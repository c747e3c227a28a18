"""The port's training entry point (``train/launch.py``) and the agent
pieces it drives (``checkpointd``, ``flight_recorder``, telemetry), on the
CPU.

* In-process runs of ``launch.run``: 3 steps with checkpoints, then
  ``--resume auto`` to 5 — the resumed steps' losses equal an
  uninterrupted run's bit for bit (synthetic batches, token shards of
  both loader flavors, LoRA); step directories are pruned to 3; a
  half-written step directory, a torn temporary one and a fast-tier
  shard whose digest does not match are all passed over.
* ``--metrics-file`` and ``--eval-data`` write the reference's keys.
* One cross-package run: the JAX and the port's launchers, in-process,
  on the same token shards (python loader), each with ``--init-params``
  from its own converter's output for one HF tiny checkpoint, the fp32
  ``tiny`` config in both (``get_config`` patched): per-step losses
  within 1e-4 (fp32, two layers, summed in another order on 8 virtual
  JAX devices against one).
* The flags not ported yet exit naming their sub-item of ROADMAP.md
  queue 1 item 8, and a mesh that does not fit the gang exits; the
  launcher refuses to start without a card unless given ``--device
  cpu``.
* checkpointd snapshots cross between the two packages both ways, and
  their cadence agrees; a flight-recorder dump has the reference's keys.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.agent import checkpointd as jax_checkpointd
from skypilot_tpu.agent import flight_recorder as jax_flight_recorder
from skypilot_tpu.agent import telemetry as jax_telemetry
from skypilot_tpu_torch import models
from skypilot_tpu_torch.agent import checkpointd
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.agent import profiler
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.train import launch
from skypilot_tpu_torch.train import trainer as trainer_lib

CROSS_LOSS_ATOL = 1e-4
METRIC_KEYS = {'step', 'loss', 'tokens_per_sec', 'model_tflops_per_chip',
               'grad_norm', 'time'}
EVAL_KEYS = {'step', 'eval_loss', 'time'}


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    """Each run's own native-loader cache, no telemetry spool, and a
    fresh process-wide checkpointer and flight recorder."""
    monkeypatch.setenv('XSKY_NATIVE_CACHE', str(tmp_path / 'native'))
    monkeypatch.delenv('XSKY_CKPT_DIR', raising=False)
    monkeypatch.delenv('XSKY_TELEMETRY_DIR', raising=False)
    checkpointd.reset_for_test()
    flight_recorder.reset_for_test()
    yield
    checkpointd.reset_for_test()


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp('tokens')
    rng = np.random.default_rng(0)
    for i in range(2):
        rng.integers(0, 256, 1500).astype('<u4').tofile(
            root / f'part-{i}.bin')
    return str(root)


def _args(*flags):
    return launch.parse_args(['--model', 'tiny', '--global-batch-size', '2',
                              '--seq-len', '16', '--log-every', '1',
                              '--device', 'cpu'] + [str(f) for f in flags])


RESUME_CASES = {
    'synthetic_adafactor': ['--optimizer', 'adafactor'],
    'python_loader': ['--data-loader', 'python'],
    # One worker: with more, the C loader's threads may hand over
    # batches out of order (the reference's loader does the same).
    'native_loader_lora': ['--data-loader', 'native', '--data-workers',
                           '1', '--lora-rank', '4', '--learning-rate',
                           '1e-2'],
}


@pytest.mark.parametrize('case', sorted(RESUME_CASES))
def test_resume_continues_bit_for_bit(case, shards, tmp_path, caplog):
    flags = list(RESUME_CASES[case])
    if case != 'synthetic_adafactor':
        flags += ['--data', shards]
    solid = launch.run(_args('--steps', 5, *flags))
    ckpt = str(tmp_path / 'ckpt')
    first = launch.run(_args('--steps', 3, '--checkpoint-every', 1,
                             '--checkpoint-dir', ckpt, *flags))
    assert sorted(os.listdir(ckpt)) == ['1', '2', '3', 'fast-tier']
    with caplog.at_level(logging.INFO, logger=launch.__name__):
        resumed = launch.run(_args('--steps', 5, '--resume', 'auto',
                                   '--checkpoint-every', 1,
                                   '--checkpoint-dir', ckpt, *flags))
    assert 'Resumed from checkpoint step 3.' in caplog.text
    assert 'step 1/5' not in caplog.text and 'step 4/5' in caplog.text
    assert resumed['start_step'] == 3
    assert resumed['restore']['tier'] == checkpointd.TIER_LOCAL
    assert first['losses'] == {k: solid['losses'][k] for k in (1, 2, 3)}
    assert resumed['losses'] == {k: solid['losses'][k] for k in (4, 5)}
    # Pruned to the newest 3 step directories; the final state matches.
    assert sorted(os.listdir(ckpt)) == ['3', '4', '5', 'fast-tier']
    for a, b in zip(trainer_lib.param_leaves(solid['state']['params']),
                    trainer_lib.param_leaves(resumed['state']['params'])):
        assert torch.equal(a, b)
    assert resumed['state']['step'] == 5


def test_storage_tier_passes_over_partial_writes(tmp_path, monkeypatch,
                                                 caplog):
    """With the fast tiers off (XSKY_CKPT=0) saves are synchronous and
    the restore reads the step directories: a step directory without its
    state file and a leftover temporary directory are ignored."""
    monkeypatch.setenv('XSKY_CKPT', '0')
    ckpt = tmp_path / 'ckpt'
    solid = launch.run(_args('--steps', 4))
    launch.run(_args('--steps', 2, '--checkpoint-every', 2,
                     '--checkpoint-dir', ckpt))
    (ckpt / '7').mkdir()                       # killed before its file
    (ckpt / '.tmp-9-123').mkdir()              # killed before the rename
    (ckpt / '.tmp-9-123' / launch.STATE_FILE).write_bytes(b'torn')
    assert launch.StepCheckpoints(str(ckpt)).latest_step() == 2
    with caplog.at_level(logging.INFO, logger=launch.__name__):
        resumed = launch.run(_args('--steps', 4, '--resume', 'auto',
                                   '--checkpoint-dir', ckpt))
    assert 'Resumed from checkpoint step 2.' in caplog.text
    assert resumed['restore']['tier'] == 'direct'
    assert resumed['losses'] == {k: solid['losses'][k] for k in (3, 4)}


def test_corrupt_fast_tier_shard_falls_back(tmp_path, caplog):
    """A fast-tier shard whose bytes no longer match its manifest is
    discarded; the restore takes the storage tier's copy of that step."""
    ckpt = tmp_path / 'ckpt'
    solid = launch.run(_args('--steps', 3))
    launch.run(_args('--steps', 2, '--checkpoint-every', 2,
                     '--checkpoint-dir', ckpt))
    shard = ckpt / 'fast-tier' / 'rank-0' / 'shard-2.bin'
    shard.write_bytes(shard.read_bytes()[:-7] + b'garbage')
    with caplog.at_level(logging.INFO, logger=launch.__name__):
        resumed = launch.run(_args('--steps', 3, '--resume', 'auto',
                                   '--checkpoint-dir', ckpt))
    assert 'Resumed from checkpoint step 2.' in caplog.text
    assert resumed['restore']['tier'] == checkpointd.TIER_STORAGE
    assert resumed['losses'] == {3: solid['losses'][3]}


def test_resume_without_a_checkpoint_starts_from_zero(tmp_path):
    out = launch.run(_args('--steps', 2, '--resume', 'auto',
                           '--checkpoint-dir', tmp_path / 'empty'))
    assert out['start_step'] == 0 and out['restore'] is None
    assert sorted(out['losses']) == [1, 2]


def test_metrics_and_eval_write_the_reference_keys(shards, tmp_path):
    metrics = tmp_path / 'metrics.jsonl'
    out = launch.run(_args('--steps', 4, '--log-every', 2, '--data', shards,
                           '--data-loader', 'python', '--eval-data', shards,
                           '--eval-every', 2, '--eval-batches', 2,
                           '--metrics-file', metrics))
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    train = [r for r in rows if 'loss' in r]
    evals = [r for r in rows if 'eval_loss' in r]
    assert [r['step'] for r in train] == [2, 4]
    assert [r['step'] for r in evals] == [2, 4]
    assert all(set(r) == METRIC_KEYS for r in train)
    assert all(set(r) == EVAL_KEYS for r in evals)
    assert [r['loss'] for r in train] == [round(out['losses'][s], 6)
                                          for s in (2, 4)]
    # A fresh eval loader each pass: the same leading batches.
    assert out['eval_losses'][2] != out['eval_losses'][4]
    assert all(np.isfinite(v) for v in out['eval_losses'].values())


def test_launcher_feeds_the_flight_recorder(shards, tmp_path, monkeypatch):
    # The profiler samples every 2nd step: that step's record carries the
    # probe's synced (dispatch gap, device) pair; the others the dispatch
    # wall alone.
    monkeypatch.setenv(profiler.ENV_SAMPLE_EVERY, '2')
    profiler.reset_for_test()
    launch.run(_args('--steps', 3, '--data', shards, '--data-loader',
                     'python', '--checkpoint-every', 3, '--checkpoint-dir',
                     tmp_path / 'ckpt'))
    records = flight_recorder.get_recorder().tail(3)
    assert [r['step'] for r in records] == [0, 1, 2]
    assert [r['synced'] for r in records] == [False, True, False]
    for rec in records:
        assert set(rec['phases']) == set(jax_flight_recorder.PHASES)
        assert sum(rec['phases'].values()) == rec['wall_s']
        assert rec['phases']['dispatch'] > 0
        assert (rec['phases']['device_compute'] > 0) == rec['synced']
        assert rec['phases']['data_wait'] > 0 and rec['phases']['h2d'] > 0
    assert records[2]['phases']['ckpt_copy'] > 0
    assert records[1]['phases']['ckpt_copy'] == 0


def _flags(module):
    """{flag: (default, choices)} of every add_argument call."""
    import ast
    import inspect
    out = {}
    for node in ast.walk(ast.parse(inspect.getsource(module))):
        if isinstance(node, ast.Call) and getattr(
                node.func, 'attr', '') == 'add_argument':
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ('default', 'choices')}
            out[node.args[0].value] = (kw.get('default'), kw.get('choices'))
    return out


def test_every_reference_flag_is_accepted_with_its_default():
    from skypilot_tpu.train import launch as jax_launch
    want, got = _flags(jax_launch), _flags(launch)
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {'--device', '--procs-per-host'}


def _exits(flags, match):
    return pytest.param(flags, match, id=' '.join(flags))


@pytest.mark.parametrize('flags,match', [
    _exits(['--attention', 'ring'], 'queue 1 item 8c'),
    _exits(['--attention', 'ulysses'], 'queue 1 item 8c'),
    # data, fsdp, expert and tensor are ported: one process is refused a
    # plan of more ranks, and slices that its data axis cannot hold.
    _exits(['--num-slices', '2'], 'multiple of num_slices'),
    _exits(['--mesh', 'data=-1,fsdp=8'], 'gang of 1 rank'),
    _exits(['--mesh', 'data=2'], 'gang of 1 rank'),
    _exits(['--mesh', 'tensor=4'], 'gang of 1 rank'),
    _exits(['--mesh', 'data=1,stage=2'], 'queue 1 item 8d'),
    _exits(['--mesh', 'sequence=2'], 'queue 1 item 8c'),
    _exits(['--mesh', 'expert=2'], 'gang of 1 rank')])
def test_multi_card_flags_exit_naming_queue_item_8(flags, match):
    with pytest.raises(SystemExit, match=match):
        launch.run(_args('--steps', 1, *flags))


def test_recipe_mesh_resolves_to_one_card():
    """examples/spot_finetune_recovery.yaml's --mesh data=1,fsdp=-1."""
    plan = launch.parse_mesh('data=1,fsdp=-1')
    assert launch.resolve_plan(plan, 1) == trainer_lib.MeshPlan(
        data=1, fsdp=1)
    assert launch.resolve_plan(plan, 4) == trainer_lib.MeshPlan(
        data=1, fsdp=4)
    out = launch.run(_args('--steps', 1, '--mesh', 'data=1,fsdp=-1'))
    assert out['trainer'].config.mesh_plan.axis_sizes() == (1,) * 6
    with pytest.raises(ValueError, match='Unknown mesh axis'):
        launch.parse_mesh('pipeline=2')


def test_mesh_plan_resolve_matches_jax():
    from skypilot_tpu.parallel import mesh as mesh_lib
    assert trainer_lib.MESH_AXES == mesh_lib.MESH_AXES
    for kw, n in ((dict(), 8), (dict(data=2, fsdp=-1), 8),
                  (dict(data=1, fsdp=-1, tensor=4), 8), (dict(data=1), 1)):
        want = mesh_lib.MeshPlan(**kw).resolve(n)
        got = trainer_lib.MeshPlan(**kw).resolve(n)
        assert got.axis_sizes() == want.axis_sizes()
    for kw, n in ((dict(data=-1, fsdp=-1), 8), (dict(fsdp=3), 8),
                  (dict(data=2), 1)):
        with pytest.raises(ValueError) as want:
            mesh_lib.MeshPlan(**kw).resolve(n)
        with pytest.raises(ValueError) as got:
            trainer_lib.MeshPlan(**kw).resolve(n)
        assert str(got.value) == str(want.value)


def test_launcher_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        launch.main(['--model', 'tiny', '--steps', '1'])


def test_gang_env_of_more_than_one_host_names_queue_item_8(monkeypatch):
    """A gang of hosts is ported (item 8a): one process per card, rank
    host_rank * cards + local rank (the gang itself is driven in
    test_torch_launch_mesh.py); one host stays a no-op."""
    monkeypatch.setenv('XSKY_NUM_HOSTS', '2')
    monkeypatch.setenv('XSKY_HOST_RANK', '1')
    assert distributed.is_multihost()
    assert distributed.gang_rank(1, 2) == (1, 2)
    assert distributed.gang_rank(1, 2, local_rank=3, local_size=4) == (7, 8)
    assert distributed.gang_rank(0, 3, local_rank=1, local_size=2) == (1, 6)
    for bad in ((2, 2, 0, 1), (0, 2, 4, 4)):
        with pytest.raises(ValueError):
            distributed.gang_rank(*bad)
    monkeypatch.setenv('XSKY_NUM_HOSTS', '1')
    monkeypatch.setenv('XSKY_HOST_RANK', '0')
    assert not distributed.is_multihost()
    distributed.initialize()   # one host: nothing to do
    assert distributed.world_size() == 1 and distributed.rank() == 0


def test_per_host_batch_and_elastic_generation_match_jax(monkeypatch):
    from skypilot_tpu.train import launch as jax_launch
    for gen in ('0', '2'):
        monkeypatch.setenv('XSKY_ELASTIC_GENERATION', gen)
        assert launch.elastic_generation() == jax_launch.elastic_generation()
        for gb, hosts in ((8, 2), (8, 3), (7, 1)):
            try:
                want = jax_launch.per_host_batch(gb, hosts)
            except ValueError:
                with pytest.raises(ValueError):
                    launch.per_host_batch(gb, hosts)
                continue
            assert launch.per_host_batch(gb, hosts) == want


def test_init_params_must_match_the_model(tmp_path):
    bad = tmp_path / 'bad'
    bad.mkdir()
    params = llama.init(dataclasses.replace(llama.LLAMA_TINY, n_layers=3),
                        device='cpu')
    torch.save(params, bad / 'params.pt')
    with pytest.raises(ValueError, match='does not match --model tiny'):
        launch.run(_args('--steps', 1, '--init-params', bad))


# ---- the same run through both packages' launchers ----

@pytest.fixture(scope='module')
def hf_checkpoint(tmp_path_factory):
    transformers = pytest.importorskip('transformers')
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        rope_theta=500_000.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    path = tmp_path_factory.mktemp('hf') / 'tiny-llama'
    transformers.LlamaForCausalLM(cfg).save_pretrained(path)
    return str(path)


def test_both_launchers_give_the_same_losses(hf_checkpoint, shards,
                                             tmp_path, monkeypatch):
    from skypilot_tpu import models as jax_models
    from skypilot_tpu.models import convert as jax_convert
    from skypilot_tpu.models import llama as jax_llama
    from skypilot_tpu.train import launch as jax_launch
    from skypilot_tpu_torch.models import convert
    monkeypatch.setenv('XSKY_STATE_DB', str(tmp_path / 'state.db'))
    jax_tiny = dataclasses.replace(jax_llama.LLAMA_TINY, dtype=jnp.float32)
    tiny = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    monkeypatch.setattr(jax_models, 'get_config', lambda name: jax_tiny)
    monkeypatch.setattr(models, 'get_config', lambda name: tiny)
    jax_convert.main(['--src', hf_checkpoint, '--out',
                      str(tmp_path / 'jax-params'), '--dtype', 'f32'])
    convert.main(['--src', hf_checkpoint, '--out',
                  str(tmp_path / 'port-params'), '--dtype', 'f32',
                  '--device', 'cpu'])
    common = ['--model', 'tiny', '--global-batch-size', '8', '--seq-len',
              '16', '--steps', '3', '--log-every', '1', '--optimizer',
              'adamw', '--learning-rate', '1e-2', '--data', shards,
              '--data-loader', 'python']
    monkeypatch.setattr(sys, 'argv', ['launch'] + common + [
        '--init-params', str(tmp_path / 'jax-params'),
        '--metrics-file', str(tmp_path / 'jax.jsonl')])
    assert jax_launch.main() == 0
    launch.main(common + ['--init-params', str(tmp_path / 'port-params'),
                          '--metrics-file', str(tmp_path / 'port.jsonl'),
                          '--device', 'cpu'])
    rows = {name: [json.loads(line) for line in
                   (tmp_path / f'{name}.jsonl').read_text().splitlines()]
            for name in ('jax', 'port')}
    assert [set(r) for r in rows['port']] == [set(r) for r in rows['jax']]
    assert [r['step'] for r in rows['port']] == [1, 2, 3]
    for got, want in zip(rows['port'], rows['jax']):
        assert got['loss'] == pytest.approx(want['loss'],
                                            abs=CROSS_LOSS_ATOL)
    # The converted weights, not a random init, started both runs.
    assert rows['port'][0]['loss'] != pytest.approx(np.log(256), abs=1e-3)


def _recorded(module, monkeypatch):
    """module.batches wrapped so that every batch a launcher takes from
    its feed is kept; returns the list it fills."""
    seen, real = [], module.batches

    def batches(loader, **kw):
        for batch in real(loader, **kw):
            seen.append(np.array(batch['tokens']))
            yield batch
    monkeypatch.setattr(module, 'batches', batches)
    return seen


def test_resumed_data_run_continues_the_stream_unlike_the_reference(
        shards, tmp_path, monkeypatch):
    """A deliberate departure from the reference: resumed at step 2 with
    ``--data``, the port's launcher takes batches 2 and 3 of an
    uninterrupted run's stream (its loader skips what the checkpointed
    steps consumed); the JAX launcher restarts the stream and takes
    batches 0 and 1. Same shards, python loader, same seed; the
    uninterrupted streams of the two launchers are equal bit for bit."""
    from skypilot_tpu.agent import checkpointd as jax_ckpt
    from skypilot_tpu.train import data as jax_data
    from skypilot_tpu.train import launch as jax_launch
    from skypilot_tpu_torch.train import data
    monkeypatch.setenv('XSKY_STATE_DB', str(tmp_path / 'state.db'))
    common = ['--model', 'tiny', '--global-batch-size', '8', '--seq-len',
              '16', '--log-every', '1', '--data', shards,
              '--data-loader', 'python']

    def port(*flags):
        with monkeypatch.context() as m:
            seen = _recorded(data, m)
            launch.main(common + ['--device', 'cpu', *flags])
        checkpointd.reset_for_test()
        return seen

    def reference(*flags):
        with monkeypatch.context() as m:
            seen = _recorded(jax_data, m)
            m.setattr(sys, 'argv', ['launch', *common, *flags])
            assert jax_launch.main() == 0
        jax_ckpt.reset_for_test()
        return seen

    streams = {}
    for name, run in (('port', port), ('jax', reference)):
        ckpt = str(tmp_path / name)
        solid = run('--steps', '4')
        run('--steps', '2', '--checkpoint-every', '2',
            '--checkpoint-dir', ckpt)
        resumed = run('--steps', '4', '--resume', 'auto',
                      '--checkpoint-dir', ckpt)
        assert len(solid) == 4 and len(resumed) == 2
        streams[name] = solid, resumed
    assert all(np.array_equal(a, b) for a, b in zip(streams['port'][0],
                                                    streams['jax'][0]))
    (solid, resumed), (jax_solid, jax_resumed) = (streams['port'],
                                                  streams['jax'])
    assert all(np.array_equal(a, b) for a, b in zip(resumed, solid[2:]))
    assert all(np.array_equal(a, b)
               for a, b in zip(jax_resumed, jax_solid[:2]))
    assert not np.array_equal(solid[0], solid[2])


# ---- checkpointd and the flight recorder against the reference ----

def _host_state():
    tr = trainer_lib.Trainer(trainer_lib.TrainConfig(
        model=llama.LLAMA_TINY, global_batch_size=2, seq_len=8),
        device='cpu')
    return tr.host_state(tr.init_state())


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_snapshots_cross_between_packages(writer, tmp_path, monkeypatch):
    """Same shard, manifest and digest layout: a snapshot written by one
    package's Checkpointer restores through the other's ladder."""
    monkeypatch.setenv('XSKY_STATE_DB', str(tmp_path / 'state.db'))
    mods = {'port': checkpointd, 'jax': jax_checkpointd}
    reader = 'jax' if writer == 'port' else 'port'
    payload = _host_state()
    w = mods[writer].Checkpointer(str(tmp_path / 'fast'),
                                  peer_dirs=(str(tmp_path / 'peer'),))
    assert w.maybe_checkpoint_impl(7, lambda: payload, force=True)
    assert w.wait_idle(timeout=60)
    w.stop()
    manifest = json.loads(
        (tmp_path / 'fast' / 'rank-0' / 'manifest-7.json').read_text())
    assert set(manifest) == {'step', 'incarnation', 'rank', 'digest',
                             'shard', 'bytes', 'ts'}
    assert (tmp_path / 'peer' / 'peer-rank-0' / 'shard-7.bin').exists()
    r = mods[reader].Checkpointer(str(tmp_path / 'fast'))
    snap = r.restore_impl()
    assert (snap.step, snap.tier) == (7, 'local')
    for a, b in zip(trainer_lib.param_leaves(snap.payload['params']),
                    trainer_lib.param_leaves(payload['params'])):
        assert torch.equal(a, b)


def test_cadence_matches_the_reference(monkeypatch):
    monkeypatch.setenv('XSKY_CKPT_MTTF_S', '3600')
    for costs, step_times in (([0.5, 2.0], [1.3]), ([1e-5], []),
                              ([40.0], [0.01, 0.02])):
        a, b = checkpointd.Cadence(), jax_checkpointd.Cadence()
        for c in costs:
            a.observe_cost(c)
            b.observe_cost(c)
        for t in step_times:
            a.observe_step_time(t)
            b.observe_step_time(t)
        assert a.interval_s() == b.interval_s()


def test_flight_recorder_dump_has_the_reference_layout(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv('XSKY_FLIGHTREC_DIR', str(tmp_path / 'dumps'))
    dumps = {}
    for name, mod in (('port', flight_recorder),
                      ('jax', jax_flight_recorder)):
        mod.reset_for_test()
        mod.begin_step(5)
        with mod.phase('h2d'):
            pass
        mod.mark_compute(0.002)
        mod.mark('ckpt_copy', 0.001)
        mod.record_step(5)
        path = mod.seal_dump('exception', detail={'error': 'x'})
        with open(path, encoding='utf-8') as f:
            dumps[name] = json.load(f)
        os.remove(path)
    port, ref = dumps['port'], dumps['jax']
    assert set(port) == set(ref)
    assert [set(r) for r in port['records']] == \
        [set(r) for r in ref['records']]
    assert set(port['records'][0]['phases']) == \
        set(ref['records'][0]['phases'])
    assert (port['reason'], port['last_step'], port['sealed']) == (
        ref['reason'], ref['last_step'], ref['sealed'])


def test_trainer_steps_feed_the_telemetry_spool(tmp_path, monkeypatch):
    monkeypatch.setenv('XSKY_TELEMETRY_DIR', str(tmp_path))
    monkeypatch.setenv('XSKY_TELEMETRY_INTERVAL_S', '0')
    launch.run(_args('--steps', 3))
    sample = jax_telemetry.read_spool(str(tmp_path))[0]
    assert sample['phase'] == 'idle'
    assert sample['resume_step'] == 0
    assert sample['step'] == 2 and sample['step_time_ema_s'] > 0
