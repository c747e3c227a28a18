"""``train/launch.py`` at expert-parallel meshes on the CPU (``--device
cpu``): gangs of launcher processes (``torch_gang_worker.py launch``: the
gang env on a free local port, gloo; every process killed when a rank
fails or after 100 s) train fp32 ``moe-tiny``, against the one-rank
launcher in this process with the same flags:

* a checkpoint written at ``--mesh data=1,fsdp=2,expert=2`` (four ranks:
  the expert stacks cut on two dims, gathered into the one ``state.pt``)
  resumes at one rank and on a gang at ``data=1,fsdp=1,expert=2`` to step
  4 with the uninterrupted run's losses, and a one-rank checkpoint
  resumes at ``data=1,fsdp=2,expert=2``;
* over token shards (``--data``, python loader) at ``--mesh
  data=1,fsdp=1,expert=2``: both expert ranks read the same rows (the
  batch splits over data and fsdp alone), so the losses equal the
  one-rank run's;
* ``multislice_moe.yaml``'s ``--mesh data=2,fsdp=-1,expert=8
  --num-slices 2`` resolves for Mixtral-8x7B at 32 ranks, data
  outermost and each slice a contiguous block of ranks;
* the refusals that stay, by their texts: ``expert x tensor`` and LoRA
  at ``expert > 1`` (8b-ii), ``sequence`` (8c), ``stage`` (8d), by
  ``Trainer`` and by ``resolve_plan``, and the server's ``--mesh`` (8f).

Tolerance: losses and grad norms 1e-5 relative (fp32, sums over ranks in
another order).
"""
from __future__ import annotations

import dataclasses
import shutil
import signal

import numpy as np
import pytest
import torch

import torch_gang_worker
from skypilot_tpu_torch import models
from skypilot_tpu_torch.agent import checkpointd
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.infer import server as server_lib
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import launch
from skypilot_tpu_torch.train import trainer

RTOL = 1e-5
FLAGS = ['--model', 'moe-tiny', '--global-batch-size', '4', '--seq-len',
         '16', '--log-every', '1', '--device', 'cpu', '--learning-rate',
         '1e-3']


@pytest.fixture(autouse=True)
def _time_limit(monkeypatch, tmp_path):
    """120 s per test; fp32 configs in process; a fresh checkpointer and
    flight recorder; one intra-op thread."""
    def _fail(signum, frame):
        raise TimeoutError('test exceeded its 120 s budget')
    get_config = models.get_config
    monkeypatch.setattr(models, 'get_config', lambda name: dataclasses.replace(
        get_config(name), dtype=torch.float32))
    monkeypatch.setenv('XSKY_NATIVE_CACHE', str(tmp_path / 'native'))
    monkeypatch.delenv('XSKY_CKPT_DIR', raising=False)
    monkeypatch.delenv('XSKY_TELEMETRY_DIR', raising=False)
    checkpointd.reset_for_test()
    flight_recorder.reset_for_test()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old = signal.signal(signal.SIGALRM, _fail)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    torch.set_num_threads(threads)
    checkpointd.reset_for_test()


def _one_rank(*flags):
    out = launch.run(launch.parse_args(FLAGS + [str(f) for f in flags]))
    checkpointd.reset_for_test()
    return out['losses'], out['grad_norms'], out['start_step']


def _gang(tmp_path, world, *flags):
    return torch_gang_worker.launch_gang(
        FLAGS + [str(f) for f in flags], world, str(tmp_path))


def _close(got, want):
    got = {int(k): v for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for step, value in want.items():
        assert got[step] == pytest.approx(value, rel=RTOL), step


def test_fsdp2_expert2_checkpoint_resumes_at_one_rank_and_at_expert2(
        tmp_path):
    losses, norms, _ = _one_rank('--steps', 4)
    ckpt = tmp_path / 'ckpt'
    ranks = _gang(tmp_path, 4, '--steps', 2, '--mesh',
                  'data=1,fsdp=2,expert=2', '--checkpoint-dir', ckpt,
                  '--checkpoint-every', 2)
    for rank in ranks:
        assert rank['losses'] == ranks[0]['losses']
        _close(rank['losses'], {s: losses[s] for s in (1, 2)})
        _close(rank['grad_norms'], {s: norms[s] for s in (1, 2)})
    assert launch.StepCheckpoints(str(ckpt)).steps() == [2]
    copy = tmp_path / 'ckpt-copy'
    shutil.copytree(ckpt, copy)
    resumed, _, start = _one_rank('--steps', 4, '--mesh', 'data=1',
                                  '--checkpoint-dir', ckpt,
                                  '--resume', 'auto')
    assert start == 2
    _close(resumed, {s: losses[s] for s in (3, 4)})
    for rank in _gang(tmp_path, 2, '--steps', 4, '--mesh',
                      'data=1,fsdp=1,expert=2', '--checkpoint-dir', copy,
                      '--resume', 'auto'):
        assert rank['start_step'] == 2
        _close(rank['losses'], {s: losses[s] for s in (3, 4)})


def test_one_rank_checkpoint_resumes_at_fsdp2_expert2(tmp_path):
    losses, _, _ = _one_rank('--steps', 4)
    ckpt = tmp_path / 'ckpt'
    _one_rank('--steps', 2, '--checkpoint-dir', ckpt)
    for rank in _gang(tmp_path, 4, '--steps', 4, '--mesh',
                      'data=1,fsdp=2,expert=2', '--checkpoint-dir', ckpt,
                      '--resume', 'auto'):
        assert rank['start_step'] == 2
        _close(rank['losses'], {s: losses[s] for s in (3, 4)})


def test_expert_ranks_read_the_same_rows_of_the_shards(tmp_path):
    rng = np.random.default_rng(0)
    shards = tmp_path / 'tokens'
    shards.mkdir()
    for i in range(2):
        rng.integers(0, 256, 1500).astype('<u4').tofile(
            shards / f'part-{i}.bin')
    data = ['--data', shards, '--data-loader', 'python', '--steps', 2]
    losses, norms, _ = _one_rank(*data)
    for rank in _gang(tmp_path, 2, *data, '--mesh',
                      'data=1,fsdp=1,expert=2'):
        _close(rank['losses'], losses)
        _close(rank['grad_norms'], norms)


def test_the_multislice_recipe_plan_resolves():
    """multislice_moe.yaml: --mesh data=2,fsdp=-1,expert=8 --num-slices 2
    on 32 ranks (two slices of 16)."""
    args = launch.parse_args(['--mesh', 'data=2,fsdp=-1,expert=8',
                              '--num-slices', '2'])
    mixtral = models.get_config('mixtral-8x7b')
    plan = launch.resolve_plan(launch.parse_mesh(args.mesh), 32, mixtral)
    assert plan == trainer.MeshPlan(data=2, fsdp=2, expert=8)
    for rank in (0, 17, 31):
        mesh = mesh_lib.build_mesh(plan, num_slices=args.num_slices,
                                   world=32, rank=rank)
        assert mesh.shape == dict(data=2, stage=1, fsdp=2, sequence=1,
                                  expert=8, tensor=1)
        # Slice s holds ranks [16 s, 16 s + 16): data is outermost.
        assert mesh.coords['data'] == rank // 16
        np.testing.assert_array_equal(
            mesh.devices.reshape(2, 16), np.arange(32).reshape(2, 16))
    # Mixtral's 8 experts: one a rank.
    assert mixtral.n_experts % plan.expert == 0


@pytest.mark.parametrize('plan,lora,match', [
    (trainer.MeshPlan(data=1, expert=2, tensor=2), 0,
     r'expert=2 x tensor=2: .*queue 1 item 8b-ii'),
    (trainer.MeshPlan(data=1, expert=2), 4,
     r'LoRA adapters at expert > 1 .*queue 1 item 8b-ii'),
    (trainer.MeshPlan(data=1, expert=2, sequence=2), 0,
     r'sequence=2: .*queue 1 item 8c'),
    (trainer.MeshPlan(data=1, expert=2, stage=2), 0,
     r'stage=2: .*queue 1 item 8d'),
], ids=['expert-x-tensor', 'lora', 'sequence', 'stage'])
def test_refusals_that_stay_name_their_items(plan, lora, match):
    cfg = models.get_config('moe-tiny')
    with pytest.raises(NotImplementedError, match=match):
        trainer.Trainer(trainer.TrainConfig(model=cfg, mesh_plan=plan,
                                            lora_rank=lora), device='cpu')
    with pytest.raises(SystemExit, match=match):
        launch.resolve_plan(plan, 8, cfg, lora)


def test_the_server_still_refuses_a_mesh(capsys):
    """serve_mixtral.yaml's --mesh expert=8 parses (item 8f); the server
    still refuses a mesh with speculation (item 8f-ii)."""
    assert server_lib.parse_args(['--model', 'mixtral-8x7b', '--mesh',
                                  'expert=8']).mesh_plan.expert == 8
    with pytest.raises(SystemExit):
        server_lib.parse_args(['--model', 'mixtral-8x7b', '--mesh',
                               'expert=8', '--spec-ngram'])
    assert 'queue 1 item 8f-ii' in capsys.readouterr().err
