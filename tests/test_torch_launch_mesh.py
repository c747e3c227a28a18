"""``train/launch.py`` as a gang of ranks on the CPU (``--device cpu``).

Two launcher processes (``torch_gang_worker.py launch``: the gang env of
two hosts on a free local port, gloo; every process killed when a rank
fails or after 100 s) train the fp32 ``tiny`` config:

* at ``--mesh data=1,fsdp=2`` on synthetic batches: both ranks return
  the one-rank launcher's losses and grad norms (in-process, same
  flags); its checkpoint at step 2 resumes in one process at
  ``--mesh data=1`` to step 4 with the uninterrupted run's losses;
* the reverse: a one-rank checkpoint at step 2 resumes on a gang at
  ``--mesh data=2`` (``XSKY_ELASTIC_GENERATION=1``, the reference's
  elastic remesh) with the same losses;
* over token shards (``--data``, python loader) at ``--mesh data=2``:
  the ranks read disjoint rows of each epoch (``order[rank::world]``),
  which together are the one-rank loader's batch, so the losses equal
  the one-rank run's.

Tolerance: losses and grad norms 1e-5 relative (fp32, sums over ranks in
another order).
"""
from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

import torch_gang_worker
from skypilot_tpu.agent import telemetry as jax_telemetry
from skypilot_tpu_torch import models
from skypilot_tpu_torch.agent import checkpointd
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.agent import telemetry
from skypilot_tpu_torch.train import data as data_lib
from skypilot_tpu_torch.train import launch

RTOL = 1e-5
FLAGS = ['--model', 'tiny', '--global-batch-size', '4', '--seq-len', '16',
         '--log-every', '1', '--device', 'cpu', '--learning-rate', '1e-3']


@pytest.fixture(autouse=True)
def _time_limit(tmp_path, monkeypatch):
    """120 s per test; fp32 ``tiny`` in process; a fresh checkpointer,
    flight recorder and native-loader cache."""
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
    old = signal.signal(signal.SIGALRM, _fail)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    checkpointd.reset_for_test()


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp('tokens')
    rng = np.random.default_rng(0)
    for i in range(2):
        rng.integers(0, 256, 1500).astype('<u4').tofile(
            root / f'part-{i}.bin')
    return str(root)


def _one_rank(*flags):
    out = launch.run(launch.parse_args(FLAGS + [str(f) for f in flags]))
    return out['losses'], out['grad_norms'], out['start_step']


def _gang(tmp_path, *flags, env=None):
    return torch_gang_worker.launch_gang(
        FLAGS + [str(f) for f in flags], 2, str(tmp_path), env=env)


def _close(got, want):
    got = {int(k): v for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for step, value in want.items():
        assert got[step] == pytest.approx(value, rel=RTOL), step


def test_fsdp_gang_equals_one_rank_and_resumes_at_data_1(tmp_path):
    losses, norms, _ = _one_rank('--steps', 4)
    ckpt = tmp_path / 'ckpt'
    spool = tmp_path / 'spool'
    ranks = _gang(tmp_path, '--steps', 2, '--mesh', 'data=1,fsdp=2',
                  '--checkpoint-dir', ckpt, '--checkpoint-every', 2,
                  env={'XSKY_TELEMETRY_DIR': str(spool),
                       'XSKY_TELEMETRY_INTERVAL_S': '0'})
    # Each rank's heartbeat under its own rank.
    samples = jax_telemetry.read_spool(str(spool))
    assert sorted(samples) == [0, 1]
    assert {s['phase'] for s in samples.values()} == {'idle'}
    for rank in ranks:
        assert rank['losses'] == ranks[0]['losses']
        assert rank['start_step'] == 0
        _close(rank['losses'], {s: losses[s] for s in (1, 2)})
        _close(rank['grad_norms'], {s: norms[s] for s in (1, 2)})
    assert launch.StepCheckpoints(str(ckpt)).steps() == [2]
    resumed, _, start = _one_rank('--steps', 4, '--mesh', 'data=1',
                                  '--checkpoint-dir', ckpt,
                                  '--resume', 'auto')
    assert start == 2
    _close(resumed, {s: losses[s] for s in (3, 4)})


def test_one_rank_checkpoint_resumes_on_a_data_parallel_gang(tmp_path):
    out = launch.run(launch.parse_args(FLAGS + ['--steps', '4']))
    whole = out['trainer'].host_state(out['state'])
    ckpt = tmp_path / 'ckpt'
    _one_rank('--steps', 2, '--checkpoint-dir', ckpt)
    checkpointd.reset_for_test()
    ranks = _gang(tmp_path, '--steps', 4, '--mesh', 'data=2',
                  '--checkpoint-dir', ckpt, '--resume', 'auto',
                  env={'XSKY_ELASTIC_GENERATION': '1'})
    for rank in ranks:
        assert rank['start_step'] == 2
        _close(rank['losses'], {s: out['losses'][s] for s in (3, 4)})
    # The gang's last checkpoint is the whole tree a one-rank run holds.
    saved = launch.StepCheckpoints(str(ckpt)).restore(4)
    assert saved['step'] == whole['step'] == 4
    for a, b in zip(_leaves(saved['params']), _leaves(whole['params'])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_ranks_read_disjoint_rows_of_each_epoch(shards, tmp_path):
    paths = data_lib.expand_data_arg(shards)
    whole = data_lib.PyTokenLoader(paths, batch=4, seq=16, seed=0)
    parts = [data_lib.PyTokenLoader(paths, batch=2, seq=16, seed=0,
                                    host_rank=r, num_hosts=2)
             for r in range(2)]
    order = whole._order
    for r, part in enumerate(parts):
        np.testing.assert_array_equal(part._order, order[r::2])
    for _ in range(3):
        rows = [tuple(row) for part in parts for row in next(part)]
        want = [tuple(row) for row in next(whole)]
        assert len(set(rows)) == len(rows) == 4
        assert set(rows) == set(want)
    losses, norms, _ = _one_rank('--steps', 2, '--data', shards,
                                 '--data-loader', 'python')
    ranks = _gang(tmp_path, '--steps', 2, '--mesh', 'data=2',
                  '--data', shards, '--data-loader', 'python')
    for rank in ranks:
        _close(rank['losses'], losses)
        _close(rank['grad_norms'], norms)


def test_a_process_per_card_carries_its_global_rank(tmp_path, monkeypatch):
    """Host 1 of a gang whose hosts run two processes each: the process
    of local rank 1 is rank 3 (``distributed.initialize`` sets
    XSKY_RANK), and its telemetry sample and flight-recorder dump say
    so, where the reference's carry the process index."""
    monkeypatch.setenv('XSKY_HOST_RANK', '1')
    monkeypatch.setenv('XSKY_RANK', '3')
    monkeypatch.setenv('XSKY_TELEMETRY_DIR', str(tmp_path / 'spool'))
    monkeypatch.setenv('XSKY_TELEMETRY_INTERVAL_S', '0')
    monkeypatch.setenv('XSKY_FLIGHTREC_DIR', str(tmp_path / 'dumps'))
    telemetry.reset_for_test()
    flight_recorder.reset_for_test()
    try:
        telemetry.emit(phase=telemetry.PHASE_STEP, step=1)
        assert sorted(jax_telemetry.read_spool(str(tmp_path / 'spool'))) == [3]
        flight_recorder.begin_step(1)
        flight_recorder.record_step(1)
        path = flight_recorder.seal_dump('exception')
        assert os.path.basename(path).startswith('rank-3-exception-')
    finally:
        telemetry.reset_for_test()
        flight_recorder.reset_for_test()
