"""``train/launch.py`` at tensor-parallel meshes on the CPU
(``--device cpu``): gangs of launcher processes
(``torch_gang_worker.py launch``: the gang env on a free local port,
gloo; every process killed when a rank fails or after 100 s) train fp32
tiny configs, against the one-rank launcher in this process with the
same flags:

* Llama ``tiny`` at ``--mesh data=1,fsdp=1,tensor=2``: both ranks log the
  one rank's losses and grad norms; its step-2 checkpoint resumes at one
  rank and on a gang at ``fsdp=2`` to step 4 with the uninterrupted
  run's losses; an ``fsdp=2`` checkpoint resumes at ``tensor=2``;
* ``train_llama3_8b.yaml``'s ``--mesh data=1,fsdp=-1,tensor=4`` flags on
  four ranks (``fsdp`` resolves to 1) with Llama ``tiny`` (two ranks
  share each KV head) and Qwen-3 tiny, and ``--mesh
  data=1,fsdp=-1,tensor=2`` (``fsdp`` 2) with Gemma-2 tiny.

Tolerance: losses and grad norms 1e-5 relative (fp32, sums over ranks in
another order).
"""
from __future__ import annotations

import dataclasses
import shutil
import signal

import pytest
import torch

import torch_gang_worker
from skypilot_tpu_torch import models
from skypilot_tpu_torch.agent import checkpointd
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.train import launch

RTOL = 1e-5
FLAGS = ['--global-batch-size', '4', '--seq-len', '16', '--log-every', '1',
         '--device', 'cpu', '--learning-rate', '1e-3']


@pytest.fixture(autouse=True)
def _time_limit(monkeypatch):
    """120 s per test; fp32 configs in process; a fresh checkpointer and
    flight recorder."""
    def _fail(signum, frame):
        raise TimeoutError('test exceeded its 120 s budget')
    get_config = models.get_config
    monkeypatch.setattr(models, 'get_config', lambda name: dataclasses.replace(
        get_config(name), dtype=torch.float32))
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


def _one_rank(model, *flags):
    out = launch.run(launch.parse_args(
        FLAGS + ['--model', model] + [str(f) for f in flags]))
    return out['losses'], out['grad_norms'], out['start_step']


def _gang(tmp_path, world, model, *flags):
    return torch_gang_worker.launch_gang(
        FLAGS + ['--model', model] + [str(f) for f in flags], world,
        str(tmp_path))


def _close(got, want):
    got = {int(k): v for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for step, value in want.items():
        assert got[step] == pytest.approx(value, rel=RTOL), step


def test_tensor_checkpoint_resumes_at_one_rank_and_at_fsdp_2(tmp_path):
    losses, norms, _ = _one_rank('tiny', '--steps', 4)
    ckpt = tmp_path / 'ckpt'
    ranks = _gang(tmp_path, 2, 'tiny', '--steps', 2, '--mesh',
                  'data=1,fsdp=1,tensor=2', '--checkpoint-dir', ckpt,
                  '--checkpoint-every', 2)
    for rank in ranks:
        assert rank['losses'] == ranks[0]['losses']
        _close(rank['losses'], {s: losses[s] for s in (1, 2)})
        _close(rank['grad_norms'], {s: norms[s] for s in (1, 2)})
    assert launch.StepCheckpoints(str(ckpt)).steps() == [2]
    copy = tmp_path / 'ckpt-copy'
    shutil.copytree(ckpt, copy)
    resumed, _, start = _one_rank('tiny', '--steps', 4, '--mesh', 'data=1',
                                  '--checkpoint-dir', ckpt,
                                  '--resume', 'auto')
    assert start == 2
    _close(resumed, {s: losses[s] for s in (3, 4)})
    for rank in _gang(tmp_path, 2, 'tiny', '--steps', 4, '--mesh',
                      'data=1,fsdp=2', '--checkpoint-dir', copy,
                      '--resume', 'auto'):
        assert rank['start_step'] == 2
        _close(rank['losses'], {s: losses[s] for s in (3, 4)})


def test_fsdp_checkpoint_resumes_at_tensor_2(tmp_path):
    losses, _, _ = _one_rank('tiny', '--steps', 4)
    ckpt = tmp_path / 'ckpt'
    _gang(tmp_path, 2, 'tiny', '--steps', 2, '--mesh', 'data=1,fsdp=2',
          '--checkpoint-dir', ckpt)
    for rank in _gang(tmp_path, 2, 'tiny', '--steps', 4, '--mesh',
                      'data=1,fsdp=1,tensor=2', '--checkpoint-dir', ckpt,
                      '--resume', 'auto'):
        assert rank['start_step'] == 2
        _close(rank['losses'], {s: losses[s] for s in (3, 4)})


@pytest.mark.parametrize('model,mesh', [
    ('tiny', 'data=1,fsdp=-1,tensor=4'),
    ('qwen3-tiny', 'data=1,fsdp=-1,tensor=4'),
    ('gemma2-tiny', 'data=1,fsdp=-1,tensor=2')])
def test_the_recipe_mesh_flags_train_on_four_ranks(tmp_path, model, mesh):
    losses, norms, _ = _one_rank(model, '--steps', 2)
    for rank in _gang(tmp_path, 4, model, '--steps', 2, '--mesh', mesh):
        _close(rank['losses'], losses)
        _close(rank['grad_norms'], norms)
