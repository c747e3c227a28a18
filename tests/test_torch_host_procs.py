"""``train/launch.py --procs-per-host``: one launcher process per host
starts the host's rank processes (``distributed.run_host``), on the CPU
(``--device cpu``, gloo):

* one invocation with ``--procs-per-host 2`` (``torch_gang_worker.py
  host``: the launcher's ``main``, whose ranks run this same command, the
  model's config in fp32) trains as a two-rank gang: Llama ``tiny`` at
  ``--mesh data=1,fsdp=2`` (``test_torch_launch_mesh.py``'s gang case)
  and ``moe-tiny`` at ``--mesh data=1,fsdp=1,expert=2`` log the one-rank
  launcher's losses and grad norms (in this process, same flags) within
  1e-5 relative, both ranks the same;
* a rank that fails (``train.straggler_rank``'s chaos point sends rank 1
  SIGKILL at its first step) takes the host down with its code (128 +
  9), a SIGTERM sent to the launcher ends every rank, and so does a
  SIGKILL (each rank binds itself to its launcher): no rank process is
  left either way;
* ``auto`` is one process on the CPU and with no card, and a rank
  process (``XSKY_LOCAL_RANK`` set) never starts others.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

import torch_gang_worker
from skypilot_tpu_torch import models
from skypilot_tpu_torch.agent import checkpointd
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.train import launch

RTOL = 1e-5
FLAGS = ['--global-batch-size', '4', '--seq-len', '16', '--log-every', '1',
         '--device', 'cpu', '--learning-rate', '1e-3']
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_gang_worker.py')


@pytest.fixture(autouse=True)
def _time_limit(monkeypatch):
    """120 s per test; fp32 configs in process; a fresh checkpointer and
    flight recorder; one intra-op thread."""
    def _fail(signum, frame):
        raise TimeoutError('test exceeded its 120 s budget')
    get_config = models.get_config
    monkeypatch.setattr(models, 'get_config', lambda name: dataclasses.replace(
        get_config(name), dtype=torch.float32))
    monkeypatch.delenv('XSKY_CKPT_DIR', raising=False)
    monkeypatch.delenv('XSKY_TELEMETRY_DIR', raising=False)
    monkeypatch.delenv(distributed.ENV_LOCAL_RANK, raising=False)
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


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('XSKY_')}
    env.update(OMP_NUM_THREADS='1', **extra)
    return env


def _close(got, want):
    got = {int(k): v for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for step, value in want.items():
        assert got[step] == pytest.approx(value, rel=RTOL), step


@pytest.mark.parametrize('model,mesh', [
    ('tiny', 'data=1,fsdp=2'), ('moe-tiny', 'data=1,fsdp=1,expert=2')])
def test_one_launch_trains_as_a_gang_of_its_ranks(tmp_path, model, mesh):
    flags = FLAGS + ['--model', model, '--steps', '2']
    one = launch.run(launch.parse_args(flags))
    out = tmp_path / 'ranks'
    out.mkdir()
    proc = subprocess.run(
        [sys.executable, WORKER, 'host', str(out), '--fp32', '--'] + flags +
        ['--mesh', mesh, '--procs-per-host', '2'], env=_env(), cwd=ROOT,
        timeout=100, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert re.search(r'Started 2 rank processes', proc.stderr)
    ranks = []
    for r in range(2):
        with open(out / f'rank-{r}.json', encoding='utf-8') as f:
            ranks.append(json.load(f))
    for rank in ranks:
        assert rank['losses'] == ranks[0]['losses']
        _close(rank['losses'], one['losses'])
        _close(rank['grad_norms'], one['grad_norms'])


def _pids(text):
    match = re.search(r'Started 2 rank processes on this host \(pids '
                      r'\[(\d+), (\d+)\]\)', text)
    assert match, text[-3000:]
    return [int(p) for p in match.groups()]


def _alive(pid) -> bool:
    """Whether ``pid`` is a live process (a zombie is not)."""
    try:
        with open(f'/proc/{pid}/stat', encoding='utf-8') as f:
            return f.read().rsplit(')', 1)[1].split()[0] != 'Z'
    except FileNotFoundError:
        return False


def _launcher(*flags, env=None):
    return subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.launch', '--model',
         'tiny', '--mesh', 'data=2', '--procs-per-host', '2'] + FLAGS +
        [str(f) for f in flags], env=_env(**(env or {})), cwd=ROOT,
        stderr=subprocess.PIPE, text=True)


def test_a_failing_rank_takes_the_host_down_with_its_code():
    plan = {'points': {'train.straggler_rank': {
        'match': {'rank': 1}, 'first_n': 1, 'signal': 'SIGKILL'}}}
    proc = _launcher('--steps', '50', env={
        'XSKY_CHAOS_PLAN': json.dumps(plan)})
    try:
        _, err = proc.communicate(timeout=100)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 128 + signal.SIGKILL, err[-3000:]
    assert 'A rank process exited with -9' in err
    for pid in _pids(err):
        assert not _alive(pid)


def test_sigterm_to_the_launcher_ends_every_rank():
    proc = _launcher('--steps', '100000')
    lines = []
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stderr.readline()
            lines.append(line)
            if 'step 1/' in line:   # rank 0 is training
                break
        pids = _pids(''.join(lines))
        assert all(_alive(pid) for pid in pids)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 128 + signal.SIGTERM, err[-3000:]
    for pid in pids:
        assert not _alive(pid)


def test_a_killed_launcher_leaves_no_rank():
    """SIGKILL to the launcher runs none of its code: each rank bound
    itself to the launcher (``distributed.bind_to_launcher``), so the
    kernel ends it."""
    proc = _launcher('--steps', '100000')
    lines = []
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stderr.readline()
            lines.append(line)
            if 'step 1/' in line:   # rank 0 is training
                break
        pids = _pids(''.join(lines))
        assert all(_alive(pid) for pid in pids)
        proc.kill()
        proc.wait()
        deadline = time.monotonic() + 30
        while any(_alive(pid) for pid in pids) and \
                time.monotonic() < deadline:
            time.sleep(0.1)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert not any(_alive(pid) for pid in pids)


def test_a_rank_whose_launcher_has_ended_exits():
    """A rank that binds itself after its launcher ended (its parent is
    another process) exits at once, with 1."""
    proc = subprocess.run(
        [sys.executable, '-c', 'from skypilot_tpu_torch.parallel import '
         'distributed; distributed.bind_to_launcher(); print("ran")'],
        env=_env(**{distributed.ENV_LAUNCHER_PID: '1'}), cwd=ROOT,
        timeout=60, capture_output=True, text=True)
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert 'ran' not in proc.stdout
    assert 'The launcher (pid 1) has ended' in proc.stderr


def test_auto_is_one_process_without_a_card(monkeypatch):
    assert distributed.host_process_count('auto', 'cpu') == 1
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    assert distributed.host_process_count('auto', 'cuda') == 1
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert distributed.host_process_count('auto', 'cuda') == 4
    assert distributed.host_process_count('auto', 'cpu') == 1
    assert distributed.host_process_count('3', 'cpu') == 3
    with pytest.raises(ValueError, match='procs-per-host'):
        distributed.host_process_count('0', 'cpu')

    def no_spawn(*args, **kwargs):
        raise AssertionError('a one-process launch started a process')
    monkeypatch.setattr(distributed, 'run_host', no_spawn)
    assert launch.main(FLAGS + ['--model', 'tiny', '--steps', '1']) == 0
    # A rank process runs itself, whatever --procs-per-host says.
    monkeypatch.setenv(distributed.ENV_LOCAL_RANK, '0')
    assert launch.main(FLAGS + ['--model', 'tiny', '--steps', '1',
                                '--procs-per-host', '2']) == 0
