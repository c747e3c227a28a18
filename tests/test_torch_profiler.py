"""The port's profiler (workload half) vs the reference's, on the CPU.

``skypilot_tpu_torch/agent/profiler.py`` against
``skypilot_tpu/agent/profiler.py``: the sampling cadence and the disabled
path, the anatomy's EMAs, ratio and warmup split over one observation
series, the fake-mode ``profile`` on the telemetry spool, the
``profiler.dispatch_stall`` chaos point, the compile count of an
``nvcc`` build (a stand-in script; this machine has no ``nvcc``) and of
a cache load, the reference's control plane (``record_profiles`` /
``verdicts_for`` over a tmp state DB) reading the port's spool samples,
``capture`` in fake mode and on the CPU (a parseable Chrome trace), and
the Trainer's sampled step handing its probe pair to the flight
recorder. Every test runs under its own 120 s SIGALRM.
"""
from __future__ import annotations

import json
import signal
import threading

import pytest
import torch

from skypilot_tpu.agent import profiler as jax_profiler
from skypilot_tpu.agent import telemetry as jax_telemetry
from skypilot_tpu.utils import chaos as jax_chaos
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.agent import profiler
from skypilot_tpu_torch.agent import telemetry
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import kernels
from skypilot_tpu_torch.train import trainer as trainer_lib
from skypilot_tpu_torch.utils import chaos

TEST_LIMIT_S = 120
# The reference's capture summary keys (agent/profiler.py run_capture).
CAPTURE_KEYS = {'ts', 'duration_s', 'out_dir', 'fake', 'device_kind',
                'num_devices', 'probe_compile_s', 'dispatch_probes',
                'dispatch_rtt_ms', 'device_matmul_ms', 'bytes_in_use',
                'bytes_limit', 'trace_files'}


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        del signum, frame
        raise TimeoutError(f'test ran past its {TEST_LIMIT_S} s limit')

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def _reset():
    for mod in (profiler, jax_profiler, telemetry, jax_telemetry):
        mod.reset_for_test()
    chaos.clear()
    jax_chaos.clear()
    flight_recorder.reset_for_test()


def _own_thread_emits(monkeypatch):
    """Only this test's thread reaches the spools. Serving loops that
    other test modules of the same worker process left running (the
    reference's ServingLoop has no close, and declares itself idle about
    once a second through ``telemetry.emit``) read the spool directory
    and rank from the environment as these tests set them: such an idle
    sample, with no ``profile``, could replace a rank's spool file
    between the test's last write and its read (seen as ``[] ==
    [['host-bound']]`` under a whole run's load)."""
    me = threading.get_ident()
    for mod in (telemetry, jax_telemetry):
        monkeypatch.setattr(
            mod, 'emit', lambda *a, _emit=mod.emit, **k: (
                _emit(*a, **k) if threading.get_ident() == me else None))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for env in (profiler.ENV_ENABLED, profiler.ENV_SAMPLE_EVERY,
                profiler.ENV_FAKE, profiler.ENV_FAKE_DISPATCH,
                profiler.ENV_FAKE_DEVICE, profiler.ENV_FAKE_HBM_USE,
                profiler.ENV_FAKE_HBM_LIMIT, profiler.ENV_WARMUP_STEPS,
                telemetry.ENV_DIR, 'XSKY_CHAOS_PLAN', 'XSKY_HOST_RANK'):
        monkeypatch.delenv(env, raising=False)
    _own_thread_emits(monkeypatch)
    _reset()
    yield
    _reset()


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setenv(profiler.ENV_FAKE, '1')
    monkeypatch.setenv(profiler.ENV_SAMPLE_EVERY, '1')


def _spool(monkeypatch, directory):
    monkeypatch.setenv(telemetry.ENV_DIR, str(directory))
    monkeypatch.setenv(telemetry.ENV_RANK, '0')
    monkeypatch.setenv(telemetry.ENV_INTERVAL, '0')


@pytest.mark.parametrize('enabled,every,steps', [
    (None, '4', 8), (None, None, 40), ('0', '4', 8), (None, 'x', 20),
    ('1', '1', 3)], ids=['every-4', 'default-16', 'disabled',
                         'bad-value', 'every-step'])
def test_sampling_cadence_matches_the_reference(monkeypatch, enabled,
                                                every, steps):
    for name, value in ((profiler.ENV_ENABLED, enabled),
                        (profiler.ENV_SAMPLE_EVERY, every)):
        if value is not None:
            monkeypatch.setenv(name, value)
    got = [profiler.step_probe() is not None for _ in range(steps)]
    want = [jax_profiler.step_probe() is not None for _ in range(steps)]
    assert got == want
    if every == '4' and enabled is None:
        assert got == [False, False, False, True] * 2
    if enabled == '0':
        assert not any(got)


def _feed(mod, series):
    """One observation series into a module's anatomy: steps seen,
    sampled observations and compiles at the steps given."""
    anatomy = mod._get_anatomy()
    for kind, *args in series:
        if kind == 'step':
            anatomy.steps_seen += 1
        elif kind == 'observe':
            anatomy.observe_step(*args)
        else:
            mod.record_compile(*args)
    return {k: v for k, v in anatomy.snapshot().items() if k != 'ts'}


def test_anatomy_series_matches_the_reference(fake, monkeypatch):
    monkeypatch.setenv(profiler.ENV_WARMUP_STEPS, '3')
    series = [('compile', 2.5), ('step',), ('observe', 0.010, 0.090),
              ('step',), ('step',), ('compile', 0.25), ('step',),
              ('observe', 0.113, 0.003), ('compile', 0.5), ('step',),
              ('observe', 0.002, 0.050), ('compile', 1.0)]
    got = _feed(profiler, series)
    want = _feed(jax_profiler, series)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12), key
    assert got['compiles_total'] == 4 and got['compiles_after_warmup'] == 2
    assert got['steps_sampled'] == 3


def test_fake_profile_on_the_spool_matches_the_reference(fake, monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv(profiler.ENV_FAKE_DISPATCH, '0.113')
    monkeypatch.setenv(profiler.ENV_FAKE_DEVICE, '0.003')
    profiles = {}
    for name, mod in (('port', profiler), ('jax', jax_profiler)):
        _spool(monkeypatch, tmp_path / name)
        for _ in range(4):
            probe = mod.step_probe()
            assert probe is not None
            assert probe.done() == pytest.approx((0.113, 0.003))
        mod.record_compile(0.5)
        mod.step_probe().done()
        # The reference's own reader parses both spools.
        sample = jax_telemetry.read_spool(str(tmp_path / name))[0]
        profiles[name] = {k: v for k, v in sample['profile'].items()
                          if k != 'ts'}
    assert profiles['port'] == profiles['jax']
    prof = profiles['port']
    assert prof['steps_sampled'] == 5
    assert prof['dispatch_gap_ratio'] == pytest.approx(0.113 / 0.116)
    assert 0 < prof['hbm_bytes_in_use'] < prof['hbm_bytes_limit']


def test_dispatch_stall_inflates_the_gap(fake, monkeypatch):
    monkeypatch.setenv('XSKY_HOST_RANK', '0')
    chaos.load_plan({'points': {
        'profiler.dispatch_stall': {'match': {'rank': 0}, 'gap_s': 0.5}}})
    gap, _ = profiler.step_probe().done()
    assert gap == pytest.approx(0.501)
    snap = profiler.snapshot()
    assert snap['dispatch_gap_ema_s'] == pytest.approx(0.501)
    assert snap['dispatch_gap_ratio'] > 0.9
    assert chaos.hits('profiler.dispatch_stall') == 1
    assert chaos.fired() == {'profiler.dispatch_stall': 1}
    monkeypatch.setenv('XSKY_HOST_RANK', '1')   # another rank: untouched
    profiler.step_probe().done()
    assert profiler.snapshot()['dispatch_gap_ema_s'] < 0.5


def test_real_probe_on_the_cpu_never_raises(monkeypatch):
    monkeypatch.setenv(profiler.ENV_SAMPLE_EVERY, '1')
    assert profiler.step_probe().done(out=object()) is not None
    gap, device = profiler.step_probe().done(
        out={'x': [torch.zeros(3), (torch.ones(2), 1)]})
    assert gap >= 0 and device >= 0
    # A process that never touched a card reports no HBM figures.
    assert profiler._hbm_stats() == {}
    snap = profiler.snapshot()
    assert snap['hbm_bytes_in_use'] is None and snap['steps_sampled'] == 2


def test_an_nvcc_build_counts_one_compile_and_a_cache_load_none(
        monkeypatch, tmp_path):
    monkeypatch.setattr(profiler, '_listener_installed', False)
    monkeypatch.setattr(kernels, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(kernels, 'REGISTRY', [])
    monkeypatch.setattr(kernels.Kernel, '_load',
                        lambda self, path: setattr(self, '_fn', print))
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text('#!/bin/sh\nsleep 0.05\nwhile [ $# -gt 1 ]; do '
                    '[ "$1" = -o ] && out=$2; shift; done\n: > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, 'nvcc_path', lambda: str(nvcc))
    # Before the listener is installed a build counts nothing.
    kernels.build_all([kernels.Kernel('a', 'flash_fwd.cu', 's', [])])
    assert profiler.snapshot()['compiles_total'] == 0
    profiler.ensure_compile_listener()
    kernels.build_all([kernels.Kernel('b', 'decode_attention.cu', 's',
                                      [])])
    snap = profiler.snapshot()
    assert snap['compiles_total'] == 1
    assert snap['compile_seconds_total'] >= 0.05
    # Both libraries are in the cache now: loading them is no build.
    kernels.build_all([kernels.Kernel('c', 'flash_fwd.cu', 's', []),
                       kernels.Kernel('d', 'decode_attention.cu', 's', [])])
    assert profiler.snapshot()['compiles_total'] == 1
    # A build whose profiler report fails still builds.
    monkeypatch.setattr(profiler, 'note_kernel_build',
                        lambda seconds: 1 / 0)
    kern = kernels.Kernel('e', 'mla_decode.cu', 's', [])
    kernels.build_all([kern])
    assert kern.loaded


SCENARIOS = {
    'healthy': ([], {}),
    'host-bound': (['host-bound'], {profiler.ENV_FAKE_DISPATCH: '0.113',
                                    profiler.ENV_FAKE_DEVICE: '0.003'}),
    'recompile-storm': (['recompile-storm'], {}),
    'hbm-pressure': (['hbm-pressure'], {
        profiler.ENV_FAKE_HBM_USE: str(15 << 30),
        profiler.ENV_FAKE_HBM_LIMIT: str(16 << 30)}),
}


@pytest.mark.parametrize('scenario', sorted(SCENARIOS))
def test_reference_control_plane_reads_the_port_samples(
        fake, monkeypatch, tmp_path, scenario):
    from skypilot_tpu import state
    monkeypatch.setenv('XSKY_STATE_DB', str(tmp_path / 'state.db'))
    state.reset_for_test()
    want, env = SCENARIOS[scenario]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv(profiler.ENV_WARMUP_STEPS, '2')
    verdicts = {}
    try:
        for name, mod in (('port', profiler), ('jax', jax_profiler)):
            _spool(monkeypatch, tmp_path / name)
            for step in range(6):
                mod.step_probe().done()
                if scenario == 'recompile-storm' and step >= 2:
                    mod.record_compile(0.1)
            samples = jax_telemetry.read_spool(str(tmp_path / name))
            verdicts[name] = jax_profiler.record_profiles(
                f'c-{name}', 1, samples)
            rows = state.get_profiles(cluster=f'c-{name}')
            assert [r['verdicts'] for r in rows] == [want]
            assert jax_profiler.verdicts_for(samples[0]['profile']) == want
    finally:
        state.reset_for_test()
    assert verdicts['port'] == verdicts['jax'] == {0: want}


def test_capture_in_fake_mode_has_the_reference_keys(fake, tmp_path):
    got = profiler.run_capture(str(tmp_path / 'port'), 0.5)
    want = jax_profiler.run_capture(str(tmp_path / 'jax'), 0.5)
    assert set(got) == set(want) == CAPTURE_KEYS
    for key in CAPTURE_KEYS - {'ts', 'out_dir'}:
        assert got[key] == want[key], key
    assert (tmp_path / 'port' / 'capture.json').exists()


def test_capture_on_the_cpu_writes_a_chrome_trace(tmp_path, capsys):
    out = tmp_path / 'cap'
    assert profiler.main(['capture', '--out', str(out), '--duration',
                          '0.2', '--device', 'cpu']) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 'error' not in summary, summary
    assert set(summary) == CAPTURE_KEYS
    assert summary['device_kind'] == 'cpu' and not summary['fake']
    assert summary['dispatch_probes'] >= 1
    assert summary['probe_compile_s'] > 0
    assert summary['dispatch_rtt_ms'] > 0
    assert summary['device_matmul_ms'] > 0
    assert profiler.TRACE_FILE in summary['trace_files']
    with open(out / profiler.TRACE_FILE) as f:
        trace = json.load(f)
    names = {e.get('name') for e in trace['traceEvents']}
    assert any('bessel_j0' in str(n) for n in names)


def test_capture_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        profiler.main(['capture', '--out', str(tmp_path)])


def test_trainer_hands_the_sampled_pair_to_the_flight_recorder(
        monkeypatch):
    """A sampled step's record is synced and carries the probe's device
    time; an unsampled step's is not synced."""
    monkeypatch.setenv(profiler.ENV_SAMPLE_EVERY, '2')
    calls = []
    real = flight_recorder.mark_compute

    def spy(dispatch_s, device_s=None, synced=False):
        calls.append((dispatch_s, device_s, synced))
        real(dispatch_s, device_s, synced=synced)

    monkeypatch.setattr(flight_recorder, 'mark_compute', spy)
    tr = trainer_lib.Trainer(trainer_lib.TrainConfig(
        model=llama.LLAMA_TINY, global_batch_size=2, seq_len=8),
        device='cpu')
    state = tr.init_state()
    gen = torch.Generator()
    gen.manual_seed(0)
    tokens = torch.randint(0, 256, (2, 9), generator=gen)
    batch = {'tokens': tokens[:, :-1], 'targets': tokens[:, 1:]}
    for step in range(4):
        flight_recorder.begin_step(step)
        state, _ = tr.step(state, batch)
        flight_recorder.record_step()
    records = flight_recorder.get_recorder().records()[::-1]
    assert [r['synced'] for r in records] == [False, True, False, True]
    assert [c[2] for c in calls] == [False, True, False, True]
    assert all(c[1] is None for c in calls[::2])
    assert all(c[1] is not None and c[1] >= 0 for c in calls[1::2])
    assert profiler.snapshot()['steps_sampled'] == 2
