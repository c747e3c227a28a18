"""The port's chaos points vs the reference's, on the CPU.

``skypilot_tpu_torch/utils/chaos.py`` against ``skypilot_tpu/utils/
chaos.py``: the same plan and the same hit sequence fire on the same hits
for every selector, the seeded ``probability`` and a rule list; a broken
plan runs chaos-free; the two pinned departures (no recovery-event
journal row, a span annotation and an in-process count instead; error
names from builtins, not from ``skypilot_tpu.exceptions``); and each hook
point at its site with the reference's effect on the same plan:
``telemetry.stall`` freezes progress while the heartbeat goes on,
``train.straggler_rank`` and ``train.data_stall`` land in
``device_compute`` and ``data_wait``, and ``ckpt.write``,
``ckpt.replicate`` and ``ckpt.restore`` give the reference checkpointd's
restore outcome and tier. Every test runs under its own 120 s SIGALRM
and a tmp ``XSKY_STATE_DB`` (the reference journals its fires there).
"""
from __future__ import annotations

import json
import signal
import threading
import time

import pytest

from skypilot_tpu import exceptions as jax_exceptions
from skypilot_tpu import state as jax_state
from skypilot_tpu.agent import checkpointd as jax_checkpointd
from skypilot_tpu.agent import flight_recorder as jax_flight_recorder
from skypilot_tpu.agent import telemetry as jax_telemetry
from skypilot_tpu.utils import chaos as jax_chaos
from skypilot_tpu_torch.agent import checkpointd
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.agent import telemetry
from skypilot_tpu_torch.utils import chaos
from skypilot_tpu_torch.utils import tracing

TEST_LIMIT_S = 120
PACKAGES = {
    'port': (chaos, telemetry, flight_recorder, checkpointd),
    'jax': (jax_chaos, jax_telemetry, jax_flight_recorder, jax_checkpointd),
}


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
    for mods in PACKAGES.values():
        mods[0].clear()
        mods[1].reset_for_test()
        mods[2].reset_for_test()
        mods[3].reset_for_test()
    jax_state.reset_for_test()


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for env in ('XSKY_CHAOS_PLAN', 'XSKY_HOST_RANK', 'XSKY_TELEMETRY_DIR',
                'XSKY_FLIGHTREC_DIR', 'XSKY_CKPT_DIR'):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv('XSKY_STATE_DB', str(tmp_path / 'state.db'))
    _reset()
    yield
    _reset()


# ---- the same plan fires on the same hits ----------------------------------

# Each case: a plan and a hit sequence of (point, ctx).
HITS = [('p', {'rank': i % 3, 'tier': 'local' if i % 2 else 'peer'})
        for i in range(40)]
PLANS = {
    'first_n': {'points': {'p': {'first_n': 3}}},
    'every_kth': {'points': {'p': {'every_kth': 4}}},
    'skip_first': {'points': {'p': {'skip_first': 5, 'first_n': 2}}},
    'skip_every': {'points': {'p': {'skip_first': 3, 'every_kth': 5}}},
    'match': {'points': {'p': {'match': {'rank': 1}, 'first_n': 2}}},
    'probability': {'seed': 7, 'points': {'p': {'probability': 0.3}}},
    'probability-unseeded-match': {'seed': 11, 'points': {'p': {
        'match': {'tier': 'peer'}, 'probability': 0.5, 'skip_first': 2}}},
    'rule-list': {'seed': 3, 'points': {'p': [
        {'match': {'rank': 2}, 'first_n': 2, 'latency_s': 0},
        {'every_kth': 3, 'probability': 0.6},
        {'match': {'tier': 'local'}, 'skip_first': 10}]}},
    'other-point': {'points': {'q': {'first_n': 100}}},
}


@pytest.mark.parametrize('plan', sorted(PLANS))
def test_same_plan_fires_on_the_same_hits(plan):
    fired = {}
    for name, (mod, *_) in PACKAGES.items():
        mod.load_plan(PLANS[plan])
        fired[name] = [mod.inject(point, **ctx) for point, ctx in HITS]
        fired[name + '-counts'] = (mod.counters(), mod.fired(),
                                   mod.hits('p'), mod.enabled())
        mod.clear()
    assert fired['port'] == fired['jax']
    assert fired['port-counts'] == fired['jax-counts']
    if plan != 'other-point':
        assert any(r is not None for r in fired['port'])
    assert not chaos.enabled() and chaos.counters() == {}


def test_plan_from_the_environment_and_from_a_file(monkeypatch, tmp_path):
    plan = {'points': {'p': {'every_kth': 2, 'code': 7}}}
    path = tmp_path / 'plan.json'
    path.write_text(json.dumps(plan))
    for src in (json.dumps(plan), str(path)):
        monkeypatch.setenv('XSKY_CHAOS_PLAN', src)
        for mod in (chaos, jax_chaos):
            got = [mod.inject('p') for _ in range(4)]
            assert got == [None, plan['points']['p'], None,
                           plan['points']['p']]
            mod.clear()


@pytest.mark.parametrize('src', ['{not json', '[1, 2]', '/no/such/plan'])
def test_a_broken_plan_runs_chaos_free(monkeypatch, src):
    monkeypatch.setenv('XSKY_CHAOS_PLAN', src)
    for mod in (chaos, jax_chaos):
        assert mod.inject('p') is None
        assert not mod.enabled()
        assert mod.counters() == {} and mod.fired() == {}


def test_actions_match_the_reference(monkeypatch):
    plan = {'points': {'slow': {'latency_s': 0.05},
                       'err': {'error': 'TimeoutError'},
                       'unknown': {'error': 'NoSuchErrorName'},
                       'code': {'returncode': 255}}}
    for mod in (chaos, jax_chaos):
        mod.load_plan(plan)
        t0 = time.monotonic()
        assert mod.inject('slow') == {'latency_s': 0.05}
        assert time.monotonic() - t0 >= 0.05
        with pytest.raises(TimeoutError, match='injected TimeoutError'):
            mod.inject('err')
        with pytest.raises(mod.ChaosError):
            mod.inject('unknown')
        assert mod.inject('code') == {'returncode': 255}
        mod.clear()


# ---- the two pinned departures ---------------------------------------------

def test_a_fire_is_noted_on_the_span_not_journalled():
    """The reference journals a fire in the control plane's state DB; the
    port notes it on its current span and counts it in process."""
    plan = {'points': {'p': {'first_n': 1, 'latency_s': 0.01}}}
    jax_chaos.load_plan(plan)
    jax_chaos.inject('p', rank=0)
    rows = jax_state.get_recovery_events(event_type='chaos.injected')
    assert [(r['scope'], r['cause']) for r in rows] == [('chaos/p',
                                                         'latency')]
    chaos.load_plan(plan)
    with tracing.request_span(None, 'outer') as span:
        chaos.inject('p', rank=0)
        chaos.inject('p', rank=0)    # past first_n: not fired
    fires = span.attrs['chaos_fires']
    assert [(f['point'], f['cause']) for f in fires] == [('p', 'latency')]
    assert fires[0]['latency_s'] >= 0.01
    assert chaos.fired() == {'p': 1} and chaos.hits('p') == 2
    # Nothing of the port reached the journal.
    assert len(jax_state.get_recovery_events(
        event_type='chaos.injected')) == 1


def test_error_names_resolve_from_builtins_only():
    plan = {'points': {'cap': {'error': 'CapacityError'},
                       'builtin': {'error': 'ConnectionError'}}}
    jax_chaos.load_plan(plan)
    chaos.load_plan(plan)
    with pytest.raises(jax_exceptions.CapacityError):
        jax_chaos.inject('cap')
    with pytest.raises(chaos.ChaosError, match='CapacityError'):
        chaos.inject('cap')
    for mod in (chaos, jax_chaos):
        with pytest.raises(ConnectionError):
            mod.inject('builtin')


# ---- each hook point at its site -------------------------------------------

def _poll(fn, timeout_s=30.0):
    """fn()'s first truthy value, polled until timeout_s (the heartbeat
    thread runs on its own schedule)."""
    deadline = time.monotonic() + timeout_s
    while True:
        value = fn()
        if value or time.monotonic() > deadline:
            assert value, 'nothing came before the timeout'
            return value
        time.sleep(0.02)


def _newer_heartbeat(spool, first):
    sample = jax_telemetry.read_spool(str(spool)).get(0)
    return sample if sample and sample['hb_ts'] > first['hb_ts'] else None


def _own_thread_emits(monkeypatch):
    """Only this test's thread reaches the spools and the chaos counts. A
    reference ServingLoop that another test module of the same worker
    process left running declares itself idle about once a second through
    ``telemetry.emit``, reading the spool directory and rank from the
    environment as this test sets them: its emit is one more
    ``telemetry.stall`` hit (the fired count), and its idle sample (step
    None, new progress) replaces the rank's spool file between the test's
    writes and its read."""
    me = threading.get_ident()
    for mod in (telemetry, jax_telemetry):
        monkeypatch.setattr(
            mod, 'emit', lambda *a, _emit=mod.emit, **k: (
                _emit(*a, **k) if threading.get_ident() == me else None))


def test_telemetry_stall_freezes_progress_while_the_heartbeat_goes_on(
        monkeypatch, tmp_path):
    _own_thread_emits(monkeypatch)
    monkeypatch.setenv('XSKY_TELEMETRY_INTERVAL_S', '0')
    monkeypatch.setenv('XSKY_HOST_RANK', '0')
    plan = {'points': {'telemetry.stall': {'match': {'rank': 0},
                                           'skip_first': 2}}}
    seen = {}
    for name, (mod_chaos, mod_tel, *_) in PACKAGES.items():
        spool = tmp_path / name
        monkeypatch.setenv('XSKY_TELEMETRY_DIR', str(spool))
        mod_chaos.load_plan(plan)
        for step in range(5):
            mod_tel.emit(phase='step', step=step)
        first = jax_telemetry.read_spool(str(spool))[0]
        later = _poll(lambda: _newer_heartbeat(spool, first))
        seen[name] = (first['step'], later['step'],
                      mod_chaos.fired()['telemetry.stall'])
        assert later['hb_ts'] > first['hb_ts']
        assert later['last_progress_ts'] == first['last_progress_ts']
        mod_tel.reset_for_test()
        mod_chaos.clear()
    assert seen['port'] == seen['jax'] == (1, 1, 3)


def test_a_stale_rank_seals_one_stall_dump(monkeypatch, tmp_path):
    monkeypatch.setenv('XSKY_TELEMETRY_INTERVAL_S', '0')
    monkeypatch.setenv('XSKY_TELEMETRY_PROGRESS_STALE_S', '0.1')
    monkeypatch.setenv('XSKY_FLIGHTREC_DIR', str(tmp_path / 'dumps'))
    monkeypatch.setenv('XSKY_TELEMETRY_DIR', str(tmp_path / 'spool'))
    flight_recorder.begin_step(0)
    flight_recorder.record_step(0)
    telemetry.emit(phase='step', step=0)
    # Progress goes stale while the heartbeat runs on.
    _poll(lambda: list((tmp_path / 'dumps').glob('*stall_verdict*.json')))
    time.sleep(0.3)                  # a few more heartbeats
    dumps = sorted((tmp_path / 'dumps').glob('*stall_verdict*.json'))
    assert len(dumps) == 1           # latched once per episode
    blob = json.loads(dumps[0].read_text())
    assert blob['reason'] == 'stall_verdict'
    assert blob['detail']['progress_age_s'] > 0.1
    assert blob['last_step'] == 0


@pytest.mark.parametrize('point,phase_name,rule_key', [
    ('train.straggler_rank', 'device_compute', 'extra_s'),
    ('train.data_stall', 'data_wait', 'stall_s')])
def test_training_points_land_in_their_phase(monkeypatch, point, phase_name,
                                             rule_key):
    monkeypatch.setenv('XSKY_HOST_RANK', '0')
    plan = {'points': {point: {'match': {'rank': 0}, 'first_n': 1,
                               rule_key: 0.08}}}
    records = {}
    for name, (mod_chaos, _, mod_fr, _) in PACKAGES.items():
        mod_chaos.load_plan(plan)
        mod_fr.reset_for_test()
        for step in range(2):
            mod_fr.begin_step(step)
            with mod_fr.phase('data_wait'):
                pass
            mod_fr.mark_compute(0.001)
            mod_fr.record_step(step)
        records[name] = mod_fr.get_recorder().records()[::-1]
        assert mod_chaos.fired() == {point: 1}
        mod_chaos.clear()
    for name, recs in records.items():
        assert recs[0]['phases'][phase_name] >= 0.08, name
        assert recs[0]['wall_s'] >= 0.08, name
        assert recs[1]['phases'][phase_name] < 0.08, name
    # The same phases got the stall in both packages.
    assert [set(k for k, v in r['phases'].items() if v >= 0.08)
            for r in records['port']] == [
        set(k for k, v in r['phases'].items() if v >= 0.08)
        for r in records['jax']]


CKPT_PLANS = {
    # The first snapshot's write fails: only step 2 exists.
    'write': {'points': {'ckpt.write': {'first_n': 1,
                                        'error': 'OSError'}}},
    # No replica reaches the peer; the local reads fail: storage.
    'replicate+restore': {'points': {
        'ckpt.replicate': {'error': 'OSError'},
        'ckpt.restore': {'match': {'tier': 'local'},
                         'error': 'OSError'}}},
    # Replicas land, the freshest local read fails: the peer's copy.
    'restore-local': {'points': {
        'ckpt.restore': {'match': {'tier': 'local'}, 'first_n': 1,
                         'error': 'OSError'}}},
    # Every fast tier fails and so does the storage tier: cold.
    'restore-all': {'points': {'ckpt.restore': {'error': 'OSError'}}},
    # Fast tiers fail, storage answers.
    'restore-fast': {'points': {'ckpt.restore': [
        {'match': {'tier': 'storage'}, 'first_n': 0},
        {'match': {'tier': 'local'}, 'error': 'OSError'},
        {'match': {'tier': 'peer'}, 'error': 'OSError'}]}},
}


@pytest.mark.parametrize('plan', sorted(CKPT_PLANS))
def test_checkpoint_points_give_the_reference_outcome(tmp_path, plan):
    outcomes = {}
    for name, (mod_chaos, _, _, mod_ckpt) in PACKAGES.items():
        root = tmp_path / name
        mod_chaos.load_plan(CKPT_PLANS[plan])
        writer = mod_ckpt.Checkpointer(str(root / 'fast'),
                                       peer_dirs=(str(root / 'peer'),))
        for step in (1, 2):
            assert writer.maybe_checkpoint_impl(
                step, lambda s=step: {'step': s}, force=True)
            assert writer.wait_idle(timeout=60)
        writer.stop()
        reader = mod_ckpt.Checkpointer(str(root / 'fast'),
                                       peer_dirs=(str(root / 'peer'),))
        snap = reader.restore_impl(storage_fn=lambda: (1, {'step': 1}))
        # The reference's replication runs on its host fan-out, whose
        # own point (`fanout.worker`) the port's thread pool has not.
        outcomes[name] = (snap.step, snap.tier,
                          snap.payload and snap.payload['step'],
                          sorted((k, v) for k, v in
                                 mod_chaos.counters().items()
                                 if k != 'fanout.worker'),
                          sorted(mod_chaos.fired().items()))
        mod_chaos.clear()
    assert outcomes['port'] == outcomes['jax']
    assert outcomes['port'][:2] == {
        'write': (2, 'local'), 'replicate+restore': (1, 'storage'),
        'restore-local': (2, 'peer'), 'restore-all': (0, 'cold'),
        'restore-fast': (1, 'storage')}[plan]
