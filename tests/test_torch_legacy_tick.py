"""The port's legacy decode tick vs the reference's, on the CPU.

``XSKY_DECODE_FAST_TICK=0`` pins ``Orchestrator._decode_tick_legacy``
(unmasked ``engine.decode_steps``, finish rules applied by the host row
by row). fp32 LLAMA_TINY, an fp32 KV cache; the JAX side runs its masked
XLA decode path (``XSKY_DECODE_ATTN=xla``) to stay fast. At
``decode_steps`` 1 and 4, with and without logprobs and penalties (and an
EOS that a request hits mid-batch), the legacy tick's greedy tokens equal
the fast tick's and the reference's legacy tick's; logprobs agree to
1e-4 (``tests/test_torch_engine.py``'s bound). ``engine.decode_steps``
gives the reference's tokens; ``infer.decode_stall`` is traversed once
per tick and a latency rule lengthens one tick. Every test runs under
its own 120 s SIGALRM, and every drain passes a small ``max_steps``.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import orchestrator as jax_orch
from skypilot_tpu.infer import sampling as jax_sampling
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.utils import chaos as jax_chaos
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.infer import sampling
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.utils import chaos

LP_ATOL = 1e-4
TEST_LIMIT_S = 120
MAX_STEPS = 64
NEW_TOKENS = 10
JCFG = dataclasses.replace(jax_llama.LLAMA_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
PROMPTS = [[int(t) for t in np.random.default_rng(40 + i).integers(0, 256, n)]
           for i, n in enumerate((4, 9, 17, 25, 6))]


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


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv('XSKY_DECODE_ATTN', 'xla')
    monkeypatch.delenv('XSKY_CHAOS_PLAN', raising=False)
    chaos.clear()
    jax_chaos.clear()
    yield
    chaos.clear()
    jax_chaos.clear()


@pytest.fixture(scope='module')
def params():
    jp = jax_llama.init(JCFG, jax.random.PRNGKey(4))
    return jp, llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), 'cpu')


def _engine(params, package):
    jp, tp = params
    if package == 'jax':
        return jax_engine.InferenceEngine(jax_engine.EngineConfig(
            model=JCFG, max_slots=4, max_target_len=64,
            prefill_buckets=(16, 32), kv_dtype=jnp.float32), jp)
    return engine_lib.InferenceEngine(engine_lib.EngineConfig(
        model=TCFG, max_slots=4, max_target_len=64,
        prefill_buckets=(16, 32), kv_dtype=torch.float32), tp,
        device='cpu')


def _serve(params, package, fast, decode_steps, monkeypatch, **request_kw):
    """Five prompts through 4 slots (a second admission wave follows
    releases) → (tokens per request, logprobs per request, orchestrator)."""
    monkeypatch.setenv('XSKY_DECODE_FAST_TICK', '1' if fast else '0')
    mod = jax_orch if package == 'jax' else orch_lib
    orch = mod.Orchestrator(_engine(params, package),
                            decode_steps=decode_steps)
    assert orch._fast_tick == fast
    requests = []
    for i, prompt in enumerate(PROMPTS):
        kw = {k: (v[i] if isinstance(v, list) else v)
              for k, v in request_kw.items()}
        requests.append(orch.submit(mod.Request(
            prompt_tokens=prompt, max_new_tokens=NEW_TOKENS, **kw)))
    orch.run_until_drained(max_steps=MAX_STEPS)
    assert all(r.done and r.error is None for r in requests)
    return ([r.output_tokens for r in requests],
            [r.token_logprobs for r in requests], orch)


CASES = {
    'greedy': {},
    'logprobs-penalties': {'logprobs': 3,
                           'presence_penalty': [0.5, 0.0, 1.0, 0.3, 0.0],
                           'frequency_penalty': [0.2, 0.0, 0.0, 0.7, 0.4]},
}


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('decode_steps', [1, 4])
def test_legacy_tick_tokens_match_fast_and_reference(params, monkeypatch,
                                                     decode_steps, case):
    kw = dict(CASES[case])
    # An EOS that request 1 meets mid-stream (its fourth greedy token).
    first, _, _ = _serve(params, 'port', True, decode_steps, monkeypatch,
                         **kw)
    eos = first[1][3]
    kw['eos_token_id'] = [None, eos, None, None, None]
    fast, fast_lp, _ = _serve(params, 'port', True, decode_steps,
                              monkeypatch, **kw)
    legacy, legacy_lp, orch = _serve(params, 'port', False, decode_steps,
                                     monkeypatch, **kw)
    want, want_lp, ref = _serve(params, 'jax', False, decode_steps,
                                monkeypatch, **kw)
    assert legacy == fast == want
    assert len(legacy[1]) < NEW_TOKENS and eos not in legacy[1]
    assert orch.wasted_decode_steps == ref.wasted_decode_steps
    if decode_steps > 1:
        assert orch.wasted_decode_steps > 0, (legacy, eos)
    if 'logprobs' in kw:
        for got, fast_row, want_row in zip(legacy_lp, fast_lp, want_lp):
            assert len(got) == len(want_row) == len(fast_row)
            np.testing.assert_allclose(got, want_row, atol=LP_ATOL)
            np.testing.assert_allclose(got, fast_row, atol=LP_ATOL)


@pytest.mark.parametrize('logprobs', [False, True])
def test_engine_decode_steps_match_the_reference(params, logprobs):
    jeng, teng = _engine(params, 'jax'), _engine(params, 'port')
    args = [(p, jax_sampling.SamplingParams()) for p in PROMPTS[:3]]
    targs = [(p, sampling.SamplingParams()) for p in PROMPTS[:3]]
    slots = [0, 2, 3]
    js, jfirst = jeng.prefill_insert_batch(jeng.init_decode_state(), args,
                                           slots)
    ts, tfirst = teng.prefill_insert_batch(teng.init_decode_state(), targs,
                                           slots)
    assert tfirst == jfirst
    kw = {}
    if logprobs:
        kw = {'logprobs_k': 5,
              'penalties': ([0.5, 0.0, 0.3, 1.0], [0.2, 0.0, 0.7, 0.0])}
    for _ in range(2):
        jout = jeng.decode_steps(js, 4, **kw)
        tout = teng.decode_steps(ts, 4, **kw)
        js, ts = jout[0], tout[0]
        assert tuple(tout[1].shape) == (4, 4)
        np.testing.assert_array_equal(tout[1].numpy()[:, slots],
                                      np.asarray(jout[1])[:, slots])
        if logprobs:
            for got, want in zip(tout[2], jout[2]):
                assert tuple(got.shape) == np.asarray(want).shape
                np.testing.assert_allclose(got.numpy()[:, slots],
                                           np.asarray(want)[:, slots],
                                           atol=LP_ATOL)
    np.testing.assert_array_equal(ts['lengths'].numpy(),
                                  np.asarray(js['lengths']))


def _own_thread_injects(monkeypatch):
    """Only this test's thread reaches the chaos points. A reference
    ServingLoop that another test module of the same worker process left
    running steps its orchestrator about once a second, and each step
    traverses ``infer.decode_stall``: one more hit, and the plan's rule
    may fire on that thread instead of this test's second tick."""
    me = threading.get_ident()
    for mod in (chaos, jax_chaos):
        monkeypatch.setattr(
            mod, 'inject', lambda *a, _inject=mod.inject, **k: (
                _inject(*a, **k) if threading.get_ident() == me else None))


@pytest.mark.parametrize('fast', [True, False], ids=['fast', 'legacy'])
def test_decode_stall_lengthens_one_tick(params, monkeypatch, fast):
    _own_thread_injects(monkeypatch)
    monkeypatch.setenv('XSKY_DECODE_FAST_TICK', '1' if fast else '0')
    plan = {'points': {'infer.decode_stall': {'skip_first': 1,
                                              'first_n': 1,
                                              'latency_s': 0.2}}}
    seen = {}
    for package, mod, mod_chaos in (('port', orch_lib, chaos),
                                    ('jax', jax_orch, jax_chaos)):
        orch = mod.Orchestrator(_engine(params, package), decode_steps=2)
        orch.generate([PROMPTS[0]], max_new_tokens=1)   # warm-up
        mod_chaos.load_plan(plan)
        orch.submit(mod.Request(prompt_tokens=PROMPTS[1],
                                max_new_tokens=7))
        ticks, fired = [], []
        for _ in range(MAX_STEPS):
            if not (orch._slot_req or not orch._pending.empty()):
                break
            t0 = time.perf_counter()
            orch.step()
            ticks.append(time.perf_counter() - t0)
            fired.append(mod_chaos.fired().get('infer.decode_stall', 0))
        # One traversal per tick; the second tick's rule fired, and that
        # tick slept its 0.2 s.
        assert mod_chaos.hits('infer.decode_stall') == len(ticks) > 2
        assert ticks[1] >= 0.2
        seen[package] = fired
        mod_chaos.clear()
    assert seen['port'] == seen['jax'] == [0] + [1] * (len(seen['port']) - 1)
