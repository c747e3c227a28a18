"""PyTorch port's speculative decoding vs the JAX reference's, on the CPU:
``verify_step``, ``NgramSpeculator`` and ``SpeculativeOrchestrator`` over
an fp32 LLAMA_TINY target (and a one-layer draft), with an fp32 or int8
KV cache.

Weights come from the JAX ``init`` in fp32 and cross with
``params_from_numpy``; prompts come from a numpy seed. The JAX engines
take their masked XLA decode path (XSKY_DECODE_ATTN=xla, set here for the
module as the reference's own speculative tests set it), so that verify
and plain decode are one numeric path there. Tolerances: tokens,
``n_emitted`` and ``accept_stats`` identical; verified cache rows within
1e-5 of the JAX cache (fp32 through two layers in another summation
order).

The JAX engines are built once for the module (the target, the draft,
and the target over an int8 cache); every test runs under a hard time
limit of its own (``_time_limit``) and every drain has an explicit step
bound. The Qwen3 target is held in test_torch_speculative_qwen.py.
"""
from __future__ import annotations

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import orchestrator as jax_orch
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.models import llama

TEST_LIMIT_S = 120
MAX_STEPS = 64
KV_ATOL = 1e-5
SLOTS = 4
MAX_LEN = 64
BUCKETS = (16, 32)
TARGET = dict(jax=dataclasses.replace(jax_llama.LLAMA_TINY,
                                      dtype=jnp.float32),
              port=dataclasses.replace(llama.LLAMA_TINY,
                                       dtype=torch.float32))
DRAFT_WIDTHS = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                    d_ff=64)
DRAFT = {k: dataclasses.replace(v, **DRAFT_WIDTHS) for k, v in
         TARGET.items()}
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(0, 256, n)]
           for i, n in enumerate((5, 3, 11, 2))]
# Copy-heavy: an 8-token block repeated, so prompt lookup finds grams.
COPY = [int(t) for t in np.random.default_rng(9).integers(0, 256, 8)] * 3
# Past the largest bucket (32): prefilled in chunks, the draft too.
LONG = [int(t) for t in np.random.default_rng(8).integers(0, 256, 50)]


@pytest.fixture(scope='module', autouse=True)
def _xla_decode_path():
    """The JAX engines trace under XSKY_DECODE_ATTN=xla (module-scoped:
    the engines below are built once)."""
    prev = os.environ.get('XSKY_DECODE_ATTN')
    os.environ['XSKY_DECODE_ATTN'] = 'xla'
    yield
    if prev is None:
        os.environ.pop('XSKY_DECODE_ATTN', None)
    else:
        os.environ['XSKY_DECODE_ATTN'] = prev


@pytest.fixture(autouse=True)
def _time_limit():
    """Fail a test that runs past TEST_LIMIT_S seconds (SIGALRM), so a
    hang costs one test, not the whole run."""
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


def _pair(cfgs, seed, **over):
    """{'jax': engine, 'port': engine} over the same fp32 weights."""
    tree = jax_llama.init(cfgs['jax'], jax.random.PRNGKey(seed))
    kv = over.pop('kv', 'fp32')
    common = dict(max_slots=over.pop('max_slots', SLOTS),
                  max_target_len=MAX_LEN, prefill_buckets=BUCKETS, **over)
    return {
        'jax': jax_engine.InferenceEngine(jax_engine.EngineConfig(
            model=cfgs['jax'], kv_dtype={'fp32': jnp.float32,
                                         'int8': jnp.int8}[kv],
            **common), tree),
        'port': engine_lib.InferenceEngine(engine_lib.EngineConfig(
            model=cfgs['port'], kv_dtype={'fp32': torch.float32,
                                          'int8': torch.int8}[kv],
            **common), llama.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, tree), 'cpu'),
            device='cpu'),
    }


@pytest.fixture(scope='module')
def target():
    return _pair(TARGET, seed=0)


@pytest.fixture(scope='module')
def draft():
    return _pair(DRAFT, seed=7)


@pytest.fixture(scope='module')
def target_int8():
    return _pair(TARGET, seed=0, kv='int8')


MODS = {'jax': jax_orch, 'port': orch_lib}


def _drain(side, orch, prompts, new_tokens, **request_kw):
    """Submit and drain with an explicit step bound → requests."""
    requests = [orch.submit(MODS[side].Request(
        prompt_tokens=list(p), max_new_tokens=new_tokens, **request_kw))
        for p in prompts]
    orch.run_until_drained(max_steps=MAX_STEPS)
    assert all(r.done and r.error is None for r in requests)
    return requests


def _tokens(requests):
    return [r.output_tokens for r in requests]


def _plain(engines, prompts, new_tokens):
    """Plain greedy tokens of both packages (which must agree)."""
    out = {side: _tokens(_drain(side, MODS[side].Orchestrator(eng),
                                prompts, new_tokens))
           for side, eng in engines.items()}
    assert out['port'] == out['jax']
    return out['port']


def _host(x):
    return np.asarray(x if isinstance(x, (np.ndarray, jax.Array))
                      else x.cpu())


# ---- verify_step ----

@pytest.mark.parametrize('kv', ['fp32', 'int8'])
@pytest.mark.parametrize('kind', ['perfect', 'garbage'])
def test_verify_step_matches_jax(target, target_int8, kind, kv):
    """Perfect proposals (the plain greedy continuation) are all accepted
    and the bonus continues the chain; garbage proposals still emit
    exactly the next greedy token. emitted, n_emitted, the new lengths
    and tokens and the written cache rows equal JAX's; the rows before
    the slot's length are left as they were."""
    engines = target if kv == 'fp32' else target_int8
    gamma = 4
    expected = _plain(engines, [PROMPTS[0]], 8)[0]
    out = {}
    for side, eng in engines.items():
        orch = MODS[side].Orchestrator(eng)
        orch.submit(MODS[side].Request(prompt_tokens=list(PROMPTS[0]),
                                       max_new_tokens=8))
        orch._admit_one()
        slot = next(iter(orch._slot_req))
        proposals = np.full((SLOTS, gamma), 255, np.int32)
        if kind == 'perfect':
            proposals[slot] = expected[1:1 + gamma]
        length = len(PROMPTS[0])
        cache = orch.state['kv_k']
        before = _host(cache[0] if kv == 'int8' else cache)[
            :, slot, :length].copy()
        state, emitted, n_emitted = eng.verify_step(orch.state, proposals)
        cache = state['kv_k'][0] if kv == 'int8' else state['kv_k']
        after = _host(cache)[:, slot]
        np.testing.assert_array_equal(after[:, :length], before)
        out[side] = dict(emitted=_host(emitted)[slot],
                         n=int(_host(n_emitted)[slot]),
                         length=int(_host(state['lengths'])[slot]),
                         token=int(_host(state['tokens'])[slot]),
                         rows=after[:, length:length + gamma + 1])
    got, want = out['port'], out['jax']
    n = gamma + 1 if kind == 'perfect' else 1
    assert got['n'] == want['n'] == n
    np.testing.assert_array_equal(got['emitted'], want['emitted'])
    assert list(got['emitted'][:n]) == expected[1:1 + n]
    assert got['length'] == want['length'] == len(PROMPTS[0]) + n
    assert got['token'] == want['token'] == expected[n]
    if kv == 'int8':   # int8 codes: a rounding step may differ by one
        assert np.abs(got['rows'].astype(np.int32)
                      - want['rows'].astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got['rows'], want['rows'], atol=KV_ATOL,
                                   rtol=0)


def test_verify_step_clamps_at_the_cache_end(target):
    """A slot four rows from the end verifies γ = 6: its rows past the
    cache are not written (the JAX scatter drops them), its length clamps
    at max_target_len, and emitted equals JAX's."""
    out = {}
    prompt = [int(t) for t in np.random.default_rng(3).integers(0, 256, 28)]
    for side, eng in target.items():
        orch = MODS[side].Orchestrator(eng)
        orch.submit(MODS[side].Request(prompt_tokens=prompt,
                                       max_new_tokens=4))
        orch._admit_one()
        slot = next(iter(orch._slot_req))
        state = orch.state
        if side == 'jax':
            state = dict(state, lengths=state['lengths'].at[slot].set(
                MAX_LEN - 4))
        else:
            state['lengths'][slot] = MAX_LEN - 4
        proposals = np.full((SLOTS, 6), 3, np.int32)
        state, emitted, n_emitted = eng.verify_step(state, proposals)
        out[side] = (_host(emitted)[slot], int(_host(n_emitted)[slot]),
                     int(_host(state['lengths'])[slot]),
                     _host(state['kv_k'])[:, slot, MAX_LEN - 4:])
    np.testing.assert_array_equal(out['port'][0], out['jax'][0])
    assert out['port'][1:3] == out['jax'][1:3]
    assert out['port'][2] <= MAX_LEN
    np.testing.assert_allclose(out['port'][3], out['jax'][3], atol=KV_ATOL,
                               rtol=0)


def test_sync_slots_from_copies_and_does_not_alias(target, draft):
    """The draft's lengths, tokens and active are copies of the target's:
    an in-place update of either state afterwards leaves the other as it
    was."""
    teng, deng = target['port'], draft['port']
    tstate = teng.init_decode_state()
    tstate['lengths'][:] = torch.tensor([3, 5, 7, 9], dtype=torch.int32)
    tstate['active'][1] = True
    tstate['tokens'][1] = 42
    dstate = deng.sync_slots_from(deng.init_decode_state(), tstate)
    for key in ('lengths', 'tokens', 'active'):
        assert torch.equal(dstate[key], tstate[key])
        assert dstate[key].data_ptr() != tstate[key].data_ptr()
    teng.release_slot(tstate, 1)
    tstate['lengths'][0] = 60
    assert bool(dstate['active'][1]) and int(dstate['lengths'][0]) == 3
    dstate['tokens'][1] = 7
    assert int(tstate['tokens'][1]) == 42
    assert dstate['kv_k'].shape[0] == DRAFT['port'].n_layers


# ---- the speculators ----

def _speculator(side, kind, target, draft, gamma):
    mod = MODS[side]
    if kind == 'ngram':
        return mod.NgramSpeculator(target[side], gamma=gamma, match_len=2)
    other = target if kind == 'self-draft' else draft
    return mod.SpeculativeOrchestrator(target[side], other[side],
                                       gamma=gamma)


SPEC_CASES = {
    # kind, prompts, new tokens, γ
    'ngram': ('ngram', PROMPTS + [COPY], 12, 3),
    'draft': ('draft', PROMPTS + [COPY], 12, 4),
    'self-draft': ('self-draft', PROMPTS, 10, 3),
    # LONG is prefilled in chunks between rounds, its draft mirror too.
    'draft-chunked': ('draft', [LONG, PROMPTS[0], COPY], 10, 4),
}


@pytest.mark.parametrize('case', sorted(SPEC_CASES))
def test_speculators_match_jax_and_plain_greedy(target, draft, case):
    """Tokens and accept_stats equal JAX's, and the tokens equal plain
    greedy decoding; a self-draft accepts every proposal."""
    kind, prompts, new_tokens, gamma = SPEC_CASES[case]
    expected = _plain(target, prompts, new_tokens)
    out = {}
    for side in MODS:
        spec = _speculator(side, kind, target, draft, gamma)
        out[side] = (_tokens(_drain(side, spec, prompts, new_tokens)),
                     dict(spec.accept_stats))
    assert out['port'] == out['jax']
    tokens, stats = out['port']
    assert tokens == expected
    assert stats['rounds'] > 0
    if kind == 'self-draft':
        assert stats['accepted'] == stats['proposed']


def test_copyable_history_is_accepted(target):
    """A prompt whose greedy continuation repeats yields accepted prompt-
    lookup proposals, as many as JAX accepts."""
    plain = _plain(target, [COPY], 16)[0]
    stats = {}
    for side in MODS:
        ng = MODS[side].NgramSpeculator(target[side], gamma=4, match_len=2)
        assert _tokens(_drain(side, ng, [COPY], 16))[0] == plain
        stats[side] = ng.accept_stats
    assert stats['port'] == stats['jax']
    assert stats['port']['accepted'] > 0


def test_propose_prefers_the_most_recent_match(target):
    request = {side: MODS[side].Request(prompt_tokens=[1, 2, 7, 1, 2, 9, 1],
                                        output_tokens=[2]) for side in MODS}
    got = {side: MODS[side].NgramSpeculator(target[side], gamma=3)._propose(
        0, request[side]) for side in MODS}
    # The trailing (1, 2) last occurred at index 3, so 9 comes first.
    assert got['port'] == got['jax'] and got['port'][0] == 9
    short = MODS['port'].Request(prompt_tokens=[5], output_tokens=[6])
    assert orch_lib.NgramSpeculator(target['port'], gamma=3)._propose(
        0, short) == [6, 6, 6]


@pytest.mark.parametrize('kind', ['ngram', 'draft'])
def test_mixed_batch_falls_back_then_speculates(target, draft, kind):
    """A sampled request makes its rounds plain; once it has finished the
    greedy one speculates. The greedy tokens equal plain greedy and
    JAX's, accept_stats equal JAX's, the sampled request gets its
    budget."""
    expected = _plain(target, [PROMPTS[0]], 12)[0]
    out = {}
    for side in MODS:
        mod = MODS[side]
        spec = _speculator(side, kind, target, draft, 3)
        greedy = spec.submit(mod.Request(prompt_tokens=list(PROMPTS[0]),
                                         max_new_tokens=12))
        sampled = spec.submit(mod.Request(prompt_tokens=list(PROMPTS[1]),
                                          max_new_tokens=3, temperature=1.0))
        spec.run_until_drained(max_steps=MAX_STEPS)
        assert greedy.done and sampled.done
        assert len(sampled.output_tokens) == 3
        out[side] = (greedy.output_tokens, dict(spec.accept_stats))
    assert out['port'] == out['jax']
    assert out['port'][0] == expected
    assert out['port'][1]['rounds'] > 0


def test_speculation_resumes_after_mixed_phase(target, draft):
    """After a sampled request drains, a later greedy one goes back
    through speculative rounds and still gives plain greedy tokens (the
    device-resident sampling arrays are those of the reference)."""
    expected = _plain(target, [PROMPTS[2]], 8)[0]
    out = {}
    for side in MODS:
        spec = _speculator(side, 'draft', target, draft, 3)
        _drain(side, spec, [PROMPTS[1]], 4, temperature=0.8)
        rounds_before = spec.accept_stats['rounds']
        tokens = _tokens(_drain(side, spec, [PROMPTS[2]], 8))[0]
        assert spec.accept_stats['rounds'] > rounds_before
        out[side] = (tokens, dict(spec.accept_stats))
    assert out['port'] == out['jax']
    assert out['port'][0] == expected


def test_budgets_are_respected_up_to_the_cache_end(target, draft):
    """max_new_tokens 7 gives 7 tokens; a request whose budget runs past
    the cache is clamped to its end (prompt + new = max_target_len), and
    both give JAX's and plain greedy tokens."""
    prompts = [PROMPTS[0], LONG[:40]]
    out = {}
    for side in MODS:
        mod = MODS[side]
        spec = _speculator(side, 'draft', target, draft, 4)
        short = spec.submit(mod.Request(prompt_tokens=list(prompts[0]),
                                        max_new_tokens=7))
        long = spec.submit(mod.Request(prompt_tokens=list(prompts[1]),
                                       max_new_tokens=100))
        spec.run_until_drained(max_steps=MAX_STEPS)
        assert len(short.output_tokens) == 7
        assert len(long.output_tokens) == MAX_LEN - len(prompts[1])
        out[side] = (short.output_tokens, long.output_tokens,
                     dict(spec.accept_stats))
    assert out['port'] == out['jax']
    expected = {side: [r.output_tokens for r in _drain(
        side, MODS[side].Orchestrator(target[side]),
        prompts[1:], 100)] for side in MODS}
    assert out['port'][1] == expected['port'][0] == expected['jax'][0]


# ---- refusals ----

def test_config_mismatches_and_paged_engines_raise_as_the_reference(
        target, draft):
    """Each mismatch raises the reference's type with its text; a paged
    engine (no verify on the page arena) raises NotImplementedError from
    either speculator."""
    bad_slots = _pair(DRAFT, seed=1, max_slots=2)
    bad_vocab = _pair({k: dataclasses.replace(v, vocab_size=300)
                       for k, v in DRAFT.items()}, seed=1)
    paged = _pair(TARGET, seed=0, kv_page_size=16)
    cases = [
        (lambda s: MODS[s].SpeculativeOrchestrator(target[s], bad_slots[s]),
         ValueError),
        (lambda s: MODS[s].SpeculativeOrchestrator(target[s], bad_vocab[s]),
         ValueError),
        (lambda s: MODS[s].SpeculativeOrchestrator(target[s], draft[s],
                                                   gamma=0), ValueError),
        (lambda s: MODS[s].NgramSpeculator(target[s], match_len=0),
         ValueError),
        (lambda s: MODS[s].NgramSpeculator(paged[s]), NotImplementedError),
        (lambda s: MODS[s].SpeculativeOrchestrator(paged[s], paged[s]),
         NotImplementedError),
    ]
    for build, error in cases:
        texts = {}
        for side in MODS:
            with pytest.raises(error) as info:
                build(side)
            texts[side] = str(info.value)
        assert texts['port'] == texts['jax']
    assert target['port'].supports_verify
    assert not paged['port'].supports_verify
    assert not paged['jax'].supports_verify


# ---- draft partials ----

def test_stale_draft_partial_is_dropped_on_slot_reuse(target, draft):
    """A chunked draft prefill whose request finished is discarded when
    its slot holds a NEW request, not stepped over the new request's
    draft cache."""
    spec = orch_lib.SpeculativeOrchestrator(target['port'], draft['port'],
                                            gamma=3)
    old = orch_lib.Request(prompt_tokens=[1, 2, 3], max_new_tokens=4)
    new = spec.submit(orch_lib.Request(prompt_tokens=[4, 5, 6],
                                       max_new_tokens=4))
    spec._admit_one()
    slot = next(iter(spec._slot_req))
    assert spec._slot_req[slot] is new
    old.done = True

    class MustNotStep:
        def step(self):
            raise AssertionError('stale draft partial was stepped')

    spec._draft_partials[slot] = (old, MustNotStep())
    spec._advance_draft_partials()
    assert slot not in spec._draft_partials


def test_draft_partials_interleave_with_chunked_prefill(target, draft):
    """A long prompt admitted while another request decodes: its target
    and draft prefills run one chunk per tick, rounds stay plain until
    the draft mirror lands, and then speculate; tokens and accept_stats
    equal JAX's and plain greedy."""
    expected = _plain(target, [PROMPTS[2], LONG], 10)
    out = {}
    for side in MODS:
        mod = MODS[side]
        spec = _speculator(side, 'draft', target, draft, 4)
        first = spec.submit(mod.Request(prompt_tokens=list(PROMPTS[2]),
                                        max_new_tokens=10))
        spec.step()
        spec.step()
        late = spec.submit(mod.Request(prompt_tokens=list(LONG),
                                       max_new_tokens=10))
        spec.step()
        assert spec._partials or spec._draft_partials
        spec.run_until_drained(max_steps=MAX_STEPS)
        assert not spec._draft_partials
        out[side] = ([first.output_tokens, late.output_tokens],
                     dict(spec.accept_stats))
    assert out['port'] == out['jax']
    assert out['port'][0] == expected
