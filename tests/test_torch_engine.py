"""PyTorch port's engine, orchestrator and sampling vs the JAX reference.

fp32 LLAMA_TINY with an fp32 (or int8) KV cache, on the CPU. The JAX
side runs its masked XLA decode path (XSKY_DECODE_ATTN=xla) to stay
fast. Greedy tokens must be identical; logprobs agree to 1e-4 (fp32
logits through two layers in another summation order). Sampled draws
cannot match JAX's bits, so the filters are tested deterministically
and the draw statistically.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import orchestrator as jax_orch
from skypilot_tpu.infer import sampling as jax_sampling
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.infer import sampling
from skypilot_tpu_torch.models import llama

LP_ATOL = 1e-4
JCFG = dataclasses.replace(jax_llama.LLAMA_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(0, 256, n)]
           for i, n in enumerate((3, 5, 12, 20, 31, 7))]


@pytest.fixture(scope='module')
def params():
    jp = jax_llama.init(JCFG, jax.random.PRNGKey(0))
    return jp, llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), 'cpu')


@pytest.fixture(autouse=True)
def _xla_decode(monkeypatch):
    monkeypatch.setenv('XSKY_DECODE_ATTN', 'xla')


def _engines(params, kv='fp32', max_target_len=64):
    jp, tp = params
    jkv = {'fp32': jnp.float32, 'int8': jnp.int8}[kv]
    tkv = {'fp32': torch.float32, 'int8': torch.int8}[kv]
    jeng = jax_engine.InferenceEngine(jax_engine.EngineConfig(
        model=JCFG, max_slots=4, max_target_len=max_target_len,
        prefill_buckets=(16, 32), kv_dtype=jkv), jp)
    teng = engine_lib.InferenceEngine(engine_lib.EngineConfig(
        model=TCFG, max_slots=4, max_target_len=max_target_len,
        prefill_buckets=(16, 32), kv_dtype=tkv), tp, device='cpu')
    return jeng, teng


@pytest.mark.parametrize('kv', ['fp32', 'int8'])
@pytest.mark.parametrize('decode_steps', [1, 4])
def test_generate_matches_jax_orchestrator(params, decode_steps, kv):
    """6 prompts of different lengths through 4 slots (so a second
    admission wave follows releases), 8 new tokens each."""
    jeng, teng = _engines(params, kv)
    want = jax_orch.Orchestrator(jeng, decode_steps=decode_steps).generate(
        PROMPTS, max_new_tokens=8)
    got = orch_lib.Orchestrator(teng, decode_steps=decode_steps).generate(
        PROMPTS, max_new_tokens=8)
    assert got == want
    assert all(len(t) == 8 for t in got)


@pytest.mark.parametrize('penalized', [False, True])
def test_decode_step_logprobs_match_jax(params, penalized):
    """Logits-level parity through the engine: a wave prefill, then two
    decode steps with logprobs (and presence/frequency penalties)."""
    jeng, teng = _engines(params)
    args = [(p, jax_sampling.SamplingParams()) for p in PROMPTS[:3]]
    targs = [(p, sampling.SamplingParams()) for p in PROMPTS[:3]]
    js, jfirst = jeng.prefill_insert_batch(jeng.init_decode_state(), args,
                                           [0, 2, 3])
    ts, tfirst = teng.prefill_insert_batch(teng.init_decode_state(), targs,
                                           [0, 2, 3])
    assert tfirst == jfirst
    pen = ([0.5, 0.0, 0.3, 1.0], [0.2, 0.0, 0.7, 0.0]) if penalized else None
    for _ in range(2):
        js, jtok, jlp = jeng.decode_step(js, logprobs_k=5, penalties=pen)
        ts, ttok, tlp = teng.decode_step(ts, logprobs_k=5, penalties=pen)
        live = [0, 2, 3]
        np.testing.assert_array_equal(ttok.numpy()[live],
                                      np.asarray(jtok)[live])
        for got, want in zip(tlp[:2], jlp[:2]):
            np.testing.assert_allclose(got.numpy()[live],
                                       np.asarray(want)[live],
                                       atol=LP_ATOL)
    np.testing.assert_array_equal(ts['counts'].numpy(),
                                  np.asarray(js['counts']))
    np.testing.assert_array_equal(ts['lengths'].numpy(),
                                  np.asarray(js['lengths']))


def test_finished_slot_cache_stays_bit_identical(params):
    """A slot that hits EOS mid fused batch stops writing KV at once:
    its cache rows after the EOS step are untouched, and the row mask
    marks the EOS step and everything after it invalid."""
    _, teng = _engines(params)
    targs = [(p, sampling.SamplingParams()) for p in PROMPTS[:2]]
    state, first = teng.prefill_insert_batch(teng.init_decode_state(),
                                             targs, [0, 1])
    snapshot = {k: state[k].clone() for k in ('kv_k', 'kv_v', 'lengths',
                                              'tokens', 'active')}
    greedy = teng.init_decode_state()
    greedy.update({k: v.clone() for k, v in snapshot.items()})
    n = 4
    temps = torch.zeros(4)
    no_eos = torch.full((4,), -1, dtype=torch.int32)
    budget = torch.full((4,), 100, dtype=torch.int32)
    greedy, _, toks, _, _ = teng.decode_steps_masked(
        greedy, n, temps, None, None, no_eos, budget, None)
    # Slot 1 samples its EOS at step 1 (the second step).
    eos = no_eos.clone()
    eos[1] = toks[1, 1]
    assert int(toks[0, 1]) != int(eos[1])
    state, remaining, toks2, valid, _ = teng.decode_steps_masked(
        state, n, temps, None, None, eos, budget.clone(), None)
    assert valid[:, 1].tolist() == [True, False, False, False]
    assert valid[:, 0].all()
    length1 = int(snapshot['lengths'][1])
    for key in ('kv_k', 'kv_v'):
        # Step 0 wrote slot 1's row at its length; step 1 (the EOS step)
        # wrote the row after it; nothing after that.
        np.testing.assert_array_equal(
            state[key][:, 1, length1 + 2:].numpy(),
            snapshot[key][:, 1, length1 + 2:].numpy())
        # The never-admitted slots 2, 3 are untouched.
        np.testing.assert_array_equal(state[key][:, 2:].numpy(),
                                      snapshot[key][:, 2:].numpy())
    assert not bool(state['active'][1])
    assert int(remaining[0]) == 100 - n


def test_eos_and_budget_masking(params):
    """EOS: the EOS token is never emitted and generation stops there;
    budget: with decode_steps 4, a 3-token budget yields 3 tokens. Both
    as the JAX orchestrator does."""
    jeng, teng = _engines(params)
    prompt = PROMPTS[2]
    full = orch_lib.Orchestrator(teng).generate([prompt],
                                                max_new_tokens=10)[0]
    cut = next(i for i in range(2, 10) if full[i] not in full[:i])
    eos = full[cut]
    for steps in (1, 4):
        _, teng = _engines(params)
        got = orch_lib.Orchestrator(teng, decode_steps=steps).generate(
            [prompt, PROMPTS[0]], max_new_tokens=10, eos_token_id=eos)
        want = jax_orch.Orchestrator(jeng, decode_steps=steps).generate(
            [prompt, PROMPTS[0]], max_new_tokens=10, eos_token_id=eos)
        assert got == want
        assert got[0] == full[:cut]
        _, teng = _engines(params)
        short = orch_lib.Orchestrator(teng, decode_steps=4).generate(
            [prompt], max_new_tokens=3)
        assert short == [full[:3]]


def test_admission_rejects_and_clamps(params):
    _, teng = _engines(params, max_target_len=40)
    orch = orch_lib.Orchestrator(teng)
    too_long = orch.submit(orch_lib.Request(prompt_tokens=[1] * 33))
    empty = orch.submit(orch_lib.Request(prompt_tokens=[]))
    clamped = orch.submit(orch_lib.Request(prompt_tokens=[1] * 30,
                                           max_new_tokens=100))
    expired = orch_lib.Request(prompt_tokens=[1, 2], deadline_at=0.0)
    orch.submit(expired)
    orch.run_until_drained()
    assert too_long.error and empty.error
    assert expired.error and orch.deadline_rejects == 1
    assert clamped.error is None and len(clamped.output_tokens) == 10
    assert sorted(orch._free_slots) == [0, 1, 2, 3]


def test_prefill_single_and_insert_match_batched(params):
    """The single-prompt path (prefill + insert) leaves the same state as
    the batched wave."""
    _, teng = _engines(params)
    sp = sampling.SamplingParams()
    batched, _ = teng.prefill_insert_batch(
        teng.init_decode_state(), [(PROMPTS[1], sp), (PROMPTS[3], sp)],
        [1, 0])
    single = teng.init_decode_state()
    for prompt, slot in ((PROMPTS[1], 1), (PROMPTS[3], 0)):
        first, kv, true_len = teng.prefill(prompt, sp)
        single = teng.insert(single, kv, first, true_len, slot)
    for key in ('lengths', 'tokens', 'active', 'counts'):
        torch.testing.assert_close(single[key], batched[key], atol=0,
                                   rtol=0)
    # Live rows agree; rows past a prompt hold its bucket's padding,
    # and the two paths pad PROMPTS[1] to different buckets.
    for slot, prompt in ((1, PROMPTS[1]), (0, PROMPTS[3])):
        for key in ('kv_k', 'kv_v'):
            torch.testing.assert_close(single[key][:, slot, :len(prompt)],
                                       batched[key][:, slot, :len(prompt)],
                                       atol=1e-5, rtol=0)


def test_sampling_filters_deterministic():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0, 2.0],
                           [0.0, 1.0, 2.0, 3.0, 4.0],
                           [5.0, 1.0, 1.0, 1.0, 1.0]])
    temps = torch.ones(3)
    # top_k: ties at the k-th value are kept; 0 disables the filter.
    out = sampling.filter_logits(logits, temps,
                                 top_k=torch.tensor([1, 2, 0]))
    assert torch.isfinite(out).tolist() == [
        [False, True, True, False, False],
        [False, False, False, True, True],
        [True] * 5]
    # top_p: smallest sorted prefix reaching the mass (first always);
    # 1.0 disables the filter.
    probs = torch.softmax(logits[1], -1)
    need = float(probs[4] + probs[3]) - 1e-4
    out = sampling.filter_logits(logits, temps,
                                 top_p=torch.tensor([1.0, need, 0.01]))
    assert torch.isfinite(out).tolist() == [
        [True] * 5,
        [False, False, False, True, True],
        [True, False, False, False, False]]
    # Greedy rows ignore the generator; the all-greedy path draws none.
    gen = torch.Generator()
    gen.manual_seed(0)
    toks = sampling.sample_batched(logits, gen, torch.zeros(3))
    assert toks.tolist() == [1, 4, 0]
    assert sampling.sample_batched(logits, None, torch.ones(3)).tolist() \
        == [1, 4, 0]


def test_sampling_support_matches_jax_filters():
    """Every JAX draw under top-k + top-p lands inside the port's
    filtered support."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 32)).astype(np.float32) * 2
    temps = np.array([0.7, 1.0, 1.3, 0.9], np.float32)
    top_k = np.array([5, 0, 12, 3], np.int32)
    top_p = np.array([0.9, 0.6, 1.0, 0.95], np.float32)
    support = torch.isfinite(sampling.filter_logits(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_k), torch.from_numpy(top_p))).numpy()
    for seed in range(64):
        draws = np.asarray(jax_sampling.sample_batched(
            jnp.asarray(logits), jax.random.PRNGKey(seed),
            jnp.asarray(temps), jnp.asarray(top_k), jnp.asarray(top_p)))
        assert support[np.arange(4), draws].all()


@pytest.mark.parametrize('top_k', [0, 3])
def test_sampling_draw_distribution(top_k):
    """40000 rows drawn at temperature 0.7: empirical frequencies within
    0.0125 (5 sigma at this count) of the filtered softmax."""
    n = 40000
    logits = torch.tensor([0.3, 1.2, -0.5, 0.9, 0.0, 1.1, -1.0, 0.4])
    temps = torch.full((n,), 0.7)
    k = torch.full((n,), top_k, dtype=torch.int32) if top_k else None
    gen = torch.Generator()
    gen.manual_seed(1)
    toks = sampling.sample_batched(logits.expand(n, -1), gen, temps, k)
    freq = torch.bincount(toks.long(), minlength=8).float() / n
    scaled = logits / 0.7
    if top_k:
        scaled = torch.where(scaled >= scaled.topk(top_k).values[-1],
                             scaled, -torch.inf)
    want = torch.softmax(scaled, -1)
    assert float((freq - want).abs().max()) < 0.0125
    assert not bool(freq[want == 0].any())
