"""PyTorch port's paged-KV serving, chunked prefill and prefix cache vs
the JAX reference, on the CPU.

fp32 LLAMA_TINY with an fp32 KV cache. Inputs come from numpy seeds and go
through both packages. The JAX paged decode kernel runs in Pallas
interpret mode in the op- and model-level tests (as
``tests/unit_tests/test_paged_kv.py`` runs it); the orchestrator-level
tests take the JAX package's masked XLA branch (XSKY_DECODE_ATTN=xla) to
stay fast, which the reference's own tests hold equal to its kernel. The
port's wrappers take their plain versions (CPU tensors). Tolerances: 1e-5
on attention outputs and 1e-4 on logits (fp32 sums in another order);
greedy tokens, page arenas and block tables must be identical.
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
from skypilot_tpu.infer import paged_kv as jax_paged_kv
from skypilot_tpu.infer import sampling as jax_sampling
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.ops import decode_attention as jax_decode_ops
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.infer import paged_kv
from skypilot_tpu_torch.infer import sampling
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import decode_attention as decode_ops

ATTN_ATOL = 1e-5
LOGITS_ATOL = 1e-4
JCFG = dataclasses.replace(jax_llama.LLAMA_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(0, 256, n)]
           for i, n in enumerate((3, 5, 12, 20, 31, 7))]
LONG_PROMPT = [int(t) for t in
               np.random.default_rng(7).integers(0, 256, 50)]


@pytest.fixture(scope='module')
def params():
    jp = jax_llama.init(JCFG, jax.random.PRNGKey(0))
    return jp, llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), 'cpu')


def _engines(params, max_target_len=64, buckets=(16, 32), **kw):
    jp, tp = params
    jeng = jax_engine.InferenceEngine(jax_engine.EngineConfig(
        model=JCFG, max_slots=4, max_target_len=max_target_len,
        prefill_buckets=buckets, kv_dtype=jnp.float32, **kw), jp)
    teng = engine_lib.InferenceEngine(engine_lib.EngineConfig(
        model=TCFG, max_slots=4, max_target_len=max_target_len,
        prefill_buckets=buckets, kv_dtype=torch.float32, **kw), tp,
        device='cpu')
    return jeng, teng


def _with_spare_page(pages: np.ndarray, axis: int) -> torch.Tensor:
    """A JAX arena [.., P, ..] → the port's [.., P + 1, ..] (spare page
    of zeros at the sentinel index)."""
    shape = list(pages.shape)
    shape[axis] = 1
    return torch.from_numpy(np.concatenate(
        [pages, np.zeros(shape, pages.dtype)], axis=axis))


# ---- (1) the allocator copy ----

def test_page_allocator_copy_matches_original():
    rng = np.random.default_rng(0)
    want = jax_paged_kv.PageAllocator(12, 8, 5)
    got = paged_kv.PageAllocator(12, 8, 5)
    assert got.sentinel == want.sentinel == 12
    for _ in range(200):
        slot = int(rng.integers(0, 6))
        tokens = int(rng.integers(0, 60))
        if want.slot_pages(slot) is None and rng.random() < 0.6:
            assert got.can_admit(tokens) == want.can_admit(tokens)
            assert got.allocate(slot, tokens) == want.allocate(slot, tokens)
        else:
            want.release(slot)
            got.release(slot)
        assert got.slot_pages(slot) == want.slot_pages(slot)
        np.testing.assert_array_equal(got.table_row(slot),
                                      want.table_row(slot))
        assert (got.free_pages, got.used_pages) == (want.free_pages,
                                                    want.used_pages)
    live = next(s for s in range(6) if want.slot_pages(s))
    with pytest.raises(ValueError, match='already holds'):
        got.allocate(live, 1)
    with pytest.raises(ValueError, match='positive sizes'):
        paged_kv.PageAllocator(0, 8, 5)
    got.release_all()
    assert got.free_pages == 12


# ---- (2) the plain paged attention vs the JAX kernel (interpret) ----

def _paged_inputs(seed, b, num_pages, page, nblk, h, h_kv, d, lengths,
                  allocated=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((num_pages, page, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((num_pages, page, h_kv, d)).astype(np.float32)
    # A random permutation of pages, so no slot's pages are contiguous;
    # blocks past each slot's allocation (by default the blocks its
    # length needs) hold the sentinel (== num_pages).
    perm = rng.permutation(num_pages)[:b * nblk].reshape(b, nblk)
    tables = np.full((b, nblk), num_pages, np.int32)
    for i, n in enumerate(lengths if allocated is None else allocated):
        used = -(-min(n, nblk * page) // page)
        tables[i, :used] = perm[i, :used]
    return q, k, v, np.asarray(lengths, np.int32), tables


PAGED_CASES = {
    # page 8 (the JAX tests' size): ragged lengths, a length-0 slot whose
    # first block is allocated, one whose table row is all sentinel, and
    # an inactive slot (length past the table, all-sentinel row).
    'page8-ragged': dict(b=6, num_pages=40, page=8, nblk=6, h=4, h_kv=2,
                         d=16, lengths=[1, 8, 9, 0, 0, 49],
                         allocated=[1, 8, 9, 8, 0, 0]),
    'page16-full-and-tails': dict(b=4, num_pages=24, page=16, nblk=4, h=8,
                                  h_kv=2, d=32, lengths=[64, 17, 33, 70]),
    'page8-softcap-scale': dict(b=3, num_pages=16, page=8, nblk=4, h=4,
                                h_kv=4, d=16, lengths=[5, 32, 20],
                                logit_softcap=30.0, scale=0.1),
}


@pytest.mark.parametrize('case', sorted(PAGED_CASES))
def test_paged_decode_attention_plain_matches_jax_kernel(case):
    kw = dict(PAGED_CASES[case])
    extra = {key: kw.pop(key) for key in ('logit_softcap', 'scale')
             if key in kw}
    lengths = kw['lengths']
    q, k, v, lens, tables = _paged_inputs(11, **kw)
    want = np.asarray(jax_decode_ops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        jnp.asarray(tables), **extra))
    got = decode_ops.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), torch.from_numpy(tables), **extra)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL, rtol=0)
    empty = [i for i, n in enumerate(lengths) if n == 0]
    for i in empty:
        # The mean of the `page` V rows of the slot's first clamped page.
        first = min(max(int(tables[i, 0]), 0), k.shape[0] - 1)
        mean = np.repeat(v[first].mean(axis=0), q.shape[2] // v.shape[2],
                         axis=0)
        np.testing.assert_allclose(got.numpy()[i, 0], mean, atol=ATTN_ATOL)


def test_paged_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, lens, tables = (torch.from_numpy(a) for a in _paged_inputs(
        0, 2, 8, 8, 2, 4, 2, 16, [3, 9]))
    with pytest.raises(ValueError, match='int8 KV is not supported'):
        decode_ops.paged_decode_attention(q, (k, k), (v, v), lens, tables)
    with pytest.raises(ValueError, match='sliding_window'):
        decode_ops.paged_decode_attention(q, k, v, lens, tables, window=4)
    # The launcher's checks, reached with tensors that are not on the CPU.
    mq, mk, mv, ml, mt = (t.to('meta') for t in (q, k, v, lens, tables))
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        decode_ops.paged_decode_attention(mq, mk, mv, ml, mt)


# ---- (3) model level: paged_decode_forward and verify_forward ----

def test_paged_decode_forward_matches_jax(params):
    """Two steps over a permuted table with one inactive slot (position
    past the table): logits of live slots and the arena's pages agree."""
    jp, tp = params
    c = JCFG
    slots, num_pages, page, nblk = 4, 12, 8, 4
    rng = np.random.default_rng(3)
    arena = rng.standard_normal(
        (2, c.n_layers, num_pages, page, c.n_kv_heads,
         c.head_dim)).astype(np.float32)
    tables = np.full((slots, nblk), num_pages, np.int32)
    perm = rng.permutation(num_pages)
    tables[0, :3], tables[1, :2], tables[3, :4] = (perm[:3], perm[3:5],
                                                   perm[5:9])
    positions = np.array([17, 8, nblk * page, 30], np.int32)
    tokens = rng.integers(0, c.vocab_size, slots).astype(np.int32)
    jkv = {'k': jnp.asarray(arena[0]), 'v': jnp.asarray(arena[1])}
    tkv = {'k': _with_spare_page(arena[0], 1),
           'v': _with_spare_page(arena[1], 1)}
    live = [0, 1, 3]
    for step in range(2):
        jlogits, jkv = jax_llama.paged_decode_forward(
            c, jp, jnp.asarray(tokens), jnp.asarray(positions), jkv,
            jnp.asarray(tables))
        tlogits, tkv = llama.paged_decode_forward(
            TCFG, tp, torch.from_numpy(tokens), torch.from_numpy(positions),
            tkv, torch.from_numpy(tables))
        np.testing.assert_allclose(tlogits.numpy()[live],
                                   np.asarray(jlogits)[live],
                                   atol=LOGITS_ATOL, rtol=0)
        for key in ('k', 'v'):
            np.testing.assert_allclose(tkv[key][:, :num_pages].numpy(),
                                       np.asarray(jkv[key]), atol=1e-5)
        positions = positions + np.array([1, 1, 0, 1], np.int32)
        tokens = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


def test_verify_forward_matches_jax(params):
    """Three tokens per slot at each slot's own offsets into a dense
    cache; one slot's last position is past the cache (written
    nowhere)."""
    jp, tp = params
    c = JCFG
    slots, cap, s = 3, 24, 3
    rng = np.random.default_rng(4)
    cache = rng.standard_normal(
        (2, c.n_layers, slots, cap, c.n_kv_heads,
         c.head_dim)).astype(np.float32)
    tokens = rng.integers(0, c.vocab_size, (slots, s)).astype(np.int32)
    positions = (np.array([[0], [10], [cap - 2]], np.int32)
                 + np.arange(s, dtype=np.int32)[None])
    jlogits, jkv = jax_llama.verify_forward(
        c, jp, jnp.asarray(tokens), jnp.asarray(positions),
        {'k': jnp.asarray(cache[0]), 'v': jnp.asarray(cache[1])})
    tlogits, tkv = llama.verify_forward(
        TCFG, tp, torch.from_numpy(tokens), torch.from_numpy(positions),
        {'k': torch.from_numpy(cache[0].copy()),
         'v': torch.from_numpy(cache[1].copy())})
    assert tuple(tlogits.shape) == (slots, s, c.vocab_size)
    # Slot 2's last query sits past the cache: its row is not comparable.
    np.testing.assert_allclose(tlogits.numpy()[:2], np.asarray(jlogits)[:2],
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(tlogits.numpy()[2, :2],
                               np.asarray(jlogits)[2, :2],
                               atol=LOGITS_ATOL, rtol=0)
    for key in ('k', 'v'):
        np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                   atol=1e-5)


# ---- (4) orchestrator level ----

@pytest.fixture
def xla_decode(monkeypatch):
    monkeypatch.setenv('XSKY_DECODE_ATTN', 'xla')


SERVE_CASES = {
    'paged': (dict(kv_page_size=16), PROMPTS),
    'paged-deferral': (dict(kv_page_size=16, kv_num_pages=5), PROMPTS),
    'chunked': ({}, [LONG_PROMPT] + PROMPTS[:2]),
    'prefix-cache': (dict(prefix_cache_entries=4),
                     [LONG_PROMPT[:25] + [1, 2, 3],
                      LONG_PROMPT[:25] + [9, 8, 7, 6], PROMPTS[3]]),
    'paged-chunked-prefix': (
        dict(kv_page_size=16, kv_num_pages=8, prefix_cache_entries=4),
        [LONG_PROMPT, LONG_PROMPT[:40] + [5, 4, 3], PROMPTS[4],
         LONG_PROMPT[:20] + [7] * 6, PROMPTS[0]]),
}


@pytest.mark.parametrize('decode_steps', [1, 4])
@pytest.mark.parametrize('case', sorted(SERVE_CASES))
def test_generate_matches_jax_orchestrator(params, xla_decode, case,
                                           decode_steps):
    kw, prompts = SERVE_CASES[case]
    jeng, teng = _engines(params, **kw)
    jorch = jax_orch.Orchestrator(jeng, decode_steps=decode_steps)
    torch_orch = orch_lib.Orchestrator(teng, decode_steps=decode_steps)
    want = jorch.generate(prompts, max_new_tokens=8)
    treqs = [torch_orch.submit(orch_lib.Request(prompt_tokens=p,
                                                max_new_tokens=8))
             for p in prompts]
    torch_orch.run_until_drained()
    assert [r.output_tokens for r in treqs] == want
    assert all(r.error is None and len(r.output_tokens) == 8 for r in treqs)
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats
    assert teng.kv_page_stats == jeng.kv_page_stats
    assert sorted(torch_orch._free_slots) == [0, 1, 2, 3]
    if 'deferral' in case:
        assert any(r.deferred_wait > 0 for r in treqs)
    if 'prefix' in case:
        assert teng.prefix_cache_stats['hits'] >= 1
    if teng.config.paged:
        stats = teng.kv_page_stats
        assert stats['free'] == stats['total']
        np.testing.assert_array_equal(
            torch_orch.state['block_tables'].numpy(),
            np.asarray(jorch.state['block_tables']))


def test_paged_state_matches_jax_after_a_wave(params, xla_decode):
    """A batched wave, a single insert and one decode step: pages, block
    tables and per-slot state equal the JAX engine's."""
    jeng, teng = _engines(params, kv_page_size=8, kv_num_pages=20)
    wave, slots = PROMPTS[1:4], [0, 2, 3]
    for eng in (jeng, teng):
        for prompt, slot in zip(wave + [PROMPTS[4]], slots + [1]):
            assert eng.reserve_kv(slot, len(prompt), 6)
    js, jfirst = jeng.prefill_insert_batch(
        jeng.init_decode_state(),
        [(p, jax_sampling.SamplingParams()) for p in wave], slots)
    ts, tfirst = teng.prefill_insert_batch(
        teng.init_decode_state(),
        [(p, sampling.SamplingParams()) for p in wave], slots)
    assert tfirst == jfirst
    jtok, jkv, jlen = jeng.prefill(PROMPTS[4])
    js = jeng.insert(js, jkv, jtok, jlen, 1)
    ttok, tkv, tlen = teng.prefill(PROMPTS[4])
    ts = teng.insert(ts, tkv, ttok, tlen, 1)
    js, jnext = jeng.decode_step(js)
    ts, tnext = teng.decode_step(ts)
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
    num_pages = teng.kv_page_stats['total']
    assert ts['kv_k'].shape[1] == num_pages + 1
    for key in ('kv_k', 'kv_v'):
        np.testing.assert_allclose(ts[key][:, :num_pages].numpy(),
                                   np.asarray(js[key]), atol=1e-5)
    for key in ('block_tables', 'lengths', 'tokens', 'active'):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))


def test_prefix_cache_entry_matches_jax(params):
    jeng, teng = _engines(params, prefix_cache_entries=2)
    prompt = LONG_PROMPT[:30]
    for eng in (jeng, teng):
        eng.prefill_any(prompt)
        eng.prefill_any(prompt + [4, 5, 6])      # a hit, chunked suffix
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats
    assert teng.prefix_cache_stats['hits'] == 1
    for key in (tuple(prompt), tuple(prompt + [4, 5, 6])):
        jentry, jlen = jeng._prefix_cache._entries[key]
        tentry, tlen = teng._prefix_cache._entries[key]
        assert tlen == jlen == tentry['k'].shape[2]
        for part in ('k', 'v'):
            np.testing.assert_allclose(tentry[part].numpy(),
                                       np.asarray(jentry[part]), atol=1e-5)
            # A copy of the live rows, not a view of the whole bucket.
            assert tentry[part].untyped_storage().nbytes() == (
                tentry[part].numel() * 4)


def test_chunk_forward_projects_one_row_only(params, monkeypatch):
    """Intermediate chunks skip the LM head; the last projects a single
    row (not [1, C, V])."""
    _, teng = _engines(params)
    shapes = []
    real = llama.lm_logits

    def spy(config, p, hidden):
        shapes.append(tuple(hidden.shape))
        return real(config, p, hidden)

    monkeypatch.setattr(llama, 'lm_logits', spy)
    cp = teng.start_chunked_prefill(LONG_PROMPT)
    while not cp.step():
        pass
    first, kv, true_len = cp.finalize()
    assert shapes == [(1, TCFG.d_model)]
    assert true_len == 50 and kv['k'].shape[2] == 64
    assert 0 <= int(first) < TCFG.vocab_size


# ---- (5) a finished slot ticking while another owns the last page ----

@pytest.mark.parametrize('live, done', [(0, 1), (1, 0)])
def test_finished_slot_never_touches_the_last_page(params, live, done):
    """Slot `done` hits its EOS at the first step of a fused batch and
    goes on ticking inactive. Its write position (past the table) clamps
    to the last page P - 1, offset 0: the very row that slot `live`, which
    owns that page, writes at the next step. Whichever of the two comes
    first in the scatter (and the never-admitted slots 2 and 3 tick the
    same way throughout), the live slot's tokens and rows must equal those
    of the dense engine, which has no shared page to collide on."""
    def run(eos_token, paged=True):
        kw = dict(kv_page_size=8, kv_num_pages=4) if paged else {}
        _, teng = _engines(params, max_target_len=32, buckets=(16,), **kw)
        if paged:
            pa = teng._page_alloc
            # The live slot gets pages [0, 3], so it writes into the LAST
            # page of the arena from position 8 on; the other gets [1, 2].
            pa._free = [2, 1, 3, 0]
            assert teng.reserve_kv(live, 7, 9)
            assert teng.reserve_kv(done, 7, 9)
            assert pa.slot_pages(live) == [0, 3]
            assert pa.slot_pages(done) == [1, 2]
        sp = sampling.SamplingParams()
        state, _ = teng.prefill_insert_batch(
            teng.init_decode_state(),
            [(PROMPTS[5], sp), (PROMPTS[5][::-1], sp)], [live, done])
        eos = torch.full((4,), -1, dtype=torch.int32)
        if eos_token is not None:
            eos[done] = eos_token
        state, _, toks, valid, _ = teng.decode_steps_masked(
            state, 6, torch.zeros(4), None, None, eos,
            torch.full((4,), 100, dtype=torch.int32), None)
        return state, toks, valid

    dense_state, dense_toks, _ = run(None, paged=False)
    state, toks, valid = run(int(dense_toks[0, done]))
    assert valid[:, done].tolist() == [False] * 6
    assert valid[:, live].all()
    np.testing.assert_array_equal(toks[:, live].numpy(),
                                  dense_toks[:, live].numpy())
    for key in ('kv_k', 'kv_v'):
        # The live slot's rows 0..12 (7 prompt rows, 6 written by decode):
        # page 0 and offsets 0..4 of page 3, the arena's last page.
        rows = state[key][:, [0, 3]].flatten(1, 2)[:, :13]
        np.testing.assert_allclose(rows.numpy(),
                                   dense_state[key][:, live, :13].numpy(),
                                   atol=1e-5)


# ---- (6) rejection and cancellation ----

def test_too_large_budget_is_rejected_and_cancel_returns_pages(params):
    _, teng = _engines(params, kv_page_size=16, kv_num_pages=2)
    orch = orch_lib.Orchestrator(teng)
    too_big = orch.submit(orch_lib.Request(prompt_tokens=[1] * 30,
                                           max_new_tokens=8))
    orch.step()
    assert too_big.done and too_big.error == (
        'Request KV budget 38 tokens exceeds the paged-cache capacity.')
    # A long prompt becomes a partial; cancelled mid-prefill, it gives its
    # slot and its pages back.
    _, teng = _engines(params, kv_page_size=16)
    orch = orch_lib.Orchestrator(teng)
    long_req = orch.submit(orch_lib.Request(prompt_tokens=LONG_PROMPT,
                                            max_new_tokens=8))
    orch.step()
    assert len(orch._partials) == 1 and not long_req.done
    assert teng.kv_page_stats['free'] == 16 - 4
    long_req.cancel_requested = True
    orch.step()
    assert long_req.done and long_req.error is None
    assert not long_req.output_tokens and not orch._partials
    assert teng.kv_page_stats['free'] == 16
    assert sorted(orch._free_slots) == [0, 1, 2, 3]
    # fail_all covers partials and deferred requests too.
    _, teng = _engines(params, kv_page_size=16, kv_num_pages=4)
    orch = orch_lib.Orchestrator(teng)
    reqs = [orch.submit(orch_lib.Request(prompt_tokens=p, max_new_tokens=8))
            for p in (LONG_PROMPT, PROMPTS[3], PROMPTS[2])]
    orch.step()
    assert orch._partials and orch._deferred
    orch.fail_all('stopped')
    assert all(r.done and r.error == 'stopped' for r in reqs)
    assert teng.kv_page_stats['free'] == 4
    assert sorted(orch._free_slots) == [0, 1, 2, 3]


@pytest.mark.parametrize('kw, exc, match', [
    (dict(kv_page_size=16, kv_dtype=torch.int8), NotImplementedError,
     'int8 KV is not supported with the paged cache.'),
    (dict(kv_page_size=12), ValueError,
     r'kv_page_size 12 must divide max_target_len and every prefill '
     r'bucket; offending sizes: \[64, 16, 32\]'),
    (dict(kv_page_size=16,
          model=dataclasses.replace(TCFG, sliding_window=8)),
     NotImplementedError,
     'sliding_window is not supported with the paged cache.'),
])
def test_paged_engine_config_errors_match_reference(params, kw, exc, match):
    cfg = dict(model=TCFG, max_slots=4, max_target_len=64,
               prefill_buckets=(16, 32), kv_dtype=torch.float32)
    cfg.update(kw)
    with pytest.raises(exc, match=match):
        engine_lib.InferenceEngine(engine_lib.EngineConfig(**cfg), params[1],
                                   device='cpu')
