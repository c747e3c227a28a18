"""PyTorch port's Llama model vs the JAX reference, on the CPU.

Weights come from the JAX ``init`` and cross with ``params_from_numpy``;
inputs are made with numpy from a seed. fp32 variants of the tiny
configs; tolerance fp32 atol 1e-4 on logits (two layers of fp32 matmuls
in another summation order), 2e-5 on the attention-level K/V.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.models import llama

LOGIT_ATOL = 1e-4
KV_ATOL = 2e-5

CONFIGS = {
    'llama_tiny': (jax_llama.LLAMA_TINY, llama.LLAMA_TINY),
    'mistral_tiny': (jax_llama.MISTRAL_TINY, llama.MISTRAL_TINY),
}


def _fp32(name):
    jcfg, tcfg = CONFIGS[name]
    return (dataclasses.replace(jcfg, dtype=jnp.float32),
            dataclasses.replace(tcfg, dtype=torch.float32))


def _params(jcfg, seed=0):
    jp = jax_llama.init(jcfg, jax.random.PRNGKey(seed))
    return jp, llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), 'cpu')


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_params_from_numpy_round_trip():
    """The bf16 JAX tree crosses one to one by name, bit for bit, and
    its shapes match the port's own init."""
    jp = jax_llama.init(jax_llama.LLAMA_TINY, jax.random.PRNGKey(1))
    tp = llama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 'cpu')
    own = llama.init(llama.LLAMA_TINY, device='cpu')
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == 12
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tp
        o = own
        for key in keys:
            t, o = t[key], o[key]
        assert t.dtype == torch.bfloat16 == o.dtype
        assert tuple(t.shape) == leaf.shape == tuple(o.shape)
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(leaf).view(np.int16))
    recast = llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), 'cpu', dtype=torch.float32)
    assert recast['layers']['wq'].dtype == torch.float32


def test_init_distribution():
    """Truncated normal in [-2, 2] scaled by fan_in^-0.5, norms at 1."""
    cfg = dataclasses.replace(llama.LLAMA_TINY, d_ff=256, vocab_size=512)
    gen = torch.Generator()
    gen.manual_seed(0)
    p = llama.init(cfg, gen, device='cpu')
    w = p['layers']['w_gate'].float()
    fan = cfg.d_model ** -0.5
    assert float(w.abs().max()) <= 2 * fan * 1.01
    # std of a standard normal truncated at ±2 is 0.8796
    assert abs(float(w.std()) / fan - 0.8796) < 0.02
    assert bool((p['final_norm'] == 1).all())


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_forward_logits_match_jax(name):
    jcfg, tcfg = _fp32(name)
    jp, tp = _params(jcfg)
    tokens = _tokens(0, 2, 24)
    want = np.asarray(jax_llama.forward(jcfg, jp, jnp.asarray(tokens)))
    got = llama.forward(tcfg, tp, torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_prefill_hidden_and_kv_match_jax(name):
    jcfg, tcfg = _fp32(name)
    jp, tp = _params(jcfg)
    tokens = _tokens(1, 3, 16)
    true_len = np.array([16, 5, 11], np.int32)
    hid_j, kv_j = jax_llama.prefill_hidden(jcfg, jp, jnp.asarray(tokens),
                                           jnp.asarray(true_len))
    hid_t, kv_t = llama.prefill_hidden(tcfg, tp,
                                       torch.from_numpy(tokens).long(),
                                       torch.from_numpy(true_len))
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j),
                               atol=LOGIT_ATOL)
    for key in ('k', 'v'):
        assert tuple(kv_t[key].shape) == kv_j[key].shape
        np.testing.assert_allclose(kv_t[key].numpy(),
                                   np.asarray(kv_j[key]), atol=KV_ATOL)
    logits_j = jax_llama.lm_logits(jcfg, jp, hid_j)
    logits_t = llama.lm_logits(tcfg, tp, hid_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_decode_forward_steps_match_jax(name, monkeypatch):
    """Three decode steps at ragged positions through the slot cache; the
    last slot is "inactive" (position = max_len), so its write must be
    dropped on both sides. The JAX side runs its masked XLA path."""
    monkeypatch.setenv('XSKY_DECODE_ATTN', 'xla')
    jcfg, tcfg = _fp32(name)
    jp, tp = _params(jcfg)
    b, max_len = 4, 32
    shape = (jcfg.n_layers, b, max_len, jcfg.n_kv_heads, jcfg.head_dim)
    rng = np.random.default_rng(2)
    cache_k = rng.standard_normal(shape).astype(np.float32)
    cache_v = rng.standard_normal(shape).astype(np.float32)
    kv_j = {'k': jnp.asarray(cache_k), 'v': jnp.asarray(cache_v)}
    kv_t = {'k': torch.from_numpy(cache_k.copy()),
            'v': torch.from_numpy(cache_v.copy())}
    positions = np.array([0, 9, 30, max_len], np.int32)
    tokens = np.array([3, 77, 150, 9], np.int32)
    for _ in range(3):
        logits_j, kv_j = jax_llama.decode_forward(
            jcfg, jp, jnp.asarray(tokens), jnp.asarray(positions), kv_j)
        logits_t, kv_t = llama.decode_forward(
            tcfg, tp, torch.from_numpy(tokens).long(),
            torch.from_numpy(positions), kv_t)
        # The inactive slot's logits are discarded by the engine; under
        # a window they differ by design: the port (like the JAX kernel)
        # clamps its length to the cache, the JAX masked path does not.
        np.testing.assert_allclose(logits_t.numpy()[:3],
                                   np.asarray(logits_j)[:3],
                                   atol=LOGIT_ATOL)
        for key in ('k', 'v'):
            np.testing.assert_allclose(kv_t[key].numpy(),
                                       np.asarray(kv_j[key]), atol=KV_ATOL)
        tokens = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)
        positions = np.where(positions < max_len - 1, positions + 1,
                             positions).astype(np.int32)
    # The inactive slot's rows never changed.
    np.testing.assert_array_equal(kv_t['k'][:, 3].numpy(), cache_k[:, 3])


def test_rope_llama3_scaling_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 20000, (2, 5)).astype(np.int32)
    scaling = (8.0, 1.0, 4.0, 8192)
    want = jax_llama._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0,
                           scaling)
    got = llama._rope(torch.from_numpy(x), torch.from_numpy(pos),
                      500000.0, scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_bf16_forward_close_to_fp32():
    """bf16 smoke: the port's bf16 dtype placement (fp32 norm / rope /
    gate, fp32 LM-head output) stays within bf16 noise of fp32."""
    jcfg, tcfg = _fp32('llama_tiny')
    _, tp32 = _params(jcfg)
    tp16 = {k: (v.to(torch.bfloat16) if torch.is_tensor(v) else
                {kk: vv.to(torch.bfloat16) for kk, vv in v.items()})
            for k, v in tp32.items()}
    tokens = torch.from_numpy(_tokens(4, 1, 20)).long()
    ref = llama.forward(tcfg, tp32, tokens)
    got = llama.forward(llama.LLAMA_TINY, tp16, tokens)
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max()) < 0.1


@pytest.mark.parametrize('int8', [False, True], ids=['fp32', 'int8'])
@pytest.mark.parametrize('mode', ['cache_index', 'positions_2d'])
def test_slot_cache_attend_masked_branches_match_jax(mode, int8):
    """The multi-token branches take the masked plain path on both
    sides: a shared write offset (cache_index, clamped so the block
    fits, as dynamic_update_slice does) and per-slot [B, S] positions."""
    rng = np.random.default_rng(5)
    b, s, max_len, h, h_kv, d = 3, 4, 16, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h_kv, d)).astype(np.float32)
    ck = rng.standard_normal((b, max_len, h_kv, d)).astype(np.float32)
    cv = rng.standard_normal((b, max_len, h_kv, d)).astype(np.float32)
    if int8:
        jcache = tuple(tuple(np.array(a) for a in jax_llama.quantize_kv(
            jnp.asarray(c))) for c in (ck, cv))
    else:
        jcache = (ck, cv)
    tcache = tuple(tuple(torch.from_numpy(a.copy()) for a in c) if int8
                   else torch.from_numpy(c.copy()) for c in jcache)
    jcache = tuple(tuple(jnp.asarray(a) for a in c) if int8
                   else jnp.asarray(c) for c in jcache)
    if mode == 'cache_index':
        kw_j = kw_t = dict(cache_index=5)
    else:
        pos = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [12, 13, 14, 15]],
                       np.int32)
        kw_j = dict(cache_positions=jnp.asarray(pos))
        kw_t = dict(cache_positions=torch.from_numpy(pos))
    attn_j, cache_j = jax_llama.slot_cache_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcache, window=6,
        **kw_j)
    attn_t, cache_t = llama.slot_cache_attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tcache, window=6, **kw_t)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j),
                               atol=KV_ATOL)
    flat_j = jax.tree_util.tree_leaves(cache_j)
    flat_t = [cache_t[0], cache_t[1]] if not int8 else [
        *cache_t[0], *cache_t[1]]
    for got, want in zip(flat_t, flat_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=KV_ATOL)
