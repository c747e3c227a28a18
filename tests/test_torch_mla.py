"""PyTorch port's MLA decode attention (plain K6 and K7) and expert
routing vs the JAX reference, on the CPU.

The JAX MLA decode kernels run in Pallas interpret mode, as the JAX
package's own tests run them on the CPU; the port's wrappers take their
plain versions (CPU tensors). Inputs come from numpy seeds and go through
both packages. Tolerances: 1e-5 on attention outputs (fp32 math in both,
summed in another order; a bf16 cache is upcast exactly by both) and on
the routed MLP's output; routing decisions must be identical.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import deepseek as jax_deepseek
from skypilot_tpu.models import moe as jax_moe
from skypilot_tpu.ops import mla_decode as jax_mla
from skypilot_tpu_torch.models import deepseek
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.ops import mla_decode

ATTN_ATOL = 1e-5
SCALE = 24 ** -0.5
DTYPES = {'fp32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


def _cache(rng, shape, dtype):
    """A cache array in the given type, the same values on both sides."""
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _queries(rng, b, h, r, dr):
    q_eff = rng.standard_normal((b, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((b, h, dr)).astype(np.float32)
    return q_eff, q_rope


# ---- K6: dense ----

@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('block_kv', [8, 16, 256])
def test_plain_mla_decode_matches_jax_kernel(dtype, block_kv):
    """Ragged lengths around block edges, a length-0 slot and an inactive
    slot (length past the cache, clamped)."""
    rng = np.random.default_rng(block_kv)
    b, h, r, dr, max_len = 7, 4, 32, 8, 64
    q_eff, q_rope = _queries(rng, b, h, r, dr)
    jckv, tckv = _cache(rng, (b, max_len, r), dtype)
    jkr, tkr = _cache(rng, (b, max_len, dr), dtype)
    lengths = np.array([0, 1, 7, 8, 17, max_len, max_len + 1], np.int32)
    want = np.asarray(jax_mla.mla_decode_attention(
        jnp.asarray(q_eff), jnp.asarray(q_rope), jckv, jkr,
        jnp.asarray(lengths), SCALE, block_kv=block_kv))
    got = mla_decode.mla_decode_attention(
        torch.from_numpy(q_eff), torch.from_numpy(q_rope), tckv, tkr,
        torch.from_numpy(lengths), SCALE, block_kv=block_kv)
    assert got.dtype == torch.float32 and got.shape == (b, h, r)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL, rtol=0)
    # The length-0 slot: the mean of its first min(block_kv, K) c_kv rows.
    mean = tckv[0, :min(block_kv, max_len)].float().mean(dim=0)
    np.testing.assert_allclose(got[0].numpy(),
                               mean.expand(h, r).numpy(), atol=ATTN_ATOL)


def test_plain_mla_decode_ignores_rows_past_the_length():
    rng = np.random.default_rng(5)
    b, h, r, dr, max_len = 2, 2, 16, 8, 32
    q_eff, q_rope = (torch.from_numpy(a) for a in _queries(rng, b, h, r, dr))
    ckv = torch.from_numpy(rng.standard_normal((b, max_len, r)).astype(
        np.float32))
    krope = torch.from_numpy(rng.standard_normal((b, max_len, dr)).astype(
        np.float32))
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    out = mla_decode.mla_decode_attention(q_eff, q_rope, ckv, krope,
                                          lengths, 0.2)
    ckv[:, 12:], krope[:, 12:] = 1e4, 1e4
    assert torch.equal(out, mla_decode.mla_decode_attention(
        q_eff, q_rope, ckv, krope, lengths, 0.2))


# ---- K7: paged ----

def _paged_inputs(seed, dtype, b, num_pages, page, nblk, h, r, dr, lengths,
                  allocated):
    rng = np.random.default_rng(seed)
    q_eff, q_rope = _queries(rng, b, h, r, dr)
    jckv, tckv = _cache(rng, (num_pages, page, r), dtype)
    jkr, tkr = _cache(rng, (num_pages, page, dr), dtype)
    # Each slot's own random permutation of pages; entries past its
    # allocation hold the sentinel (== num_pages).
    perm = np.stack([rng.permutation(num_pages)[:nblk] for _ in range(b)])
    tables = np.full((b, nblk), num_pages, np.int32)
    for i, n in enumerate(allocated):
        used = -(-min(n, nblk * page) // page)
        tables[i, :used] = perm[i, :used]
    return (q_eff, q_rope, (jckv, tckv), (jkr, tkr),
            np.asarray(lengths, np.int32), tables)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_plain_paged_mla_decode_matches_jax_kernel(dtype):
    """Page 8, permuted tables with sentinel tails, a length-0 slot whose
    first block is allocated, one whose row is all sentinel, and an
    inactive slot (length past the table, all-sentinel row)."""
    page, nblk, num_pages = 8, 6, 40
    lengths = [1, 8, 9, 0, 0, nblk * page + 1, 30]
    allocated = [1, 8, 9, 8, 0, 0, 40]
    q_eff, q_rope, ckv, krope, lens, tables = _paged_inputs(
        3, dtype, len(lengths), num_pages, page, nblk, 4, 32, 8, lengths,
        allocated)
    want = np.asarray(jax_mla.paged_mla_decode_attention(
        jnp.asarray(q_eff), jnp.asarray(q_rope), ckv[0], krope[0],
        jnp.asarray(lens), jnp.asarray(tables), SCALE))
    got = mla_decode.paged_mla_decode_attention(
        torch.from_numpy(q_eff), torch.from_numpy(q_rope), ckv[1], krope[1],
        torch.from_numpy(lens), torch.from_numpy(tables), SCALE)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL, rtol=0)
    for slot in (3, 4):
        # The mean of the `page` c_kv rows of the slot's first clamped page.
        first = min(int(tables[slot, 0]), num_pages - 1)
        mean = ckv[1][first].float().mean(dim=0)
        np.testing.assert_allclose(got[slot].numpy(),
                                   mean.expand(4, 32).numpy(),
                                   atol=ATTN_ATOL)


def test_plain_paged_equals_dense_on_an_identity_table():
    rng = np.random.default_rng(9)
    b, page, nblk, h, r, dr = 3, 8, 4, 4, 32, 8
    q_eff, q_rope = (torch.from_numpy(a) for a in _queries(rng, b, h, r, dr))
    ckv = torch.from_numpy(rng.standard_normal(
        (b, nblk * page, r)).astype(np.float32))
    krope = torch.from_numpy(rng.standard_normal(
        (b, nblk * page, dr)).astype(np.float32))
    lengths = torch.tensor([1, 13, 32], dtype=torch.int32)
    tables = torch.arange(b * nblk, dtype=torch.int32).reshape(b, nblk)
    dense = mla_decode.mla_decode_attention(q_eff, q_rope, ckv, krope,
                                            lengths, SCALE)
    paged = mla_decode.paged_mla_decode_attention(
        q_eff, q_rope, ckv.reshape(-1, page, r), krope.reshape(-1, page, dr),
        lengths, tables, SCALE)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), atol=1e-6)


# ---- expert routing ----

JCFG = dataclasses.replace(jax_deepseek.DEEPSEEK_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(deepseek.DEEPSEEK_TINY, dtype=torch.float32)


@pytest.fixture(scope='module')
def moe_layer():
    """Layer 0 of the tiny model's MoE group, from the JAX init."""
    jp = jax_deepseek.init(JCFG, jax.random.PRNGKey(1))['moe_layers']
    jlp = {k: v[0] for k, v in jp.items()}
    tlp = {k: torch.from_numpy(np.array(v)) for k, v in jlp.items()}
    return jlp, tlp


def _dense_routing(r: moe.Routing, n_experts: int):
    """The port's index routing as the reference's one-hot [T, E, C]
    dispatch and combine tensors."""
    t, k = r.expert.shape
    dispatch = torch.zeros((t, n_experts, r.capacity))
    combine = torch.zeros((t, n_experts, r.capacity))
    for i in range(t):
        for j in range(k):
            if r.keep[i, j]:
                dispatch[i, r.expert[i, j], r.place[i, j]] = 1.0
                combine[i, r.expert[i, j], r.place[i, j]] = r.gate[i, j]
    return dispatch, combine


ROUTE_CASES = {
    'default-capacity': dict(capacity=None, masked=False),
    'forced-drops': dict(capacity=4, masked=False),
    'token-mask-and-drops': dict(capacity=4, masked=True),
}


@pytest.mark.parametrize('case', sorted(ROUTE_CASES))
def test_route_and_moe_mlp_match_jax(moe_layer, case):
    kw = ROUTE_CASES[case]
    jlp, tlp = moe_layer
    rng = np.random.default_rng(2)
    b, s, d = 2, 12, JCFG.d_model
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    if kw['masked']:
        mask[0, 7:] = 0.0
        mask[1, 3:] = 0.0
    jmask = jnp.asarray(mask) if kw['masked'] else None
    tmask = torch.from_numpy(mask) if kw['masked'] else None
    view = jax_deepseek._RouterView(JCFG)
    jd, jc, _ = jax_moe.route(view, jlp['router'],
                              jnp.asarray(h.reshape(b * s, d)),
                              token_mask=None if jmask is None
                              else jmask.reshape(-1),
                              capacity=kw['capacity'])
    r = moe.route(TCFG, tlp['router'], torch.from_numpy(h.reshape(b * s, d)),
                  token_mask=None if tmask is None else tmask.reshape(-1),
                  capacity=kw['capacity'])
    dispatch, combine = _dense_routing(r, TCFG.n_experts)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), atol=1e-6)
    real = (mask.reshape(-1) > 0)[:, None].repeat(TCFG.experts_per_token, 1)
    if kw['capacity'] is not None:
        assert (real & ~r.keep.numpy()).any(), 'no real token was dropped'
    assert not (~real & r.keep.numpy()).any(), 'a masked token was routed'
    jout, _ = jax_moe._moe_mlp(view, None, jnp.asarray(h), jlp,
                               token_mask=jmask, capacity=kw['capacity'])
    tout, aux = moe._moe_mlp(TCFG, torch.from_numpy(h), tlp,
                             token_mask=tmask, capacity=kw['capacity'])
    assert aux is None
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize('capacity', [None, 4])
def test_moe_mlp_bf16_matches_jax_roundings(capacity):
    """A bf16 model: gate and up are fp32 products, as the reference asks,
    and only silu(gate) * up is rounded to bf16. Tolerance: one bf16 step
    at the output's size (|out| < 2), and at most 1 % of the outputs may
    differ at all (an fp32 sum in another order can move a rounding); a
    gate and up rounded to bf16 first change ~60 % of them."""
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    jp = jax_deepseek.init(jcfg, jax.random.PRNGKey(1))['moe_layers']
    jlp = {k: v[0] for k, v in jp.items()}
    tlp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in jlp.items()}
    assert tlp['router'].dtype == torch.float32
    rng = np.random.default_rng(2)
    jh = jnp.asarray(rng.standard_normal((2, 12, jcfg.d_model)),
                     jnp.bfloat16)
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).bfloat16()
    jout, _ = jax_moe._moe_mlp(jax_deepseek._RouterView(jcfg), None, jh, jlp,
                               capacity=capacity)
    want = np.array(jout.astype(jnp.float32))
    got, _ = moe._moe_mlp(tcfg, th, tlp, capacity=capacity)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(want).max() < 2.0
    np.testing.assert_allclose(got, want, atol=2.0 ** -6, rtol=0)
    assert (got != want).mean() <= 0.01


def test_expert_capacity_matches_jax():
    view = jax_deepseek._RouterView(JCFG)
    for tokens in (1, 7, 48, 64, 32768):
        assert moe.expert_capacity(TCFG, tokens) == jax_moe.expert_capacity(
            view, tokens)
    lite = deepseek.DEEPSEEK_V2_LITE
    assert moe.expert_capacity(lite, 32 * 1024) == 3840
