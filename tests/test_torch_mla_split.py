"""The numerical claim the MLA decode kernels' tensor-core walk rests on,
on the CPU.

Over a bf16 cache, K6 and K7 (``csrc/mla_common.cuh``) take every product
on the tensor cores: each fp32 operand that is not from the cache (q, and
the probabilities p) is split into three bf16 terms
(``mla_decode.bf16_terms``), every bf16 × bf16 product is exact in fp32,
and the terms' products are summed in fp32. These tests state that claim
at DeepSeek-V2-Lite's widths, from numpy seeds, and hold the whole
function computed so against the JAX Pallas kernel (interpret mode).
"""
from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import mla_decode as jax_mla
from skypilot_tpu_torch.ops import mla_decode

# DeepSeek-V2-Lite: 16 heads, kv_lora_rank 512, RoPE key 64.
H, R, DR = 16, 512, 64
CSRC = pathlib.Path(mla_decode.__file__).resolve().parents[1] / 'csrc'


@pytest.mark.parametrize('n', [1, 2, 3])
def test_bf16_terms_sum_to_x(n):
    """Each term rounds what the earlier ones left to bf16 (8 significant
    bits), so n terms leave at most 2^-8n of |x|: three hold fp32's 24
    bits. Every term is bf16 and the residuals are exact in fp32."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(
        (rng.standard_normal((H, R + DR)) *
         np.exp2(rng.integers(-20, 20, (H, R + DR)))).astype(np.float32))
    terms = mla_decode.bf16_terms(x, n)
    assert len(terms) == n and all(t.dtype == torch.bfloat16 for t in terms)
    total = sum(t.double() for t in terms)
    assert bool(((total - x.double()).abs() <=
                 2.0 ** (-8 * n) * x.double().abs()).all())


def _terms_product(a: torch.Tensor, b_bf16: torch.Tensor, n: int):
    """Σ_k terms_k(a) @ b in fp32, smallest term first, as the kernel sums
    its accumulators."""
    out = torch.zeros(a.shape[0], b_bf16.shape[-1])
    for term in reversed(mla_decode.bf16_terms(a, n)):
        out = out + term.float() @ b_bf16.float()
    return out


@pytest.mark.parametrize('product', ['scores', 'values'])
def test_three_term_products_match_fp32(product):
    """The scores q · [c_kv | k_rope]ᵀ (16 heads × 576 against 1024 bf16
    rows) and the values p · c_kv (probabilities of 64 rows against 512
    columns) from three-term products, summed in fp32, equal the fp32
    products to 1e-6 of Σ|a·b|, the scale of an fp32 sum's own rounding;
    one term (q or p rounded to bf16) does not."""
    rng = np.random.default_rng(7)
    if product == 'scores':
        a = torch.from_numpy(rng.standard_normal((H, R + DR)).astype(
            np.float32))
        b = torch.from_numpy(rng.standard_normal((R + DR, 1024)).astype(
            np.float32)).bfloat16()
    else:
        s = rng.standard_normal((H, 64)).astype(np.float32) * 3
        a = torch.from_numpy(np.exp(s - s.max(axis=1, keepdims=True)))
        b = torch.from_numpy(rng.standard_normal((64, R)).astype(
            np.float32)).bfloat16()
    want = a @ b.float()
    scale = a.abs() @ b.float().abs()
    err3 = (_terms_product(a, b, 3) - want).abs()
    err1 = (_terms_product(a, b, 1) - want).abs()
    assert bool((err3 <= 1e-6 * scale).all()), float((err3 / scale).max())
    assert bool((err1 > 1e-6 * scale).any())


def _split_mla(q_eff, q_rope, ckv, krope, lengths, scale):
    """Absorbed-MLA decode over live rows, with the kernel's arithmetic:
    three-term q against the bf16 rows, softmax in fp32, three-term
    unnormalised p against c_kv, divided by the fp32 sum."""
    b, _, r = q_eff.shape
    q = torch.cat([q_eff, q_rope], -1)
    rows = torch.cat([ckv, krope], -1)
    out = torch.empty_like(q_eff)
    for i in range(b):
        n = int(lengths[i])
        s = _terms_product(q[i], rows[i, :n].T.contiguous(), 3) * scale
        p = torch.exp(s - s.max(dim=1, keepdim=True).values)
        out[i] = _terms_product(p, ckv[i, :n], 3) / p.sum(dim=1,
                                                           keepdim=True)
    return out


def test_split_arithmetic_matches_the_pallas_kernel():
    """The function as the tensor-core walk computes it, on a bf16 cache at
    DEEPSEEK_TINY's widths (4 heads, r 32, dr 8), against the JAX Pallas
    kernel in interpret mode: 1e-5, the MLA tests' fp32 tolerance."""
    rng = np.random.default_rng(11)
    b, h, r, dr, max_len = 4, 4, 32, 8, 96
    q_eff = rng.standard_normal((b, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((b, h, dr)).astype(np.float32)
    ckv = jnp.asarray(rng.standard_normal((b, max_len, r)), jnp.bfloat16)
    krope = jnp.asarray(rng.standard_normal((b, max_len, dr)), jnp.bfloat16)
    lengths = np.array([1, 33, 70, max_len], np.int32)
    scale = 24 ** -0.5
    want = np.asarray(jax_mla.mla_decode_attention(
        jnp.asarray(q_eff), jnp.asarray(q_rope), ckv, krope,
        jnp.asarray(lengths), scale, block_kv=32))

    def to_torch(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()

    got = _split_mla(torch.from_numpy(q_eff), torch.from_numpy(q_rope),
                     to_torch(ckv), to_torch(krope), lengths, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_split_rows_match_the_kernels():
    """The wrapper sizes the split scratch with SPLIT_ROWS: the rows one
    block of the kernels walks (kMlaSplitRows)."""
    found = re.search(r'kMlaSplitRows = (\d+);',
                      (CSRC / 'mla_common.cuh').read_text())
    assert found and int(found.group(1)) == mla_decode.SPLIT_ROWS
