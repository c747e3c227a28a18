"""PyTorch port's attention ops vs the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its port counterpart. The JAX Pallas kernels run in interpret mode
here (as the JAX package's own tests run them on the CPU); the port's
wrappers take their plain versions because the tensors lie on the CPU.
Tolerance: fp32 atol 2e-5 (both sides compute in fp32; summation order
differs).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.ops import attention as jax_attention
from skypilot_tpu.ops import decode_attention as jax_decode
from skypilot_tpu.ops import flash_attention as jax_flash
from skypilot_tpu_torch.models import llama as torch_llama
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.ops import decode_attention
from skypilot_tpu_torch.ops import flash_attention

ATOL = 2e-5


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _segments(b, s):
    """Three packed documents per row, boundaries differing by row."""
    pos = np.arange(s)[None, :]
    cuts = np.array([[s // 3 + 9 * i, 2 * s // 3 - 7 * i]
                     for i in range(b)])
    return ((pos >= cuts[:, :1]).astype(np.int32) +
            (pos >= cuts[:, 1:]).astype(np.int32))


ATTN_CASES = {
    'causal': dict(causal=True),
    'window': dict(causal=True, window=5),
    'segments': dict(causal=True, segments=True),
    'softcap_scale': dict(causal=True, logit_softcap=3.0, scale=0.3),
    'non_causal_window': dict(causal=False, window=4),
    'kv_longer_than_q': dict(causal=True, s_q=7),
}


@pytest.mark.parametrize('case', sorted(ATTN_CASES))
def test_xla_attention_matches_jax(case):
    kw = dict(ATTN_CASES[case])
    segments = kw.pop('segments', False)
    s_q = kw.pop('s_q', 24)
    b, s, h, h_kv, d = 2, 24, 4, 2, 16
    q = _normal(0, b, s_q, h, d)
    k = _normal(1, b, s, h_kv, d)
    v = _normal(2, b, s, h_kv, d)
    seg = _segments(b, s) if segments else None
    want = jax_attention.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=None if seg is None else jnp.asarray(seg), **kw)
    got = attention.xla_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segment_ids=None if seg is None else torch.from_numpy(seg), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_xla_attention_with_mask_matches_jax():
    b, s, h, h_kv, d = 3, 16, 4, 1, 16
    q = _normal(3, b, 1, h, d)
    k = _normal(4, b, s, h_kv, d)
    v = _normal(5, b, s, h_kv, d)
    mask = np.random.default_rng(6).random((b, 1, 1, s)) < 0.6
    mask[:, :, :, 0] = True
    want = jax_attention.xla_attention_with_mask(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        logit_softcap=5.0)
    got = attention.xla_attention_with_mask(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), logit_softcap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dot_product_attention_dispatch_on_cpu():
    """'auto' on CPU tensors takes the plain path; 'flash' on CPU
    tensors takes the flash kernel's plain version (same function)."""
    q = torch.from_numpy(_normal(7, 1, 32, 4, 16))
    k = torch.from_numpy(_normal(8, 1, 32, 2, 16))
    v = torch.from_numpy(_normal(9, 1, 32, 2, 16))
    ref = attention.xla_attention(q, k, v)
    auto = attention.dot_product_attention(q, k, v)
    flash = attention.dot_product_attention(q, k, v,
                                            implementation='flash')
    torch.testing.assert_close(auto, ref, atol=0, rtol=0)
    torch.testing.assert_close(flash, ref, atol=ATOL, rtol=0)


FLASH_CASES = {
    'causal': dict(causal=True),
    'window': dict(causal=True, window=100),
    'segments': dict(causal=True, segments=True),
    'softcap_scale': dict(causal=True, softcap=20.0, scale=0.1),
}


@pytest.mark.parametrize('case', sorted(FLASH_CASES))
def test_plain_flash_matches_jax_kernel(case):
    """Port's plain flash (out and LSE) vs the JAX kernel in interpret
    mode: S=256, H=4, Hkv=2, D=32, blocks of 128."""
    kw = dict(FLASH_CASES[case])
    segments = kw.pop('segments', False)
    b, s, h, h_kv, d = 1, 256, 4, 2, 32
    q = _normal(10, b, s, h, d)
    k = _normal(11, b, s, h_kv, d)
    v = _normal(12, b, s, h_kv, d)
    seg = _segments(b, s) if segments else None
    out_j, lse_j = jax_flash._flash_fwd(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)),
        None if seg is None else jnp.asarray(seg),
        causal=kw['causal'], block_q=128, block_kv=128,
        window=kw.get('window'), softcap=kw.get('softcap'),
        scale_override=kw.get('scale'))
    out_t, lse_t = flash_attention.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=kw['causal'], window=kw.get('window'),
        segment_ids=None if seg is None else torch.from_numpy(seg),
        logit_softcap=kw.get('softcap'), scale=kw.get('scale'))
    np.testing.assert_allclose(
        out_t.numpy(), np.asarray(out_j).transpose(0, 2, 1, 3), atol=ATOL)
    np.testing.assert_allclose(
        lse_t.numpy(),
        np.asarray(lse_j)[..., 0].reshape(b, h, s), atol=ATOL)
    # The public entry point on CPU tensors is the same plain version.
    out_pub = flash_attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=kw['causal'], window=kw.get('window'),
        segment_ids=None if seg is None else torch.from_numpy(seg),
        logit_softcap=kw.get('softcap'), scale=kw.get('scale'))
    torch.testing.assert_close(out_pub, out_t, atol=0, rtol=0)


DECODE_CASES = {
    'dense': dict(),
    'window': dict(window=40),
    'int8_pair': dict(int8=True),
    'softcap_scale': dict(logit_softcap=4.0, scale=0.2),
}


@pytest.mark.parametrize('case', sorted(DECODE_CASES))
def test_plain_decode_matches_jax_kernel(case):
    """Port's plain decode vs the JAX kernel in interpret mode, ragged
    lengths including 0, at the JAX default block of 256 rows (the one
    serving uses): a length-0 slot gives the mean of its first 256 V rows
    on both sides."""
    kw = dict(DECODE_CASES[case])
    int8 = kw.pop('int8', False)
    b, max_len, h, h_kv, d = 5, 512, 4, 2, 32
    q = _normal(13, b, 1, h, d)
    k = _normal(14, b, max_len, h_kv, d)
    v = _normal(15, b, max_len, h_kv, d)
    lengths = np.array([0, 1, 255, 257, 512], np.int32)
    if int8:
        kq, ks = (np.array(a) for a in jax_llama.quantize_kv(
            jnp.asarray(k)))
        vq, vs = (np.array(a) for a in jax_llama.quantize_kv(
            jnp.asarray(v)))
        jk, jv = (jnp.asarray(kq), jnp.asarray(ks)), (jnp.asarray(vq),
                                                     jnp.asarray(vs))
        tk = (torch.from_numpy(kq), torch.from_numpy(ks))
        tv = (torch.from_numpy(vq), torch.from_numpy(vs))
        # Both sides quantize identically.
        tq, tscale = torch_llama.quantize_kv(torch.from_numpy(k))
        np.testing.assert_array_equal(tq.numpy(), kq)
        np.testing.assert_allclose(tscale.numpy(), ks, rtol=1e-6)
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    want = np.asarray(jax_decode.decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(lengths), block_kv=256, **kw))
    got = decode_attention.decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(lengths), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert np.abs(want[0]).max() > 0
