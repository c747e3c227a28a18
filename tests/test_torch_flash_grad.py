"""Flash-attention gradient of the PyTorch port vs the JAX reference, on
the CPU.

``jax.grad`` of ``skypilot_tpu.ops.flash_attention.flash_attention`` runs
the Pallas forward and backward kernels in interpret mode here, at S=256
with blocks of 128 so that the JAX side skips causal blocks. The port's
``flash_attention`` on CPU tensors is the same ``torch.autograd.Function``
the card runs, with ``flash_attention_plain`` / ``flash_attention_bwd_plain``
in place of the kernels. Inputs are made with numpy from a seed.

Tolerance: fp32 atol 5e-5 on dq/dk/dv (both sides compute in fp32; the
sums over S=256 keys and over the GQA group run in another order), and
2e-5 against torch autograd through the plain forward.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import flash_attention as jax_flash
from skypilot_tpu_torch.ops import flash_attention

GRAD_ATOL = 5e-5
AUTOGRAD_ATOL = 2e-5


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _segments(b, s):
    pos = np.arange(s)[None, :]
    cuts = np.array([[s // 3 + 9 * i, 2 * s // 3 - 7 * i]
                     for i in range(b)])
    return ((pos >= cuts[:, :1]).astype(np.int32) +
            (pos >= cuts[:, 1:]).astype(np.int32))


CASES = {
    'causal': dict(),
    'window': dict(window=100),
    'segments': dict(segments=True),
    'softcap_scale': dict(logit_softcap=20.0, scale=0.1),
    'non_causal': dict(causal=False),
    'hkv_1': dict(h_kv=1),
    'groups_2_b2': dict(b=2, segments=True, window=77),
}


def _inputs(case):
    kw = dict(CASES[case])
    b = kw.pop('b', 1)
    h_kv = kw.pop('h_kv', 2)
    segments = kw.pop('segments', False)
    s, h, d = 256, 4, 32
    arrays = dict(q=_normal(20, b, s, h, d), k=_normal(21, b, s, h_kv, d),
                  v=_normal(22, b, s, h_kv, d), dout=_normal(23, b, s, h, d))
    seg = _segments(b, s) if segments else None
    kw.setdefault('causal', True)
    return arrays, seg, kw


def _torch_grads(arrays, seg, kw):
    q, k, v = (torch.from_numpy(arrays[n]).requires_grad_()
               for n in ('q', 'k', 'v'))
    out = flash_attention.flash_attention(
        q, k, v, segment_ids=None if seg is None else torch.from_numpy(seg),
        **kw)
    out.backward(torch.from_numpy(arrays['dout']))
    return out.detach(), q.grad, k.grad, v.grad


@pytest.mark.parametrize('case', sorted(CASES))
def test_flash_gradient_matches_jax(case):
    arrays, seg, kw = _inputs(case)

    def loss(q, k, v):
        out = jax_flash.flash_attention(
            q, k, v, block_q=128, block_kv=128,
            segment_ids=None if seg is None else jnp.asarray(seg), **kw)
        return jnp.sum(out * jnp.asarray(arrays['dout']))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(arrays[n]) for n in ('q', 'k', 'v')))
    _, *got = _torch_grads(arrays, seg, kw)
    for name, g, w in zip('qkv', got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   err_msg=f'd{name}')


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_backward_matches_autograd_of_plain_forward(case):
    """flash_attention_bwd_plain is the derivative of the plain forward:
    torch autograd through flash_attention_plain gives the same grads."""
    arrays, seg, kw = _inputs(case)
    seg_t = None if seg is None else torch.from_numpy(seg)
    q, k, v = (torch.from_numpy(arrays[n]).requires_grad_()
               for n in ('q', 'k', 'v'))
    opts = dict(causal=kw['causal'], window=kw.get('window'),
                segment_ids=seg_t, logit_softcap=kw.get('logit_softcap'),
                scale=kw.get('scale'))
    out, _ = flash_attention.flash_attention_plain(q, k, v, **opts)
    dout = torch.from_numpy(arrays['dout'])
    out.backward(dout)
    with torch.no_grad():
        out2, lse = flash_attention.flash_attention_plain(q, k, v, **opts)
        got = flash_attention.flash_attention_bwd_plain(
            q, k, v, out2, dout, lse, **opts)
    for name, g, w in zip('qkv', got, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(g, w, atol=AUTOGRAD_ATOL, rtol=0,
                                   msg=f'd{name}')


def test_segment_ids_carry_no_gradient():
    arrays, seg, kw = _inputs('segments')
    out, dq, dk, dv = _torch_grads(arrays, seg, kw)
    assert out.shape == dq.shape
    assert dk.shape == dv.shape == arrays['k'].shape
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))


def _plain_grads(s=1024, seed=30):
    """Plain forward and backward in fp32 at B1 H2/1 D32 → (inputs, out,
    lse, grads)."""
    q, dout = (torch.from_numpy(_normal(seed + i, 1, s, 2, 32))
               for i in range(2))
    k, v = (torch.from_numpy(_normal(seed + 2 + i, 1, s, 1, 32))
            for i in range(2))
    out, lse = flash_attention.flash_attention_plain(q, k, v)
    grads = flash_attention.flash_attention_bwd_plain(q, k, v, out, dout,
                                                      lse)
    return (q, k, v, dout), out, lse, grads


def test_gradient_errors_are_local_to_each_block():
    """The gradients shrink along a causal sequence, so the check is held
    to each 64-row block's own size: a 10 % fault past the middle reads
    0.1 blockwise, as does dq from an LSE 0.1 high on one tile, while
    rounding the gradient to bf16 reads under the kernels' bf16 limits
    (1e-2 blockwise, 0.15 per element over the block's RMS)."""
    (q, k, v, dout), out, lse, (dq, dk, dv) = _plain_grads()
    assert flash_attention.gradient_errors(dk, dk) == (0.0, 0.0)
    norm_err, elem_err = flash_attention.gradient_errors(
        dk.to(torch.bfloat16), dk)
    assert norm_err < 3e-3 and elem_err < 3e-2
    late = dk.clone()
    late[:, 512:] *= 0.9
    norm_err, elem_err = flash_attention.gradient_errors(late, dk)
    assert norm_err == pytest.approx(0.1, rel=1e-4) and elem_err > 0.1
    # A fixed atol would not see it: the late rows are small.
    assert float((late - dk).abs().max()) < 0.05
    bad_lse = lse.clone()
    bad_lse[:, :, 768:832] += 0.1
    bad_dq = flash_attention.flash_attention_bwd_plain(
        q, k, v, out, dout, bad_lse)[0]
    assert flash_attention.gradient_errors(bad_dq, dq)[0] > 0.09


def test_gradient_errors_ragged_rows_and_non_finite():
    """S not a multiple of the block: the last block's RMS counts only
    its rows; a NaN reads as inf."""
    *_, (dq, _, _) = _plain_grads(s=200)
    bad = dq.clone()
    bad[:, 192:] += dq[:, 192:] * 0.5
    norm_err, _ = flash_attention.gradient_errors(bad, dq)
    assert norm_err == pytest.approx(0.5, rel=1e-4)
    bad[0, 3, 1, 7] = float('nan')
    assert flash_attention.gradient_errors(bad, dq) == (float('inf'),
                                                       float('inf'))
