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


# The limits the kernels' forward outputs are held to blockwise on the
# card (chip_smoke.py, tests/test_torch_kernels_gpu.py).
_BLOCK_TOL = {torch.bfloat16: (1e-2, 0.15), torch.float32: (1e-5, 1e-4)}


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('fault', ['late_rows_x0.9', 'tile_from_other_head'])
def test_gradient_errors_see_a_late_output_fault(dtype, fault):
    """The forward's output shrinks along a causal sequence too, so it is
    judged blockwise as well: the plain output rounded to the kernel's
    type reads under the limits, and a fault confined to late rows (10 %
    low past the middle; one 64-row tile of head 0 holding head 1's rows,
    as a wrong V fragment would give) reads over them."""
    _, out, _, _ = _plain_grads()
    norm_tol, elem_tol = _BLOCK_TOL[dtype]
    sound = out.to(dtype)
    norm_err, elem_err = flash_attention.gradient_errors(sound, out)
    assert norm_err <= norm_tol and elem_err <= elem_tol
    bad = sound.clone()
    if fault == 'late_rows_x0.9':
        bad[:, 512:] *= 0.9
    else:
        bad[:, 768:832, 0] = bad[:, 768:832, 1]
    norm_err, elem_err = flash_attention.gradient_errors(bad, out)
    assert norm_err > 0.09 and elem_err > elem_tol


def test_check_aligned_names_the_misaligned_tensor():
    """The TMA loads of the wgmma kernels need 16-byte-aligned bases: a
    contiguous view two bf16 elements into its storage is refused with
    the tensor's name; an aligned one passes."""
    storage = torch.zeros(2 * 64 * 4 * 64 + 8, dtype=torch.bfloat16)
    good = storage[:-8].view(2, 64, 4, 64)
    bad = storage[2:-6].view(2, 64, 4, 64)
    assert good.is_contiguous() and bad.is_contiguous()
    flash_attention.check_aligned(q=good, dout=good)
    with pytest.raises(ValueError, match=r'needs dout to start on a 16-byte'
                                         r' boundary \(TMA\)'):
        flash_attention.check_aligned(q=good, dout=bad)


def _record_backward_launches(monkeypatch, scratch_floats):
    """Stand-ins for the backward kernels' library on a machine without a
    card: the launches are recorded, not run, and the library's scratch
    rule answers ``scratch_floats``."""
    calls = []
    monkeypatch.setattr(flash_attention, '_check_bwd', lambda *args: None)
    monkeypatch.setattr(flash_attention.kernels, 'stream_ptr',
                        lambda device: 0)
    monkeypatch.setattr(flash_attention.DQ_KERNEL, 'query',
                        lambda symbol, *args: scratch_floats)
    for name, kern in (('dq', flash_attention.DQ_KERNEL),
                       ('dkv', flash_attention.DKV_KERNEL)):
        monkeypatch.setattr(kern, 'launch',
                            lambda *args, name=name: calls.append(
                                (name, args)))
    return calls


# Positions of (scratch pointer, fill flag) in each entry point's
# arguments: seven input pointers, then the outputs (dq; dk, dv).
_STATS_ARG = {'dq': 8, 'dkv': 9}


def test_one_backward_runs_the_row_pre_pass_once(monkeypatch):
    """_flash_bwd hands one pre-pass scratch, sized by the library, to both
    kernels: the dQ launch fills it, the dK/dV launch reads it."""
    calls = _record_backward_launches(monkeypatch, 2 * 2 * 4 * 64)
    q = torch.zeros((2, 64, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 64, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((2, 4, 64))
    flash_attention._flash_bwd(q, k, k, None, q, q, lse, causal=True)
    assert [name for name, _ in calls] == ['dq', 'dkv']
    (_, dq_args), (_, dkv_args) = calls
    stats, fill = dq_args[_STATS_ARG['dq']:_STATS_ARG['dq'] + 2]
    assert stats is not None and fill == 1
    assert dkv_args[_STATS_ARG['dkv']:_STATS_ARG['dkv'] + 2] == (stats, 0)


@pytest.mark.parametrize('kernel', ['dq', 'dkv'])
def test_a_backward_kernel_alone_fills_its_own_scratch(monkeypatch, kernel):
    """Launched on its own, either backward kernel gets scratch of its
    own and computes the row statistics into it."""
    calls = _record_backward_launches(monkeypatch, 2 * 2 * 4 * 64)
    q = torch.zeros((2, 64, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 64, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((2, 4, 64))
    launch = {'dq': flash_attention._flash_bwd_dq,
              'dkv': flash_attention._flash_bwd_dkv}[kernel]
    launch(q, k, k, None, q, q, lse)
    launch(q, k, k, None, q, q, lse)
    (_, first), (_, second) = calls
    at = _STATS_ARG[kernel]
    assert first[at + 1] == second[at + 1] == 1
    assert first[at] is not None and second[at] is not None


def test_no_scratch_where_the_library_asks_for_none(monkeypatch):
    """fp32 and the mma.sync head dims take no pre-pass: both kernels get
    a null scratch pointer."""
    calls = _record_backward_launches(monkeypatch, 0)
    q = torch.zeros((1, 32, 2, 32))
    lse = torch.zeros((1, 2, 32))
    flash_attention._flash_bwd(q, q, q, None, q, q, lse)
    assert [args[_STATS_ARG[name]] for name, args in calls] == [None, None]
