"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: these need an NVIDIA Hopper card and ``nvcc``, and skip
elsewhere (the check happens inside the test, never at import). Run them
on the card with

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu -q

(``--noconftest``: the suite's conftest imports JAX, which a machine
with the card need not have.)

``chip_smoke.py`` runs the same comparisons at the main path's shapes.
Tolerances: fp32 atol 1e-4 (summation order); bf16 atol 2e-2 + 1e-2
relative (one or two bf16 ulps: the output rounding, and the flash
kernel's bf16 P before P·V). Gradients: blockwise, see GRAD_TOL.
"""
from __future__ import annotations

import pytest
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import decode_attention
from skypilot_tpu_torch.ops import flash_attention

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}
# Gradients, judged in each block of 64 rows of one head against the
# reference's own size there (flash_attention.gradient_errors), since
# attention gradients shrink along the sequence: limits on the blockwise
# relative error and on the largest element error over the block's RMS.
# fp32 sums in another order; bf16 also rounds P and dS to bf16 before
# their products (as the Pallas kernels do) and the gradient on the way
# out. chip_smoke.py holds the kernels to the same limits.
GRAD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 0.15)}


def assert_grad_close(got, want, dtype, name):
    norm_err, elem_err = flash_attention.gradient_errors(got, want)
    norm_tol, elem_tol = GRAD_TOL[dtype]
    assert norm_err <= norm_tol and elem_err <= elem_tol, (
        f'{name}: block rel err {norm_err:.3e} (limit {norm_tol:g}), '
        f'element err / block rms {elem_err:.3e} (limit {elem_tol:g})')


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (kernels build with nvcc at first '
                    'use)')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    return gen


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device='cuda').to(dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kw', [dict(), dict(window=37),
                                dict(segments=True),
                                dict(softcap=20.0, scale=0.1),
                                dict(causal=False)],
                         ids=['causal', 'window', 'segments',
                              'softcap_scale', 'non_causal'])
def test_flash_kernel_matches_plain(card, dtype, kw):
    kw = dict(kw)
    b, s, h, h_kv, d = 2, 200, 4, 2, 64
    q = _randn(card, (b, s, h, d), dtype)
    k = _randn(card, (b, s, h_kv, d), dtype)
    v = _randn(card, (b, s, h_kv, d), dtype)
    seg = None
    if kw.pop('segments', False):
        seg = (torch.arange(s, device='cuda')[None, :] >= 90).int().expand(
            b, s).contiguous()
    causal = kw.pop('causal', True)
    out, lse = flash_attention._flash_fwd(
        q, k, v, seg, causal=causal, window=kw.get('window'),
        softcap=kw.get('softcap'), scale_override=kw.get('scale'))
    ref, ref_lse = flash_attention.flash_attention_plain(
        q, k, v, causal=causal, window=kw.get('window'), segment_ids=seg,
        logit_softcap=kw.get('softcap'), scale=kw.get('scale'))
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kw', [dict(), dict(window=37),
                                dict(segments=True),
                                dict(softcap=20.0, scale=0.1),
                                dict(causal=False), dict(d=16, h_kv=1)],
                         ids=['causal', 'window', 'segments',
                              'softcap_scale', 'non_causal', 'd16_hkv1'])
def test_flash_backward_kernels_match_plain(card, dtype, kw):
    """dq (K3) and dk/dv (K2) against the plain backward on the same
    forward output and LSE; S=200 is ragged against the 64-row tiles."""
    kw = dict(kw)
    b, s, h = 2, 200, 4
    h_kv, d = kw.pop('h_kv', 2), kw.pop('d', 64)
    q = _randn(card, (b, s, h, d), dtype)
    k = _randn(card, (b, s, h_kv, d), dtype)
    v = _randn(card, (b, s, h_kv, d), dtype)
    dout = _randn(card, (b, s, h, d), dtype)
    seg = None
    if kw.pop('segments', False):
        seg = (torch.arange(s, device='cuda')[None, :] >= 90).int().expand(
            b, s).contiguous()
    opts = dict(causal=kw.pop('causal', True), window=kw.get('window'),
                softcap=kw.get('softcap'), scale_override=kw.get('scale'))
    out, lse = flash_attention._flash_fwd(q, k, v, seg, **opts)
    got = flash_attention._flash_bwd(q, k, v, seg, out, dout, lse, **opts)
    want = flash_attention.flash_attention_bwd_plain(
        q, k, v, out, dout, lse, causal=opts['causal'],
        window=opts['window'], segment_ids=seg,
        logit_softcap=opts['softcap'], scale=opts['scale_override'])
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert_grad_close(g, w, dtype, name)


def test_flash_backward_check_rejects_planted_faults(card):
    """In bf16 at S=2048, where the later rows' gradients are small, the
    kernels pass the check and two faults confined to late rows fail it:
    dK 10 % low past the middle, dQ from an LSE 0.1 high on one tile."""
    b, s, h, h_kv, d = 1, 2048, 4, 2, 128
    dtype = torch.bfloat16
    q, dout = (_randn(card, (b, s, h, d), dtype) for _ in range(2))
    k, v = (_randn(card, (b, s, h_kv, d), dtype) for _ in range(2))
    out, lse = flash_attention._flash_fwd(q, k, v)
    dq, dk, dv = flash_attention._flash_bwd(q, k, v, None, out, dout, lse)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, out, dout, lse)
    for name, g, w in zip(('dq', 'dk', 'dv'), (dq, dk, dv), want):
        assert_grad_close(g, w, dtype, name)
    bad_dk = dk.clone()
    bad_dk[:, s // 2:] *= 0.9
    bad_lse = lse.clone()
    bad_lse[:, :, 1536:1600] += 0.1
    bad_dq = flash_attention._flash_bwd_dq(q, k, v, None, out, dout, bad_lse)
    for name, g, w in (('dk', bad_dk, want[1]), ('dq', bad_dq, want[0])):
        with pytest.raises(AssertionError):
            assert_grad_close(g, w, dtype, name)


def test_flash_attention_autograd_on_the_card(card):
    """The autograd Function on CUDA tensors launches all three kernels
    and agrees with the same Function on the CPU (plain versions)."""
    b, s, h, h_kv, d = 1, 130, 4, 2, 32
    tensors = [torch.randn(shape, generator=card, device='cuda')
               for shape in ((b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d),
                             (b, s, h, d))]
    grads = {}
    for device in ('cuda', 'cpu'):
        q, k, v = (t.detach().to(device).requires_grad_()
                   for t in tensors[:3])
        out = flash_attention.flash_attention(q, k, v, window=50)
        out.backward(tensors[3].to(device))
        grads[device] = [out.detach(), q.grad, k.grad, v.grad]
    torch.testing.assert_close(grads['cuda'][0].cpu(), grads['cpu'][0],
                               **TOL[torch.float32])
    for name, got, want in zip(('dq', 'dk', 'dv'), grads['cuda'][1:],
                               grads['cpu'][1:]):
        assert_grad_close(got.cpu(), want, torch.float32, name)


@pytest.mark.parametrize('kv', ['bf16', 'fp32', 'int8'])
@pytest.mark.parametrize('window', [None, 50])
def test_decode_kernel_matches_plain(card, kv, window):
    b, max_len, h, h_kv, d = 6, 300, 8, 2, 128
    q = _randn(card, (b, 1, h, d), torch.bfloat16)
    k = _randn(card, (b, max_len, h_kv, d), torch.float32)
    v = _randn(card, (b, max_len, h_kv, d), torch.float32)
    if kv == 'int8':
        k, v = llama.quantize_kv(k), llama.quantize_kv(v)
    else:
        dtype = torch.bfloat16 if kv == 'bf16' else torch.float32
        k, v = k.to(dtype), v.to(dtype)
    lengths = torch.tensor([0, 1, 63, 64, 300, 400], dtype=torch.int32,
                           device='cuda')
    out = decode_attention.decode_attention(q, k, v, lengths, window=window)
    ref = decode_attention.decode_attention_plain(q, k, v, lengths,
                                                  window=window)
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize('kv', ['bf16', 'fp32', 'int8'])
@pytest.mark.parametrize('max_len', [300, 100])
def test_decode_kernel_length_zero_slot_is_mean_of_first_rows(card, kv,
                                                               max_len):
    """A slot of length 0 gives the mean of its first min(256, max_len)
    V rows (dequantized), as the JAX kernel does."""
    b, h, h_kv, d = 3, 8, 2, 64
    q = _randn(card, (b, 1, h, d), torch.float32)
    k = _randn(card, (b, max_len, h_kv, d), torch.float32)
    v = _randn(card, (b, max_len, h_kv, d), torch.float32)
    if kv == 'int8':
        k, v = llama.quantize_kv(k), llama.quantize_kv(v)
        v_rows = v[0].float() * v[1]
    else:
        dtype = torch.bfloat16 if kv == 'bf16' else torch.float32
        k, v = k.to(dtype), v.to(dtype)
        v_rows = v.float()
    lengths = torch.tensor([0, 5, 0], dtype=torch.int32, device='cuda')
    out = decode_attention.decode_attention(q, k, v, lengths, window=3)
    ref = decode_attention.decode_attention_plain(q, k, v, lengths,
                                                  window=3)
    torch.testing.assert_close(out, ref, **TOL[torch.float32])
    mean = v_rows[:, :min(256, max_len)].mean(dim=1)      # [B, Hkv, D]
    want = mean.repeat_interleave(h // h_kv, dim=1)[:, None]
    torch.testing.assert_close(out[0], want[0], **TOL[torch.float32])
    torch.testing.assert_close(out[2], want[2], **TOL[torch.float32])
