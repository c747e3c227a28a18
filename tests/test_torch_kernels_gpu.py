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
kernel's bf16 P before P·V).
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
    assert not out[0].any()
