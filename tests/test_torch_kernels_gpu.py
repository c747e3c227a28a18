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
kernel's bf16 P before P·V). Forward outputs and gradients also
blockwise, see BLOCK_TOL.
"""
from __future__ import annotations

import pathlib
import sys

import pytest
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import decode_attention
from skypilot_tpu_torch.ops import flash_attention
from skypilot_tpu_torch.ops import mla_decode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the flash kernels' tile-edge cases)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}
# Gradients and forward outputs, also judged in each block of 64 rows of
# one head against the reference's own size there
# (flash_attention.gradient_errors), since both shrink along the
# sequence: limits on the blockwise relative error and on the largest
# element error over the block's RMS. fp32 sums in another order; bf16
# also rounds P and dS to bf16 before their products (as the Pallas
# kernels do) and the result on the way out. chip_smoke.py holds the
# kernels to the same limits.
BLOCK_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 0.15)}


def assert_blocks_close(got, want, dtype, name):
    norm_err, elem_err = flash_attention.gradient_errors(got, want)
    norm_tol, elem_tol = BLOCK_TOL[dtype]
    assert norm_err <= norm_tol and elem_err <= elem_tol, (
        f'{name}: block rel err {norm_err:.3e} (limit {norm_tol:g}), '
        f'element err / block rms {elem_err:.3e} (limit {elem_tol:g})')


def assert_out_close(out, lse, ref, ref_lse, dtype):
    """A forward's output, elementwise and blockwise, and its LSE."""
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert_blocks_close(out, ref, dtype, 'out')
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


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


# The wgmma kernels' tile edges (chip_smoke.py phase [3] runs the same
# cases): S 127, 129 and 1000, GQA groups 1, 2 and 4, D 64 and 128, each
# with one of the mask variants in turn, as extra cases of the two tests
# below.
_EDGE_KW = [dict(kw, s=shape[1], h_kv=shape[3], d=shape[4])
            for _, shape, kw in chip_smoke.edge_cases()]
_EDGE_IDS = [f"edge_s{kw['s']}_hkv{kw['h_kv']}_d{kw['d']}_" + (
    '_'.join(k for k in kw if k not in ('s', 'h_kv', 'd')) or 'causal')
    for kw in _EDGE_KW]


# Qwen2-7B's heads: 28 query heads over 4 KV heads, a GQA group of 7,
# which no power-of-two tile divides.
_GQA7_KW = dict(s=1000, h=28, h_kv=4, d=128)


def _flash_inputs(gen, dtype, kw, with_dout=False):
    """(q, k, v[, dout]), segment ids and the kernel's options from a
    case's kw (B2; 4 query heads, S 200, Hkv 2, D 64 unless it says)."""
    kw = dict(kw)
    b, h = 2, kw.pop('h', 4)
    s, h_kv, d = kw.pop('s', 200), kw.pop('h_kv', 2), kw.pop('d', 64)
    q = _randn(gen, (b, s, h, d), dtype)
    k = _randn(gen, (b, s, h_kv, d), dtype)
    v = _randn(gen, (b, s, h_kv, d), dtype)
    tensors = (q, k, v) + ((_randn(gen, (b, s, h, d), dtype),)
                           if with_dout else ())
    seg = None
    if kw.pop('segments', False):
        seg = (torch.arange(s, device='cuda')[None, :] >= 90).int().expand(
            b, s).contiguous()
    opts = dict(causal=kw.pop('causal', True), window=kw.get('window'),
                softcap=kw.get('softcap'), scale_override=kw.get('scale'))
    return tensors, seg, opts


def _plain_opts(seg, opts):
    return dict(causal=opts['causal'], window=opts['window'],
                segment_ids=seg, logit_softcap=opts['softcap'],
                scale=opts['scale_override'])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kw', [dict(), dict(window=37),
                                dict(segments=True),
                                dict(softcap=20.0, scale=0.1),
                                dict(causal=False)] + _EDGE_KW
                         + [_GQA7_KW],
                         ids=['causal', 'window', 'segments',
                              'softcap_scale', 'non_causal'] + _EDGE_IDS
                         + ['gqa7_h28_hkv4_d128'])
def test_flash_kernel_matches_plain(card, dtype, kw):
    (q, k, v), seg, opts = _flash_inputs(card, dtype, kw)
    out, lse = flash_attention._flash_fwd(q, k, v, seg, **opts)
    ref, ref_lse = flash_attention.flash_attention_plain(
        q, k, v, **_plain_opts(seg, opts))
    assert_out_close(out, lse, ref, ref_lse, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kw', [dict(), dict(window=37),
                                dict(segments=True),
                                dict(softcap=20.0, scale=0.1),
                                dict(causal=False), dict(d=16, h_kv=1)]
                         + _EDGE_KW + [_GQA7_KW],
                         ids=['causal', 'window', 'segments',
                              'softcap_scale', 'non_causal', 'd16_hkv1']
                         + _EDGE_IDS + ['gqa7_h28_hkv4_d128'])
def test_flash_backward_kernels_match_plain(card, dtype, kw):
    """dq (K3) and dk/dv (K2) against the plain backward on the same
    forward output and LSE; S=200 is ragged against the 64-row tiles."""
    (q, k, v, dout), seg, opts = _flash_inputs(card, dtype, kw,
                                               with_dout=True)
    out, lse = flash_attention._flash_fwd(q, k, v, seg, **opts)
    got = flash_attention._flash_bwd(q, k, v, seg, out, dout, lse, **opts)
    want = flash_attention.flash_attention_bwd_plain(
        q, k, v, out, dout, lse, **_plain_opts(seg, opts))
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert_blocks_close(g, w, dtype, name)


# Head dim 256 (every Gemma): the forward's wgmma kernel with 64-key
# tiles in a two-stage ring (bf16) and the FMA kernel (fp32), at the tile
# edges, GQA groups 1, 2 and 8 (Gemma-7B, Gemma2-9B, Gemma-2B) and
# Gemma-2's options: a window, softcap 50, scale 1/16.
_D256_KW = [dict(s=127, h=8, h_kv=8, d=256), dict(s=129, h=8, h_kv=4, d=256),
            dict(s=1000, h=8, h_kv=1, d=256, window=100),
            dict(s=300, h=8, h_kv=4, d=256, softcap=50.0, scale=1 / 16,
                 window=64),
            dict(s=200, d=256, segments=True),
            dict(s=200, d=256, causal=False)]
_D256_IDS = ['s127_g1', 's129_g2', 's1000_g8_window', 's300_gemma2_opts',
             'segments', 'non_causal']


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kw', _D256_KW, ids=_D256_IDS)
def test_flash_kernel_matches_plain_at_head_dim_256(card, dtype, kw):
    (q, k, v), seg, opts = _flash_inputs(card, dtype, kw)
    out, lse = flash_attention._flash_fwd(q, k, v, seg, **opts)
    ref, ref_lse = flash_attention.flash_attention_plain(
        q, k, v, **_plain_opts(seg, opts))
    assert_out_close(out, lse, ref, ref_lse, dtype)


def test_flash_backward_refuses_head_dim_256_on_the_card(card):
    """K2/K3 take head dims up to 128 (ROADMAP.md queue 1, "Gemma
    training (K2/K3 at D 256)"): the wrappers raise before any launch,
    and so does autograd through the forward kernel."""
    (q, k, v, dout), seg, opts = _flash_inputs(card, torch.bfloat16,
                                               dict(d=256), with_dout=True)
    out, lse = flash_attention._flash_fwd(q, k, v, seg, **opts)
    before = [flash_attention.DKV_KERNEL.launches,
              flash_attention.DQ_KERNEL.launches]
    with pytest.raises(ValueError, match='K2/K3 at D 256'):
        flash_attention._flash_bwd(q, k, v, seg, out, dout, lse, **opts)
    q.requires_grad_(True)
    with pytest.raises(ValueError, match='K2/K3 at D 256'):
        flash_attention.flash_attention(q, k, v).sum().backward()
    assert [flash_attention.DKV_KERNEL.launches,
            flash_attention.DQ_KERNEL.launches] == before


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
        assert_blocks_close(g, w, dtype, name)
    bad_dk = dk.clone()
    bad_dk[:, s // 2:] *= 0.9
    bad_lse = lse.clone()
    bad_lse[:, :, 1536:1600] += 0.1
    bad_dq = flash_attention._flash_bwd_dq(q, k, v, None, out, dout, bad_lse)
    for name, g, w in (('dk', bad_dk, want[1]), ('dq', bad_dq, want[0])):
        with pytest.raises(AssertionError):
            assert_blocks_close(g, w, dtype, name)


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
    for name, got, want in zip(('out', 'dq', 'dk', 'dv'), grads['cuda'],
                               grads['cpu']):
        assert_blocks_close(got.cpu(), want, torch.float32, name)


def test_flash_kernels_repeat_bit_for_bit_in_fp32(card):
    """The fp32 kernels (the autograd test's shapes: D32, S130, window
    50) give the same bits on the same inputs 200 times over, wherever
    the allocator places their tensors (a spacer of another size before
    each run), and the first run agrees with the CPU. A race in the FMA
    kernels, or a stray write into a neighbouring tensor, would show."""
    b, s, h, h_kv, d = 1, 130, 4, 2, 32
    q, dout = (torch.randn((b, s, h, d), generator=card, device='cuda')
               for _ in range(2))
    k, v = (torch.randn((b, s, h_kv, d), generator=card, device='cuda')
            for _ in range(2))
    opts = dict(window=50)

    def run():
        out, lse = flash_attention._flash_fwd(q, k, v, None, **opts)
        return (out, lse) + flash_attention._flash_bwd(
            q, k, v, None, out, dout, lse, **opts)

    first = [t.clone() for t in run()]
    for i in range(200):
        spacer = torch.empty(1 + 4099 * (i % 7), device='cuda')
        again = run()
        for name, a, b_ in zip(('out', 'lse', 'dq', 'dk', 'dv'), first,
                               again):
            assert torch.equal(a, b_), f'run {i + 1}: {name} changed'
        del spacer, again
    cpu = [t.cpu() for t in (q, k, v, dout)]
    ref, ref_lse = flash_attention.flash_attention_plain(*cpu[:3], **opts)
    assert_out_close(first[0].cpu(), first[1].cpu(), ref, ref_lse,
                     torch.float32)


@pytest.mark.parametrize('kernel', ['dkv', 'dq'])
def test_flash_dkv_kernel_is_deterministic(card, kernel):
    """Neither backward kernel has atomics: K2 sums each GQA group in
    registers and writes once, K3 owns its query rows' dQ. Two runs on the
    same inputs give the same bits, each alone and inside one backward
    (where the two share the row pre-pass's scratch)."""
    b, s, h, h_kv, d = 2, 1000, 8, 2, 128
    dtype = torch.bfloat16
    q, dout = (_randn(card, (b, s, h, d), dtype) for _ in range(2))
    k, v = (_randn(card, (b, s, h_kv, d), dtype) for _ in range(2))
    out, lse = flash_attention._flash_fwd(q, k, v)
    launch = {'dkv': flash_attention._flash_bwd_dkv,
              'dq': flash_attention._flash_bwd_dq}[kernel]
    args = (q, k, v, None, out, dout, lse)
    first, second = launch(*args), launch(*args)
    if kernel == 'dq':
        first, second = (first,), (second,)
    together = flash_attention._flash_bwd(*args)
    together = together[1:] if kernel == 'dkv' else together[:1]
    for a, b_, c in zip(first, second, together):
        assert torch.equal(a, b_)
        assert torch.equal(a, c)


def test_flash_kernels_at_the_training_length(card):
    """B1 S8192 H16/8 D128 bf16 (the training path's length and
    widths): K1 against the plain forward, K2 and K3 against the plain
    backward."""
    b, s, h, h_kv, d = 1, 8192, 16, 8, 128
    dtype = torch.bfloat16
    q, dout = (_randn(card, (b, s, h, d), dtype) for _ in range(2))
    k, v = (_randn(card, (b, s, h_kv, d), dtype) for _ in range(2))
    out, lse = flash_attention._flash_fwd(q, k, v)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v)
    assert_out_close(out, lse, ref, ref_lse, dtype)
    # A fault on the V side (wrong V panel or ring stage, bad rescale)
    # confined to the later rows, where the output is smallest: 10 % low
    # past the middle passes the elementwise tolerance and fails the
    # blockwise one.
    bad = out.clone()
    bad[:, s // 2:] *= 0.9
    torch.testing.assert_close(bad.float(), ref.float(), **TOL[dtype])
    with pytest.raises(AssertionError):
        assert_blocks_close(bad, ref, dtype, 'out')
    del ref, ref_lse, bad
    got = flash_attention._flash_bwd(q, k, v, None, out, dout, lse)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, out, dout, lse)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert_blocks_close(g, w, dtype, name)


@pytest.mark.parametrize('dtype, d, want', [
    (torch.bfloat16, 128, 2 * 3 * 4 * 256),
    (torch.bfloat16, 64, 2 * 3 * 4 * 256),
    (torch.bfloat16, 32, None),
    (torch.float32, 128, None)])
def test_dkv_scratch_only_where_the_wgmma_kernel_runs(card, dtype, d, want):
    """The backward pre-pass's scratch (shared by dK/dV and dQ), sized by
    the kernels' library: LSE and delta per query row, S padded to the
    64-row query tile (200 -> 256); none for fp32 or the mma.sync head
    dims."""
    q = torch.zeros(3, 200, 4, d, dtype=dtype, device='cuda')
    got = flash_attention.bwd_scratch(q)
    if want is None:
        assert got is None
    else:
        assert got.numel() == want and got.dtype == torch.float32


# Slot lengths of the decode tests over a 300-row cache: ragged ones, and
# the split-KV walk's edges (splits of SPLIT_ROWS = 128 rows: one split,
# one split +- 1, two splits +- 1, max_len and past it).
DECODE_LENGTHS = {'ragged': [0, 1, 63, 64, 300, 400],
                  'split edges': [127, 128, 129, 255, 256, 257],
                  'split edges, max_len': [0, 300, 301, 1, 130, 299]}


@pytest.mark.parametrize('kv', ['bf16', 'fp32', 'int8'])
@pytest.mark.parametrize('window', [None, 50])
@pytest.mark.parametrize('lengths', list(DECODE_LENGTHS))
def test_decode_kernel_matches_plain(card, kv, window, lengths):
    """K4 against the plain version; under window=50 the split-edge
    lengths start their window inside a split."""
    b, max_len, h, h_kv, d = 6, 300, 8, 2, 128
    q = _randn(card, (b, 1, h, d), torch.bfloat16)
    k = _randn(card, (b, max_len, h_kv, d), torch.float32)
    v = _randn(card, (b, max_len, h_kv, d), torch.float32)
    if kv == 'int8':
        k, v = llama.quantize_kv(k), llama.quantize_kv(v)
    else:
        dtype = torch.bfloat16 if kv == 'bf16' else torch.float32
        k, v = k.to(dtype), v.to(dtype)
    lengths = torch.tensor(DECODE_LENGTHS[lengths], dtype=torch.int32,
                           device='cuda')
    out = decode_attention.decode_attention(q, k, v, lengths, window=window)
    ref = decode_attention.decode_attention_plain(q, k, v, lengths,
                                                  window=window)
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])
    # Per (slot, head) against the output's own size: a lost split would
    # hide inside the absolute tolerance.
    assert_blocks_close(out, ref, torch.bfloat16, 'decode out')


@pytest.mark.parametrize('kv', ['bf16', 'fp32', 'int8'])
def test_decode_kernel_matches_plain_at_gqa_group_7(card, kv):
    """K4 at Qwen2-7B's heads (28 over 4 KV heads: the walk for groups of
    up to 8 with one idle head) over 16 slots of a 2048-row cache, ragged
    lengths around 1000 and an empty slot."""
    b, max_len, h, h_kv, d = 16, 2048, 28, 4, 128
    q = _randn(card, (b, 1, h, d), torch.bfloat16)
    k = _randn(card, (b, max_len, h_kv, d), torch.float32)
    v = _randn(card, (b, max_len, h_kv, d), torch.float32)
    if kv == 'int8':
        k, v = llama.quantize_kv(k), llama.quantize_kv(v)
    else:
        dtype = torch.bfloat16 if kv == 'bf16' else torch.float32
        k, v = k.to(dtype), v.to(dtype)
    lengths = torch.tensor([0] + [990 + 5 * i for i in range(b - 1)],
                           dtype=torch.int32, device='cuda')
    out = decode_attention.decode_attention(q, k, v, lengths)
    ref = decode_attention.decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])
    assert_blocks_close(out, ref, torch.bfloat16, 'decode out')


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


@pytest.mark.parametrize('kv', ['bf16', 'fp32', 'int8'])
@pytest.mark.parametrize('h,h_kv', [(16, 16), (16, 8), (8, 1)],
                         ids=['g1', 'g2', 'g8'])
def test_decode_kernel_matches_plain_at_head_dim_256(card, kv, h, h_kv):
    """K4 at D 256 (each thread of the P·V pass owns 8 of 256 columns, in
    4 row subsets; the combine writes two columns a thread) with Gemma-2's
    options (window 64, softcap 50, scale 1/16) over 6 slots of a 300-row
    cache: ragged lengths, split edges and an empty slot; GQA groups 1, 2
    and 8 (Gemma-7B, Gemma2-9B, Gemma-2B)."""
    b, max_len, d = 6, 300, 256
    q = _randn(card, (b, 1, h, d), torch.bfloat16)
    k = _randn(card, (b, max_len, h_kv, d), torch.float32)
    v = _randn(card, (b, max_len, h_kv, d), torch.float32)
    if kv == 'int8':
        k, v = llama.quantize_kv(k), llama.quantize_kv(v)
    else:
        dtype = torch.bfloat16 if kv == 'bf16' else torch.float32
        k, v = k.to(dtype), v.to(dtype)
    lengths = torch.tensor([0, 1, 127, 129, 257, 300], dtype=torch.int32,
                           device='cuda')
    for kw in (dict(), dict(window=64, logit_softcap=50.0, scale=1 / 16)):
        out = decode_attention.decode_attention(q, k, v, lengths, **kw)
        ref = decode_attention.decode_attention_plain(q, k, v, lengths,
                                                      **kw)
        torch.testing.assert_close(out.float(), ref.float(),
                                   **TOL[torch.bfloat16])
        assert_blocks_close(out, ref, torch.bfloat16, 'decode out')


def _paged_case(gen, dtype, b, num_pages, page, nblk, h, h_kv, d, lengths,
                allocated=None, q_dtype=None):
    """q, arenas, lengths and a block table drawn as a random permutation
    of pages (no slot's pages are contiguous), sentinel (== num_pages)
    past each slot's allocation (by default what its length needs)."""
    q = _randn(gen, (b, 1, h, d), q_dtype or dtype)
    k = _randn(gen, (num_pages, page, h_kv, d), dtype)
    v = _randn(gen, (num_pages, page, h_kv, d), dtype)
    perm = torch.randperm(num_pages, generator=gen, device='cuda')[
        :b * nblk].reshape(b, nblk).to(torch.int32)
    blocks = torch.tensor([-(-min(n, nblk * page) // page) for n in
                           (lengths if allocated is None else allocated)],
                          device='cuda')
    held = torch.arange(nblk, device='cuda')[None, :] < blocks[:, None]
    tables = torch.where(held, perm, num_pages).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    return q, k, v, lens, tables


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('page, d, h, h_kv', [(8, 16, 4, 2), (16, 128, 32, 8),
                                              (64, 64, 8, 8),
                                              (256, 32, 8, 1),
                                              (16, 256, 16, 8)])
def test_paged_decode_kernel_matches_plain(card, dtype, page, d, h, h_kv):
    """K5 over a permuted table: ragged lengths, a length-0 slot with and
    without an allocated first block, an inactive slot (length past the
    table, all-sentinel row), softcap + scale."""
    nblk = 5
    cap = nblk * page
    lengths = [1, page, page + 1, 0, 0, cap + 1, cap, cap - 3]
    allocated = [1, page, page + 1, page, 0, 0, cap, cap - 3]
    q, k, v, lens, tables = _paged_case(card, dtype, 8, 40, page, nblk, h,
                                        h_kv, d, lengths, allocated)
    for kw in (dict(), dict(logit_softcap=20.0, scale=0.1)):
        out = decode_attention.paged_decode_attention(q, k, v, lens, tables,
                                                      **kw)
        ref = decode_attention.paged_decode_attention_plain(q, k, v, lens,
                                                            tables, **kw)
        torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    # The length-0 slots: the mean of the `page` V rows of their first
    # clamped page.
    for slot in (3, 4):
        first = int(tables[slot, 0].clamp(0, k.shape[0] - 1))
        mean = v[first].float().mean(dim=0).repeat_interleave(h // h_kv,
                                                              dim=0)
        torch.testing.assert_close(out[slot, 0].float(), mean, **TOL[dtype])


def test_paged_decode_kernel_equals_dense_kernel_on_an_identity_table(card):
    """On a contiguous identity table the paged kernel walks the same rows
    in the same order as the dense kernel (one shared row walk), so the
    two outputs are equal bit for bit, for live slots (a length-0 slot
    averages 256 rows in the dense kernel and one page in the paged)."""
    b, page, nblk, h, h_kv, d = 4, 16, 8, 8, 2, 128
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn(card, (b, 1, h, d), dtype)
        k = _randn(card, (b, nblk * page, h_kv, d), dtype)
        v = _randn(card, (b, nblk * page, h_kv, d), dtype)
        lens = torch.tensor([1, 17, 128, 77], dtype=torch.int32,
                            device='cuda')
        tables = torch.arange(b * nblk, dtype=torch.int32,
                              device='cuda').reshape(b, nblk)
        dense = decode_attention.decode_attention(q, k, v, lens)
        paged = decode_attention.paged_decode_attention(
            q, k.reshape(b * nblk, page, h_kv, d),
            v.reshape(b * nblk, page, h_kv, d), lens, tables)
        assert torch.equal(dense, paged)


def test_paged_decode_kernel_long_table_and_mixed_types(card):
    """A table row too long for the default shared-memory limit (8192
    blocks of 8 rows: 32 KB) and fp32 queries over a bf16 arena."""
    page, nblk = 8, 8192
    lengths = [nblk * page, 12345, 3]
    q, k, v, lens, tables = _paged_case(
        card, torch.bfloat16, 3, 3 * nblk, page, nblk, 4, 2, 64, lengths,
        q_dtype=torch.float32)
    out = decode_attention.paged_decode_attention(q, k, v, lens, tables)
    ref = decode_attention.paged_decode_attention_plain(q, k, v, lens,
                                                        tables)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, **TOL[torch.float32])


def test_paged_decode_wrapper_names_its_limits(card):
    q, k, v, lens, tables = _paged_case(card, torch.bfloat16, 2, 8, 8, 2, 4,
                                        2, 16, [3, 9])
    launch = decode_attention.paged_decode_attention
    with pytest.raises(ValueError, match='page sizes'):
        launch(q, k.reshape(16, 4, 2, 16), v.reshape(16, 4, 2, 16), lens,
               tables)
    with pytest.raises(ValueError, match='int32'):
        launch(q, k, v, lens, tables.long())
    with pytest.raises(ValueError, match='contiguous'):
        launch(q, k, v, lens, tables.t().contiguous().t())
    with pytest.raises(ValueError, match='head_dim'):
        launch(q[..., :8].contiguous(), k[..., :8].contiguous(),
               v[..., :8].contiguous(), lens, tables)
    with pytest.raises(ValueError, match='int8 KV'):
        launch(q, (k, k), (v, v), lens, tables)
    with pytest.raises(ValueError, match='sliding_window'):
        launch(q, k, v, lens, tables, window=4)


def test_paged_engine_tokens_on_the_card_match_the_cpu(card):
    """Paged + chunked + prefix-cached serving of a small fp32 model: the
    card (kernels) and the CPU (plain versions) give the same greedy
    tokens."""
    import dataclasses

    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(3)
    cpu_params = llama.init(cfg, gen, device='cpu')
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (50, 20, 31, 7)]
    prompts.append(prompts[0][:40] + [5, 4, 3])
    outputs = {}
    for device in ('cuda', 'cpu'):
        params = {k: (v.to(device) if torch.is_tensor(v) else
                      {kk: vv.to(device) for kk, vv in v.items()})
                  for k, v in cpu_params.items()}
        engine = engine_lib.InferenceEngine(engine_lib.EngineConfig(
            model=cfg, max_slots=4, max_target_len=64,
            prefill_buckets=(16, 32), kv_dtype=torch.float32,
            kv_page_size=16, kv_num_pages=8, prefix_cache_entries=4),
            params, device=device)
        outputs[device] = orch_lib.Orchestrator(
            engine, decode_steps=4).generate(prompts, max_new_tokens=8)
        assert engine.prefix_cache_stats['hits'] >= 1
    assert outputs['cuda'] == outputs['cpu']


# ---- the absorbed-MLA decode kernels (K6 dense, K7 paged) ----

# (heads, r, dr): DEEPSEEK_TINY's (fewer than 16 heads and a width that is
# not a multiple of 16 pad the tensor-core tiles), DeepSeek-V2-Lite's, and
# the widest row the kernels take (r + dr = 1024: the bf16 walk's ring
# then holds one stage of 32 rows).
MLA_SHAPES = {'tiny': (4, 32, 8), 'v2_lite': (16, 512, 64),
              'widest': (16, 512, 512)}


def _mla_queries(gen, b, h, r, dr):
    return (_randn(gen, (b, h, r), torch.float32),
            _randn(gen, (b, h, dr), torch.float32))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', sorted(MLA_SHAPES))
def test_mla_decode_kernel_matches_plain(card, dtype, shape):
    """K6 vs its plain version (both fp32 math: TOL fp32 for either cache
    type): ragged lengths around the 32- and 64-row tiles and the 192-row
    splits, a length-0 slot (the mean of its first min(256, K) rows), an
    inactive slot (length past the cache); K = 300 ends in a partial
    split."""
    h, r, dr = MLA_SHAPES[shape]
    max_len = 300
    lengths = [0, 1, 31, 32, 33, 127, 128, 129, 255, 256, 257, max_len,
               max_len + 1, 63, 64, 65, 191, 192, 193]
    b = len(lengths)
    q_eff, q_rope = _mla_queries(card, b, h, r, dr)
    ckv = _randn(card, (b, max_len, r), dtype)
    krope = _randn(card, (b, max_len, dr), dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    out = mla_decode.mla_decode_attention(q_eff, q_rope, ckv, krope, lens,
                                          0.07)
    ref = mla_decode.mla_decode_attention_plain(q_eff, q_rope, ckv, krope,
                                                lens, 0.07)
    assert out.dtype == torch.float32 and out.shape == (b, h, r)
    torch.testing.assert_close(out, ref, **TOL[torch.float32])
    mean = ckv[0, :256].float().mean(dim=0).expand(h, r)
    torch.testing.assert_close(out[0], mean, **TOL[torch.float32])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('page', [1, 8, 16, 256])
def test_paged_mla_decode_kernel_matches_plain(card, dtype, page):
    """K7 over per-slot random page permutations with sentinel tails: a
    length-0 slot with and without an allocated first block (the mean of
    that page), an inactive slot (length past the table, all-sentinel
    row), lengths across pages and splits."""
    h, r, dr = MLA_SHAPES['v2_lite']
    nblk = max(2, 640 // page)
    cap = nblk * page
    lengths = [1, page, page + 1, 0, 0, cap + 1, cap, 129, cap - 3]
    allocated = [1, page, page + 1, page, 0, 0, cap, 129, cap - 3]
    b, num_pages = len(lengths), 3 * nblk
    q_eff, q_rope = _mla_queries(card, b, h, r, dr)
    ckv = _randn(card, (num_pages, page, r), dtype)
    krope = _randn(card, (num_pages, page, dr), dtype)
    perm = torch.stack([torch.randperm(num_pages, generator=card,
                                       device='cuda')[:nblk]
                        for _ in range(b)])
    blocks = torch.tensor([-(-n // page) for n in allocated], device='cuda')
    held = torch.arange(nblk, device='cuda')[None, :] < blocks[:, None]
    tables = torch.where(held, perm, num_pages).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    out = mla_decode.paged_mla_decode_attention(q_eff, q_rope, ckv, krope,
                                                lens, tables, 0.07)
    ref = mla_decode.paged_mla_decode_attention_plain(
        q_eff, q_rope, ckv, krope, lens, tables, 0.07)
    torch.testing.assert_close(out, ref, **TOL[torch.float32])
    for slot in (3, 4):
        first = int(tables[slot, 0].clamp(0, num_pages - 1))
        mean = ckv[first].float().mean(dim=0).expand(h, r)
        torch.testing.assert_close(out[slot], mean, **TOL[torch.float32])


def test_paged_mla_kernel_equals_dense_kernel_on_an_identity_table(card):
    """On a contiguous identity table K7 walks the same rows in the same
    order as K6 (one shared split walk), so live slots agree bit for
    bit."""
    h, r, dr = MLA_SHAPES['v2_lite']
    b, page, nblk = 5, 16, 20
    for dtype in (torch.float32, torch.bfloat16):
        q_eff, q_rope = _mla_queries(card, b, h, r, dr)
        ckv = _randn(card, (b, nblk * page, r), dtype)
        krope = _randn(card, (b, nblk * page, dr), dtype)
        lens = torch.tensor([1, 17, 128, 200, 320], dtype=torch.int32,
                            device='cuda')
        tables = torch.arange(b * nblk, dtype=torch.int32,
                              device='cuda').reshape(b, nblk)
        dense = mla_decode.mla_decode_attention(q_eff, q_rope, ckv, krope,
                                                lens, 0.07)
        paged = mla_decode.paged_mla_decode_attention(
            q_eff, q_rope, ckv.reshape(-1, page, r),
            krope.reshape(-1, page, dr), lens, tables, 0.07)
        assert torch.equal(dense, paged)


@pytest.mark.parametrize('shape', ['tiny', 'widest'])
def test_paged_mla_decode_kernel_pads_heads_and_widths(card, shape):
    """K7 over a bf16 arena at the padded shapes (4 heads of a 16-head
    tile, r + dr = 40 of 48 columns; and r + dr = 1024), pages of 8."""
    h, r, dr = MLA_SHAPES[shape]
    page, nblk, num_pages = 8, 40, 100
    lengths = [0, 1, 9, 129, 300, nblk * page]
    b = len(lengths)
    q_eff, q_rope = _mla_queries(card, b, h, r, dr)
    ckv = _randn(card, (num_pages, page, r), torch.bfloat16)
    krope = _randn(card, (num_pages, page, dr), torch.bfloat16)
    tables = torch.stack([torch.randperm(num_pages, generator=card,
                                         device='cuda')[:nblk]
                          for _ in range(b)]).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    out = mla_decode.paged_mla_decode_attention(q_eff, q_rope, ckv, krope,
                                                lens, tables, 0.07)
    ref = mla_decode.paged_mla_decode_attention_plain(
        q_eff, q_rope, ckv, krope, lens, tables, 0.07)
    torch.testing.assert_close(out, ref, **TOL[torch.float32])


def _mla_long_case(gen, dtype, b=6, page=16, nblk=128):
    """V2-Lite widths, a contiguous identity table over a [b, nblk*page]
    cache, lengths over 8 to 11 splits of 192 rows (and one short)."""
    h, r, dr = MLA_SHAPES['v2_lite']
    q_eff, q_rope = _mla_queries(gen, b, h, r, dr)
    ckv = _randn(gen, (b, nblk * page, r), dtype)
    krope = _randn(gen, (b, nblk * page, dr), dtype)
    lens = torch.tensor([1537, 1700, 2048, 1900, 1601, 77][:b],
                        dtype=torch.int32, device='cuda')
    tables = torch.arange(b * nblk, dtype=torch.int32,
                          device='cuda').reshape(b, nblk)
    paged = (q_eff, q_rope, ckv.reshape(-1, page, r),
             krope.reshape(-1, page, dr), lens, tables)
    return (q_eff, q_rope, ckv, krope, lens), paged


def test_mla_kernels_repeat_bit_for_bit(card):
    """The combine merges a slot's splits in split order, whichever split
    ended last: two calls on the same bf16 inputs give the same bits, K6
    and K7 alike."""
    dense, paged = _mla_long_case(card, torch.bfloat16)
    first = mla_decode.mla_decode_attention(*dense, 0.07)
    again = mla_decode.mla_decode_attention(*dense, 0.07)
    assert torch.equal(first, again)
    first = mla_decode.paged_mla_decode_attention(*paged, 0.07)
    again = mla_decode.paged_mla_decode_attention(*paged, 0.07)
    assert torch.equal(first, again)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_paged_mla_kernel_equals_dense_kernel_over_many_splits(card, dtype):
    """K7 on an identity table equals K6 bit for bit at lengths of 8 to
    11 splits, and both agree with the plain version."""
    dense, paged = _mla_long_case(card, dtype)
    want = mla_decode.mla_decode_attention(*dense, 0.07)
    got = mla_decode.paged_mla_decode_attention(*paged, 0.07)
    assert torch.equal(want, got)
    torch.testing.assert_close(
        want, mla_decode.mla_decode_attention_plain(*dense, 0.07),
        **TOL[torch.float32])


def test_mla_wrappers_name_their_limits(card):
    q_eff, q_rope = _mla_queries(card, 2, 4, 32, 8)
    ckv = _randn(card, (2, 64, 32), torch.bfloat16)
    krope = _randn(card, (2, 64, 8), torch.bfloat16)
    lens = torch.tensor([3, 9], dtype=torch.int32, device='cuda')
    launch = mla_decode.mla_decode_attention
    with pytest.raises(ValueError, match='fp32'):
        launch(q_eff.bfloat16(), q_rope, ckv, krope, lens, 0.1)
    with pytest.raises(ValueError, match='heads'):
        launch(q_eff.repeat(1, 5, 1), q_rope.repeat(1, 5, 1), ckv, krope,
               lens, 0.1)
    with pytest.raises(ValueError, match='int32'):
        launch(q_eff, q_rope, ckv, krope, lens.long(), 0.1)
    with pytest.raises(ValueError, match='same for both'):
        launch(q_eff, q_rope, ckv, krope.float(), lens, 0.1)
    tables = torch.zeros((2, 8), dtype=torch.int32, device='cuda')
    with pytest.raises(ValueError, match='page sizes'):
        mla_decode.paged_mla_decode_attention(
            q_eff, q_rope, ckv.reshape(4, 32, 32)[:, :24].contiguous(),
            krope.reshape(4, 32, 8)[:, :24].contiguous(), lens, tables, 0.1)


@pytest.mark.parametrize('paged', [False, True], ids=['dense', 'paged'])
def test_deepseek_engine_tokens_on_the_card_match_the_cpu(card, paged):
    """Small fp32 DeepSeek served on the card (K6 or K7) and on the CPU
    (plain versions), with a 3-prompt wave that pads to 4 rows: the same
    greedy tokens, and the path's kernel ran."""
    import dataclasses

    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import deepseek
    cfg = dataclasses.replace(deepseek.DEEPSEEK_TINY, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(4)
    cpu_params = deepseek.init(cfg, gen, device='cpu')
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (9, 16, 5)]
    kernel = mla_decode.PAGED_KERNEL if paged else mla_decode.KERNEL
    outputs = {}
    for device in ('cuda', 'cpu'):
        params = {k: (v.to(device) if torch.is_tensor(v) else
                      {kk: vv.to(device) for kk, vv in v.items()})
                  for k, v in cpu_params.items()}
        engine = engine_lib.InferenceEngine(engine_lib.EngineConfig(
            model=cfg, max_slots=4, max_target_len=64,
            prefill_buckets=(16,), kv_dtype=torch.float32,
            kv_page_size=8 if paged else 0), params, device=device)
        before = kernel.launches
        outputs[device] = orch_lib.Orchestrator(
            engine, decode_steps=4).generate(prompts, max_new_tokens=8)
        if device == 'cuda':
            assert kernel.launches > before
    assert outputs['cuda'] == outputs['cpu']


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_quantization_on_the_card_gives_the_cpu_bytes(card, dtype):
    """The server quantizes on the card: int8 and int4 values and fp32
    scales equal the CPU's (which tests/test_torch_quantization.py holds
    equal to JAX's) bit for bit, for per-channel and per-row axes."""
    from skypilot_tpu_torch.ops import quantization as qops
    w = _randn(card, (3, 512, 384), dtype)
    for got, want in ((qops.quantize(w), qops.quantize(w.cpu())),
                      (qops.quantize(w, -1), qops.quantize(w.cpu(), -1)),
                      (qops.quantize4(w), qops.quantize4(w.cpu()))):
        values = 'q_packed' if hasattr(got, 'q_packed') else 'q'
        assert torch.equal(getattr(got, values).cpu(), getattr(want, values))
        assert torch.equal(got.scale.cpu(), want.scale)
