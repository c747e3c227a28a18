#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: require CUDA, print the card's name and power limit, turn
     TF32 off for fp32 products;
  2. build: compile every kernel source in skypilot_tpu_torch/csrc/ (one
     nvcc per source, all at once) and print the build seconds;
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main paths' shapes and in the window / segment /
     softcap / int8 / ragged-length cases, in bf16 and fp32, with each
     error beside its tolerance (gradients blockwise, and two planted
     gradient faults must be rejected); kernel, plain and library times
     and the least time the card could take (bound): the flash forward,
     the flash backward pair (dK/dV, dQ), dense decode, paged decode, and
     the absorbed-MLA decode pair (dense K6, paged K7: ragged lengths,
     length 0, inactive slots, sentinel tables, and K7 bit for bit equal
     to K6 on an identity table);
  4. serving main path: Llama-3-8B (bf16, random weights from a seeded
     torch.Generator) served by InferenceEngine + Orchestrator: 16
     prompts of ~1000 tokens, 64 new tokens each;
  5. small serving end to end: an fp32 model at LLAMA_TINY widths with
     prefill bucket 1024 (so the flash kernel runs) served on the card and
     on the CPU (plain versions); the greedy tokens must be identical;
  6. training main path: Llama-3-1B (LLAMA3_1B, all 16 layers, bf16,
     random weights) trained by Trainer through measure_throughput at
     seq 8192, global batch 4, remat 'qkvo_gup', adafactor: 2 warm-up
     and 5 measured steps on one repeated batch; the loss must be finite
     and fall;
  7. small training check: LLAMA_TINY widths in fp32 at seq 1024 with EOS
     packing, adamw, accum_steps=2: three steps on the card (kernels) and
     on the CPU (plain versions) must agree;
  8. paged serving main path: the same Llama-3-8B served from a shared
     page arena (32 slots over 2048 pages of 16 rows: the memory that gives
     phase 4 its 16 dense slots): (a) 32 prompts of ~1000 tokens, 64 new
     tokens each, more than the arena holds at once, so some requests are
     deferred and admitted later; (b) a second engine with the prefix
     cache on: two 3000-token prompts prefilled in three chunks each
     between decode ticks, and four prompts sharing their first 768 tokens;
  9. small paged end to end: fp32 LLAMA_TINY widths, paged + chunked +
     prefix cache, on the card and on the CPU; the greedy tokens must be
     identical;
 10. DeepSeek serving main path: DeepSeek-V2-Lite (all 27 layers, public
     widths, bf16, random weights) from a dense slot cache, the traffic
     of phase 4 (16 prompts of ~1000 tokens, 64 new tokens each): K6 in
     every layer of every decode step, no other kernel (prefill attention
     is the plain path: qk dim 192 differs from v dim 128);
 11. DeepSeek paged main path: the same model and weights over 2048 pages
     of 16 rows, the traffic of phase 8(a), with deferral: K7 only;
 12. small DeepSeek end to end: fp32 DEEPSEEK_TINY widths, a dense and a
     paged engine, a wave padded to 4 rows, on the card and on the CPU;
     the greedy tokens must be identical.
Before each main path (4, 6, 8a, 8b, 10, 11) every kernel's launch count is
set to 0; just after, the kernels of that path must each have run, and no
other.

The second-to-last lines are the kernels' JSON record and the
`nvidia-smi` name/power-limit line; the last line is
{"ok": true, "device": {...}}. Nothing of JAX is imported.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from skypilot_tpu_torch.ops import decode_attention as decode_ops  # noqa: E402
from skypilot_tpu_torch.ops import flash_attention as flash_ops  # noqa: E402
from skypilot_tpu_torch.ops import kernels  # noqa: E402
from skypilot_tpu_torch.ops import mla_decode as mla_ops  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core
# and fp32 non-tensor-core rates, and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# Tolerances, kernel vs plain version on the same inputs. fp32: both
# compute in fp32 and differ by summation order only. bf16: the plain
# versions compute in fp32 and round the output once; the flash kernel
# also rounds P to bf16 before P·V (as the Pallas kernel does), so
# outputs may differ by one or two bf16 ulps (2^-8 relative each).
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RTOL = {torch.float32: 0.0, torch.bfloat16: 1e-2}
LSE_ATOL = 1e-3
# Gradients, backward kernels vs the plain backward, judged in each block
# of 64 rows of one head against the reference's own size there
# (flash_ops.gradient_errors): attention gradients shrink along the
# sequence, so one absolute tolerance would pass a wrong later block.
# Limits on the blockwise relative error ||got-want||/||want|| and on the
# largest element error over the block's RMS. fp32 sums over up to S rows
# in another order. bf16 also rounds P and dS to bf16 before their
# products (as the Pallas kernels do) and the gradient on the way out.
# Over the cases below, on an H100, the kernels read at most 3.7e-3 and
# 7.0e-2 in bf16, 9.4e-7 and 2.9e-5 in fp32; a 10 % error confined to
# some blocks reads 0.1 and above (the planted faults below).
GRAD_NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
GRAD_ELEM_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.15}

REPLACES = {
    'flash_fwd': 'skypilot_tpu/ops/flash_attention.py:64',
    'flash_bwd_dkv': 'skypilot_tpu/ops/flash_attention.py:300',
    'flash_bwd_dq': 'skypilot_tpu/ops/flash_attention.py:360',
    'decode_attention': 'skypilot_tpu/ops/decode_attention.py:73',
    'paged_decode_attention': 'skypilot_tpu/ops/decode_attention.py:143',
    'mla_decode': 'skypilot_tpu/ops/mla_decode.py:41',
    'paged_mla_decode': 'skypilot_tpu/ops/mla_decode.py:149',
}
SERVE_KERNELS = ('flash_fwd', 'decode_attention')
PAGED_SERVE_KERNELS = ('flash_fwd', 'paged_decode_attention')
TRAIN_KERNELS = ('flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq')
DEEPSEEK_KERNELS = ('mla_decode',)
PAGED_DEEPSEEK_KERNELS = ('paged_mla_decode',)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over iters runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            dtype, atol=None, rtol=None) -> float:
    atol = ATOL[dtype] if atol is None else atol
    rtol = RTOL[dtype] if rtol is None else rtol
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    max_err = float(err.max())
    log(f'  {name}: max_abs_err={max_err:.3e} (tolerance atol={atol:g} '
        f'rtol={rtol:g})')
    if not torch.isfinite(got.float()).all() or bool(bad.any()):
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version (max_abs_err={max_err:.3e})')
    return max_err


def compare_grad(name: str, got: torch.Tensor, want: torch.Tensor,
                 dtype) -> float:
    """A gradient against the plain backward's, blockwise (see
    GRAD_NORM_TOL) → its largest absolute error."""
    norm_err, elem_err = flash_ops.gradient_errors(got, want)
    max_err = float((got.float() - want.float()).abs().max())
    log(f'  {name}: block rel err {norm_err:.3e} (limit '
        f'{GRAD_NORM_TOL[dtype]:g}), element err / block rms '
        f'{elem_err:.3e} (limit {GRAD_ELEM_TOL[dtype]:g}); mean |ref| '
        f'{float(want.float().abs().mean()):.3e}, max_abs_err '
        f'{max_err:.3e}')
    if not (norm_err <= GRAD_NORM_TOL[dtype]
            and elem_err <= GRAD_ELEM_TOL[dtype]):
        raise AssertionError(f'{name}: kernel disagrees with the plain '
                             f'backward (block rel err {norm_err:.3e}, '
                             f'element err {elem_err:.3e})')
    return max_err


def expect_rejected(name: str, got: torch.Tensor, want: torch.Tensor,
                    dtype) -> None:
    """A planted fault must fail compare_grad: the check can see it."""
    try:
        compare_grad(f'planted fault, {name}', got, want, dtype)
    except AssertionError:
        log('    rejected, as it must be')
        return
    raise AssertionError(f'the gradient check passed a planted fault: '
                         f'{name}')


def rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device='cuda').to(dtype)


# ---- phase 3: kernel checks ----

def segments_for(b, s):
    """Three packed documents per row, boundaries differing by row."""
    cuts = torch.tensor([[s // 3 + 7 * i, 2 * s // 3 - 5 * i]
                         for i in range(b)], device='cuda')
    pos = torch.arange(s, device='cuda')[None, :]
    return ((pos >= cuts[:, :1]).int() + (pos >= cuts[:, 1:]).int()
            ).to(torch.int32).contiguous()


def flash_case(gen, label, dtype, b, s, h, h_kv, d, causal=True,
               window=None, segments=False, softcap=None, scale=None):
    q = rand(gen, (b, s, h, d), dtype)
    k = rand(gen, (b, s, h_kv, d), dtype)
    v = rand(gen, (b, s, h_kv, d), dtype)
    seg = segments_for(b, s) if segments else None
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale_override=scale)
    out, lse = flash_ops._flash_fwd(q, k, v, seg, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_ops.flash_attention_plain(
        q, k, v, causal=causal, window=window, segment_ids=seg,
        logit_softcap=softcap, scale=scale)
    err = compare(f'flash {label} out', out, ref_out, dtype)
    compare(f'flash {label} lse', lse, ref_lse, torch.float32,
            atol=LSE_ATOL, rtol=0.0)
    return (q, k, v, seg, kw), err


def check_flash(gen) -> dict:
    log('[3] flash_fwd: kernel vs plain version')
    for dtype in (torch.bfloat16, torch.float32):
        name = 'bf16' if dtype == torch.bfloat16 else 'fp32'
        flash_case(gen, f'{name} B4 S1024 H32/8 D128 causal', dtype,
                   4, 1024, 32, 8, 128)
        flash_case(gen, f'{name} window=100 S300', dtype, 2, 300, 4, 2,
                   64, window=100)
        flash_case(gen, f'{name} segments S300', dtype, 2, 300, 4, 2, 64,
                   segments=True)
        flash_case(gen, f'{name} softcap=30 scale=0.1 S300', dtype, 2,
                   300, 4, 2, 64, softcap=30.0, scale=0.1)
        flash_case(gen, f'{name} non-causal S200 D32', dtype, 2, 200, 4,
                   1, 32, causal=False)
        flash_case(gen, f'{name} D16 S1024 (LLAMA_TINY widths)', dtype,
                   2, 1024, 4, 2, 16)
    # The main path's prefill wave: 16 prompts in one 1024 bucket.
    dtype = torch.bfloat16
    (q, k, v, _, kw), err = flash_case(
        gen, 'bf16 main-path B16 S1024 H32/8 D128', dtype,
        16, 1024, 32, 8, 128)
    b, s, h, d = q.shape
    ms = time_ms(lambda: flash_ops._flash_fwd(q, k, v, None, **kw))
    plain_ms = time_ms(lambda: flash_ops.flash_attention_plain(q, k, v),
                       iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    elem = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * elem + (
        b * h * s * 4)
    # Causal: each row attends to itself and the keys before it.
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)
    bound, bound_by = bound_ms(nbytes, flops, dtype)
    log(f'  flash main-path timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, SDPA (library) {library_ms:.4f} ms, bound '
        f'{bound:.4f} ms ({bound_by}); {flops / ms / 1e9:.2f} TFLOP/s')
    return {'name': 'flash_fwd', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
            'replaces': REPLACES['flash_fwd'], 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': bound_by, 'library_ms': library_ms}


def flash_bwd_case(gen, label, dtype, b, s, h, h_kv, d, causal=True,
                   window=None, segments=False, softcap=None, scale=None):
    """Both backward kernels vs the plain backward on one forward's
    output and LSE → (inputs, {kernel name: max error})."""
    q, dout = (rand(gen, (b, s, h, d), dtype) for _ in range(2))
    k, v = (rand(gen, (b, s, h_kv, d), dtype) for _ in range(2))
    seg = segments_for(b, s) if segments else None
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale_override=scale)
    out, lse = flash_ops._flash_fwd(q, k, v, seg, **kw)
    dq = flash_ops._flash_bwd_dq(q, k, v, seg, out, dout, lse, **kw)
    dk, dv = flash_ops._flash_bwd_dkv(q, k, v, seg, out, dout, lse, **kw)
    torch.cuda.synchronize()
    ref = flash_ops.flash_attention_bwd_plain(
        q, k, v, out, dout, lse, causal=causal, window=window,
        segment_ids=seg, logit_softcap=softcap, scale=scale)
    errs = {'flash_bwd_dq': compare_grad(f'bwd {label} dq', dq, ref[0],
                                         dtype)}
    errs['flash_bwd_dkv'] = max(
        compare_grad(f'bwd {label} dk', dk, ref[1], dtype),
        compare_grad(f'bwd {label} dv', dv, ref[2], dtype))
    return (q, k, v, seg, out, dout, lse, kw), errs


def check_flash_bwd(gen) -> dict:
    log('[3] flash backward (dK/dV, dQ): kernels vs plain version')
    for dtype in (torch.bfloat16, torch.float32):
        name = 'bf16' if dtype == torch.bfloat16 else 'fp32'
        flash_bwd_case(gen, f'{name} B2 S1024 H16/8 D128 causal', dtype,
                       2, 1024, 16, 8, 128)
        flash_bwd_case(gen, f'{name} window=100 S300', dtype, 2, 300, 4, 2,
                       64, window=100)
        flash_bwd_case(gen, f'{name} segments S300', dtype, 2, 300, 4, 2,
                       64, segments=True)
        flash_bwd_case(gen, f'{name} softcap=30 scale=0.1 S300', dtype, 2,
                       300, 4, 2, 64, softcap=30.0, scale=0.1)
        flash_bwd_case(gen, f'{name} non-causal S200 D32', dtype, 2, 200, 4,
                       1, 32, causal=False)
        flash_bwd_case(gen, f'{name} D16 S1024 (LLAMA_TINY widths)', dtype,
                       2, 1024, 4, 2, 16)
    # The training path's shape: B4 S8192 H16/8 D128 bf16, causal. The
    # plain backward holds several fp32 [B, H, S, S] tensors (17 GB each
    # at B4), so the comparison and its timing run on batch row 0 only.
    dtype = torch.bfloat16
    b, s, h, h_kv, d = 4, 8192, 16, 8, 128
    q, dout = (rand(gen, (b, s, h, d), dtype) for _ in range(2))
    k, v = (rand(gen, (b, s, h_kv, d), dtype) for _ in range(2))
    out, lse = flash_ops._flash_fwd(q, k, v, None)
    row0 = [t[:1].contiguous() for t in (q, k, v, out, dout, lse)]
    dq = flash_ops._flash_bwd_dq(q, k, v, None, out, dout, lse)
    dk, dv = flash_ops._flash_bwd_dkv(q, k, v, None, out, dout, lse)
    torch.cuda.synchronize()
    ref = flash_ops.flash_attention_bwd_plain(*row0)
    label = 'bf16 main-path B4 S8192 H16/8 D128 (row 0 vs plain)'
    errs = {'flash_bwd_dq': compare_grad(f'bwd {label} dq', dq[:1], ref[0],
                                         dtype),
            'flash_bwd_dkv': max(
                compare_grad(f'bwd {label} dk', dk[:1], ref[1], dtype),
                compare_grad(f'bwd {label} dv', dv[:1], ref[2], dtype))}
    # The check must see a fault confined to the later rows, where the
    # gradients are smallest: dK 10 % low past row 4096, and dQ from an
    # LSE 0.1 too high on one 64-row tile (P 10 % low there).
    bad_dk = dk[:1].clone()
    bad_dk[:, s // 2:] *= 0.9
    expect_rejected('dk x 0.9 past row 4096', bad_dk, ref[1], dtype)
    bad_lse = row0[5].clone()
    bad_lse[:, :, 6016:6080] += 0.1
    bad_dq = flash_ops._flash_bwd_dq(*row0[:3], None, *row0[3:5], bad_lse)
    expect_rejected('dq with the LSE + 0.1 on rows 6016-6079', bad_dq,
                    ref[0], dtype)
    del ref, bad_dk, bad_dq
    args = (q, k, v, None, out, dout, lse)
    ms = {'flash_bwd_dq': time_ms(lambda: flash_ops._flash_bwd_dq(*args),
                                  iters=5, warmup=1),
          'flash_bwd_dkv': time_ms(
              lambda: flash_ops._flash_bwd_dkv(*args), iters=5, warmup=1)}
    plain_b1_ms = time_ms(lambda: flash_ops.flash_attention_bwd_plain(
        *row0), iters=2, warmup=1)
    torch.cuda.empty_cache()
    # Yardstick only: PyTorch's fused attention backward (its flash or
    # memory-efficient backend, never the math one, which would hold the
    # S x S matrix), for dq, dk and dv together.
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dout_t, retain_graph=True), iters=5,
        warmup=1)
    del lib_out, qt, kt, vt
    elem = q.element_size()
    causal_pairs = s * (s + 1) / 2
    product = 2.0 * b * h * d * causal_pairs
    inputs = (2 * q.numel() + k.numel() + v.numel() + dout.numel()) * elem \
        + lse.numel() * 4
    work = {'flash_bwd_dkv': (inputs + (k.numel() + v.numel()) * elem,
                              4 * product),
            'flash_bwd_dq': (inputs + q.numel() * elem, 3 * product)}
    records = {}
    for name, (nbytes, flops) in work.items():
        bound, bound_by = bound_ms(nbytes, flops, dtype)
        log(f'  {name} main-path timing: kernel {ms[name]:.4f} ms, bound '
            f'{bound:.4f} ms ({bound_by}); '
            f'{flops / ms[name] / 1e9:.2f} TFLOP/s')
        records[name] = {
            'name': name, 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/flash_bwd.cu',
            'replaces': REPLACES[name], 'max_abs_err': errs[name],
            'ms': ms[name], 'plain_ms': plain_b1_ms,
            'plain_shape': 'B1 (dq, dk and dv together)',
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms,
            'library_call': 'backward of F.scaled_dot_product_attention('
                            'is_causal=True, enable_gqa=True): dq, dk, dv'}
    log(f'  plain backward at B1 (dq, dk, dv together) {plain_b1_ms:.4f} '
        f'ms; SDPA backward (library, B4) {library_ms:.4f} ms')
    return records


def decode_case(gen, label, q_dtype, kv_dtype, lengths, b=16, max_len=2048,
                h=32, h_kv=8, d=128, window=None, softcap=None,
                scale=None):
    from skypilot_tpu_torch.models import llama
    q = rand(gen, (b, 1, h, d), q_dtype)
    k = rand(gen, (b, max_len, h_kv, d), torch.float32)
    v = rand(gen, (b, max_len, h_kv, d), torch.float32)
    if kv_dtype == torch.int8:
        k, v = llama.quantize_kv(k), llama.quantize_kv(v)
    else:
        k, v = k.to(kv_dtype), v.to(kv_dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    kw = dict(window=window, logit_softcap=softcap, scale=scale)
    out = decode_ops.decode_attention(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    ref = decode_ops.decode_attention_plain(q, k, v, lens, **kw)
    err = compare(f'decode {label}', out, ref, q_dtype)
    empty = [i for i, n in enumerate(lengths) if n == 0]
    if empty:
        # The JAX kernel's answer for a length-0 slot: the mean of its
        # first min(256, max_len) V rows, dequantized.
        v_rows = v[0].float() * v[1] if kv_dtype == torch.int8 else v.float()
        mean = v_rows[empty, :min(decode_ops.EMPTY_SLOT_ROWS, max_len)].mean(
            dim=1).repeat_interleave(h // h_kv, dim=1)[:, None]
        compare(f'decode {label}, length-0 slots vs mean of first rows',
                out[empty], mean, q_dtype)
    return (q, k, v, lens, kw), err


def check_decode(gen) -> dict:
    log('[3] decode_attention: kernel vs plain version')
    ragged = [0, 1, 255, 256, 257, 2048, 2100, 7, 1000, 1500, 31, 64,
              513, 777, 1999, 128]
    bf16, fp32 = torch.bfloat16, torch.float32
    decode_case(gen, 'bf16 cache, ragged lengths', bf16, bf16, ragged)
    decode_case(gen, 'fp32 cache, ragged lengths', fp32, fp32, ragged)
    decode_case(gen, 'fp32 q over bf16 cache', fp32, bf16, ragged)
    decode_case(gen, 'int8 pair (bf16 q)', bf16, torch.int8, ragged)
    decode_case(gen, 'int8 pair (fp32 q)', fp32, torch.int8, ragged)
    decode_case(gen, 'bf16 window=300', bf16, bf16, ragged, window=300)
    decode_case(gen, 'bf16 softcap=30 scale=0.1', bf16, bf16, ragged,
                softcap=30.0, scale=0.1)
    decode_case(gen, 'fp32 D16 G2 (LLAMA_TINY widths)', fp32, fp32,
                [0, 1, 15, 16, 17, 1040], b=6, max_len=1040, h=4,
                h_kv=2, d=16)
    # The main path's decode steps: 16 slots holding ~1000-token
    # prompts plus up to 64 generated tokens.
    rng = np.random.default_rng(1)
    lengths = [int(x) for x in rng.integers(990, 1065, 16)]
    cases = [decode_case(gen, 'bf16 main-path lengths', bf16, bf16,
                         lengths) for _ in range(4)]
    (_, _, _, lens, kw), err = cases[0]
    # Rotate over four caches (4 x 134 MB) so that no launch finds its
    # K/V in the 50 MB L2, as each layer's cache is cold on the path.
    it = itertools.count()

    def run_kernel():
        q, k, v, ln, _ = cases[next(it) % 4][0]
        decode_ops.decode_attention(q, k, v, ln)

    def run_plain():
        q, k, v, ln, _ = cases[next(it) % 4][0]
        decode_ops.decode_attention_plain(q, k, v, ln)

    def run_library():
        q, k, v, ln, _ = cases[next(it) % 4][0]
        pos = torch.arange(k.shape[1], device='cuda')[None, :]
        mask = (pos < ln[:, None].long())[:, None, None, :]
        F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    ms = time_ms(run_kernel, iters=40, warmup=4)
    plain_ms = time_ms(run_plain, iters=8, warmup=2)
    library_ms = time_ms(run_library, iters=20, warmup=4)
    q, k = cases[0][0][0], cases[0][0][1]
    b, _, h, d = q.shape
    h_kv = k.shape[2]
    live = int(lens.clamp(max=k.shape[1]).sum())
    nbytes = (2 * q.numel() * q.element_size() + 4 * b +
              2 * live * h_kv * d * k.element_size())
    flops = 4.0 * live * h * d
    bound, bound_by = bound_ms(nbytes, flops, bf16)
    log(f'  decode main-path timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, masked SDPA (library) {library_ms:.4f} ms, '
        f'bound {bound:.4f} ms ({bound_by}); '
        f'{nbytes / ms / 1e6:.1f} GB/s of live KV')
    return {'name': 'decode_attention', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/decode_attention.cu',
            'replaces': REPLACES['decode_attention'], 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': bound_by, 'library_ms': library_ms}


def paged_case(gen, label, q_dtype, kv_dtype, lengths, allocated=None,
               num_pages=2048, page=16, nblk=256, h=32, h_kv=8, d=128,
               softcap=None, scale=None, check=True):
    """K5 vs its plain version. Each slot's table row is its own random
    permutation of the arena's pages, so no slot's pages are contiguous;
    entries past a slot's allocation (by default what its length needs)
    hold the sentinel (== num_pages)."""
    b = len(lengths)
    q = rand(gen, (b, 1, h, d), q_dtype)
    k = rand(gen, (num_pages, page, h_kv, d), kv_dtype)
    v = rand(gen, (num_pages, page, h_kv, d), kv_dtype)
    perm = torch.stack([torch.randperm(num_pages, generator=gen,
                                       device='cuda')[:nblk]
                        for _ in range(b)])
    blocks = torch.tensor([-(-min(n, nblk * page) // page) for n in
                           (lengths if allocated is None else allocated)],
                          device='cuda')
    held = torch.arange(nblk, device='cuda')[None, :] < blocks[:, None]
    tables = torch.where(held, perm, num_pages).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    kw = dict(logit_softcap=softcap, scale=scale)
    err = None
    if check:
        out = decode_ops.paged_decode_attention(q, k, v, lens, tables, **kw)
        torch.cuda.synchronize()
        ref = decode_ops.paged_decode_attention_plain(q, k, v, lens, tables,
                                                      **kw)
        err = compare(f'paged decode {label}', out, ref, q_dtype)
        empty = [i for i, n in enumerate(lengths) if n == 0]
        if empty:
            # The JAX kernel's answer for a length-0 slot: the mean of
            # the `page` V rows of its first clamped page.
            first = tables[empty, 0].long().clamp(0, num_pages - 1)
            mean = v[first].float().mean(dim=1).repeat_interleave(
                h // h_kv, dim=1)[:, None]
            compare(f'paged decode {label}, length-0 slots vs mean of '
                    'their first page', out[empty], mean, q_dtype)
    return (q, k, v, lens, tables, kw), err


def check_paged_decode(gen) -> dict:
    log('[3] paged_decode_attention: kernel vs plain version')
    bf16, fp32 = torch.bfloat16, torch.float32
    cap = 256 * 16
    # Ragged lengths around page edges; slot 3 has length 0 and an
    # allocated first block, slot 4 length 0 and an all-sentinel row, slot
    # 5 is inactive (length past the table, all-sentinel row); the others
    # end in sentinel tails.
    ragged = [1, 16, 17, 0, 0, cap + 1, cap, 1000, 3064, 255, 256, 257]
    held = [1, 16, 17, 16, 0, 0, cap, 1000, 3064, 255, 256, 257]
    paged_case(gen, 'bf16 arena, ragged lengths', bf16, bf16, ragged, held)
    paged_case(gen, 'fp32 arena, ragged lengths', fp32, fp32, ragged, held)
    paged_case(gen, 'fp32 q over bf16 arena', fp32, bf16, ragged, held)
    paged_case(gen, 'bf16 softcap=30 scale=0.1', bf16, bf16, ragged, held,
               softcap=30.0, scale=0.1)
    paged_case(gen, 'fp32 page 8, D16 G2 (LLAMA_TINY widths)', fp32, fp32,
               [0, 1, 8, 9, 65, 64, 30], [8, 1, 8, 9, 0, 64, 30],
               num_pages=40, page=8, nblk=8, h=4, h_kv=2, d=16)
    paged_case(gen, 'bf16 page 256, D64 G8', bf16, bf16, [0, 300, 1025, 256],
               [256, 300, 1025, 256], num_pages=24, page=256, nblk=5, h=8,
               h_kv=1, d=64)
    paged_case(gen, 'bf16 page 8, 8192-block table rows', bf16, bf16,
               [65536, 12345, 3], num_pages=8192, page=8, nblk=8192, h=4,
               h_kv=2, d=64)
    # On a contiguous identity table K5 walks the same rows in the same
    # order as K4 (they share one row walk, csrc/decode_common.cuh), so
    # live slots must agree bit for bit.
    for dtype in (bf16, fp32):
        b, page, nblk, h, h_kv, d = 16, 16, 128, 32, 8, 128
        q = rand(gen, (b, 1, h, d), dtype)
        k = rand(gen, (b, nblk * page, h_kv, d), dtype)
        v = rand(gen, (b, nblk * page, h_kv, d), dtype)
        lens = torch.randint(1, nblk * page + 1, (b,), generator=gen,
                             device='cuda', dtype=torch.int32)
        tables = torch.arange(b * nblk, dtype=torch.int32,
                              device='cuda').reshape(b, nblk)
        dense = decode_ops.decode_attention(q, k, v, lens)
        paged = decode_ops.paged_decode_attention(
            q, k.reshape(b * nblk, page, h_kv, d),
            v.reshape(b * nblk, page, h_kv, d), lens, tables)
        torch.cuda.synchronize()
        if not torch.equal(dense, paged):
            raise AssertionError(
                'paged decode on an identity table differs from dense '
                f'decode ({dtype}): max_abs_err '
                f'{float((dense.float() - paged.float()).abs().max()):.3e}')
        log(f'  paged decode on an identity table == dense decode, bit for '
            f'bit ({dtype})')
    # The paged main path's decode steps: 32 slots over 2048 pages of 16
    # rows, ~1000-token prompts plus up to 64 generated tokens, a few
    # slots near a 3000-token prompt's end.
    rng = np.random.default_rng(2)
    lengths = [int(x) for x in rng.integers(990, 1101, 32)]
    lengths[5], lengths[17], lengths[30] = 3064, 3001, 3050
    cases = [paged_case(gen, 'bf16 main-path lengths', bf16, bf16, lengths,
                        check=i == 0) for i in range(2)]
    (q, k, v, lens, tables, _), err = cases[0]
    # Two arenas (2 x 134 MB) in turn: each launch reads more live K/V
    # than the 50 MB L2 holds, and never the arena it read last.
    it = itertools.count()

    def run_kernel():
        q, k, v, ln, tb, _ = cases[next(it) % 2][0]
        decode_ops.paged_decode_attention(q, k, v, ln, tb)

    def run_plain():
        q, k, v, ln, tb, _ = cases[next(it) % 2][0]
        decode_ops.paged_decode_attention_plain(q, k, v, ln, tb)

    def run_library():
        # The nearest library route: gather each slot's pages into a
        # dense [B, K, Hkv, D] view, then masked SDPA.
        q, k, v, ln, tb, _ = cases[next(it) % 2][0]
        safe = tb.long().clamp(0, k.shape[0] - 1)
        b = q.shape[0]
        kd = k[safe].reshape(b, -1, *k.shape[2:])
        vd = v[safe].reshape(b, -1, *v.shape[2:])
        pos = torch.arange(kd.shape[1], device='cuda')[None, :]
        mask = (pos < ln[:, None].long())[:, None, None, :]
        F.scaled_dot_product_attention(
            q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    ms = time_ms(run_kernel, iters=40, warmup=4)
    plain_ms = time_ms(run_plain, iters=8, warmup=2)
    library_ms = time_ms(run_library, iters=20, warmup=4)
    # One block walks one slot's rows, so the three long slots set the
    # time above; the same arenas with every slot near 1000 rows, as in
    # phase [8](a), for comparison with the dense kernel's timing.
    even = torch.tensor([min(n, 1100) for n in lengths], dtype=torch.int32,
                        device='cuda')

    def run_even():
        q, k, v, _, tb, _ = cases[next(it) % 2][0]
        decode_ops.paged_decode_attention(q, k, v, even, tb)

    even_ms = time_ms(run_even, iters=40, warmup=4)
    b, _, h, d = q.shape
    page, h_kv = k.shape[1], k.shape[2]
    live = int(lens.clamp(max=tables.shape[1] * page).sum())
    nbytes = (2 * q.numel() * q.element_size() + 4 * b +
              tables.numel() * 4 + 2 * live * h_kv * d * k.element_size())
    flops = 4.0 * live * h * d
    bound, bound_by = bound_ms(nbytes, flops, bf16)
    log(f'  paged decode main-path timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, page gather + masked SDPA (library) '
        f'{library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); '
        f'{nbytes / ms / 1e6:.1f} GB/s of live KV ({live} live rows); '
        f'with every slot at most 1100 rows ({int(even.sum())} live rows) '
        f'kernel {even_ms:.4f} ms')
    return {'name': 'paged_decode_attention', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_decode_attention.cu',
            'replaces': REPLACES['paged_decode_attention'],
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms, 'ms_at_most_1100_rows': even_ms}


# ---- phase 3: the MLA decode kernels (K6 dense, K7 paged) ----

# DeepSeek-V2-Lite's MLA widths: 16 heads, latent rank 512, RoPE key 64;
# the absorbed step's scale is (qk_nope + qk_rope) ** -0.5.
MLA_H, MLA_R, MLA_DR = 16, 512, 64
MLA_SCALE = 192 ** -0.5


def mla_inputs(gen, b, h=MLA_H, r=MLA_R, dr=MLA_DR):
    return rand(gen, (b, h, r), torch.float32), rand(gen, (b, h, dr),
                                                     torch.float32)


def mla_case(gen, label, kv_dtype, lengths, max_len=2048, h=MLA_H,
             r=MLA_R, dr=MLA_DR, check=True):
    """K6 vs its plain version. Both compute in fp32 (the cache is upcast)
    and differ only by summation order, so the fp32 tolerance holds for a
    bf16 cache too."""
    b = len(lengths)
    q_eff, q_rope = mla_inputs(gen, b, h, r, dr)
    ckv = rand(gen, (b, max_len, r), kv_dtype)
    krope = rand(gen, (b, max_len, dr), kv_dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    err = None
    if check:
        out = mla_ops.mla_decode_attention(q_eff, q_rope, ckv, krope, lens,
                                           MLA_SCALE)
        torch.cuda.synchronize()
        ref = mla_ops.mla_decode_attention_plain(q_eff, q_rope, ckv, krope,
                                                 lens, MLA_SCALE)
        err = compare(f'mla decode {label}', out, ref, torch.float32)
        empty = [i for i, n in enumerate(lengths) if n == 0]
        if empty:
            # The JAX kernel's answer for a length-0 slot: the mean of its
            # first min(256, K) c_kv rows.
            mean = ckv[empty, :min(mla_ops.DEFAULT_BLOCK_KV, max_len)].float(
            ).mean(dim=1)[:, None].expand(len(empty), h, r)
            compare(f'mla decode {label}, length-0 slots vs mean of first '
                    'rows', out[empty], mean, torch.float32)
    return (q_eff, q_rope, ckv, krope, lens), err


def mla_bound(q_eff, q_rope, live, elem, extra_bytes=0):
    """(bound ms, what bounds it): each input read once (queries fp32, the
    live cache rows in the cache's type), the fp32 output written once;
    fp32 products at the 67 TFLOP/s non-tensor-core peak (the kernel's
    math is fp32, as the TPU kernel's)."""
    b, h, r = q_eff.shape
    dr = q_rope.shape[-1]
    nbytes = ((q_eff.numel() + q_rope.numel() + b * h * r) * 4 + 4 * b +
              live * (r + dr) * elem + extra_bytes)
    flops = 2.0 * live * h * ((r + dr) + r)
    return bound_ms(nbytes, flops, torch.float32) + (nbytes, flops)


def check_mla_decode(gen) -> dict:
    log('[3] mla_decode (K6): kernel vs plain version')
    bf16, fp32 = torch.bfloat16, torch.float32
    max_len = 2048
    ragged = [1, 255, 256, 257, max_len, 0, max_len + 1, 1000]
    for dtype, name in ((bf16, 'bf16'), (fp32, 'fp32')):
        mla_case(gen, f'{name} cache, lengths 1/255/256/257/K, length 0, '
                 'inactive K+1', dtype, ragged)
    mla_case(gen, 'fp32 cache, DEEPSEEK_TINY widths', fp32,
             [0, 1, 31, 33, 127, 129, 300], max_len=300, h=4, r=32, dr=8)
    rng = np.random.default_rng(10)
    lengths = [int(x) for x in rng.integers(990, 1065, 16)]
    mla_case(gen, 'fp32 main-path lengths', fp32, lengths)
    # The main path's decode steps: 16 slots, bf16 cache. Four caches in
    # turn (4 x 38 MB): no launch finds its rows in the 50 MB L2.
    cases = [mla_case(gen, 'bf16 main-path lengths', bf16, lengths,
                      check=i == 0) for i in range(4)]
    err = cases[0][1]
    # The library yardstick's inputs, prepared outside the timed region:
    # [q_eff | q_rope] in the cache's type against one KV head
    # [c_kv | k_rope], value c_kv, a length mask.
    lib = []
    for (q_eff, q_rope, ckv, krope, lens), _ in cases:
        q = torch.cat([q_eff, q_rope], -1).to(bf16)[:, :, None]
        k = torch.cat([ckv, krope], -1)[:, None]
        pos = torch.arange(max_len, device='cuda')[None, :]
        mask = (pos < lens[:, None].long())[:, None, None, :]
        lib.append((q, k, ckv[:, None], mask))
    it = itertools.count()

    def run_kernel():
        mla_ops.mla_decode_attention(*cases[next(it) % 4][0], MLA_SCALE)

    def run_plain():
        mla_ops.mla_decode_attention_plain(*cases[next(it) % 4][0],
                                           MLA_SCALE)

    def run_library():
        q, k, v, mask = lib[next(it) % 4]
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                       scale=MLA_SCALE, enable_gqa=True)

    ms = time_ms(run_kernel, iters=40, warmup=4)
    plain_ms = time_ms(run_plain, iters=8, warmup=2)
    library_ms = time_ms(run_library, iters=20, warmup=4)
    q_eff, q_rope, ckv, _, lens = cases[0][0]
    live = int(lens.clamp(max=max_len).sum())
    bound, bound_by, nbytes, flops = mla_bound(q_eff, q_rope, live,
                                               ckv.element_size())
    log(f'  mla decode main-path timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, masked SDPA (library) {library_ms:.4f} ms, '
        f'bound {bound:.4f} ms ({bound_by}; bf16 cache bytes, fp32 '
        f'products); {live} live rows, {nbytes / ms / 1e6:.1f} GB/s, '
        f'{flops / ms / 1e9:.2f} TFLOP/s fp32')
    return {'name': 'mla_decode', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/mla_decode.cu',
            'replaces': REPLACES['mla_decode'], 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': bound_by, 'library_ms': library_ms}


def paged_mla_case(gen, label, kv_dtype, lengths, allocated=None,
                   num_pages=2048, page=16, nblk=256, h=MLA_H, r=MLA_R,
                   dr=MLA_DR, check=True):
    """K7 vs its plain version: each slot's table row its own random
    permutation of the arena's pages, sentinel (== num_pages) past its
    allocation (by default what its length needs)."""
    b = len(lengths)
    q_eff, q_rope = mla_inputs(gen, b, h, r, dr)
    ckv = rand(gen, (num_pages, page, r), kv_dtype)
    krope = rand(gen, (num_pages, page, dr), kv_dtype)
    perm = torch.stack([torch.randperm(num_pages, generator=gen,
                                       device='cuda')[:nblk]
                        for _ in range(b)])
    blocks = torch.tensor([-(-min(n, nblk * page) // page) for n in
                           (lengths if allocated is None else allocated)],
                          device='cuda')
    held = torch.arange(nblk, device='cuda')[None, :] < blocks[:, None]
    tables = torch.where(held, perm, num_pages).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    err = None
    if check:
        out = mla_ops.paged_mla_decode_attention(q_eff, q_rope, ckv, krope,
                                                 lens, tables, MLA_SCALE)
        torch.cuda.synchronize()
        ref = mla_ops.paged_mla_decode_attention_plain(
            q_eff, q_rope, ckv, krope, lens, tables, MLA_SCALE)
        err = compare(f'paged mla decode {label}', out, ref, torch.float32)
        empty = [i for i, n in enumerate(lengths) if n == 0]
        if empty:
            first = tables[empty, 0].long().clamp(0, num_pages - 1)
            mean = ckv[first].float().mean(dim=1)[:, None].expand(
                len(empty), h, r)
            compare(f'paged mla decode {label}, length-0 slots vs mean of '
                    'their first page', out[empty], mean, torch.float32)
    return (q_eff, q_rope, ckv, krope, lens, tables), err


def check_paged_mla_decode(gen) -> dict:
    log('[3] paged_mla_decode (K7): kernel vs plain version')
    bf16, fp32 = torch.bfloat16, torch.float32
    cap = 256 * 16
    # Slot 3: length 0 with an allocated first block; slot 4: length 0,
    # all-sentinel row; slot 5: inactive (length past the table,
    # all-sentinel row); the others end in sentinel tails.
    ragged = [1, 16, 17, 0, 0, cap + 1, cap, 1000, 3064, 255, 256, 257]
    held = [1, 16, 17, 16, 0, 0, cap, 1000, 3064, 255, 256, 257]
    for dtype, name in ((bf16, 'bf16'), (fp32, 'fp32')):
        paged_mla_case(gen, f'{name} arena, ragged lengths', dtype, ragged,
                       held)
    paged_mla_case(gen, 'fp32 page 8, DEEPSEEK_TINY widths', fp32,
                   [0, 1, 8, 9, 65, 64, 30], [8, 1, 8, 9, 0, 64, 30],
                   num_pages=40, page=8, nblk=8, h=4, r=32, dr=8)
    # On a contiguous identity table K7 walks the same rows in the same
    # order as K6 (one shared split walk, csrc/mla_common.cuh).
    for dtype in (bf16, fp32):
        b, page, nblk = 16, 16, 128
        q_eff, q_rope = mla_inputs(gen, b)
        ckv = rand(gen, (b, nblk * page, MLA_R), dtype)
        krope = rand(gen, (b, nblk * page, MLA_DR), dtype)
        lens = torch.randint(1, nblk * page + 1, (b,), generator=gen,
                             device='cuda', dtype=torch.int32)
        tables = torch.arange(b * nblk, dtype=torch.int32,
                              device='cuda').reshape(b, nblk)
        dense = mla_ops.mla_decode_attention(q_eff, q_rope, ckv, krope, lens,
                                             MLA_SCALE)
        paged = mla_ops.paged_mla_decode_attention(
            q_eff, q_rope, ckv.reshape(-1, page, MLA_R),
            krope.reshape(-1, page, MLA_DR), lens, tables, MLA_SCALE)
        torch.cuda.synchronize()
        if not torch.equal(dense, paged):
            raise AssertionError(
                'paged mla decode on an identity table differs from dense '
                f'({dtype}): max_abs_err '
                f'{float((dense - paged).abs().max()):.3e}')
        log(f'  paged mla decode on an identity table == dense mla decode, '
            f'bit for bit ({dtype})')
    # The paged main path's decode steps: 32 slots over 2048 pages of 16
    # rows, ~1000-token prompts plus up to 64 generated tokens, three slots
    # near a 3000-token prompt's end. Three arenas in turn (3 x 38 MB).
    rng = np.random.default_rng(11)
    lengths = [int(x) for x in rng.integers(990, 1101, 32)]
    lengths[5], lengths[17], lengths[30] = 3064, 3001, 3050
    paged_mla_case(gen, 'fp32 main-path lengths', fp32, lengths)
    cases = [paged_mla_case(gen, 'bf16 main-path lengths', bf16, lengths,
                            check=i == 0) for i in range(3)]
    err = cases[0][1]
    it = itertools.count()

    def run_kernel():
        mla_ops.paged_mla_decode_attention(*cases[next(it) % 3][0],
                                           MLA_SCALE)

    def run_plain():
        mla_ops.paged_mla_decode_attention_plain(*cases[next(it) % 3][0],
                                                 MLA_SCALE)

    def run_library():
        # Gather each slot's pages into a dense view, then masked SDPA.
        q_eff, q_rope, ckv, krope, ln, tb = cases[next(it) % 3][0]
        safe = tb.long().clamp(0, ckv.shape[0] - 1)
        b = q_eff.shape[0]
        kd = torch.cat([ckv[safe], krope[safe]], -1).reshape(b, 1, -1,
                                                            MLA_R + MLA_DR)
        q = torch.cat([q_eff, q_rope], -1).to(kd.dtype)[:, :, None]
        pos = torch.arange(kd.shape[2], device='cuda')[None, :]
        mask = (pos < ln[:, None].long())[:, None, None, :]
        F.scaled_dot_product_attention(q, kd, kd[..., :MLA_R],
                                       attn_mask=mask, scale=MLA_SCALE,
                                       enable_gqa=True)

    ms = time_ms(run_kernel, iters=40, warmup=4)
    plain_ms = time_ms(run_plain, iters=8, warmup=2)
    library_ms = time_ms(run_library, iters=10, warmup=2)
    q_eff, q_rope, ckv, _, lens, tables = cases[0][0]
    live = int(lens.clamp(max=tables.shape[1] * ckv.shape[1]).sum())
    bound, bound_by, nbytes, flops = mla_bound(
        q_eff, q_rope, live, ckv.element_size(), tables.numel() * 4)
    log(f'  paged mla decode main-path timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, page gather + masked SDPA (library) '
        f'{library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; bf16 cache '
        f'bytes, fp32 products); {live} live rows, '
        f'{nbytes / ms / 1e6:.1f} GB/s, {flops / ms / 1e9:.2f} TFLOP/s fp32')
    return {'name': 'paged_mla_decode', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_mla_decode.cu',
            'replaces': REPLACES['paged_mla_decode'], 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': bound_by, 'library_ms': library_ms}


def zero_launches() -> None:
    for kern in kernels.REGISTRY:
        kern.launches = 0


def check_launches(path: str, launches: dict, wanted, n_layers: int) -> None:
    """The path's kernels each ran a positive multiple of n_layers times;
    every other kernel not at all."""
    for name, n in launches.items():
        if name in wanted and (n == 0 or n % n_layers):
            raise AssertionError(f'{name}: {n} launches on the {path} path '
                                 f'(want a positive multiple of {n_layers} '
                                 'layers)')
        if name not in wanted and n:
            raise AssertionError(f'{name}: {n} launches on the {path} '
                                 'path, which should not run it')


# ---- phases 4 and 8: serving main paths ----

def serve_and_check(orch, cfg, prompts, new_tokens: int):
    """Submit, drain, require every request whole → (requests, seconds)."""
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    t0 = time.perf_counter()
    requests = [orch.submit(orch_lib.Request(prompt_tokens=p,
                                             max_new_tokens=new_tokens))
                for p in prompts]
    orch.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for r in requests:
        if r.error or len(r.output_tokens) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(
                f'request {r.request_id}: error={r.error}, '
                f'{len(r.output_tokens)} tokens')
    stats = orch.engine.kv_page_stats      # None for a dense cache
    if (stats and stats['free'] != stats['total']) or len(
            orch._free_slots) != orch.engine.config.max_slots:
        raise AssertionError(f'pages or slots not given back after the '
                             f'drain: {stats}, {len(orch._free_slots)} '
                             'free slots')
    return requests, dt


def mean_ms(requests) -> float:
    return float(np.mean([r.first_token_at - r.submitted_at
                          for r in requests])) * 1e3


def main_path(records: dict) -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import llama
    cfg = llama.LLAMA3_8B
    log(f'[4] main path: Llama-3-8B bf16 ({cfg.n_layers} layers, '
        f'd_model {cfg.d_model}, vocab {cfg.vocab_size}), random init')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = llama.init(cfg, gen)
    torch.cuda.synchronize()
    log(f'  init {time.perf_counter() - t0:.2f} s, '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=16,
                                max_target_len=2048,
                                prefill_buckets=(1024,)), params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(960, 1025, 16)]
    new_tokens = 64
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('serving', launches, SERVE_KERNELS, cfg.n_layers)
    for name in SERVE_KERNELS:
        records[name]['launches_by_path'] = {'serve': launches[name]}
    out_tokens = sum(len(r.output_tokens) for r in requests)
    log(f'  16 requests x {new_tokens} tokens done in {dt:.3f} s: '
        f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
        f'{mean_ms(requests):.1f} ms, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
        f'launches {launches} on {nvidia_smi_line()}')
    del orch, engine, params
    release_card()


# ---- phase 5: small model, card vs CPU ----

def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def small_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    log('[5] small end to end: fp32 LLAMA_TINY widths, bucket 1024, '
        'card (kernels) vs CPU (plain versions)')
    gen = torch.Generator()
    gen.manual_seed(3)
    cpu_params = llama.init(cfg, gen, device='cpu')
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (1024, 700, 913, 1000, 64)]
    outputs = {}
    before = {k.name: k.launches for k in kernels.REGISTRY}
    for device in ('cuda', 'cpu'):
        params = to_device(cpu_params, device)
        engine = engine_lib.InferenceEngine(
            engine_lib.EngineConfig(model=cfg, max_slots=4,
                                    max_target_len=1040,
                                    prefill_buckets=(1024,),
                                    kv_dtype=torch.float32),
            params, device=device)
        outputs[device] = orch_lib.Orchestrator(
            engine, decode_steps=4).generate(prompts, max_new_tokens=12)
    used = {k.name: k.launches - before[k.name] for k in kernels.REGISTRY}
    log(f'  card tokens {outputs["cuda"]}')
    log(f'  cpu tokens  {outputs["cpu"]}; card kernel launches {used}')
    if outputs['cuda'] != outputs['cpu']:
        raise AssertionError('greedy tokens differ between the card and '
                             'the CPU')
    if not all(used[name] for name in SERVE_KERNELS):
        raise AssertionError(f'a kernel did not run on the card: {used}')


# ---- phase 6: training main path ----

def train_main_path(records: dict) -> None:
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer as trainer_lib
    cfg = dataclasses.replace(llama.LLAMA3_1B, remat=True,
                              remat_policy='qkvo_gup')
    # The learning rate only sets how fast the repeated batch's loss
    # falls (the check below); it does not change the step's work.
    tcfg = trainer_lib.TrainConfig(model=cfg, global_batch_size=4,
                                   seq_len=8192, optimizer='adafactor',
                                   learning_rate=3e-3, warmup_steps=2)
    log(f'[6] training main path: Llama-3-1B bf16 ({cfg.n_layers} layers, '
        f'd_model {cfg.d_model}, vocab {cfg.vocab_size}), seq '
        f'{tcfg.seq_len}, batch {tcfg.global_batch_size}, remat '
        f'{cfg.remat_policy}, {tcfg.optimizer}; random init')
    trainer = trainer_lib.Trainer(tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    result = trainer_lib.measure_throughput(trainer, num_steps=5, warmup=2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('training', launches, TRAIN_KERNELS, cfg.n_layers)
    for name in TRAIN_KERNELS:
        records[name].setdefault('launches_by_path', {})['train'] = (
            launches[name])
    first, last = result['first_loss'], result['loss']
    if not (np.isfinite(first) and np.isfinite(last) and last < first):
        raise AssertionError(f'training loss {first} -> {last}: want finite '
                             'and falling on the repeated batch')
    tflops = result['model_tflops_per_sec_per_chip']
    log(f'  7 steps (2 warm-up + 5 measured) in {dt:.3f} s with init: '
        f'{result["tokens_per_sec"]:.1f} tokens/s, step '
        f'{result["step_time_s"]:.4f} s, model {tflops:.2f} TFLOP/s = '
        f'{tflops / (PEAK_FLOPS[torch.bfloat16] / 1e12):.4f} of the bf16 '
        f'peak; loss {first:.4f} -> {last:.4f}; peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
        f'{launches} on {nvidia_smi_line()}')
    log(f'  measure_throughput: {json.dumps(result)}')
    del trainer
    release_card()


# ---- phase 7: small training check, card vs CPU ----

# Card vs CPU after three fp32 steps: the kernels and the plain versions
# sum in other orders (~1e-6 relative); Adam normalizes each element by
# its own gradient history, which carries a nearly cancelling gradient's
# relative error into the update, up to a few % of one step at lr 1e-3.
TRAIN_LOSS_ATOL = 1e-4
TRAIN_NORM_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-4


def small_train_check() -> None:
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer as trainer_lib
    eos = 7
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32,
                              packing_reset_eos=eos)
    tcfg = trainer_lib.TrainConfig(model=cfg, global_batch_size=2,
                                   seq_len=1024, optimizer='adamw',
                                   accum_steps=2, learning_rate=1e-3,
                                   warmup_steps=2)
    log('[7] small training check: fp32 LLAMA_TINY widths, seq 1024, EOS '
        'packing, adamw, accum_steps=2, 3 steps: card (kernels) vs CPU '
        '(plain versions)')
    gen = torch.Generator()
    gen.manual_seed(5)
    cpu_params = llama.init(cfg, gen, device='cpu')
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 1024))
    tokens[rng.random(tokens.shape) < 0.01] = eos
    batch = {'tokens': torch.from_numpy(tokens),
             'targets': torch.from_numpy(np.roll(tokens, -1, axis=1))}
    runs = {}
    before = {k.name: k.launches for k in kernels.REGISTRY}
    for device in ('cuda', 'cpu'):
        tr = trainer_lib.Trainer(tcfg, device=device)
        state = tr.init_state(to_device(
            {k: (v.clone() if torch.is_tensor(v) else
                 {kk: vv.clone() for kk, vv in v.items()})
             for k, v in cpu_params.items()}, device))
        on_device = {k: v.to(device) for k, v in batch.items()}
        metrics = []
        for _ in range(3):
            state, m = tr.step(state, on_device)
            metrics.append((float(m['loss']), float(m['grad_norm'])))
        runs[device] = (metrics, trainer_lib.param_leaves(state['params']))
    used = {k.name: k.launches - before[k.name] for k in kernels.REGISTRY}
    log(f'  card (loss, grad_norm) {runs["cuda"][0]}')
    log(f'  cpu  (loss, grad_norm) {runs["cpu"][0]}; card kernel launches '
        f'{used}')
    for (lc, nc), (lp, npl) in zip(runs['cuda'][0], runs['cpu'][0]):
        if abs(lc - lp) > TRAIN_LOSS_ATOL or abs(nc - npl) > (
                TRAIN_NORM_RTOL * abs(npl)):
            raise AssertionError('loss or grad norm differs between the '
                                 'card and the CPU')
    err = max(float((pc.detach().cpu() - pp.detach()).abs().max())
              for pc, pp in zip(runs['cuda'][1], runs['cpu'][1]))
    log(f'  final params: max_abs_err={err:.3e} (tolerance '
        f'atol={TRAIN_PARAM_ATOL:g}); losses atol {TRAIN_LOSS_ATOL:g}, '
        f'grad norms rtol {TRAIN_NORM_RTOL:g}')
    if err > TRAIN_PARAM_ATOL:
        raise AssertionError('parameters differ between the card and the '
                             'CPU after three steps')
    if not all(used[name] for name in TRAIN_KERNELS):
        raise AssertionError(f'a kernel did not run on the card: {used}')


# ---- phase 8: paged serving main path ----

def release_card() -> None:
    """Free what a finished phase held on the card. The step counter below
    makes its engine a reference cycle, which only the collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def count_decode_steps(engine) -> list:
    """Wrap the engine's decode step so that a run can count its steps."""
    steps = [0]
    step_impl = engine._decode_step_impl

    def counted(*args, **kwargs):
        steps[0] += 1
        return step_impl(*args, **kwargs)

    engine._decode_step_impl = counted
    return steps


def paged_main_path(records: dict) -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import llama
    cfg = llama.LLAMA3_8B
    log(f'[8] paged main path: Llama-3-8B bf16 ({cfg.n_layers} layers), the '
        'random weights of [4]; 32 slots over 2048 pages of 16 rows')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    params = llama.init(cfg, gen)
    ecfg = engine_lib.EngineConfig(
        model=cfg, max_slots=32, max_target_len=4096,
        prefill_buckets=(1024,), kv_page_size=16, kv_num_pages=2048)
    new_tokens = 64
    rng = np.random.default_rng(8)

    def prompt(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    # (a) 32 prompts whose budgets (1064-1088 rows, 67-68 pages each) add
    # up to more than the arena's 2048 pages.
    engine = engine_lib.InferenceEngine(ecfg, params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    steps = count_decode_steps(engine)
    prompts = [prompt(n) for n in rng.integers(1000, 1025, 32)]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('paged serving', launches, PAGED_SERVE_KERNELS,
                   cfg.n_layers)
    deferred = sum(r.deferred_wait > 0 for r in requests)
    if not deferred:
        raise AssertionError('no request was deferred: the arena held '
                             'every budget at once')
    if launches['paged_decode_attention'] != cfg.n_layers * steps[0]:
        raise AssertionError(
            f'paged_decode_attention: {launches["paged_decode_attention"]} '
            f'launches for {steps[0]} decode steps of {cfg.n_layers} layers')
    for name in PAGED_SERVE_KERNELS:
        records[name].setdefault('launches_by_path', {})['serve_paged'] = (
            launches[name])
    out_tokens = sum(len(r.output_tokens) for r in requests)
    log(f'  (a) 32 requests x {new_tokens} tokens done in {dt:.3f} s: '
        f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
        f'{mean_ms(requests):.1f} ms (admitted at once '
        f'{mean_ms([r for r in requests if not r.deferred_wait]):.1f} ms), '
        f'{deferred} deferred, {steps[0]} decode steps, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
        f'{launches} on {nvidia_smi_line()}')
    del orch, engine
    release_card()

    # (b) the prefix cache on (admission is then one prompt per call): a
    # short prompt, two long ones (three chunks each, one chunk per tick
    # between decode ticks), three more short ones that share the first
    # one's first 768 tokens.
    engine = engine_lib.InferenceEngine(
        dataclasses.replace(ecfg, prefix_cache_entries=4), params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    steps = count_decode_steps(engine)
    shared = prompt(768)
    shorts = [shared + prompt(n) for n in rng.integers(200, 250, 4)]
    longs = [prompt(3000) for _ in range(2)]
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, [shorts[0]] + longs + shorts[1:],
                                   new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('paged + prefix serving', launches, PAGED_SERVE_KERNELS,
                   cfg.n_layers)
    stats = engine.prefix_cache_stats
    if stats['hits'] < 3 or stats['tokens_reused'] < 3 * 768:
        raise AssertionError(f'prefix cache: {stats}, want 3 hits of 768 '
                             'tokens')
    if launches['paged_decode_attention'] != cfg.n_layers * steps[0]:
        raise AssertionError(
            f'paged_decode_attention: {launches["paged_decode_attention"]} '
            f'launches for {steps[0]} decode steps of {cfg.n_layers} layers')
    for name in PAGED_SERVE_KERNELS:
        records[name]['launches_by_path']['serve_paged_prefix'] = (
            launches[name])
    log(f'  (b) 6 requests x {new_tokens} tokens done in {dt:.3f} s: TTFT '
        f'first short prompt (miss) {mean_ms(requests[:1]):.1f} ms, long '
        f'prompts (3 chunks) {mean_ms(requests[1:3]):.1f} ms, prefix-hit '
        f'prompts {mean_ms(requests[3:]):.1f} ms; prefix cache {stats}, '
        f'{steps[0]} decode steps; launches {launches} on '
        f'{nvidia_smi_line()}')
    del orch, engine, params
    release_card()


# ---- phase 9: small paged model, card vs CPU ----

def small_paged_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    log('[9] small paged end to end: fp32 LLAMA_TINY widths, 250 pages of '
        '16 rows, bucket 1024, chunked prefill and the prefix cache, card '
        '(kernels) vs CPU (plain versions)')
    gen = torch.Generator()
    gen.manual_seed(9)
    cpu_params = llama.init(cfg, gen, device='cpu')
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (2100, 1024, 700, 913, 64)]
    prompts.insert(3, prompts[1][:600] + prompts[4][:50])
    outputs, stats = {}, {}
    before = {k.name: k.launches for k in kernels.REGISTRY}
    for device in ('cuda', 'cpu'):
        engine = engine_lib.InferenceEngine(
            engine_lib.EngineConfig(model=cfg, max_slots=4,
                                    max_target_len=2560,
                                    prefill_buckets=(1024,),
                                    kv_dtype=torch.float32, kv_page_size=16,
                                    kv_num_pages=250,
                                    prefix_cache_entries=4),
            to_device(cpu_params, device), device=device)
        orch = orch_lib.Orchestrator(engine, decode_steps=4)
        requests = [orch.submit(orch_lib.Request(prompt_tokens=p,
                                                 max_new_tokens=12))
                    for p in prompts]
        orch.run_until_drained()
        outputs[device] = [r.output_tokens for r in requests]
        stats[device] = (engine.prefix_cache_stats, engine.kv_page_stats,
                         sum(r.deferred_wait > 0 for r in requests))
    used = {k.name: k.launches - before[k.name] for k in kernels.REGISTRY}
    log(f'  card tokens {outputs["cuda"]}')
    log(f'  cpu tokens  {outputs["cpu"]}; (prefix cache, pages, deferred) '
        f'{stats["cuda"]}; card kernel launches {used}')
    if outputs['cuda'] != outputs['cpu'] or stats['cuda'] != stats['cpu']:
        raise AssertionError('greedy tokens or cache statistics differ '
                             'between the card and the CPU')
    if not all(len(t) == 12 for t in outputs['cuda']):
        raise AssertionError('a request did not finish')
    prefix, pages, deferred = stats['cuda']
    if not (prefix['hits'] and deferred and pages['free'] == pages['total']):
        raise AssertionError(f'the run missed a path: {stats["cuda"]}')
    if not all(used[name] for name in PAGED_SERVE_KERNELS):
        raise AssertionError(f'a kernel did not run on the card: {used}')


# ---- phases 10 and 11: DeepSeek-V2-Lite serving, dense and paged ----

def deepseek_main_paths(records: dict) -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import deepseek
    cfg = deepseek.DEEPSEEK_V2_LITE
    log(f'[10] DeepSeek main path: DeepSeek-V2-Lite bf16 ({cfg.n_layers} '
        f'layers, d_model {cfg.d_model}, {cfg.n_heads} heads, kv_lora_rank '
        f'{cfg.kv_lora_rank}, {cfg.n_experts} experts top-'
        f'{cfg.experts_per_token} + {cfg.n_shared_experts} shared, vocab '
        f'{cfg.vocab_size}; {cfg.num_params() / 1e9:.2f} B parameters), '
        'random init; dense slot cache')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = deepseek.init(cfg, gen)
    torch.cuda.synchronize()
    log(f'  init {time.perf_counter() - t0:.2f} s, '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    rng = np.random.default_rng(10)

    def prompt(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    new_tokens = 64
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=16,
                                max_target_len=2048,
                                prefill_buckets=(1024,)), params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    steps = count_decode_steps(engine)
    prompts = [prompt(n) for n in rng.integers(960, 1025, 16)]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('DeepSeek serving', launches, DEEPSEEK_KERNELS,
                   cfg.n_layers)
    if launches['mla_decode'] != cfg.n_layers * steps[0]:
        raise AssertionError(f'mla_decode: {launches["mla_decode"]} launches '
                             f'for {steps[0]} decode steps of '
                             f'{cfg.n_layers} layers')
    records['mla_decode']['launches_by_path'] = {
        'serve_deepseek': launches['mla_decode']}
    out_tokens = sum(len(r.output_tokens) for r in requests)
    log(f'  16 requests x {new_tokens} tokens done in {dt:.3f} s: '
        f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
        f'{mean_ms(requests):.1f} ms, {steps[0]} decode steps, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
        f'{launches} on {nvidia_smi_line()}')
    del orch, engine
    release_card()

    log('[11] DeepSeek paged main path: the same model and weights, 32 '
        'slots over 2048 pages of 16 rows')
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=32,
                                max_target_len=4096,
                                prefill_buckets=(1024,), kv_page_size=16,
                                kv_num_pages=2048), params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    steps = count_decode_steps(engine)
    # Budgets of 1064-1088 rows (67-68 pages each): more than 2048 pages.
    prompts = [prompt(n) for n in rng.integers(1000, 1025, 32)]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('DeepSeek paged serving', launches,
                   PAGED_DEEPSEEK_KERNELS, cfg.n_layers)
    deferred = sum(r.deferred_wait > 0 for r in requests)
    if not deferred:
        raise AssertionError('no request was deferred: the arena held '
                             'every budget at once')
    if launches['paged_mla_decode'] != cfg.n_layers * steps[0]:
        raise AssertionError(
            f'paged_mla_decode: {launches["paged_mla_decode"]} launches for '
            f'{steps[0]} decode steps of {cfg.n_layers} layers')
    records['paged_mla_decode']['launches_by_path'] = {
        'serve_deepseek_paged': launches['paged_mla_decode']}
    out_tokens = sum(len(r.output_tokens) for r in requests)
    log(f'  32 requests x {new_tokens} tokens done in {dt:.3f} s: '
        f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
        f'{mean_ms(requests):.1f} ms (admitted at once '
        f'{mean_ms([r for r in requests if not r.deferred_wait]):.1f} ms), '
        f'{deferred} deferred, {steps[0]} decode steps, all pages free '
        f'after the drain, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
        f'{launches} on {nvidia_smi_line()}')
    del orch, engine, params
    release_card()


# ---- phase 12: small DeepSeek, card vs CPU ----

def small_deepseek_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import deepseek
    cfg = dataclasses.replace(deepseek.DEEPSEEK_TINY, dtype=torch.float32)
    log('[12] small DeepSeek end to end: fp32 DEEPSEEK_TINY widths, a dense '
        'and a paged engine, a 3-prompt wave padded to 4 rows, card '
        '(kernels) vs CPU (plain versions)')
    gen = torch.Generator()
    gen.manual_seed(12)
    cpu_params = deepseek.init(cfg, gen, device='cpu')
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (120, 77, 128)]
    for paged in (False, True):
        kernel = mla_ops.PAGED_KERNEL if paged else mla_ops.KERNEL
        outputs = {}
        before = kernel.launches
        for device in ('cuda', 'cpu'):
            engine = engine_lib.InferenceEngine(
                engine_lib.EngineConfig(
                    model=cfg, max_slots=4, max_target_len=512,
                    prefill_buckets=(128,), kv_dtype=torch.float32,
                    kv_page_size=16 if paged else 0),
                to_device(cpu_params, device), device=device)
            outputs[device] = orch_lib.Orchestrator(
                engine, decode_steps=4).generate(prompts, max_new_tokens=16)
        name = 'paged' if paged else 'dense'
        log(f'  {name} card tokens {outputs["cuda"]}')
        log(f'  {name} cpu tokens  {outputs["cpu"]}; {kernel.name} launches '
            f'on the card {kernel.launches - before}')
        if outputs['cuda'] != outputs['cpu']:
            raise AssertionError(f'{name}: greedy tokens differ between the '
                                 'card and the CPU')
        if not all(len(t) == 16 for t in outputs['cuda']):
            raise AssertionError(f'{name}: a request did not finish')
        if kernel.launches == before:
            raise AssertionError(f'{kernel.name} did not run on the card')


def main() -> int:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py needs a CUDA device; none found.')
    log(f'[1] device: {torch.cuda.get_device_name(0)} x '
        f'{torch.cuda.device_count()}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}')
    smi = nvidia_smi_line()
    log(f'  nvidia-smi: {smi}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('  TF32 off for fp32 matmuls and cuDNN')
    t0 = time.perf_counter()
    seconds = kernels.build_all()
    log(f'[2] built {len(kernels.REGISTRY)} kernels from {len(seconds)} '
        f'sources in {time.perf_counter() - t0:.2f} s wall: {seconds}')
    logs = {kern.source: kern.build_log for kern in kernels.REGISTRY}
    for source, build_log in sorted(logs.items()):
        regs = re.findall(r'Used (\d+) registers', build_log)
        spills = re.findall(r'(\d+) bytes spill stores', build_log)
        if regs:
            log(f'  {source}: {len(regs)} kernel instantiations, at most '
                f'{max(map(int, regs))} registers, '
                f'{sum(map(int, spills))} bytes spilled')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    records = {'flash_fwd': check_flash(gen), **check_flash_bwd(gen),
               'decode_attention': check_decode(gen),
               'paged_decode_attention': check_paged_decode(gen),
               'mla_decode': check_mla_decode(gen),
               'paged_mla_decode': check_paged_mla_decode(gen)}
    main_path(records)
    small_end_to_end()
    train_main_path(records)
    small_train_check()
    paged_main_path(records)
    small_paged_end_to_end()
    deepseek_main_paths(records)
    small_deepseek_end_to_end()
    for rec in records.values():
        rec['launches'] = sum(rec['launches_by_path'].values())
    log(f'[total] chip_smoke wall time {time.perf_counter() - start:.1f} s '
        '(limit 1200 s)')
    print(json.dumps({'kernels': list(records.values())}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
