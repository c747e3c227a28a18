#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: require CUDA, print the card's name and power limit, turn
     TF32 off for fp32 products;
  2. build: compile every kernel source in skypilot_tpu_torch/csrc/ (one
     nvcc per source, all at once) and print the build seconds, and the
     registers and spilled bytes of each source and of each wgmma
     kernel;
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main paths' shapes and in the window / segment /
     softcap / int8 / ragged-length cases, in bf16 and fp32, with each
     error beside its tolerance (flash outputs and gradients also
     blockwise, decode outputs per (slot, head), and four planted faults
     must be rejected); the flash kernels also at the wgmma kernels'
     tile edges (S 127, 129, 1000 x GQA groups 1, 2, 4 x D 64, 128), the
     forward at the training shape (row 0 against the plain version,
     then timed beside SDPA), and two dK/dV and two dQ runs at the
     training shape must be bit-identical; dense decode also at its
     split-KV walk's edges (128-row splits); kernel, plain and library
     device times (see time_ms) and the least time the card could take
     (bound): the flash forward,
     the flash backward pair (dK/dV, dQ), dense decode, paged decode, and
     the absorbed-MLA decode pair (dense K6, paged K7: ragged lengths,
     length 0, inactive slots, sentinel tables, pages of 1-256 rows,
     4 heads and r + dr up to 1024, K7 bit for bit equal to K6 on an
     identity table, two calls bit-identical, and planted faults: a slot
     without one split must be rejected, and p without its third bf16
     term is rejected or its distance from the tolerance logged); the
     flash forward and dense decode also at Qwen2-7B's heads (28 over 4
     KV heads, a GQA group of 7), checked and timed (the gqa7_* keys);
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
     the greedy tokens must be identical;
 13. int8 replica: bench.py serve's first rung through the port's HTTP
     server (infer/server.py on 127.0.0.1): Llama-3-8B, int8 weights
     quantized on the card from the seeded bf16 init, int8 KV, 16 slots,
     max_target_len 2048, decode_steps 16; four prompts one at a time must
     give Orchestrator.generate's tokens on the same engine, then 32
     concurrent POST /generate of 512-token prompts, 128 new tokens each:
     every request whole, K4 only, /metrics counters equal to what
     was sent; tok/s, mean TTFT (/metrics), peak memory, weight bytes (K4
     only: 512-token prompts take the plain prefill attention, below the
     flash kernel's 1024, as in the reference);
 14. int4 replica: the same with int4 weights (bench.py's second rung);
 15. small quantized models: fp32 LLAMA_TINY and DEEPSEEK_TINY widths with
     int8 and int4 weights (Llama int8 also over an int8 KV cache),
     quantized on the card and on the CPU to the same bytes, greedy tokens
     on the card equal to the CPU's; at full width, the int8 and int4
     matmul ([16, 4096] x [4096, 14336]), the fp32-output LM head and the
     int8 expert product at DeepSeek-V2-Lite's widths against their plain
     form (dequantize to fp32, fp32 product), and the quantized embedding
     rows equal to the CPU's bit for bit;
 16. launch, checkpoint, resume: python -m skypilot_tpu_torch.train.launch
     (run in-process, so the launch counts stay readable) at phase 6's
     configuration (Llama-3-1B bf16, seq 8192, global batch 4, qkvo_gup,
     adafactor) over uint32 token shards written from a numpy seed and
     read by the native loader (g++ build): 6 steps uninterrupted; 3 steps
     with --checkpoint-every 3; then --steps 6 --resume auto on the same
     directory, which must log "Resumed from checkpoint step 3", run only
     steps 4-6 and give the uninterrupted run's losses within rel 1e-4;
     the metrics file has the reference's keys; tokens/s, the step loop's
     cost of a save, restore seconds, checkpoint bytes and the flight
     recorder's phase shares;
 17. LoRA: examples/tpu/lora_finetune_llama3.yaml on one card (Llama-3-8B
     bf16, rank 16, alpha 32, wq,wk,wv,wo, adamw, lr 1e-3, seq 8192,
     global batch 4 in 4 accumulated rows) for 4 steps on a repeated
     batch: loss finite and falling, the base bit-identical to its seeded
     init, the optimizer state adapter-sized only; tokens/s, model
     TFLOP/s, peak memory;
 18. the converter and the server's --hf-checkpoint: a random Llama-3-1B
     written in HF's layout (config.json + bf16 safetensors from numpy),
     converted (equal bit for bit to the tree built directly from the same
     tensors) and served by infer/server.py; the greedy tokens of three
     prompts (16, 300 and 1000 tokens) equal Orchestrator.generate on the
     directly built tree: K1 and K4 only;
 19. small checks, card vs CPU (fp32 LLAMA_TINY widths, seq 1024): the
     converter's fp32 and bf16 trees equal bit for bit; three launcher
     steps from one --init-params and --data, full and LoRA, give the
     same losses within phase 7's tolerance;
 20. Qwen3-8B replica: examples/tpu/serve_qwen.yaml's command without its
     speculative flags (phase 23 adds them) through infer/server.py on
     127.0.0.1: --model qwen3-8b --max-slots 32 --max-target-len 4096,
     bf16, random weights from a seeded generator; three prompts (16, 300
     and 1000 tokens) one at a time, then 32 concurrent prompts of
     1000-1024 tokens, 64 new tokens each: K1 and K4 only, counted from
     the served requests alone; the three served prompts' tokens equal
     Orchestrator.generate on the same engine; tok/s, mean TTFT
     (/metrics), peak memory;
 21. Qwen2-7B (28 query heads over 4 KV heads: GQA group 7, Q/K/V biases)
     served by InferenceEngine + Orchestrator: 16 slots, max_target_len
     2048, bucket 1024, 16 prompts of 1000-1024 tokens, 32 new tokens:
     K1 and K4 only, at group 7;
 22. small Qwen checks, card vs CPU: fp32 qwen-tiny and qwen3-tiny widths
     with random biases and norm scales, bucket 1024: the greedy tokens,
     a chunked prefill with a prefix-cache hit against the whole prompt
     in one 2048 bucket, and loss_fn with every gradient at seq 1024;
 23. serve_qwen.yaml as written: phase 20's replica with --spec-ngram
     --spec-gamma 4 (prompt-lookup speculation), phase 20's 32 prompts plus
     4 copy-heavy ones (a 64-token block 8 times) and one sampled request,
     so that plain rounds run too: two prompts one at a time give the
     speculator's own generate; K1 launches once per layer for each
     prompt in the 1024 bucket (admission is one at a time) and K4 once
     per layer per plain round, none in a verify round; every greedy
     stream equals plain greedy decoding on the same engine, or parts
     from it at a tie (the plain margin between the two tokens at most
     twice the largest logit difference of the decode and verify paths
     there); tok/s, mean TTFT, the spec counters of /metrics, acceptance
     and peak memory beside phase 20's;
 24. draft-model speculation: --model llama3-8b --draft-model llama3-1b
     is refused with the reference's ValueError (the repo's llama3-1b has
     a 32,768-token vocabulary); served instead through the HTTP handler
     as the server wires it: Llama-3-8B with a draft at llama3-1b's widths
     and Llama-3's vocabulary, 16 slots x 2048, 16 prompts of 960-1024
     tokens and one sampled request; the checks of phase 23, with K1 for
     both engines' prefills and K4 for the draft's 5 steps a speculative
     round and the target's plain rounds; then a Llama-3-1B self-draft
     (one engine, its own draft) must accept at least half its proposals;
 25. small speculative checks, card vs CPU: fp32 LLAMA_TINY and
     qwen3-tiny targets, bucket 1024: NgramSpeculator and
     SpeculativeOrchestrator (a one-layer draft, and the target drafting
     for itself) give plain greedy tokens and equal accept_stats on both;
     the self-draft accepts every proposal.
 26. Gemma2-9B replica: infer/server.py --model gemma2-9b --max-slots 8
     --max-target-len 8192 on 127.0.0.1, bf16, random weights from a
     seeded generator (head_dim 256, softcap 50, scale 1/16, a window of
     4096 on even layers, a tied soft-capped head); two prompts of
     6000-8000 tokens one at a time (prefilled in 1024-token chunks, then
     decoded over their even layers' live window alone), then 8 concurrent
     prompts of 1000-1024 tokens, 64 new tokens each: K1 = 42 layers x
     prefill waves in the 1024 bucket, K4 = 42 x decode steps, no other
     kernel; the long prompts' served tokens equal Orchestrator.generate
     on the same engine; tok/s, mean TTFT (/metrics), peak memory;
 27. small Gemma checks, card vs CPU: fp32 gemma-tiny, gemma2-tiny and
     gemma2-tiny at head_dim 256 (so K1 and K4 run at D 256 inside a
     model), random norms, bucket 1024: served greedy tokens,
     NgramSpeculator's tokens equal plain greedy, a chunked prefill with a
     prefix-cache hit against the whole prompt in one 2048 bucket; only K1
     and K4 on the card.
 28. Gemma2-2B training: python -m skypilot_tpu_torch.train.launch
     in-process, --model gemma2-2b --seq-len 8192 --global-batch-size 1
     --optimizer adafactor (bf16, random weights from the seeded init,
     head_dim 256, softcap 50, scale 1/16, a window of 4096 on even
     layers, the tied fp32 head) over uint32 token shards: 7 steps (2
     warm-up, 5 measured); 2 steps with --checkpoint-every 2, then
     --steps 4 --resume auto, whose losses must equal the uninterrupted
     run's within rel 1e-4; K1 = 2 x 26 layers x steps (the remat policy
     recomputes attention), K2 = K3 = 26 x steps, nothing else; tokens/s,
     model TFLOP/s and its share of 989, peak memory, the flight
     recorder's phase shares, and the fp32 head's forward and backward
     timed alone against a step;
 29. small Gemma training checks, card (kernels, TF32 off) vs CPU (plain
     versions): fp32 gemma-tiny, gemma2-tiny and gemma2-tiny at head_dim
     256, random norms, seq 1024: three Trainer steps each (adafactor,
     accum_steps=2) and three LoRA steps on the head_dim-256 config; the
     losses, grad norms and every parameter agree, the LoRA base stays
     bit-identical, and only K1-K3 run on the card.
Phase 3 also holds K1 at D 256 (Gemma's head dim: tile edges, Gemma2-9B's
wave of 8192 tokens with and without its window, Gemma-2B's and
Gemma-7B's heads, bf16 and fp32, timed), K2 and K3 at D 256 (tile edges
at GQA groups 1, 2 and 8 with segment ids, then B1 S8192 waves on
Gemma2-2B's and Gemma2-9B's heads with softcap 50, scale 1/16 and the
window of 4096 or none, and Gemma-2B's and Gemma-7B's heads, in bf16 and
fp32: checked, two runs bit-identical, timed beside the plain backward
and SDPA's), K4 at D 256 (8 slots x 8192, window 4096, softcap 50,
scale 1/16: bf16, fp32 and int8 caches, GQA groups 1, 2 and 8, timed)
and K5 at D 256; they land in the kernels line as the `d256` entries.
Phase 2 fails if a D 256 instantiation of the flash backward spills.
Before each main path (4, 6, 8a, 8b, 10, 11, 13, 14, each run of 16, 17,
18, 20, 21) every kernel's launch count is set to 0; just after, the
kernels of that path must each have run, and no other. Phases 23, 24
(and its self-draft), 26 and each run of 28 hold each kernel to the
count derived from the run's prefills, steps and rounds, every other
kernel to 0. A phase's first line says when it began.

The second-to-last lines are the kernels' JSON record and the
`nvidia-smi` name/power-limit line; the last line is
{"ok": true, "device": {...}}. Nothing of JAX is imported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import functools
import itertools
import json
import logging
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
# Flash outputs and gradients, kernel vs plain version, are also judged
# in each block of 64 rows of one head against the reference's own size
# there (flash_ops.gradient_errors): under a causal mask both shrink along
# the sequence (an output row's spread is about sqrt(e / pos)), so one
# absolute tolerance would pass a wrong later block. Limits on the
# blockwise relative error ||got-want||/||want|| and on the largest
# element error over the block's RMS. fp32 sums over up to S rows in
# another order. bf16 also rounds P and dS to bf16 before their products
# (as the Pallas kernels do) and the result on the way out. Over the
# cases below, on an H100, the kernels read at most 3.5e-3 and 5.7e-2 for
# bf16 outputs, 5.1e-3 and 8.2e-2 for bf16 gradients (the tile-edge cases
# at S 129 the largest), 8.4e-7 and 2.2e-5 for fp32 outputs, 1.1e-6 and
# 3.1e-5 for fp32 gradients; a 10 % error confined to some blocks reads
# 0.1 and above (the planted faults below).
BLOCK_NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
BLOCK_ELEM_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.15}

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


_START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's first line (it starts with '[') also says
    when the phase began, in seconds since the script started."""
    if msg.startswith('['):
        msg = f'{msg} (at {time.perf_counter() - _START:.1f} s)'
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over iters runs, by CUDA events. The
    device is first held busy (torch.cuda._sleep) for three times as long
    as the host takes to queue the runs, so the events bracket device
    work only, not the host's enqueue rate: a decode kernel takes less
    device time than its Python wrapper takes host time. Raises if the
    host did not finish queueing before the hold ran out."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    call_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_ms = 1.0 + 3 * iters * call_ms
    # Cycles at 2 GHz, above the card's clock: the hold lasts at least
    # hold_ms.
    torch.cuda._sleep(int(hold_ms * 2e6))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if queued_ms > hold_ms:
        raise AssertionError(f'timing: the host took {queued_ms:.2f} ms to '
                             f'queue {iters} runs, past the {hold_ms:.2f} ms '
                             'hold, so the events would include host time')
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 20) -> float:
    """Host time of one fn() call (checks, scratch, launch), the calls
    queued back to back without a synchronize in between."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return dt


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


def compare_blocks(name: str, got: torch.Tensor, want: torch.Tensor,
                   dtype, block_rows: int = 64) -> float:
    """A gradient or a forward output [B, S, H, D] against the plain
    version's, blockwise (see BLOCK_NORM_TOL) → its largest absolute
    error. A decode output [B, 1, H, D] is judged per (slot, head) with
    block_rows=1."""
    norm_err, elem_err = flash_ops.gradient_errors(got, want, block_rows)
    max_err = float((got.float() - want.float()).abs().max())
    log(f'  {name}: block rel err {norm_err:.3e} (limit '
        f'{BLOCK_NORM_TOL[dtype]:g}), element err / block rms '
        f'{elem_err:.3e} (limit {BLOCK_ELEM_TOL[dtype]:g}); mean |ref| '
        f'{float(want.float().abs().mean()):.3e}, max_abs_err '
        f'{max_err:.3e}')
    if not (norm_err <= BLOCK_NORM_TOL[dtype]
            and elem_err <= BLOCK_ELEM_TOL[dtype]):
        raise AssertionError(f'{name}: kernel disagrees with the plain '
                             f'version (block rel err {norm_err:.3e}, '
                             f'element err {elem_err:.3e})')
    return max_err


def expect_rejected(name: str, got: torch.Tensor, want: torch.Tensor,
                    dtype, block_rows: int = 64) -> None:
    """A planted fault must fail compare_blocks: the check can see it."""
    try:
        compare_blocks(f'planted fault, {name}', got, want, dtype,
                       block_rows)
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
    compare_blocks(f'flash {label} out', out, ref_out, dtype)
    compare(f'flash {label} lse', lse, ref_lse, torch.float32,
            atol=LSE_ATOL, rtol=0.0)
    return (q, k, v, seg, kw), err


# Tile edges of the wgmma kernels (128-row query blocks and key tiles in
# the forward, 128-key blocks and 64-row query tiles in dK/dV): each
# (S, GQA group, D) at B2 with 4 query heads, cycling through the mask
# variants.
EDGE_SHAPES = list(itertools.product((127, 129, 1000), (1, 2, 4), (64, 128)))
EDGE_VARIANTS = ({}, {'window': 100}, {'segments': True},
                 {'softcap': 30.0, 'scale': 0.1}, {'causal': False})


def edge_cases():
    for i, (s, groups, d) in enumerate(EDGE_SHAPES):
        kw = EDGE_VARIANTS[i % len(EDGE_VARIANTS)]
        tag = ' '.join(f'{k}={v}' for k, v in kw.items()) or 'causal'
        yield (f'bf16 edge S{s} H4/{4 // groups} D{d} {tag}',
               (2, s, 4, 4 // groups, d), kw)


def check_flash(gen) -> dict:
    log('[3] flash_fwd: kernel vs plain version')
    for label, shape, kw in edge_cases():
        flash_case(gen, label, torch.bfloat16, *shape, **kw)
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
    (q, k, v, _, kw), err = flash_case(
        gen, 'bf16 main-path B16 S1024 H32/8 D128', torch.bfloat16,
        16, 1024, 32, 8, 128)
    times = flash_timings('main-path', q, k, v, kw)
    del q, k, v
    gqa7 = flash_group7(gen)
    train = flash_train_shape(gen)
    gemma = flash_head_dim_256(gen)
    return {'name': 'flash_fwd', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
            'replaces': REPLACES['flash_fwd'], 'max_abs_err': err,
            **times, **gqa7, **train, 'd256': gemma}


def flash_timings(label, q, k, v, kw) -> dict:
    """Kernel, plain and SDPA (library) device times of one causal bf16
    forward at q's shape, beside its bound, and the wrapper's host time."""
    b, s, h, d = q.shape
    ms = time_ms(lambda: flash_ops._flash_fwd(q, k, v, None, **kw))
    # Host time of one wrapper call (checks, tensor maps, launch).
    wrapper_ms = host_ms(lambda: flash_ops._flash_fwd(q, k, v, None, **kw))
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
    bound, bound_by = bound_ms(nbytes, flops, q.dtype)
    log(f'  flash {label} timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, SDPA (library) {library_ms:.4f} ms, bound '
        f'{bound:.4f} ms ({bound_by}); {flops / ms / 1e9:.2f} TFLOP/s; '
        f'wrapper host time {wrapper_ms:.4f} ms a call')
    return {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': bound_by, 'library_ms': library_ms,
            'host_ms': wrapper_ms}


def flash_group7(gen) -> dict:
    """Qwen2-7B's heads, 28 query heads over 4 KV heads (a GQA group of
    7): B2 in bf16 and fp32 against the plain version, then phase [21]'s
    prefill wave (B16 S1024) against it and timed → the record's gqa7_*
    entries."""
    errs = []
    for dtype, name in ((torch.bfloat16, 'bf16'), (torch.float32, 'fp32')):
        errs.append(flash_case(gen, f'{name} B2 S1024 H28/4 D128 causal '
                               '(GQA group 7)', dtype, 2, 1024, 28, 4,
                               128)[1])
    (q, k, v, _, kw), err = flash_case(
        gen, 'bf16 B16 S1024 H28/4 D128 causal (GQA group 7, the wave of '
        '[21])', torch.bfloat16, 16, 1024, 28, 4, 128)
    times = flash_timings('GQA group 7 wave', q, k, v, kw)
    return {'gqa7_shape': 'B16 S1024 H28/4 D128 causal',
            'gqa7_max_abs_err': max(errs + [err]),
            **{f'gqa7_{key}': value for key, value in times.items()}}


def causal_pairs(s: int, window=None) -> int:
    """(query, key) pairs a causal attention over s rows computes: each
    row attends to itself and the keys before it, at most ``window``."""
    rows = np.arange(1, s + 1)
    return int((rows if window is None else np.minimum(rows, window)).sum())


# Gemma's head dim: K1 at Gemma2-9B's prefill wave (B1 S8192, 16 query
# heads over 8, softcap 50, scale 1/16, with the even layers' window of
# 4096 and without), in bf16 and fp32, and at Gemma-2B's (8 over 1) and
# Gemma-7B's (16 over 16) heads; first at the wgmma kernel's tile edges
# (64-key tiles at D 256).
D256_EDGES = list(itertools.product((127, 129, 1000), (1, 2, 8)))
D256_WAVES = (
    ('bf16 Gemma2-9B wave B1 S8192 H16/8 D256, window 4096', torch.bfloat16,
     16, 8, 4096, 50.0),
    ('bf16 Gemma2-9B wave B1 S8192 H16/8 D256, no window', torch.bfloat16,
     16, 8, None, 50.0),
    ('fp32 Gemma2-9B wave B1 S8192 H16/8 D256, window 4096', torch.float32,
     16, 8, 4096, 50.0),
    ('fp32 Gemma2-9B wave B1 S8192 H16/8 D256, no window', torch.float32,
     16, 8, None, 50.0),
    ('bf16 Gemma-2B wave B1 S8192 H8/1 D256', torch.bfloat16, 8, 1, None,
     None),
    ('bf16 Gemma-7B wave B1 S8192 H16/16 D256', torch.bfloat16, 16, 16,
     None, None))


def flash_head_dim_256(gen) -> list:
    """K1 at D 256 against its plain version: the tile edges, then each
    wave of D256_WAVES checked and timed beside its bound (the pairs its
    mask keeps) and SDPA's time at the same shapes without the softcap
    and the window (one PyTorch call takes neither) → one record each."""
    for i, (s, groups) in enumerate(D256_EDGES):
        kw = EDGE_VARIANTS[i % len(EDGE_VARIANTS)]
        tag = ' '.join(f'{k}={v}' for k, v in kw.items()) or 'causal'
        flash_case(gen, f'bf16 edge S{s} H8/{8 // groups} D256 {tag}',
                   torch.bfloat16, 2, s, 8, 8 // groups, 256, **kw)
    out = []
    for label, dtype, h, h_kv, window, softcap in D256_WAVES:
        b, s, d = 1, 8192, 256
        (q, k, v, _, kw), err = flash_case(
            gen, label, dtype, b, s, h, h_kv, d, window=window,
            softcap=softcap, scale=d ** -0.5)
        ms = time_ms(lambda: flash_ops._flash_fwd(q, k, v, None, **kw),
                     iters=5, warmup=1)
        plain_ms = time_ms(lambda: flash_ops.flash_attention_plain(
            q, k, v, window=window, logit_softcap=softcap,
            scale=d ** -0.5), iters=2, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True, scale=d ** -0.5),
            iters=5, warmup=1)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size(
        ) + b * h * s * 4
        flops = 4.0 * b * h * d * causal_pairs(s, window)
        bound, bound_by = bound_ms(nbytes, flops, dtype)
        log(f'  flash {label} timing: kernel {ms:.4f} ms, plain '
            f'{plain_ms:.4f} ms, SDPA (library, causal, no softcap or '
            f'window) {library_ms:.4f} ms, bound {bound:.4f} ms '
            f'({bound_by}); {flops / ms / 1e9:.2f} TFLOP/s')
        out.append({'shape': label, 'max_abs_err': err, 'ms': ms,
                    'plain_ms': plain_ms, 'bound_ms': bound,
                    'bound_by': bound_by, 'library_ms': library_ms,
                    'library': 'SDPA, causal, without softcap and window'})
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def flash_train_shape(gen) -> dict:
    """The forward at the training path's shape (B4 S8192 H16/8 D128,
    causal): batch row 0 against the plain version (which holds fp32
    [H, S, S] scores), then kernel, SDPA and bound times at B4."""
    dtype = torch.bfloat16
    b, s, h, h_kv, d = 4, 8192, 16, 8, 128
    q = rand(gen, (b, s, h, d), dtype)
    k, v = (rand(gen, (b, s, h_kv, d), dtype) for _ in range(2))
    out, lse = flash_ops._flash_fwd(q, k, v, None)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_ops.flash_attention_plain(
        *(t[:1].contiguous() for t in (q, k, v)))
    label = 'bf16 training shape B4 S8192 H16/8 D128 (row 0 vs plain)'
    err = compare(f'flash {label} out', out[:1], ref_out, dtype)
    compare_blocks(f'flash {label} out', out[:1], ref_out, dtype)
    compare(f'flash {label} lse', lse[:1], ref_lse, torch.float32,
            atol=LSE_ATOL, rtol=0.0)
    # The check must see a fault on the V side (a wrong V panel or ring
    # stage, a bad rescale) confined to the later rows, where the output
    # is smallest: the output 10 % low past row 4096. One absolute
    # tolerance cannot: its verdict is printed beside.
    bad_out = out[:1].clone()
    bad_out[:, s // 2:] *= 0.9
    loose = (bad_out.float() - ref_out.float()).abs() <= (
        ATOL[dtype] + RTOL[dtype] * ref_out.float().abs())
    log(f'  planted fault, out x 0.9 past row 4096: the absolute check '
        f'alone would {"pass" if bool(loose.all()) else "reject"} it')
    expect_rejected('out x 0.9 past row 4096', bad_out, ref_out, dtype)
    del out, lse, ref_out, ref_lse, bad_out, loose
    torch.cuda.empty_cache()
    ms = time_ms(lambda: flash_ops._flash_fwd(q, k, v, None), iters=5,
                 warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=5, warmup=1)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + (
        b * h * s * 4)
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)
    bound, bound_by = bound_ms(nbytes, flops, dtype)
    log(f'  flash training-shape timing: kernel {ms:.4f} ms, SDPA (library) '
        f'{library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); '
        f'{flops / ms / 1e9:.2f} TFLOP/s')
    return {'train_shape': 'B4 S8192 H16/8 D128 causal', 'train_ms': ms,
            'train_max_abs_err': err, 'train_bound_ms': bound,
            'train_library_ms': library_ms}


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
    errs = {'flash_bwd_dq': compare_blocks(f'bwd {label} dq', dq, ref[0],
                                         dtype)}
    errs['flash_bwd_dkv'] = max(
        compare_blocks(f'bwd {label} dk', dk, ref[1], dtype),
        compare_blocks(f'bwd {label} dv', dv, ref[2], dtype))
    return (q, k, v, seg, out, dout, lse, kw), errs


def check_flash_bwd(gen) -> dict:
    log('[3] flash backward (dK/dV, dQ): kernels vs plain version')
    for label, shape, kw in edge_cases():
        flash_bwd_case(gen, label, torch.bfloat16, *shape, **kw)
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
    errs = {'flash_bwd_dq': compare_blocks(f'bwd {label} dq', dq[:1], ref[0],
                                         dtype),
            'flash_bwd_dkv': max(
                compare_blocks(f'bwd {label} dk', dk[:1], ref[1], dtype),
                compare_blocks(f'bwd {label} dv', dv[:1], ref[2], dtype))}
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
    # Neither kernel has atomics: a second run gives the same bits.
    dk2, dv2 = flash_ops._flash_bwd_dkv(*args)
    dq2 = flash_ops._flash_bwd_dq(*args)
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError('flash_bwd_dkv: two runs on the same inputs '
                             'differ')
    if not torch.equal(dq, dq2):
        raise AssertionError('flash_bwd_dq: two runs on the same inputs '
                             'differ')
    log('  flash_bwd_dkv, flash_bwd_dq: two runs at the training shape '
        'bit-identical')
    del dk2, dv2, dq2
    plain_b1_ms = time_ms(lambda: flash_ops.flash_attention_bwd_plain(
        *row0), iters=2, warmup=1)
    torch.cuda.empty_cache()
    library, backend, _ = sdpa_backward(q, k, v, dout)
    # Kernels and the library in turn, three rounds.
    runs = {'flash_bwd_dq': [], 'flash_bwd_dkv': [], 'library': []}
    for _ in range(3):
        runs['flash_bwd_dq'].append(time_ms(
            lambda: flash_ops._flash_bwd_dq(*args), iters=5, warmup=1))
        runs['flash_bwd_dkv'].append(time_ms(
            lambda: flash_ops._flash_bwd_dkv(*args), iters=5, warmup=1))
        runs['library'].append(time_ms(library, iters=5, warmup=1))
    ms = {name: float(np.mean(t)) for name, t in runs.items()}
    library_ms = ms['library']
    log(f'  backward timings over three rounds (ms): {runs}')
    del library
    records = {}
    for name, (nbytes, flops) in flash_bwd_work(q, k, v, dout, lse).items():
        bound, bound_by = bound_ms(nbytes, flops, dtype)
        log(f'  {name} main-path timing: kernel {ms[name]:.4f} ms, bound '
            f'{bound:.4f} ms ({bound_by}); '
            f'{flops / ms[name] / 1e9:.2f} TFLOP/s')
        records[name] = {
            'name': name, 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/flash_bwd.cu',
            'replaces': REPLACES[name], 'max_abs_err': errs[name],
            'ms': ms[name], 'ms_rounds': runs[name],
            'library_ms_rounds': runs['library'], 'plain_ms': plain_b1_ms,
            'plain_shape': 'B1 (dq, dk and dv together)',
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms,
            'library_call': f'backward of F.scaled_dot_product_attention('
                            f'is_causal=True, enable_gqa=True) ({backend}): '
                            'dq, dk, dv'}
    log(f'  plain backward at B1 (dq, dk, dv together) {plain_b1_ms:.4f} '
        f'ms; SDPA backward ({backend}, B4) {library_ms:.4f} ms')
    gemma = flash_bwd_head_dim_256(gen)
    for name in records:
        records[name]['d256'] = gemma[name]
    return records


# Gemma's head dim in the backward: K2 and K3 at B1 S8192 on each Gemma's
# heads, softcap 50 and scale 1/16 on Gemma-2's with the even layers'
# window of 4096 and without (Gemma-1: neither softcap nor window), in
# bf16 and fp32; first at the tile edges (D256_EDGES: 64-key dK/dV blocks
# and 64-row query tiles, 128-row dQ blocks and 32-key tiles; 32-row
# tiles in fp32).
D256_BWD_WAVES = (
    ('Gemma2-2B H8/4, window 4096', 8, 4, 4096, 50.0),
    ('Gemma2-2B H8/4, no window', 8, 4, None, 50.0),
    ('Gemma2-9B H16/8, window 4096', 16, 8, 4096, 50.0),
    ('Gemma2-9B H16/8, no window', 16, 8, None, 50.0),
    ('Gemma-2B H8/1', 8, 1, None, None),
    ('Gemma-7B H16/16', 16, 16, None, None))


def flash_bwd_work(q, k, v, dout, lse, window=None) -> dict:
    """What K2 and K3 must do at these inputs, for their bounds: each input
    (q, k, v, out, dout, lse) read once and each output written once, and
    four products (S, dP, dV, dK) or three (S, dP, dQ) over the pairs the
    mask keeps → {kernel name: (bytes, operations)}."""
    b, s, h, d = q.shape
    elem = q.element_size()
    inputs = (2 * q.numel() + k.numel() + v.numel() + dout.numel()) * elem \
        + lse.numel() * 4
    product = 2.0 * b * h * d * causal_pairs(s, window)
    return {'flash_bwd_dkv': (inputs + (k.numel() + v.numel()) * elem,
                              4 * product),
            'flash_bwd_dq': (inputs + q.numel() * elem, 3 * product)}


def sdpa_backward(q, k, v, dout):
    """The backward of one causal SDPA call at these shapes (dq, dk and
    dv; no softcap or window, which no one PyTorch call takes): each of
    PyTorch's fused backends that takes them is timed and the fastest
    kept; where none does, its math backend (which holds the S x S
    scores: 2.1 GB a copy in fp32 at B1 H8 S8192) → (a function that runs
    it, backend name, ms). A yardstick only: the port never calls it."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dout_t = dout.transpose(1, 2)
    best = None
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        if backend == SDPBackend.MATH and best is not None:
            break
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter('ignore')   # why a backend declines
                out = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True,
                    scale=q.shape[-1] ** -0.5)
            run = functools.partial(torch.autograd.grad, out, (qt, kt, vt),
                                    dout_t, retain_graph=True)
            ms = time_ms(run, iters=3, warmup=1)
        except RuntimeError:   # this backend does not take these shapes
            if backend == SDPBackend.MATH:
                raise
            continue
        if best is None or ms < best[2]:
            best = (run, backend.name, ms)
        del out, run
    return best


def flash_bwd_head_dim_256(gen) -> dict:
    """K2 and K3 at D 256 against the plain backward: the tile edges in
    bf16 and fp32, then each wave of D256_BWD_WAVES in both, checked and
    timed beside its bound (the pairs its mask keeps), the plain backward
    (dq, dk and dv together) and SDPA's backward → {kernel name: one
    record per wave}."""
    for dtype, name in ((torch.bfloat16, 'bf16'), (torch.float32, 'fp32')):
        for i, (s, groups) in enumerate(D256_EDGES):
            kw = EDGE_VARIANTS[i % len(EDGE_VARIANTS)]
            tag = ' '.join(f'{k}={v}' for k, v in kw.items()) or 'causal'
            flash_bwd_case(gen, f'{name} edge S{s} H8/{8 // groups} D256 '
                           f'{tag}', dtype, 2, s, 8, 8 // groups, 256, **kw)
    out = {'flash_bwd_dkv': [], 'flash_bwd_dq': []}
    b, s, d = 1, 8192, 256
    for dtype, name in ((torch.bfloat16, 'bf16'), (torch.float32, 'fp32')):
        for wave, h, h_kv, window, softcap in D256_BWD_WAVES:
            label = f'{name} B1 S8192 D256 {wave}' + (
                ', softcap 50' if softcap else '')
            (q, k, v, _, o, dout, lse, kw), errs = flash_bwd_case(
                gen, label, dtype, b, s, h, h_kv, d, window=window,
                softcap=softcap, scale=d ** -0.5)
            args = (q, k, v, None, o, dout, lse)
            first = flash_ops._flash_bwd(*args, **kw)
            if not all(torch.equal(x, y) for x, y in zip(
                    first, flash_ops._flash_bwd(*args, **kw))):
                raise AssertionError(f'{label}: two backward runs differ')
            del first
            ms = {'flash_bwd_dkv': time_ms(lambda: flash_ops._flash_bwd_dkv(
                      *args, **kw), iters=3, warmup=1),
                  'flash_bwd_dq': time_ms(lambda: flash_ops._flash_bwd_dq(
                      *args, **kw), iters=3, warmup=1)}
            plain_ms = time_ms(lambda: flash_ops.flash_attention_bwd_plain(
                q, k, v, o, dout, lse, window=window, logit_softcap=softcap,
                scale=d ** -0.5), iters=1, warmup=1)
            library = sdpa_backward(q, k, v, dout)
            backend, library_ms = library[1:]
            del library
            torch.cuda.empty_cache()
            work = flash_bwd_work(q, k, v, dout, lse, window)
            line = []
            for kname, (nbytes, flops) in work.items():
                bound, bound_by = bound_ms(nbytes, flops, dtype)
                out[kname].append({
                    'shape': label, 'max_abs_err': errs[kname],
                    'ms': ms[kname], 'plain_ms': plain_ms,
                    'plain_shape': 'dq, dk and dv together',
                    'bound_ms': bound, 'bound_by': bound_by,
                    'library_ms': library_ms,
                    'library': f'SDPA backward ({backend}), causal, without '
                               'softcap and window: dq, dk, dv'})
                line.append(f'{kname} {ms[kname]:.4f} ms (bound {bound:.4f},'
                            f' {bound_by}; {flops / ms[kname] / 1e9:.2f} '
                            'TFLOP/s)')
            log(f'  {label} timing: {", ".join(line)}; plain (dq, dk, dv) '
                f'{plain_ms:.4f} ms; SDPA backward ({backend}, causal, no '
                f'softcap or window) {library_ms:.4f} ms; two runs '
                'bit-identical')
            del q, k, v, o, dout, lse, args
            torch.cuda.empty_cache()
    return out


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
    # Also per (slot, head) against the reference's own size there: an
    # output averaged over ~1000 rows is small, and one absolute tolerance
    # would pass a lost split (the planted fault in check_decode).
    compare_blocks(f'decode {label}', out, ref, q_dtype, block_rows=1)
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


def without_split(q, k, v, lens, slot: int, split: int) -> torch.Tensor:
    """What a combine that lost one split's partial state gives for one
    slot of a bf16 cache: the plain attention over the slot's live rows
    less the split's SPLIT_ROWS rows → [1, H, D]."""
    _, _, h, d = q.shape
    h_kv = k.shape[2]
    rows = decode_ops.SPLIT_ROWS
    keep = torch.arange(k.shape[1], device='cuda') < int(lens[slot])
    keep[split * rows:(split + 1) * rows] = False
    qg = q[slot, 0].float().reshape(h_kv, h // h_kv, d)
    s = torch.einsum('hgd,khd->hgk', qg, k[slot].float()) * d ** -0.5
    p = torch.softmax(s.masked_fill(~keep, -torch.inf), dim=-1)
    out = torch.einsum('hgk,khd->hgd', p, v[slot].float())
    return out.reshape(1, h, d).to(q.dtype)


def check_decode(gen) -> dict:
    log('[3] decode_attention: kernel vs plain version')
    ragged = [0, 1, 255, 256, 257, 2048, 2100, 7, 1000, 1500, 31, 64,
              513, 777, 1999, 128]
    # The split-KV walk's edges (splits of SPLIT_ROWS = 128 rows): one
    # split exactly and one split +- 1, two splits +- 1, max_len and one
    # past it, length 0 twice; under window=100 most of these start their
    # window inside a split.
    edges = [128, 127, 129, 0, 256, 255, 257, 2048, 2049, 0, 1, 384, 130,
             2047, 1100, 1025]
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
    decode_case(gen, 'bf16 cache, split edges', bf16, bf16, edges)
    decode_case(gen, 'bf16 window=100, split edges', bf16, bf16, edges,
                window=100)
    decode_case(gen, 'int8 pair (bf16 q), split edges', bf16, torch.int8,
                edges)
    decode_case(gen, 'int8 pair window=100, split edges', bf16, torch.int8,
                edges, window=100)
    decode_case(gen, 'fp32 cache, split edges', fp32, fp32, edges)
    decode_case(gen, 'fp32 cache window=100, split edges', fp32, fp32,
                edges, window=100)
    decode_case(gen, 'fp32 D16 G2, split edges', fp32, fp32,
                [0, 127, 128, 129, 1040, 256], b=6, max_len=1040, h=4,
                h_kv=2, d=16)
    decode_case(gen, 'fp32 D16 G2 window=100, split edges', fp32, fp32,
                [0, 127, 128, 129, 1040, 257], b=6, max_len=1040, h=4,
                h_kv=2, d=16, window=100)
    # The main path's decode steps: 16 slots holding ~1000-token
    # prompts plus up to 64 generated tokens.
    rng = np.random.default_rng(1)
    lengths = [int(x) for x in rng.integers(990, 1065, 16)]
    cases = [decode_case(gen, 'bf16 main-path lengths', bf16, bf16,
                         lengths) for _ in range(4)]
    (_, _, _, lens, kw), err = cases[0]
    # The check must see one split's partial state lost (slot 3, rows
    # 128-255): the whole output of the case, that slot recomputed without
    # them.
    q, k, v, _, _ = cases[0][0]
    out = decode_ops.decode_attention(q, k, v, lens)
    ref = decode_ops.decode_attention_plain(q, k, v, lens)
    bad = out.clone()
    bad[3] = without_split(q, k, v, lens, 3, 1)
    loose = (bad.float() - ref.float()).abs() <= (
        ATOL[bf16] + RTOL[bf16] * ref.float().abs())
    log(f'  planted fault, slot 3 without split 1: the absolute check alone '
        f'would {"pass" if bool(loose.all()) else "reject"} it')
    expect_rejected('decode slot 3 without split 1', bad, ref, bf16,
                    block_rows=1)
    del out, ref, bad, loose
    times = decode_timings('main-path', cases)
    del cases
    gqa7 = decode_group7(gen)
    gemma = decode_head_dim_256(gen)
    return {'name': 'decode_attention', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/decode_attention.cu',
            'replaces': REPLACES['decode_attention'], 'max_abs_err': err,
            **times, **gqa7, 'd256': gemma}


def decode_timings(label, cases) -> dict:
    """Kernel and masked-SDPA (library) device times over three rounds in
    turn, the plain version's, the bound and the wrapper's host time, for
    decode cases of one shape and one set of options, launched in turn.
    The library call masks what the kernel's window masks and scales as
    it does, without its softcap (SDPA takes none); over an int8 cache
    there is no one library call (library_ms None)."""
    # Rotate over the caches (4 x 134 MB at 16 slots x 2048 rows) so that
    # no launch finds its K/V in the 50 MB L2, as each layer's cache is
    # cold on the path.
    it = itertools.count()

    def case():
        return cases[next(it) % len(cases)][0]

    def run_kernel():
        q, k, v, ln, kw = case()
        decode_ops.decode_attention(q, k, v, ln, **kw)

    def run_plain():
        q, k, v, ln, kw = case()
        decode_ops.decode_attention_plain(q, k, v, ln, **kw)

    def run_library():
        q, k, v, ln, kw = case()
        pos = torch.arange(k.shape[1], device='cuda')[None, :]
        length = ln[:, None].long()
        mask = pos < length
        if kw['window'] is not None:
            mask &= pos >= length - kw['window']
        F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :], enable_gqa=True,
            scale=kw['scale'])

    q, k, _, lens, kw = cases[0][0]
    quantized = isinstance(k, tuple)
    # Kernel and library in turn, three rounds.
    rounds = {'kernel': [], 'library': []}
    for _ in range(3):
        rounds['kernel'].append(time_ms(run_kernel, iters=40, warmup=4))
        if not quantized:
            rounds['library'].append(time_ms(run_library, iters=20,
                                             warmup=4))
    ms = float(np.mean(rounds['kernel']))
    library_ms = None if quantized else float(np.mean(rounds['library']))
    plain_ms = time_ms(run_plain, iters=8, warmup=2)
    wrapper_ms = host_ms(run_kernel)
    log(f'  decode {label} timings over three rounds (ms): {rounds}; '
        f'wrapper host time {wrapper_ms:.4f} ms a call')
    b, _, h, d = q.shape
    values = k[0] if quantized else k
    h_kv, max_len = values.shape[2], values.shape[1]
    length = lens.clamp(0, max_len)
    first = (length - kw['window']).clamp(min=0) if kw['window'] else 0
    live = int((length - first).sum())
    row_bytes = h_kv * (d * values.element_size() + (4 if quantized else 0))
    nbytes = 2 * q.numel() * q.element_size() + 4 * b + 2 * live * row_bytes
    flops = 4.0 * live * h * d
    bound, bound_by = bound_ms(nbytes, flops, torch.bfloat16)
    library = ('none (int8 cache)' if quantized else
               f'masked SDPA{" (no softcap)" if kw["logit_softcap"] else ""}')
    log(f'  decode {label} timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, {library} (library) {library_ms} ms, '
        f'bound {bound:.4f} ms ({bound_by}); '
        f'{nbytes / ms / 1e6:.1f} GB/s of live KV')
    return {'ms': ms, 'ms_rounds': rounds['kernel'], 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms,
            'library_ms_rounds': rounds['library'], 'host_ms': wrapper_ms}


# Gemma's decode step at D 256: 8 slots over an 8192-row cache (phase
# [26]'s replica), lengths 4500-8100 under the even layers' window of
# 4096 with softcap 50 and scale 1/16; Gemma2-9B's heads (16 over 8) over
# bf16, fp32 and int8 caches, and Gemma-7B's (16 over 16, group 1) and
# Gemma-2B's (8 over 1, group 8) over bf16.
D256_DECODE = (('bf16 cache', torch.bfloat16, torch.bfloat16, 16, 8),
               ('fp32 cache', torch.float32, torch.float32, 16, 8),
               ('int8 pair (bf16 q)', torch.bfloat16, torch.int8, 16, 8),
               ('bf16 cache, group 1 (Gemma-7B heads)', torch.bfloat16,
                torch.bfloat16, 16, 16),
               ('bf16 cache, group 8 (Gemma-2B heads)', torch.bfloat16,
                torch.bfloat16, 8, 1))


def decode_head_dim_256(gen) -> list:
    """K4 at D 256 against its plain version, each case of D256_DECODE
    over two caches, then timed beside its bound → one record each."""
    rng = np.random.default_rng(26)
    lengths = [int(x) for x in rng.integers(4500, 8101, 8)]
    out = []
    for label, q_dtype, kv_dtype, h, h_kv in D256_DECODE:
        full = f'{label} 8 slots x 8192 H{h}/{h_kv} D256 window 4096'
        cases = [decode_case(gen, full, q_dtype, kv_dtype, lengths, b=8,
                             max_len=8192, h=h, h_kv=h_kv, d=256,
                             window=4096, softcap=50.0, scale=1 / 16)
                 for _ in range(2)]
        times = decode_timings(full, cases)
        out.append({'shape': full, 'lengths': lengths,
                    'max_abs_err': max(err for _, err in cases), **times})
        del cases
        torch.cuda.empty_cache()
    return out


def decode_group7(gen) -> dict:
    """Qwen2-7B's decode step: 16 slots over a 2048-row cache, 28 query
    heads over 4 KV heads (a GQA group of 7, which the walk for groups of
    up to 8 takes with one idle head), ragged lengths around 1000 and one
    empty slot, in bf16 and fp32 against the plain version; the bf16 case
    timed → the record's gqa7_* entries."""
    rng = np.random.default_rng(7)
    lengths = [0] + [int(x) for x in rng.integers(990, 1060, 15)]
    shape = dict(h=28, h_kv=4, d=128)
    errs = [decode_case(gen, 'fp32 cache, GQA group 7 (H28/4 D128)',
                        torch.float32, torch.float32, lengths, **shape)[1]]
    cases = [decode_case(gen, 'bf16 cache, GQA group 7 (H28/4 D128)',
                         torch.bfloat16, torch.bfloat16, lengths, **shape)
             for _ in range(4)]
    errs += [err for _, err in cases]
    times = decode_timings('GQA group 7', cases)
    return {'gqa7_shape': 'B16 K2048 H28/4 D128, lengths 0 and 990-1059',
            'gqa7_max_abs_err': max(errs),
            **{f'gqa7_{key}': value for key, value in times.items()}}


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
    # D 256 through K4's walk (Gemma's width; Gemma has no paged engine).
    d256 = max(paged_case(
        gen, f'{name} page 16, H16/8 D256 softcap=50 scale=1/16', dtype,
        dtype, [0, 1, 17, 300, 4000, 1000], [16, 1, 17, 300, 4000, 1000],
        num_pages=1024, page=16, nblk=256, h=16, h_kv=8, d=256,
        softcap=50.0, scale=1 / 16)[1]
        for name, dtype in (('bf16', bf16), ('fp32', fp32)))
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
            'library_ms': library_ms, 'ms_at_most_1100_rows': even_ms,
            'd256_max_abs_err': d256}


# ---- phase 3: the MLA decode kernels (K6 dense, K7 paged) ----

# DeepSeek-V2-Lite's MLA widths: 16 heads, latent rank 512, RoPE key 64;
# the absorbed step's scale is (qk_nope + qk_rope) ** -0.5.
MLA_H, MLA_R, MLA_DR = 16, 512, 64
MLA_SCALE = 192 ** -0.5
# bf16 terms of each fp32 operand that is not from the cache (q and p) in
# the kernels' tensor-core walk over a bf16 cache.
MLA_TERMS = 3


def mla_inputs(gen, b, h=MLA_H, r=MLA_R, dr=MLA_DR):
    return rand(gen, (b, h, r), torch.float32), rand(gen, (b, h, dr),
                                                     torch.float32)


def mla_case(gen, label, kv_dtype, lengths, max_len=2048, h=MLA_H,
             r=MLA_R, dr=MLA_DR, check=True):
    """K6 vs its plain version. Both compute in fp32 and differ only by
    summation order (over a bf16 cache the kernel's three-term products
    are the fp32 products), so the fp32 tolerance holds for a bf16 cache
    too."""
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
    """(bound ms, what bounds it, bytes, products): each input read once
    (queries fp32, the live cache rows in the cache's type), the fp32
    output written once; the products at the bf16 tensor-core peak,
    counted MLA_TERMS times: over a bf16 cache the kernels keep the math
    fp32 by splitting q and p into three bf16 terms
    (csrc/mla_common.cuh), so each fp32 product costs three bf16 ones."""
    b, h, r = q_eff.shape
    dr = q_rope.shape[-1]
    nbytes = ((q_eff.numel() + q_rope.numel() + b * h * r) * 4 + 4 * b +
              live * (r + dr) * elem + extra_bytes)
    flops = 2.0 * live * h * ((r + dr) + r) * MLA_TERMS
    return bound_ms(nbytes, flops, torch.bfloat16) + (nbytes, flops)


def mla_faulty(q_eff, q_rope, ckv, krope, lens, slot, drop_split=None,
               p_terms=MLA_TERMS):
    """One slot's output [H, r] over its live rows as a faulty kernel
    would give it: without the rows of split `drop_split` (a partial lost
    in the merge), or with each probability cut to its first `p_terms`
    bf16 terms (the kernel's split of p)."""
    keep = torch.arange(int(lens[slot]), device='cuda')
    if drop_split is not None:
        keep = keep[keep // mla_ops.SPLIT_ROWS != drop_split]
    c, k = ckv[slot, keep].float(), krope[slot, keep].float()
    s = (q_eff[slot] @ c.T + q_rope[slot] @ k.T) * MLA_SCALE
    e = torch.exp(s - s.max(dim=1, keepdim=True).values)
    p = sum(t.float() for t in mla_ops.bf16_terms(e, p_terms))
    return (p @ c) / e.sum(dim=1, keepdim=True)


def mla_planted_faults(name, out, ref, dense, slot) -> None:
    """The unchanged fp32 comparison must reject `slot` without its split
    1; p without its lo term is rejected, or the log says by how much it
    stays inside the tolerance."""
    bad = out.clone()
    bad[slot] = mla_faulty(*dense, slot, drop_split=1)
    try:
        compare(f'planted fault, {name} slot {slot} without split 1', bad,
                ref, torch.float32)
    except AssertionError:
        log('    rejected, as it must be')
    else:
        raise AssertionError(f'the {name} check passed a slot without one '
                             'split')
    lens = dense[-1]
    two = torch.stack([mla_faulty(*dense, i, p_terms=MLA_TERMS - 1)
                       if int(lens[i]) else ref[i]
                       for i in range(len(lens))])
    err = float((two - ref).abs().max())
    atol = ATOL[torch.float32]
    if err > atol:
        log(f'  planted fault, {name} without p\'s lo term: max_abs_err '
            f'{err:.3e}, rejected')
    else:
        log(f'  planted fault, {name} without p\'s lo term: max_abs_err '
            f'{err:.3e}, inside the fp32 tolerance {atol:g} by '
            f'{atol / err:.1f}x: the comparison cannot see it')


def mla_repeat(name, fn) -> None:
    """Two calls on the same inputs give the same bits: the combine merges
    a slot's splits in split order, whichever split ended last."""
    first, again = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError(f'{name}: two calls on the same inputs differ')
    log(f'  {name}: two calls on the same inputs, bit for bit equal')


def check_mla_decode(gen) -> dict:
    log('[3] mla_decode (K6): kernel vs plain version')
    bf16, fp32 = torch.bfloat16, torch.float32
    max_len = 2048
    ragged = [1, 255, 256, 257, max_len, 0, max_len + 1, 1000]
    errs = [mla_case(gen, f'{name} cache, lengths 1/255/256/257/K, length '
                     '0, inactive K+1', dtype, ragged)[1]
            for dtype, name in ((bf16, 'bf16'), (fp32, 'fp32'))]
    tiny = [0, 1, 31, 33, 127, 129, 300]
    errs += [mla_case(gen, f'{name} cache, DEEPSEEK_TINY widths (4 of 16 '
                      'heads, 40 of 48 columns)', dtype, tiny, max_len=300,
                      h=4, r=32, dr=8)[1]
             for dtype, name in ((bf16, 'bf16'), (fp32, 'fp32'))]
    errs.append(mla_case(gen, 'bf16 cache, r + dr = 1024 (a one-stage ring)',
                         bf16, [0, 1, 129, 1000, max_len], dr=512)[1])
    rng = np.random.default_rng(10)
    lengths = [int(x) for x in rng.integers(990, 1065, 16)]
    errs.append(mla_case(gen, 'fp32 main-path lengths', fp32, lengths)[1])
    # The main path's decode steps: 16 slots, bf16 cache. Four caches in
    # turn (4 x 38 MB): no launch finds its rows in the 50 MB L2.
    cases = [mla_case(gen, 'bf16 main-path lengths', bf16, lengths,
                      check=i == 0) for i in range(4)]
    err = cases[0][1]
    errs.append(err)
    log(f'  largest mla decode error over these {len(errs)} cases: '
        f'{max(errs):.3e} (fp32 tolerance {ATOL[fp32]:g})')
    dense = cases[0][0]
    out = mla_ops.mla_decode_attention(*dense, MLA_SCALE)
    ref = mla_ops.mla_decode_attention_plain(*dense, MLA_SCALE)
    mla_planted_faults('mla decode', out, ref, dense, slot=3)
    mla_repeat('mla decode (bf16, main-path lengths)',
               lambda: mla_ops.mla_decode_attention(*dense, MLA_SCALE))
    del out, ref
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
        f'bound {bound:.4f} ms ({bound_by}; bf16 cache bytes, products x'
        f'{MLA_TERMS} at the bf16 peak); {live} live rows, '
        f'{nbytes / ms / 1e6:.1f} GB/s, {flops / ms / 1e9:.2f} TFLOP/s bf16')
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
    errs = [paged_mla_case(gen, f'{name} arena, ragged lengths', dtype,
                           ragged, held)[1]
            for dtype, name in ((bf16, 'bf16'), (fp32, 'fp32'))]
    errs += [paged_mla_case(gen, f'{name} page 8, DEEPSEEK_TINY widths',
                            dtype, [0, 1, 8, 9, 65, 64, 30],
                            [8, 1, 8, 9, 0, 64, 30], num_pages=40, page=8,
                            nblk=8, h=4, r=32, dr=8)[1]
             for dtype, name in ((bf16, 'bf16'), (fp32, 'fp32'))]
    # Pages of one row and of 256 rows (one bulk copy a row either way).
    errs.append(paged_mla_case(gen, 'bf16 page 1', bf16, [0, 1, 2, 129, 640],
                               [1, 1, 2, 129, 640], num_pages=4096, page=1,
                               nblk=640)[1])
    errs.append(paged_mla_case(gen, 'bf16 page 256', bf16, [0, 300, 1025, 256],
                               [256, 300, 1025, 256], num_pages=24, page=256,
                               nblk=5)[1])
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
    errs.append(paged_mla_case(gen, 'fp32 main-path lengths', fp32,
                               lengths)[1])
    cases = [paged_mla_case(gen, 'bf16 main-path lengths', bf16, lengths,
                            check=i == 0) for i in range(3)]
    err = cases[0][1]
    errs.append(err)
    log(f'  largest paged mla decode error over these {len(errs)} cases: '
        f'{max(errs):.3e} (fp32 tolerance {ATOL[fp32]:g})')
    paged = cases[0][0]
    q_eff, q_rope, ckv, krope, lens, tables = paged
    safe = tables.long().clamp(0, ckv.shape[0] - 1)
    dense = (q_eff, q_rope, ckv[safe].reshape(len(lens), -1, MLA_R),
             krope[safe].reshape(len(lens), -1, MLA_DR), lens)
    out = mla_ops.paged_mla_decode_attention(*paged, MLA_SCALE)
    ref = mla_ops.paged_mla_decode_attention_plain(*paged, MLA_SCALE)
    mla_planted_faults('paged mla decode', out, ref, dense, slot=5)
    mla_repeat('paged mla decode (bf16, main-path lengths)',
               lambda: mla_ops.paged_mla_decode_attention(*paged, MLA_SCALE))
    del out, ref, dense, safe
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
        f'bytes, products x{MLA_TERMS} at the bf16 peak); {live} live rows, '
        f'{nbytes / ms / 1e6:.1f} GB/s, {flops / ms / 1e9:.2f} TFLOP/s bf16')
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

def train_main_path(records: dict) -> dict:
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
    return result


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


# ---- phases 13 and 14: quantized replicas through the HTTP server ----

# bench.py serve's first two rungs: Llama-3-8B with int8, then int4
# weights and an int8 KV cache; 16 slots, max_target_len 2048, prompts of
# 512 tokens ((i * 7 + j) % vocab), 128 new tokens each, decode fused 16
# steps a tick; 32 requests. The path's kernel is K4 alone: a 512-token
# prompt takes the plain prefill attention, as the reference's dispatch
# sends every sequence below 1024 to its XLA path (ops/attention.py
# _FLASH_MIN_SEQ in both packages).
QUANT_SERVE_KERNELS = ('decode_attention',)
RUNG = dict(slots=16, max_len=2048, requests=32, prompt_len=512,
            new_tokens=128, decode_steps=16)


def http_json(url: str, path: str, body=None, timeout: float = 600.0):
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        text = resp.read().decode()
    return json.loads(text) if body is not None else text


def concurrent_generate(url: str, bodies, vocab: int):
    """POST /generate every body at once, each whole → (streams, s)."""
    import threading
    results = [None] * len(bodies)

    def client(i):
        try:
            results[i] = http_json(url, '/generate', bodies[i])
        except Exception as e:  # pylint: disable=broad-except
            results[i] = e

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    dt = time.perf_counter() - t0
    for i, res in enumerate(results):
        if not isinstance(res, dict) or len(res['output_tokens']) != \
                bodies[i]['max_new_tokens'] or not all(
                0 <= t < vocab for t in res['output_tokens']):
            raise AssertionError(f'request {i}: {str(res)[:300]}')
    return [res['output_tokens'] for res in results], dt


def metric(text: str, name: str) -> float:
    """The value of an unlabelled (or the one labelled) series."""
    for line in text.splitlines():
        if line.startswith(name) and not line.startswith('#'):
            return float(line.rsplit(' ', 1)[1])
    raise AssertionError(f'{name} missing from /metrics:\n{text[:2000]}')


def quantized_replica(records: dict, bits: str) -> None:
    import threading
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import quantization as qops
    phase = {'int8': 13, 'int4': 14}[bits]
    cfg = llama.LLAMA3_8B
    r = RUNG
    log(f'[{phase}] {bits} replica: Llama-3-8B ({cfg.n_layers} layers, '
        f'public widths) with {bits} weights quantized on the card from the '
        f'seeded bf16 init, int8 KV; {r["slots"]} slots, max_target_len '
        f'{r["max_len"]}, decode_steps {r["decode_steps"]}; the port\'s '
        'infer/server.py on 127.0.0.1')
    t0 = time.perf_counter()
    replica = server_lib.build_replica(server_lib.parse_args([
        '--model', 'llama3-8b', '--weight-dtype', bits, '--kv-dtype', 'int8',
        '--max-slots', str(r['slots']), '--max-target-len', str(r['max_len']),
        '--decode-steps', str(r['decode_steps']), '--port', '0']),
        host='127.0.0.1')
    torch.cuda.synchronize()
    nbytes = qops.params_nbytes(replica.engine.params)
    log(f'  init + quantize + engine + warm-up {time.perf_counter() - t0:.2f}'
        f' s; weights {nbytes / 1e9:.3f} GB (params_nbytes), '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    try:
        if json.loads(http_json(url, '/health'))['status'] != 'healthy':
            raise AssertionError('/health did not answer healthy')
        vocab = cfg.vocab_size
        prompts = [[(i * 7 + j) % vocab for j in range(r['prompt_len'])]
                   for i in range(r['requests'])]
        # The server adds nothing: the first four prompts, one at a time
        # (a wave of one, then decode), give the tokens of
        # Orchestrator.generate on the same engine, run with the serving
        # loop held.
        t0 = time.perf_counter()
        for i, p in enumerate(prompts[:4]):
            served = http_json(url, '/generate', {
                'prompt_tokens': p, 'max_new_tokens': r['new_tokens']})
            with replica.loop._lock:
                direct = replica.loop.orch.generate(
                    [p], max_new_tokens=r['new_tokens'])[0]
            if served['output_tokens'] != direct:
                raise AssertionError(f'request {i}: the server gave other '
                                     'tokens than Orchestrator.generate')
        log(f'  four requests one at a time ({time.perf_counter() - t0:.2f} '
            's with their direct runs): the server\'s tokens equal '
            'Orchestrator.generate on the same engine')
        before = http_json(url, '/metrics')
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        _, dt = concurrent_generate(url, [
            {'prompt_tokens': p, 'max_new_tokens': r['new_tokens']}
            for p in prompts], vocab)
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        after = http_json(url, '/metrics')
        check_launches(f'{bits} replica', launches, QUANT_SERVE_KERNELS,
                       cfg.n_layers)
        for name in QUANT_SERVE_KERNELS:
            records[name].setdefault('launches_by_path', {})[
                f'serve_{bits}'] = launches[name]
        n_req = 4 + r['requests']
        want = {'xsky_serve_requests_total{endpoint="/generate",'
                'outcome="ok"}': n_req,
                'xsky_serve_prompt_tokens_total': n_req * r['prompt_len'],
                'xsky_serve_generated_tokens_total':
                    n_req * r['new_tokens']}
        got = {name: metric(after, name) for name in want}
        if got != want:
            raise AssertionError(f'/metrics counters {got}, sent {want}')
        ttft_n = (metric(after, 'xsky_serve_ttft_seconds_count')
                  - metric(before, 'xsky_serve_ttft_seconds_count'))
        ttft_s = (metric(after, 'xsky_serve_ttft_seconds_sum')
                  - metric(before, 'xsky_serve_ttft_seconds_sum'))
        if ttft_n != r['requests']:
            raise AssertionError(f'{ttft_n} TTFT samples for '
                                 f'{r["requests"]} requests')
        out_tokens = r['requests'] * r['new_tokens']
        log(f'  {r["requests"]} concurrent POST /generate x '
            f'{r["new_tokens"]} tokens in {dt:.3f} s: '
            f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
            f'{ttft_s / ttft_n * 1e3:.1f} ms (/metrics), peak memory '
            f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, weights '
            f'{nbytes} bytes; /metrics counters equal what was sent; '
            f'launches {launches} on {nvidia_smi_line()}')
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()
    del replica
    release_card()


# ---- phase 15: small quantized models card vs CPU, full-width ops ----

# The quantized forms round to bf16 where the plain form (dequantize to
# fp32, fp32 product) does not: the int8 product and its scale (int8),
# each dequantized weight (int4), at 2^-9 relative each. Against the
# largest |output|, with the same relative bound per element.
QUANT_RTOL = 2.0 ** -7
QUANT_ATOL_OF_MAX = 2.0 ** -7
# fp32 outputs (the fp32 LM head, the fp32 expert gate): exact products
# summed in fp32 in another order.
QUANT_FP32_ATOL_OF_MAX = 1e-5


def small_quantized_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import deepseek
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import quantization as qops
    log('[15] small quantized models, card (kernels) vs CPU (plain '
        'versions); quantized ops at full width against their plain form')
    cases = [('llama', dataclasses.replace(llama.LLAMA_TINY,
                                           dtype=torch.float32), llama),
             ('deepseek', dataclasses.replace(deepseek.DEEPSEEK_TINY,
                                              dtype=torch.float32),
              deepseek)]
    rng = np.random.default_rng(15)
    for name, cfg, mod in cases:
        gen = torch.Generator()
        gen.manual_seed(15)
        cpu_params = mod.init(cfg, gen, device='cpu')
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                   for n in (120, 77, 128)]
        for bits, wd in (('int8', torch.int8), ('int4', 'int4')):
            quant = (qops.quantize_params if bits == 'int8'
                     else qops.quantize_params_int4)
            tree = quant(cpu_params)
            on_card = quant(to_device(cpu_params, 'cuda'))
            same = all(torch.equal(a.cpu(), b) for a, b in zip(
                tensors(on_card), tensors(tree)))
            if not same:
                raise AssertionError(f'{name} {bits}: quantizing on the '
                                     'card gave other bytes than the CPU')
            kv = (torch.int8 if name == 'llama' and bits == 'int8'
                  else torch.float32)
            outputs = {}
            for device in ('cuda', 'cpu'):
                engine = engine_lib.InferenceEngine(
                    engine_lib.EngineConfig(
                        model=cfg, max_slots=4, max_target_len=256,
                        prefill_buckets=(128,), kv_dtype=kv,
                        weight_dtype=wd),
                    to_device(tree, device), device=device)
                outputs[device] = orch_lib.Orchestrator(
                    engine, decode_steps=4).generate(prompts,
                                                     max_new_tokens=12)
            log(f'  {name} {bits} weights, {str(kv)[6:]} KV: card tokens '
                f'{outputs["cuda"]}; quantized on the card = on the CPU, '
                'bit for bit')
            if outputs['cuda'] != outputs['cpu']:
                raise AssertionError(f'{name} {bits}: greedy tokens differ '
                                     'between the card and the CPU '
                                     f'({outputs["cpu"]})')
    release_card()
    full_width_quantized_ops()


def tensors(tree):
    """Every tensor of a params tree (a quantized leaf's values and
    scales), in key order."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from tensors(value)
        elif hasattr(value, 'scale'):
            yield value.q_packed if hasattr(value, 'q_packed') else value.q
            yield value.scale
        else:
            yield value


def compare_quantized(name, got, want, atol_of_max, rtol) -> float:
    atol = atol_of_max * float(want.abs().max())
    err = (got.float() - want).abs()
    max_err = float(err.max())
    log(f'  {name}: max_abs_err={max_err:.3e} (tolerance atol '
        f'{atol:.3e} = {atol_of_max:g} x max|plain|, rtol {rtol:g})')
    if not torch.isfinite(got.float()).all() or bool(
            (err > atol + rtol * want.abs()).any()):
        raise AssertionError(f'{name}: the quantized form disagrees with '
                             'its plain form')
    return max_err


def full_width_quantized_ops() -> None:
    from skypilot_tpu_torch.models import deepseek
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import quantization as qops
    cfg = llama.LLAMA3_8B
    gen = torch.Generator(device='cuda')
    gen.manual_seed(150)
    x = rand(gen, (16, cfg.d_model), torch.bfloat16)
    w = (rand(gen, (cfg.d_model, cfg.d_ff), torch.float32)
         * cfg.d_model ** -0.5).to(torch.bfloat16)
    bound = bound_ms(w.numel() * w.element_size(), 0, torch.bfloat16)[0]
    bf16_ms = time_ms(lambda: torch.matmul(x, w))
    for bits, quant, deq in (('int8', qops.quantize, qops.dequantize),
                             ('int4', qops.quantize4, qops.dequantize4)):
        qw = quant(w)
        cpu = quant(w.cpu())
        for a, b in zip(tensors({'w': qw}), tensors({'w': cpu})):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f'{bits} quantization of a [4096, '
                                     '14336] bf16 weight: the card differs '
                                     'from the CPU')
        want = x.float() @ deq(qw, torch.float32)
        compare_quantized(f'{bits} matmul [16, 4096] x [4096, 14336] (bf16 '
                          'out)', qops.matmul(x, qw), want,
                          QUANT_ATOL_OF_MAX, QUANT_RTOL)
        ms = time_ms(lambda: qops.matmul(x, qw))
        log(f'    {bits} matmul {ms:.4f} ms (the bf16 weight\'s own product '
            f'{bf16_ms:.4f} ms; weight bytes over 3.35 TB/s: '
            f'{bound_ms(qw.nbytes, 0, torch.bfloat16)[0]:.4f} ms at {bits}, '
            f'{bound:.4f} ms at bf16) on the card, quantized weights '
            'bit for bit equal to the CPU\'s')
    # The fp32-output LM head, int8 (the int8 replica's) and int4.
    head = (rand(gen, (cfg.d_model, cfg.vocab_size), torch.float32)
            * cfg.d_model ** -0.5).to(torch.bfloat16)
    for bits, quant, deq in (('int8', qops.quantize, qops.dequantize),
                             ('int4', qops.quantize4, qops.dequantize4)):
        qh = quant(head)
        got = qops.matmul(x, qh, preferred_element_type=torch.float32)
        if bits == 'int8':
            want = (x.float() @ qh.q.float()) * qh.scale
            tol = QUANT_FP32_ATOL_OF_MAX
        else:
            want = x.float() @ deq(qh, torch.float32)
            tol = QUANT_ATOL_OF_MAX
        if got.dtype != torch.float32:
            raise AssertionError(f'{bits} LM head: {got.dtype} logits')
        compare_quantized(f'{bits} LM head [16, 4096] x [4096, 128256], '
                          'fp32 out', got, want, tol,
                          0.0 if bits == 'int8' else QUANT_RTOL)
        del qh, got, want
    del head
    # DeepSeek-V2-Lite's experts: 64 of [2048, 1408], a decode step's 16
    # rows each, the gate product in fp32.
    ds = deepseek.DEEPSEEK_V2_LITE
    xe = rand(gen, (ds.n_experts, 16, ds.d_model), torch.bfloat16)
    we = (rand(gen, (ds.n_experts, ds.d_model, ds.moe_d_ff), torch.float32)
          * ds.d_model ** -0.5).to(torch.bfloat16)
    qe = qops.quantize(we)
    got = qops.expert_matmul(xe, qe, torch.float32)
    want = torch.bmm(xe.float(), qe.q.float()) * qe.scale[:, None, :]
    compare_quantized('int8 expert_matmul [64, 16, 2048] x [64, 2048, 1408],'
                      ' fp32 out', got, want, QUANT_FP32_ATOL_OF_MAX, 0.0)
    # The quantized embedding: rows on the card equal the CPU's bit for bit.
    table = qops.quantize((rand(gen, (cfg.vocab_size, cfg.d_model),
                                torch.float32)).to(torch.bfloat16), -1)
    tokens = torch.randint(0, cfg.vocab_size, (16, 64), generator=gen,
                           device='cuda')
    rows = qops.embed_rows(table, tokens)
    if not torch.equal(rows.cpu(), qops.embed_rows(table.to('cpu'),
                                                   tokens.cpu())):
        raise AssertionError('quantized embed_rows: the card differs from '
                             'the CPU')
    log('  int8 embed_rows [128256, 4096] table, 16 x 64 tokens: the card\'s '
        'rows equal the CPU\'s bit for bit')
    del table, rows, xe, we, qe
    release_card()


# ---- phases 16-19: the training entry point, LoRA, the converter ----

LAUNCH_LOGGER = 'skypilot_tpu_torch.train.launch'


class LaunchLog(logging.Handler):
    """Collects the launcher's log lines (its logger at INFO) while a
    phase runs it in-process, so the kernel counters stay readable."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        logger = logging.getLogger(LAUNCH_LOGGER)
        self._level = logger.level
        logger.setLevel(logging.INFO)
        logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        logger = logging.getLogger(LAUNCH_LOGGER)
        logger.removeHandler(self)
        logger.setLevel(self._level)
        return False


class registered_config:
    """``name`` → ``cfg`` in the port's Llama configs while a phase runs
    the launcher (``--model name``), as bench.py builds its own rungs."""

    def __init__(self, name, cfg):
        from skypilot_tpu_torch.models import llama
        self.configs, self.name, self.cfg = llama.CONFIGS, name, cfg

    def __enter__(self):
        self.configs[self.name] = self.cfg
        return self.name

    def __exit__(self, *exc):
        del self.configs[self.name]
        return False


class short_warmup:
    """The trainer's learning-rate warm-up cut from its fixed 100 steps to
    ``steps`` while a phase runs the launcher, so that a loss moves within
    a few steps: ``TrainConfig`` becomes a subclass with that default
    (the launcher, like the reference's, has no flag for it)."""

    def __init__(self, steps: int):
        from skypilot_tpu_torch.train import trainer as trainer_lib
        self.module, self.steps = trainer_lib, steps

    def __enter__(self):
        self.real = self.module.TrainConfig
        self.module.TrainConfig = dataclasses.make_dataclass(
            'TrainConfig', [('warmup_steps', int, self.steps)],
            bases=(self.real,))
        return self.steps

    def __exit__(self, *exc):
        self.module.TrainConfig = self.real
        return False


def write_token_shards(root: str, n_tokens: int, vocab: int, seed: int,
                       n_shards: int = 2) -> str:
    """uint32 token shards from a numpy seed, split over n_shards files."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, n_tokens).astype('<u4')
    os.makedirs(root, exist_ok=True)
    for i, part in enumerate(np.array_split(tokens, n_shards)):
        part.tofile(os.path.join(root, f'part-{i:02d}.bin'))
    return root


def launch_run(argv, label: str, kernels_wanted=TRAIN_KERNELS,
               n_layers: int = 16):
    """launch.run on argv with the launch counts zeroed just before and
    read just after; the flight recorder's ring starts empty."""
    from skypilot_tpu_torch.agent import flight_recorder
    from skypilot_tpu_torch.train import launch
    flight_recorder.reset_for_test()
    zero_launches()
    with LaunchLog() as captured:
        out = launch.run(launch.parse_args(argv))
    if out['trainer'].device.type == 'cuda':
        torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    if kernels_wanted:
        check_launches(label, launches, kernels_wanted, n_layers)
    out['log'] = captured.lines
    out['launches'] = launches
    out['records'] = flight_recorder.get_recorder().records()[::-1]
    return out


def phase_shares(records) -> dict:
    """Each flight-recorder phase's share of the steps' summed wall."""
    wall = sum(r['wall_s'] for r in records)
    return {name: sum(r['phases'][name] for r in records) / wall
            for name in records[0]['phases']}


# Resumed losses against the uninterrupted run's: the reference's own
# bound (tests/unit_tests/test_checkpoint_resume.py:75-78).
RESUME_RTOL = 1e-4
METRIC_KEYS = {'step', 'loss', 'tokens_per_sec', 'model_tflops_per_chip',
               'grad_norm', 'time'}


def launch_main_path(records: dict, train_result: dict) -> None:
    import tempfile
    from skypilot_tpu_torch.agent import checkpointd
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import launch
    cfg = dataclasses.replace(llama.LLAMA3_1B, remat=True,
                              remat_policy='qkvo_gup')
    gb, seq = 4, 8192
    log(f'[16] launch, checkpoint, resume: python -m '
        f'skypilot_tpu_torch.train.launch in-process, Llama-3-1B bf16 '
        f'({cfg.n_layers} layers), seq {seq}, global batch {gb}, remat '
        'qkvo_gup, adafactor, uint32 token shards through the native loader '
        '(built by g++ here; one worker, so that batches arrive in order)')
    with tempfile.TemporaryDirectory(prefix='xsky-launch-') as tmp, \
            registered_config('llama3-1b-qkvo_gup', cfg) as name:
        os.environ['XSKY_NATIVE_CACHE'] = os.path.join(tmp, 'native')
        data = write_token_shards(os.path.join(tmp, 'tokens'),
                                  7 * gb * seq + 1, cfg.vocab_size, seed=16)
        common = ['--model', name, '--global-batch-size', str(gb),
                  '--seq-len', str(seq), '--optimizer', 'adafactor',
                  '--device', 'cuda', '--log-every', '1', '--data', data,
                  '--data-loader', 'native', '--data-workers', '1']
        ckpt = os.path.join(tmp, 'ckpt')
        metrics = os.path.join(tmp, 'metrics.jsonl')
        t0 = time.perf_counter()
        solid = launch_run(common + ['--steps', '6', '--metrics-file',
                                     metrics], 'launch (6 steps)')
        t_solid = time.perf_counter() - t0
        if solid['data'] != 'NativeTokenLoader':
            raise AssertionError(f'loader {solid["data"]}, want native')
        rows = [json.loads(line) for line in open(metrics, encoding='utf-8')]
        if [set(r) for r in rows] != [METRIC_KEYS] * 6:
            raise AssertionError(f'metrics file rows {rows}')
        shares = phase_shares(solid['records'])
        launches = {k: v for k, v in solid['launches'].items()
                    if k in TRAIN_KERNELS}
        del solid['state'], solid['trainer']
        release_card()
        counted0 = checkpointd.counters().get('xsky_ckpt_bytes_total', 0.0)
        t0 = time.perf_counter()
        first = launch_run(common + ['--steps', '3', '--checkpoint-every',
                                     '3', '--checkpoint-dir', ckpt],
                           'launch (3 steps, checkpoint)')
        t_first = time.perf_counter() - t0
        copy_ms = [r['phases']['ckpt_copy'] * 1e3 for r in first['records']]
        fast_bytes = checkpointd.counters()['xsky_ckpt_bytes_total'] - counted0
        store = launch.StepCheckpoints(ckpt)
        if store.steps() != [3]:
            raise AssertionError(f'step directories {store.steps()}')
        step_bytes = os.path.getsize(os.path.join(ckpt, '3',
                                                  launch.STATE_FILE))
        del first['state'], first['trainer']
        release_card()
        t0 = time.perf_counter()
        resumed = launch_run(common + ['--steps', '6', '--resume', 'auto',
                                       '--checkpoint-every', '3',
                                       '--checkpoint-dir', ckpt],
                             'launch (resumed to 6)')
        t_resumed = time.perf_counter() - t0
        del resumed['state'], resumed['trainer']
        release_card()
        os.environ.pop('XSKY_NATIVE_CACHE')
    if 'Resumed from checkpoint step 3.' not in resumed['log']:
        raise AssertionError(f'no resume line in {resumed["log"]}')
    if sorted(resumed['losses']) != [4, 5, 6] or any(
            line.startswith(f'step {k}/6 ') for line in resumed['log']
            for k in (1, 2, 3)):
        raise AssertionError(f'resumed run logged {resumed["log"]}')
    if first['losses'] != {k: solid['losses'][k] for k in (1, 2, 3)}:
        log(f'  note: steps 1-3 of the checkpointing run '
            f'{first["losses"]} vs {solid["losses"]}')
    errs = {k: abs(resumed['losses'][k] - solid['losses'][k]) /
            abs(solid['losses'][k]) for k in (4, 5, 6)}
    identical = all(resumed['losses'][k] == solid['losses'][k]
                    for k in (4, 5, 6))
    log(f'  uninterrupted losses {solid["losses"]}')
    log(f'  resumed from step 3 ({resumed["restore"]["tier"]} tier in '
        f'{resumed["restore"]["seconds"]:.3f} s): losses '
        f'{resumed["losses"]}; relative differences {errs} (tolerance '
        f'{RESUME_RTOL:g}); bit-identical: {identical}')
    if max(errs.values()) > RESUME_RTOL:
        raise AssertionError('resumed losses differ from the uninterrupted '
                             'run')
    tps = [r['tokens_per_sec'] for r in rows[1:]]
    copies = [ms for ms in copy_ms if ms > 0]
    log(f'  launched steps 2-6: {np.mean(tps):.1f} tokens/s (metrics file; '
        f'{[round(t, 1) for t in tps]}) against measure_throughput\'s '
        f'{train_result["tokens_per_sec"]:.1f} in [6]; runs took '
        f'{t_solid:.1f} / {t_first:.1f} / {t_resumed:.1f} s with init')
    log(f'  save: the step loop paid {copies} ms of device->host copy '
        f'(ckpt_copy, per forced snapshot); checkpoint bytes: step '
        f'directory {step_bytes}, fast tier {fast_bytes:.0f} over '
        f'{len(copies)} snapshots; restore '
        f'{resumed["restore"]["seconds"]:.3f} s')
    log('  flight recorder shares of the 6-step run\'s wall: ' + ', '.join(
        f'{k} {v:.4f}' for k, v in shares.items()) +
        ' (dispatch = the host\'s launch of the step, unsynced)')
    total = {name: launches[name] + first['launches'][name] +
             resumed['launches'][name] for name in TRAIN_KERNELS}
    for name in TRAIN_KERNELS:
        records[name].setdefault('launches_by_path', {})['launch'] = (
            total[name])
    log(f'  launches per run: {launches}, '
        f'{ {k: first["launches"][k] for k in TRAIN_KERNELS} }, '
        f'{ {k: resumed["launches"][k] for k in TRAIN_KERNELS} }; decode '
        f'kernels 0; on {nvidia_smi_line()}')


def lora_main_path(records: dict) -> None:
    import tempfile
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer as trainer_lib
    cfg = llama.LLAMA3_8B
    gb, seq, steps = 4, 8192, 4
    # remat 'dots' keeps ~86 KB a token and layer (every product): one
    # 8192-token row is ~23 GB for 32 layers beside the 16 GB base, so
    # the batch of 4 runs as 4 accumulated microbatches of one row.
    accum = 4
    log(f'[17] LoRA: examples/tpu/lora_finetune_llama3.yaml on one card: '
        f'Llama-3-8B bf16 ({cfg.n_layers} layers, random base), rank 16, '
        f'alpha 32, targets wq,wk,wv,wo, adamw, lr 1e-3 (warm-up 1), seq '
        f'{seq}, global batch {gb} as --accum-steps {accum}; {steps} steps '
        'on a repeated batch (a shard of exactly one batch)')
    with tempfile.TemporaryDirectory(prefix='xsky-lora-') as tmp:
        os.environ['XSKY_NATIVE_CACHE'] = os.path.join(tmp, 'native')
        data = write_token_shards(os.path.join(tmp, 'tokens'),
                                  gb * seq + 1, cfg.vocab_size, seed=17,
                                  n_shards=1)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with short_warmup(1):
            out = launch_run([
                '--model', 'llama3-8b', '--seq-len', str(seq),
                '--global-batch-size', str(gb), '--accum-steps', str(accum),
                '--lora-rank', '16', '--lora-alpha', '32', '--lora-targets',
                'wq,wk,wv,wo', '--learning-rate', '1e-3', '--optimizer',
                'adamw', '--steps', str(steps), '--log-every', '1',
                '--data', data, '--data-loader', 'native',
                '--device', 'cuda'], 'LoRA', n_layers=cfg.n_layers)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        os.environ.pop('XSKY_NATIVE_CACHE')
    losses = [out['losses'][k] for k in sorted(out['losses'])]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f'LoRA losses {losses}: want finite, falling')
    state = out['state']
    adapters = trainer_lib.param_leaves(state['params'])
    shapes = {tuple(a.shape) for a in adapters}
    opt = []

    def walk(x):
        if torch.is_tensor(x):
            opt.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
    walk(state['opt_state'])
    if not opt or any(tuple(t.shape) not in shapes for t in opt if t.ndim):
        raise AssertionError('optimizer state holds a tensor that is not '
                             f'adapter-sized: {[tuple(t.shape) for t in opt]}')
    n_adapter = sum(a.numel() for a in adapters)
    opt_bytes = sum(t.numel() * t.element_size() for t in opt)
    # The base is frozen: equal bit for bit to the seeded init it started
    # from (the trainer draws it from a generator seeded with the seed).
    base = state['base']
    del out['state'], out['trainer'], state
    release_card()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    fresh = llama.init(cfg, gen, device='cuda')
    same = all(torch.equal(a, b) for a, b in zip(
        trainer_lib.param_leaves(base), trainer_lib.param_leaves(fresh)))
    if not same:
        raise AssertionError('the frozen base changed during LoRA steps')
    del base, fresh
    release_card()
    rows = out['log']
    tps = [float(line.split(' tok/s')[0].split()[-1].replace(',', ''))
           for line in rows if ' tok/s ' in line][1:]
    flops = dataclasses.replace(cfg, max_seq_len=seq).train_flops_per_token()
    log(f'  losses {losses} (finite, falling); base bit-identical to its '
        f'seeded init; optimizer state {len(opt)} tensors, {opt_bytes} '
        f'bytes, all adapter-sized ({n_adapter} adapter parameters)')
    log(f'  steps 2-{steps}: {np.mean(tps):.1f} tokens/s, model '
        f'{np.mean(tps) * flops / 1e12:.2f} TFLOP/s by the 6N + 12LdS '
        f'formula (a LoRA step computes no weight gradient for the frozen '
        f'base); peak memory {peak / 2**30:.2f} GiB; {dt:.1f} s with init; '
        f'launches {out["launches"]} on {nvidia_smi_line()}')
    for name in TRAIN_KERNELS:
        records[name].setdefault('launches_by_path', {})['lora'] = (
            out['launches'][name])


def write_safetensors(path: str, tensors: dict) -> None:
    """A .safetensors file from {name: torch tensor} in a few lines of
    numpy: an 8-byte header length, a JSON header, raw little-endian
    bytes (bf16 as its uint16 bits)."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw, code = t.view(torch.int16).numpy().tobytes(), 'BF16'
        else:
            raw, code = t.float().numpy().astype('<f4').tobytes(), 'F32'
        header[name] = {'dtype': code, 'shape': list(t.shape),
                        'data_offsets': [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b' ' * (-len(text) % 8)
    with open(path, 'wb') as f:
        f.write(len(text).to_bytes(8, 'little'))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def random_hf_llama(root: str, cfg, dtype, seed: int) -> dict:
    """A random checkpoint in HF's layout for cfg's widths (config.json +
    model.safetensors), drawn on the card; returns the port's tree built
    directly from the same tensors (stacked, transposed to [in, out])."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    hd = cfg.head_dim

    def draw(out_dim, in_dim):
        return (torch.randn((out_dim, in_dim), generator=gen, device='cuda')
                * in_dim ** -0.5).to(dtype)

    def norm(d):
        return (1 + 0.1 * torch.randn((d,), generator=gen,
                                      device='cuda')).to(dtype)

    hf, layers = {}, {k: [] for k in (
        'wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down', 'attn_norm',
        'mlp_norm')}
    shapes = {'q_proj': ('wq', cfg.n_heads * hd, cfg.d_model),
              'k_proj': ('wk', cfg.n_kv_heads * hd, cfg.d_model),
              'v_proj': ('wv', cfg.n_kv_heads * hd, cfg.d_model),
              'o_proj': ('wo', cfg.d_model, cfg.n_heads * hd),
              'gate_proj': ('w_gate', cfg.d_ff, cfg.d_model),
              'up_proj': ('w_up', cfg.d_ff, cfg.d_model),
              'down_proj': ('w_down', cfg.d_model, cfg.d_ff)}
    for i in range(cfg.n_layers):
        for proj, (ours, o, n) in shapes.items():
            kind = 'self_attn' if ours in ('wq', 'wk', 'wv', 'wo') else 'mlp'
            w = draw(o, n)
            hf[f'model.layers.{i}.{kind}.{proj}.weight'] = w
            layers[ours].append(w.t())
        for hf_name, ours in (('input_layernorm', 'attn_norm'),
                              ('post_attention_layernorm', 'mlp_norm')):
            w = norm(cfg.d_model)
            hf[f'model.layers.{i}.{hf_name}.weight'] = w
            layers[ours].append(w)
    hf['model.embed_tokens.weight'] = draw(cfg.vocab_size, cfg.d_model)
    hf['model.norm.weight'] = norm(cfg.d_model)
    hf['lm_head.weight'] = draw(cfg.vocab_size, cfg.d_model)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, 'config.json'), 'w',
              encoding='utf-8') as f:
        json.dump({'model_type': 'llama', 'architectures':
                   ['LlamaForCausalLM'], 'vocab_size': cfg.vocab_size,
                   'hidden_size': cfg.d_model, 'num_hidden_layers':
                   cfg.n_layers, 'num_attention_heads': cfg.n_heads,
                   'num_key_value_heads': cfg.n_kv_heads,
                   'intermediate_size': cfg.d_ff,
                   'max_position_embeddings': cfg.max_seq_len,
                   'rope_theta': cfg.rope_theta, 'rms_norm_eps':
                   cfg.norm_eps, 'tie_word_embeddings': False,
                   'torch_dtype': str(dtype).split('.')[-1]}, f)
    write_safetensors(os.path.join(root, 'model.safetensors'), hf)
    direct = {'embed': hf['model.embed_tokens.weight'],
              'layers': {k: torch.stack(v).contiguous()
                         for k, v in layers.items()},
              'final_norm': hf['model.norm.weight'],
              'lm_head': hf['lm_head.weight'].t().contiguous()}
    del hf
    return direct


HF_SERVE_KERNELS = ('flash_fwd', 'decode_attention')


def hf_checkpoint_path(records: dict) -> None:
    import tempfile
    import threading
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train.trainer import param_leaves
    cfg = dataclasses.replace(llama.LLAMA3_1B, remat=False)
    new_tokens = 24
    log(f'[18] converter and --hf-checkpoint: a random Llama-3-1B '
        f'({cfg.n_layers} layers) in HF\'s layout (config.json + bf16 '
        'safetensors written with numpy), converted, and served by '
        'infer/server.py --hf-checkpoint on 127.0.0.1; greedy tokens '
        'against Orchestrator.generate on the tree built directly')
    with tempfile.TemporaryDirectory(prefix='xsky-hf-') as tmp:
        root = os.path.join(tmp, 'llama-3-1b-random')
        t0 = time.perf_counter()
        direct = random_hf_llama(root, cfg, torch.bfloat16, seed=18)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(root, 'model.safetensors'))
        t0 = time.perf_counter()
        converted_cfg, converted = convert.from_hf(root, device='cuda')
        torch.cuda.synchronize()
        t_convert = time.perf_counter() - t0
        if dataclasses.replace(converted_cfg, remat=False) != cfg:
            raise AssertionError(f'converted config {converted_cfg}')
        same = all(torch.equal(a, b) for a, b in zip(
            param_leaves(converted), param_leaves(direct)))
        if not same:
            raise AssertionError('the converted tree differs from the tree '
                                 'built directly')
        del converted
        release_card()
        zero_launches()
        t0 = time.perf_counter()
        replica = server_lib.build_replica(server_lib.parse_args([
            '--hf-checkpoint', root, '--max-slots', '4', '--max-target-len',
            '2048', '--port', '0', '--device', 'cuda']), host='127.0.0.1')
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    rng = np.random.default_rng(18)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (16, 300, 1000)]
    try:
        model_id = json.loads(http_json(url, '/v1/models'))['data'][0]['id']
        served = [http_json(url, '/generate', {
            'prompt_tokens': p, 'max_new_tokens': new_tokens})[
                'output_tokens'] for p in prompts]
        # The served path's own launches (build, warm-up, the requests),
        # read before the comparison run below launches anything.
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        check_launches('hf-checkpoint serving', launches, HF_SERVE_KERNELS,
                       cfg.n_layers)
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()
    del replica
    release_card()
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=4, max_target_len=2048),
        direct, device='cuda')
    orch = orch_lib.Orchestrator(engine, decode_steps=4)
    built = [orch.generate([p], max_new_tokens=new_tokens)[0]
             for p in prompts]
    del orch, engine, direct
    release_card()
    if model_id != 'llama-3-1b-random':
        raise AssertionError(f'/v1/models id {model_id!r}')
    if served != built:
        raise AssertionError(f'served tokens {served} differ from the '
                             f'directly built tree\'s {built}')
    for name in HF_SERVE_KERNELS:
        records[name].setdefault('launches_by_path', {})['hf_checkpoint'] = (
            launches[name])
    log(f'  checkpoint {size} bytes written in {t_write:.2f} s; from_hf '
        f'{t_convert:.2f} s (read, stack, cast on the card), equal bit for '
        f'bit to the tree built directly; server build (conversion on the '
        f'host + engine + warm-up) {t_build:.2f} s; model id {model_id!r}')
    log(f'  prompts of {[len(p) for p in prompts]} tokens, {new_tokens} new '
        f'each, one at a time: served tokens equal Orchestrator.generate on '
        f'the directly built tree; served launches {launches} on '
        f'{nvidia_smi_line()}')


def small_launch_checks() -> None:
    import tempfile
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train.trainer import param_leaves
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    seq = 1024
    log(f'[19] small checks, card vs CPU: fp32 LLAMA_TINY widths, seq {seq} '
        '(so the flash kernels run on the card): the converter\'s trees, '
        'three launcher steps from one --init-params and --data, and three '
        'LoRA steps')
    with tempfile.TemporaryDirectory(prefix='xsky-small-') as tmp, \
            registered_config('tiny-fp32', cfg) as name:
        root = os.path.join(tmp, 'hf')
        random_hf_llama(root, cfg, torch.float32, seed=19)
        trees = {}
        for dtype in (torch.float32, torch.bfloat16):
            for device in ('cuda', 'cpu'):
                trees[dtype, device] = param_leaves(
                    convert.from_hf(root, dtype, device=device)[1])
            if not all(torch.equal(a.cpu(), b) for a, b in zip(
                    trees[dtype, 'cuda'], trees[dtype, 'cpu'])):
                raise AssertionError(f'{dtype} trees differ between the '
                                     'card and the CPU')
        init = os.path.join(tmp, 'init')
        printed = io.StringIO()   # stdout keeps only the result lines
        with contextlib.redirect_stdout(printed):
            convert.main(['--src', root, '--out', init, '--dtype', 'f32',
                          '--device', 'cpu'])
        log(f'  convert.main: {printed.getvalue().strip()}')
        data = write_token_shards(os.path.join(tmp, 'tokens'),
                                  3 * 2 * seq + 1, cfg.vocab_size, seed=19)
        common = ['--model', name, '--global-batch-size', '2', '--seq-len',
                  str(seq), '--steps', '3', '--log-every', '1',
                  '--learning-rate', '1e-3', '--init-params', init,
                  '--data', data, '--data-loader', 'python']
        for label, extra in (('full', ['--optimizer', 'adamw']),
                             ('LoRA', ['--lora-rank', '4', '--optimizer',
                                       'adamw'])):
            runs = {}
            for device in ('cuda', 'cpu'):
                with short_warmup(1):
                    out = launch_run(common + extra + ['--device', device],
                                     f'small {label} on {device}',
                                     kernels_wanted=None)
                runs[device] = (out['losses'], out['launches'])
            losses = {d: [runs[d][0][k] for k in (1, 2, 3)] for d in runs}
            used = runs['cuda'][1]
            log(f'  {label}: card losses {losses['cuda']}, CPU '
                f'{losses["cpu"]} (atol {TRAIN_LOSS_ATOL:g}); card launches '
                f'{ {k: used[k] for k in TRAIN_KERNELS} }')
            if max(abs(a - b) for a, b in zip(losses['cuda'],
                                              losses['cpu'])) > \
                    TRAIN_LOSS_ATOL:
                raise AssertionError(f'{label} losses differ between the '
                                     'card and the CPU')
            if not all(used[k] for k in TRAIN_KERNELS):
                raise AssertionError(f'a kernel did not run: {used}')
    log('  converter trees (fp32 and bf16) equal bit for bit on the card '
        'and the CPU')
    release_card()


# ---- phases 20-22: the Qwen family ----

# serve_qwen.yaml's replica without its speculative flags, which phase 23
# adds: 32 slots over a 4096-row cache, 32 concurrent prompts
# of 1000-1024 tokens (so the prefill waves take the flash kernel's 1024
# bucket), 64 new tokens each.
QWEN_SERVE = dict(slots=32, max_len=4096, requests=32, new_tokens=64)


def qwen_replica(records: dict) -> dict:
    import threading
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import qwen
    cfg = qwen.QWEN3_8B
    r = QWEN_SERVE
    log(f'[20] serve_qwen.yaml on one card, without --spec-ngram (phase '
        f'[23] adds it): Qwen3-8B bf16 ({cfg.n_layers} layers, d_model '
        f'{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim '
        f'{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, QK-norm, '
        f'rope theta {cfg.rope_theta:g}; {cfg.num_params() / 1e9:.2f} B '
        f'parameters), seeded random weights; infer/server.py --model '
        f'qwen3-8b --max-slots {r["slots"]} --max-target-len {r["max_len"]} '
        'on 127.0.0.1')
    t0 = time.perf_counter()
    replica = server_lib.build_replica(server_lib.parse_args([
        '--model', 'qwen3-8b', '--max-slots', str(r['slots']),
        '--max-target-len', str(r['max_len']), '--port', '0',
        '--device', 'cuda']), host='127.0.0.1')
    torch.cuda.synchronize()
    log(f'  init + engine + warm-up {time.perf_counter() - t0:.2f} s; '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    rng = np.random.default_rng(20)
    singles = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (16, 300, 1000)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(1000, 1025, r['requests'])]
    try:
        # The served requests' own launches: counted from here (after the
        # warm-up) and read before anything else runs on the engine.
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        served = [http_json(url, '/generate', {
            'prompt_tokens': p, 'max_new_tokens': r['new_tokens']})[
                'output_tokens'] for p in singles]
        before = http_json(url, '/metrics')
        _, dt = concurrent_generate(url, [
            {'prompt_tokens': p, 'max_new_tokens': r['new_tokens']}
            for p in prompts], cfg.vocab_size)
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        after = http_json(url, '/metrics')
        check_launches('qwen3-8b replica', launches, SERVE_KERNELS,
                       cfg.n_layers)
        for name in SERVE_KERNELS:
            records[name].setdefault('launches_by_path', {})[
                'qwen_serve'] = launches[name]
        ttft_n = (metric(after, 'xsky_serve_ttft_seconds_count')
                  - metric(before, 'xsky_serve_ttft_seconds_count'))
        ttft_s = (metric(after, 'xsky_serve_ttft_seconds_sum')
                  - metric(before, 'xsky_serve_ttft_seconds_sum'))
        if ttft_n != r['requests']:
            raise AssertionError(f'{ttft_n} TTFT samples for '
                                 f'{r["requests"]} requests')
        peak = torch.cuda.max_memory_allocated() / 2**30
        # The server adds nothing: the prompts sent one at a time give the
        # tokens of Orchestrator.generate on the same engine, run with the
        # serving loop held.
        with replica.loop._lock:
            direct = [replica.loop.orch.generate(
                [p], max_new_tokens=r['new_tokens'])[0] for p in singles]
        if served != direct:
            raise AssertionError('the server gave other tokens than '
                                 'Orchestrator.generate')
        out_tokens = r['requests'] * r['new_tokens']
        numbers = {'tok_s': out_tokens / dt,
                   'ttft_ms': ttft_s / ttft_n * 1e3, 'peak_gib': peak}
        log(f'  prompts of {[len(p) for p in singles]} tokens one at a time: '
            'the served tokens equal Orchestrator.generate on the same '
            'engine')
        log(f'  {r["requests"]} concurrent POST /generate (prompts of '
            f'{min(map(len, prompts))}-{max(map(len, prompts))} tokens) x '
            f'{r["new_tokens"]} tokens in {dt:.3f} s: {out_tokens / dt:.1f} '
            f'output tok/s, mean TTFT {ttft_s / ttft_n * 1e3:.1f} ms '
            f'(/metrics), peak memory {peak:.2f} GiB; served launches '
            f'{launches} on {nvidia_smi_line()}')
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()
    del replica
    release_card()
    return numbers


def qwen2_main_path(records: dict) -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import qwen
    cfg = qwen.QWEN2_7B
    log(f'[21] Qwen2-7B bf16 ({cfg.n_layers} layers, d_model {cfg.d_model}, '
        f'{cfg.n_heads}/{cfg.n_kv_heads} heads: GQA group '
        f'{cfg.n_heads // cfg.n_kv_heads}, Q/K/V biases, vocab '
        f'{cfg.vocab_size}; {cfg.num_params() / 1e9:.2f} B parameters), '
        'seeded random weights, InferenceEngine + Orchestrator: 16 slots, '
        'max_target_len 2048, bucket 1024')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(21)
    t0 = time.perf_counter()
    params = qwen.init(cfg, gen)
    torch.cuda.synchronize()
    log(f'  init {time.perf_counter() - t0:.2f} s, '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=16,
                                max_target_len=2048,
                                prefill_buckets=(1024,)), params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    rng = np.random.default_rng(21)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(1000, 1025, 16)]
    new_tokens = 32
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('qwen2-7b serving', launches, SERVE_KERNELS, cfg.n_layers)
    for name in SERVE_KERNELS:
        records[name].setdefault('launches_by_path', {})['qwen2_serve'] = (
            launches[name])
    out_tokens = sum(len(r.output_tokens) for r in requests)
    log(f'  16 requests x {new_tokens} tokens done in {dt:.3f} s: '
        f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
        f'{mean_ms(requests):.1f} ms, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
        f'launches {launches} on {nvidia_smi_line()}')
    del orch, engine, params
    release_card()


# Loss and gradients of the small Qwen models, card against CPU: fp32 sums
# in another order, the flash kernels' against the plain versions'; [19]'s
# tolerance.
QWEN_GRAD_ATOL = 1e-4


def small_qwen_params(cfg, seed: int):
    """The port's init for cfg on the CPU, with the Qwen leaves drawn too
    (biases 0.1 N(0, 1), norm scales 1 + 0.2 N(0, 1)): zero biases and
    unit scales would not show a misplaced one, and larger V biases swamp
    the attention output over ~1000-token prompts, so that every prompt
    gives the same greedy tokens."""
    from skypilot_tpu_torch.models import qwen
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = qwen.init(cfg, gen, device='cpu')
    for key, value in params['layers'].items():
        if key in ('bq', 'bk', 'bv'):
            value.copy_(0.1 * torch.randn(value.shape, generator=gen))
        elif key in ('q_norm', 'k_norm'):
            value.copy_(1 + 0.2 * torch.randn(value.shape, generator=gen))
    return params


def small_qwen_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import qwen
    from skypilot_tpu_torch.train.trainer import param_leaves
    log('[22] small Qwen checks, card (kernels) vs CPU (plain versions): '
        'fp32 qwen-tiny (Q/K/V biases) and qwen3-tiny (QK-norm) widths with '
        'random biases and norm scales, bucket 1024 (so the flash kernel '
        'runs): served greedy tokens; a chunked prefill with a prefix-cache '
        'hit against the whole prompt in one 2048 bucket; loss_fn and its '
        'gradients at seq 1024')
    for cfg in (qwen.QWEN_TINY_F32, qwen.QWEN3_TINY_F32):
        label = 'qwen-tiny' if cfg.qkv_bias else 'qwen3-tiny'
        cpu_params = small_qwen_params(cfg, seed=22)
        rng = np.random.default_rng(22)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                   for n in (1024, 700, 913, 1000, 64)]
        long = [int(t) for t in rng.integers(0, cfg.vocab_size, 1500)]
        hit = long[:1200] + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                          100)]
        tokens = rng.integers(0, cfg.vocab_size, (2, 1024))

        def generate(device, prompt_list, new_tokens, one_by_one=False,
                     **kw):
            """Greedy tokens of an engine of its own, and its prefix-cache
            statistics. one_by_one: each prompt after the one before has
            finished, so that a later prompt can hit an earlier one's
            cache entry."""
            engine = engine_lib.InferenceEngine(
                engine_lib.EngineConfig(model=cfg, max_slots=4,
                                        kv_dtype=torch.float32, **kw),
                to_device(cpu_params, device), device=device)
            orch = orch_lib.Orchestrator(engine, decode_steps=4)
            groups = ([[p] for p in prompt_list] if one_by_one
                      else [prompt_list])
            out = [t for group in groups
                   for t in orch.generate(group, max_new_tokens=new_tokens)]
            return out, engine.prefix_cache_stats

        runs, used = {}, {}
        for device in ('cuda', 'cpu'):
            before = {k.name: k.launches for k in kernels.REGISTRY}
            served = generate(device, prompts, 12, max_target_len=1040,
                              prefill_buckets=(1024,))[0]
            chunked, stats = generate(device, [long, hit], 8,
                                      one_by_one=True, max_target_len=2100,
                                      prefill_buckets=(1024,),
                                      prefix_cache_entries=4)
            whole = generate(device, [long, hit], 8, max_target_len=2100,
                             prefill_buckets=(2048,))[0]
            params = {k: ({kk: vv.to(device, copy=True)
                           for kk, vv in v.items()} if isinstance(v, dict)
                          else v.to(device, copy=True))
                      for k, v in cpu_params.items()}
            for leaf in param_leaves(params):
                leaf.requires_grad_(True)
            batch = torch.from_numpy(tokens).to(device)
            loss = qwen.loss_fn(cfg, params, batch, batch.roll(-1, 1))
            loss.backward()
            used[device] = {k.name: k.launches - before[k.name]
                            for k in kernels.REGISTRY}
            runs[device] = dict(served=served, chunked=chunked,
                                whole=whole, stats=stats,
                                loss=float(loss.detach()),
                                grads=[p.grad.cpu()
                                       for p in param_leaves(params)])
        card, cpu = runs['cuda'], runs['cpu']
        grad_err = max(float((a - b).abs().max()) for a, b in zip(
            card['grads'], cpu['grads']))
        log(f'  {label}: card tokens {card["served"]}; chunked + prefix '
            f'hit {card["chunked"]} ({card["stats"]}); loss card '
            f'{card["loss"]!r} CPU {cpu["loss"]!r}, largest gradient error '
            f'{grad_err:.3e} (atol {QWEN_GRAD_ATOL:g}); card launches '
            f'{used["cuda"]}')
        for key in ('served', 'chunked', 'whole', 'stats'):
            if card[key] != cpu[key]:
                raise AssertionError(f'{label}: {key} differs between the '
                                     f'card and the CPU')
        for device, run in runs.items():
            if run['chunked'] != run['whole'] or not run['stats']['hits']:
                raise AssertionError(
                    f'{label} on {device}: the chunked prefill with a '
                    f'prefix-cache hit gave {run["chunked"]}, the whole '
                    f'prompt {run["whole"]} ({run["stats"]})')
        if abs(card['loss'] - cpu['loss']) > TRAIN_LOSS_ATOL or \
                grad_err > QWEN_GRAD_ATOL:
            raise AssertionError(f'{label}: loss or gradients differ '
                                 'between the card and the CPU')
        if not all(used['cuda'][name] for name in TRAIN_KERNELS + (
                'decode_attention',)):
            raise AssertionError(f'a kernel did not run on the card: '
                                 f'{used["cuda"]}')
    release_card()


# ---- phases 23-25: speculative decoding ----

SPEC_GAMMA = 4
# The sampled request of [23] and [24]: its rounds are plain (only greedy
# rounds speculate), so that both kinds run in one served run.
SAMPLED_NEW = 16
DRAFT_SERVE = dict(slots=16, max_len=2048, requests=16, new_tokens=64)
# A self-draft with the target's own weights: bf16 near-ties between the
# decode kernel's and the verify pass's logits are the only rejections.
SELF_DRAFT_MIN_ACCEPT = 0.5


def count_plain_rounds(orch) -> list:
    """Wrap a speculator's _decode_tick, through which its plain rounds
    go, so that a run can count them; each is one decode step of every
    slot."""
    rounds = [0]
    tick = orch._decode_tick

    def counted():
        rounds[0] += 1
        tick()

    orch._decode_tick = counted
    return rounds


def flash_prefills(engine, prompts) -> int:
    """How many of these prompts a one-at-a-time admission prefills
    through the flash kernel (their bucket reaches its shortest
    sequence; one launch per layer each)."""
    from skypilot_tpu_torch.ops import attention
    return sum(engine.bucket_for(len(p)) >= attention._FLASH_MIN_SEQ
               for p in prompts)


def check_derived_launches(path: str, launches: dict, want: dict) -> None:
    """Each kernel ran exactly as often as derived from the run's rounds
    and prefills; every other kernel not at all."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f'{name}: {n} launches on the {path} path; '
                                 f'derived {want.get(name, 0)} '
                                 f'(all derived: {want})')


def path_logits(engine, prefix):
    """The fp32 logits [V] for the token after ``prefix`` through the
    two numeric paths, on a one-slot scratch cache whose rows before the
    last token one verify_hidden pass fills: decode_forward (the decode
    kernel, as plain rounds run it) and verify_forward (the verify
    pass's plain attention)."""
    c = engine.config.model
    lib = engine._model_lib
    dev = engine.device
    n = len(prefix)
    shape = (c.n_layers, 1, engine.config.max_target_len, c.n_kv_heads,
             c.head_dim)
    kv = {key: torch.zeros(shape, dtype=engine.config.kv_dtype, device=dev)
          for key in ('k', 'v')}
    tokens = torch.tensor([prefix], device=dev)
    last = torch.tensor([n - 1], device=dev)
    with torch.no_grad():
        lib.verify_hidden(c, engine.params, tokens[:, :-1],
                          torch.arange(n - 1, device=dev)[None], kv)
        dec, _ = lib.decode_forward(c, engine.params, tokens[:, -1], last,
                                    kv)
        ver, _ = lib.verify_forward(c, engine.params, tokens[:, -1:],
                                    last[None], kv)
    return dec[0], ver[0, 0]


def check_ties(label: str, engine, prompts, spec_streams,
               plain_streams) -> int:
    """Each greedy stream of the speculative run equals the plain run's,
    or parts from it at a tie: at the first token where the two differ,
    the plain path's logit margin between the two tokens is at most
    twice the largest difference, over that row, between the decode and
    verify paths' logits at that position. → the number of partings."""
    partings = []
    for prompt, got, want in zip(prompts, spec_streams, plain_streams):
        if got == want:
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        dec, ver = path_logits(engine, list(prompt) + list(want[:j]))
        margin = abs(float(dec[want[j]] - dec[got[j]]))
        diff = float((ver - dec).abs().max())
        partings.append((j, margin, diff))
        if margin > 2 * diff:
            raise AssertionError(
                f'{label}: the speculative stream parts from plain greedy '
                f'at token {j} ({got[j]} for {want[j]}) with a plain margin '
                f'of {margin:.6f} > 2 x the paths\' largest logit '
                f'difference {diff:.6f}: not a tie')
    log(f'  {label}: {len(partings)} of {len(plain_streams)} greedy streams '
        'part from plain greedy decoding on the same engine, each at a '
        'tie (token, plain margin, paths\' largest logit difference): '
        f'{[(j, round(m, 6), round(d, 6)) for j, m, d in partings]}')
    return len(partings)


def plain_streams(engine, prompts, new_tokens: int):
    """Plain greedy decoding of ``prompts`` on ``engine``, admitted one at
    a time as the speculators admit them (so that both runs prefill with
    the same numerics)."""
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    plain = orch_lib.Orchestrator(engine, decode_steps=4)
    plain._batched_admit = False
    requests, _ = serve_and_check(plain, engine.config.model, prompts,
                                  new_tokens)
    return [r.output_tokens for r in requests]


def spec_counters(text: str) -> dict:
    return {key: metric(text, f'xsky_serve_spec_{key}_total')
            for key in ('rounds', 'proposed', 'accepted')}


def serve_speculative(label: str, records: dict, path: str, url: str, orch,
                      loop, singles, bodies, want_launches):
    """The speculative replica's checks and numbers: singles one at a
    time (served tokens = the speculator's own generate, loop lock held),
    then ``bodies`` at once; launch counts from these requests alone,
    checked against ``want_launches(plain_rounds, spec_rounds)``.
    → (streams, numbers)."""
    cfg = orch.engine.config.model
    with loop._lock:
        plain_rounds = count_plain_rounds(orch)
        rounds0 = orch.accept_stats['rounds']
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
    served = [http_json(url, '/generate', {
        'prompt_tokens': p, 'max_new_tokens': 64})['output_tokens']
        for p in singles]
    before = http_json(url, '/metrics')
    streams, dt = concurrent_generate(url, bodies, cfg.vocab_size)
    with loop._lock:
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        n_plain = plain_rounds[0]
        n_spec = orch.accept_stats['rounds'] - rounds0
        totals = dict(orch.accept_stats)
    after = http_json(url, '/metrics')
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_derived_launches(path, launches, want_launches(n_plain, n_spec))
    if not n_plain or not n_spec:
        raise AssertionError(f'{label}: {n_plain} plain and {n_spec} '
                             'speculative rounds; both kinds must run')
    for name, n in launches.items():
        if n:
            records[name].setdefault('launches_by_path', {})[path] = n
    if spec_counters(after) != totals:
        raise AssertionError(f'/metrics spec counters {spec_counters(after)}'
                             f', accept_stats {totals}')
    spec = {key: spec_counters(after)[key] - spec_counters(before)[key]
            for key in totals}
    ttft_n = (metric(after, 'xsky_serve_ttft_seconds_count')
              - metric(before, 'xsky_serve_ttft_seconds_count'))
    ttft_s = (metric(after, 'xsky_serve_ttft_seconds_sum')
              - metric(before, 'xsky_serve_ttft_seconds_sum'))
    if ttft_n != len(bodies):
        raise AssertionError(f'{ttft_n} TTFT samples for {len(bodies)} '
                             'requests')
    with loop._lock:
        direct = [orch.generate([p], max_new_tokens=64)[0] for p in singles]
    if served != direct:
        raise AssertionError(f'{label}: the server gave other tokens than '
                             'the speculator\'s own generate')
    out_tokens = sum(b['max_new_tokens'] for b in bodies)
    numbers = {'tok_s': out_tokens / dt, 'ttft_ms': ttft_s / ttft_n * 1e3,
               'peak_gib': peak, 'spec': spec,
               'acceptance': spec['accepted'] / max(spec['proposed'], 1),
               'plain_rounds': n_plain, 'spec_rounds': n_spec}
    log(f'  prompts of {[len(p) for p in singles]} tokens one at a time: the '
        'served tokens equal the speculator\'s own generate')
    log(f'  {len(bodies)} concurrent POST /generate ({out_tokens} tokens) in '
        f'{dt:.3f} s: {numbers["tok_s"]:.1f} output tok/s, mean TTFT '
        f'{numbers["ttft_ms"]:.1f} ms (/metrics), peak memory {peak:.2f} '
        f'GiB; the concurrent run\'s /metrics '
        f'xsky_serve_spec_{{rounds,proposed,accepted}}_total grew by '
        f'{spec["rounds"]:.0f}, {spec["proposed"]:.0f}, '
        f'{spec["accepted"]:.0f} (acceptance {numbers["acceptance"]:.4f}); '
        f'with the singles, {n_spec} speculative and {n_plain} plain rounds '
        f'and launches {launches} as derived, on {nvidia_smi_line()}')
    return streams, numbers


def spec_qwen_replica(records: dict, plain: dict) -> None:
    import threading
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import qwen
    cfg = qwen.QWEN3_8B
    r = QWEN_SERVE
    log(f'[23] serve_qwen.yaml as written: infer/server.py --model qwen3-8b '
        f'--max-slots {r["slots"]} --max-target-len {r["max_len"]} '
        f'--spec-ngram --spec-gamma {SPEC_GAMMA} on 127.0.0.1 (Qwen3-8B '
        f'bf16 at its published widths, seeded random weights)')
    t0 = time.perf_counter()
    replica = server_lib.build_replica(server_lib.parse_args([
        '--model', 'qwen3-8b', '--max-slots', str(r['slots']),
        '--max-target-len', str(r['max_len']), '--spec-ngram',
        '--spec-gamma', str(SPEC_GAMMA), '--port', '0',
        '--device', 'cuda']), host='127.0.0.1')
    torch.cuda.synchronize()
    orch, engine = replica.loop.orch, replica.engine
    if not isinstance(orch, orch_lib.NgramSpeculator):
        raise AssertionError(f'--spec-ngram built a {type(orch).__name__}')
    log(f'  init + engine + warm-up {time.perf_counter() - t0:.2f} s; '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    rng = np.random.default_rng(23)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(1000, 1025, r['requests'])]
    # Copy-heavy: a 64-token block repeated 8 times.
    copies = [[int(t) for t in rng.integers(0, cfg.vocab_size, 64)] * 8
              for _ in range(4)]
    sampled = [int(t) for t in rng.integers(0, cfg.vocab_size, 1000)]
    greedy = prompts + copies
    bodies = ([{'prompt_tokens': p, 'max_new_tokens': r['new_tokens']}
               for p in greedy]
              + [{'prompt_tokens': sampled, 'max_new_tokens': SAMPLED_NEW,
                  'temperature': 1.0}])
    singles = [prompts[0], copies[0]]
    n_flash = flash_prefills(engine, singles + greedy + [sampled])

    def want(n_plain, n_spec):
        del n_spec   # verify passes take the plain attention
        return {'flash_fwd': cfg.n_layers * n_flash,
                'decode_attention': cfg.n_layers * n_plain}

    try:
        streams, numbers = serve_speculative(
            '[23]', records, 'qwen_spec_ngram', url, orch, replica.loop,
            singles, bodies, want)
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()
    orch.state = None      # the plain run below needs the room
    release_card()
    expected = plain_streams(engine, greedy, r['new_tokens'])
    partings = check_ties('[23]', engine, greedy,
                          streams[:len(greedy)], expected)
    log(f'  [23] beside [20] (same model, slots, cache and 32 prompts; [23] '
        f'adds 4 copy-heavy and 1 sampled request): output tok/s '
        f'{numbers["tok_s"]:.1f} vs {plain["tok_s"]:.1f}, mean TTFT '
        f'{numbers["ttft_ms"]:.1f} vs {plain["ttft_ms"]:.1f} ms, peak '
        f'{numbers["peak_gib"]:.2f} vs {plain["peak_gib"]:.2f} GiB; '
        f'acceptance {numbers["acceptance"]:.4f}; {partings} tie partings')
    del replica, orch, engine
    release_card()


def draft_model_paths(records: dict) -> None:
    import threading
    from http.server import ThreadingHTTPServer
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import llama
    r = DRAFT_SERVE
    target_cfg = dataclasses.replace(llama.LLAMA3_8B, remat=False)
    small = llama.LLAMA3_1B
    log(f'[24] draft-model speculation, gamma {SPEC_GAMMA}: --model llama3-8b '
        f'--draft-model llama3-1b is refused, as the reference refuses it '
        f'(the repo\'s llama3-1b has a {small.vocab_size}-token vocabulary, '
        f'Llama-3-8B {target_cfg.vocab_size})')
    argv = ['--model', 'llama3-8b', '--draft-model', 'llama3-1b',
            '--spec-gamma', str(SPEC_GAMMA), '--max-slots', str(r['slots']),
            '--max-target-len', str(r['max_len']), '--port', '0',
            '--device', 'cuda']
    try:
        server_lib.build_replica(server_lib.parse_args(argv),
                                 host='127.0.0.1')
    except ValueError as e:
        if str(e) != 'draft/target vocab_size must match':
            raise
        log(f'  refused: ValueError({str(e)!r})')
    else:
        raise AssertionError('--draft-model llama3-1b was not refused')
    release_card()

    draft_cfg = dataclasses.replace(small, vocab_size=target_cfg.vocab_size,
                                    remat=False)
    log(f'  served instead: Llama-3-8B (bf16, {target_cfg.n_layers} layers, '
        f'seed 0) with a draft at llama3-1b\'s widths ({draft_cfg.n_layers} '
        f'layers, d_model {draft_cfg.d_model}) and Llama-3\'s '
        f'{draft_cfg.vocab_size}-token vocabulary (seed 1), as the server '
        f'wires --draft-model: SpeculativeOrchestrator, warm_up, '
        f'ServingLoop and the HTTP handler on 127.0.0.1; {r["slots"]} '
        f'slots, max_target_len {r["max_len"]}')
    t0 = time.perf_counter()
    engines = []
    for cfg, seed in ((target_cfg, 0), (draft_cfg, 1)):
        gen = torch.Generator(device='cuda')
        gen.manual_seed(seed)
        engines.append(engine_lib.InferenceEngine(
            engine_lib.EngineConfig(model=cfg, max_slots=r['slots'],
                                    max_target_len=r['max_len']),
            llama.init(cfg, gen)))
    engine, draft = engines
    orch = orch_lib.SpeculativeOrchestrator(engine, draft, gamma=SPEC_GAMMA)
    server_lib.warm_up(orch)
    loop = server_lib.ServingLoop(orch)
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), server_lib.build_handler(
        loop, engine.config, model_id='llama3-8b', max_queue=64))
    torch.cuda.synchronize()
    log(f'  init + engines + warm-up {time.perf_counter() - t0:.2f} s; '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{httpd.server_address[1]}'
    rng = np.random.default_rng(24)
    # 960-1024 tokens, so that both engines prefill in the flash kernel's
    # 1024 bucket.
    prompts = [[int(t) for t in rng.integers(0, target_cfg.vocab_size, n)]
               for n in rng.integers(960, 1025, r['requests'])]
    sampled = [int(t) for t in rng.integers(0, target_cfg.vocab_size, 1000)]
    bodies = ([{'prompt_tokens': p, 'max_new_tokens': r['new_tokens']}
               for p in prompts]
              + [{'prompt_tokens': sampled, 'max_new_tokens': SAMPLED_NEW,
                  'temperature': 1.0}])
    singles = [prompts[0]]
    n_flash = flash_prefills(engine, singles + prompts + [sampled])

    def want(n_plain, n_spec):
        return {'flash_fwd': (target_cfg.n_layers + draft_cfg.n_layers)
                * n_flash,
                'decode_attention': draft_cfg.n_layers * (SPEC_GAMMA + 1)
                * n_spec + target_cfg.n_layers * n_plain}

    try:
        streams, numbers = serve_speculative(
            '[24]', records, 'llama_spec_draft', url, orch, loop, singles,
            bodies, want)
    finally:
        httpd.shutdown()
        httpd.server_close()
        loop.close()
    orch.state = orch.draft_state = None
    release_card()
    expected = plain_streams(engine, prompts, r['new_tokens'])
    check_ties('[24]', engine, prompts, streams[:len(prompts)], expected)
    del orch, loop, httpd, engine, draft, engines
    release_card()

    cfg = dataclasses.replace(small, remat=False)
    log(f'  self-draft: Llama-3-1B (llama3-1b, bf16, {cfg.n_layers} layers, '
        f'seed 0) drafting for itself (one engine, two caches), '
        f'{r["slots"]} slots, {r["requests"]} prompts of 960-1024 tokens x '
        f'{r["new_tokens"]} new')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=r['slots'],
                                max_target_len=r['max_len']),
        llama.init(cfg, gen))
    orch = orch_lib.SpeculativeOrchestrator(engine, engine, gamma=SPEC_GAMMA)
    plain_rounds = count_plain_rounds(orch)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(960, 1025, r['requests'])]
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, r['new_tokens'])
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    stats = orch.accept_stats
    check_derived_launches('llama3-1b self-draft', launches, {
        'flash_fwd': 2 * cfg.n_layers * flash_prefills(engine, prompts),
        'decode_attention': cfg.n_layers * (
            (SPEC_GAMMA + 1) * stats['rounds'] + plain_rounds[0])})
    for name, n in launches.items():
        if n:
            records[name].setdefault('launches_by_path', {})[
                'llama_spec_self_draft'] = n
    acceptance = stats['accepted'] / stats['proposed']
    out_tokens = sum(len(q.output_tokens) for q in requests)
    log(f'  self-draft: {out_tokens / dt:.1f} output tok/s, {stats} '
        f'(acceptance {acceptance:.4f}, at least {SELF_DRAFT_MIN_ACCEPT}); '
        f'launches {launches} as derived, on {nvidia_smi_line()}')
    if acceptance < SELF_DRAFT_MIN_ACCEPT:
        raise AssertionError(f'self-draft acceptance {acceptance:.4f} < '
                             f'{SELF_DRAFT_MIN_ACCEPT}')
    del orch, engine
    release_card()


def small_speculative_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import qwen
    log('[25] small speculative checks, card (kernels, TF32 off) vs CPU '
        '(plain versions): fp32 LLAMA_TINY and qwen3-tiny targets, bucket '
        '1024 (so the flash kernel runs); NgramSpeculator, '
        'SpeculativeOrchestrator with a one-layer draft and with the target '
        'drafting for itself: tokens and accept_stats')
    draft_cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32,
                                    n_layers=1, d_model=32, n_heads=2,
                                    n_kv_heads=2, d_ff=64)
    gen = torch.Generator()
    gen.manual_seed(26)
    draft_params = llama.init(draft_cfg, gen, device='cpu')
    for label, cfg in (
            ('llama-tiny', dataclasses.replace(llama.LLAMA_TINY,
                                               dtype=torch.float32)),
            ('qwen3-tiny', qwen.QWEN3_TINY_F32)):
        if label == 'qwen3-tiny':
            params = small_qwen_params(cfg, seed=25)
        else:
            gen = torch.Generator()
            gen.manual_seed(25)
            params = llama.init(cfg, gen, device='cpu')
        rng = np.random.default_rng(25)
        prompts = ([[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                    for n in (1000, 700, 20)]
                   + [[int(t) for t in rng.integers(0, cfg.vocab_size, 64)]
                      * 8])
        runs, used = {}, {}
        for device in ('cuda', 'cpu'):
            before = {k.name: k.launches for k in kernels.REGISTRY}

            def engine(c, p):
                return engine_lib.InferenceEngine(
                    engine_lib.EngineConfig(model=c, max_slots=4,
                                            max_target_len=1100,
                                            prefill_buckets=(1024,),
                                            kv_dtype=torch.float32),
                    to_device(p, device), device=device)

            target, draft = engine(cfg, params), engine(draft_cfg,
                                                        draft_params)
            run = {'plain': (orch_lib.Orchestrator(target).generate(
                prompts, max_new_tokens=12), None)}
            for kind, spec in (
                    ('ngram', orch_lib.NgramSpeculator(target,
                                                       gamma=SPEC_GAMMA)),
                    ('draft', orch_lib.SpeculativeOrchestrator(
                        target, draft, gamma=SPEC_GAMMA)),
                    ('self-draft', orch_lib.SpeculativeOrchestrator(
                        target, target, gamma=SPEC_GAMMA))):
                run[kind] = (spec.generate(prompts, max_new_tokens=12),
                             dict(spec.accept_stats))
            runs[device] = run
            used[device] = {k.name: k.launches - before[k.name]
                            for k in kernels.REGISTRY}
        card, cpu = runs['cuda'], runs['cpu']
        log(f'  {label}: card {card}; card launches {used["cuda"]}')
        if card != cpu:
            raise AssertionError(f'{label}: the card gave other tokens or '
                                 f'accept_stats than the CPU: {cpu}')
        for device, run in runs.items():
            for kind, (tokens, stats) in run.items():
                if tokens != run['plain'][0]:
                    raise AssertionError(f'{label} on {device}: {kind} gave '
                                         'other tokens than plain greedy')
                if stats is not None and not stats['rounds']:
                    raise AssertionError(f'{label}: {kind} never speculated')
            stats = run['self-draft'][1]
            if stats['accepted'] != stats['proposed']:
                raise AssertionError(f'{label} on {device}: the fp32 '
                                     f'self-draft rejected proposals: {stats}')
        if not all(used['cuda'][name] for name in SERVE_KERNELS):
            raise AssertionError(f'a kernel did not run on the card: '
                                 f'{used["cuda"]}')
    release_card()


# ---- phases 26-27: the Gemma family ----

# Phase [26]: Gemma2-9B behind infer/server.py, 8 slots over an 8192-row
# cache (the model's context); two prompts of 6000-8000 tokens one at a
# time (past the even layers' window of 4096: prefilled in 1024-token
# chunks, then decoded over their live window alone), then 8 concurrent
# prompts of 1000-1024 tokens (one prefill bucket, the flash kernel's).
GEMMA_SERVE = dict(slots=8, max_len=8192, long=(6000, 8000),
                   prompt_len=(1000, 1024), requests=8, new_tokens=64)


def count_flash_waves(engine) -> list:
    """Wrap the engine's prefill forward so that a run can count the
    waves whose bucket reaches the flash kernel's shortest sequence (one
    K1 launch per layer each); prompt chunks take the plain attention."""
    from skypilot_tpu_torch.ops import attention
    waves = [0]
    prefill = engine._prefill_batch

    def counted(tokens, *args, **kwargs):
        waves[0] += int(tokens.shape[1] >= attention._FLASH_MIN_SEQ)
        return prefill(tokens, *args, **kwargs)

    engine._prefill_batch = counted
    return waves


def gemma2_replica(records: dict) -> None:
    import threading
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import gemma
    cfg = gemma.GEMMA2_9B
    r = GEMMA_SERVE
    kv_gb = (2 * cfg.n_layers * r['slots'] * r['max_len'] * cfg.n_kv_heads
             * cfg.head_dim * 2 / 1e9)
    log(f'[26] Gemma2-9B replica on one card: bf16 ({cfg.n_layers} layers, '
        f'd_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of '
        f'{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied '
        f'head, softcaps {cfg.attn_logit_softcap:g}/'
        f'{cfg.final_logit_softcap:g}, window {cfg.sliding_window} on even '
        f'layers; {cfg.num_params() / 1e9:.2f} B parameters), seeded '
        f'random weights; infer/server.py --model gemma2-9b --max-slots '
        f'{r["slots"]} --max-target-len {r["max_len"]} on 127.0.0.1 (KV '
        f'cache {kv_gb:.1f} GB)')
    t0 = time.perf_counter()
    replica = server_lib.build_replica(server_lib.parse_args([
        '--model', 'gemma2-9b', '--max-slots', str(r['slots']),
        '--max-target-len', str(r['max_len']), '--port', '0',
        '--device', 'cuda']), host='127.0.0.1')
    torch.cuda.synchronize()
    log(f'  init + engine + warm-up {time.perf_counter() - t0:.2f} s; '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    steps = count_decode_steps(replica.engine)
    waves = count_flash_waves(replica.engine)
    rng = np.random.default_rng(26)
    singles = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(r['long'][0], r['long'][1] + 1, 2)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(r['prompt_len'][0],
                                     r['prompt_len'][1] + 1, r['requests'])]
    try:
        # The served requests' own launches: counted from here (after the
        # warm-up) and read before anything else runs on the engine.
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        steps[0] = waves[0] = 0
        t0 = time.perf_counter()
        served = [http_json(url, '/generate', {
            'prompt_tokens': p, 'max_new_tokens': r['new_tokens']})[
                'output_tokens'] for p in singles]
        singles_s = time.perf_counter() - t0
        before = http_json(url, '/metrics')
        _, dt = concurrent_generate(url, [
            {'prompt_tokens': p, 'max_new_tokens': r['new_tokens']}
            for p in prompts], cfg.vocab_size)
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        n_waves, n_steps = waves[0], steps[0]
        after = http_json(url, '/metrics')
        check_derived_launches('gemma2-9b replica', launches, {
            'flash_fwd': cfg.n_layers * n_waves,
            'decode_attention': cfg.n_layers * n_steps})
        if not n_waves or not n_steps:
            raise AssertionError(f'{n_waves} flash waves, {n_steps} '
                                 'decode steps')
        for name in SERVE_KERNELS:
            records[name].setdefault('launches_by_path', {})[
                'gemma_serve'] = launches[name]
        ttft_n = (metric(after, 'xsky_serve_ttft_seconds_count')
                  - metric(before, 'xsky_serve_ttft_seconds_count'))
        ttft_s = (metric(after, 'xsky_serve_ttft_seconds_sum')
                  - metric(before, 'xsky_serve_ttft_seconds_sum'))
        if ttft_n != r['requests']:
            raise AssertionError(f'{ttft_n} TTFT samples for '
                                 f'{r["requests"]} requests')
        peak = torch.cuda.max_memory_allocated() / 2**30
        # The server adds nothing: the long prompts sent one at a time
        # give the tokens of Orchestrator.generate on the same engine,
        # run with the serving loop held.
        with replica.loop._lock:
            direct = [replica.loop.orch.generate(
                [p], max_new_tokens=r['new_tokens'])[0] for p in singles]
        if served != direct:
            raise AssertionError('the server gave other tokens than '
                                 'Orchestrator.generate')
        out_tokens = r['requests'] * r['new_tokens']
        log(f'  prompts of {[len(p) for p in singles]} tokens one at a time '
            f'({singles_s:.2f} s): the served tokens equal '
            'Orchestrator.generate on the same engine')
        log(f'  {r["requests"]} concurrent POST /generate (prompts of '
            f'{min(map(len, prompts))}-{max(map(len, prompts))} tokens) x '
            f'{r["new_tokens"]} tokens in {dt:.3f} s: {out_tokens / dt:.1f} '
            f'output tok/s, mean TTFT {ttft_s / ttft_n * 1e3:.1f} ms '
            f'(/metrics), peak memory {peak:.2f} GiB; served launches '
            f'{launches} = {cfg.n_layers} layers x ({n_waves} flash waves, '
            f'{n_steps} decode steps) on {nvidia_smi_line()}')
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()
    del replica
    release_card()


def small_gemma_params(cfg, seed: int):
    """The port's init for cfg on the CPU, every norm drawn 0.3 N(0, 1):
    zero norms are the identity under Gemma's (1 + w) scaling and would
    not show a misplaced one."""
    from skypilot_tpu_torch.models import gemma
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = gemma.init(cfg, gen, device='cpu')
    for parent in (params['layers'], params):
        for key, value in parent.items():
            if key.endswith('_norm'):
                value.copy_(0.3 * torch.randn(value.shape, generator=gen))
    return params


def small_gemma_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import gemma
    log('[27] small Gemma checks, card (kernels, TF32 off) vs CPU (plain '
        'versions): fp32 gemma-tiny, gemma2-tiny (window 8) and gemma2-tiny '
        'at head_dim 256 (4 heads x 256 over d_model 64), random norms, '
        'bucket 1024 (so the flash kernel runs, past the window): served '
        'greedy tokens; a chunked prefill with a prefix-cache hit against '
        'the whole prompt in one 2048 bucket; NgramSpeculator against plain '
        'greedy')
    d256 = dataclasses.replace(gemma.GEMMA2_TINY_F32, head_dim=256)
    for label, cfg in (('gemma-tiny', gemma.GEMMA_TINY_F32),
                       ('gemma2-tiny', gemma.GEMMA2_TINY_F32),
                       ('gemma2-tiny D256', d256)):
        cpu_params = small_gemma_params(cfg, seed=27)
        rng = np.random.default_rng(27)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                   for n in (1024, 700, 913, 64)]
        copy = [int(t) for t in rng.integers(0, cfg.vocab_size, 64)] * 8
        long = [int(t) for t in rng.integers(0, cfg.vocab_size, 1500)]
        hit = long[:1200] + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                          100)]

        def engine(device, **kw):
            return engine_lib.InferenceEngine(
                engine_lib.EngineConfig(model=cfg, max_slots=4,
                                        kv_dtype=torch.float32, **kw),
                to_device(cpu_params, device), device=device)

        runs, used = {}, {}
        for device in ('cuda', 'cpu'):
            before = {k.name: k.launches for k in kernels.REGISTRY}
            served_engine = engine(device, max_target_len=1100,
                                   prefill_buckets=(1024,))
            served = orch_lib.Orchestrator(served_engine).generate(
                prompts + [copy], max_new_tokens=12)
            spec = orch_lib.NgramSpeculator(served_engine, gamma=SPEC_GAMMA)
            ngram = spec.generate(prompts + [copy], max_new_tokens=12)
            cached = engine(device, max_target_len=2100,
                            prefill_buckets=(1024,), prefix_cache_entries=4)
            chunked = [t for p in (long, hit) for t in orch_lib.Orchestrator(
                cached, decode_steps=4).generate([p], max_new_tokens=8)]
            whole = orch_lib.Orchestrator(
                engine(device, max_target_len=2100, prefill_buckets=(2048,)),
                decode_steps=4).generate([long, hit], max_new_tokens=8)
            used[device] = {k.name: k.launches - before[k.name]
                            for k in kernels.REGISTRY}
            runs[device] = dict(served=served, ngram=ngram,
                                stats=dict(spec.accept_stats),
                                chunked=chunked, whole=whole,
                                cache=cached.prefix_cache_stats)
        card, cpu = runs['cuda'], runs['cpu']
        log(f'  {label}: card tokens {card["served"]}; ngram '
            f'{card["stats"]}; chunked + prefix hit {card["chunked"]} '
            f'({card["cache"]}); card launches {used["cuda"]}')
        if card != cpu:
            raise AssertionError(f'{label}: the card and the CPU differ: '
                                 f'{card} vs {cpu}')
        for device, run in runs.items():
            if run['ngram'] != run['served'] or not run['stats']['rounds']:
                raise AssertionError(f'{label} on {device}: NgramSpeculator '
                                     f'gave {run["ngram"]} ({run["stats"]}), '
                                     f'plain greedy {run["served"]}')
            if run['chunked'] != run['whole'] or not run['cache']['hits']:
                raise AssertionError(
                    f'{label} on {device}: the chunked prefill with a '
                    f'prefix-cache hit gave {run["chunked"]}, the whole '
                    f'prompt {run["whole"]} ({run["cache"]})')
        for name, n in used['cuda'].items():
            if (n > 0) != (name in SERVE_KERNELS):
                raise AssertionError(f'{label}: {name} ran {n} times on the '
                                     f'card: {used["cuda"]}')
    release_card()


# ---- phases 28-29: Gemma training ----

# Phase [28]: Gemma2-2B as `train/launch.py --model gemma2-2b --seq-len 8192
# --global-batch-size 1 --optimizer adafactor` runs it: 2 warm-up and 5
# measured steps, then a run of 2 steps that checkpoints and one resumed
# from it to step 4.
GEMMA_TRAIN = dict(model='gemma2-2b', seq=8192, batch=1, warmup=2,
                   measured=5, saved=2, resumed=4)


def gemma_head_ms(cfg, seq: int) -> float:
    """Device time of the tied fp32 head's forward and backward on one
    row of seq tokens, as a training step runs it: the product against
    the embedding in fp32 (_UpcastMatmul, FFMA), the final softcap, the
    cross-entropy, and the gradients of the hidden states and the
    embedding."""
    from skypilot_tpu_torch.models import gemma
    from skypilot_tpu_torch.models import llama
    gen = torch.Generator(device='cuda')
    gen.manual_seed(28)
    x = torch.randn((1, seq, cfg.d_model), generator=gen, device='cuda').to(
        cfg.dtype).requires_grad_()
    embed = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                         device='cuda') * cfg.d_model ** -0.5).to(
        cfg.dtype).requires_grad_()
    targets = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                            device='cuda')

    def head():
        nll = llama._token_nll(gemma.lm_logits(cfg, {'embed': embed}, x),
                               targets)
        torch.autograd.grad(nll.mean(), (x, embed))

    # CUDA events without time_ms's hold: the host queues a run in ~0.1 s
    # (its 8.4 GB tensors wait on the allocator), far less than the run's
    # device time, so nothing of the host's shows between the events.
    head()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        head()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 3
    del x, embed, targets
    release_card()
    return ms


def gemma_train_path(records: dict) -> None:
    import tempfile
    from skypilot_tpu_torch.models import gemma
    cfg = gemma.GEMMA2_2B
    r = GEMMA_TRAIN
    steps = r['warmup'] + r['measured']
    # Each step runs K2 and K3 once a layer, and K1 twice: the remat
    # policy ('dots') saves the weight products only, so the backward
    # recomputes each layer's attention forward.
    k1_factor = 2 if cfg.remat else 1

    def derived(n):
        return {'flash_fwd': k1_factor * cfg.n_layers * n,
                'flash_bwd_dkv': cfg.n_layers * n,
                'flash_bwd_dq': cfg.n_layers * n}

    log(f'[28] Gemma2-2B training on one card through train/launch.py: '
        f'bf16 ({cfg.n_layers} layers, d_model {cfg.d_model}, '
        f'{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff '
        f'{cfg.d_ff}, vocab {cfg.vocab_size}, tied fp32 head, softcaps '
        f'{cfg.attn_logit_softcap:g}/{cfg.final_logit_softcap:g}, window '
        f'{cfg.sliding_window} on even layers, remat {cfg.remat_policy}; '
        f'{cfg.num_params() / 1e9:.2f} B parameters), seeded random '
        f'weights; --model {r["model"]} --seq-len {r["seq"]} '
        f'--global-batch-size {r["batch"]} --optimizer adafactor (the '
        f'learning-rate warm-up cut to 1 step) over uint32 token shards: '
        f'{steps} steps '
        f'({r["warmup"]} warm-up + {r["measured"]} measured); {r["saved"]} '
        f'steps with --checkpoint-every {r["saved"]}, then --steps '
        f'{r["resumed"]} --resume auto')
    with tempfile.TemporaryDirectory(prefix='xsky-gemma-train-') as tmp:
        data = write_token_shards(os.path.join(tmp, 'tokens'),
                                  steps * r['batch'] * r['seq'] + 1,
                                  cfg.vocab_size, seed=28)
        common = ['--model', r['model'], '--global-batch-size',
                  str(r['batch']), '--seq-len', str(r['seq']),
                  '--optimizer', 'adafactor', '--device', 'cuda',
                  '--log-every', '1', '--data', data, '--data-loader',
                  'python']
        ckpt = os.path.join(tmp, 'ckpt')
        metrics = os.path.join(tmp, 'metrics.jsonl')
        runs = {}
        with short_warmup(1):
            torch.cuda.reset_peak_memory_stats()
            runs['solid'] = launch_run(
                common + ['--steps', str(steps), '--metrics-file', metrics],
                'Gemma2-2B launch', kernels_wanted=None)
            peak = torch.cuda.max_memory_allocated()
            del runs['solid']['state'], runs['solid']['trainer']
            release_card()
            runs['saved'] = launch_run(
                common + ['--steps', str(r['saved']), '--checkpoint-every',
                          str(r['saved']), '--checkpoint-dir', ckpt],
                'Gemma2-2B launch (checkpoint)', kernels_wanted=None)
            del runs['saved']['state'], runs['saved']['trainer']
            release_card()
            runs['resumed'] = launch_run(
                common + ['--steps', str(r['resumed']), '--resume', 'auto',
                          '--checkpoint-dir', ckpt],
                'Gemma2-2B launch (resumed)', kernels_wanted=None)
            del runs['resumed']['state'], runs['resumed']['trainer']
            release_card()
        rows = [json.loads(line) for line in open(metrics, encoding='utf-8')]
    solid, resumed = runs['solid'], runs['resumed']
    for label, n in (('solid', steps), ('saved', r['saved']),
                     ('resumed', r['resumed'] - r['saved'])):
        check_derived_launches(f'Gemma2-2B launch ({label})',
                               runs[label]['launches'], derived(n))
    want = f'Resumed from checkpoint step {r["saved"]}.'
    if want not in resumed['log']:
        raise AssertionError(f'no resume line in {resumed["log"]}')
    later = range(r['saved'] + 1, r['resumed'] + 1)
    if sorted(resumed['losses']) != list(later):
        raise AssertionError(f'resumed run logged {resumed["losses"]}')
    errs = {k: abs(resumed['losses'][k] - solid['losses'][k]) /
            abs(solid['losses'][k]) for k in later}
    losses = [solid['losses'][k] for k in sorted(solid['losses'])]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f'Gemma2-2B losses {losses}')
    log(f'  uninterrupted losses {losses}; resumed from step {r["saved"]} '
        f'({resumed["restore"]["tier"]} tier in '
        f'{resumed["restore"]["seconds"]:.3f} s): {resumed["losses"]}, '
        f'relative differences {errs} (tolerance {RESUME_RTOL:g}), '
        f'bit-identical: {all(e == 0 for e in errs.values())}')
    if max(errs.values()) > RESUME_RTOL:
        raise AssertionError('resumed losses differ from the uninterrupted '
                             'run')
    measured = rows[r['warmup']:]
    tps = float(np.mean([row['tokens_per_sec'] for row in measured]))
    tflops = float(np.mean([row['model_tflops_per_chip'] for row in measured]))
    step_ms = r['batch'] * r['seq'] / tps * 1e3
    head = gemma_head_ms(cfg, r['seq'])
    shares = phase_shares(solid['records'][r['warmup']:])
    totals = {name: sum(runs[label]['launches'][name] for label in runs)
              for name in TRAIN_KERNELS}
    for name in TRAIN_KERNELS:
        records[name].setdefault('launches_by_path', {})['gemma_train'] = (
            totals[name])
    log(f'  measured steps {r["warmup"] + 1}-{steps}: {tps:.1f} tokens/s, '
        f'step {step_ms:.1f} ms, model {tflops:.2f} TFLOP/s = '
        f'{tflops / (PEAK_FLOPS[torch.bfloat16] / 1e12):.4f} of the bf16 '
        f'peak (6N + 12LdS); peak memory {peak / 2**30:.2f} GiB; the fp32 '
        f'tied head (forward + backward, timed alone at one 8192-token row) '
        f'{head:.2f} ms = {head / step_ms:.4f} of a step')
    log("  flight recorder shares of the measured steps' wall: " + ', '.join(
        f'{k} {v:.4f}' for k, v in shares.items()))
    log(f'  launches per run {[runs[label]["launches"] for label in runs]} '
        f'= {cfg.n_layers} layers x steps (K1 x {k1_factor}); decode '
        f'kernels 0; on {nvidia_smi_line()}')


def small_gemma_train_checks() -> None:
    from skypilot_tpu_torch.models import gemma
    from skypilot_tpu_torch.train import trainer as trainer_lib
    log('[29] small Gemma training checks, card (kernels, TF32 off) vs CPU '
        '(plain versions): fp32 gemma-tiny, gemma2-tiny (window 8) and '
        'gemma2-tiny at head_dim 256 (4 heads x 256 over d_model 64), '
        'random norms, seq 1024 (so the flash kernels run), adafactor, '
        'accum_steps=2: 3 Trainer steps each; then 3 LoRA steps (rank 4, '
        'wq,wk,wv,wo) on the head_dim-256 config')
    d256 = dataclasses.replace(gemma.GEMMA2_TINY_F32, head_dim=256)
    rng = np.random.default_rng(29)
    tokens = rng.integers(0, 256, (2, 1024))
    batch = {'tokens': torch.from_numpy(tokens),
             'targets': torch.from_numpy(np.roll(tokens, -1, axis=1))}
    for label, cfg, rank in (('gemma-tiny', gemma.GEMMA_TINY_F32, 0),
                             ('gemma2-tiny', gemma.GEMMA2_TINY_F32, 0),
                             ('gemma2-tiny D256', d256, 0),
                             ('gemma2-tiny D256 LoRA', d256, 4)):
        tcfg = trainer_lib.TrainConfig(
            model=cfg, global_batch_size=2, seq_len=1024,
            optimizer='adafactor', accum_steps=2, learning_rate=1e-3,
            warmup_steps=2, lora_rank=rank)
        runs = {}
        for device in ('cuda', 'cpu'):
            before = {k.name: k.launches for k in kernels.REGISTRY}
            tr = trainer_lib.Trainer(tcfg, device=device)
            state = tr.init_state(to_device(small_gemma_params(cfg, 29),
                                            device))
            on_device = {k: v.to(device) for k, v in batch.items()}
            metrics = []
            for _ in range(3):
                state, m = tr.step(state, on_device)
                metrics.append((float(m['loss']), float(m['grad_norm'])))
            used = {k.name: k.launches - before[k.name]
                    for k in kernels.REGISTRY}
            runs[device] = (metrics, trainer_lib.param_leaves(
                state['params']), state.get('base'), used)
        (card, card_params, card_base, used), (cpu, cpu_params, _, _) = (
            runs['cuda'], runs['cpu'])
        err = max(float((a.detach().cpu() - b.detach()).abs().max())
                  for a, b in zip(card_params, cpu_params))
        log(f'  {label}: card (loss, grad_norm) {card}; CPU {cpu}; '
            f'parameters max_abs_err {err:.3e} (tolerances: losses atol '
            f'{TRAIN_LOSS_ATOL:g}, grad norms rtol {TRAIN_NORM_RTOL:g}, '
            f'parameters atol {TRAIN_PARAM_ATOL:g}); card launches {used}')
        for (lc, nc), (lp, npl) in zip(card, cpu):
            if abs(lc - lp) > TRAIN_LOSS_ATOL or abs(nc - npl) > (
                    TRAIN_NORM_RTOL * abs(npl)):
                raise AssertionError(f'{label}: loss or grad norm differs '
                                     'between the card and the CPU')
        if err > TRAIN_PARAM_ATOL:
            raise AssertionError(f'{label}: parameters differ between the '
                                 'card and the CPU after three steps')
        for name, n in used.items():
            if (n > 0) != (name in TRAIN_KERNELS):
                raise AssertionError(f'{label}: {name} ran {n} times on the '
                                     f'card: {used}')
        if card_base is not None:
            init = small_gemma_params(cfg, 29)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(
                    trainer_lib.param_leaves(card_base),
                    trainer_lib.param_leaves(init))):
                raise AssertionError(f'{label}: the frozen base changed')
            log('    LoRA: the base on the card is bit-identical to its '
                'init')
    release_card()


def hopper_kernels(build_log: str):
    """(name, registers, spill-store bytes) of each wgmma kernel and
    pre-pass, of the fp32 flash backward at D 256, of the decode split
    walks and combine at the main paths' types (bf16 queries and cache,
    D 128 and 256), and of the MLA tensor-core walks (bf16 cache), in an
    nvcc -Xptxas -v log."""
    for chunk in build_log.split('Compiling entry function')[1:]:
        mangled = chunk.split("'")[1]
        found = re.search(r'(flash_[a-z_]+_(?:wgmma|rowstats)_kernel)ILi(\d+)',
                          mangled) or re.search(
            r'(flash_bwd_[a-z]+_fma_kernel)ILi(256)E', mangled) or re.search(
            r'((?:paged_)?decode_kernel)I13__nv_bfloat16S\w*?_Li'
            r'((?:128|256)ELi\d)E',
            mangled) or re.search(
            r'(decode_combine_kernel)I13(__nv_bfloat16)E',
            mangled) or re.search(
            r'((?:paged_)?mla_decode_tc_kernel)E', mangled)
        regs = re.search(r'Used (\d+) registers', chunk)
        spill = re.search(r'(\d+) bytes spill stores', chunk)
        if found and regs:
            args = (f'<{found.group(2)}>'.replace('ELi', ', groups <= ')
                    if found.lastindex > 1 else '')
            yield (f'{found.group(1)}{args}', int(regs.group(1)),
                   int(spill.group(1)) if spill else 0)


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
        for chunk in build_log.split('Compiling entry function')[1:]:
            spilled = re.search(r'(\d+) bytes spill stores', chunk)
            if spilled and int(spilled.group(1)):
                log(f'    spills {spilled.group(1)} bytes: '
                    f'{chunk.split(chr(39))[1]}')
        for name, regs, spill in hopper_kernels(build_log):
            note = (' at entry (setmaxnreg then splits them)'
                    if 'wgmma' in name or 'rowstats' in name else '')
            log(f'    {name}: {regs} registers{note}, {spill} bytes spilled')
            if name.startswith('flash_bwd') and '<256>' in name and spill:
                raise AssertionError(f'{name} spills {spill} bytes')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    records = {'flash_fwd': check_flash(gen), **check_flash_bwd(gen),
               'decode_attention': check_decode(gen),
               'paged_decode_attention': check_paged_decode(gen),
               'mla_decode': check_mla_decode(gen),
               'paged_mla_decode': check_paged_mla_decode(gen)}
    main_path(records)
    small_end_to_end()
    train_result = train_main_path(records)
    small_train_check()
    paged_main_path(records)
    small_paged_end_to_end()
    deepseek_main_paths(records)
    small_deepseek_end_to_end()
    quantized_replica(records, 'int8')
    quantized_replica(records, 'int4')
    small_quantized_end_to_end()
    launch_main_path(records, train_result)
    lora_main_path(records)
    hf_checkpoint_path(records)
    small_launch_checks()
    plain_qwen = qwen_replica(records)
    qwen2_main_path(records)
    small_qwen_end_to_end()
    spec_qwen_replica(records, plain_qwen)
    draft_model_paths(records)
    small_speculative_end_to_end()
    gemma2_replica(records)
    small_gemma_end_to_end()
    gemma_train_path(records)
    small_gemma_train_checks()
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
