#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: require CUDA, print the card's name and power limit, turn
     TF32 off for fp32 products;
  2. build: compile every kernel in skypilot_tpu_torch/csrc/ (one nvcc
     per source, all at once) and print the build seconds;
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main path's shapes and in the window / segment /
     softcap / int8 / ragged-length cases, in bf16 and fp32, with each
     error beside its tolerance; kernel, plain and library times and the
     least time the card could take (bound);
  4. main path: Llama-3-8B (bf16, random weights from a seeded
     torch.Generator) served by InferenceEngine + Orchestrator: 16
     prompts of ~1000 tokens, 64 new tokens each; the kernels' launch
     counts are zeroed just before and read just after;
  5. small end to end: an fp32 model at LLAMA_TINY widths with prefill
     bucket 1024 (so the flash kernel runs) served on the card and on
     the CPU (plain versions); the greedy tokens must be identical.

The second-to-last lines are the kernels' JSON record and the
`nvidia-smi` name/power-limit line; the last line is
{"ok": true, "device": {...}}. Nothing of JAX is imported.
"""
from __future__ import annotations

import dataclasses
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

REPLACES = {
    'flash_fwd': 'skypilot_tpu/ops/flash_attention.py:64',
    'decode_attention': 'skypilot_tpu/ops/decode_attention.py:73',
}


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


def rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device='cuda').to(dtype)


# ---- phase 3: kernel checks ----

def flash_case(gen, label, dtype, b, s, h, h_kv, d, causal=True,
               window=None, segments=False, softcap=None, scale=None):
    q = rand(gen, (b, s, h, d), dtype)
    k = rand(gen, (b, s, h_kv, d), dtype)
    v = rand(gen, (b, s, h_kv, d), dtype)
    seg = None
    if segments:
        # Three packed documents per row, boundaries differing by row.
        cuts = torch.tensor([[s // 3 + 7 * i, 2 * s // 3 - 5 * i]
                             for i in range(b)], device='cuda')
        pos = torch.arange(s, device='cuda')[None, :]
        seg = ((pos >= cuts[:, :1]).int() + (pos >= cuts[:, 1:]).int()
               ).to(torch.int32).contiguous()
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
    if any(n == 0 for n in lengths):
        zero = [i for i, n in enumerate(lengths) if n == 0]
        if bool(out[zero].float().abs().max() != 0):
            raise AssertionError('decode: a length-0 slot must give zeros')
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


# ---- phase 4: main path ----

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
    for kern in kernels.REGISTRY:
        kern.launches = 0
    t0 = time.perf_counter()
    requests = [orch.submit(orch_lib.Request(prompt_tokens=p,
                                             max_new_tokens=new_tokens))
                for p in prompts]
    orch.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    for r in requests:
        if r.error or len(r.output_tokens) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(
                f'request {r.request_id}: error={r.error}, '
                f'{len(r.output_tokens)} tokens')
    for name, n in launches.items():
        if n == 0 or n % cfg.n_layers:
            raise AssertionError(f'{name}: {n} launches on the main path '
                                 f'(want a positive multiple of '
                                 f'{cfg.n_layers} layers)')
        records[name]['launches'] = n
    out_tokens = sum(len(r.output_tokens) for r in requests)
    ttft = [r.first_token_at - r.submitted_at for r in requests]
    log(f'  16 requests x {new_tokens} tokens done in {dt:.3f} s: '
        f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
        f'{np.mean(ttft) * 1e3:.1f} ms, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
        f'launches {launches} on {nvidia_smi_line()}')
    del orch, engine, params
    torch.cuda.empty_cache()


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
    if not all(used.values()):
        raise AssertionError(f'a kernel did not run on the card: {used}')


def main() -> int:
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
    log(f'[2] built {len(seconds)} kernels in '
        f'{time.perf_counter() - t0:.2f} s wall: {seconds}')
    for kern in kernels.REGISTRY:
        regs = re.findall(r'Used (\d+) registers', kern.build_log)
        spills = re.findall(r'(\d+) bytes spill stores', kern.build_log)
        if regs:
            log(f'  {kern.name}: {len(regs)} instantiations, at most '
                f'{max(map(int, regs))} registers, '
                f'{sum(map(int, spills))} bytes spilled')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    records = {'flash_fwd': check_flash(gen),
               'decode_attention': check_decode(gen)}
    main_path(records)
    small_end_to_end()
    print(json.dumps({'kernels': list(records.values())}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
