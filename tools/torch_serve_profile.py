#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one card.

Runs the same configuration as ``chip_smoke.py``'s main path (Llama-3-8B
bf16 with random weights, 16 slots, bucket 1024, dense bf16 KV), warms it
up with one full generate, then traces one prefill wave of 16 prompts
and one fused decode tick (8 steps), and on a dense engine one
speculative verify round (``engine.verify_step``, γ = 4 proposals a
slot), with ``torch.profiler``. For each it
prints the host wall time, the device busy time (sum of kernel times —
one stream, so kernels do not overlap), the idle share, the number of
kernel launches, the device time by kind of kernel (the port's own
kernels, matrix products, index operations, the rest) and the kernels
that take the most time. A JSON summary goes to
``chiprun_out/torch_serve_profile[_paged][_<model>].json``.

    python3 tools/torch_serve_profile.py [--paged] [--model MODEL]
        [--weight-dtype bf16|int8|int4] [--kv-dtype bf16|int8]

With ``--paged`` it runs ``chip_smoke.py``'s paged main path instead (32
slots over 2048 pages of 16 rows, max_target_len 4096; 30 prompts, as
many as the arena holds at once), and, for a family with chunked
prefill, also traces one 1024-token prompt chunk. ``--model
deepseek-v2-lite`` serves DeepSeek-V2-Lite (``chip_smoke.py`` [10] and
[11]) in place of the default ``llama3-8b``; ``--model qwen3-8b`` and
``--model qwen2-7b`` serve Qwen3-8B and Qwen2-7B (GQA groups 4 and 7;
dense cache only: the Qwen family has no paged hook).
``--weight-dtype int8|int4`` quantizes the weights on the card after the
seeded init (as the port's server does) and also reports the device
time of the dequantized weight copies the quantized products make
(``ops/quantization._weight_operand``, timed under a profiler range);
``--kv-dtype int8`` takes the int8 KV cache.

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from skypilot_tpu_torch import models  # noqa: E402
from skypilot_tpu_torch.infer import engine as engine_lib  # noqa: E402
from skypilot_tpu_torch.infer import orchestrator as orch_lib  # noqa: E402
from skypilot_tpu_torch.infer import sampling  # noqa: E402
from skypilot_tpu_torch.ops import quantization as qops  # noqa: E402

MODELS = ('llama3-8b', 'deepseek-v2-lite', 'qwen3-8b', 'qwen2-7b')
DEQUANT_RANGE = 'xsky.dequant_weight'
# Device kernels by kind, matched on the kernel's name (first match wins).
CATEGORIES = (
    ('port kernels', ('mla_decode', 'mla_combine', 'decode_kernel',
                      'decode_combine', 'flash_')),
    ('matrix products', ('gemm', 'gemv', 'nvjet', 'cutlass', 'xmma',
                         'cublas', 'splitk', 'dot_kernel')),
    ('index, scan and sort ops', ('index', 'scatter', 'gather', 'scan',
                                  'topk', 'sort')),
)


def _category(name: str) -> str:
    lower = name.lower()
    for label, keys in CATEGORIES:
        if any(key in lower for key in keys):
            return label
    return 'elementwise and other'


def _kernel_events(prof):
    """(name, device µs) of every kernel the trace saw on the card. The
    dequant range's own device-side span (a user annotation, not a
    kernel) is left out: its kernels are counted already."""
    out = []
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and evt.name != DEQUANT_RANGE):
            out.append((evt.name, evt.device_time_total))
    return out


def traced(label: str, fn) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _kernel_events(prof)
    busy_ms = sum(us for _, us in kernels) / 1e3
    dequant_ms = sum(evt.device_time_total for evt in prof.events()
                     if evt.name == DEQUANT_RANGE
                     and evt.device_type == torch.autograd.DeviceType.CPU
                     ) / 1e3
    by_name = collections.Counter()
    counts = collections.Counter()
    for name, us in kernels:
        by_name[name] += us / 1e3
        counts[name] += 1
    top = [{'kernel': name[:90], 'ms': ms, 'launches': counts[name]}
           for name, ms in by_name.most_common(12)]
    by_category = collections.Counter()
    for name, ms in by_name.items():
        by_category[_category(name)] += ms
    summary = {'phase': label, 'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
               'idle_share': max(0.0, 1 - busy_ms / wall_ms),
               'kernel_launches': len(kernels), 'top_kernels': top,
               'dequant_copies_ms': dequant_ms,
               'ms_by_category': dict(by_category),
               'ms_by_kernel': dict(by_name)}
    print(f'{label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms '
          f'(idle share {summary["idle_share"]:.3f}), '
          f'{len(kernels)} kernel launches, dequantized weight copies '
          f'{dequant_ms:.3f} ms; by kind '
          f'{ {k: round(v, 3) for k, v in by_category.most_common()} }',
          flush=True)
    for row in top:
        print(f'  {row["ms"]:9.3f} ms  {row["launches"]:6d}x  '
              f'{row["kernel"]}', flush=True)
    return summary


def nvidia_smi_line() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], check=True,
                          capture_output=True, text=True).stdout.strip()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--paged', action='store_true',
                        help="trace chip_smoke.py's paged main path")
    parser.add_argument('--model', choices=MODELS, default=MODELS[0],
                        help='the model served (default %(default)s)')
    parser.add_argument('--weight-dtype', choices=('bf16', 'int8', 'int4'),
                        default='bf16')
    parser.add_argument('--kv-dtype', choices=('bf16', 'int8'),
                        default='bf16')
    args = parser.parse_args()
    paged = args.paged
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    smi = nvidia_smi_line()
    print(f'card: {smi}; torch {torch.__version__}; model {args.model}, '
          f'{args.weight_dtype} weights, {args.kv_dtype} KV', flush=True)
    kv_dtype = torch.int8 if args.kv_dtype == 'int8' else torch.bfloat16
    cfg = models.get_config(args.model)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    if paged:
        ecfg = engine_lib.EngineConfig(
            model=cfg, max_slots=32, max_target_len=4096,
            prefill_buckets=(1024,), kv_page_size=16, kv_num_pages=2048,
            kv_dtype=kv_dtype)
        n_prompts = 30
    else:
        ecfg = engine_lib.EngineConfig(model=cfg, max_slots=16,
                                       max_target_len=2048,
                                       prefill_buckets=(1024,),
                                       kv_dtype=kv_dtype)
        n_prompts = 16
    params = models.module_for(cfg).init(cfg, gen)
    if args.weight_dtype != 'bf16':
        qops.quantize_params_in_place(
            params, torch.int8 if args.weight_dtype == 'int8' else 'int4')
        torch.cuda.empty_cache()
        operand = qops._weight_operand

        def timed_operand(w, dtype):
            with torch.profiler.record_function(DEQUANT_RANGE):
                return operand(w, dtype)

        qops._weight_operand = timed_operand
    engine = engine_lib.InferenceEngine(ecfg, params)
    del params
    print(f'weights {qops.params_nbytes(engine.params)} bytes', flush=True)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(960, 1025, n_prompts)]
    warm = orch_lib.Orchestrator(engine, decode_steps=8)
    result = warm.benchmark(prompts, max_new_tokens=64)
    print(f'warm-up generate: {result}', flush=True)

    state = engine.init_decode_state()
    sp = sampling.SamplingParams()
    holder = {}

    for slot, p in enumerate(prompts):
        if not engine.reserve_kv(slot, len(p), 64):
            raise SystemExit(f'no KV pages for slot {slot}')

    def prefill():
        holder['state'], _ = engine.prefill_insert_batch(
            state, [(p, sp) for p in prompts], list(range(n_prompts)))

    summaries = [traced(f'prefill wave ({n_prompts} x 1024)', prefill)]
    slots = engine.config.max_slots
    temps = torch.zeros(slots, device='cuda')
    eos = torch.full((slots,), -1, dtype=torch.int32, device='cuda')
    budget = torch.full((slots,), 64, dtype=torch.int32, device='cuda')

    def decode():
        engine.decode_steps_masked(holder['state'], 8, temps, None, None,
                                   eos, budget, None)

    decode()  # same shapes as traced, outside the trace
    summaries.append(traced(f'decode tick (8 steps x {slots} slots)',
                            decode))
    if engine.supports_verify:
        proposals = torch.zeros((slots, 4), dtype=torch.int32, device='cuda')

        def verify():
            engine.verify_step(holder['state'], proposals)

        verify()
        summaries.append(traced(f'verify round (gamma 4 x {slots} slots)',
                                verify))
    if paged and engine.supports_chunked_prefill:
        # The third 1024-token chunk of a 3000-token prompt's prefill.
        scratch = engine._make_scratch_cache()
        chunk = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, 1024)), device='cuda')

        def prompt_chunk():
            engine._chunk_forward(scratch, chunk, 2048, 951, True)

        prompt_chunk()
        summaries.append(traced('prompt chunk (1024 tokens at row 2048)',
                                prompt_chunk))
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    name = 'torch_serve_profile' + ('_paged' if paged else '') + (
        '' if args.model == MODELS[0] else f'_{args.model}') + (
        '' if args.weight_dtype == 'bf16' else f'_{args.weight_dtype}') + (
        '' if args.kv_dtype == 'bf16' else '_kv_int8') + '.json'
    with open(os.path.join(REPO, 'chiprun_out', name), 'w') as f:
        json.dump({'card': smi, 'torch': torch.__version__,
                   'model': args.model, 'weight_dtype': args.weight_dtype,
                   'kv_dtype': args.kv_dtype, 'warm_generate': result,
                   'phases': summaries}, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
