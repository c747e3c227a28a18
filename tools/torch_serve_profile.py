#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one card.

Runs the same configuration as ``chip_smoke.py``'s main path (Llama-3-8B
bf16 with random weights, 16 slots, bucket 1024, dense bf16 KV), warms it
up with one full generate, then traces one prefill wave of 16 prompts
and one fused decode tick (8 steps) with ``torch.profiler``. For each it
prints the host wall time, the device busy time (sum of kernel times —
one stream, so kernels do not overlap), the idle share, the number of
kernel launches and the kernels that take the most time. A JSON summary
goes to ``chiprun_out/torch_serve_profile.json``.

    python3 tools/torch_serve_profile.py

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

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

from skypilot_tpu_torch.infer import engine as engine_lib  # noqa: E402
from skypilot_tpu_torch.infer import orchestrator as orch_lib  # noqa: E402
from skypilot_tpu_torch.infer import sampling  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402


def _kernel_events(prof):
    """(name, device µs) of every kernel the trace saw on the card."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
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
    by_name = collections.Counter()
    counts = collections.Counter()
    for name, us in kernels:
        by_name[name] += us / 1e3
        counts[name] += 1
    top = [{'kernel': name[:90], 'ms': ms, 'launches': counts[name]}
           for name, ms in by_name.most_common(12)]
    summary = {'phase': label, 'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
               'idle_share': max(0.0, 1 - busy_ms / wall_ms),
               'kernel_launches': len(kernels), 'top_kernels': top}
    print(f'{label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms '
          f'(idle share {summary["idle_share"]:.3f}), '
          f'{len(kernels)} kernel launches', flush=True)
    for row in top:
        print(f'  {row["ms"]:9.3f} ms  {row["launches"]:6d}x  '
              f'{row["kernel"]}', flush=True)
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f'card: {smi}; torch {torch.__version__}', flush=True)
    cfg = llama.LLAMA3_8B
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=16,
                                max_target_len=2048,
                                prefill_buckets=(1024,)),
        llama.init(cfg, gen))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(960, 1025, 16)]
    warm = orch_lib.Orchestrator(engine, decode_steps=8)
    result = warm.benchmark(prompts, max_new_tokens=64)
    print(f'warm-up generate: {result}', flush=True)

    state = engine.init_decode_state()
    sp = sampling.SamplingParams()
    holder = {}

    def prefill():
        holder['state'], _ = engine.prefill_insert_batch(
            state, [(p, sp) for p in prompts], list(range(16)))

    summaries = [traced('prefill wave (16 x 1024)', prefill)]
    slots = engine.config.max_slots
    temps = torch.zeros(slots, device='cuda')
    eos = torch.full((slots,), -1, dtype=torch.int32, device='cuda')
    budget = torch.full((slots,), 64, dtype=torch.int32, device='cuda')

    def decode():
        engine.decode_steps_masked(holder['state'], 8, temps, None, None,
                                   eos, budget, None)

    decode()  # same shapes as traced, outside the trace
    summaries.append(traced('decode tick (8 steps x 16 slots)', decode))
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out',
                           'torch_serve_profile.json'), 'w') as f:
        json.dump({'card': smi, 'torch': torch.__version__,
                   'warm_generate': result, 'phases': summaries}, f,
                  indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
