#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on one card.

Runs the configuration of one of ``chip_smoke.py``'s training paths:
Llama-3-1B bf16 with random weights, seq 8192, global batch 4, remat
'qkvo_gup', adafactor ([6], the default); ``--model gemma2-2b``: Gemma2-2B
bf16, seq 8192, global batch 1, its own remat 'dots', adafactor ([28]);
``--model mixtral-8x7b``: Mixtral-8x7B at its public widths cut to 2
layers, seq 4096, global batch 2, adamw ([32]); ``--model
deepseek-v2-lite``: DeepSeek-V2-Lite cut to 4 layers, seq 4096, batch 1,
adamw ([33a]); ``--model deepseek-v2-lite-lora``: all 27 layers with
LoRA (rank 16, wq,w_ukv,wo) as [33b] launches it. It takes two warm-up
steps, then traces one step with
``torch.profiler`` and prints the step's host wall time, the device busy
time (sum of kernel times: one stream, so kernels do not overlap), the
idle share, the kernels that take the most time, and the device time
split into groups.

Kernels are grouped by the part of the step that launched them: the
flash kernels by name (forward, dK/dV, dQ); the others by the range the
forward ran in (``xsky.*`` ranges this script opens around the routed
experts' products, the rest of the routed MLP — top-k, gathers,
scatter-adds and the combine —, the attention, the LM head with its
cross-entropy, and the optimizer), a backward kernel by the range of the
forward op its autograd node belongs to; what none of these holds by
kernel name: fp32 matrix products (FFMA), the other matrix products,
index ops, and everything else. A JSON summary goes to
``chiprun_out/torch_train_profile_<model>.json``.

    python3 tools/torch_train_profile.py [--model gemma2-2b | mixtral-8x7b
                                          | deepseek-v2-lite
                                          | deepseek-v2-lite-lora]

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from skypilot_tpu_torch.models import deepseek  # noqa: E402
from skypilot_tpu_torch.models import gemma  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.models import moe  # noqa: E402
from skypilot_tpu_torch.ops import attention as attention_ops  # noqa: E402
from skypilot_tpu_torch.ops import quantization as qops  # noqa: E402
from skypilot_tpu_torch.train import optim  # noqa: E402
from skypilot_tpu_torch.train import trainer as trainer_lib  # noqa: E402
from tools.torch_serve_profile import nvidia_smi_line, traced  # noqa: E402

# Kernel-name fragments of each group (first match wins).
FLASH = (
    ('flash_fwd (K1)', ('flash_fwd',)),
    ('flash_bwd_dkv (K2)', ('flash_bwd_dkv',)),
    # The row pre-pass runs inside the dQ launch (once per backward).
    ('flash_bwd_dq (K3)', ('flash_bwd_dq', 'flash_bwd_rowstats')),
)
BY_NAME = (
    # By the names of FFMA kernels: TF32 tensor-core GEMMs also carry
    # 'f32f32' and stay with the other matrix products.
    ('fp32 matrix products (FFMA)', ('ffma', 'simt', 'sgemm')),
    ('matrix products (cuBLAS/CUTLASS)',
     ('gemm', 'gemv', 'xmma', 'cutlass', 'nvjet', 'sm90_', 'splitk')),
    ('index ops', ('index', 'scatter', 'gather')),
)
OTHER = 'elementwise, reductions, copies'
# The ranges this script opens: name → group.
RANGES = {
    'xsky.expert_products': 'routed experts\' products',
    'xsky.routing': 'routing: top-k, gathers, scatter-adds, combine',
    'xsky.attention': 'attention (besides the flash kernels)',
    'xsky.lm_head': 'LM head and cross-entropy (fp32)',
    'xsky.optimizer': 'optimizer (clip, update, apply)',
}


def group_of(kernel: str) -> str:
    low = kernel.lower()
    for group, fragments in FLASH + BY_NAME:
        if any(f in low for f in fragments):
            return group
    return OTHER


# --model → (config, global batch, seq, optimizer, learning rate):
# chip_smoke.py's [6], [28], [32] and [33a].
MODELS = {
    'llama3-1b': (dataclasses.replace(llama.LLAMA3_1B, remat=True,
                                      remat_policy='qkvo_gup'), 4, 8192,
                  'adafactor', 3e-3),
    'gemma2-2b': (gemma.GEMMA2_2B, 1, 8192, 'adafactor', 3e-3),
    'mixtral-8x7b': (dataclasses.replace(moe.MIXTRAL_8X7B, n_layers=2), 2,
                     4096, 'adamw', 3e-4),
    'deepseek-v2-lite': (dataclasses.replace(deepseek.DEEPSEEK_V2_LITE,
                                             n_layers=4), 1, 4096, 'adamw',
                         3e-4),
    # [33b]: all 27 layers, LoRA (LORA below) on the frozen base.
    'deepseek-v2-lite-lora': (deepseek.DEEPSEEK_V2_LITE, 1, 4096, 'adamw',
                              3e-4),
}
LORA = {'deepseek-v2-lite-lora': dict(lora_rank=16,
                                      lora_targets=('wq', 'w_ukv', 'wo'))}


@contextlib.contextmanager
def ranges(trainer):
    """Run the step's parts inside their ``xsky.*`` ranges: each wrapper
    replaces a module attribute that the step looks up when it calls it,
    and is taken out again on exit."""
    patches = [(qops, '_plain_expert_matmul', 'xsky.expert_products'),
               (moe, '_moe_mlp', 'xsky.routing'),
               (attention_ops, 'dot_product_attention', 'xsky.attention'),
               (llama, 'lm_logits', 'xsky.lm_head'),
               (llama, '_chunked_ce', 'xsky.lm_head'),
               (llama, '_token_nll', 'xsky.lm_head'),
               (optim, 'global_norm', 'xsky.optimizer'),
               (optim, 'apply_updates', 'xsky.optimizer'),
               (trainer.optimizer, 'update', 'xsky.optimizer')]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]

    def wrap(fn, label):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    for obj, name, label in patches:
        setattr(obj, name, wrap(getattr(obj, name), label))
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def attribute(prof) -> dict:
    """Device ms by group. Every kernel is first grouped by its name (so
    the groups sum to the busy time); a kernel the trace ties to the CPU
    op that launched it then moves to the innermost ``xsky.*`` range above
    that op, or, in the backward, to the range of the forward op of its
    autograd node (matched by thread and sequence number). A range's own
    device-side span is not a kernel and is skipped. ``attributed_share``:
    the busy time tied to an op."""
    events = prof.events()
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]

    def range_above(evt):
        while evt is not None:
            if evt.name in RANGES:
                return evt.name
            evt = evt.cpu_parent
        return None

    forward = {}
    for evt in cpu:
        if evt.sequence_nr >= 0 and 'Backward' not in evt.name:
            label = range_above(evt)
            if label is not None:
                forward.setdefault((evt.thread, evt.sequence_nr), label)

    def label_of(evt):
        label = range_above(evt)
        while label is None and evt is not None:
            if evt.sequence_nr >= 0 and 'Backward' in evt.name:
                label = forward.get((evt.fwd_thread, evt.sequence_nr))
            evt = evt.cpu_parent
        return label

    groups = collections.Counter()
    total = 0.0
    for dev in events:
        if (dev.device_type == torch.autograd.DeviceType.CUDA
                and dev.name not in RANGES):
            groups[group_of(dev.name)] += dev.device_time_total / 1e3
            total += dev.device_time_total / 1e3
    linked = 0.0
    seen = set()
    for evt in cpu:
        # One op can appear more than once in the list (its kernels with
        # it): take each correlation id once.
        if evt.name in RANGES or evt.id in seen:
            continue
        seen.add(evt.id)
        for kern in evt.kernels:
            group = group_of(kern.name)
            if kern.name in RANGES or group in dict(FLASH):
                continue
            label = label_of(evt)
            ms = kern.duration / 1e3
            linked += ms
            if label is not None:
                groups[group] -= ms
                groups[RANGES[label]] += ms
    return {'device_ms_by_group': dict(groups),
            'attributed_share': linked / total if total else 0.0}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--model', default='llama3-1b', choices=MODELS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    smi = nvidia_smi_line()
    print(f'card: {smi}; torch {torch.__version__}', flush=True)
    cfg, batch_size, seq, optimizer, lr = MODELS[args.model]
    tcfg = trainer_lib.TrainConfig(model=cfg, global_batch_size=batch_size,
                                   seq_len=seq, optimizer=optimizer,
                                   learning_rate=lr, warmup_steps=2,
                                   **LORA.get(args.model, {}))
    trainer = trainer_lib.Trainer(tcfg)
    holder = {'state': trainer.init_state()}
    batch = trainer.synthetic_batch()

    def step():
        holder['state'], metrics = trainer.step(holder['state'], batch)
        holder['loss'] = float(metrics['loss'])

    for _ in range(2):
        step()
    torch.cuda.reset_peak_memory_stats()
    with ranges(trainer):
        summary = traced(f'{args.model} train step (B{batch_size} x S{seq}, '
                         f'{cfg.n_layers} layers)', step, attribute)
    summary.pop('ms_by_kernel')
    summary['peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    busy = summary['device_busy_ms']
    for group, ms in sorted(summary['device_ms_by_group'].items(),
                            key=lambda kv: -kv[1]):
        print(f'  group {group}: {ms:.3f} ms ({ms / busy:.4f} of device '
              'time)', flush=True)
    print(f'  loss after the traced step {holder["loss"]:.4f}; peak memory '
          f'{summary["peak_gib"]:.2f} GiB; kernels traced to their op: '
          f'{summary["attributed_share"]:.4f} of device time', flush=True)
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out',
                           f'torch_train_profile_{args.model}.json'),
              'w') as f:
        json.dump({'card': smi, 'torch': torch.__version__,
                   'phases': [summary]}, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
