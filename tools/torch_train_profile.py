#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on one card.

Runs the configuration of ``chip_smoke.py``'s training main path
(Llama-3-1B bf16 with random weights, seq 8192, global batch 4, remat
'qkvo_gup', adafactor), or with ``--model gemma2-2b`` that of its Gemma
training path [28] (Gemma2-2B bf16, seq 8192, global batch 1, its own
remat 'dots', adafactor), takes two warm-up steps, then traces one step
with ``torch.profiler``. It prints the step's host wall time, the device
busy time (sum of kernel times: one stream, so kernels do not overlap),
the idle share, the kernels that take the most time, and the device time
split into the flash kernels (forward, dK/dV, dQ), fp32 matrix products
(FFMA: the fp32 LM head), the other matrix products (cuBLAS / CUTLASS)
and everything else (elementwise passes, reductions, copies, the
optimizer). A JSON summary goes to
``chiprun_out/torch_train_profile.json``.

    python3 tools/torch_train_profile.py [--model gemma2-2b]

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from skypilot_tpu_torch.models import gemma  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.train import trainer as trainer_lib  # noqa: E402
from tools.torch_serve_profile import nvidia_smi_line, traced  # noqa: E402

# Kernel-name fragments of each group (first match wins).
GROUPS = (
    ('flash_fwd (K1)', ('flash_fwd',)),
    ('flash_bwd_dkv (K2)', ('flash_bwd_dkv',)),
    # The row pre-pass runs inside the dQ launch (once per backward).
    ('flash_bwd_dq (K3)', ('flash_bwd_dq', 'flash_bwd_rowstats')),
    # By the names of FFMA kernels: TF32 tensor-core GEMMs also carry
    # 'f32f32' and stay with the other matrix products.
    ('fp32 matrix products (FFMA)', ('ffma', 'simt', 'sgemm')),
    ('matrix products (cuBLAS/CUTLASS)',
     ('gemm', 'gemv', 'xmma', 'cutlass', 'nvjet', 'sm90_', 'splitk')),
)


def group_of(kernel: str) -> str:
    low = kernel.lower()
    for group, fragments in GROUPS:
        if any(f in low for f in fragments):
            return group
    return 'elementwise, reductions, copies, optimizer'


# --model → (config, global batch): chip_smoke.py's [6] and [28].
MODELS = {
    'llama3-1b': (dataclasses.replace(llama.LLAMA3_1B, remat=True,
                                      remat_policy='qkvo_gup'), 4),
    'gemma2-2b': (gemma.GEMMA2_2B, 1),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--model', default='llama3-1b', choices=MODELS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    smi = nvidia_smi_line()
    print(f'card: {smi}; torch {torch.__version__}', flush=True)
    cfg, batch_size = MODELS[args.model]
    tcfg = trainer_lib.TrainConfig(model=cfg, global_batch_size=batch_size,
                                   seq_len=8192, optimizer='adafactor',
                                   learning_rate=3e-3, warmup_steps=2)
    trainer = trainer_lib.Trainer(tcfg)
    holder = {'state': trainer.init_state()}
    batch = trainer.synthetic_batch()

    def step():
        holder['state'], metrics = trainer.step(holder['state'], batch)
        holder['loss'] = float(metrics['loss'])

    for _ in range(2):
        step()
    summary = traced(f'{args.model} train step (B{batch_size} x S8192)',
                     step)
    groups = {}
    for kernel, ms in summary.pop('ms_by_kernel').items():
        groups[group_of(kernel)] = groups.get(group_of(kernel), 0.0) + ms
    busy = summary['device_busy_ms']
    summary['device_ms_by_group'] = groups
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f'  group {group}: {ms:.3f} ms ({ms / busy:.4f} of device '
              'time)', flush=True)
    print(f'  loss after the traced step {holder["loss"]:.4f}', flush=True)
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out',
                           'torch_train_profile.json'), 'w') as f:
        json.dump({'card': smi, 'torch': torch.__version__,
                   'phases': [summary]}, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
