"""PyTorch/CUDA port of xsky's compute stack, for NVIDIA Hopper.

A second package beside ``skypilot_tpu`` (the JAX reference, which stays
as it is). It imports torch and numpy, never jax, and nothing of
``skypilot_tpu``. Layout mirrors the reference: ``ops/`` (attention and
the kernel wrappers), ``models/``, ``infer/``, with the hand-written
CUDA kernels under ``csrc/``.

Entry points run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """``device`` as a torch.device; None means the card.

    Raises when no card is present and the caller did not ask for the
    CPU: the port never carries on quietly on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" to run the '
                'port on the CPU.')
        return torch.device('cuda')
    return torch.device(device)
