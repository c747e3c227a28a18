"""Weight matmul and embedding lookup for plain (unquantized) weights.

Counterpart of the plain-array branches of ``matmul`` and ``embed_rows``
in ``skypilot_tpu/ops/quantization.py``. Weight quantization (int8
per-channel, int4 group-128) comes in a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

# Columns of a narrow weight upcast at a time for an fp32-output product
# (4096 x 8192 fp32 = 128 MiB of scratch for the Llama-3 LM head).
UPCAST_COLUMNS = 8192


def matmul(x: torch.Tensor, w: torch.Tensor,
           preferred_element_type: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """``x @ w`` for a plain ``[in, out]`` weight.

    preferred_element_type=torch.float32 with bf16 operands asks, as in
    XLA, for fp32 products summed and returned in fp32. That is computed
    from an fp32 copy of x and of w taken UPCAST_COLUMNS output columns
    at a time, so the full weight is never held in fp32 (the bf16
    products are exact in fp32, so this is the same function).
    """
    if preferred_element_type is None or (
            x.dtype == w.dtype == preferred_element_type):
        return torch.matmul(x, w)
    xf = x.to(preferred_element_type)
    out = torch.empty(x.shape[:-1] + (w.shape[-1],),
                      dtype=preferred_element_type, device=x.device)
    for j in range(0, w.shape[-1], UPCAST_COLUMNS):
        out[..., j:j + UPCAST_COLUMNS] = torch.matmul(
            xf, w[:, j:j + UPCAST_COLUMNS].to(preferred_element_type))
    return out


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` for a plain table."""
    return table[tokens]
