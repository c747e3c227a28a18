"""Weight matmul and embedding lookup for plain (unquantized) weights.

Counterpart of the plain-array branches of ``matmul``, ``expert_einsum``
and ``embed_rows`` in ``skypilot_tpu/ops/quantization.py``. Weight
quantization (int8 per-channel, int4 group-128) comes in a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

# Columns of a narrow weight upcast at a time for an fp32-output product
# (4096 x 8192 fp32 = 128 MiB of scratch for the Llama-3 LM head).
UPCAST_COLUMNS = 8192


class _UpcastMatmul(torch.autograd.Function):
    """fp32 ``x @ w`` from lower-precision operands, UPCAST_COLUMNS output
    columns at a time, with a gradient that saves only x and w.

    Autograd through the chunked forward would save an fp32 copy of every
    weight chunk (the whole weight in fp32) and hand each chunk's slice
    gradient back as a full-size tensor; this backward instead upcasts
    one chunk at a time again and writes dW chunk by chunk into one
    tensor. Gradients come back in x's and w's types, as JAX casts a
    cotangent to its primal's type. (``torch.mm(x, w, out_dtype=
    torch.float32)`` computes the forward on the tensor cores, but torch
    2.11 has no gradient for it.)
    """

    @staticmethod
    def forward(ctx, x, w, dtype):
        ctx.save_for_backward(x, w)
        xf = x.to(dtype)
        out = torch.empty(x.shape[:-1] + (w.shape[-1],), dtype=dtype,
                          device=x.device)
        for j in range(0, w.shape[-1], UPCAST_COLUMNS):
            torch.matmul(xf, w[:, j:j + UPCAST_COLUMNS].to(dtype),
                         out=out[..., j:j + UPCAST_COLUMNS])
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        dtype = dout.dtype
        x2 = x.reshape(-1, x.shape[-1]).to(dtype)
        d2 = dout.reshape(-1, dout.shape[-1])
        dx = torch.zeros(x2.shape, dtype=dtype, device=x.device)
        dw = torch.empty_like(w)
        for j in range(0, w.shape[-1], UPCAST_COLUMNS):
            cols = slice(j, j + UPCAST_COLUMNS)
            dx.addmm_(d2[:, cols], w[:, cols].to(dtype).t())
            dw[:, cols] = (x2.t() @ d2[:, cols]).to(w.dtype)
        return dx.reshape(x.shape).to(x.dtype), dw, None


def matmul(x: torch.Tensor, w: torch.Tensor,
           preferred_element_type: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """``x @ w`` for a plain ``[in, out]`` weight.

    preferred_element_type=torch.float32 with bf16 operands asks, as in
    XLA, for fp32 products summed and returned in fp32. That is computed
    from an fp32 copy of x and of w taken UPCAST_COLUMNS output columns
    at a time, so the full weight is never held in fp32 (the bf16
    products are exact in fp32, so this is the same function); the
    gradient does the same (``_UpcastMatmul``).
    """
    if preferred_element_type is None or (
            x.dtype == w.dtype == preferred_element_type):
        return torch.matmul(x, w)
    return _UpcastMatmul.apply(x, w, preferred_element_type)


def expert_matmul(x: torch.Tensor, w: torch.Tensor,
                  preferred_element_type: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """Per-expert ``x @ w``: x [E, C, in], w [E, in, out] → [E, C, out]
    (the reference's ``expert_einsum('ecd,edf->ecf', ...)``).

    preferred_element_type as in ``matmul``. On a card the fp32 output
    comes from cuBLAS (``out_dtype``: lower-precision operands, fp32 sums
    returned unrounded); the CPU has no such product, so there it is taken
    from fp32 copies, the same function. No gradient: serving only.
    """
    if preferred_element_type is None or (
            x.dtype == w.dtype == preferred_element_type):
        return torch.bmm(x, w)
    if x.is_cuda:
        return torch.bmm(x, w, out_dtype=preferred_element_type)
    return torch.bmm(x.to(preferred_element_type),
                     w.to(preferred_element_type))


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` for a plain table. Its gradient is autograd's
    scatter-add of the rows' gradients into one zero table (repeated
    tokens accumulate), as JAX's gather transposes to a scatter-add."""
    return table[tokens]
