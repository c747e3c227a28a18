"""Attention ops: plain PyTorch reference + dispatch to the flash kernel.

Counterpart of ``skypilot_tpu/ops/attention.py``. The plain path is the
correctness reference (and the CPU path); on a CUDA tensor the
hand-written flash kernel (``skypilot_tpu_torch.ops.flash_attention``)
takes causal attention at long sequence, where materializing the S x S
score matrix would cost device memory and bandwidth.

Shapes follow the JAX package: q [B, S, H, D], k/v [B, S, Hkv, D]
(Hkv <= H, grouped-query attention).
"""
from __future__ import annotations

from typing import Optional

import torch

_FLASH_MIN_SEQ = 1024  # below this the plain path's fused ops are fine
_NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, num_groups: int) -> torch.Tensor:
    if num_groups == 1:
        return k
    b, s, h_kv, d = k.shape
    k = k[:, :, :, None, :].expand(b, s, h_kv, num_groups, d)
    return k.reshape(b, s, h_kv * num_groups, d)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: Optional[float],
            logit_softcap: Optional[float]) -> torch.Tensor:
    """fp32 scores [B, H, S_q, S_kv], softcap applied (before masking).

    Upcasting the operands gives what XLA's bf16 einsum with an fp32
    preferred_element_type gives: bf16 products are exact in fp32 and
    the sum is taken in fp32."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    return logits


def xla_attention(q: torch.Tensor,
                  k: torch.Tensor,
                  v: torch.Tensor,
                  causal: bool = True,
                  segment_ids: Optional[torch.Tensor] = None,
                  window: Optional[int] = None,
                  logit_softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention (fp32 softmax), named after its JAX twin.

    window: sliding-window size W (Mistral-style) — each query attends
    to at most the W most recent positions (inclusive of itself).
    Causal and window masks offset the query positions by S_kv - S_q.
    logit_softcap: Gemma-2's cap·tanh(s/cap) on the scores (before
    masking). scale: score multiplier (default head_dim**-0.5).
    """
    s_q, h = q.shape[1], q.shape[2]
    s_kv = k.shape[1]
    groups = h // k.shape[2]
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    logits = _scores(q, k, scale, logit_softcap)
    if causal or window is not None:
        q_pos = (torch.arange(s_q, device=q.device)[:, None]
                 + (s_kv - s_q))
        kv_pos = torch.arange(s_kv, device=q.device)[None, :]
        mask = (q_pos >= kv_pos if causal else
                torch.ones((s_q, s_kv), dtype=torch.bool, device=q.device))
        if window is not None:
            mask &= (q_pos - kv_pos) < window
        logits = torch.where(mask[None, None], logits, _NEG_INF)
    if segment_ids is not None:
        seg_mask = segment_ids[:, :, None] == segment_ids[:, None, :]
        logits = torch.where(seg_mask[:, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', probs.to(v.dtype), v)


def xla_attention_with_mask(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: torch.Tensor,
                            logit_softcap: Optional[float] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Attention with an explicit boolean mask [B, 1|H, S_q|1, S_kv].

    Used by the decode path's masked branch (KV-cache validity mask)."""
    groups = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    logits = _scores(q, k, scale, logit_softcap)
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', probs.to(v.dtype), v)


def dot_product_attention(q: torch.Tensor,
                          k: torch.Tensor,
                          v: torch.Tensor,
                          causal: bool = True,
                          segment_ids: Optional[torch.Tensor] = None,
                          implementation: str = 'auto',
                          window: Optional[int] = None,
                          logit_softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dispatching attention entry point used by the models.

    implementation: 'auto' | 'xla' | 'flash'. Under 'auto' the flash
    kernel takes CUDA tensors with causal attention at S >= 1024, as the
    JAX dispatch does for the TPU; everything else takes the plain path.
    """
    if implementation == 'auto':
        use_flash = q.is_cuda and causal and q.shape[1] >= _FLASH_MIN_SEQ
        implementation = 'flash' if use_flash else 'xla'
    if implementation == 'flash':
        from skypilot_tpu_torch.ops import flash_attention
        return flash_attention.flash_attention(
            q, k, v, causal=causal, window=window,
            segment_ids=segment_ids, logit_softcap=logit_softcap,
            scale=scale)
    return xla_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                         window=window, logit_softcap=logit_softcap,
                         scale=scale)
