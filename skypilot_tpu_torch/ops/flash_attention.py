"""Flash-attention forward: hand-written Hopper kernel + plain version.

Counterpart of the forward half of ``skypilot_tpu/ops/flash_attention.py``
(``_fwd_kernel`` / ``_flash_fwd`` / ``flash_attention``). The kernel is
``csrc/flash_fwd.cu``; its header says what bounds it on the H100 and how
it is laid out. The backward kernels (``_bwd_dkv_kernel``,
``_bwd_dq_kernel``) come with the training slice; ``_flash_fwd`` already
returns the LSE they consume.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes ``flash_attention_plain``, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import kernels

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)

KERNEL = kernels.Kernel(
    'flash_fwd', 'flash_fwd.cu', 'xsky_flash_fwd',
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 +
    [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          window: Optional[int] = None,
                          segment_ids: Optional[torch.Tensor] = None,
                          logit_softcap: Optional[float] = None,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch → (out, lse [B, H, S]).

    fp32 throughout, output cast to q's type. Masked scores are filled
    with -1e30, softcap comes before the mask, and the causal mask is
    q_pos >= kv_pos with no S_kv - S_q offset — the kernel's semantics.
    """
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    groups = h // k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    kf = k.float().repeat_interleave(groups, dim=2)
    vf = v.float().repeat_interleave(groups, dim=2)
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), kf) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    q_pos = torch.arange(s_q, device=q.device)[:, None]
    kv_pos = torch.arange(s_kv, device=q.device)[None, :]
    keep = torch.ones((s_q, s_kv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= q_pos >= kv_pos
    if window is not None:
        keep &= (q_pos - kv_pos) < window
    keep = keep[None, None]
    if segment_ids is not None:
        keep = keep & (segment_ids[:, :, None] ==
                       segment_ids[:, None, :])[:, None]
    s = torch.where(keep, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lse = (m + torch.log(p.sum(dim=-1, keepdim=True)))[..., 0]
    out = torch.einsum('bhqk,bkhd->bqhd', p / p.sum(-1, keepdim=True), vf)
    return out.to(q.dtype), lse


def _check(q, k, v, segment_ids) -> None:
    b, s_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f'k/v shape {tuple(k.shape)} does not fit q '
                         f'{tuple(q.shape)}')
    if h % k.shape[2]:
        raise ValueError(f'{h} query heads not a multiple of '
                         f'{k.shape[2]} KV heads')
    if d not in HEAD_DIMS:
        raise ValueError(f'head_dim {d} not in {HEAD_DIMS}')
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f'q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: '
                         'need one of bf16 or fp32')
    tensors = [q, k, v] + ([segment_ids] if segment_ids is not None
                           else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError('q, k, v and segment_ids must share a device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('flash_attention needs contiguous inputs')
    if segment_ids is not None and (
            segment_ids.dtype != torch.int32 or
            tuple(segment_ids.shape) != (b, s_q) or k.shape[1] != s_q):
        raise ValueError('segment_ids must be int32 [B, S] with S_kv == S')


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               segment_ids: Optional[torch.Tensor] = None, *,
               causal: bool = True, window: Optional[int] = None,
               softcap: Optional[float] = None,
               scale_override: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel → (out [B, S, H, D], lse [B, H, S] fp32)."""
    if not q.is_cuda:
        raise ValueError(f'_flash_fwd launches a CUDA kernel; got a '
                         f'{q.device} tensor')
    _check(q, k, v, segment_ids)
    b, s_q, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    scale = d ** -0.5 if scale_override is None else scale_override
    KERNEL.launch(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        kernels.ptr(segment_ids), kernels.ptr(out), kernels.ptr(lse),
        b, s_q, k.shape[1], h, k.shape[2], d, int(causal),
        0 if window is None else int(window), float(scale),
        0.0 if softcap is None else float(softcap),
        kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q.device))
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    logit_softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention; q [B,S,H,D], k/v [B,S,Hkv,D] (GQA) → [B,S,H,D].

    window: sliding window — tiles left of it are skipped. segment_ids
    [B, S] int32: packed-sequence document masking. A CPU tensor takes
    the plain version; a CUDA tensor the kernel.
    """
    if q.device.type == 'cpu':
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     segment_ids=segment_ids,
                                     logit_softcap=logit_softcap,
                                     scale=scale)[0]
    return _flash_fwd(q, k, v, segment_ids, causal=causal, window=window,
                      softcap=logit_softcap, scale_override=scale)[0]
