"""Decode attention over the dense slot cache: Hopper kernel + plain version.

Counterpart of the dense half of ``skypilot_tpu/ops/decode_attention.py``
(``_decode_kernel`` / ``decode_attention``). One decode step attends each
slot's single query token over that slot's live cache rows. The kernel is
``csrc/decode_attention.cu``; its header says what bounds it on the H100
(bytes) and what the design does about it. The paged form
(``_paged_adapter``) and the multi-device layout come in later slices.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes ``decode_attention_plain``, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from skypilot_tpu_torch.ops import kernels

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUPS = 8
# A slot of length 0 returns the mean of its first min(EMPTY_SLOT_ROWS,
# max_len) V rows, as the JAX kernel does: its grid still runs KV block 0
# (first = last = 0, skypilot_tpu/ops/decode_attention.py:95), where every
# score is masked to the same -1e30, so p = 1 on each of the block's rows
# (the default block, 256 rows, capped at max_len: its line 303).
EMPTY_SLOT_ROWS = 256

KERNEL = kernels.Kernel(
    'decode_attention', 'decode_attention.cu', 'xsky_decode_attention',
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 +
    [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p])


def _split(cache):
    """Cache entry → (values, fp32 scale or None)."""
    if isinstance(cache, (tuple, list)):
        return cache[0], cache[1]
    return cache, None


def decode_attention_plain(q: torch.Tensor, k_cache, v_cache,
                           lengths: torch.Tensor,
                           window: Optional[int] = None,
                           logit_softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 math).

    Rows [max(length - window, 0), length) of each slot are live, with
    lengths clamped to the cache length; a slot of length 0 returns the
    mean of its first min(EMPTY_SLOT_ROWS, max_len) V rows (see
    EMPTY_SLOT_ROWS).
    """
    b, _, h, d = q.shape
    k, k_scale = _split(k_cache)
    v, v_scale = _split(v_cache)
    max_len, h_kv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale
        vf = vf * v_scale
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, h_kv, h // h_kv, d)
    s = torch.einsum('bhgd,bkhd->bhgk', qg, kf) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    length = lengths.long().clamp(0, max_len)[:, None]          # [B, 1]
    empty = length == 0
    pos = torch.arange(max_len, device=q.device)[None, :]
    live = pos < torch.where(empty, EMPTY_SLOT_ROWS, length)
    if window is not None:
        live &= pos >= length - window
    live = live[:, None, None, :]                                # [B,1,1,K]
    # Equal scores on an empty slot's rows: the softmax is their mean.
    s = torch.where(empty[:, None, None], 0.0, s)
    m = torch.where(live, s, -torch.inf).amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(live, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum('bhgk,bkhd->bhgd', p, vf) / torch.where(
        den > 0, den, 1.0)
    return out.reshape(b, 1, h, d).to(q.dtype)


def _decode_cuda(q, k, v, k_scale, v_scale, lengths, window,
                 logit_softcap, scale) -> torch.Tensor:
    if not q.is_cuda:
        raise ValueError(f'_decode_cuda launches a CUDA kernel; got a '
                         f'{q.device} tensor')
    b, s, h, d = q.shape
    max_len, h_kv = k.shape[1], k.shape[2]
    if s != 1 or tuple(k.shape) != (b, max_len, h_kv, d) or (
            k.shape != v.shape):
        raise ValueError(f'decode_attention shapes: q {tuple(q.shape)}, '
                         f'k {tuple(k.shape)}, v {tuple(v.shape)}')
    if d not in HEAD_DIMS or h % h_kv or h // h_kv > MAX_GROUPS:
        raise ValueError(f'decode_attention takes head_dim in {HEAD_DIMS} '
                         f'and at most {MAX_GROUPS} query heads per KV '
                         f'head; got d={d}, h={h}, h_kv={h_kv}')
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'q dtype {q.dtype}: need bf16 or fp32')
    quantized = k_scale is not None
    if quantized:
        scale_shape = (b, max_len, h_kv, 1)
        if (k.dtype != torch.int8 or v.dtype != torch.int8
                or k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32
                or tuple(k_scale.shape) != scale_shape
                or tuple(v_scale.shape) != scale_shape):
            raise ValueError('an int8 cache is (int8 [B,K,Hkv,D], fp32 '
                             'scale [B,K,Hkv,1]) pairs')
    elif k.dtype not in (torch.bfloat16, torch.float32) or k.dtype != (
            v.dtype):
        raise ValueError(f'cache dtypes {k.dtype}/{v.dtype}: need bf16, '
                         'fp32 or an int8 pair')
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError('lengths must be int32 [B]')
    tensors = [q, k, v, lengths] + ([k_scale, v_scale] if quantized
                                    else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError('decode_attention inputs must share a device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('decode_attention needs contiguous inputs')
    out = torch.empty_like(q)
    KERNEL.launch(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        kernels.ptr(k_scale), kernels.ptr(v_scale), kernels.ptr(lengths),
        kernels.ptr(out), b, max_len, h, h_kv, d,
        0 if window is None else int(window),
        float(d ** -0.5 if scale is None else scale),
        0.0 if logit_softcap is None else float(logit_softcap),
        kernels.DTYPE_CODES[q.dtype], kernels.DTYPE_CODES[k.dtype],
        kernels.stream_ptr(q.device))
    return out


def decode_attention(q: torch.Tensor, k_cache, v_cache,
                     lengths: torch.Tensor, window: Optional[int] = None,
                     logit_softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over the slot cache.

    q: [B, 1, H, D]; k_cache/v_cache: [B, K, Hkv, D] tensors or
    (int8 values, fp32 scale [B, K, Hkv, 1]) pairs; lengths: [B] int32 —
    rows < lengths[b] are live for slot b (the step's own K/V must
    already be written at position lengths[b]-1); lengths past K clamp
    to K. Returns [B, 1, H, D] in q's type. logit_softcap / scale:
    Gemma-2's cap·tanh(s/cap) and explicit score multiplier.
    """
    if q.device.type == 'cpu':
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      window=window,
                                      logit_softcap=logit_softcap,
                                      scale=scale)
    k, k_scale = _split(k_cache)
    v, v_scale = _split(v_cache)
    return _decode_cuda(q, k, v, k_scale, v_scale, lengths, window,
                        logit_softcap, scale)
