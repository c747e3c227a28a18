"""Decode attention over the slot cache, dense and paged: Hopper kernels
+ plain versions.

Counterpart of ``skypilot_tpu/ops/decode_attention.py``. One decode step
attends each slot's single query token over that slot's live cache rows:

  * ``decode_attention`` (its ``_decode_kernel`` / ``decode_attention``)
    over the dense cache [B, K, Hkv, D]; kernel ``csrc/decode_attention.cu``;
  * ``paged_decode_attention`` (its ``_paged_adapter`` /
    ``paged_decode_attention``) over a page arena [P, page, Hkv, D] shared
    by all slots, each slot's logical block i read from physical page
    ``block_tables[b, i]``; kernel ``csrc/paged_decode_attention.cu``.

Each source's header says what bounds the kernel on the H100 (bytes) and
what the design does about it; the two share their row walk
(``csrc/decode_common.cuh``). The multi-device layout comes in a later
slice.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version, the same function in plain PyTorch.
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

PAGE_SIZES = (8, 16, 32, 64, 128, 256)
# The kernel keeps a slot's table row in shared memory (128 KB at most).
MAX_BLOCKS = 32768

PAGED_KERNEL = kernels.Kernel(
    'paged_decode_attention', 'paged_decode_attention.cu',
    'xsky_paged_decode_attention',
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 +
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


def _check_paged(k_pages, v_pages, window) -> None:
    if isinstance(k_pages, (tuple, list)) or isinstance(v_pages,
                                                        (tuple, list)):
        raise ValueError('int8 KV is not supported for the paged cache '
                         '(use the dense slot cache for a quantized '
                         'cache).')
    if window is not None:
        raise ValueError('sliding_window is not supported with the paged '
                         'KV cache')


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 lengths: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 logit_softcap: Optional[float] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch (fp32 math): gather
    each slot's clamped pages into a dense [B, nblk*page, Hkv, D] view,
    then a masked softmax over rows [0, length), lengths clamped to
    nblk*page. A slot of length 0 returns the mean of the ``page`` V rows
    of its first (clamped) page: the JAX kernel's grid still runs logical
    block 0 for it with every score masked to the same -1e30."""
    _check_paged(k_pages, v_pages, None)
    b, _, h, d = q.shape
    num_pages, page, h_kv = k_pages.shape[:3]
    nblk = block_tables.shape[1]
    max_len = nblk * page
    safe = block_tables.long().clamp(0, num_pages - 1)
    kf = k_pages[safe].reshape(b, max_len, h_kv, d).float()
    vf = v_pages[safe].reshape(b, max_len, h_kv, d).float()
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, h_kv, h // h_kv, d)
    s = torch.einsum('bhgd,bkhd->bhgk', qg, kf) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    length = lengths.long().clamp(0, max_len)[:, None]          # [B, 1]
    empty = length == 0
    pos = torch.arange(max_len, device=q.device)[None, :]
    live = (pos < torch.where(empty, page, length))[:, None, None, :]
    # Equal scores on an empty slot's rows: the softmax is their mean.
    s = torch.where(empty[:, None, None], 0.0, s)
    p = torch.softmax(torch.where(live, s, -torch.inf), dim=-1)
    out = torch.einsum('bhgk,bkhd->bhgd', p, vf)
    return out.reshape(b, 1, h, d).to(q.dtype)


def _paged_decode_cuda(q, k_pages, v_pages, lengths, block_tables,
                       logit_softcap, scale) -> torch.Tensor:
    if not q.is_cuda:
        raise ValueError(f'_paged_decode_cuda launches a CUDA kernel; got '
                         f'a {q.device} tensor')
    b, s, h, d = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape or s != 1 or (
            k_pages.shape[3] != d):
        raise ValueError(
            f'paged_decode_attention shapes: q {tuple(q.shape)}, k_pages '
            f'{tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)}')
    num_pages, page, h_kv = k_pages.shape[:3]
    if d not in HEAD_DIMS or h % h_kv or h // h_kv > MAX_GROUPS:
        raise ValueError(
            f'paged_decode_attention takes head_dim in {HEAD_DIMS} and at '
            f'most {MAX_GROUPS} query heads per KV head; got d={d}, '
            f'h={h}, h_kv={h_kv}')
    if page not in PAGE_SIZES:
        raise ValueError(f'paged_decode_attention takes page sizes '
                         f'{PAGE_SIZES}; got {page}')
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'q dtype {q.dtype}: need bf16 or fp32')
    if k_pages.dtype not in (torch.bfloat16, torch.float32) or (
            k_pages.dtype != v_pages.dtype):
        raise ValueError(f'page arena dtypes {k_pages.dtype}/'
                         f'{v_pages.dtype}: need bf16 or fp32')
    if (block_tables.dtype != torch.int32 or block_tables.ndim != 2
            or block_tables.shape[0] != b):
        raise ValueError('block_tables must be int32 [B, nblk]')
    nblk = block_tables.shape[1]
    if not 0 < nblk <= MAX_BLOCKS:
        raise ValueError(f'paged_decode_attention takes 1 to {MAX_BLOCKS} '
                         f'blocks per slot; got {nblk}')
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError('lengths must be int32 [B]')
    tensors = [q, k_pages, v_pages, lengths, block_tables]
    if any(t.device != q.device for t in tensors):
        raise ValueError('paged_decode_attention inputs must share a '
                         'device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('paged_decode_attention needs contiguous inputs')
    out = torch.empty_like(q)
    PAGED_KERNEL.launch(
        kernels.ptr(q), kernels.ptr(k_pages), kernels.ptr(v_pages),
        kernels.ptr(lengths), kernels.ptr(block_tables), kernels.ptr(out),
        b, num_pages, page, nblk, h, h_kv, d,
        float(d ** -0.5 if scale is None else scale),
        0.0 if logit_softcap is None else float(logit_softcap),
        kernels.DTYPE_CODES[q.dtype], kernels.DTYPE_CODES[k_pages.dtype],
        kernels.stream_ptr(q.device))
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, lengths: torch.Tensor,
                           block_tables: torch.Tensor,
                           window: Optional[int] = None,
                           logit_softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over the paged slot cache.

    q: [B, 1, H, D]; k_pages/v_pages: [P, page, Hkv, D] shared page
    arenas (bf16 or fp32; an int8 pair or a window raises); block_tables:
    [B, nblk] int32, the physical page of each logical KV block (entries
    outside [0, P) mean "unallocated" and clamp into range: the lengths
    bound keeps a live slot from ever reading one); lengths: [B] int32,
    clamped to nblk*page. Returns [B, 1, H, D] in q's type.
    """
    _check_paged(k_pages, v_pages, window)
    if q.device.type == 'cpu':
        return paged_decode_attention_plain(
            q, k_pages, v_pages, lengths, block_tables,
            logit_softcap=logit_softcap, scale=scale)
    return _paged_decode_cuda(q, k_pages, v_pages, lengths, block_tables,
                              logit_softcap, scale)
