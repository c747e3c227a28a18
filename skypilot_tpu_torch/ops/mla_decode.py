"""Absorbed-MLA decode attention over the compressed cache, dense and
paged: Hopper kernels + plain versions.

Counterpart of ``skypilot_tpu/ops/mla_decode.py``. The absorbed MLA
decode step (``models/deepseek.py``) scores each slot's queries directly
against the compressed cache:

    scores[b,h,t] = (q_eff[b,h,:]·c_kv[b,t,:] + q_rope[b,h,:]·k_rope[b,t,:])·scale
    out_c[b,h,:]  = softmax(scores)·c_kv[b,:,:]

  * ``mla_decode_attention`` (its ``_mla_decode_kernel`` /
    ``mla_decode_attention``) over the dense cache [B, K, r];
    kernel ``csrc/mla_decode.cu``;
  * ``paged_mla_decode_attention`` (its ``_paged_mla_adapter`` /
    ``paged_mla_decode_attention``) over page arenas [P, page, r] shared
    by all slots through block tables; kernel ``csrc/paged_mla_decode.cu``.

The two kernels share their row walk (``csrc/mla_common.cuh``); each
source's header says what bounds it on the H100 and what the design does
about it. The rank-side products (q_nope·W_uk before, out_c·W_uv after)
stay with the caller, as in the reference. The math is fp32 whatever the
cache's type.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from skypilot_tpu_torch.ops import kernels

# Copies of the constants the JAX module borrows from its
# decode_attention.py (the port imports nothing of the JAX package).
DEFAULT_BLOCK_KV = 256
_NEG_INF = -1e30

# Rows one block of either kernel walks; csrc/mla_common.cuh's
# kMlaSplitRows. The wrapper sizes the per-split scratch with it.
SPLIT_ROWS = 128
MAX_HEADS = 16
MAX_RANK = 512
MAX_WIDTH = 1024          # r + dr: the staged row and the queries in smem
PAGE_SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256)

KERNEL = kernels.Kernel(
    'mla_decode', 'mla_decode.cu', 'xsky_mla_decode',
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 +
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

PAGED_KERNEL = kernels.Kernel(
    'paged_mla_decode', 'paged_mla_decode.cu', 'xsky_paged_mla_decode',
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 +
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _last_block(length: torch.Tensor, block_kv: int) -> torch.Tensor:
    """Index of the last live KV block for a slot of ``length`` rows."""
    return (length - 1).clamp(min=0) // block_kv


def mla_decode_attention_plain(q_eff: torch.Tensor, q_rope: torch.Tensor,
                               ckv_cache: torch.Tensor,
                               krope_cache: torch.Tensor,
                               lengths: torch.Tensor, scale: float,
                               block_kv: int = DEFAULT_BLOCK_KV
                               ) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 math) → [B, H, r] fp32.

    The Pallas grid's semantics, row by row: blocks of ``min(block_kv,
    K)`` rows up to ``_last_block(length)`` are read; inside them a row
    past the slot's length scores -1e30; rows of later blocks are never
    read. So a slot of length 0 returns the mean of its first block's
    c_kv rows (every score there is the same -1e30). Lengths clamp to K.
    """
    max_len = ckv_cache.shape[1]
    block_kv = min(block_kv, max_len)
    ckv = ckv_cache.float()
    s = (torch.einsum('bhr,btr->bht', q_eff.float(), ckv) +
         torch.einsum('bhd,btd->bht', q_rope.float(),
                      krope_cache.float())) * scale
    length = lengths.long().clamp(0, max_len)[:, None]            # [B, 1]
    pos = torch.arange(max_len, device=q_eff.device)[None, :]
    read = pos // block_kv <= _last_block(length, block_kv)
    s = torch.where((pos < length)[:, None], s, _NEG_INF)
    s = torch.where(read[:, None], s, -torch.inf)
    return torch.einsum('bht,btr->bhr', torch.softmax(s, dim=-1), ckv)


def paged_mla_decode_attention_plain(q_eff: torch.Tensor,
                                     q_rope: torch.Tensor,
                                     ckv_pages: torch.Tensor,
                                     krope_pages: torch.Tensor,
                                     lengths: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     scale: float) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch: gather each slot's
    pages (table entries clipped to [0, P - 1]) into a dense [B,
    nblk*page, ·] view, then the dense plain version with one page per
    block (lengths clamp to nblk*page; a length-0 slot returns the mean
    of its first page's c_kv rows)."""
    b = q_eff.shape[0]
    num_pages, page = ckv_pages.shape[:2]
    safe = block_tables.long().clamp(0, num_pages - 1)
    ckv = ckv_pages[safe].reshape(b, -1, ckv_pages.shape[-1])
    krope = krope_pages[safe].reshape(b, -1, krope_pages.shape[-1])
    return mla_decode_attention_plain(q_eff, q_rope, ckv, krope, lengths,
                                      scale, block_kv=page)


def _check_common(q_eff, q_rope, ckv, krope, lengths, name) -> None:
    if not q_eff.is_cuda:
        raise ValueError(f'{name} launches a CUDA kernel; got a '
                         f'{q_eff.device} tensor')
    b, h, r = q_eff.shape
    dr = q_rope.shape[-1]
    if tuple(q_rope.shape) != (b, h, dr) or ckv.shape[-1] != r or (
            krope.shape[-1] != dr) or ckv.shape[:-1] != krope.shape[:-1]:
        raise ValueError(f'{name} shapes: q_eff {tuple(q_eff.shape)}, '
                         f'q_rope {tuple(q_rope.shape)}, c_kv '
                         f'{tuple(ckv.shape)}, k_rope {tuple(krope.shape)}')
    if (h > MAX_HEADS or r > MAX_RANK or r % 8 or dr % 8
            or r + dr > MAX_WIDTH):
        raise ValueError(f'{name} takes at most {MAX_HEADS} heads, a rank '
                         f'of at most {MAX_RANK}, r and dr multiples of 8 '
                         f'and r + dr <= {MAX_WIDTH}; got h={h}, r={r}, '
                         f'dr={dr}')
    if q_eff.dtype != torch.float32 or q_rope.dtype != torch.float32:
        raise ValueError('q_eff and q_rope must be fp32 (the absorbed step '
                         'computes in fp32)')
    if ckv.dtype not in (torch.bfloat16, torch.float32) or (
            krope.dtype != ckv.dtype):
        raise ValueError(f'cache dtypes {ckv.dtype}/{krope.dtype}: need '
                         'bf16 or fp32, the same for both')
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError('lengths must be int32 [B]')
    tensors = [q_eff, q_rope, ckv, krope, lengths]
    if any(t.device != q_eff.device for t in tensors):
        raise ValueError(f'{name} inputs must share a device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{name} needs contiguous inputs')
    if ckv.data_ptr() % 16 or krope.data_ptr() % 16:
        raise ValueError(f'{name} reads the cache 16 bytes at a time: '
                         'its base pointers must be 16-byte aligned')


def _scratch(q_eff: torch.Tensor, cap: int):
    """Per-split partial state the kernel's combine pass merges: the
    unnormalised accumulator [B, S, H, r] and (max, sum) [B, S, H, 2]."""
    b, h, r = q_eff.shape
    splits = -(-cap // SPLIT_ROWS)
    return (splits,
            torch.empty((b, splits, h, r), dtype=torch.float32,
                        device=q_eff.device),
            torch.empty((b, splits, h, 2), dtype=torch.float32,
                        device=q_eff.device))


def _mla_decode_cuda(q_eff, q_rope, ckv, krope, lengths, scale,
                     block_kv) -> torch.Tensor:
    _check_common(q_eff, q_rope, ckv, krope, lengths, 'mla_decode_attention')
    b, h, r = q_eff.shape
    if ckv.ndim != 3 or ckv.shape[0] != b:
        raise ValueError(f'mla_decode_attention: c_kv must be [B, K, r]; '
                         f'got {tuple(ckv.shape)}')
    max_len = ckv.shape[1]
    out = torch.empty_like(q_eff)
    splits, part_acc, part_ml = _scratch(q_eff, max_len)
    KERNEL.launch(
        kernels.ptr(q_eff), kernels.ptr(q_rope), kernels.ptr(ckv),
        kernels.ptr(krope), kernels.ptr(lengths), kernels.ptr(out),
        kernels.ptr(part_acc), kernels.ptr(part_ml), b, max_len, h, r,
        q_rope.shape[-1], min(block_kv, max_len), splits, float(scale),
        kernels.DTYPE_CODES[ckv.dtype], kernels.stream_ptr(q_eff.device))
    return out


def mla_decode_attention(q_eff: torch.Tensor, q_rope: torch.Tensor,
                         ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                         lengths: torch.Tensor, scale: float,
                         block_kv: int = DEFAULT_BLOCK_KV) -> torch.Tensor:
    """Length-bounded absorbed-MLA decode → out_c [B, H, r] (fp32).

    q_eff: [B, H, r] (q_nope already absorbed through W_uk), fp32;
    q_rope: [B, H, dr] fp32; ckv_cache: [B, K, r]; krope_cache: [B, K,
    dr] (bf16 or fp32); lengths: [B] int32 live rows per slot (the
    step's own entry already written at lengths[b]-1), clamped to K.
    ``block_kv`` only sets what a length-0 slot returns: the mean of its
    first min(block_kv, K) c_kv rows, as the Pallas grid gives it. The
    caller applies W_uv afterwards.
    """
    if q_eff.device.type == 'cpu':
        return mla_decode_attention_plain(q_eff, q_rope, ckv_cache,
                                          krope_cache, lengths, scale,
                                          block_kv)
    return _mla_decode_cuda(q_eff, q_rope, ckv_cache, krope_cache, lengths,
                            scale, block_kv)


def _paged_mla_decode_cuda(q_eff, q_rope, ckv, krope, lengths,
                           block_tables, scale) -> torch.Tensor:
    _check_common(q_eff, q_rope, ckv, krope, lengths,
                  'paged_mla_decode_attention')
    b, h, r = q_eff.shape
    if ckv.ndim != 3:
        raise ValueError(f'paged_mla_decode_attention: arenas must be '
                         f'[P, page, ·]; got {tuple(ckv.shape)}')
    num_pages, page = ckv.shape[:2]
    if page not in PAGE_SIZES:
        raise ValueError(f'paged_mla_decode_attention takes page sizes '
                         f'{PAGE_SIZES}; got {page}')
    if (block_tables.dtype != torch.int32 or block_tables.ndim != 2
            or block_tables.shape[0] != b or block_tables.shape[1] == 0):
        raise ValueError('block_tables must be int32 [B, nblk], nblk > 0')
    if block_tables.device != q_eff.device or not (
            block_tables.is_contiguous()):
        raise ValueError('block_tables must be contiguous, on the inputs\' '
                         'device')
    nblk = block_tables.shape[1]
    out = torch.empty_like(q_eff)
    splits, part_acc, part_ml = _scratch(q_eff, nblk * page)
    PAGED_KERNEL.launch(
        kernels.ptr(q_eff), kernels.ptr(q_rope), kernels.ptr(ckv),
        kernels.ptr(krope), kernels.ptr(lengths), kernels.ptr(block_tables),
        kernels.ptr(out), kernels.ptr(part_acc), kernels.ptr(part_ml), b,
        num_pages, page, nblk, h, r, q_rope.shape[-1], splits, float(scale),
        kernels.DTYPE_CODES[ckv.dtype], kernels.stream_ptr(q_eff.device))
    return out


def paged_mla_decode_attention(q_eff: torch.Tensor, q_rope: torch.Tensor,
                               ckv_pages: torch.Tensor,
                               krope_pages: torch.Tensor,
                               lengths: torch.Tensor,
                               block_tables: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """Absorbed-MLA decode over the PAGED compressed cache → [B, H, r]
    fp32.

    ckv_pages: [P, page, r]; krope_pages: [P, page, dr] shared arenas;
    block_tables: [B, nblk] int32, the physical page of each logical
    block (entries outside [0, P) are unallocated sentinels and clamp
    into range: a live slot's length never reaches one); lengths: [B]
    int32, clamped to nblk*page. A slot of length 0 returns the mean of
    its first (clamped) page's c_kv rows.
    """
    if q_eff.device.type == 'cpu':
        return paged_mla_decode_attention_plain(
            q_eff, q_rope, ckv_pages, krope_pages, lengths, block_tables,
            scale)
    return _paged_mla_decode_cuda(q_eff, q_rope, ckv_pages, krope_pages,
                                  lengths, block_tables, scale)
