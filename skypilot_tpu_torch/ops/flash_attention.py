"""Flash attention: hand-written Hopper kernels + plain versions, forward
and gradient.

Counterpart of ``skypilot_tpu/ops/flash_attention.py``: the forward
(``_fwd_kernel`` / ``_flash_fwd``) is ``csrc/flash_fwd.cu``; the backward
pair (``_bwd_dkv_kernel`` / ``_bwd_dq_kernel`` / ``_bwd_flash``) is
``csrc/flash_bwd.cu``, one library with two entry points and two launch
counts. In bf16 at head dims 64 and 128 the forward, dK/dV and dQ are
TMA + wgmma kernels built on ``csrc/hopper.cuh``, and one backward runs
the row pre-pass they share (LSE in base 2, delta) once; the sources'
headers say what bounds each kernel on the H100 and how it is laid out.
The forward also takes head dim 256 (Gemma; FWD_HEAD_DIMS); the backward
does not yet (BWD_HEAD_DIMS: ROADMAP.md queue 1, "Gemma training (K2/K3
at D 256)"), and its wrappers refuse it.
``flash_attention`` is a ``torch.autograd.Function`` (the JAX
``custom_vjp``): its forward saves the LSE, its backward recomputes P
from it.

A CUDA tensor launches the kernels (or the wrapper raises); a CPU tensor
takes ``flash_attention_plain`` and ``flash_attention_bwd_plain``, the
same functions in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import kernels

_NEG_INF = -1e30
FWD_HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_HEAD_DIMS = (16, 32, 64, 128)

_SHAPE_ARGS = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float,
                                    ctypes.c_int, ctypes.c_void_p]
KERNEL = kernels.Kernel(
    'flash_fwd', 'flash_fwd.cu', 'xsky_flash_fwd',
    [ctypes.c_void_p] * 6 + _SHAPE_ARGS)
# The backward pair: pointers, then the scratch of the row pre-pass and
# whether this launch fills it.
DKV_KERNEL = kernels.Kernel(
    'flash_bwd_dkv', 'flash_bwd.cu', 'xsky_flash_bwd_dkv',
    [ctypes.c_void_p] * 10 + [ctypes.c_int] + _SHAPE_ARGS)
# The TMA loads of the bf16 wgmma kernels read from 16-byte-aligned bases.
TMA_ALIGN = 16
DQ_KERNEL = kernels.Kernel(
    'flash_bwd_dq', 'flash_bwd.cu', 'xsky_flash_bwd_dq',
    [ctypes.c_void_p] * 9 + [ctypes.c_int] + _SHAPE_ARGS)


def _plain_scores(q, k, causal, window, segment_ids, logit_softcap, scale):
    """fp32 masked scores [B, H, S_q, S_kv] and the softcap's chain factor
    d(capped)/d(scaled) (None without a softcap), K at query-head width."""
    s_q, h, d = q.shape[1], q.shape[2], q.shape[3]
    s_kv = k.shape[1]
    groups = h // k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    kf = k.float().repeat_interleave(groups, dim=2)
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), kf) * scale
    dcap = None
    if logit_softcap is not None:
        t = torch.tanh(s / logit_softcap)
        s = logit_softcap * t
        dcap = 1.0 - t * t
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
    return torch.where(keep, s, _NEG_INF), dcap


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
    groups = q.shape[2] // k.shape[2]
    vf = v.float().repeat_interleave(groups, dim=2)
    s, _ = _plain_scores(q, k, causal, window, segment_ids, logit_softcap,
                         scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lse = (m + torch.log(p.sum(dim=-1, keepdim=True)))[..., 0]
    out = torch.einsum('bhqk,bkhd->bqhd', p / p.sum(-1, keepdim=True), vf)
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, lse: torch.Tensor,
                              causal: bool = True,
                              window: Optional[int] = None,
                              segment_ids: Optional[torch.Tensor] = None,
                              logit_softcap: Optional[float] = None,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' function in plain PyTorch → (dq, dk, dv).

    The FlashAttention-2 equations in fp32, as the Pallas kernels
    compute them: S recomputed (softcap, then the -1e30 mask),
    P = exp(S - lse), delta = Σ dO⊙O, dS = P·(dP - delta)·scale (times
    1 - tanh² under a softcap); dK and dV summed over each GQA group, so
    they come out at Hkv width. Each gradient in its input's type.
    """
    b, s_kv, h_kv, d = k.shape
    groups = q.shape[2] // h_kv
    scale_ = d ** -0.5 if scale is None else scale
    s, dcap = _plain_scores(q, k, causal, window, segment_ids,
                            logit_softcap, scale)
    p = torch.exp(s - lse.float()[..., None])
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)[..., None]
    dp = torch.einsum('bqhd,bkhd->bhqk', do,
                      v.float().repeat_interleave(groups, dim=2))
    ds = p * (dp - delta) * scale_
    if dcap is not None:
        ds = ds * dcap
    dq = torch.einsum('bhqk,bkhd->bqhd', ds,
                      k.float().repeat_interleave(groups, dim=2))
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, q.float())
    dv = torch.einsum('bhqk,bqhd->bkhd', p, do)
    dk = dk.reshape(b, s_kv, h_kv, groups, d).sum(3)
    dv = dv.reshape(b, s_kv, h_kv, groups, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def gradient_errors(got: torch.Tensor, want: torch.Tensor,
                    block_rows: int = 64) -> Tuple[float, float]:
    """How far a gradient or a forward output [B, S, H, D] is from its
    reference, each block of ``block_rows`` rows of one (batch row, head)
    judged against the reference's own size there → (norm_err, elem_err).

    norm_err is the largest ||got - want|| / ||want|| over the blocks;
    elem_err the largest |got - want| over the RMS of ``want`` in the
    element's block. Both are local because attention gradients and
    outputs shrink along the sequence (about as 1/sqrt(pos) under a
    causal mask): one absolute tolerance would be loose for the later
    rows. A block far
    smaller than the whole (RMS under 1e-3 of the tensor's) is judged
    against that floor, so a near-zero block does not divide by zero.
    A non-finite value in ``got`` gives (inf, inf).
    """
    err = got.float() - want.float()
    if not bool(torch.isfinite(err).all()):
        return float('inf'), float('inf')
    ref = want.float()
    b, s, h, d = ref.shape
    pad = (-s) % block_rows
    err, ref = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                for t in (err, ref))
    blocks = (b, (s + pad) // block_rows, block_rows, h, d)
    err, ref = err.reshape(blocks), ref.reshape(blocks)
    rows = torch.full((blocks[1],), float(block_rows), device=ref.device)
    rows[-1] = block_rows - pad
    count = rows[None, :, None] * d
    floor = max(1e-3 * float(ref.square().sum() / (b * s * h * d)) ** 0.5,
                1e-30)
    rms = (ref.square().sum((2, 4)) / count).sqrt().clamp_min(floor)
    norm_err = (err.square().sum((2, 4)) / count).sqrt() / rms
    elem_err = err.abs() / rms[:, :, None, :, None]
    return float(norm_err.max()), float(elem_err.max())


def _check(q, k, v, segment_ids) -> None:
    b, s_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f'k/v shape {tuple(k.shape)} does not fit q '
                         f'{tuple(q.shape)}')
    if h % k.shape[2]:
        raise ValueError(f'{h} query heads not a multiple of '
                         f'{k.shape[2]} KV heads')
    if d not in FWD_HEAD_DIMS:
        raise ValueError(f'head_dim {d} not in {FWD_HEAD_DIMS}')
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
    check_aligned(q=q, k=k, v=v)


def check_aligned(**tensors: torch.Tensor) -> None:
    """Raise unless each tensor's base is 16-byte aligned, as the TMA
    loads of the bf16 wgmma kernels need. A contiguous view that starts a
    few elements into its storage is not."""
    for name, t in tensors.items():
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(
                f'flash_attention needs {name} to start on a {TMA_ALIGN}-'
                f'byte boundary (TMA); its base {t.data_ptr():#x} is not: '
                'pass a .clone()')


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
    b, s_q, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    KERNEL.launch(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        kernels.ptr(segment_ids), kernels.ptr(out), kernels.ptr(lse),
        *_shape_args(q, k, causal, window, softcap, scale_override))
    return out, lse


def _shape_args(q, k, causal, window, softcap, scale_override):
    b, s_q, h, d = q.shape
    scale = d ** -0.5 if scale_override is None else scale_override
    return (b, s_q, k.shape[1], h, k.shape[2], d, int(causal),
            0 if window is None else int(window), float(scale),
            0.0 if softcap is None else float(softcap),
            kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q.device))


def _check_bwd(q, k, v, segment_ids, out, dout, lse) -> None:
    if not q.is_cuda:
        raise ValueError(f'the flash backward launches a CUDA kernel; got '
                         f'a {q.device} tensor')
    if q.shape[-1] not in BWD_HEAD_DIMS:
        raise ValueError(
            f'the flash backward takes head_dim in {BWD_HEAD_DIMS}; '
            f'{q.shape[-1]} is not ported yet: ROADMAP.md queue 1, "Gemma '
            'training (K2/K3 at D 256)"')
    _check(q, k, v, segment_ids)
    b, s_q, h, _ = q.shape
    for name, t in (('out', out), ('dout', dout)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f'{name} must be a contiguous {q.dtype} '
                             f'{tuple(q.shape)} tensor on {q.device}')
    check_aligned(out=out, dout=dout)
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s_q)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError('lse must be a contiguous fp32 [B, H, S] tensor')


def _bwd_common(q, k, v, segment_ids, out, dout, lse):
    return (kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
            kernels.ptr(segment_ids), kernels.ptr(out), kernels.ptr(dout),
            kernels.ptr(lse))


def _flash_bwd_dq(q, k, v, segment_ids, out, dout, lse, *, stats=None,
                  fill_stats=True, causal=True, window=None, softcap=None,
                  scale_override=None) -> torch.Tensor:
    """Launch the dQ kernel (K3) → dq [B, S, H, D].

    stats / fill_stats: the row pre-pass's scratch (``bwd_scratch``) and
    whether this launch computes it. By default the launch fills scratch
    of its own; ``_flash_bwd`` hands one scratch to both kernels and lets
    only the first fill it."""
    _check_bwd(q, k, v, segment_ids, out, dout, lse)
    if stats is None:
        stats, fill_stats = bwd_scratch(q), True
    dq = torch.empty_like(q)
    DQ_KERNEL.launch(*_bwd_common(q, k, v, segment_ids, out, dout, lse),
                     kernels.ptr(dq), kernels.ptr(stats), int(fill_stats),
                     *_shape_args(q, k, causal, window, softcap,
                                  scale_override))
    return dq


def _flash_bwd_dkv(q, k, v, segment_ids, out, dout, lse, *, stats=None,
                   fill_stats=True, causal=True, window=None, softcap=None,
                   scale_override=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel (K2) → (dk, dv) [B, S_kv, Hkv, D].
    stats / fill_stats as for ``_flash_bwd_dq``."""
    _check_bwd(q, k, v, segment_ids, out, dout, lse)
    if stats is None:
        stats, fill_stats = bwd_scratch(q), True
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    DKV_KERNEL.launch(*_bwd_common(q, k, v, segment_ids, out, dout, lse),
                      kernels.ptr(dk), kernels.ptr(dv), kernels.ptr(stats),
                      int(fill_stats),
                      *_shape_args(q, k, causal, window, softcap,
                                   scale_override))
    return dk, dv


def bwd_scratch(q: torch.Tensor) -> Optional[torch.Tensor]:
    """Scratch of the backward kernels' row pre-pass, or None where they
    take none: fp32, as many floats as the kernels' library asks for
    (each query row's LSE in base 2 and its delta = Σ dO⊙O, computed once
    per row). The library alone knows which shapes run the wgmma kernels
    and how far their query tiles pad S."""
    b, s, h, d = q.shape
    floats = DQ_KERNEL.query('xsky_flash_bwd_scratch_floats', b, s, h, d,
                             kernels.DTYPE_CODES[q.dtype])
    if not floats:
        return None
    return torch.empty(floats, dtype=torch.float32, device=q.device)


def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               segment_ids: Optional[torch.Tensor], out: torch.Tensor,
               dout: torch.Tensor, lse: torch.Tensor, **options
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dQ kernel, then the dK/dV kernel → (dq, dk, dv).
    The row pre-pass runs once, inside the dQ launch, and the dK/dV launch
    reads the same scratch. options: causal, window, softcap,
    scale_override (as _flash_fwd)."""
    _check_bwd(q, k, v, segment_ids, out, dout, lse)
    stats = bwd_scratch(q)
    dq = _flash_bwd_dq(q, k, v, segment_ids, out, dout, lse, stats=stats,
                       fill_stats=True, **options)
    dk, dv = _flash_bwd_dkv(q, k, v, segment_ids, out, dout, lse,
                            stats=stats, fill_stats=False, **options)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward keeps (q, k, v,
    segment ids, out, lse), the backward recomputes P from the LSE. CPU
    tensors take the plain versions of both halves."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window, softcap, scale):
        if q.device.type == 'cpu':
            out, lse = flash_attention_plain(
                q, k, v, causal=causal, window=window,
                segment_ids=segment_ids, logit_softcap=softcap, scale=scale)
        else:
            out, lse = _flash_fwd(q, k, v, segment_ids, causal=causal,
                                  window=window, softcap=softcap,
                                  scale_override=scale)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.options = (causal, window, softcap, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        causal, window, softcap, scale = ctx.options
        dout = dout.contiguous()
        if q.device.type == 'cpu':
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, out, dout, lse, causal=causal, window=window,
                segment_ids=segment_ids, logit_softcap=softcap, scale=scale)
        else:
            dq, dk, dv = _flash_bwd(q, k, v, segment_ids, out, dout, lse,
                                    causal=causal, window=window,
                                    softcap=softcap, scale_override=scale)
        # Segment ids are integral: no gradient.
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    logit_softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention; q [B,S,H,D], k/v [B,S,Hkv,D] (GQA) → [B,S,H,D].

    window: sliding window — tiles left of it are skipped. segment_ids
    [B, S] int32: packed-sequence document masking. Differentiable in q,
    k and v. A CPU tensor takes the plain versions; a CUDA tensor the
    kernels.
    """
    return _FlashAttention.apply(q, k, v, segment_ids, causal, window,
                                 logit_softcap, scale)
