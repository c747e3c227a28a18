"""Weight matmuls and embedding lookups, plain or weight-only quantized.

Counterpart of ``skypilot_tpu/ops/quantization.py``. Weights are stored
int8 with per-output-channel fp32 scales (``QuantizedTensor``), or as
packed int4 nibbles with fp32 scales per group of 128 contraction rows
(``Quantized4Tensor``). ``matmul``, ``expert_matmul``, ``embed_rows``
and ``tied_head`` dispatch on the weight's type: plain tensors pass
through, so training shares the call sites.

The quantized branches compute what the reference computes, in the same
order and types:

  * int8: ``(x @ q.to(x.dtype)) * scale.to(out.dtype)`` — the scale is
    applied after the product, rounded to the product's type;
  * int4: the weight is dequantized to ``x.dtype`` first (fp32
    ``q * scale`` per group, then rounded), then multiplied;
  * scales are fp32 ``max(amax, 1e-8) / 127`` (int8) or ``/ 7`` (int4)
    over the contraction axis, values rounded half to even.

The reference has no Pallas kernel for the dequantization (XLA fuses it
into the matmul), so these are torch products over a dequantized
operand: each call writes a full-width copy of the weight. The quantized
branches are for serving only and refuse a gradient.

``axis`` is the contraction axis counted from the end, so a stacked
``[L, in, out]`` weight stays valid after ``w[layer]`` takes one layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]

# Columns of a narrow weight upcast at a time for an fp32-output product
# (4096 x 8192 fp32 = 128 MiB of scratch for the Llama-3 LM head).
UPCAST_COLUMNS = 8192


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """int8 values + per-output-channel fp32 scales.

    ``axis`` is the CONTRACTION axis as a negative index; ``scale`` has
    the shape of ``q`` with that axis removed.
    """
    q: torch.Tensor
    scale: torch.Tensor
    axis: int = -2

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return _nbytes(self.q) + _nbytes(self.scale)

    def __getitem__(self, index) -> 'QuantizedTensor':
        """Leading-axis indexing (``w[layer]`` of a stacked weight): q and
        scale are sliced together."""
        _check_leading(self.ndim, self.axis)
        return QuantizedTensor(self.q[index], self.scale[index], self.axis)

    def to(self, device) -> 'QuantizedTensor':
        """The same tensor on ``device`` (the stored types never change)."""
        return QuantizedTensor(self.q.to(device), self.scale.to(device),
                               self.axis)


@dataclasses.dataclass(frozen=True)
class Quantized4Tensor:
    """Packed int4 values + group-wise fp32 scales.

    Two signed 4-bit values per byte along the CONTRACTION axis:
    ``q_packed`` has that axis halved. ``scale`` has the contraction axis
    replaced by the group count G = in / group.
    """
    q_packed: torch.Tensor
    scale: torch.Tensor
    axis: int = -2
    group: int = 128

    @property
    def shape(self):
        """LOGICAL shape (unpacked)."""
        s = list(self.q_packed.shape)
        s[self.axis] *= 2
        return tuple(s)

    @property
    def ndim(self) -> int:
        return self.q_packed.ndim

    @property
    def device(self) -> torch.device:
        return self.q_packed.device

    @property
    def nbytes(self) -> int:
        return _nbytes(self.q_packed) + _nbytes(self.scale)

    def __getitem__(self, index) -> 'Quantized4Tensor':
        _check_leading(self.ndim, self.axis)
        return Quantized4Tensor(self.q_packed[index], self.scale[index],
                                self.axis, self.group)

    def to(self, device) -> 'Quantized4Tensor':
        return Quantized4Tensor(self.q_packed.to(device),
                                self.scale.to(device), self.axis,
                                self.group)


_QUANTIZED = (QuantizedTensor, Quantized4Tensor)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _check_leading(ndim: int, axis: int) -> None:
    if ndim + axis <= 0:
        raise IndexError('a quantized tensor is indexed along leading axes '
                         'only, never along its contraction axis')


def from_numpy(leaf: Any, device: torch.device):
    """A quantized leaf whose arrays are numpy (the JAX tree's
    ``QuantizedTensor`` / ``Quantized4Tensor`` after ``np.asarray`` of
    each child) → the port's, with the int8 bytes and fp32 scales
    unchanged."""
    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device)

    if hasattr(leaf, 'q_packed'):
        return Quantized4Tensor(tensor(leaf.q_packed), tensor(leaf.scale),
                                int(leaf.axis), int(leaf.group))
    return QuantizedTensor(tensor(leaf.q), tensor(leaf.scale),
                           int(leaf.axis))


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, _QUANTIZED)


# ---- int4 packing ----

def _pack4(q: torch.Tensor, axis: int) -> torch.Tensor:
    """int8 values in [-8, 7] → packed bytes; ``axis`` (negative) halves.

    Byte b at pair index p holds (q[2p] & 0xF) | (q[2p+1] << 4)."""
    ax = q.ndim + axis
    pairs = q.reshape(q.shape[:ax] + (q.shape[ax] // 2, 2) +
                      q.shape[ax + 1:])
    lo = pairs.select(ax + 1, 0).view(torch.uint8)
    hi = pairs.select(ax + 1, 1).view(torch.uint8)
    return ((hi << 4) | (lo & 0xF)).view(torch.int8)


def _unpack4(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Packed bytes → int8 values in [-8, 7]; ``axis`` (negative)
    doubles. Arithmetic shifts recover the signed nibbles."""
    ax = packed.ndim + axis
    lo = (packed.view(torch.uint8) << 4).view(torch.int8) >> 4
    hi = packed >> 4
    pair = torch.stack([lo, hi], dim=ax + 1)   # [..., dim/2, 2, ...]
    return pair.reshape(packed.shape[:ax] + (packed.shape[ax] * 2,) +
                        packed.shape[ax + 1:])


# ---- quantize / dequantize ----

def _fp32_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor, rounded as one fp32 division. The divisor goes in as
    a tensor: CUDA's division by a Python scalar multiplies by the
    scalar's reciprocal, which rounds differently, so the card's scales
    (and then its int8 values) would differ from the reference's."""
    return x / torch.full_like(x, divisor)


def quantize4(w: torch.Tensor, axis: int = -2,
              group: int = 128) -> Quantized4Tensor:
    """Symmetric group-wise int4 over the contraction ``axis``.

    Groups of ``group`` consecutive contraction rows share one fp32 scale
    (amax / 7). Falls back to one group when the axis is shorter than
    ``group``; the axis length must be even (packing) and divisible by the
    effective group size.
    """
    if axis >= 0:
        axis = axis - w.ndim
    dim = w.shape[axis]
    group = min(group, dim)
    if dim % 2 or dim % group or group % 2:
        raise ValueError(f'int4 needs even, group-divisible contraction '
                         f'(dim={dim}, group={group})')
    ax = w.ndim + axis
    grouped = w.float().reshape(
        w.shape[:ax] + (dim // group, group) + w.shape[ax + 1:])
    amax = grouped.abs().amax(dim=ax + 1)                 # [..., G, ...]
    scale = _fp32_div(amax.clamp(min=1e-8), 7.0)
    q = torch.clamp(torch.round(grouped / scale.unsqueeze(ax + 1)),
                    -8, 7).to(torch.int8).reshape(w.shape)
    return Quantized4Tensor(_pack4(q, axis), scale, axis, group)


def dequantize4(w: Quantized4Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    q = _unpack4(w.q_packed, w.axis)
    ax = q.ndim + w.axis
    dim = q.shape[ax]
    grouped = q.float().reshape(
        q.shape[:ax] + (dim // w.group, w.group) + q.shape[ax + 1:])
    out = grouped * w.scale.unsqueeze(ax + 1)
    return out.reshape(q.shape).to(dtype)


def quantize(w: torch.Tensor, axis: int = -2) -> QuantizedTensor:
    """Symmetric per-output-channel int8 over the contraction ``axis``."""
    if axis >= 0:
        axis = axis - w.ndim
    wf = w.float()
    amax = wf.abs().amax(dim=axis)
    scale = _fp32_div(amax.clamp(min=1e-8), 127.0)
    q = torch.round(wf / scale.unsqueeze(axis)).to(torch.int8)
    return QuantizedTensor(q, scale, axis)


def dequantize(w: QuantizedTensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (w.q.float() * w.scale.unsqueeze(w.axis)).to(dtype)


# ---- products ----

class _UpcastMatmul(torch.autograd.Function):
    """fp32 ``x @ w`` from lower-precision operands, UPCAST_COLUMNS output
    columns at a time, with a gradient that saves only x and w.

    Autograd through the chunked forward would save an fp32 copy of every
    weight chunk (the whole weight in fp32) and hand each chunk's slice
    gradient back as a full-size tensor; this backward instead upcasts
    one chunk at a time again and writes dW chunk by chunk into one
    tensor. Gradients come back in x's and w's types, as JAX casts a
    cotangent to its primal's type. Under a tensor split ``w`` is the
    LM head's block of vocabulary columns: the product and dW are that
    block's, and dx is this rank's part (summed by the caller's
    ``mesh.tensor_input``). (``torch.mm(x, w, out_dtype=
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


def _serving_only(x: torch.Tensor, what: str) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f'{what}: quantized weights are for serving; '
                           'no gradient is taken through them')


def _check_axis(w, axis: int, what: str) -> None:
    if w.axis != axis:
        raise ValueError(f'{what} needs contraction at {axis}, got {w.axis}')


def _weight_operand(w, dtype: torch.dtype) -> torch.Tensor:
    """A quantized weight as a ``dtype`` operand of a torch product: the
    int8 values cast (exact), or the int4 weight dequantized. Each call
    writes a full copy of the weight (``tools/torch_serve_profile.py``
    times these copies)."""
    if isinstance(w, QuantizedTensor):
        return w.q.to(dtype)
    return dequantize4(w, dtype)


def _plain_matmul(x: torch.Tensor, w: torch.Tensor,
                  preferred_element_type: Optional[torch.dtype]
                  ) -> torch.Tensor:
    if preferred_element_type is None or (
            x.dtype == w.dtype == preferred_element_type):
        return torch.matmul(x, w)
    return _UpcastMatmul.apply(x, w, preferred_element_type)


def matmul(x: torch.Tensor, w,
           preferred_element_type: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """``x @ w`` for ``w`` a plain ``[.., in, out]`` weight, a
    QuantizedTensor or a Quantized4Tensor.

    preferred_element_type=torch.float32 with bf16 operands asks, as in
    XLA, for fp32 products summed and returned in fp32. That is computed
    from an fp32 copy of x and of w taken UPCAST_COLUMNS output columns
    at a time, so the full weight is never held in fp32 (the bf16
    products are exact in fp32, so this is the same function); the
    gradient does the same (``_UpcastMatmul``). An int8 weight is upcast
    the same way straight from its int8 values (exact in bf16 and fp32).
    """
    if isinstance(w, QuantizedTensor):
        _check_axis(w, -2, 'matmul')
        _serving_only(x, 'matmul')
        if preferred_element_type not in (None, x.dtype):
            out = _UpcastMatmul.apply(x, w.q, preferred_element_type)
        else:
            out = torch.matmul(x, _weight_operand(w, x.dtype))
        return out * w.scale.to(out.dtype)
    if isinstance(w, Quantized4Tensor):
        _check_axis(w, -2, 'matmul')
        _serving_only(x, 'matmul')
        return _plain_matmul(x, _weight_operand(w, x.dtype),
                             preferred_element_type)
    return _plain_matmul(x, w, preferred_element_type)


class _UpcastBmm(torch.autograd.Function):
    """fp32 per-expert products from lower-precision operands on the
    card: cuBLAS's ``out_dtype`` forward, which torch 2.11 cannot
    differentiate, with the gradient the CPU's fp32 copies give: the fp32
    cotangent against fp32 copies of the operands, cast back to their
    types (JAX casts a cotangent to its primal's type)."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        ctx.save_for_backward(x, w)
        return torch.bmm(x, w, out_dtype=dtype)

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.bmm(dout, w.to(dout.dtype).transpose(1, 2)).to(
                x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.bmm(x.to(dout.dtype).transpose(1, 2), dout).to(
                w.dtype)
        return dx, dw, None


def _plain_expert_matmul(x: torch.Tensor, w: torch.Tensor,
                         preferred_element_type: Optional[torch.dtype]
                         ) -> torch.Tensor:
    if preferred_element_type is None or (
            x.dtype == w.dtype == preferred_element_type):
        return torch.bmm(x, w)
    if x.is_cuda:
        return _UpcastBmm.apply(x, w, preferred_element_type)
    return torch.bmm(x.to(preferred_element_type),
                     w.to(preferred_element_type))


def expert_matmul(x: torch.Tensor, w,
                  preferred_element_type: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """Per-expert ``x @ w``: x [E, C, in], w [E, in, out] → [E, C, out]
    (the reference's ``expert_einsum('ecd,edf->ecf', ...)``).

    preferred_element_type as in ``matmul``. On a card the fp32 output
    comes from cuBLAS (``out_dtype``: lower-precision operands, fp32 sums
    returned unrounded); the CPU has no such product, so there it is taken
    from fp32 copies, the same function, and so is the card's gradient
    (``_UpcastBmm``). Quantized weights are for serving only (no
    gradient); their [E, out] scale broadcasts as [E, 1, out].
    """
    if isinstance(w, QuantizedTensor):
        _check_axis(w, -2, 'expert_matmul')
        _serving_only(x, 'expert_matmul')
        out = _plain_expert_matmul(x, _weight_operand(w, x.dtype),
                                   preferred_element_type)
        return out * w.scale[:, None, :].to(out.dtype)
    if isinstance(w, Quantized4Tensor):
        _check_axis(w, -2, 'expert_matmul')
        _serving_only(x, 'expert_matmul')
        return _plain_expert_matmul(x, _weight_operand(w, x.dtype),
                                    preferred_element_type)
    return _plain_expert_matmul(x, w, preferred_element_type)


def embed_rows(table, tokens: torch.Tensor,
               start: Optional[int] = None) -> torch.Tensor:
    """``table[tokens]`` for a plain or row-quantized (axis -1) table.

    A plain table's gradient is autograd's scatter-add of the rows'
    gradients into one zero table (repeated tokens accumulate), as JAX's
    gather transposes to a scatter-add. A quantized table's rows come
    back in the scale's type (fp32); the model casts them.

    With ``start`` the table is the block of a larger vocabulary that
    begins at row ``start``: a token inside the block takes its row, a
    token outside it a row of zeros (and gives the block no gradient)."""
    if start is None:
        inside = None
    else:
        tokens = tokens - start
        inside = (tokens >= 0) & (tokens < table.shape[0])
        tokens = torch.where(inside, tokens, 0)
    if isinstance(table, QuantizedTensor):
        _check_axis(table, -1, 'embed_rows')
        rows = table.q[tokens]
        rows = rows.to(table.scale.dtype) * table.scale[tokens][..., None]
    else:
        rows = table[tokens]
    if inside is None:
        return rows
    return torch.where(inside[..., None], rows, rows.new_zeros(()))


def tied_head(hidden: torch.Tensor, table,
              preferred_element_type: Optional[torch.dtype] = torch.float32
              ) -> torch.Tensor:
    """``einsum('...d,vd->...v')`` against a (possibly row-quantized)
    embedding table used as a tied LM head."""
    if isinstance(table, QuantizedTensor):
        _check_axis(table, -1, 'tied_head')
        _serving_only(hidden, 'tied_head')
        if preferred_element_type not in (None, hidden.dtype):
            out = _UpcastMatmul.apply(hidden, table.q.t(),
                                      preferred_element_type)
        else:
            out = torch.matmul(hidden, table.q.t().to(hidden.dtype))
        return out * table.scale.to(out.dtype)
    return _plain_matmul(hidden, table.t(), preferred_element_type)


# ---- whole trees ----

# Weight leaves quantized for serving, keyed by name. Contraction is -2
# (matmul convention) except the embedding table, whose rows must
# dequantize independently for the token gather (and whose tied-head use
# contracts over d = its LAST axis: the same per-row scale serves both).
_QUANT_AXES = {
    'wq': -2, 'wk': -2, 'wv': -2, 'wo': -2,
    'w_gate': -2, 'w_up': -2, 'w_down': -2,
    'lm_head': -2,
    'embed': -1,
}


def quantizes(name: str, shape) -> bool:
    """Whether quantize_params quantizes a full-precision leaf ``name`` of
    this shape: a weight named in _QUANT_AXES, with two or more axes."""
    return name in _QUANT_AXES and len(shape) >= 2


def _to_quantize(key: str, value: Any) -> bool:
    """quantizes(key, value.shape), and value is not quantized yet."""
    return not is_quantized(value) and quantizes(key, value.shape)


def _walk(params: Params, leaf_fn: Callable[[str, Any], Any]) -> Params:
    """A new tree: ``leaf_fn(name, leaf)`` for every leaf to quantize;
    every other leaf passes through."""
    out = {}
    for key, value in params.items():
        if isinstance(value, dict):
            out[key] = _walk(value, leaf_fn)
        elif _to_quantize(key, value):
            out[key] = leaf_fn(key, value)
        else:
            out[key] = value
    return out


def _int8_leaf(key: str, value: torch.Tensor) -> QuantizedTensor:
    return quantize(value, _QUANT_AXES[key])


def _int4_leaf(key: str, value: torch.Tensor, group: int = 128):
    axis = _QUANT_AXES[key]
    if axis == -2:
        try:
            return quantize4(value, axis, group)
        except ValueError:
            pass   # odd/indivisible contraction
    return quantize(value, axis)


def quantize_params(params: Params) -> Params:
    """Quantize a family's weight matrices for serving.

    Norm vectors (and any leaf not in the known weight set) stay in their
    original dtype; already-quantized leaves pass through, so the
    transform is idempotent.
    """
    return _walk(params, _int8_leaf)


def quantize_params_int4(params: Params, group: int = 128) -> Params:
    """int4 (group-scaled) for the dense matmul weights, int8 for the rest
    of the known weight set (the embedding's per-row gather and any
    contraction that cannot pack evenly). Idempotent like
    quantize_params."""
    return _walk(params, lambda key, value: _int4_leaf(key, value, group))


def leaf_quantizer(weight_dtype) -> Optional[Callable[[str, Any], Any]]:
    """The leaf function of quantize_params (``torch.int8``) or of
    quantize_params_int4 (``'int4'``): (name, full-precision leaf) → its
    quantized form. None for None or a full-precision ``weight_dtype``."""
    if weight_dtype is None:
        return None
    if weight_dtype == torch.int8:
        return _int8_leaf
    if weight_dtype == 'int4':
        return _int4_leaf
    if (isinstance(weight_dtype, torch.dtype)
            and weight_dtype.is_floating_point):
        return None
    raise ValueError(f'weight_dtype {weight_dtype!r}: need a float type, '
                     "torch.int8 or 'int4'")


# One cut of a leaf: (dim, parts, index), this rank keeping block
# ``index`` of ``parts`` equal blocks along ``dim``.
Cuts = Tuple[Tuple[int, int, int], ...]


def _chunk(t: torch.Tensor, dim: int, parts: int, index: int
           ) -> torch.Tensor:
    return t.chunk(parts, dim)[index]


def block(leaf, cuts: Cuts):
    """This rank's block of a plain or quantized leaf (a contiguous copy),
    ``cuts`` counted on its logical dims. A quantized leaf is cut with
    its scales: int8 scales (one per output column) are kept whole along
    the contraction dim, whose cut leaves them as they are, and cut with
    every other dim; an int4 leaf's contraction cut must fall on its
    groups of rows, whose scales go with them. Quantizing the whole leaf
    and then cutting gives the scales the whole leaf has."""
    for dim, parts, index in cuts:
        dim %= leaf.ndim
        if isinstance(leaf, QuantizedTensor):
            cdim = leaf.ndim + leaf.axis
            scale = leaf.scale if dim == cdim else _chunk(
                leaf.scale, dim - (dim > cdim), parts, index)
            leaf = QuantizedTensor(_chunk(leaf.q, dim, parts, index),
                                   scale, leaf.axis)
        elif isinstance(leaf, Quantized4Tensor):
            if (dim == leaf.ndim + leaf.axis
                    and (leaf.shape[dim] // parts) % leaf.group):
                raise ValueError(
                    f'int4 weights of {leaf.shape[dim]} contraction rows '
                    f'in groups of {leaf.group} do not split into {parts} '
                    'blocks of whole groups: the tensor split cuts a '
                    'group. Serve this split with --weight-dtype int8.')
            leaf = Quantized4Tensor(
                _chunk(leaf.q_packed, dim, parts, index),
                _chunk(leaf.scale, dim, parts, index), leaf.axis,
                leaf.group)
        else:
            leaf = _chunk(leaf, dim, parts, index)
    if isinstance(leaf, QuantizedTensor):
        return QuantizedTensor(leaf.q.contiguous(), leaf.scale.contiguous(),
                               leaf.axis)
    if isinstance(leaf, Quantized4Tensor):
        return Quantized4Tensor(leaf.q_packed.contiguous(),
                                leaf.scale.contiguous(), leaf.axis,
                                leaf.group)
    return leaf.contiguous()


def layer_cuts(cuts: Cuts) -> Cuts:
    """The cuts of one layer of a stacked leaf (whose leading layer dim
    is never cut)."""
    if any(dim == 0 for dim, _, _ in cuts):
        raise ValueError('a stacked leaf is never cut along its layers')
    return tuple((dim - 1, parts, index) for dim, parts, index in cuts)


def quantized_stack(name: str, n: int, layer: Callable[[int], torch.Tensor],
                    leaf_fn: Callable[[str, Any], Any],
                    cuts: Cuts = ()):
    """A stacked ``[n, ...]`` weight quantized one layer at a time:
    ``layer(i)`` gives layer i's full-precision slice, ``leaf_fn`` (see
    leaf_quantizer) quantizes it, and its values and scales land in the
    stack's own tensors. The contraction axis is counted from the end, so
    each layer's scales come from that layer alone: the bytes are those
    of ``leaf_fn(name, whole stack)``, while no more than one layer is
    ever held in full precision. With ``cuts`` (the stack's, see
    :func:`block`) each quantized layer is cut to this rank's block
    before it lands, so the stack is only ever held as blocks."""
    out = None
    for i in range(n):
        part = block(leaf_fn(name, layer(i)), layer_cuts(cuts))
        fields = {f.name: getattr(part, f.name)
                  for f in dataclasses.fields(part)
                  if torch.is_tensor(getattr(part, f.name))}
        if out is None:
            out = {key: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                    device=t.device)
                   for key, t in fields.items()}
        for key, t in fields.items():
            out[key][i] = t
    return dataclasses.replace(part, **out)


def stacked_blocks(n: int, layer: Callable[[int], torch.Tensor],
                   cuts: Cuts) -> torch.Tensor:
    """A full-precision ``[n, ...]`` stack of this rank's blocks (see
    :func:`block`; ``cuts`` are the stack's), ``layer(i)`` giving layer
    i whole: one layer is whole at a time."""
    out = None
    for i in range(n):
        part = block(layer(i), layer_cuts(cuts))
        if out is None:
            out = torch.empty((n,) + tuple(part.shape), dtype=part.dtype,
                              device=part.device)
        out[i] = part
    return out


def quantize_params_to(params: Params, weight_dtype, device,
                       cuts=None) -> Params:
    """quantize_params (``torch.int8``) or quantize_params_int4
    (``'int4'``) of ``params`` (a converted tree on the host, say), its
    result on ``device``: each leaf moves there before it is quantized,
    a stacked ``[L, ...]`` weight one layer at a time (quantized_stack),
    so the device never holds more than one layer of a full-precision
    stack. Leaves that stay full precision move as they are. ``cuts``, a
    tree like ``params`` of :data:`Cuts` (or None), keeps this rank's
    block of each leaf: quantized whole, then cut (:func:`block`), a
    stack layer by layer, so no whole stacked leaf reaches ``device``."""
    leaf_fn = leaf_quantizer(weight_dtype)
    out = {}
    for key, value in params.items():
        cut = () if cuts is None or cuts.get(key) is None else cuts[key]
        if isinstance(value, dict):
            out[key] = quantize_params_to(value, weight_dtype, device,
                                          None if cuts is None
                                          else cuts.get(key))
        elif leaf_fn is not None and _to_quantize(key, value):
            if value.ndim >= 3:
                out[key] = quantized_stack(
                    key, value.shape[0],
                    lambda i, value=value: value[i].to(device), leaf_fn,
                    cut)
            else:
                out[key] = block(leaf_fn(key, value.to(device)), cut)
        elif cut and value.ndim >= 3:
            # A full-precision stack: moved and cut one layer at a time.
            out[key] = stacked_blocks(
                value.shape[0], lambda i, value=value: value[i].to(device),
                cut)
        else:
            out[key] = block(value.to(device), cut)
    return out


def _random_bytes(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform random int8 values straight from bytes (no wider
    transient)."""
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                         generator=generator,
                         device=generator.device).view(torch.int8)


def _synthetic_int8(shape, axis: int,
                    generator: torch.Generator) -> QuantizedTensor:
    fan_in = shape[axis]
    scale_shape = list(shape)
    del scale_shape[axis % len(shape)]
    scale = torch.full(scale_shape, (fan_in ** -0.5) / 127.0,
                       dtype=torch.float32, device=generator.device)
    return QuantizedTensor(_random_bytes(shape, generator), scale, axis)


def _synthetic(shapes: Params, generator: torch.Generator,
               leaf_fn: Callable) -> Params:
    out = {}
    for name, value in sorted(shapes.items()):
        if isinstance(value, dict):
            out[name] = _synthetic(value, generator, leaf_fn)
        elif quantizes(name, value.shape):
            out[name] = leaf_fn(name, tuple(value.shape))
        else:
            out[name] = torch.ones(tuple(value.shape), dtype=value.dtype,
                                   device=generator.device)
    return out


def synthetic_quantized_params(shapes: Params,
                               generator: torch.Generator) -> Params:
    """Random params born directly in quantized form.

    For throughput runs of models whose full-precision init is not
    wanted: weights are sampled straight as int8 bytes with fan-in scales,
    never materializing a full-precision weight. ``shapes`` is a tree of
    anything with ``.shape`` and ``.dtype`` (the family's ``init`` on
    ``device='meta'``); the tensors land on ``generator.device``. Leaves
    that are not weights are ones, as in the reference.
    """
    return _synthetic(shapes, generator,
                      lambda name, shape: _synthetic_int8(
                          shape, _QUANT_AXES[name], generator))


def synthetic_quantized4_params(shapes: Params, generator: torch.Generator,
                                group: int = 128) -> Params:
    """synthetic_quantized_params at int4: packed nibbles are sampled
    directly as bytes; weights whose contraction cannot pack stay int8."""

    def leaf(name, shape):
        axis = _QUANT_AXES[name]
        fan_in = shape[-2]
        if (axis == -2 and fan_in % 2 == 0
                and fan_in % min(group, fan_in) == 0):
            g = min(group, fan_in)
            packed = _random_bytes(shape[:-2] + (fan_in // 2, shape[-1]),
                                   generator)
            scale = torch.full(shape[:-2] + (fan_in // g, shape[-1]),
                               (fan_in ** -0.5) / 7.0, dtype=torch.float32,
                               device=generator.device)
            return Quantized4Tensor(packed, scale, -2, g)
        return _synthetic_int8(shape, axis, generator)

    return _synthetic(shapes, generator, leaf)


def params_nbytes(params: Params) -> int:
    """Bytes of every leaf (a quantized leaf's values and scales)."""
    total = 0
    for value in params.values():
        if isinstance(value, dict):
            total += params_nbytes(value)
        elif is_quantized(value):
            total += value.nbytes
        else:
            total += _nbytes(value)
    return total
