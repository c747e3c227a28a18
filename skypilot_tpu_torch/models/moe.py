"""Routed expert MLP (GShard-style capacity routing) in PyTorch.

Counterpart of the routing half of ``skypilot_tpu/models/moe.py``:
``expert_capacity``, ``route`` and ``_moe_mlp``, which the DeepSeek family
uses. The Mixtral family itself (``MoEConfig``, its ``init``, ``forward``
and decode) and the router's load-balance loss (a training term) come in
later slices.

The reference expresses dispatch and combine as one-hot [T, E, C] einsums.
At DeepSeek-V2-Lite's prefill wave (32 rows of 1024 tokens, C = 3840) each
of those tensors would be 32 GB, so the port computes the same function
with index operations: the same k-major cumulative count gives each
(token, choice) its place in its expert's buffer, a gather fills the
[E, C, D] buffers (each place holds at most one token: an exact copy), the
expert products run batched over experts, and a gather-and-weight brings
the outputs back. The roundings are the reference's: gate values
renormalised over the top k in fp32, combine weights cast to the model
type before the combine product.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from skypilot_tpu_torch.ops import quantization as qops


class Routing(NamedTuple):
    """Where each (token, choice) goes: expert [T, k], place in that
    expert's buffer [T, k], renormalised fp32 gate value [T, k], and
    whether it is kept [T, k] (a real token whose place is inside the
    capacity). ``capacity`` is the buffer length C."""
    expert: torch.Tensor
    place: torch.Tensor
    gate: torch.Tensor
    keep: torch.Tensor
    capacity: int


def expert_capacity(config, num_tokens: int) -> int:
    """Per-expert token slots (rounded, min 4 so tiny tests route)."""
    c = config
    cap = int(c.capacity_factor * c.experts_per_token * num_tokens /
              c.n_experts + 0.5)
    return max(4, cap)


def route(config, router_w: torch.Tensor, x: torch.Tensor,
          token_mask: Optional[torch.Tensor] = None,
          capacity: Optional[int] = None) -> Routing:
    """Top-k routing of x [T, D] through the fp32 router [D, E].

    A (token, choice)'s place is the number of earlier assignments to the
    same expert, counted choice-major (every token's first choice before
    any second choice), so first choices win buffer places; places at or
    past the capacity are dropped. token_mask [T] (1 real / 0 pad):
    masked tokens are not routed and take no place.
    """
    c = config
    t = x.shape[0]
    cap = capacity if capacity is not None else expert_capacity(c, t)
    probs = torch.softmax(x.float() @ router_w, dim=-1)        # [T, E]
    gate, expert = torch.topk(probs, c.experts_per_token, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    onehot = F.one_hot(expert, c.n_experts).int()               # [T, k, E]
    if token_mask is not None:
        onehot = onehot * (token_mask != 0).int()[:, None, None]
    # [E, k*T] in priority order. The count runs along the last axis: on
    # the card a scan along a first axis of k*T rows and only E columns
    # took two thirds of a 16 x 1024 prefill wave.
    flat = onehot.permute(2, 1, 0).reshape(c.n_experts, -1)
    earlier = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    place = (earlier * flat).sum(dim=0).reshape(
        c.experts_per_token, t).transpose(0, 1)                 # [T, k]
    keep = (place < cap) & (onehot.sum(dim=-1) > 0)
    return Routing(expert, place, gate, keep, cap)


def _expert_mlp(expert_in: torch.Tensor, lp, dtype) -> torch.Tensor:
    """SwiGLU of each expert on its buffer: [E, C, D] → [E, C, D].

    The gate and up products come out in fp32, as the reference asks
    (``preferred_element_type=jnp.float32``); only silu(gate) * up is
    rounded to the model type before the down product."""
    gate = F.silu(qops.expert_matmul(expert_in, lp['w_gate'], torch.float32))
    up = qops.expert_matmul(expert_in, lp['w_up'], torch.float32)
    return qops.expert_matmul((gate * up).to(dtype), lp['w_down'])


def _moe_mlp(config, h: torch.Tensor, lp,
             token_mask: Optional[torch.Tensor] = None,
             capacity: Optional[int] = None) -> torch.Tensor:
    """Routed expert MLP: h [B, S, D] → [B, S, D] in h's type.

    ``lp`` holds the layer's ``router`` [D, E] (fp32) and the stacked
    expert weights ``w_gate``/``w_up`` [E, D, F], ``w_down`` [E, F, D].
    """
    c = config
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    t, e = x.shape[0], c.n_experts
    flat_mask = token_mask.reshape(b * s) if token_mask is not None else None
    r = route(c, lp['router'], x, token_mask=flat_mask, capacity=capacity)
    cap = r.capacity
    # Buffer place of every kept (token, choice); dropped ones point at the
    # spare place e * cap, which is thrown away.
    dest = torch.where(r.keep, r.expert * cap + r.place,
                       e * cap).reshape(-1).long()
    tokens = torch.arange(t, device=x.device).repeat_interleave(
        c.experts_per_token)
    # Which token fills each place (t: none, the zero row below). Kept
    # places are distinct, so only the spare place sees repeated writes.
    src = torch.full((e * cap + 1,), t, dtype=torch.long, device=x.device)
    src[dest] = tokens
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    expert_in = x_pad[src[:e * cap]].reshape(e, cap, d)
    expert_out = _expert_mlp(expert_in, lp, c.dtype)
    out_pad = torch.cat([expert_out.reshape(e * cap, d),
                         expert_out.new_zeros((1, d))])
    picked = out_pad[dest].reshape(t, c.experts_per_token, d)   # [T, k, D]
    weight = torch.where(r.keep, r.gate, 0.0).to(c.dtype)
    out = torch.bmm(weight[:, None, :], picked)[:, 0]
    return out.reshape(b, s, d)
