"""Token sampling: greedy / temperature / top-k / top-p, per row.

Counterpart of ``skypilot_tpu/infer/sampling.py``. The draw takes a
``torch.Generator`` in place of a ``jax.random`` key; it is Gumbel-max
over the filtered logits, the same distribution as
``jax.random.categorical`` (the bits differ, so tests compare
distributions, not draws).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 → greedy
    top_k: int = 0               # 0 → disabled
    top_p: float = 1.0           # 1 → disabled


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: Optional[torch.Tensor] = None,
                  top_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Temperature-scaled logits [B, V] with the top-k / top-p filters
    applied (-inf outside). Top-k keeps ties at the k-th value; top-p
    keeps the smallest prefix of the sorted distribution whose mass
    reaches top_p (the first token always), taken after top-k."""
    safe_t = temperature.clamp(min=1e-6)[:, None]
    scaled = logits / safe_t
    v = logits.shape[-1]
    if top_k is not None:
        top_k = top_k.to(torch.int64)
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        k_idx = (top_k - 1).clamp(0, v - 1)[:, None]
        kth = torch.gather(sorted_desc, -1, k_idx)
        mask = (top_k[:, None] > 0) & (scaled < kth)
        scaled = scaled.masked_fill(mask, -torch.inf)
    if top_p is not None:
        top_p = top_p.float()
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p[:, None]).sum(dim=-1).clamp(max=v - 1)
        cutoff_logit = torch.gather(sorted_desc, -1, cutoff_idx[:, None])
        active = top_p[:, None] < 1.0
        scaled = scaled.masked_fill(active & (scaled < cutoff_logit),
                                    -torch.inf)
    return scaled


def sample_batched(logits: torch.Tensor,
                   generator: Optional[torch.Generator],
                   temperature: torch.Tensor,
                   top_k: Optional[torch.Tensor] = None,
                   top_p: Optional[torch.Tensor] = None,
                   rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Per-row sampling → int32 tokens [B]. logits [B, V];
    temperature/top_k/top_p [B].

    Rows with temperature <= 0 are greedy; top_k == 0 / top_p >= 1
    disable the respective filter for that row. ``generator`` None means
    the caller knows every row is greedy: no noise is drawn.

    ``rows`` = (total, first): ``logits`` are rows [first, first + B) of
    a batch of ``total`` rows (a rank's slots): the noise is drawn for
    the whole batch, as one process draws it, and these rows kept, so
    each row's draw does not depend on how the batch is split.
    """
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        return greedy
    scaled = filter_logits(logits, temperature, top_k, top_p)
    shape = scaled.shape if rows is None else (rows[0],) + scaled.shape[1:]
    u = torch.rand(shape, generator=generator, device=scaled.device)
    if rows is not None:
        u = u[rows[1]:rows[1] + scaled.shape[0]]
    u = u.clamp_(min=1e-20)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)),
                           dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy)
