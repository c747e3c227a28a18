"""The optax pieces the trainer uses, in PyTorch.

Counterparts of what ``skypilot_tpu/train/trainer.py:make_optimizer``
builds from optax 0.2.6: ``warmup_cosine_decay_schedule``,
``clip_by_global_norm``, ``adamw`` (``scale_by_adam`` with a bf16 first
moment, ``add_decayed_weights``, ``scale_by_learning_rate``) and
``adafactor`` with optax's defaults (``scale_by_factored_rms``,
``clip_by_block_rms``, the learning rate, ``scale_by_param_block_rms``,
the sign flip). Each follows optax's arithmetic and state dtypes.

A transformation works on a flat list of tensors (one per parameter, in
a fixed order) and keeps its step counts as Python ints, so reading a
count never waits for the card. Unlike optax, whose functions are pure
and whose caller donates the old buffers, the port updates parameters in
place (``apply_updates``): one copy of the parameters lives at a time.
Differences that remain: the global norm is summed in fp32 whatever the
gradients' type (optax sums in the leaf type), and scalar factors such as
the bias corrections are computed on the host.

Sharded leaves: a transformation built with ``splits`` (one
``parallel.mesh.Split`` or None per leaf) takes each leaf as this rank's
block of the full leaf, which may be split along several dims (fsdp's
and tensor's). The elementwise pieces (Adam, decay, the
schedule) are exact on blocks as they are; the reductions that span a
leaf (the global norm, adafactor's factored row and column statistics,
the block RMS clip and the parameter-scale RMS) sum their block's part
and add the other blocks' over the group of the dims they reduce (a
factored statistic over a tensor dim over the tensor group, one over an
fsdp dim over the fsdp group), so the update equals
the one-rank update on the full leaf. ``state_splits`` gives the split of
every state tensor, for gathering the state whole.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensors = List[torch.Tensor]
Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warm-up from init_value to peak_value over warmup_steps,
    then cosine decay to end_value at decay_steps (optax's join of a
    linear and a cosine schedule at warmup_steps), in fp32 as optax
    computes it."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError('The cosine_decay_schedule requires positive '
                         f'decay_steps, got decay_steps={cosine_steps}.')

    def linear(count: int) -> float:
        if warmup_steps <= 0:
            return init_value
        count = min(max(count, 0), warmup_steps)
        frac = f32(1) - f32(count) / f32(warmup_steps)
        return float(f32(init_value - peak_value) * frac + f32(peak_value))

    def cosine(count: int) -> float:
        count = f32(min(count, cosine_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * count /
                                            f32(cosine_steps)))
        return float(f32(peak_value) * (f32(1 - alpha) * decay ** f32(
            exponent) + f32(alpha)))

    def schedule(count: int) -> float:
        return linear(count) if count < warmup_steps else cosine(
            count - warmup_steps)

    return schedule


Splits = Optional[Sequence[Any]]


def _full_shape(t: torch.Tensor, split) -> Tuple[int, ...]:
    return tuple(split.shape) if split is not None else tuple(t.shape)


def _mean(t: torch.Tensor, dim: int, split) -> torch.Tensor:
    """``t.mean(dim)`` of the full leaf: where ``dim`` is split, the
    blocks' sums added over that dim's group, over the full size (the
    other dims stay this rank's blocks)."""
    if split is None or split.cut(dim) is None:
        return t.mean(dim=dim)
    return split.reduce_dim(t.sum(dim=dim), dim) / split.shape[dim]


def _rms(t: torch.Tensor, split) -> torch.Tensor:
    """sqrt(mean(t²)) over the full leaf."""
    if split is None:
        return torch.sqrt(torch.mean(t * t))
    return torch.sqrt(split.reduce(torch.sum(t * t)) /
                      math.prod(split.shape))


def _per_leaf(splits: Splits, n: int) -> List[Any]:
    return list(splits) if splits is not None else [None] * n


class Transform:
    """One gradient transformation: ``init(params) -> state`` and
    ``update(updates, state, params) -> (updates, state)``."""

    def init(self, params: Tensors) -> Any:
        del params
        return None

    def state_splits(self, splits: Sequence[Any]) -> Any:
        """``init``'s state tree with each tensor's split (None: whole
        on every rank) in its place."""
        del splits
        return None

    def update(self, updates: Tensors, state: Any, params: Tensors
               ) -> Tuple[Tensors, Any]:
        raise NotImplementedError


class Chain(Transform):
    def __init__(self, *transforms: Transform) -> None:
        self.transforms = transforms

    def init(self, params: Tensors) -> List[Any]:
        return [t.init(params) for t in self.transforms]

    def state_splits(self, splits):
        return [t.state_splits(splits) for t in self.transforms]

    def update(self, updates, state, params):
        new_state = []
        for t, s in zip(self.transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state


def global_norm(tensors: Sequence[torch.Tensor],
                splits: Splits = None) -> torch.Tensor:
    """sqrt(Σ x²) over every tensor, summed in fp32 (a 0-dim tensor).
    With ``splits`` a split tensor is a block: the blocks' sums are
    added over the group of the ranks that hold the leaf's blocks (every
    split dim's ranks together; one sum per group), whole tensors count
    once (a leaf whole on the tensor ranks is one leaf, not one per
    rank)."""
    if splits is None:
        return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                              for t in tensors))
    whole, by_group = 0.0, {}
    for t, split in zip(tensors, splits):
        sq = torch.sum(torch.square(t.float()))
        if split is None:
            whole = whole + sq
        else:
            key = id(split.group)
            part, first = by_group.get(key, (0.0, split))
            by_group[key] = (part + sq, first)
    total = whole
    for part, split in by_group.values():
        total = total + split.reduce(part)
    return torch.sqrt(total)


def _scalar(value: float, dtype: torch.dtype) -> float:
    """value as the tensor type holds it (optax casts scalar factors
    to the leaf's dtype before multiplying)."""
    return float(torch.tensor(value, dtype=dtype))


class ClipByGlobalNorm(Transform):
    """Scale every update by max_norm / norm when norm >= max_norm."""

    def __init__(self, max_norm: float, splits: Splits = None) -> None:
        self.max_norm = max_norm
        self.splits = splits

    def update(self, updates, state, params):
        del params
        norm = global_norm(updates, self.splits)
        keep = norm < self.max_norm
        return [torch.where(keep, u, u / norm.to(u.dtype) * self.max_norm)
                for u in updates], state


class ScaleByAdam(Transform):
    """Adam's moment estimates with bias correction; mu is stored in
    mu_dtype (when given), nu in the parameter's type."""

    def __init__(self, b1: float, b2: float, eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None) -> None:
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = mu_dtype

    def init(self, params):
        return {'count': 0,
                'mu': [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for p in params],
                'nu': [torch.zeros_like(p) for p in params]}

    def state_splits(self, splits):
        return {'count': None, 'mu': list(splits), 'nu': list(splits)}

    def update(self, updates, state, params):
        del params
        b1, b2 = self.b1, self.b2
        count = state['count'] + 1
        # optax: 1 - decay**count in fp32, cast to the moment's type.
        c1 = np.float32(1) - np.float32(b1) ** np.float32(count)
        c2 = np.float32(1) - np.float32(b2) ** np.float32(count)
        out, mus, nus = [], [], []
        for g, mu, nu in zip(updates, state['mu'], state['nu']):
            # As XLA computes (1 - b) * g + b * m: each scalar rounded to
            # its operand's type, the products and the sum in fp32.
            mu = (_scalar(1 - b1, g.dtype) * g.float() +
                  _scalar(b1, mu.dtype) * mu.float()).to(
                      torch.promote_types(g.dtype, mu.dtype))
            nu = (_scalar(1 - b2, g.dtype) * (g.float() * g.float()) +
                  _scalar(b2, nu.dtype) * nu.float()).to(
                      torch.promote_types(g.dtype, nu.dtype))
            mu_hat = mu / _scalar(float(c1), mu.dtype)
            nu_hat = nu / _scalar(float(c2), nu.dtype)
            out.append(mu_hat / (torch.sqrt(nu_hat) + self.eps))
            mus.append(mu.to(self.mu_dtype) if self.mu_dtype else mu)
            nus.append(nu)
        return out, {'count': count, 'mu': mus, 'nu': nus}


class AddDecayedWeights(Transform):
    def __init__(self, weight_decay: float) -> None:
        self.weight_decay = weight_decay

    def update(self, updates, state, params):
        return [u + self.weight_decay * p
                for u, p in zip(updates, params)], state


class ScaleBySchedule(Transform):
    """Multiply by schedule(count), count read before it increments."""

    def __init__(self, schedule: Schedule) -> None:
        self.schedule = schedule

    def init(self, params):
        del params
        return {'count': 0}

    def state_splits(self, splits):
        return {'count': None}

    def update(self, updates, state, params):
        del params
        step = self.schedule(state['count'])
        return ([_scalar(step, u.dtype) * u for u in updates],
                {'count': state['count'] + 1})


class Scale(Transform):
    def __init__(self, factor: float) -> None:
        self.factor = factor

    def update(self, updates, state, params):
        del params
        return [self.factor * u for u in updates], state


def _factored_dims(shape: Sequence[int], min_dim_size_to_factor: int
                   ) -> Optional[Tuple[int, int]]:
    """The two largest dims to factor over, or None (optax's rule)."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class ScaleByFactoredRms(Transform):
    """Adafactor's scaling: a factored (row x column) estimate of the
    squared gradient for leaves with two dims >= min_dim_size_to_factor,
    a full one otherwise; decay 1 - (step + 1)^-decay_rate. State in the
    parameter's type."""

    def __init__(self, decay_rate: float = 0.8,
                 min_dim_size_to_factor: int = 128,
                 epsilon: float = 1e-30, splits: Splits = None) -> None:
        self.decay_rate = decay_rate
        self.min_dim = min_dim_size_to_factor
        self.epsilon = epsilon
        self.splits = splits

    def state_splits(self, splits):
        rows, cols, full = [], [], []
        for split in splits:
            dims = (None if split is None else
                    _factored_dims(split.shape, self.min_dim))
            if dims is None:
                rows.append(None)
                cols.append(None)
                full.append(split)
                continue
            d1, d0 = dims
            rows.append(split.drop(d0))
            cols.append(split.drop(d1))
            full.append(None)
        return {'count': None, 'v_row': rows, 'v_col': cols, 'v': full}

    def init(self, params):
        rows, cols, full = [], [], []
        for p, split in zip(params, _per_leaf(self.splits, len(params))):
            dims = _factored_dims(_full_shape(p, split), self.min_dim)
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                rows.append(one)
                cols.append(one)
                full.append(torch.zeros_like(p))
                continue
            d1, d0 = dims
            row_shape = [n for i, n in enumerate(p.shape) if i != d0]
            col_shape = [n for i, n in enumerate(p.shape) if i != d1]
            rows.append(torch.zeros(row_shape, dtype=p.dtype,
                                    device=p.device))
            cols.append(torch.zeros(col_shape, dtype=p.dtype,
                                    device=p.device))
            full.append(one)
        return {'count': 0, 'v_row': rows, 'v_col': cols, 'v': full}

    def update(self, updates, state, params):
        t = np.float32(state['count'] + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-self.decay_rate))
        out, rows, cols, full = [], [], [], []
        for g, v_row, v_col, v, p, split in zip(
                updates, state['v_row'], state['v_col'], state['v'],
                params, _per_leaf(self.splits, len(params))):
            dtype = p.dtype
            grad_sqr = g * g + self.epsilon
            dims = _factored_dims(_full_shape(p, split), self.min_dim)
            if dims is None:
                v = (decay * v.float() +
                     (1.0 - decay) * grad_sqr.float()).to(dtype)
                out.append(g * v ** -0.5)
                rows.append(v_row)
                cols.append(v_col)
                full.append(v)
                continue
            d1, d0 = dims
            sq = grad_sqr.float()
            v_row = (decay * v_row.float() + (1.0 - decay) * _mean(
                sq, d0, split).to(dtype).float()).to(dtype)
            v_col = (decay * v_col.float() + (1.0 - decay) * _mean(
                sq, d1, split).to(dtype).float()).to(dtype)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = _mean(
                v_row.float(), reduced_d1,
                split.drop(d0) if split is not None else None
            ).unsqueeze(reduced_d1).to(dtype)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            out.append(g * row_factor.unsqueeze(d0) *
                       col_factor.unsqueeze(d1))
            rows.append(v_row)
            cols.append(v_col)
            full.append(v)
        return out, {'count': state['count'] + 1, 'v_row': rows,
                     'v_col': cols, 'v': full}


class ClipByBlockRms(Transform):
    """Divide each update by max(1, rms(update) / threshold)."""

    def __init__(self, threshold: float, splits: Splits = None) -> None:
        self.threshold = threshold
        self.splits = splits

    def update(self, updates, state, params):
        del params
        return [u / torch.clamp(_rms(u, split) / self.threshold, min=1.0)
                for u, split in zip(updates, _per_leaf(self.splits,
                                                       len(updates)))
                ], state


class ScaleByParamBlockRms(Transform):
    """Multiply each update by max(rms(param), min_scale)."""

    def __init__(self, min_scale: float = 1e-3,
                 splits: Splits = None) -> None:
        self.min_scale = min_scale
        self.splits = splits

    def update(self, updates, state, params):
        out = []
        for u, p, split in zip(updates, params,
                               _per_leaf(self.splits, len(params))):
            rms = _rms(p, split)
            out.append(u * torch.where(rms <= self.min_scale,
                                       self.min_scale, rms).to(u.dtype))
        return out, state


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, mu_dtype: Optional[torch.dtype] = None,
          weight_decay: float = 1e-4) -> Transform:
    """optax.adamw: decay applies to every leaf (no mask)."""
    return Chain(ScaleByAdam(b1, b2, eps, mu_dtype),
                 AddDecayedWeights(weight_decay),
                 ScaleBySchedule(lambda count: -learning_rate(count)))


def adafactor(learning_rate: Schedule, splits: Splits = None
              ) -> Transform:
    """optax.adafactor with its defaults (factored, decay_rate 0.8,
    min_dim_size_to_factor 128, clipping_threshold 1.0, parameter-scale
    multiplication, eps 1e-30, no momentum, no weight decay)."""
    return Chain(ScaleByFactoredRms(splits=splits),
                 ClipByBlockRms(1.0, splits),
                 ScaleBySchedule(learning_rate),
                 ScaleByParamBlockRms(splits=splits), Scale(-1.0))


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """params += updates, in place: the sum in the promoted type, stored
    in each parameter's type (optax.apply_updates)."""
    for p, u in zip(params, updates):
        p.copy_(p + u)
