"""LoRA adapters for parameter-efficient fine-tuning.

Counterpart of ``skypilot_tpu/train/lora.py``:

  * the base checkpoint is FROZEN (held outside the optimizer, with no
    gradient), only the A/B factors train — optimizer state shrinks
    from O(params) to O(adapters);
  * merging happens inside the step's loss as one batched product per
    target (W_eff = W + (alpha/r)·A·B over the stacked [L, in, out]
    layout), so the model code and the base layout are untouched;
  * targets are matched by weight NAME anywhere in the param tree
    (wq/wk/wv/wo by default, MLP matrices opt-in); unmatched names raise
    rather than silently training a crippled adapter subset.

The JAX PRNG's draws cannot be reproduced: ``init_lora`` draws A from a
``torch.Generator`` (the trainer seeds a CPU generator with
``config.seed + 1``, as the reference seeds its key, so the adapters are
the same on every device), leaf after leaf in the tree's order.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Params = Dict[str, Any]

DEFAULT_TARGETS: Tuple[str, ...] = ('wq', 'wk', 'wv', 'wo')


def _is_matrix(leaf: Any) -> bool:
    return torch.is_tensor(leaf) and leaf.ndim >= 2


def _all_matrices(tree: Any, path: Tuple[str, ...] = ()) -> list:
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.extend(_all_matrices(v, path + (k,)))
    elif _is_matrix(tree):
        out.append((path, tree))
    return out


def init_lora(base: Params, rank: int, generator: torch.Generator,
              targets: Tuple[str, ...] = DEFAULT_TARGETS) -> Params:
    """Build the adapter tree mirroring ``base``'s structure.

    Every dict entry whose KEY is in ``targets`` and whose value is a
    (stacked) matrix gets {'a': [..., in, r] (gaussian, scaled by
    in^-1/2, drawn on the generator's device), 'b': [..., r, out]
    (zeros)} in the weight's type, on the weight's device — b = 0 makes
    the merged model exactly equal the base at step 0.
    """
    leaves: list = []

    def collect(tree: Any, path: Tuple[str, ...]):
        if isinstance(tree, dict):
            for k, v in tree.items():
                collect(v, path + (k,))
        elif path and path[-1] in targets and _is_matrix(tree):
            leaves.append((path, tree))

    collect(base, ())
    matched = {path[-1] for path, _ in leaves}
    missing = [t for t in targets if t not in matched]
    if missing:
        names = sorted({p[-1] for p, _ in _all_matrices(base)})
        raise ValueError(
            f'LoRA target(s) {missing} not found in the model params; '
            f'available matrix names: {names}.')
    out: Params = {}
    for path, w in leaves:
        *lead, d_in, d_out = w.shape
        a = torch.randn((*lead, d_in, rank), dtype=torch.float32,
                        device=generator.device, generator=generator)
        a = (a * (d_in ** -0.5)).to(w.device, w.dtype)
        b = torch.zeros((*lead, rank, d_out), dtype=w.dtype,
                        device=w.device)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = {'a': a, 'b': b}
    return out


def _block(a: torch.Tensor, b: torch.Tensor, split
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The factors whose product is this rank's block of A·B, for a base
    weight split as ``split`` (a ``parallel.mesh.Split``): A's rows for
    the input dim, B's columns for the output dim, both for a leading
    dim."""
    if split is None:
        return a, b
    for cut in split.cuts:
        n, i, d = cut.parts, cut.index, cut.dim
        if d != a.ndim - 1:
            a = a.chunk(n, d)[i]
        if d != a.ndim - 2:
            b = b.chunk(n, d)[i]
    return a, b


def merge(base: Params, lora: Params, alpha: float, rank: int,
          splits: Any = None) -> Params:
    """W_eff = W + (alpha/rank)·A·B for every adapted weight: the product
    in fp32, cast to the weight's type before the add (the reference's
    order). Differentiable in the adapters; the base is taken as it is
    (the trainer's base carries no gradient). With ``splits`` (a tree
    like ``base`` of ``parallel.mesh.Split`` or None) the base holds this
    rank's blocks, and each gets the block of A·B that is its own."""
    scale = alpha / rank

    def walk(b_tree: Any, l_tree: Any, s_tree: Any) -> Any:
        if not isinstance(b_tree, dict):
            return b_tree
        out = {}
        for k, v in b_tree.items():
            l_sub = l_tree.get(k) if isinstance(l_tree, dict) else None
            s_sub = s_tree.get(k) if isinstance(s_tree, dict) else None
            if (isinstance(l_sub, dict) and set(l_sub) == {'a', 'b'}
                    and _is_matrix(v)):
                a, b = _block(l_sub['a'], l_sub['b'], s_sub)
                delta = torch.matmul(a.float(), b.float()) * scale
                out[k] = v + delta.to(v.dtype)
            elif isinstance(v, dict):
                out[k] = walk(v, l_sub if isinstance(l_sub, dict) else {},
                              s_sub)
            else:
                out[k] = v
        return out

    return walk(base, lora, splits)


@torch.no_grad()
def merged_params(base: Params, lora: Params, alpha: float,
                  rank: int) -> Params:
    """Merge for EXPORT (serving / checkpoint-as-full-model): same math
    as merge(), with no autograd graph."""
    return merge(base, lora, alpha, rank)


def count_params(lora: Params) -> int:
    if isinstance(lora, dict):
        return sum(count_params(v) for v in lora.values())
    return lora.numel()
