"""Mixtral-family sparse-MoE decoder in PyTorch, and the routed expert MLP
(GShard-style capacity routing) that the DeepSeek family shares.

Counterpart of ``skypilot_tpu/models/moe.py``: the same ``MoEConfig``
fields and named configs, the same parameter names and stacked layout
(expert weights ``[L, E, in, out]``, the router ``[L, D, E]`` in fp32),
so a JAX ``init`` tree converts one to one. A Mixtral block is Llama's
attention (GQA, RoPE, RMSNorm; the Llama module's helpers) with the MLP
replaced by the routed expert block. For serving: ``forward`` (logits),
``prefill_hidden`` (pad positions masked out of routing),
``decode_forward`` and ``verify_forward`` (capacity = batch x tokens, so
no decode or verify token is ever dropped; inactive slots are routed
too, as in the reference) over the dense slot cache, whose single-token
step goes to the decode kernel; the prefill waves go to the flash
kernel. As in the reference, attention takes no window: a
``sliding_window`` that a converted checkpoint carries is ignored. The
reference has no paged hook for this family, nor has the port.

Training: ``forward(return_aux=True)`` and ``loss_fn`` add the router's
Switch-Transformer load-balance term (``route(..., with_aux=True)``), the
term DeepSeek's loss shares; with ``remat`` each layer is a
``torch.utils.checkpoint`` that keeps the products of the layer's 2-D
weights and recomputes the rest (the JAX
``dots_with_no_batch_dims_saveable``). The pipelined loss waits for
ROADMAP.md queue 1 item 8d. Over the mesh's ``expert`` axis
(``mesh_lib.expert_split``) each rank runs its block of the experts on
the (token, choice) pairs routed to them, and the routed output is summed
over the group; the routing, the capacity and the load-balance term stay
the global batch's, whole on every rank, as the reference's SPMD step
computes them.

The reference expresses dispatch and combine as one-hot [T, E, C] einsums.
At DeepSeek-V2-Lite's prefill wave (32 rows of 1024 tokens, C = 3840) each
of those tensors would be 32 GB, so the port computes the same function
with index operations: the same k-major cumulative count gives each
(token, choice) its place in its expert's buffer, a gather fills the
[E, C, D] buffers (each place holds at most one token: an exact copy), the
expert products run batched over experts, and a gather-and-weight brings
the outputs back. The gathers' gradients are gathers too (``_Dispatch``,
``_Combine``), summed over a token's k places in a fixed order. The
roundings are the reference's: gate values renormalised over the top k
in fp32, combine weights cast to the model type before the combine
product.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from skypilot_tpu_torch import Device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import quantization as qops
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]

_PIPELINE = ('The pipelined loss is not ported yet: ROADMAP.md queue 1 '
             'item 8d, pipeline parallelism.')


@dataclasses.dataclass(frozen=True)
class MoEConfig(llama.LlamaConfig):
    """Llama-style trunk with a routed expert MLP (Mixtral)."""
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2

    def num_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_layer = (self._attn_params() + 3 * d * f * self.n_experts +
                     d * self.n_experts + 2 * d)
        return v * d * 2 + self.n_layers * per_layer + d

    def active_params(self) -> int:
        """Parameters one token touches (what sets a step's FLOPs)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_layer = (self._attn_params() + 3 * d * f * self.experts_per_token
                     + d * self.n_experts + 2 * d)
        return v * d * 2 + self.n_layers * per_layer + d

    def train_flops_per_token(self) -> float:
        attn_flops = 12 * self.n_layers * self.d_model * self.max_seq_len
        return 6 * self.active_params() + attn_flops


# Mixtral-8x7B dimensions (public config).
MIXTRAL_8X7B = MoEConfig(vocab_size=32_000, d_model=4096, n_layers=32,
                         n_heads=32, n_kv_heads=8, d_ff=14_336,
                         max_seq_len=32_768, rope_theta=1e6,
                         n_experts=8, experts_per_token=2)
# DeepSeek-R1-scale config (fine-grained experts; trunk dims approximate,
# as in the reference).
DEEPSEEK_MOE = MoEConfig(vocab_size=129_280, d_model=7168, n_layers=61,
                         n_heads=128, n_kv_heads=128, d_ff=2048,
                         n_experts=256, experts_per_token=8)
MOE_TINY = MoEConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=128, max_seq_len=128, remat=False,
                     n_experts=4, experts_per_token=2)
# fp32 twin of the tiny config: the parity checks against the reference
# and between the card and the CPU run at it.
MOE_TINY_F32 = dataclasses.replace(MOE_TINY, dtype=torch.float32)

CONFIGS = {
    'mixtral-8x7b': MIXTRAL_8X7B,
    'deepseek-moe': DEEPSEEK_MOE,
    'moe-tiny': MOE_TINY,
}


def logical_axes(config: MoEConfig) -> Params:
    """Logical sharding axes, mirroring init()'s tree: Llama's attention,
    the router and the expert stacks in place of the MLP."""
    axes = llama.logical_axes(config)
    layers = axes['layers']
    for name in ('w_gate', 'w_up', 'w_down'):
        del layers[name]
    layers.update({
        'router': ('layers', 'embed', None),
        'w_gate': ('layers', 'expert', 'embed', 'mlp'),
        'w_up': ('layers', 'expert', 'embed', 'mlp'),
        'w_down': ('layers', 'expert', 'mlp', 'embed'),
    })
    return axes


def init(config: MoEConfig, generator: Optional[torch.Generator] = None,
         device: Device = None, weight_dtype=None) -> Params:
    """Initialize parameters as ``llama.init`` does (``llama.Draws``:
    truncated-normal fan-in scaling, drawn from ``generator``, seeded 0
    if omitted, one layer at a time; ``device='meta'`` for shapes alone),
    with the reference's Mixtral leaves: an fp32 router and expert stacks
    ``[L, E, in, out]``. ``weight_dtype`` int8 or ``'int4'`` quantizes
    each layer of a stack as it is drawn, so Mixtral-8x7B (93.4 GB in
    bf16) is built on one card without its bf16 tree."""
    c = config
    draw = llama.Draws(c, generator, device, weight_dtype)
    hd, d, e = c.head_dim, c.d_model, c.n_experts
    return {
        'embed': draw.dense('embed', (c.vocab_size, d), d),
        'layers': {
            'wq': draw.stack('wq', (d, c.n_heads * hd), d),
            'wk': draw.stack('wk', (d, c.n_kv_heads * hd), d),
            'wv': draw.stack('wv', (d, c.n_kv_heads * hd), d),
            'wo': draw.stack('wo', (c.n_heads * hd, d), c.n_heads * hd),
            # Router in fp32: routing decisions are precision-sensitive.
            'router': draw.stack('router', (d, e), d, dtype=torch.float32),
            'w_gate': draw.stack('w_gate', (e, d, c.d_ff), d),
            'w_up': draw.stack('w_up', (e, d, c.d_ff), d),
            'w_down': draw.stack('w_down', (e, c.d_ff, d), c.d_ff),
            'attn_norm': draw.full((c.n_layers, d), 1.0),
            'mlp_norm': draw.full((c.n_layers, d), 1.0),
        },
        'final_norm': draw.full((d,), 1.0),
        'lm_head': draw.dense('lm_head', (d, c.vocab_size), d),
    }


def params_from_numpy(tree: Params, device: Device,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """``llama.params_from_numpy`` for this family: ``dtype`` recasts
    every floating array except the router, which stays fp32."""
    params = llama.params_from_numpy(tree, device, dtype)
    params['layers']['router'] = llama.params_from_numpy(
        tree['layers']['router'], device, torch.float32)
    return params


class Routing(NamedTuple):
    """Where each (token, choice) goes: expert [T, k], place in that
    expert's buffer [T, k], renormalised fp32 gate value [T, k], and
    whether it is kept [T, k] (a real token whose place is inside the
    capacity). ``capacity`` is the buffer length C; ``aux`` the
    load-balance term (a 0-dim fp32 tensor) when asked for, else None."""
    expert: torch.Tensor
    place: torch.Tensor
    gate: torch.Tensor
    keep: torch.Tensor
    capacity: int
    aux: Optional[torch.Tensor] = None


def expert_capacity(config, num_tokens: int) -> int:
    """Per-expert token slots (rounded, min 4 so tiny tests route)."""
    c = config
    cap = int(c.capacity_factor * c.experts_per_token * num_tokens /
              c.n_experts + 0.5)
    return max(4, cap)


def route(config, router_w: torch.Tensor, x: torch.Tensor,
          token_mask: Optional[torch.Tensor] = None,
          capacity: Optional[int] = None,
          with_aux: bool = False) -> Routing:
    """Top-k routing of x [T, D] through the fp32 router [D, E].

    A (token, choice)'s place is the number of earlier assignments to the
    same expert, counted choice-major (every token's first choice before
    any second choice), so first choices win buffer places; places at or
    past the capacity are dropped. token_mask [T] (1 real / 0 pad):
    masked tokens are not routed and take no place.

    ``with_aux``: also the Switch-Transformer load-balance term
    E · Σₑ fₑ·pₑ / k (1 at perfect balance), as the reference computes
    it: fₑ counts the (token, choice) pairs of real tokens sent to expert
    e, kept or dropped, and pₑ is the mean router probability, both over
    the real tokens (max(Σ mask, 1); T without a mask). Only pₑ carries a
    gradient.

    Under a batch split (``mesh_lib.batch_split``: x is this rank's rows
    of a global batch) the routing is the global batch's, as the
    reference's SPMD step computes it: the capacity counts every rank's
    tokens, a place counts the assignments of the ranks before this one
    (every rank's earlier choices first), and the term's statistics are
    global, with this rank's probabilities only in its pₑ sum: the
    ranks' terms sum to the global one.
    """
    c = config
    t = x.shape[0]
    k = c.experts_per_token
    split = mesh_lib.current_batch_split()
    cap = capacity if capacity is not None else expert_capacity(
        c, mesh_lib.batch_total(t))
    probs = torch.softmax(x.float() @ router_w, dim=-1)        # [T, E]
    gate, expert = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    onehot = F.one_hot(expert, c.n_experts).int()               # [T, k, E]
    if token_mask is not None:
        onehot = onehot * (token_mask != 0).int()[:, None, None]
    # [E, k*T] in priority order. The count runs along the last axis: on
    # the card a scan along a first axis of k*T rows and only E columns
    # took two thirds of a 16 x 1024 prefill wave.
    flat = onehot.permute(2, 1, 0).reshape(c.n_experts, -1)
    earlier = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    if split is not None:
        # + earlier choices of the other ranks, + this choice on the
        # ranks before this one.
        mine = flat.reshape(c.n_experts, k, t).sum(dim=-1)     # [E, k]
        before, total = mesh_lib.batch_offsets(mine)
        others = total - mine
        offset = before + torch.cumsum(others, dim=1) - others
        earlier = earlier + offset.repeat_interleave(t, dim=1).to(
            earlier.dtype)
    place = (earlier * flat).sum(dim=0).reshape(k, t).transpose(0, 1)
    keep = (place < cap) & (onehot.sum(dim=-1) > 0)             # [T, k]
    aux = None
    if with_aux:
        if token_mask is None:
            n_real = float(mesh_lib.batch_total(t))
            mean_probs = (probs.mean(dim=0) if split is None
                          else probs.sum(dim=0) / n_real)
        else:
            m = token_mask.float()
            n_real = mesh_lib.batch_total(m.sum()).clamp(min=1.0)
            mean_probs = (probs * m[:, None]).sum(dim=0) / n_real
        frac = mesh_lib.batch_total(flat.sum(dim=1)).float() / n_real
        aux = c.n_experts * (frac * mean_probs).sum() / k
    return Routing(expert, place, gate, keep, cap, aux)


def _expert_mlp(expert_in: torch.Tensor, lp, dtype) -> torch.Tensor:
    """SwiGLU of each expert on its buffer: [E, C, D] → [E, C, D].

    The gate and up products come out in fp32, as the reference asks
    (``preferred_element_type=jnp.float32``); only silu(gate) * up is
    rounded to the model type before the down product."""
    gate = F.silu(qops.expert_matmul(expert_in, lp['w_gate'], torch.float32))
    up = qops.expert_matmul(expert_in, lp['w_up'], torch.float32)
    return qops.expert_matmul((gate * up).to(dtype), lp['w_down'])


class _Dispatch(torch.autograd.Function):
    """The experts' buffers: the row of x [T, D] of the (token, choice)
    that fills each place, ``choice`` [E*C] (T*k: none, a zero row).
    The gradient is the transpose as a gather, not autograd's scatter-add
    of the indexing: each token's row sums the buffer rows at its k places
    ``dest`` [T*k] (E*C: dropped, the zero row) in choice order, in fp32
    as the reference's einsum accumulates, then cast. A scatter-add
    piles every unfilled place onto the zero row, and on an H100 that one
    row serialised: 0.40 of a DeepSeek-V2-Lite LoRA step's device time."""

    @staticmethod
    def forward(ctx, x, choice, dest, k: int):
        ctx.save_for_backward(dest)
        ctx.k = k
        x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        return x_pad[torch.div(choice, k, rounding_mode='floor')]

    @staticmethod
    def backward(ctx, grad):
        (dest,) = ctx.saved_tensors
        g_pad = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        rows = g_pad[dest].reshape(-1, ctx.k, grad.shape[1])
        return rows.float().sum(dim=1).to(grad.dtype), None, None, None


class _Combine(torch.autograd.Function):
    """Each (token, choice)'s expert output: rows of y [E*C, D] at
    ``dest`` [T*k] (E*C: dropped, a zero row). Kept places are distinct,
    so the transpose is a gather too: each place takes the gradient of the
    (token, choice) that filled it, ``choice`` [E*C] (T*k: none, zero)."""

    @staticmethod
    def forward(ctx, y, dest, choice):
        ctx.save_for_backward(choice)
        y_pad = torch.cat([y, y.new_zeros((1, y.shape[1]))])
        return y_pad[dest]

    @staticmethod
    def backward(ctx, grad):
        (choice,) = ctx.saved_tensors
        g_pad = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        return g_pad[choice], None, None


def _moe_mlp(config, h: torch.Tensor, lp,
             token_mask: Optional[torch.Tensor] = None,
             capacity: Optional[int] = None,
             with_aux: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Routed expert MLP: h [B, S, D] → (out [B, S, D] in h's type, the
    load-balance term with ``with_aux``, else None).

    ``lp`` holds the layer's ``router`` [D, E] (fp32) and the stacked
    expert weights ``w_gate``/``w_up`` [E, D, F], ``w_down`` [E, F, D].
    Under ``mesh_lib.expert_split`` the stacks are this rank's experts,
    [E/x, ...], h is the same rows on every rank of the group, and the
    output is summed over the group (``mesh_lib.expert_sum``).
    """
    c = config
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    t, e = x.shape[0], c.n_experts
    flat_mask = token_mask.reshape(b * s) if token_mask is not None else None
    r = route(c, lp['router'], x, token_mask=flat_mask, capacity=capacity,
              with_aux=with_aux)
    cap, k = r.capacity, c.experts_per_token
    # Under an expert split this rank holds experts [first, stop) of the
    # stacks and fills their buffers alone; the routing is every rank's.
    ep = mesh_lib.current_expert_split()
    first, stop = ep.block(e) if ep is not None else (0, e)
    n = stop - first
    keep = r.keep if ep is None else (
        r.keep & (r.expert >= first) & (r.expert < stop))
    # Buffer place of every kept (token, choice); dropped ones (and under
    # a split the other ranks' ones) point at the spare place n * cap,
    # which is thrown away.
    dest = torch.where(keep, (r.expert - first) * cap + r.place,
                       n * cap).reshape(-1).long()
    # Which (token, choice) fills each place (t * k: none). Kept places
    # are distinct, so only the spare place sees repeated writes.
    choice = torch.full((n * cap + 1,), t * k, dtype=torch.long,
                        device=x.device)
    choice[dest] = torch.arange(t * k, device=x.device)
    choice = choice[:n * cap]
    expert_in = _Dispatch.apply(mesh_lib.expert_input(x), choice, dest,
                                k).reshape(n, cap, d)
    expert_out = _expert_mlp(expert_in, lp, c.dtype)
    picked = _Combine.apply(expert_out.reshape(n * cap, d), dest,
                            choice).reshape(t, k, d)            # [T, k, D]
    # The gate values go through expert_input too: d gate_k = <dout,
    # y_k> is made on the rank of expert k alone, and the router's
    # gradient leaves whole on every rank.
    weight = torch.where(keep, mesh_lib.expert_input(r.gate),
                         0.0).to(c.dtype)
    if ep is None:
        out = torch.bmm(weight[:, None, :], picked)[:, 0]
    else:
        # This rank's experts' part in fp32, summed over the group and
        # rounded once.
        out = mesh_lib.expert_sum(torch.bmm(
            weight.float()[:, None, :], picked.float())[:, 0]).to(c.dtype)
    return out.reshape(b, s, d), r.aux


# ---- the Mixtral model ----

def _layer(config: MoEConfig, x: torch.Tensor, lp: Params, rope,
           token_mask: Optional[torch.Tensor] = None, kv_cache=None,
           cache_positions=None, return_kv: bool = False,
           segment_ids: Optional[torch.Tensor] = None,
           with_aux: bool = False):
    """One Mixtral block: Llama attention (no window, as in the reference)
    + the routed expert MLP; ``rope`` = llama._rope_tables(positions, ...).
    With ``kv_cache`` a step writing each slot's K/V at its own
    ``cache_positions`` (llama.slot_cache_attend), routed with capacity
    b * s and no mask; otherwise prefill or forward, routed with the
    capacity of its b * s tokens, ``token_mask`` keeping pads out.
    Returns (x, aux, new_kv_cache); aux is the layer's load-balance term
    with ``with_aux``, else None."""
    c = config
    lp = mesh_lib.gathered(lp)
    hd = c.head_dim
    b, s, _ = x.shape
    h = llama._rms_norm(x, lp['attn_norm'], c.norm_eps)
    q = qops.matmul(h, lp['wq']).reshape(b, s, c.n_heads, hd)
    k = qops.matmul(h, lp['wk']).reshape(b, s, c.n_kv_heads, hd)
    v = qops.matmul(h, lp['wv']).reshape(b, s, c.n_kv_heads, hd)
    q = llama._apply_rope(q, rope)
    k = llama._apply_rope(k, rope)
    if kv_cache is not None:
        attn, new_cache = llama.slot_cache_attend(
            q, k, v, kv_cache, cache_positions=cache_positions)
    else:
        new_cache = (k, v) if return_kv else None
        attn = attention_ops.dot_product_attention(
            q, k, v, causal=True, implementation=c.attention_impl,
            segment_ids=segment_ids)
    attn = attn.reshape(b, s, c.n_heads * hd)
    x = x + qops.matmul(attn, lp['wo'])
    h = llama._rms_norm(x, lp['mlp_norm'], c.norm_eps)
    capacity = b * s if kv_cache is not None else None
    out, aux = _moe_mlp(c, h, lp, token_mask=token_mask, capacity=capacity,
                        with_aux=with_aux)
    return x + out, aux, new_cache


def _layer_output(config, x, lp, rope, token_mask, segment_ids, with_aux):
    return _layer(config, x, lp, rope, token_mask=token_mask,
                  segment_ids=segment_ids, with_aux=with_aux)[:2]


def _trunk(config: MoEConfig, params: Params, tokens: torch.Tensor,
           positions: torch.Tensor, token_mask: Optional[torch.Tensor],
           return_kv: bool, segment_ids: Optional[torch.Tensor] = None,
           with_aux: bool = False):
    """Embed → layers → final RMSNorm. Returns (x [B,S,D], kv or None,
    the mean of the layers' load-balance terms or None); kv is {'k','v':
    [L, B, S, KVH, HD]}, filled layer by layer. With ``remat`` (and a
    gradient to take) each layer is checkpointed, keeping the products of
    its 2-D weights (wq, wk, wv, wo, the router), as the reference's
    ``dots_with_no_batch_dims_saveable`` does whatever ``remat_policy``
    says, and recomputing the rest."""
    c = config
    x = qops.embed_rows(params['embed'], tokens).to(c.dtype)
    kv = None
    if return_kv:
        shape = (c.n_layers,) + tuple(tokens.shape) + (c.n_kv_heads,
                                                       c.head_dim)
        kv = {'k': torch.empty(shape, dtype=c.dtype, device=x.device),
              'v': torch.empty(shape, dtype=c.dtype, device=x.device)}
    rope = llama._rope_tables(positions, c.head_dim, c.rope_theta,
                              c.rope_scaling)
    remat = c.remat and not return_kv and torch.is_grad_enabled()
    auxes = []
    for layer in range(c.n_layers):
        lp = llama._layer_params(params, layer)
        if remat:
            x, aux = ckpt.checkpoint(
                _layer_output, c, x, lp, rope, token_mask, segment_ids,
                with_aux, use_reentrant=False,
                context_fn=llama.save_products(llama.matrices(lp)))
        else:
            x, aux, layer_kv = _layer(c, x, lp, rope, token_mask=token_mask,
                                      return_kv=return_kv,
                                      segment_ids=segment_ids,
                                      with_aux=with_aux)
            if return_kv:
                kv['k'][layer] = layer_kv[0]
                kv['v'][layer] = layer_kv[1]
        auxes.append(aux)
    aux = torch.stack(auxes).mean() if with_aux else None
    return llama._rms_norm(x, params['final_norm'], c.norm_eps), kv, aux


def _cached_trunk(config: MoEConfig, params: Params, tokens: torch.Tensor,
                  positions: torch.Tensor, cache_positions: torch.Tensor,
                  kv: Dict[str, Any]) -> torch.Tensor:
    """tokens [B, S] at positions [B, S] through every layer against the
    slot cache (written in place at ``cache_positions``: [B] for one
    decode step, which goes to the decode kernel, or [B, S]) → the
    final-normed hidden [B, S, D]."""
    c = config
    x = qops.embed_rows(params['embed'], tokens).to(c.dtype)
    rope = llama._rope_tables(positions, c.head_dim, c.rope_theta,
                              c.rope_scaling)
    for layer in range(c.n_layers):
        cache = (llama._cache_layer(kv['k'], layer),
                 llama._cache_layer(kv['v'], layer))
        x, _, _ = _layer(c, x, llama._layer_params(params, layer), rope,
                         kv_cache=cache, cache_positions=cache_positions)
    return llama._rms_norm(x, params['final_norm'], c.norm_eps)


def forward(config: MoEConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            return_aux: bool = False,
            token_mask: Optional[torch.Tensor] = None):
    """Forward pass → fp32 logits [B, S, vocab], and with ``return_aux``
    also the router's load-balance term averaged over the layers.
    token_mask [B, S] keeps pad positions out of expert routing and of
    the load-balance statistics."""
    c = config
    segment_ids = None
    if positions is None:
        segment_ids, positions = llama.positions_and_segments(
            c, tokens, serving=False)
    x, _, aux = _trunk(c, params, tokens, positions, token_mask,
                       return_kv=False, segment_ids=segment_ids,
                       with_aux=return_aux)
    logits = lm_logits(c, params, x)
    return (logits, aux) if return_aux else logits


def loss_fn(config: MoEConfig, params: Params, tokens: torch.Tensor,
            targets: torch.Tensor, loss_mask=None, token_mask=None
            ) -> torch.Tensor:
    """Next-token cross-entropy over the full vocabulary plus
    ``router_aux_coef`` x the load-balance term. loss_mask [B, S] selects
    the targets that count; token_mask [B, S] marks the real input
    positions and reaches routing only (a prompt token counts for no loss
    but still goes through its experts)."""
    logits, aux = forward(config, params, tokens, return_aux=True,
                          token_mask=token_mask)
    ce = llama.masked_mean(llama._token_nll(logits, targets), loss_mask)
    return ce + config.router_aux_coef * aux


def pipelined_loss_fn(config: MoEConfig, params: Params, tokens, targets,
                      mesh=None, n_microbatches: int = 1, loss_mask=None,
                      token_mask=None):
    """loss_fn with the layer stack pipelined over a mesh's stages: not
    ported yet (ROADMAP.md queue 1 item 8d)."""
    del config, params, tokens, targets, mesh, n_microbatches
    del loss_mask, token_mask
    raise NotImplementedError(_PIPELINE)


def lm_logits(config: MoEConfig, params: Params,
              hidden: torch.Tensor) -> torch.Tensor:
    """Untied LM head (Llama's); hidden [..., D] -> fp32 logits [..., V]."""
    return llama.lm_logits(config, params, hidden)


def prefill_hidden(config: MoEConfig, params: Params, tokens: torch.Tensor,
                   true_len) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill trunk → (last_hidden [B, D], per-layer KV): the engine
    contract of llama.prefill_hidden. Positions at or past a row's
    true_len (a scalar or [B]) are masked out of expert routing, so pads
    take no capacity; the capacity itself comes from the padded B x S."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    lens = torch.as_tensor(true_len, device=tokens.device).reshape(-1, 1)
    token_mask = (positions < lens).float()
    x, kv, _ = _trunk(config, params, tokens, positions, token_mask,
                      return_kv=True)
    return llama.last_token_hidden(x, true_len), kv


def decode_forward(config: MoEConfig, params: Params,
                   last_tokens: torch.Tensor, positions: torch.Tensor,
                   kv: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for a batch of slots (llama.decode_forward's
    contract): last_tokens [B], positions [B] (at or past the cache
    length writes nothing), kv updated in place → (fp32 logits [B, V],
    kv). Expert capacity is the slot count, so no token is dropped."""
    x = _cached_trunk(config, params, last_tokens[:, None],
                      positions[:, None], positions, kv)
    return lm_logits(config, params, x)[:, 0], kv


def verify_hidden(config: MoEConfig, params: Params, tokens: torch.Tensor,
                  positions: torch.Tensor, kv: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The trunk of verify_forward → (final-normed hidden [B, S, D], kv),
    for callers that project only some rows (llama.verify_hidden)."""
    return _cached_trunk(config, params, tokens, positions, positions,
                         kv), kv


def verify_forward(config: MoEConfig, params: Params, tokens: torch.Tensor,
                   positions: torch.Tensor, kv: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Multi-token decode into the dense cache (chunked prefill and
    speculative verification): tokens and positions [B, S] → (fp32
    logits [B, S, V], kv). Capacity B x S: no verified token is dropped."""
    x, kv = verify_hidden(config, params, tokens, positions, kv)
    return lm_logits(config, params, x), kv
