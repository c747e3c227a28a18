"""DeepSeek-family decoder in PyTorch: Multi-head Latent Attention +
DeepSeekMoE, for serving.

Counterpart of ``skypilot_tpu/models/deepseek.py``: the same config
fields and named configs, the same parameter names and stacked layout
(``dense_layers`` for the first ``first_k_dense`` layers, ``moe_layers``
for the rest), so a JAX ``init`` tree converts one to one.

  * **MLA.** Queries and keys/values go through low-rank latents with a
    decoupled RoPE branch. Prefill runs the expanded form through the
    plain attention (qk head dim 192 differs from the v head dim 128, so
    the flash kernel does not take it, as in the reference). Decode caches
    only the post-norm latent c_kv (``kv_lora_rank``) and the shared
    post-RoPE key k_rope (``qk_rope_head_dim``) per token and runs the
    absorbed form over them through the MLA decode kernels
    (``ops/mla_decode.py``): dense slots or a paged arena.
  * **DeepSeekMoE.** ``first_k_dense`` dense layers, then layers with
    always-on shared experts plus routed experts (``models/moe.py``); the
    router stays fp32 in a bf16 model. Decode routes with capacity equal
    to the slot count, so no decode token is dropped.

Layers run in a Python loop in place of ``lax.scan``; caches are written
in place. Training: ``loss_fn`` (the chunked cross-entropy plus
``router_aux_coef`` x the routed layers' mean load-balance term), with
``remat`` as ``llama``'s per-layer checkpoint under the config's policy;
attention takes the plain path there too. The pipelined loss waits for
ROADMAP.md queue 1 item 8d.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from skypilot_tpu_torch import Device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import mla_decode as mla_ops
from skypilot_tpu_torch.ops import quantization as qops
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DeepSeekConfig:
    """The reference's fields, one to one."""
    vocab_size: int = 102_400
    d_model: int = 2048
    n_layers: int = 27
    n_heads: int = 16
    # MLA dims (DeepSeek-V2 paper notation).
    q_lora_rank: int = 0          # 0 = full-rank q projection (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # Dense MLP (first_k_dense layers) and MoE shape.
    d_ff: int = 10_944
    first_k_dense: int = 1
    n_experts: int = 64
    n_shared_experts: int = 2
    experts_per_token: int = 6
    moe_d_ff: int = 1408
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    max_seq_len: int = 4096
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = 'dots'
    # qk dim (192) != v dim (128): the plain attention takes prefill and
    # training.
    attention_impl: str = 'xla'
    ce_chunk: int = 2048

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense

    def _attn_params(self) -> int:
        d, h = self.d_model, self.n_heads
        dn, dr, dv = (self.qk_nope_head_dim, self.qk_rope_head_dim,
                      self.v_head_dim)
        if self.q_lora_rank:
            q = (d * self.q_lora_rank + self.q_lora_rank * h * (dn + dr) +
                 self.q_lora_rank)                       # + q_norm
        else:
            q = d * h * (dn + dr)
        kv = (d * self.kv_lora_rank + d * dr +
              self.kv_lora_rank * h * (dn + dv) +
              self.kv_lora_rank)                         # + kv_norm
        return q + kv + h * dv * d

    def num_params(self) -> int:
        c = self
        d, v = c.d_model, c.vocab_size
        dense_layer = self._attn_params() + 3 * d * c.d_ff + 2 * d
        shared = 3 * d * (c.moe_d_ff * c.n_shared_experts)
        routed = 3 * d * c.moe_d_ff * c.n_experts + d * c.n_experts
        moe_layer = self._attn_params() + shared + routed + 2 * d
        return (v * d * 2 + c.first_k_dense * dense_layer +
                c.n_moe_layers * moe_layer + d)

    def active_params(self) -> int:
        """Parameters one token touches (what sets a step's FLOPs)."""
        c = self
        d, v = c.d_model, c.vocab_size
        dense_layer = self._attn_params() + 3 * d * c.d_ff + 2 * d
        shared = 3 * d * (c.moe_d_ff * c.n_shared_experts)
        routed = (3 * d * c.moe_d_ff * c.experts_per_token +
                  d * c.n_experts)
        moe_layer = self._attn_params() + shared + routed + 2 * d
        return (v * d * 2 + c.first_k_dense * dense_layer +
                c.n_moe_layers * moe_layer + d)

    def train_flops_per_token(self) -> float:
        attn_flops = (6 * self.n_layers * self.n_heads *
                      (self.qk_head_dim + self.v_head_dim) *
                      self.max_seq_len)
        return 6 * self.active_params() + attn_flops


# DeepSeek-V2-Lite dimensions (public config: 15.7B total, 2.4B active).
DEEPSEEK_V2_LITE = DeepSeekConfig()
# DeepSeek-V3/R1-class dimensions (671B total, 37B active).
DEEPSEEK_V3 = DeepSeekConfig(
    vocab_size=129_280, d_model=7168, n_layers=61, n_heads=128,
    q_lora_rank=1536, kv_lora_rank=512, d_ff=18_432, first_k_dense=3,
    n_experts=256, n_shared_experts=1, experts_per_token=8,
    moe_d_ff=2048, rope_theta=10_000.0)
DEEPSEEK_TINY = DeepSeekConfig(
    vocab_size=256, d_model=64, n_layers=3, n_heads=4, q_lora_rank=32,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, d_ff=128, first_k_dense=1, n_experts=4,
    n_shared_experts=1, experts_per_token=2, moe_d_ff=32,
    max_seq_len=128, remat=False)
# A variant exercising the no-dense, full-rank-q corner.
DEEPSEEK_TINY_MOE_ONLY = dataclasses.replace(
    DEEPSEEK_TINY, first_k_dense=0, q_lora_rank=0, n_layers=2)

CONFIGS = {
    'deepseek-v2-lite': DEEPSEEK_V2_LITE,
    'deepseek-v3': DEEPSEEK_V3,
    'deepseek-tiny': DEEPSEEK_TINY,
    'deepseek-tiny-moe-only': DEEPSEEK_TINY_MOE_ONLY,
}


def _check_decode_widths(c: DeepSeekConfig) -> None:
    """The MLA decode kernels take at most MAX_HEADS heads (DeepSeek-V2-
    Lite has 16, DeepSeek-V3 128): refuse a wider model when its engine is
    built, not at its first decode step."""
    if c.n_heads > mla_ops.MAX_HEADS or c.kv_lora_rank > mla_ops.MAX_RANK:
        raise NotImplementedError(
            f'MLA decode takes at most {mla_ops.MAX_HEADS} heads and a '
            f'kv_lora_rank of at most {mla_ops.MAX_RANK}; got '
            f'{c.n_heads} heads, kv_lora_rank {c.kv_lora_rank}.')


def kv_cache_shapes(config: DeepSeekConfig, max_slots: int,
                    max_target_len: int
                    ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Engine hook: the 'k' cache holds the compressed latent c_kv, the
    'v' cache the shared post-RoPE key: kv_lora_rank + qk_rope_head_dim
    values per token instead of 2 × n_kv_heads × head_dim."""
    c = config
    _check_decode_widths(c)
    return ((c.n_layers, max_slots, max_target_len, 1, c.kv_lora_rank),
            (c.n_layers, max_slots, max_target_len, 1,
             c.qk_rope_head_dim))


def paged_kv_cache_shapes(config: DeepSeekConfig, num_pages: int,
                          page_size: int
                          ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Engine hook for the paged cache: the compressed layout over a
    shared page arena [L, pages, page, 1, ·]."""
    c = config
    _check_decode_widths(c)
    return ((c.n_layers, num_pages, page_size, 1, c.kv_lora_rank),
            (c.n_layers, num_pages, page_size, 1, c.qk_rope_head_dim))


def _attn_shapes(c: DeepSeekConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                      Optional[int]]]:
    """Attention weights of one layer: name → (shape, fan-in; None for a
    norm scale of ones)."""
    h, d = c.n_heads, c.d_model
    dn, dr, dv = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
    shapes = {
        'w_dkv': ((d, c.kv_lora_rank), d),
        'w_kr': ((d, dr), d),
        'w_ukv': ((c.kv_lora_rank, h * (dn + dv)), c.kv_lora_rank),
        'wo': ((h * dv, d), h * dv),
        'kv_norm': ((c.kv_lora_rank,), None),
        'attn_norm': ((d,), None),
        'mlp_norm': ((d,), None),
    }
    if c.q_lora_rank:
        shapes.update({
            'w_dq': ((d, c.q_lora_rank), d),
            'w_uq': ((c.q_lora_rank, h * (dn + dr)), c.q_lora_rank),
            'q_norm': ((c.q_lora_rank,), None),
        })
    else:
        shapes['wq'] = ((d, h * (dn + dr)), d)
    return shapes


def _attn_axes(c: DeepSeekConfig) -> Params:
    axes: Params = {
        'w_dkv': ('layers', 'embed', None),
        'w_kr': ('layers', 'embed', None),
        'w_ukv': ('layers', None, 'heads'),
        'wo': ('layers', 'heads', 'embed'),
        'kv_norm': ('layers', None),
        'attn_norm': ('layers', 'embed'),
        'mlp_norm': ('layers', 'embed'),
    }
    if c.q_lora_rank:
        axes.update({'w_dq': ('layers', 'embed', None),
                     'w_uq': ('layers', None, 'heads'),
                     'q_norm': ('layers', None)})
    else:
        axes['wq'] = ('layers', 'embed', 'heads')
    return axes


def logical_axes(config: DeepSeekConfig) -> Params:
    """Logical sharding axes, mirroring init()'s tree (the reference's)."""
    dense = _attn_axes(config)
    dense.update({
        'w_gate': ('layers', 'embed', 'mlp'),
        'w_up': ('layers', 'embed', 'mlp'),
        'w_down': ('layers', 'mlp', 'embed'),
    })
    routed = _attn_axes(config)
    routed.update({
        'router': ('layers', 'embed', None),
        'w_gate': ('layers', 'expert', 'embed', 'mlp'),
        'w_up': ('layers', 'expert', 'embed', 'mlp'),
        'w_down': ('layers', 'expert', 'mlp', 'embed'),
        'ws_gate': ('layers', 'embed', 'mlp'),
        'ws_up': ('layers', 'embed', 'mlp'),
        'ws_down': ('layers', 'mlp', 'embed'),
    })
    out: Params = {
        'embed': ('vocab', 'embed'),
        'moe_layers': routed,
        'final_norm': ('embed',),
        'lm_head': ('embed', 'vocab'),
    }
    if config.first_k_dense:
        out['dense_layers'] = dense
    return out


def init(config: DeepSeekConfig, generator: Optional[torch.Generator] = None,
         device: Device = None, weight_dtype=None) -> Params:
    """Initialize parameters (truncated-normal fan-in scaling).

    Same names, shapes and distribution as the JAX ``init``; the draws
    come from ``generator`` (seeded 0 if omitted), which must live on
    ``device`` (``llama.Draws``: stacked weights one layer at a time,
    quantized as drawn for an int8 or int4 ``weight_dtype``). The router
    stays fp32. ``device='meta'`` gives the shapes and types alone.
    """
    c = config
    draw = llama.Draws(c, generator, device, weight_dtype)
    d = c.d_model

    def stack(name, n, shape, fan_in):
        if fan_in is None:
            return draw.full((n,) + shape, 1.0)
        return draw.stack(name, shape, fan_in, n=n)

    def attn_group(n):
        return {name: stack(name, n, shape, fan_in)
                for name, (shape, fan_in) in _attn_shapes(c).items()}

    params: Params = {
        'embed': draw.dense('embed', (c.vocab_size, d), d),
        'final_norm': draw.full((d,), 1.0),
        'lm_head': draw.dense('lm_head', (d, c.vocab_size), d),
    }
    if c.first_k_dense:
        n = c.first_k_dense
        group = attn_group(n)
        group.update({
            'w_gate': stack('w_gate', n, (d, c.d_ff), d),
            'w_up': stack('w_up', n, (d, c.d_ff), d),
            'w_down': stack('w_down', n, (c.d_ff, d), c.d_ff),
        })
        params['dense_layers'] = group
    n = c.n_moe_layers
    group = attn_group(n)
    sf = c.moe_d_ff * c.n_shared_experts
    group.update({
        'router': draw.stack('router', (d, c.n_experts), d, n=n,
                             dtype=torch.float32),
        'w_gate': stack('w_gate', n, (c.n_experts, d, c.moe_d_ff), d),
        'w_up': stack('w_up', n, (c.n_experts, d, c.moe_d_ff), d),
        'w_down': stack('w_down', n, (c.n_experts, c.moe_d_ff, d),
                        c.moe_d_ff),
        'ws_gate': stack('ws_gate', n, (d, sf), d),
        'ws_up': stack('ws_up', n, (d, sf), d),
        'ws_down': stack('ws_down', n, (sf, d), sf),
    })
    params['moe_layers'] = group
    return params


def params_from_numpy(tree: Params, device: Device,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """``llama.params_from_numpy`` for this family: the JAX ``init`` tree
    as numpy arrays → the port's tree; ``dtype`` recasts every floating
    array except the router, which stays fp32, and quantized leaves,
    which cross unchanged."""
    params = llama.params_from_numpy(tree, device, dtype)
    params['moe_layers']['router'] = llama.params_from_numpy(
        tree['moe_layers']['router'], device, torch.float32)
    return params


def _groups(c: DeepSeekConfig, params: Params):
    """(group params, is_moe, first layer index) per layer group."""
    if c.first_k_dense:
        yield params['dense_layers'], False, 0
    yield params['moe_layers'], True, c.first_k_dense


def _mla_qkv(c: DeepSeekConfig, h: torch.Tensor, lp: Params, rope):
    """Project hidden → (q_nope [B,S,H,dn], q_rope [B,S,H,dr], c_kv
    [B,S,r], k_rope [B,S,1,dr]); ``rope`` = _rope_tables(positions, dr).

    c_kv is post-RMSNorm and k_rope post-RoPE: exactly what the decode
    cache stores, so prefill and decode share one projection."""
    b, s, _ = h.shape
    dn, dr = c.qk_nope_head_dim, c.qk_rope_head_dim
    if c.q_lora_rank:
        cq = llama._rms_norm(qops.matmul(h, lp['w_dq']), lp['q_norm'],
                             c.norm_eps)
        q = qops.matmul(cq, lp['w_uq'])
    else:
        q = qops.matmul(h, lp['wq'])
    q = q.reshape(b, s, c.n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], llama._apply_rope(q[..., dn:], rope)
    c_kv = llama._rms_norm(qops.matmul(h, lp['w_dkv']), lp['kv_norm'],
                           c.norm_eps)
    k_rope = llama._apply_rope(
        qops.matmul(h, lp['w_kr']).reshape(b, s, 1, dr), rope)
    return q_nope, q_rope, c_kv, k_rope


def _mla_attention(c: DeepSeekConfig, x: torch.Tensor, lp: Params, rope,
                   kv_cache=None, cache_positions=None,
                   return_kv: bool = False,
                   block_tables: Optional[torch.Tensor] = None,
                   paged_route=None):
    """MLA block attention → (attn_out [B,S,D], new_kv).

    Without kv_cache: the expanded form (prefill). With kv_cache
    ([B,K,1,r], [B,K,1,dr] slot caches, written in place): the absorbed
    decode step, one token per slot. With block_tables [B, nblk] the
    caches are page arenas ([P+1,page,1,r], [P+1,page,1,dr]: P pages and
    the spare page P that takes writes routed past the table or to a
    sentinel, see llama.paged_write_route) and attention reads pages
    [0, P) through the paged kernel.
    """
    b, s, _ = x.shape
    h = c.n_heads
    dn, dr, dv = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
    hid = llama._rms_norm(x, lp['attn_norm'], c.norm_eps)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(c, hid, lp, rope)

    if kv_cache is not None:
        ck, cv = kv_cache
        if block_tables is not None:
            num_pages = ck.shape[0] - 1
            if paged_route is None:
                paged_route = llama.paged_write_route(
                    cache_positions, block_tables, num_pages, ck.shape[1])
            page_idx, off, lengths = paged_route
            ck[page_idx, off] = c_kv.to(ck.dtype)
            cv[page_idx, off] = k_rope[:, 0].to(cv.dtype)
        else:
            pos = cache_positions[:, None]
            llama._write_rows(ck, c_kv[:, :, None], pos)
            llama._write_rows(cv, k_rope, pos)
            lengths = (cache_positions + 1).to(torch.int32)
        w_ukv = lp['w_ukv'].reshape(c.kv_lora_rank, h, dn + dv)
        w_uk, w_uv = w_ukv[..., :dn], w_ukv[..., dn:]
        q_eff = torch.einsum('bhd,rhd->bhr', q_nope[:, 0].float(),
                             w_uk.float()).contiguous()
        q_rot = q_rope[:, 0].float().contiguous()
        scale = (dn + dr) ** -0.5
        if block_tables is not None:
            o_c = mla_ops.paged_mla_decode_attention(
                q_eff, q_rot, ck[:num_pages, :, 0], cv[:num_pages, :, 0],
                lengths, block_tables, scale)
        else:
            o_c = mla_ops.mla_decode_attention(
                q_eff, q_rot, ck[:, :, 0], cv[:, :, 0], lengths, scale)
        attn = torch.einsum('bhr,rhd->bhd', o_c, w_uv.float())
        attn = attn.to(c.dtype).reshape(b, 1, h * dv)
        new_kv = kv_cache
    else:
        kv = qops.matmul(c_kv, lp['w_ukv']).reshape(b, s, h, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        attn = attention_ops.dot_product_attention(
            q, k, v, causal=True, implementation=c.attention_impl)
        attn = attn.reshape(b, s, h * dv)
        new_kv = (c_kv[:, :, None, :], k_rope) if return_kv else None
    return qops.matmul(attn, lp['wo']), new_kv


def _dense_mlp(c: DeepSeekConfig, h: torch.Tensor, lp: Params,
               gate_key='w_gate', up_key='w_up', down_key='w_down'):
    return llama._swiglu(c, h, lp[gate_key], lp[up_key], lp[down_key])


def _layer(c: DeepSeekConfig, x: torch.Tensor, lp: Params, rope,
           is_moe: bool, token_mask: Optional[torch.Tensor] = None,
           kv_cache=None, cache_positions=None, return_kv: bool = False,
           block_tables: Optional[torch.Tensor] = None, paged_route=None,
           with_aux: bool = False):
    """One block → (x, aux, new_kv); aux is the routed layer's
    load-balance term with ``with_aux`` (None for a dense layer or
    without it). A decode step (kv_cache set) routes with capacity equal
    to its token count, so no decode token is dropped."""
    lp = mesh_lib.gathered(lp)
    attn, new_kv = _mla_attention(c, x, lp, rope, kv_cache=kv_cache,
                                  cache_positions=cache_positions,
                                  return_kv=return_kv,
                                  block_tables=block_tables,
                                  paged_route=paged_route)
    x = x + attn
    h = llama._rms_norm(x, lp['mlp_norm'], c.norm_eps)
    if not is_moe:
        return x + _dense_mlp(c, h, lp), None, new_kv
    shared = _dense_mlp(c, h, lp, 'ws_gate', 'ws_up', 'ws_down')
    capacity = x.shape[0] * x.shape[1] if kv_cache is not None else None
    routed, aux = moe._moe_mlp(c, h, lp, token_mask=token_mask,
                               capacity=capacity, with_aux=with_aux)
    return x + (shared + routed), aux, new_kv


def _layer_output(c, x, lp, rope, is_moe, token_mask, with_aux):
    return _layer(c, x, lp, rope, is_moe, token_mask=token_mask,
                  with_aux=with_aux)[:2]


# The reference's checkpoint names in this family's layers
# (skypilot_tpu/models/deepseek.py): the output projection and the dense
# (or shared-expert) MLP's gate and up products.
_NAMED_PRODUCTS = {'attn_o': ('wo',), 'mlp_gate': ('w_gate', 'ws_gate'),
                   'mlp_up': ('w_up', 'ws_up')}


def _remat_weights(c: DeepSeekConfig, lp: Params) -> list:
    """The weights whose products the layer's checkpoint keeps under
    ``llama._remat_policy``'s mapping: 'dots' every 2-D weight (the
    routed experts' batched products are recomputed), 'none' none, a
    named policy the products this family tags with its names."""
    if c.remat_policy == 'dots':
        return llama.matrices(lp)
    llama._saved_weights(c)      # raises for an unknown policy
    names = llama._REMAT_SAVE_NAMES.get(c.remat_policy, ())
    return [lp[w] for n in names for w in _NAMED_PRODUCTS.get(n, ())
            if w in lp and lp[w].ndim == 2]


def _trunk(c: DeepSeekConfig, params: Params, tokens: torch.Tensor,
           positions: Optional[torch.Tensor],
           token_mask: Optional[torch.Tensor] = None,
           return_kv: bool = False, with_aux: bool = False):
    """Embed → layers → final RMSNorm → (x [B,S,D], kv or None, the
    routed layers' mean load-balance term or None); kv is {'k': c_kv
    [L,B,S,1,r], 'v': k_rope [L,B,S,1,dr]}. With ``remat`` (and a
    gradient to take) each layer is checkpointed under the config's
    policy."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)[
            None, :].expand(tokens.shape)
    x = qops.embed_rows(params['embed'], tokens).to(c.dtype)
    rope = llama._rope_tables(positions, c.qk_rope_head_dim, c.rope_theta)
    kv = None
    if return_kv:
        b, s = tokens.shape
        kv = {'k': torch.empty((c.n_layers, b, s, 1, c.kv_lora_rank),
                               dtype=c.dtype, device=x.device),
              'v': torch.empty((c.n_layers, b, s, 1, c.qk_rope_head_dim),
                               dtype=c.dtype, device=x.device)}
    remat = c.remat and not return_kv and torch.is_grad_enabled()
    aux_sum = None
    for group, is_moe, first in _groups(c, params):
        for i in range(group['attn_norm'].shape[0]):
            lp = {name: w[i] for name, w in group.items()}
            if remat:
                x, aux = ckpt.checkpoint(
                    _layer_output, c, x, lp, rope, is_moe, token_mask,
                    with_aux, use_reentrant=False,
                    context_fn=llama.save_products(_remat_weights(c, lp)))
            else:
                x, aux, layer_kv = _layer(c, x, lp, rope, is_moe,
                                          token_mask=token_mask,
                                          return_kv=return_kv,
                                          with_aux=with_aux)
                if return_kv:
                    kv['k'][first + i] = layer_kv[0]
                    kv['v'][first + i] = layer_kv[1]
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
    mean_aux = None
    if with_aux:
        mean_aux = (aux_sum if aux_sum is not None else
                    torch.zeros((), device=x.device)) / max(c.n_moe_layers, 1)
    return (llama._rms_norm(x, params['final_norm'], c.norm_eps), kv,
            mean_aux)


def forward(c: DeepSeekConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            return_aux: bool = False,
            token_mask: Optional[torch.Tensor] = None):
    """Full forward → fp32 logits [B, S, vocab], and with ``return_aux``
    the routed layers' mean load-balance term."""
    x, _, aux = _trunk(c, params, tokens, positions, token_mask=token_mask,
                       with_aux=return_aux)
    logits = lm_logits(c, params, x)
    return (logits, aux) if return_aux else logits


def loss_fn(c: DeepSeekConfig, params: Params, tokens: torch.Tensor,
            targets: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None,
            token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunked next-token cross-entropy (``ce_chunk`` positions of fp32
    logits at a time) + ``router_aux_coef`` x the load-balance term.
    token_mask [B, S] reaches routing only."""
    x, _, aux = _trunk(c, params, tokens, None, token_mask=token_mask,
                       with_aux=True)
    ce = llama._chunked_ce(x, params['lm_head'], targets, loss_mask,
                           c.ce_chunk)
    return ce + c.router_aux_coef * aux


def pipelined_loss_fn(c: DeepSeekConfig, params: Params, tokens, targets,
                      mesh=None, n_microbatches: int = 1, loss_mask=None,
                      token_mask=None):
    """loss_fn pipelined over a mesh's stages: not ported yet (ROADMAP.md
    queue 1 item 8d)."""
    del c, params, tokens, targets, mesh, n_microbatches, loss_mask
    del token_mask
    raise NotImplementedError(moe._PIPELINE)


def prefill_hidden(c: DeepSeekConfig, params: Params, tokens: torch.Tensor,
                   true_len):
    """Engine contract: → (last_hidden [B, D], stacked compressed KV
    {'k': c_kv [L,B,S,1,r], 'v': k_rope [L,B,S,1,dr]}). Tokens at or past
    a row's true_len are padding: masked out of expert routing."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    true = torch.as_tensor(true_len, device=tokens.device).reshape(-1, 1)
    token_mask = (positions < true).float()
    x, kv, _ = _trunk(c, params, tokens, positions,
                      token_mask=token_mask, return_kv=True)
    return llama.last_token_hidden(x, true_len), kv


def _decode(c: DeepSeekConfig, params: Params, last_tokens: torch.Tensor,
            positions: torch.Tensor, kv, block_tables=None):
    x = qops.embed_rows(params['embed'], last_tokens[:, None]).to(c.dtype)
    rope = llama._rope_tables(positions[:, None], c.qk_rope_head_dim,
                              c.rope_theta)
    route = None
    if block_tables is not None:
        route = llama.paged_write_route(positions, block_tables,
                                        kv['k'].shape[1] - 1,
                                        kv['k'].shape[2])
    for group, is_moe, first in _groups(c, params):
        for i in range(group['attn_norm'].shape[0]):
            lp = {name: w[i] for name, w in group.items()}
            x, _, _ = _layer(c, x, lp, rope, is_moe,
                             kv_cache=(kv['k'][first + i],
                                       kv['v'][first + i]),
                             cache_positions=positions,
                             block_tables=block_tables, paged_route=route)
    x = llama._rms_norm(x, params['final_norm'], c.norm_eps)
    return lm_logits(c, params, x)[:, 0], kv


def decode_forward(c: DeepSeekConfig, params: Params,
                   last_tokens: torch.Tensor, positions: torch.Tensor,
                   kv) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One absorbed-MLA decode step over the compressed slot cache.

    last_tokens [B], positions [B] (index each new token lands at; at or
    past the cache length writes nothing), kv {'k': [L,B,K,1,r], 'v':
    [L,B,K,1,dr]}, updated in place → (fp32 logits [B, V], kv)."""
    return _decode(c, params, last_tokens, positions, kv)


def paged_decode_forward(c: DeepSeekConfig, params: Params,
                         last_tokens: torch.Tensor, positions: torch.Tensor,
                         kv, block_tables: torch.Tensor
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """decode_forward over the paged compressed cache: kv {'k','v': [L,
    P + 1, page, 1, ·]} arenas (P pages and the spare page), block_tables
    [B, nblk] int32 shared by every layer; positions of inactive slots
    point past the table, so their writes land in the spare page."""
    return _decode(c, params, last_tokens, positions, kv, block_tables)


def lm_logits(c, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Untied LM head (the same as llama's) → fp32 logits."""
    return llama.lm_logits(None, params, hidden)
