"""Gemma-family decoder-only transformer in PyTorch: serving and training.

Counterpart of ``skypilot_tpu/models/gemma.py``, built on the Llama
module's helpers as the reference builds on its own. Where Gemma differs
from Llama:

  * tied embeddings: the LM head is the embedding table, transposed, and
    the inputs are scaled by sqrt(d_model) rounded to the model's type
    first (in bf16, sqrt(3584) is 60.0, not 59.87);
  * GeGLU MLP: gelu (tanh form) of the gate, in fp32;
  * decoupled head_dim: n_heads * head_dim need not be d_model (Gemma-2B
    has d_model 2048 and 8 heads of 256);
  * RMSNorm scaled by (1 + w) in fp32, so a zero norm is the identity;
  * Gemma-2: output norms after the attention and MLP sublayers,
    attention logits soft-capped (cap * tanh(s / cap)), an explicit
    attention scale (query_pre_attn_scalar ** -0.5), a sliding window on
    even layers only, and the final logits soft-capped.

The same config fields, named configs, parameter names and stacked
``[L, ...]`` layer layout as the reference, so a JAX ``init`` tree
crosses one to one (``params_from_numpy``). The reference scans Gemma-2's
layers in (windowed, global) pairs so that the window stays a static
kernel parameter; here a plain layer loop hands even layers
``sliding_window`` and odd layers none. Every Gemma config has head_dim
256, which every flash kernel (K1-K3) and the decode kernels (K4, K5)
take, so Gemma serves and trains on the card. Training takes the whole
fp32 logits at once, as the reference's loss does. The reference has no
paged hook for Gemma, nor has the port; the pipelined loss waits for
ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from skypilot_tpu_torch import Device, resolve_device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import quantization as qops

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 256_128
    d_model: int = 2048
    n_layers: int = 18
    n_heads: int = 8
    n_kv_heads: int = 1
    head_dim: int = 256
    d_ff: int = 16_384
    max_seq_len: int = 8192
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    final_logit_softcap: Optional[float] = None   # Gemma-2: 30.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = 'dots'
    attention_impl: str = 'auto'
    # Packed-sequence training (see llama.LlamaConfig.packing_reset_eos).
    packing_reset_eos: Optional[int] = None
    # Gemma-2 block structure: output norms after the attention and MLP
    # sublayers (post_attn_norm / post_ffw_norm), attention logit
    # softcapping (50.0 in the release), an explicit attention scale and
    # a sliding window on even layers only. n_layers must be even, as the
    # reference's pair scan requires (every released Gemma-2 is).
    gemma2: bool = False
    attn_logit_softcap: Optional[float] = None
    attn_scale: Optional[float] = None
    sliding_window: Optional[int] = None

    def __post_init__(self):
        if self.gemma2 and self.n_layers % 2:
            raise ValueError('gemma2 needs an even n_layers '
                             '(the layer scan runs windowed/global '
                             'pairs).')

    def num_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, h, kv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * h * hd * 2 + d * kv * hd * 2
        mlp = 3 * d * f
        norms = 4 * d if self.gemma2 else 2 * d
        per_layer = attn + mlp + norms
        return v * d + self.n_layers * per_layer + d   # tied embedding

    def train_flops_per_token(self) -> float:
        attn_flops = (12 * self.n_layers * self.n_heads * self.head_dim *
                      self.max_seq_len)
        return 6 * self.num_params() + attn_flops


GEMMA_2B = GemmaConfig()
GEMMA_7B = GemmaConfig(d_model=3072, n_layers=28, n_heads=16,
                       n_kv_heads=16, head_dim=256, d_ff=24_576)
GEMMA_TINY = GemmaConfig(vocab_size=256, d_model=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                         max_seq_len=128, remat=False,
                         final_logit_softcap=30.0)

# Gemma-2 (public configs): post-sublayer norms, softcaps 50/30,
# alternating 4096-token sliding windows, query_pre_attn_scalar scale.
GEMMA2_2B = GemmaConfig(
    d_model=2304, n_layers=26, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, gemma2=True, attn_logit_softcap=50.0,
    final_logit_softcap=30.0, sliding_window=4096,
    attn_scale=256.0 ** -0.5)
GEMMA2_9B = GemmaConfig(
    d_model=3584, n_layers=42, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14_336, gemma2=True, attn_logit_softcap=50.0,
    final_logit_softcap=30.0, sliding_window=4096,
    attn_scale=256.0 ** -0.5)
GEMMA2_TINY = dataclasses.replace(
    GEMMA_TINY, gemma2=True, attn_logit_softcap=50.0,
    sliding_window=8, attn_scale=24.0 ** -0.5)
# fp32 twins of the tiny configs: the parity checks against the
# reference and between the card and the CPU run at these.
GEMMA_TINY_F32 = dataclasses.replace(GEMMA_TINY, dtype=torch.float32)
GEMMA2_TINY_F32 = dataclasses.replace(GEMMA2_TINY, dtype=torch.float32)

CONFIGS = {
    'gemma-2b': GEMMA_2B,
    'gemma-7b': GEMMA_7B,
    'gemma-tiny': GEMMA_TINY,
    'gemma2-2b': GEMMA2_2B,
    'gemma2-9b': GEMMA2_9B,
    'gemma2-tiny': GEMMA2_TINY,
}


def init(config: GemmaConfig, generator: Optional[torch.Generator] = None,
         device: Device = None) -> Params:
    """Initialize parameters as ``llama.init`` does (truncated-normal
    fan-in scaling, drawn from ``generator``, seeded 0 if omitted, one
    layer at a time; ``device='meta'`` for shapes alone), with the
    reference's Gemma leaves: zero norms (the (1 + w) scaling makes them
    the identity), Gemma-2's two output norms, and no LM head (tied)."""
    c = config
    device = resolve_device(device)
    if generator is None and device.type != 'meta':
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    hd = c.head_dim

    def fill(out, fan_in):
        tmp = torch.empty(out.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(tmp, a=-2.0, b=2.0, generator=generator)
        out.copy_(tmp.mul_(fan_in ** -0.5))
        return out

    def stack(shape, fan_in):
        out = torch.empty((c.n_layers,) + shape, dtype=c.dtype,
                          device=device)
        for layer in range(c.n_layers):
            fill(out[layer], fan_in)
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=c.dtype, device=device)

    norms = ('attn_norm', 'mlp_norm') + (
        ('post_attn_norm', 'post_ffw_norm') if c.gemma2 else ())
    layers: Params = {
        'wq': stack((c.d_model, c.n_heads * hd), c.d_model),
        'wk': stack((c.d_model, c.n_kv_heads * hd), c.d_model),
        'wv': stack((c.d_model, c.n_kv_heads * hd), c.d_model),
        'wo': stack((c.n_heads * hd, c.d_model), c.n_heads * hd),
        'w_gate': stack((c.d_model, c.d_ff), c.d_model),
        'w_up': stack((c.d_model, c.d_ff), c.d_model),
        'w_down': stack((c.d_ff, c.d_model), c.d_ff),
        **{name: zeros(c.n_layers, c.d_model) for name in norms},
    }
    embed = fill(torch.empty((c.vocab_size, c.d_model), dtype=c.dtype,
                             device=device), c.d_model)
    return {'embed': embed, 'layers': layers,
            'final_norm': zeros(c.d_model)}


# The JAX tree crosses by name, the Gemma-2 output norms included.
params_from_numpy = llama.params_from_numpy


def _rms_norm(x: torch.Tensor, scale: torch.Tensor,
              eps: float) -> torch.Tensor:
    """x·rsqrt(mean(x²) + eps)·(1 + w), all in fp32, cast back to x's type
    once (the reference's order)."""
    x32 = torch.nn.functional.rms_norm(x.float(), (x.shape[-1],), eps=eps)
    return (x32 * (1.0 + scale.float())).to(x.dtype)


def _embed(config: GemmaConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows scaled by sqrt(d_model) rounded to the model's type
    first, as the reference's jnp.asarray(d_model ** 0.5, dtype): the
    product of two values of the type is exact in fp32 and rounds once."""
    c = config
    normalizer = float(torch.tensor(c.d_model ** 0.5, dtype=c.dtype))
    return qops.embed_rows(params['embed'], tokens).to(c.dtype) * normalizer


def _window(config: GemmaConfig, layer: int) -> Optional[int]:
    """Gemma-2 windows its even layers; odd layers (and Gemma-1) attend
    over the whole prefix."""
    return config.sliding_window if config.gemma2 and layer % 2 == 0 else None


def _layer(config: GemmaConfig, x: torch.Tensor, layer_params: Params,
           rope, window: Optional[int] = None, kv_cache=None,
           cache_positions=None, return_kv: bool = False,
           segment_ids: Optional[torch.Tensor] = None):
    """One block; ``rope`` = llama._rope_tables(positions, ...). Training
    and prefill by default; with ``kv_cache`` a step writing each slot's
    new K/V at its own ``cache_positions`` (llama.slot_cache_attend).
    Gemma-2 adds the output norms, the softcap and the scale; ``window``
    is the caller's (even layers). Returns (x, new_kv_cache)."""
    c = config
    hd = c.head_dim
    b, s, _ = x.shape
    lp = layer_params
    h = _rms_norm(x, lp['attn_norm'], c.norm_eps)
    q = qops.matmul(h, lp['wq']).reshape(b, s, c.n_heads, hd)
    k = qops.matmul(h, lp['wk']).reshape(b, s, c.n_kv_heads, hd)
    v = qops.matmul(h, lp['wv']).reshape(b, s, c.n_kv_heads, hd)
    q = llama._apply_rope(q, rope)
    k = llama._apply_rope(k, rope)
    opts = dict(window=window, logit_softcap=c.attn_logit_softcap,
                scale=c.attn_scale)
    if kv_cache is not None:
        attn, new_cache = llama.slot_cache_attend(
            q, k, v, kv_cache, cache_positions=cache_positions, **opts)
    else:
        new_cache = (k, v) if return_kv else None
        attn = attention_ops.dot_product_attention(
            q, k, v, causal=True, implementation=c.attention_impl,
            segment_ids=segment_ids, **opts)
    attn_out = qops.matmul(attn.reshape(b, s, c.n_heads * hd), lp['wo'])
    if c.gemma2:
        attn_out = _rms_norm(attn_out, lp['post_attn_norm'], c.norm_eps)
    x = x + attn_out

    h = _rms_norm(x, lp['mlp_norm'], c.norm_eps)
    gate = torch.nn.functional.gelu(qops.matmul(h, lp['w_gate']).float(),
                                    approximate='tanh')
    up = qops.matmul(h, lp['w_up']).float()
    ffw_out = qops.matmul((gate * up).to(c.dtype), lp['w_down'])
    if c.gemma2:
        ffw_out = _rms_norm(ffw_out, lp['post_ffw_norm'], c.norm_eps)
    return x + ffw_out, new_cache


def _layer_output(config, x, layer_params, rope, window, segment_ids):
    return _layer(config, x, layer_params, rope, window=window,
                  segment_ids=segment_ids)[0]


def _trunk(config: GemmaConfig, params: Params, tokens: torch.Tensor,
           positions: Optional[torch.Tensor], return_kv: bool):
    """Scaled embed → layers → final norm. Returns (x [B,S,D], kv or
    None); kv is {'k','v': [L, B, S, KVH, HD]}."""
    c = config
    segment_ids = None
    if positions is None:
        segment_ids, positions = llama.positions_and_segments(
            c, tokens, serving=return_kv)
    x = _embed(c, params, tokens)
    kv = None
    if return_kv:
        shape = (c.n_layers,) + tuple(tokens.shape) + (c.n_kv_heads,
                                                       c.head_dim)
        kv = {'k': torch.empty(shape, dtype=c.dtype, device=x.device),
              'v': torch.empty(shape, dtype=c.dtype, device=x.device)}
    rope = llama._rope_tables(positions, c.head_dim, c.rope_theta)
    remat = c.remat and not return_kv and torch.is_grad_enabled()
    for layer in range(c.n_layers):
        lp = llama._layer_params(params, layer)
        window = _window(c, layer)
        if remat:
            x = ckpt.checkpoint(_layer_output, c, x, lp, rope, window,
                                segment_ids, use_reentrant=False,
                                context_fn=llama._remat_context(c, lp))
            continue
        x, layer_kv = _layer(c, x, lp, rope, window=window,
                             return_kv=return_kv, segment_ids=segment_ids)
        if return_kv:
            kv['k'][layer] = layer_kv[0]
            kv['v'][layer] = layer_kv[1]
    return _rms_norm(x, params['final_norm'], c.norm_eps), kv


def _cached_trunk(config: GemmaConfig, params: Params, tokens: torch.Tensor,
                  positions: torch.Tensor, cache_positions: torch.Tensor,
                  kv: Dict[str, Any]) -> torch.Tensor:
    """tokens [B, S] at positions [B, S] through every layer against the
    slot cache (written in place at ``cache_positions``: [B] for one
    decode step, which goes to the decode kernel, or [B, S]) → the
    final-normed hidden [B, S, D]."""
    c = config
    x = _embed(c, params, tokens)
    rope = llama._rope_tables(positions, c.head_dim, c.rope_theta)
    for layer in range(c.n_layers):
        cache = (llama._cache_layer(kv['k'], layer),
                 llama._cache_layer(kv['v'], layer))
        x, _ = _layer(c, x, llama._layer_params(params, layer), rope,
                      window=_window(c, layer), kv_cache=cache,
                      cache_positions=cache_positions)
    return _rms_norm(x, params['final_norm'], c.norm_eps)


def lm_logits(config: GemmaConfig, params: Params,
              hidden: torch.Tensor) -> torch.Tensor:
    """Tied-embedding head with the optional final softcap; hidden
    [..., D] → fp32 logits [..., V]."""
    logits = qops.tied_head(hidden, params['embed'],
                            preferred_element_type=torch.float32)
    cap = config.final_logit_softcap
    if cap:
        logits = cap * torch.tanh(logits / cap)
    return logits


def forward(config: GemmaConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training forward → fp32 logits [B, S, vocab] (tied head)."""
    x, _ = _trunk(config, params, tokens, positions, return_kv=False)
    return lm_logits(config, params, x)


def loss_fn(config: GemmaConfig, params: Params, tokens: torch.Tensor,
            targets: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (fp32). The tied, soft-capped head
    takes the whole logits at once, as the reference's does."""
    nll = llama._token_nll(forward(config, params, tokens), targets)
    if loss_mask is not None:
        mask = loss_mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def prefill_hidden(config: GemmaConfig, params: Params, tokens: torch.Tensor,
                   true_len) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill trunk → (last_hidden [B, D], per-layer KV): the engine
    contract of llama.prefill_hidden."""
    x, kv = _trunk(config, params, tokens, None, return_kv=True)
    return llama.last_token_hidden(x, true_len), kv


def decode_forward(config: GemmaConfig, params: Params,
                   last_tokens: torch.Tensor, positions: torch.Tensor,
                   kv: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for a batch of slots (llama.decode_forward's
    contract): last_tokens [B], positions [B] (at or past the cache
    length writes nothing), kv updated in place → (fp32 logits [B, V],
    kv)."""
    x = _cached_trunk(config, params, last_tokens[:, None],
                      positions[:, None], positions, kv)
    return lm_logits(config, params, x)[:, 0], kv


def verify_hidden(config: GemmaConfig, params: Params, tokens: torch.Tensor,
                  positions: torch.Tensor, kv: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The trunk of verify_forward → (final-normed hidden [B, S, D], kv),
    for callers that project only some rows (llama.verify_hidden)."""
    return _cached_trunk(config, params, tokens, positions, positions,
                         kv), kv


def verify_forward(config: GemmaConfig, params: Params, tokens: torch.Tensor,
                   positions: torch.Tensor, kv: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Multi-token decode into the dense cache (llama.verify_forward's
    contract): tokens and positions [B, S] → (fp32 logits [B, S, V],
    kv)."""
    x, kv = verify_hidden(config, params, tokens, positions, kv)
    return lm_logits(config, params, x), kv
