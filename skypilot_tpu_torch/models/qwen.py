"""Qwen-family decoder-only transformer in PyTorch: serving and training.

Counterpart of ``skypilot_tpu/models/qwen.py``, built on the Llama
module's helpers as the reference builds on its own. Where Qwen differs
from Llama:

  * Qwen-2: biases on the Q/K/V projections (none elsewhere);
  * Qwen-3: per-head QK-RMSNorm (one scale over head_dim, shared by the
    heads) instead of projection biases, applied before RoPE;
  * RoPE base theta = 1e6, and ``head_dim`` is a field, not derived;
  * untied LM head, so Llama's chunked cross-entropy applies unchanged
    (chunked every ``ce_chunk`` positions, as the reference's).

The same config fields, named configs, parameter names and stacked
``[L, ...]`` layer layout as the reference, so a JAX ``init`` tree
crosses one to one (``params_from_numpy``), and the same serving surface
as the Llama family over the dense slot cache: ``prefill_hidden``,
``decode_forward`` and ``verify_forward`` (the engine's chunked prefill
and prefix cache). The reference has no paged hook for Qwen, nor has the
port; the pipelined loss waits for ROADMAP.md queue 1 item 8.
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
class QwenConfig:
    vocab_size: int = 152_064
    d_model: int = 3584
    n_layers: int = 28
    n_heads: int = 28
    n_kv_heads: int = 4
    head_dim: int = 128
    d_ff: int = 18_944
    max_seq_len: int = 32_768
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    qkv_bias: bool = True      # Qwen-2 style
    qk_norm: bool = False      # Qwen-3 style
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = 'dots'
    attention_impl: str = 'auto'
    ce_chunk: int = 2048
    # Packed-sequence training (see llama.LlamaConfig.packing_reset_eos).
    packing_reset_eos: Optional[int] = None

    def num_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, h, kv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * h * hd * 2 + d * kv * hd * 2
        if self.qkv_bias:
            attn += h * hd + 2 * kv * hd
        if self.qk_norm:
            attn += 2 * hd
        mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
        return v * d * 2 + self.n_layers * per_layer + d

    def train_flops_per_token(self) -> float:
        attn_flops = (12 * self.n_layers * self.n_heads * self.head_dim *
                      self.max_seq_len)
        return 6 * self.num_params() + attn_flops


QWEN2_7B = QwenConfig()
QWEN3_8B = QwenConfig(vocab_size=151_936, d_model=4096, n_layers=36,
                      n_heads=32, n_kv_heads=8, head_dim=128,
                      d_ff=12_288, qkv_bias=False, qk_norm=True)
QWEN_TINY = QwenConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, head_dim=16, d_ff=128,
                       max_seq_len=128, remat=False)
QWEN3_TINY = dataclasses.replace(QWEN_TINY, qkv_bias=False, qk_norm=True)
# fp32 twins of the tiny configs: the parity checks against the
# reference and between the card and the CPU run at these.
QWEN_TINY_F32 = dataclasses.replace(QWEN_TINY, dtype=torch.float32)
QWEN3_TINY_F32 = dataclasses.replace(QWEN3_TINY, dtype=torch.float32)

CONFIGS = {
    'qwen2-7b': QWEN2_7B,
    'qwen3-8b': QWEN3_8B,
    'qwen-tiny': QWEN_TINY,
    'qwen3-tiny': QWEN3_TINY,
}


def init(config: QwenConfig, generator: Optional[torch.Generator] = None,
         device: Device = None) -> Params:
    """Initialize parameters as ``llama.init`` does (truncated-normal
    fan-in scaling, drawn from ``generator``, seeded 0 if omitted, one
    layer at a time; ``device='meta'`` for shapes alone), with the
    reference's Qwen leaves: zero Q/K/V biases (Qwen-2) and unit
    per-head-dim norms (Qwen-3)."""
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

    def dense(shape, fan_in):
        return fill(torch.empty(shape, dtype=c.dtype, device=device), fan_in)

    def stack(shape, fan_in):
        out = torch.empty((c.n_layers,) + shape, dtype=c.dtype,
                          device=device)
        for layer in range(c.n_layers):
            fill(out[layer], fan_in)
        return out

    like = dict(dtype=c.dtype, device=device)
    layers: Params = {
        'wq': stack((c.d_model, c.n_heads * hd), c.d_model),
        'wk': stack((c.d_model, c.n_kv_heads * hd), c.d_model),
        'wv': stack((c.d_model, c.n_kv_heads * hd), c.d_model),
        'wo': stack((c.n_heads * hd, c.d_model), c.n_heads * hd),
        'w_gate': stack((c.d_model, c.d_ff), c.d_model),
        'w_up': stack((c.d_model, c.d_ff), c.d_model),
        'w_down': stack((c.d_ff, c.d_model), c.d_ff),
        'attn_norm': torch.ones((c.n_layers, c.d_model), **like),
        'mlp_norm': torch.ones((c.n_layers, c.d_model), **like),
    }
    if c.qkv_bias:
        layers.update({
            'bq': torch.zeros((c.n_layers, c.n_heads * hd), **like),
            'bk': torch.zeros((c.n_layers, c.n_kv_heads * hd), **like),
            'bv': torch.zeros((c.n_layers, c.n_kv_heads * hd), **like),
        })
    if c.qk_norm:
        layers.update({
            'q_norm': torch.ones((c.n_layers, hd), **like),
            'k_norm': torch.ones((c.n_layers, hd), **like),
        })
    return {
        'embed': dense((c.vocab_size, c.d_model), c.d_model),
        'layers': layers,
        'final_norm': torch.ones((c.d_model,), **like),
        'lm_head': dense((c.d_model, c.vocab_size), c.d_model),
    }


# The JAX tree crosses by name, biases and norms included.
params_from_numpy = llama.params_from_numpy


def _layer(config: QwenConfig, x: torch.Tensor, layer_params: Params, rope,
           kv_cache=None, cache_positions=None, return_kv: bool = False,
           segment_ids: Optional[torch.Tensor] = None):
    """One block; ``rope`` = llama._rope_tables(positions, ...). Training
    and prefill by default; with ``kv_cache`` a step writing each slot's
    new K/V at its own ``cache_positions`` (llama.slot_cache_attend).
    Returns (x, new_kv_cache)."""
    c = config
    hd = c.head_dim
    b, s, _ = x.shape
    lp = layer_params
    h = llama._rms_norm(x, lp['attn_norm'], c.norm_eps)
    q = qops.matmul(h, lp['wq'])
    k = qops.matmul(h, lp['wk'])
    v = qops.matmul(h, lp['wv'])
    if c.qkv_bias:
        q, k, v = q + lp['bq'], k + lp['bk'], v + lp['bv']
    q = q.reshape(b, s, c.n_heads, hd)
    k = k.reshape(b, s, c.n_kv_heads, hd)
    v = v.reshape(b, s, c.n_kv_heads, hd)
    if c.qk_norm:
        q = llama._rms_norm(q, lp['q_norm'], c.norm_eps)
        k = llama._rms_norm(k, lp['k_norm'], c.norm_eps)
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
    x = x + llama._swiglu(c, h, lp['w_gate'], lp['w_up'], lp['w_down'])
    return x, new_cache


def _layer_output(config, x, layer_params, rope, segment_ids):
    return _layer(config, x, layer_params, rope, segment_ids=segment_ids)[0]


def _trunk(config: QwenConfig, params: Params, tokens: torch.Tensor,
           positions: Optional[torch.Tensor], return_kv: bool):
    """Embed → layers → final RMSNorm (llama._trunk's twin). Returns
    (x [B,S,D], kv or None); kv is {'k','v': [L, B, S, KVH, HD]}."""
    c = config
    segment_ids = None
    if positions is None:
        segment_ids, positions = llama.positions_and_segments(
            c, tokens, serving=return_kv)
    x = qops.embed_rows(params['embed'], tokens).to(c.dtype)
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
        if remat:
            x = ckpt.checkpoint(_layer_output, c, x, lp, rope, segment_ids,
                                use_reentrant=False,
                                context_fn=llama._remat_context(c, lp))
            continue
        x, layer_kv = _layer(c, x, lp, rope, return_kv=return_kv,
                             segment_ids=segment_ids)
        if return_kv:
            kv['k'][layer] = layer_kv[0]
            kv['v'][layer] = layer_kv[1]
    return llama._rms_norm(x, params['final_norm'], c.norm_eps), kv


def _cached_trunk(config: QwenConfig, params: Params, tokens: torch.Tensor,
                  positions: torch.Tensor, cache_positions: torch.Tensor,
                  kv: Dict[str, Any]) -> torch.Tensor:
    """tokens [B, S] at positions [B, S] through every layer against the
    slot cache (written in place at ``cache_positions``: [B] for one
    decode step, which goes to the decode kernel, or [B, S]) → the
    final-normed hidden [B, S, D]."""
    c = config
    x = qops.embed_rows(params['embed'], tokens).to(c.dtype)
    rope = llama._rope_tables(positions, c.head_dim, c.rope_theta)
    for layer in range(c.n_layers):
        cache = (llama._cache_layer(kv['k'], layer),
                 llama._cache_layer(kv['v'], layer))
        x, _ = _layer(c, x, llama._layer_params(params, layer), rope,
                      kv_cache=cache, cache_positions=cache_positions)
    return llama._rms_norm(x, params['final_norm'], c.norm_eps)


def forward(config: QwenConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training forward → fp32 logits [B, S, vocab]."""
    x, _ = _trunk(config, params, tokens, positions, return_kv=False)
    return lm_logits(config, params, x)


def loss_fn(config: QwenConfig, params: Params, tokens: torch.Tensor,
            targets: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (fp32), Llama's chunked head taken
    ``config.ce_chunk`` positions at a time."""
    x, _ = _trunk(config, params, tokens, None, return_kv=False)
    return llama._chunked_ce(x, params['lm_head'], targets, loss_mask,
                             chunk=config.ce_chunk)


def lm_logits(config: QwenConfig, params: Params,
              hidden: torch.Tensor) -> torch.Tensor:
    """Untied LM head (Llama's); hidden [..., D] -> fp32 logits [..., V]."""
    return llama.lm_logits(config, params, hidden)


def prefill_hidden(config: QwenConfig, params: Params, tokens: torch.Tensor,
                   true_len) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill trunk → (last_hidden [B, D], per-layer KV): the engine
    contract of llama.prefill_hidden."""
    x, kv = _trunk(config, params, tokens, None, return_kv=True)
    return llama.last_token_hidden(x, true_len), kv


def decode_forward(config: QwenConfig, params: Params,
                   last_tokens: torch.Tensor, positions: torch.Tensor,
                   kv: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for a batch of slots (llama.decode_forward's
    contract): last_tokens [B], positions [B] (at or past the cache
    length writes nothing), kv updated in place → (fp32 logits [B, V],
    kv)."""
    x = _cached_trunk(config, params, last_tokens[:, None],
                      positions[:, None], positions, kv)
    return lm_logits(config, params, x)[:, 0], kv


def verify_hidden(config: QwenConfig, params: Params, tokens: torch.Tensor,
                  positions: torch.Tensor, kv: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The trunk of verify_forward → (final-normed hidden [B, S, D], kv),
    for callers that project only some rows (llama.verify_hidden)."""
    return _cached_trunk(config, params, tokens, positions, positions,
                         kv), kv


def verify_forward(config: QwenConfig, params: Params, tokens: torch.Tensor,
                   positions: torch.Tensor, kv: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Multi-token decode into the dense cache (llama.verify_forward's
    contract): tokens and positions [B, S] → (fp32 logits [B, S, V],
    kv)."""
    x, kv = verify_hidden(config, params, tokens, positions, kv)
    return lm_logits(config, params, x), kv
