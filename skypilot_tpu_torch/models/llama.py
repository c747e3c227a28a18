"""Llama-family decoder-only transformer in PyTorch (serving half).

Counterpart of ``skypilot_tpu/models/llama.py``: the same config fields
and named configs, the same parameter names and stacked ``[L, ...]``
layer layout (so a JAX ``init`` tree converts one to one), and the same
serving functions. Layers run in a Python loop in place of ``lax.scan``;
the KV cache is updated in place (the JAX engine donates it instead).

Dtype placement follows the reference: RMSNorm computes in fp32 and
casts back before the scale multiply, RoPE and the SwiGLU gate run in
fp32, and the LM head returns fp32 logits (see ``quantization.matmul``).

Training (loss, chunked cross-entropy, remat), ring/ulysses attention,
the paged cache and speculative verification come in later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import Device, resolve_device
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import decode_attention as decode_ops
from skypilot_tpu_torch.ops import quantization as qops

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = 'dots'
    attention_impl: str = 'auto'
    # Mistral-style sliding-window attention: each token attends to at
    # most this many recent positions. None = full causal attention.
    sliding_window: Optional[int] = None
    # Llama-3.1-style RoPE frequency scaling (factor, low_freq_factor,
    # high_freq_factor, original_ctx). None = unscaled.
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    # Packed-sequence training only (EOS-derived segments); serving
    # trunks ignore it, as in the reference.
    packing_reset_eos: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# Canonical configs (sizes match the public Llama-3 / Mistral configs).
LLAMA3_8B = LlamaConfig()
LLAMA3_70B = LlamaConfig(d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                         d_ff=28_672)
LLAMA3_1B = LlamaConfig(vocab_size=32_768, d_model=2048, n_layers=16,
                        n_heads=16, n_kv_heads=8, d_ff=8192,
                        max_seq_len=8192)
LLAMA_TINY = LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128, max_seq_len=128,
                         remat=False)
MISTRAL_7B = LlamaConfig(vocab_size=32_000, d_model=4096, n_layers=32,
                         n_heads=32, n_kv_heads=8, d_ff=14_336,
                         max_seq_len=32_768, rope_theta=10_000.0,
                         sliding_window=4096)
MISTRAL_TINY = LlamaConfig(vocab_size=256, d_model=64, n_layers=2,
                           n_heads=4, n_kv_heads=2, d_ff=128,
                           max_seq_len=128, remat=False,
                           sliding_window=8)

CONFIGS = {
    'llama3-8b': LLAMA3_8B,
    'llama3-70b': LLAMA3_70B,
    'llama3-1b': LLAMA3_1B,
    'mistral-7b': MISTRAL_7B,
    'mistral-tiny': MISTRAL_TINY,
    'tiny': LLAMA_TINY,
}

def init(config: LlamaConfig, generator: Optional[torch.Generator] = None,
         device: Device = None) -> Params:
    """Initialize parameters (truncated-normal fan-in scaling).

    Same names, shapes and distribution as the JAX ``init``; the draws
    come from ``generator`` (seeded 0 if omitted), which must live on
    ``device``. Stacked layer weights are drawn one layer at a time, so
    the fp32 scratch never exceeds one layer's weight.
    """
    c = config
    device = resolve_device(device)
    if generator is None:
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

    ones = dict(dtype=c.dtype, device=device)
    return {
        'embed': dense((c.vocab_size, c.d_model), c.d_model),
        'layers': {
            'wq': stack((c.d_model, c.n_heads * hd), c.d_model),
            'wk': stack((c.d_model, c.n_kv_heads * hd), c.d_model),
            'wv': stack((c.d_model, c.n_kv_heads * hd), c.d_model),
            'wo': stack((c.n_heads * hd, c.d_model), c.n_heads * hd),
            'w_gate': stack((c.d_model, c.d_ff), c.d_model),
            'w_up': stack((c.d_model, c.d_ff), c.d_model),
            'w_down': stack((c.d_ff, c.d_model), c.d_ff),
            'attn_norm': torch.ones((c.n_layers, c.d_model), **ones),
            'mlp_norm': torch.ones((c.n_layers, c.d_model), **ones),
        },
        'final_norm': torch.ones((c.d_model,), **ones),
        'lm_head': dense((c.d_model, c.vocab_size), c.d_model),
    }


def _to_tensor(array: np.ndarray, device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    array = np.asarray(array)
    if array.dtype.name == 'bfloat16':   # ml_dtypes, as JAX hands it out
        t = torch.from_numpy(array.view(np.uint16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(array))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Params, device: Device,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Carry weights across: the JAX ``init`` tree as numpy arrays → the
    port's tree, one to one by name. ``dtype`` recasts floating arrays."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return _to_tensor(tree, device, dtype)


def _layer_params(params: Params, layer: int) -> Params:
    return {name: w[layer] for name, w in params['layers'].items()}


def _rms_norm(x: torch.Tensor, scale: torch.Tensor,
              eps: float) -> torch.Tensor:
    """x·rsqrt(mean(x²) + eps) in fp32, cast back to x's type before the
    scale multiply (the JAX cast order)."""
    x32 = torch.nn.functional.rms_norm(x.float(), (x.shape[-1],), eps=eps)
    return x32.to(x.dtype) * scale


def _rope_tables(positions: torch.Tensor, d: int, theta: float,
                 scaling=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) [B, S, 1, D/2] for positions [B, S].

    ``scaling`` = (factor, low_freq_factor, high_freq_factor, orig_ctx)
    applies Llama-3.1's piecewise frequency remap (HF rope_type
    'llama3'). Every layer of a forward shares one table: the JAX scan
    recomputes it per layer, which eager PyTorch would pay for in
    kernel launches."""
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=positions.device) / d)
    if scaling is not None:
        factor, low_f, high_f, orig_ctx = scaling
        wavelen = 2.0 * math.pi / freqs
        low_wl = orig_ctx / low_f
        high_wl = orig_ctx / high_f
        smooth = ((orig_ctx / wavelen - low_f) /
                  (high_f - low_f)).clamp(0.0, 1.0)
        mid = (1.0 - smooth) * freqs / factor + smooth * freqs
        freqs = torch.where(wavelen > low_wl, freqs / factor,
                            torch.where(wavelen < high_wl, freqs, mid))
    angles = positions[..., None].float() * freqs           # [B, S, D/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotate x [B, S, H, D] in fp32 by precomputed (cos, sin)."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          scaling=None) -> torch.Tensor:
    """Rotary embeddings in fp32; x [B, S, H, D], positions [B, S]."""
    return _apply_rope(x, _rope_tables(positions, x.shape[-1], theta,
                                       scaling))


def positions_and_segments(config, tokens: torch.Tensor, serving: bool
                           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Default (segment_ids, positions) for a trunk given no explicit
    positions: serving trunks (one document per slot) get plain arange
    and no segments. EOS-derived packing is training-only and comes
    with the training slice."""
    if config.packing_reset_eos is not None and not serving:
        raise NotImplementedError(
            'packing_reset_eos (packed-sequence training) is not ported '
            'yet; serving trunks do not use it.')
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    return None, positions[None, :].expand(tokens.shape)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(position, head) int8 symmetric quantization over head_dim.
    → (int8 values, fp32 scale with a trailing 1-dim)."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1, keepdim=True) / 127.0).clamp(min=1e-8)
    q = torch.round(x32 / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def write_cache_slots(cache_entry, values: torch.Tensor,
                      slots: torch.Tensor) -> Any:
    """Write full K (or V) prefixes into cache slots, in place.

    cache_entry: [L, n_slots, len, KVH, HD] tensor, or the quantized
    (int8, scale) pair; values: [L, B, n, KVH, HD] with n <= len, written
    into rows [0, n) of slots [B] — rows [n, len) are zeroed, as the
    JAX scatter of a zero-padded prefix leaves them. Every slot index
    must be in range: the JAX version drops out-of-range writes, and the
    port's engine never issues one.
    """
    n = values.shape[2]
    if isinstance(cache_entry, (tuple, list)):
        data, scale = cache_entry
        q_vals, q_scale = quantize_kv(values)
        write_cache_slots(data, q_vals, slots)
        write_cache_slots(scale, q_scale, slots)
        return cache_entry
    cache_entry[:, slots, :n] = values.to(cache_entry.dtype)
    cache_entry[:, slots, n:] = 0
    return cache_entry


def last_token_hidden(x: torch.Tensor, true_len) -> torch.Tensor:
    """x [B, S, D] → [B, D] rows at position true_len-1 (true_len a
    scalar or per-row [B])."""
    idx = torch.as_tensor(true_len, device=x.device).reshape(-1).expand(
        x.shape[0])
    return x[torch.arange(x.shape[0], device=x.device), idx - 1]


def _write_rows(cache: torch.Tensor, rows: torch.Tensor,
                positions: torch.Tensor) -> None:
    """cache[b, positions[b, i]] = rows[b, i] for in-range positions.

    JAX drops an out-of-range scatter and the engine relies on it
    (inactive slots write at max_target_len); torch indexing would raise
    on the CPU and fault on the card, so the write is masked: an
    out-of-range position rewrites its clamped row with the row's own
    old value, leaving the cache bit-identical."""
    max_len = cache.shape[1]
    valid = positions < max_len
    safe = positions.clamp(max=max_len - 1)
    slots = torch.arange(cache.shape[0], device=cache.device)[:, None]
    old = cache[slots, safe]
    mask = valid.reshape(valid.shape + (1,) * (old.ndim - valid.ndim))
    cache[slots, safe] = torch.where(mask, rows.to(cache.dtype), old)


def slot_cache_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_cache, cache_index=None, cache_positions=None,
                      window=None, logit_softcap=None, scale=None):
    """Write this step's K/V into the slot cache (in place) and attend.

    With ``cache_positions`` [B] (or [B, S]) each slot writes at its own
    positions (continuous batching); with scalar ``cache_index`` the
    whole batch writes at one offset. Cache entries are tensors or
    ``(int8, fp32 scale)`` pairs. The single-token per-slot step — the
    serving hot path — goes to the decode kernel, which reads only each
    slot's live rows; the other cases take the masked plain path.
    Returns (attn, kv_cache).
    """
    b, s = q.shape[0], q.shape[1]
    ck, cv = kv_cache
    quantized = isinstance(ck, (tuple, list))
    if quantized:
        ck, ck_scale = ck
        cv, cv_scale = cv
        k_write, k_scale_write = quantize_kv(k)
        v_write, v_scale_write = quantize_kv(v)
    else:
        k_write, v_write = k, v
    if cache_positions is not None:
        pos = (cache_positions if cache_positions.ndim == 2
               else cache_positions[:, None])                   # [B, S]
        _write_rows(ck, k_write, pos)
        _write_rows(cv, v_write, pos)
        if quantized:
            _write_rows(ck_scale, k_scale_write, pos)
            _write_rows(cv_scale, v_scale_write, pos)
        q_pos = pos
    else:
        # JAX's dynamic_update_slice clamps the start so the block fits.
        start = max(0, min(int(cache_index), ck.shape[1] - s))
        ck[:, start:start + s] = k_write.to(ck.dtype)
        cv[:, start:start + s] = v_write.to(cv.dtype)
        if quantized:
            ck_scale[:, start:start + s] = k_scale_write
            cv_scale[:, start:start + s] = v_scale_write
        q_pos = int(cache_index) + torch.arange(s, device=q.device)[None]
    if quantized:
        cache_k: Any = (ck, ck_scale)
        cache_v: Any = (cv, cv_scale)
    else:
        cache_k, cache_v = ck, cv

    if cache_positions is not None and s == 1 and cache_positions.ndim == 1:
        attn = decode_ops.decode_attention(
            q, cache_k, cache_v,
            lengths=(cache_positions + 1).to(torch.int32),
            window=window, logit_softcap=logit_softcap, scale=scale)
        return attn, kv_cache

    # Per-query validity (a multi-token step's earlier rows must not see
    # later rows, and each row carries its own window).
    kv_pos = torch.arange(ck.shape[1], device=q.device)[None, None, :]
    valid = kv_pos <= q_pos[..., None]
    if window is not None:
        valid = valid & (kv_pos > q_pos[..., None] - window)
    if quantized:
        k_full = dequantize_kv(ck, ck_scale, q.dtype)
        v_full = dequantize_kv(cv, cv_scale, q.dtype)
    else:
        k_full, v_full = ck.to(q.dtype), cv.to(q.dtype)
    attn = attention_ops.xla_attention_with_mask(
        q, k_full, v_full, valid[:, None], logit_softcap=logit_softcap,
        scale=scale)
    return attn, kv_cache


def _layer(config: LlamaConfig, x: torch.Tensor, layer_params: Params,
           rope, kv_cache=None, cache_index=None, cache_positions=None,
           return_kv: bool = False,
           segment_ids: Optional[torch.Tensor] = None):
    """One transformer block; ``rope`` = _rope_tables(positions, ...).
    Returns (x, new_kv_cache)."""
    c = config
    hd = c.head_dim
    b, s, _ = x.shape
    h = _rms_norm(x, layer_params['attn_norm'], c.norm_eps)
    q = qops.matmul(h, layer_params['wq']).reshape(b, s, c.n_heads, hd)
    k = qops.matmul(h, layer_params['wk']).reshape(b, s, c.n_kv_heads, hd)
    v = qops.matmul(h, layer_params['wv']).reshape(b, s, c.n_kv_heads, hd)
    q = _apply_rope(q, rope)
    k = _apply_rope(k, rope)

    if kv_cache is not None:
        attn, new_cache = slot_cache_attend(
            q, k, v, kv_cache, cache_index=cache_index,
            cache_positions=cache_positions, window=c.sliding_window)
    else:
        new_cache = (k, v) if return_kv else None
        attn = attention_ops.dot_product_attention(
            q, k, v, causal=True,
            implementation=c.attention_impl, window=c.sliding_window,
            segment_ids=segment_ids)

    attn = attn.reshape(b, s, c.n_heads * hd)
    x = x + qops.matmul(attn, layer_params['wo'])

    h = _rms_norm(x, layer_params['mlp_norm'], c.norm_eps)
    gate = torch.nn.functional.silu(
        qops.matmul(h, layer_params['w_gate']).float())
    up = qops.matmul(h, layer_params['w_up']).float()
    ff = (gate * up).to(c.dtype)
    x = x + qops.matmul(ff, layer_params['w_down'])
    return x, new_cache


def _trunk(config: LlamaConfig, params: Params, tokens: torch.Tensor,
           positions: Optional[torch.Tensor], return_kv: bool,
           segment_ids: Optional[torch.Tensor] = None):
    """Embed → layers → final RMSNorm. Returns (x [B,S,D], kv or None);
    kv is {'k','v': [L, B, S, KVH, HD]}, filled layer by layer."""
    c = config
    if positions is None:
        segment_ids, positions = positions_and_segments(
            c, tokens, serving=return_kv)
    x = qops.embed_rows(params['embed'], tokens).to(c.dtype)
    kv = None
    if return_kv:
        shape = (c.n_layers,) + tuple(tokens.shape) + (c.n_kv_heads,
                                                       c.head_dim)
        kv = {'k': torch.empty(shape, dtype=c.dtype, device=x.device),
              'v': torch.empty(shape, dtype=c.dtype, device=x.device)}
    rope = _rope_tables(positions, c.head_dim, c.rope_theta, c.rope_scaling)
    for layer in range(c.n_layers):
        x, layer_kv = _layer(c, x, _layer_params(params, layer), rope,
                             return_kv=return_kv, segment_ids=segment_ids)
        if return_kv:
            kv['k'][layer] = layer_kv[0]
            kv['v'][layer] = layer_kv[1]
    return _rms_norm(x, params['final_norm'], c.norm_eps), kv


def forward(config: LlamaConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            return_kv: bool = False):
    """Prefill forward pass → fp32 logits [B, S, vocab] (and, with
    return_kv, the per-layer K/V {'k','v': [L,B,S,KVH,HD]})."""
    x, kv = _trunk(config, params, tokens, positions, return_kv)
    logits = qops.matmul(x, params['lm_head'],
                         preferred_element_type=torch.float32)
    return (logits, kv) if return_kv else logits


def lm_logits(config: LlamaConfig, params: Params,
              hidden: torch.Tensor) -> torch.Tensor:
    """Untied LM head; hidden [..., D] -> fp32 logits [..., V]."""
    del config
    return qops.matmul(hidden, params['lm_head'],
                       preferred_element_type=torch.float32)


def prefill_hidden(config: LlamaConfig, params: Params,
                   tokens: torch.Tensor, true_len
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill trunk returning only the hidden state at true_len-1 →
    (last_hidden [B, D] in model dtype, per-layer KV). The caller does
    the single-row LM-head projection."""
    x, kv = _trunk(config, params, tokens, None, return_kv=True)
    return last_token_hidden(x, true_len), kv


def decode_forward(config: LlamaConfig, params: Params,
                   last_tokens: torch.Tensor, positions: torch.Tensor,
                   kv: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for a batch of slots.

    last_tokens [B], positions [B] (index each new token lands at; at or
    past the cache length means "write nothing"), kv {'k','v':
    [L,B,MAX_LEN,KVH,HD]} (or int8 pairs), updated in place. Returns
    (fp32 logits [B,V], kv).
    """
    c = config
    x = qops.embed_rows(params['embed'], last_tokens[:, None]).to(c.dtype)
    rope = _rope_tables(positions[:, None], c.head_dim, c.rope_theta,
                        c.rope_scaling)
    for layer in range(c.n_layers):
        ck = _cache_layer(kv['k'], layer)
        cv = _cache_layer(kv['v'], layer)
        x, _ = _layer(c, x, _layer_params(params, layer), rope,
                      kv_cache=(ck, cv), cache_positions=positions)
    x = _rms_norm(x, params['final_norm'], c.norm_eps)
    logits = qops.matmul(x, params['lm_head'],
                         preferred_element_type=torch.float32)
    return logits[:, 0], kv


def _cache_layer(entry, layer: int):
    """One layer's view of a cache entry (tensor or int8 pair)."""
    if isinstance(entry, (tuple, list)):
        return (entry[0][layer], entry[1][layer])
    return entry[layer]
