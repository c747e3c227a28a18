"""Slot-based inference engine: prefill / insert / decode in PyTorch.

Counterpart of ``skypilot_tpu/infer/engine.py`` for the dense slot cache:

  * A fixed pool of ``max_slots`` decode slots shares one KV cache,
    [L, slots, max_len, KVH, HD] (bf16, fp32, or an int8 values + fp32
    scale pair). The cache and the per-slot state are updated in place.
  * Prefill runs a wave of prompts at one padded bucket length; the wave
    is exactly as many rows as prompts (the JAX engine pads waves to a
    power of two only to bound its compiled variants), and its prefix
    K/V is written into the claimed slots.
  * Decode advances ALL slots one token per step. Inactive slots write
    nothing (their cache write is masked) and their tokens are ignored.

Every method runs on the engine's device under ``torch.no_grad``. The
paged cache, chunked prefill, the prefix cache, speculative
verification and weight quantization come in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import Device, resolve_device
from skypilot_tpu_torch import models
from skypilot_tpu_torch.infer import sampling
from skypilot_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    model: llama.LlamaConfig = dataclasses.field(
        default_factory=lambda: llama.LLAMA3_8B)
    max_slots: int = 8               # concurrent decode sequences
    max_target_len: int = 2048       # prompt + generation budget per slot
    prefill_buckets: Tuple[int, ...] = (128, 256, 512, 1024)
    # bf16 (or fp32), or torch.int8 for a quantized cache (per-head
    # symmetric scales, dequantized inside the decode kernel).
    kv_dtype: torch.dtype = torch.bfloat16

    @property
    def max_prompt_len(self) -> int:
        return self.prefill_buckets[-1]


def _logprobs_info(logits: torch.Tensor, tokens: torch.Tensor, k: int):
    """(chosen_lp [B], top_vals [B, k], top_ids [B, k]) from fp32 logits
    [B, V] and sampled tokens [B]; None when k == 0."""
    if k == 0:
        return None
    logp = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(logp, -1, tokens.long()[:, None])[:, 0]
    top_vals, top_ids = torch.topk(logp, k, dim=-1)
    return chosen, top_vals, top_ids.to(torch.int32)


class InferenceEngine:
    """Owns params + KV cache; exposes prefill/insert/decode."""

    def __init__(self, config: EngineConfig, params: llama.Params,
                 device: Device = None) -> None:
        self.device = resolve_device(device)
        self._model_lib = models.module_for(config.model)
        if config.kv_dtype not in (torch.bfloat16, torch.float32,
                                   torch.int8):
            raise ValueError(f'kv_dtype {config.kv_dtype}: need bf16, '
                             'fp32 or int8')
        self.config = config
        self.params = params
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        c = config.model
        self._cache_shape = (c.n_layers, config.max_slots,
                             config.max_target_len, c.n_kv_heads,
                             c.head_dim)

    # ---- state ----

    @property
    def _kv_quantized(self) -> bool:
        return self.config.kv_dtype == torch.int8

    def _make_cache(self, shape):
        """One cache entry: plain tensor, or (int8, fp32 scale) pair."""
        if not self._kv_quantized:
            return torch.zeros(shape, dtype=self.config.kv_dtype,
                               device=self.device)
        return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                            device=self.device))

    def init_decode_state(self) -> Dict[str, Any]:
        cfg = self.config
        slots = cfg.max_slots
        return {
            'kv_k': self._make_cache(self._cache_shape),
            'kv_v': self._make_cache(self._cache_shape),
            # per-slot: index the NEXT token will be written at
            'lengths': torch.zeros((slots,), dtype=torch.int32,
                                   device=self.device),
            'tokens': torch.zeros((slots,), dtype=torch.int32,
                                  device=self.device),
            'active': torch.zeros((slots,), dtype=torch.bool,
                                  device=self.device),
            # per-slot generated-token counts (uint8 saturating) for the
            # presence / frequency penalties.
            'counts': torch.zeros((slots, cfg.model.vocab_size),
                                  dtype=torch.uint8, device=self.device),
        }

    @property
    def max_admit_len(self) -> int:
        """Longest admissible prompt: the largest prefill bucket (there is
        no chunked prefill yet), leaving one KV row for the first
        generated token."""
        return min(self.config.max_prompt_len,
                   self.config.max_target_len - 1)

    # ---- prefill ----

    def bucket_for(self, length: int) -> int:
        for b in self.config.prefill_buckets:
            if length <= b:
                return b
        raise ValueError(
            f'Prompt length {length} exceeds max prefill bucket '
            f'{self.config.prefill_buckets[-1]}.')

    def _sampling_args(self, temps, top_ks, top_ps):
        """Per-row host arrays → device tensors; disabled filters fold to
        None and an all-greedy batch gets no generator (no noise is
        drawn)."""
        temps = np.asarray(temps, np.float32)
        top_ks = np.asarray(top_ks, np.int32)
        top_ps = np.asarray(top_ps, np.float32)
        dev = self.device
        return (torch.as_tensor(temps, device=dev),
                torch.as_tensor(top_ks, device=dev)
                if (top_ks > 0).any() else None,
                torch.as_tensor(top_ps, device=dev)
                if (top_ps < 1.0).any() else None,
                self._generator if (temps > 0).any() else None)

    @torch.no_grad()
    def _prefill_batch(self, tokens, true_lens, temperature, top_k, top_p,
                       generator, logprobs_k: int = 0):
        """Batched prefill: tokens [B, bucket] (one shared bucket),
        true_lens [B] → (first_tokens [B], kv [L, B, bucket, KVH, HD],
        lp-info-or-None).

        Only the hidden state at true_len-1 goes through the LM head:
        projecting the whole padded bucket would burn bucket × vocab
        products on the time-to-first-token path for one useful row.
        """
        c = self.config.model
        last_hidden, kv = self._model_lib.prefill_hidden(
            c, self.params, tokens, true_lens)
        logits = self._model_lib.lm_logits(c, self.params, last_hidden)
        first_tokens = sampling.sample_batched(logits, generator,
                                               temperature, top_k, top_p)
        return (first_tokens, kv,
                _logprobs_info(logits, first_tokens, logprobs_k))

    def _pad_prompts(self, prompts):
        bucket = self.bucket_for(max(len(p) for p in prompts))
        tokens = np.zeros((len(prompts), bucket), np.int64)
        for i, prompt in enumerate(prompts):
            tokens[i, :len(prompt)] = prompt
        true_lens = np.array([len(p) for p in prompts], np.int64)
        return (torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(true_lens, device=self.device))

    @torch.no_grad()
    def _insert_batch(self, state, kv, first_tokens, true_lens, slots):
        """Write a batched prefill into decode slots (in place): cache
        rows [0, bucket) of each slot from its prefix, the rest zeroed,
        and the slot's length, token, active flag and counts reset."""
        cfg = self.config
        slots = slots.long()
        k = kv['k'][:, :, :cfg.max_target_len]
        v = kv['v'][:, :, :cfg.max_target_len]
        llama.write_cache_slots(state['kv_k'], k, slots)
        llama.write_cache_slots(state['kv_v'], v, slots)
        state['lengths'][slots] = true_lens.to(torch.int32)
        state['tokens'][slots] = first_tokens.to(torch.int32)
        state['active'][slots] = True
        state['counts'][slots] = 0
        state['counts'][slots, first_tokens.long()] = 1
        return state

    def prefill_insert_batch(self, state, requests_args, slots):
        """Admit a wave of requests: one forward + one insert.

        requests_args: list of (prompt_tokens, SamplingParams), all with
        len(prompt) ≤ max_prompt_len; slots: one free slot per request.
        Returns (state, first_tokens host list)."""
        n = len(requests_args)
        if not 0 < n == len(slots) <= self.config.max_slots:
            raise ValueError(f'{n} requests for {len(slots)} slots')
        tokens, true_lens = self._pad_prompts([p for p, _ in requests_args])
        temps, top_k, top_p, gen = self._sampling_args(
            *zip(*[(sp.temperature, sp.top_k, sp.top_p)
                   for _, sp in requests_args]))
        first_tokens, kv, _ = self._prefill_batch(
            tokens, true_lens, temps, top_k, top_p, gen)
        state = self._insert_batch(
            state, kv, first_tokens, true_lens,
            torch.as_tensor(list(slots), device=self.device))
        return state, first_tokens.tolist()

    def prefill(self, prompt_tokens,
                sampling_params: Optional[sampling.SamplingParams] = None,
                logprobs_k: int = 0):
        """Run prefill on one prompt → (first_token, kv, true_len), or
        (first_token, kv, true_len, lp_info) when logprobs_k > 0. The
        single-row case of ``_prefill_batch``; the engine's generator
        draws any sampling noise."""
        sp = sampling_params or sampling.SamplingParams()
        tokens, true_lens = self._pad_prompts([prompt_tokens])
        temps, top_k, top_p, gen = self._sampling_args(
            [sp.temperature], [sp.top_k], [sp.top_p])
        first, kv, lp = self._prefill_batch(tokens, true_lens, temps,
                                            top_k, top_p, gen, logprobs_k)
        if logprobs_k > 0:
            return first[0], kv, len(prompt_tokens), lp
        return first[0], kv, len(prompt_tokens)

    # ---- insert / release ----

    def insert(self, state, kv, first_token, true_len: int, slot: int):
        """Write one prefill prefix into decode slot ``slot`` — the B=1
        case of ``_insert_batch``."""
        dev = self.device
        return self._insert_batch(
            state, kv, torch.as_tensor(first_token, device=dev).reshape(1),
            torch.as_tensor([true_len], device=dev),
            torch.as_tensor([slot], device=dev))

    def release_slot(self, state, slot: int):
        state['active'][slot] = False
        return state

    # ---- decode ----

    @torch.no_grad()
    def _decode_step_impl(self, state, temperatures, top_k, top_p,
                          generator, logprobs_k: int = 0, penalties=None):
        """One step for every slot. Per-slot sampling params [slots]
        (temp 0 → greedy, top_k 0 / top_p 1 → filter off); ``penalties``
        = (presence [slots], frequency [slots]) enables the OpenAI
        repetition penalties. Returns (new_state, (next_tokens, lp))."""
        c = self.config.model
        cap = self.config.max_target_len
        kv = {'k': state['kv_k'], 'v': state['kv_v']}
        # Inactive slots "write" at max_target_len, which the cache write
        # masks out, so a slot finished mid-fused-batch never writes
        # post-EOS KV (the JAX scatter drops it instead).
        write_pos = torch.where(state['active'], state['lengths'], cap)
        logits, new_kv = self._model_lib.decode_forward(
            c, self.params, state['tokens'], write_pos, kv)
        counts = state['counts']
        if penalties is not None:
            presence, frequency = penalties
            cnt = counts.float()
            logits = (logits - presence[:, None] * (cnt > 0)
                      - frequency[:, None] * cnt)
        next_tokens = sampling.sample_batched(logits, generator,
                                              temperatures, top_k, top_p)
        lp = _logprobs_info(logits, next_tokens, logprobs_k)
        if penalties is not None:
            # Saturating add at uint8 max; inactive slots excluded.
            slots_idx = torch.arange(counts.shape[0], device=self.device)
            tok = next_tokens.long()
            cur = counts[slots_idx, tok]
            bump = (state['active'] & (cur < 255)).to(torch.uint8)
            counts[slots_idx, tok] = cur + bump
        new_state = {
            'kv_k': new_kv['k'], 'kv_v': new_kv['v'],
            'lengths': torch.where(
                state['active'],
                (state['lengths'] + 1).clamp(max=cap), state['lengths']),
            'tokens': torch.where(state['active'], next_tokens,
                                  state['tokens']),
            'active': state['active'],
            'counts': counts,
        }
        return new_state, (next_tokens, lp)

    @torch.no_grad()
    def _decode_steps_masked(self, state, temperatures, top_k, top_p,
                             n: int, generator, eos_ids, remaining,
                             logprobs_k: int = 0, penalties=None):
        """n decode steps with DEVICE-SIDE finish detection.

        eos_ids [slots] int32 (< 0 = no EOS for that slot): a slot
        sampling its EOS is deactivated in-loop — the EOS step's row
        comes back with valid=False and later steps neither sample for
        the slot nor write its KV. remaining [slots] int32: token budget,
        decremented per kept token; a slot reaching zero keeps that
        token and deactivates after it. Returns (state, remaining,
        (tokens [n, slots], valid [n, slots], lp)); nothing here waits
        for the device.
        """
        tokens, valid, lps = [], [], []
        for _ in range(n):
            prev_active = state['active']
            state, (next_tokens, lp) = self._decode_step_impl(
                state, temperatures, top_k, top_p, generator, logprobs_k,
                penalties)
            hit_eos = prev_active & (eos_ids >= 0) & (next_tokens == eos_ids)
            keep = prev_active & ~hit_eos
            remaining = remaining - keep.to(remaining.dtype)
            state['active'] = keep & ~(keep & (remaining <= 0))
            tokens.append(next_tokens)
            valid.append(keep)
            lps.append(lp)
        lp = (tuple(torch.stack(parts) for parts in zip(*lps))
              if logprobs_k else None)
        return state, remaining, (torch.stack(tokens), torch.stack(valid),
                                  lp)

    def decode_steps_masked(self, state, n: int, temperatures, top_k,
                            top_p, eos_ids, remaining, generator,
                            logprobs_k: int = 0, penalties=None):
        """Public fused-masked decode → (state, remaining, tokens, valid,
        lp). The sampling tensors are taken as given: the orchestrator
        keeps them on the device and rebuilds them only on admit /
        release."""
        state, remaining, (tokens, valid, lp) = self._decode_steps_masked(
            state, temperatures, top_k, top_p, n, generator, eos_ids,
            remaining, logprobs_k, penalties)
        return state, remaining, tokens, valid, lp

    def decode_step(self, state, temperatures=None, top_k=None,
                    top_p=None, logprobs_k: int = 0, penalties=None):
        """Advance every slot one token. Returns (state, tokens [slots])
        — or (state, tokens, lp) when logprobs_k > 0.

        Per-slot host arrays [max_slots]: temperatures (0 = greedy),
        top_k (0 = off), top_p (1 = off), penalties = (presence,
        frequency) (0 = off); None means disabled for all slots. The
        engine's generator draws any sampling noise.
        """
        slots = self.config.max_slots
        temps, top_k, top_p, gen = self._sampling_args(
            np.zeros(slots) if temperatures is None else temperatures,
            np.zeros(slots) if top_k is None else top_k,
            np.ones(slots) if top_p is None else top_p)
        if penalties is not None:
            penalties = tuple(torch.as_tensor(np.asarray(a, np.float32),
                                              device=self.device)
                              for a in penalties)
        state, (tokens, lp) = self._decode_step_impl(
            state, temps, top_k, top_p, gen, logprobs_k, penalties)
        if logprobs_k > 0:
            return state, tokens, lp
        return state, tokens
