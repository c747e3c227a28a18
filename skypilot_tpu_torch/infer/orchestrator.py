"""Continuous-batching orchestrator over the slot engine (PyTorch).

Counterpart of ``skypilot_tpu/infer/orchestrator.py``: a host-side
scheduler where a queue of requests feeds free slots via prefill+insert
and fused decode ticks advance all active slots together, with EOS and
budget finish detection on the device. The host logic (admission,
deadline rejection, wave batching, anatomy accumulators, commit) is the
reference's; the device seams are torch (a device ``torch.Generator`` in
place of the key pool, one host copy per tick).

Chunked prefill, the prefix cache, speculative decoding, the paged
cache's deferral, the profiler and chaos hooks and the legacy tick come
in later slices.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import sampling as sampling_lib

logger = logging.getLogger(__name__)

# Fixed device-side top-k for logprobs-requesting batches (per-request k
# is sliced host-side), matching the OpenAI completions cap.
LOGPROBS_K = 5


@dataclasses.dataclass
class Request:
    prompt_tokens: List[int]
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0               # 0 → disabled
    top_p: float = 1.0           # 1 → disabled
    # 0 = off; 1..LOGPROBS_K = record each generated token's logprob
    # plus that many top alternatives per step:
    logprobs: int = 0
    # OpenAI repetition penalties over this request's GENERATED tokens.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # set by the caller (any thread) to stop generation early; honored
    # at the next token boundary:
    cancel_requested: bool = False
    # filled by the orchestrator:
    request_id: int = -1
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    top_logprobs: List[Dict[int, float]] = dataclasses.field(
        default_factory=list)
    done: bool = False
    error: Optional[str] = None
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # Absolute perf_counter deadline. None = no deadline.
    deadline_at: Optional[float] = None
    # Anatomy phase accumulators (seconds), pure float adds:
    taken_at: Optional[float] = None
    decode_s: float = 0.0
    commit_s: float = 0.0


class Orchestrator:
    """Runs requests to completion with continuous batching."""

    def __init__(self, engine: engine_lib.InferenceEngine,
                 seed: int = 0, decode_steps: int = 1) -> None:
        if decode_steps < 1:
            raise ValueError(f'decode_steps must be >= 1, '
                             f'got {decode_steps}')
        self.engine = engine
        self.state = engine.init_decode_state()
        self._slot_req: Dict[int, Request] = {}
        self._free_slots = list(range(engine.config.max_slots))
        self._pending: 'queue.Queue[Request]' = queue.Queue()
        self._next_id = 0
        self._lock = threading.Lock()
        # The device generator every sampled decode step draws from (the
        # JAX orchestrator's pre-split key pool has no counterpart: a
        # torch generator advances on the device by itself).
        self._generator = torch.Generator(device=engine.device)
        self._generator.manual_seed(seed)
        # > 1 fuses that many decode steps into one tick: the host sees
        # tokens in batches of n, so cancel latency grows by ≤ n-1
        # tokens; EOS and budgets are enforced on the device in-loop.
        self.decode_steps = decode_steps
        self._params_dirty = True
        self._d_temps = None
        self._d_topk = None
        self._d_topp = None
        self._d_pen = None
        self._d_eos = None
        self._d_remaining = None
        self._lp_k = 0
        self._any_sampled = False
        # Deadline admission: requests rejected because their remaining
        # deadline could not cover the estimated prefill+decode budget.
        self.deadline_rejects = 0
        # EWMA budget estimators feeding the deadline gate (seconds).
        self._ewma_prefill_s: Optional[float] = None
        self._ewma_decode_per_token_s: Optional[float] = None

    # ---- submission ----

    def submit(self, request: Request) -> Request:
        with self._lock:
            request.request_id = self._next_id
            self._next_id += 1
        request.submitted_at = time.perf_counter()
        self._pending.put(request)
        return request

    # ---- scheduling ----

    def _finish(self, request: Request, error: Optional[str] = None,
                now: Optional[float] = None) -> None:
        if error is not None:
            request.error = error
        request.done = True
        request.finished_at = time.perf_counter() if now is None else now

    def _validate_admit(self, request: Request) -> bool:
        """Cancel/length checks + KV-budget clamp. False ⇒ the request
        was finished (cancelled/rejected) and must not be admitted."""
        if request.cancel_requested:
            self._finish(request)
            return False
        prompt_len = len(request.prompt_tokens)
        limit = self.engine.max_admit_len
        if prompt_len == 0 or prompt_len > limit:
            self._finish(request,
                         f'Prompt length {prompt_len} outside (0, {limit}].')
            logger.warning('Rejected request %d: %s', request.request_id,
                           request.error)
            return False
        budget = prompt_len + request.max_new_tokens
        if budget > self.engine.config.max_target_len:
            request.max_new_tokens = (self.engine.config.max_target_len -
                                      prompt_len)
        return True

    def _estimated_budget_s(self, request: Request) -> Optional[float]:
        """EWMA estimate of one prefill plus max_new_tokens decode
        steps; None before any sample."""
        p = self._ewma_prefill_s
        d = self._ewma_decode_per_token_s
        if p is None and d is None:
            return None
        est = p or 0.0
        if d is not None:
            est += d * request.max_new_tokens
        return est

    def _deadline_reject(self, request: Request, now: float) -> bool:
        """Deadline admission gate (pure host float math): a request
        whose remaining deadline cannot cover the estimated budget is
        finished here instead of being admitted."""
        if request.deadline_at is None:
            return False
        remaining = request.deadline_at - now
        budget = self._estimated_budget_s(request) or 0.0
        if remaining > budget:
            return False
        self._finish(request,
                     f'deadline exceeded at admit: {remaining * 1e3:.0f} '
                     f'ms remaining < {budget * 1e3:.0f} ms estimated '
                     f'prefill+decode budget', now)
        self.deadline_rejects += 1
        return True

    def _take_request(self) -> Optional[Request]:
        """Next admission candidate; expired-deadline candidates are
        rejected here, at admission time."""
        now = time.perf_counter()
        while True:
            try:
                request = self._pending.get_nowait()
            except queue.Empty:
                return None
            if request.taken_at is None:
                request.taken_at = now
            if not self._deadline_reject(request, now):
                return request

    def _admit_claimed(self, request: Request, slot: int) -> None:
        """Single-request admission into an already-claimed slot."""
        sp = sampling_lib.SamplingParams(
            temperature=request.temperature, top_k=request.top_k,
            top_p=request.top_p)
        lp_k = LOGPROBS_K if request.logprobs else 0
        out = self.engine.prefill(request.prompt_tokens, sampling_params=sp,
                                  logprobs_k=lp_k)
        if request.logprobs:
            first_token, kv, true_len, lp = out
            self._record_logprobs(request, lp, row=0)
        else:
            first_token, kv, true_len = out
        self.state = self.engine.insert(self.state, kv, first_token,
                                        true_len, slot)
        self._post_insert(slot, request, int(first_token))

    def _admit_wave(self) -> None:
        """Admit pending requests, batching same-bucket prefills into one
        forward + one insert per bucket group. Logprobs requests take
        the single path (their first token's logprobs come back with
        it)."""
        batch: List = []       # (request, claimed slot)
        while self._free_slots:
            request = self._take_request()
            if request is None:
                break
            if not self._validate_admit(request):
                continue
            slot = self._free_slots.pop()
            if not request.logprobs:
                batch.append((request, slot))
            else:
                self._admit_claimed(request, slot)
        groups: Dict[int, List] = {}
        for request, slot in batch:
            bucket = self.engine.bucket_for(len(request.prompt_tokens))
            groups.setdefault(bucket, []).append((request, slot))
        for group in groups.values():
            if len(group) == 1:
                self._admit_claimed(*group[0])
                continue
            args = [(r.prompt_tokens, sampling_lib.SamplingParams(
                temperature=r.temperature, top_k=r.top_k,
                top_p=r.top_p)) for r, _ in group]
            slots = [s for _, s in group]
            try:
                self.state, first_tokens = \
                    self.engine.prefill_insert_batch(self.state, args,
                                                     slots)
            except Exception as e:  # pylint: disable=broad-except
                # Fail the group and restore its claimed slots: a
                # raising prefill must not shrink the slot pool.
                logger.exception('Batched prefill failed for %d '
                                 'requests', len(group))
                for request, slot in group:
                    self._finish(request, f'Prefill failed: {e}')
                    self._free_slots.append(slot)
                continue
            for (request, slot), token in zip(group, first_tokens):
                self._post_insert(slot, request, token)

    def _post_insert(self, slot: int, request: Request,
                     first_token: int) -> None:
        """Host-side bookkeeping once a prefill is in the slot cache."""
        request.output_tokens.append(int(first_token))
        request.first_token_at = time.perf_counter()
        if request.taken_at is not None:
            sample = max(0.0, request.first_token_at - request.taken_at)
            prev = self._ewma_prefill_s
            self._ewma_prefill_s = (sample if prev is None
                                    else 0.8 * prev + 0.2 * sample)
        self._slot_req[slot] = request
        self._params_dirty = True
        self._maybe_finish(slot, int(first_token))

    def _record_logprobs(self, request: Request, lp, row) -> None:
        """Append one generated token's logprob + top-k alternatives.
        lp = (chosen, top_vals, top_ids) tensors or arrays; `row`
        indexes the batch dim (0 for prefill, the slot for decode)."""
        chosen, vals, ids = (np.asarray(torch.as_tensor(a).cpu())
                             for a in lp)
        k = min(request.logprobs, vals.shape[-1])
        request.token_logprobs.append(float(chosen[row]))
        request.top_logprobs.append(
            {int(t): float(v)
             for t, v in zip(ids[row][:k], vals[row][:k])})

    def _release(self, slot: int, now: Optional[float] = None,
                 error: Optional[str] = None) -> None:
        request = self._slot_req.pop(slot)
        self._finish(request, error, now)
        self.state = self.engine.release_slot(self.state, slot)
        self._free_slots.append(slot)
        self._params_dirty = True

    def _maybe_finish(self, slot: int, token: int) -> None:
        """Finish check for a prefill's first token (decode rows are
        finished on the device)."""
        request = self._slot_req[slot]
        hit_eos = (request.eos_token_id is not None and
                   token == request.eos_token_id)
        exhausted = len(request.output_tokens) >= request.max_new_tokens
        if hit_eos or exhausted or request.cancel_requested:
            if hit_eos:
                request.output_tokens.pop()
                if request.token_logprobs:
                    request.token_logprobs.pop()
                    request.top_logprobs.pop()
            self._release(slot)

    def step(self) -> None:
        """One scheduler tick: admit while possible, then decode."""
        self._admit_wave()
        self._decode_tick_fast()

    def _attribute_tick(self, residents: List[Request], decode_share: float,
                        commit_share: float, tokens: int) -> None:
        """Fold one fused batch's decode/commit wall time into the
        resident requests' anatomy accumulators (one timestamp pair per
        tick) and feed the per-token decode EWMA of the deadline gate."""
        for request in residents:
            request.decode_s += decode_share
            request.commit_s += commit_share
        if tokens > 0:
            sample = (decode_share + commit_share) / tokens
            prev = self._ewma_decode_per_token_s
            self._ewma_decode_per_token_s = (
                sample if prev is None else 0.8 * prev + 0.2 * sample)

    # ---- decode tick: device-resident params + device-side finish ----

    def _rebuild_device_params(self) -> None:
        """Push the per-slot sampling/finish params to the device — only
        when occupancy changed (admit/release), not per tick."""
        slots = self.engine.config.max_slots
        temps = np.zeros((slots,), np.float32)
        top_k = np.zeros((slots,), np.int32)
        top_p = np.ones((slots,), np.float32)
        pres = np.zeros((slots,), np.float32)
        freq = np.zeros((slots,), np.float32)
        eos = np.full((slots,), -1, np.int32)
        remaining = np.zeros((slots,), np.int32)
        need_lp = False
        for slot, r in self._slot_req.items():
            temps[slot] = r.temperature
            top_k[slot] = r.top_k
            top_p[slot] = r.top_p
            pres[slot] = r.presence_penalty
            freq[slot] = r.frequency_penalty
            if r.eos_token_id is not None:
                eos[slot] = r.eos_token_id
            remaining[slot] = max(
                r.max_new_tokens - len(r.output_tokens), 0)
            need_lp = need_lp or bool(r.logprobs)
        dev = self.engine.device

        def put(a):
            return torch.as_tensor(a, device=dev)

        self._d_temps = put(temps)
        # Disabled filters fold to None here, on the dirty tick, so the
        # steady-state tick skips the [slots, vocab] sorts entirely.
        self._d_topk = put(top_k) if (top_k > 0).any() else None
        self._d_topp = put(top_p) if (top_p < 1.0).any() else None
        self._d_pen = ((put(pres), put(freq))
                       if (pres.any() or freq.any()) else None)
        self._d_eos = put(eos)
        self._d_remaining = put(remaining)
        self._lp_k = LOGPROBS_K if need_lp else 0
        self._any_sampled = bool((temps > 0).any())
        self._params_dirty = False

    def _next_keys(self) -> Optional[torch.Generator]:
        """The randomness for the next fused steps: the orchestrator's
        device generator when any resident samples, else None (an
        all-greedy tick draws no noise at all)."""
        return self._generator if self._any_sampled else None

    def _decode_tick_fast(self) -> None:
        """Fused masked decode tick: one engine call runs decode_steps
        steps with EOS/budget masking on the device; one host copy brings
        back (tokens, valid[, logprobs]) and the host commits only rows
        the mask kept."""
        if not self._slot_req:
            return
        t_tick = time.perf_counter()
        residents = list(self._slot_req.values())
        if self._params_dirty:
            self._rebuild_device_params()
        n = self.decode_steps
        out = self.engine.decode_steps_masked(
            self.state, n, self._d_temps, self._d_topk, self._d_topp,
            self._d_eos, self._d_remaining, self._next_keys(),
            logprobs_k=self._lp_k, penalties=self._d_pen)
        self.state, self._d_remaining, tokens, valid, lp = out
        tokens_np = tokens.cpu().numpy()
        valid_np = valid.cpu().numpy()
        lp_np = (tuple(a.cpu().numpy() for a in lp) if self._lp_k
                 else None)
        now = time.perf_counter()
        committed = 0
        for slot in list(self._slot_req):
            request = self._slot_req[slot]
            vm = valid_np[:, slot]
            emitted_before = len(request.output_tokens)
            for i in range(n):
                if not vm[i]:
                    break
                request.output_tokens.append(int(tokens_np[i, slot]))
                if self._lp_k and request.logprobs:
                    self._record_logprobs(
                        request,
                        (lp_np[0][i], lp_np[1][i], lp_np[2][i]), slot)
            committed += len(request.output_tokens) - emitted_before
            # An invalid row means the device deactivated the slot (EOS,
            # never emitted, or budget exhaustion after the last row).
            if (not vm.all()
                    or len(request.output_tokens) >= request.max_new_tokens
                    or request.cancel_requested):
                self._release(slot, now)
        self._attribute_tick(residents, max(0.0, now - t_tick),
                             max(0.0, time.perf_counter() - now), committed)

    def fail_all(self, error: str) -> None:
        """Finish every active and pending request with `error` and free
        their slots — never hand back silently-truncated outputs."""
        for slot in list(self._slot_req):
            self._release(slot, error=error)
        while True:
            try:
                request = self._pending.get_nowait()
            except queue.Empty:
                break
            self._finish(request, error)

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        steps = 0
        while (self._slot_req or not self._pending.empty()) and (
                steps < max_steps):
            self.step()
            steps += 1
        if self._slot_req or not self._pending.empty():
            logger.warning('run_until_drained hit max_steps=%d with %d '
                           'active and ~%d pending requests.', max_steps,
                           len(self._slot_req), self._pending.qsize())
            self.fail_all(f'Truncated at max_steps={max_steps}.')

    # ---- convenience ----

    def generate(self, prompts: List[List[int]],
                 max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0) -> List[List[int]]:
        requests = [
            self.submit(Request(prompt_tokens=p,
                                max_new_tokens=max_new_tokens,
                                eos_token_id=eos_token_id,
                                temperature=temperature))
            for p in prompts
        ]
        self.run_until_drained()
        return [r.output_tokens for r in requests]

    def benchmark(self, prompts: List[List[int]],
                  max_new_tokens: int = 64) -> Dict[str, Any]:
        """Throughput numbers in JetStream's terms (host clock; the
        engine's outputs are on the host by the time the run drains)."""
        t0 = time.perf_counter()
        requests = [self.submit(Request(prompt_tokens=p,
                                        max_new_tokens=max_new_tokens))
                    for p in prompts]
        self.run_until_drained()
        dt = time.perf_counter() - t0
        in_tokens = sum(len(p) for p in prompts)
        out_tokens = sum(len(r.output_tokens) for r in requests)
        ttfts = [r.first_token_at - r.submitted_at for r in requests
                 if r.first_token_at is not None]
        return {
            'duration_s': dt,
            'request_throughput_rps': len(prompts) / dt,
            'input_token_throughput_tps': in_tokens / dt,
            'output_token_throughput_tps': out_tokens / dt,
            'mean_ttft_s': float(np.mean(ttfts)) if ttfts else 0.0,
        }
