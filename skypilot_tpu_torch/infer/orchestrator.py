"""Continuous-batching orchestrator over the slot engine (PyTorch).

Counterpart of ``skypilot_tpu/infer/orchestrator.py``: a host-side
scheduler where a queue of requests feeds free slots via prefill+insert
and fused decode ticks advance all active slots together, with EOS and
budget finish detection on the device. The host logic (admission,
deadline rejection, wave batching, anatomy accumulators, commit) is the
reference's; the device seams are torch (a device ``torch.Generator`` in
place of the key pool, one host copy per tick). Long prompts run their
chunked prefill one chunk per tick between decode ticks; on a paged
engine a request that finds no free pages is deferred and retried ahead
of the queue.

Speculative decoding: ``SpeculativeOrchestrator`` (a draft engine
proposes γ tokens per slot) and ``NgramSpeculator`` (prompt lookup)
verify the proposals in one target pass (``engine.verify_step``), with
greedy acceptance, so the output equals plain greedy decoding.

The profiler and chaos hooks and the legacy tick come in later slices.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

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
    # Cross-hop trace context, set by the serving handler from the
    # X-Xsky-* relay headers before submit (None for direct callers):
    trace_id: Optional[str] = None
    client_request_id: Optional[str] = None
    # Absolute perf_counter deadline. None = no deadline.
    deadline_at: Optional[float] = None
    # Anatomy phase accumulators (seconds), pure float adds:
    taken_at: Optional[float] = None
    deferred_at: Optional[float] = None
    deferred_wait: float = 0.0
    decode_s: float = 0.0
    commit_s: float = 0.0
    kv_headroom_at_admit: Optional[float] = None


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
        # Long prompts run their chunked prefill interleaved with decode
        # (see _advance_partials); slot → (request, ChunkedPrefill) for
        # admissions mid-prefill, with a per-tick chunk budget so
        # concurrent long prompts cannot multiply running streams'
        # inter-token latency.
        self.interleave_prefill = True
        self.prefill_chunks_per_tick = 1
        self._partials: Dict[int, Any] = {}
        # Requests that passed validation but found no KV-page headroom
        # (paged engines): retried ahead of the queue next tick.
        self._deferred: List[Request] = []
        # KV free-page fraction observed at the last successful admit
        # (paged engines).
        self.last_admit_kv_headroom: Optional[float] = None
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
        # Fused decode rows burned after a slot finished: the masked tick
        # burns none, so this stays 0 (the reference counts them on its
        # legacy tick; /metrics exports it).
        self.wasted_decode_steps = 0
        # Per-request anatomy: when on, ticks amortize one timestamp pair
        # over the resident requests (infer/anatomy.py seals them);
        # XSKY_ANATOMY=0 turns the accumulators off.
        self._anatomy = os.environ.get('XSKY_ANATOMY', '1') != '0'
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

    def _admit_limit(self) -> int:
        return self.engine.max_admit_len

    def _validate_admit(self, request: Request) -> bool:
        """Cancel/length checks + KV-budget clamp. False ⇒ the request
        was finished (cancelled/rejected) and must not be admitted."""
        if request.cancel_requested:
            self._finish(request)
            return False
        prompt_len = len(request.prompt_tokens)
        # The prompt must leave room for at least one generated token in
        # the per-slot KV budget; families with a chunked-prefill path
        # admit beyond the largest bucket (engine.max_admit_len).
        limit = self._admit_limit()
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
        if not self.engine.kv_admissible(prompt_len,
                                         request.max_new_tokens):
            # Paged engine whose whole arena cannot hold this budget:
            # deferring would deadlock the drain loop, so reject.
            self._finish(
                request,
                f'Request KV budget {prompt_len + request.max_new_tokens}'
                f' tokens exceeds the paged-cache capacity.')
            logger.warning('Rejected request %d: %s', request.request_id,
                           request.error)
            return False
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
        """Next admission candidate: headroom-deferred requests retry
        ahead of the queue (FIFO within each). Expired-deadline
        candidates are rejected here, at admission time."""
        now = time.perf_counter()
        while self._deferred:
            request = self._deferred.pop(0)
            if request.deferred_at is not None:
                request.deferred_wait += now - request.deferred_at
                request.deferred_at = None
            if self._deadline_reject(request, now):
                continue
            return request
        while True:
            try:
                request = self._pending.get_nowait()
            except queue.Empty:
                return None
            if request.taken_at is None:
                request.taken_at = now
            if not self._deadline_reject(request, now):
                return request

    def _reserve_or_defer(self, request: Request, slot: int) -> bool:
        """Reserve KV capacity for the request's full budget against the
        claimed slot. On a paged engine with no page headroom the slot
        goes back, the request parks in the deferred list, and the
        caller stops admitting this tick (headroom only appears when a
        running stream finishes)."""
        if self.engine.reserve_kv(slot, len(request.prompt_tokens),
                                  request.max_new_tokens):
            pages = self.engine.kv_page_stats
            if self._anatomy and pages and pages.get('total'):
                headroom = pages['free'] / pages['total']
                request.kv_headroom_at_admit = headroom
                self.last_admit_kv_headroom = headroom
            return True
        self._free_slots.append(slot)
        if request.deferred_at is None:
            request.deferred_at = time.perf_counter()
        self._deferred.append(request)
        return False

    def _admit_claimed(self, request: Request, slot: int) -> None:
        """Single-request admission into an already-claimed slot."""
        prompt_len = len(request.prompt_tokens)
        sp = sampling_lib.SamplingParams(
            temperature=request.temperature, top_k=request.top_k,
            top_p=request.top_p)
        lp_k = LOGPROBS_K if request.logprobs else 0
        if (self.interleave_prefill
                and prompt_len > self.engine.config.max_prompt_len
                and self.engine.supports_chunked_prefill):
            # Long prompt: claim the slot but run its prefill one chunk
            # per tick interleaved with decode, so running streams keep
            # emitting instead of stalling for the whole multi-chunk
            # prefill.
            self._partials[slot] = (
                request, self.engine.start_chunked_prefill(
                    request.prompt_tokens, sp, lp_k))
            return
        # prefill_any == prefill for in-bucket prompts with no cached
        # prefix; beyond that it chunks and reuses cached prefixes.
        out = self.engine.prefill_any(request.prompt_tokens,
                                      sampling_params=sp, logprobs_k=lp_k)
        self._finish_admit(slot, request, out)

    def _admit_one(self) -> bool:
        """Prefill + insert one pending request into a free slot."""
        if not self._free_slots:
            return False
        request = self._take_request()
        if request is None:
            return False
        if not self._validate_admit(request):
            return True
        slot = self._free_slots.pop()
        if not self._reserve_or_defer(request, slot):
            return False   # no KV headroom: stop admitting this tick
        self._admit_claimed(request, slot)
        return True

    #: Subclasses with per-request admission hooks (speculation mirrors
    #: each prefill into a draft cache) keep the single path.
    _batched_admit = True

    def _admit_wave(self) -> None:
        """Admit pending requests, batching same-bucket prefills into one
        forward + one insert per bucket group. Logprobs requests, long
        prompts (chunked path), prefix-cached engines, engines built
        without batched admission and speculators take the single
        path."""
        if not (self._batched_admit
                and self.engine.config.batched_admission
                and self.engine.supports_batched_prefill):
            while self._admit_one():
                pass
            return
        batch: List = []       # (request, claimed slot)
        while self._free_slots:
            request = self._take_request()
            if request is None:
                break
            if not self._validate_admit(request):
                continue
            slot = self._free_slots.pop()
            if not self._reserve_or_defer(request, slot):
                break      # no KV headroom: stop admitting this tick
            if (not request.logprobs
                    and len(request.prompt_tokens)
                    <= self.engine.config.max_prompt_len):
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
                # Fail the group and restore its claimed slots and KV
                # reservations: a raising prefill must not shrink the
                # slot pool.
                logger.exception('Batched prefill failed for %d '
                                 'requests', len(group))
                for request, slot in group:
                    self._finish(request, f'Prefill failed: {e}')
                    self.engine.release_kv(slot)
                    self._free_slots.append(slot)
                continue
            for (request, slot), token in zip(group, first_tokens):
                self._post_insert(slot, request, token)

    def _finish_admit(self, slot: int, request: Request, out) -> None:
        if request.logprobs:
            first_token, kv, true_len, lp = out
            self._record_logprobs(request, lp, row=0)
        else:
            first_token, kv, true_len = out
        self.state = self.engine.insert(self.state, kv, first_token,
                                        true_len, slot)
        self._post_insert(slot, request, int(first_token))

    def _post_insert(self, slot: int, request: Request,
                     first_token: int) -> None:
        """Host-side bookkeeping once a prefill is in the slot cache."""
        request.output_tokens.append(int(first_token))
        request.first_token_at = time.perf_counter()
        if request.taken_at is not None:
            # Take → first token, minus any headroom-deferred wait.
            sample = max(0.0, request.first_token_at - request.taken_at
                         - request.deferred_wait)
            prev = self._ewma_prefill_s
            self._ewma_prefill_s = (sample if prev is None
                                    else 0.8 * prev + 0.2 * sample)
        self._slot_req[slot] = request
        self._params_dirty = True
        self._maybe_finish(slot, int(first_token))

    def _advance_partials(self) -> None:
        """Advance in-flight chunked admissions, oldest first, up to
        prefill_chunks_per_tick chunks total: the budget bounds how much
        prefill work can delay each decode wave; on a request's last
        chunk it joins the decode batch this tick. Cancelled partials
        are always reaped regardless of budget."""
        budget = self.prefill_chunks_per_tick
        for slot in list(self._partials):
            request, cp = self._partials[slot]
            if request.cancel_requested:
                del self._partials[slot]
                # The claimed slot's KV reservation goes back too: the
                # slot never reached release_slot (nothing inserted).
                self.engine.release_kv(slot)
                self._free_slots.append(slot)
                self._finish(request)
                continue
            if budget <= 0:
                continue
            budget -= 1
            if cp.step():
                del self._partials[slot]
                self._finish_admit(slot, request, cp.finalize())

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
        """One scheduler tick: admit while possible (batching
        same-bucket prefills), advance in-flight chunked prefills by one
        chunk, then decode."""
        self._admit_wave()
        self._advance_partials()
        self._decode_tick()

    def _decode_tick(self) -> None:
        """The decode half of a tick: the speculators' plain rounds call
        it directly, so admission and the partials budget run once per
        tick."""
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
        anatomy = self._anatomy
        t_tick = time.perf_counter() if anatomy else 0.0
        residents = list(self._slot_req.values()) if anatomy else None
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
        if anatomy:
            self._attribute_tick(residents, max(0.0, now - t_tick),
                                 max(0.0, time.perf_counter() - now),
                                 committed)

    def _verify_round(self, active_before: Dict[int, Request],
                      proposals) -> None:
        """One greedy verify pass over [slots, γ] proposals: append the
        accepted tokens and the bonus per slot and update accept_stats
        (the speculators own that dict). The round's one host copy brings
        back emitted and n_emitted together."""
        gamma = proposals.shape[1]
        self.state, emitted, n_emitted = self.engine.verify_step(
            self.state, proposals)
        both = torch.cat([emitted, n_emitted[:, None]], dim=1).cpu().numpy()
        emitted, n_emitted = both[:, :-1], both[:, -1]
        for slot, request in active_before.items():
            for i in range(int(n_emitted[slot])):
                if slot not in self._slot_req:
                    break  # finished mid-round: drop the tail
                request.output_tokens.append(int(emitted[slot, i]))
                self._maybe_finish(slot, int(emitted[slot, i]))
        self.accept_stats['rounds'] += 1
        self.accept_stats['proposed'] += gamma * len(active_before)
        self.accept_stats['accepted'] += int(
            sum(n_emitted[s] - 1 for s in active_before))

    def fail_all(self, error: str) -> None:
        """Finish every active and pending request with `error` and free
        their slots — never hand back silently-truncated outputs."""
        for slot in list(self._partials):
            request, _ = self._partials.pop(slot)
            self._finish(request, error)
            self.engine.release_kv(slot)
            self._free_slots.append(slot)
        for request in self._deferred:
            self._finish(request, error)
        self._deferred.clear()
        for slot in list(self._slot_req):
            self._release(slot, error=error)
        while True:
            try:
                request = self._pending.get_nowait()
            except queue.Empty:
                break
            self._finish(request, error)

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        def busy() -> bool:
            return bool(self._slot_req or self._partials or self._deferred
                        or not self._pending.empty())

        steps = 0
        while busy() and steps < max_steps:
            self.step()
            steps += 1
        if busy():
            logger.warning('run_until_drained hit max_steps=%d with %d '
                           'active, %d mid-prefill, %d deferred and ~%d '
                           'pending requests.', max_steps,
                           len(self._slot_req), len(self._partials),
                           len(self._deferred), self._pending.qsize())
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


def _all_greedy(requests) -> bool:
    """Whether a speculative round may run: every resident is greedy,
    wants no logprobs (verify_forward surfaces none) and is not penalized
    (only plain rounds update the penalty counts)."""
    return all(r.temperature == 0.0 and not r.logprobs
               and not r.presence_penalty and not r.frequency_penalty
               for r in requests)


class SpeculativeOrchestrator(Orchestrator):
    """Continuous batching with draft-model speculative decoding.

    A small draft engine proposes γ tokens per slot (γ+1 cheap decode
    steps); the target engine verifies them in ONE multi-token pass
    (engine.verify_step), so the target's weights stream from memory once
    per round instead of once per token. Greedy acceptance keeps outputs
    equal to plain greedy decoding whatever the draft; a bad draft only
    lowers the accepted-token rate (``accept_stats``).

    Speculation applies to rounds where every active slot is greedy.
    Mixed batches fall back to plain per-token decoding for that round;
    the draft's bookkeeping is re-synced each round either way, and a
    stale draft cache can only cost acceptance, never correctness.
    """

    # Admission mirrors every prefill into the draft cache per request
    # (_finish_admit hook): keep the single path.
    _batched_admit = False

    def __init__(self, engine: engine_lib.InferenceEngine,
                 draft_engine: engine_lib.InferenceEngine,
                 gamma: int = 4, seed: int = 0) -> None:
        if draft_engine.config.max_slots != engine.config.max_slots:
            raise ValueError('draft/target max_slots must match')
        if draft_engine.config.max_target_len != \
                engine.config.max_target_len:
            raise ValueError('draft/target max_target_len must match')
        if draft_engine.config.model.vocab_size != \
                engine.config.model.vocab_size:
            raise ValueError('draft/target vocab_size must match')
        if gamma < 1:
            raise ValueError(f'gamma must be >= 1, got {gamma}')
        if not engine.supports_verify:
            raise NotImplementedError(
                'target model family has no verify_forward')
        super().__init__(engine, seed)
        self.draft = draft_engine
        self.draft_state = draft_engine.init_decode_state()
        self.gamma = gamma
        self.accept_stats = {'rounds': 0, 'proposed': 0, 'accepted': 0}
        # slot → (request, ChunkedPrefill) for draft mirrors of long
        # prompts still prefilling (see _advance_draft_partials).
        self._draft_partials: Dict[int, Any] = {}

    def _admit_limit(self) -> int:
        # Both engines prefill every admitted prompt, so the admit gate
        # is the tighter of the two.
        return min(self.engine.max_admit_len, self.draft.max_admit_len)

    def _insert_draft(self, slot: int, request: Request, out) -> None:
        """Write a draft prefill into the draft cache; the draft chain
        continues from the TARGET's first token."""
        _, draft_kv, true_len = out
        self.draft_state = self.draft.insert(
            self.draft_state, draft_kv,
            np.int32(request.output_tokens[-1]), true_len, slot)

    def _finish_admit(self, slot, request, out) -> None:
        # Mirror every completed admission (direct or interleaved
        # chunked) into the draft cache, so its proposals have context.
        super()._finish_admit(slot, request, out)
        if slot not in self._slot_req:
            return   # finished during admit (EOS or budget on token one)
        if (len(request.prompt_tokens) > self.draft.config.max_prompt_len
                and self.draft.supports_chunked_prefill):
            # A long prompt's draft prefill is chunked and budgeted
            # across ticks too; until it lands, rounds fall back to plain
            # decoding (the late mirror costs acceptance only).
            self._draft_partials[slot] = (
                request, self.draft.start_chunked_prefill(
                    request.prompt_tokens))
            return
        self._insert_draft(slot, request,
                           self.draft.prefill_any(request.prompt_tokens))

    def _advance_draft_partials(self) -> None:
        budget = self.prefill_chunks_per_tick
        for slot in list(self._draft_partials):
            request, cp = self._draft_partials[slot]
            # Identity check, not just occupancy: if the owning request
            # finished and the slot was re-admitted in the same tick, a
            # stale partial's finalize() would overwrite the NEW
            # request's draft cache with the old prompt's KV.
            if request.done or self._slot_req.get(slot) is not request:
                del self._draft_partials[slot]
                continue
            if budget <= 0:
                continue
            budget -= 1
            if cp.step():
                del self._draft_partials[slot]
                self._insert_draft(slot, request, cp.finalize())
                # Bookkeeping catches up to the target's frontier; the
                # generated tokens' draft rows stay absent (acceptance
                # cost only).
                self.draft_state = self.draft.sync_slots_from(
                    self.draft_state, self.state)

    def step(self) -> None:
        while self._admit_one():
            pass
        self._advance_partials()
        self._advance_draft_partials()
        if not self._slot_req:
            return
        if not _all_greedy(self._slot_req.values()) or self._draft_partials:
            # Plain round; the draft's bookkeeping stays aligned (its
            # cache rows for these tokens are missing: acceptance pays,
            # not correctness).
            self._decode_tick()
            self.draft_state = self.draft.sync_slots_from(
                self.draft_state, self.state)
            return
        active_before = dict(self._slot_req)
        # γ draft proposals (+1 ingest step, so that a fully accepted
        # round leaves no hole in the draft cache), all greedy; they stay
        # on the device, so the round's only host sync is the verify's.
        proposals = []
        for _ in range(self.gamma):
            self.draft_state, toks = self.draft.decode_step(
                self.draft_state)
            proposals.append(toks)
        self.draft_state, _ = self.draft.decode_step(self.draft_state)
        self._verify_round(active_before, torch.stack(proposals, dim=1))
        # The draft follows the target's accepted frontier.
        self.draft_state = self.draft.sync_slots_from(
            self.draft_state, self.state)


class NgramSpeculator(Orchestrator):
    """Draft-model-free speculation: prompt-lookup (n-gram) proposals.

    The last ``match_len`` tokens of each slot's history (prompt +
    generated so far) are matched against their most recent earlier
    occurrence in that history; the γ tokens that followed it become the
    proposals, verified in ONE multi-token target pass
    (engine.verify_step) as in draft-model speculation. A failed lookup
    only wastes the round's extra verify columns. Wins on copy-heavy
    generation (quoting the prompt, code, RAG answers) with no second
    model and no extra memory.
    """

    # Keep per-request admission: gram indexes key off request state at
    # admit time.
    _batched_admit = False

    def __init__(self, engine: engine_lib.InferenceEngine,
                 gamma: int = 4, match_len: int = 2,
                 seed: int = 0) -> None:
        if gamma < 1:
            raise ValueError(f'gamma must be >= 1, got {gamma}')
        if match_len < 1:
            raise ValueError(f'match_len must be >= 1, got {match_len}')
        if not engine.supports_verify:
            raise NotImplementedError(
                'target model family has no verify_forward')
        super().__init__(engine, seed)
        self.gamma = gamma
        self.match_len = match_len
        self.accept_stats = {'rounds': 0, 'proposed': 0, 'accepted': 0}
        # slot → (request_id, gram → most recent start, tokens indexed so
        # far): maintained incrementally, so a round's lookup costs the
        # new tokens only. Keyed by request_id, so a slot reused by a new
        # request never inherits a stale index.
        self._grams: Dict[int, Tuple[int, Dict[tuple, int], int]] = {}

    def _propose(self, slot: int, request: Request) -> List[int]:
        """γ proposals from the most recent earlier occurrence of the
        history's trailing match_len-gram; repeats of the last token when
        nothing matches (wrong proposals cost only acceptance)."""
        history = request.prompt_tokens + request.output_tokens
        k = self.match_len
        fallback = [history[-1]] * self.gamma
        if len(history) <= k:
            return fallback
        entry = self._grams.get(slot)
        if entry is None or entry[0] != request.request_id:
            entry = (request.request_id, {}, 0)
        _, index, upto = entry
        # Index every gram STARTING before the trailing one (the trailing
        # gram itself must not match in place).
        for j in range(upto, len(history) - k):
            index[tuple(history[j:j + k])] = j
        self._grams[slot] = (request.request_id, index, len(history) - k)
        j = index.get(tuple(history[-k:]))
        if j is None:
            return fallback
        return (history[j + k:j + k + self.gamma] + fallback)[:self.gamma]

    def step(self) -> None:
        while self._admit_one():
            pass
        self._advance_partials()
        # Drop the gram indexes of released slots (memory hygiene; the
        # request_id key already prevents staleness).
        for slot in list(self._grams):
            if slot not in self._slot_req:
                del self._grams[slot]
        if not self._slot_req:
            return
        if not _all_greedy(self._slot_req.values()):
            self._decode_tick()
            return
        active_before = dict(self._slot_req)
        proposals = np.zeros((self.engine.config.max_slots, self.gamma),
                             np.int32)
        for slot, request in active_before.items():
            proposals[slot] = self._propose(slot, request)
        self._verify_round(active_before, proposals)
