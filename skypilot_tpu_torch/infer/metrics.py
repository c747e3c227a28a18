"""Prometheus-format metrics for the inference server.

Counterpart of ``skypilot_tpu/infer/metrics.py`` (the port imports
nothing of the reference): the same metric names and labels, so the
serve controller, autoscaler dashboards and operators scrape a port
replica as they scrape a JAX one.

Exposed at GET /metrics on every replica:
  * xsky_serve_requests_total{endpoint,outcome}
  * xsky_serve_prompt_tokens_total / xsky_serve_generated_tokens_total
  * xsky_serve_ttft_seconds          (histogram)
  * xsky_serve_tpot_seconds          (histogram, inter-token latency)
  * xsky_serve_e2e_latency_seconds   (histogram)
  * xsky_serve_active_slots / xsky_serve_free_slots /
    xsky_serve_queue_depth           (gauges, read live)
  * xsky_serve_kv_pages_total / xsky_serve_kv_pages_free
    (gauges, paged-KV engines only)
  * xsky_serve_wasted_decode_steps_total  (counter: fused decode rows
    burned after a slot finished — legacy tick only, the masked fast
    tick holds it at 0)
  * xsky_serve_phase_seconds{phase=...}   (histogram per anatomy
    phase — replica_queue/admit_deferred/prefill/decode/
    sampling_commit/finish, fed by infer/anatomy.py seals)
  * xsky_serve_kv_headroom_at_admit       (gauge: free/total KV pages
    seen by the most recent successful admission)
  * xsky_serve_deferred_wait_seconds      (gauge: how long the oldest
    currently-deferred request has been parked for KV headroom)
  * xsky_serve_deadline_rejects_total     (counter: requests rejected
    at admit because the relayed SLO deadline could not cover the
    estimated prefill+decode budget)

The serve controller's SLO monitor (serve/slo.py) scrapes this text
each tick: TTFT/TPOT/e2e feed the per-replica latency digests in
`xsky slo`, and TPOT is the replica-side signal behind the
``slo.tpot_p50_ms`` objective (the LB can time bytes but cannot count
tokens).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from skypilot_tpu_torch.agent import telemetry
# The SLO plane's cumulative-bucket histogram, whose render its scrape
# parser round-trips (serve/slo.py).
from skypilot_tpu_torch.serve.slo import Histogram as _Histogram
from skypilot_tpu_torch.serve.slo import fmt_le as _fmt_le

_TTFT_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                 float('inf'))
# Inter-token latency: decode steps are milliseconds on-device but
# 100ms+ when host dispatch dominates — the buckets must resolve both
# regimes.
_TPOT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, float('inf'))
_E2E_BUCKETS = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
                float('inf'))
# Anatomy phases span sub-ms (sampling_commit) to tens of seconds
# (decode totals, deferred waits) — one shared bucket ladder must
# resolve both ends.
_PHASE_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                  5.0, 10.0, 30.0, float('inf'))


class ServeMetrics:
    """Per-replica serving metrics; thread-safe, stdlib-only."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._requests: Dict[Tuple[str, str], int] = {}
        self._prompt_tokens = 0
        self._generated_tokens = 0
        self._ttft = _Histogram(_TTFT_BUCKETS)
        self._tpot = _Histogram(_TPOT_BUCKETS)
        self._e2e = _Histogram(_E2E_BUCKETS)
        self._phase: Dict[str, _Histogram] = {}

    def observe(self, endpoint: str, outcome: str, prompt_tokens: int,
                generated_tokens: int, ttft_s: Optional[float],
                e2e_s: Optional[float],
                tpot_s: Optional[float] = None) -> None:
        with self._lock:
            key = (endpoint, outcome)
            self._requests[key] = self._requests.get(key, 0) + 1
            self._prompt_tokens += prompt_tokens
            self._generated_tokens += generated_tokens
            if ttft_s is not None:
                self._ttft.observe(ttft_s)
            if tpot_s is not None:
                self._tpot.observe(tpot_s)
            if e2e_s is not None:
                self._e2e.observe(e2e_s)
            n_requests = sum(self._requests.values())
        # Workload-telemetry heartbeat: each finished request is
        # progress; generated tokens feed the rank's tokens/s rate. A
        # replica that keeps heartbeating without completing requests
        # shows up hung in `xsky top`, same as a stalled train step.
        telemetry.emit(phase=telemetry.PHASE_STEP, step=n_requests,
                       tokens=generated_tokens)

    def observe_phases(self, phases: Dict[str, float]) -> None:
        """Fold one sealed anatomy record's phase breakdown into the
        per-phase histograms (called off the tick path, by the handler
        thread that sealed the record)."""
        with self._lock:
            for phase, seconds in phases.items():
                hist = self._phase.get(phase)
                if hist is None:
                    hist = self._phase[phase] = _Histogram(
                        _PHASE_BUCKETS)
                hist.observe(seconds)

    def observe_choice_tokens(self, request) -> None:
        """Token accounting for an n>1 sibling choice: its prompt AND
        generated tokens are real device work (each sibling prefills),
        but it is NOT another request — counting it through
        observe_request would inflate request counts and latency
        histograms n-fold."""
        with self._lock:
            self._prompt_tokens += len(request.prompt_tokens)
            self._generated_tokens += len(request.output_tokens)

    def observe_request(self, endpoint: str, request,
                        outcome: Optional[str] = None) -> None:
        """Record a finished orchestrator Request. Pass `outcome`
        explicitly when the handler knows better (a stop-sequence hit
        sets cancel_requested but is a successful 'ok' completion; a
        client disconnect is 'cancelled')."""
        if outcome is None:
            outcome = 'error' if request.error else 'ok'
        ttft = None
        if request.first_token_at is not None:
            ttft = request.first_token_at - request.submitted_at
        e2e = None
        if request.finished_at is not None:
            e2e = request.finished_at - request.submitted_at
        # TPOT (inter-token latency): decode wall time over the tokens
        # it emitted AFTER the first (the first token is prefill and
        # belongs to TTFT). One token has no inter-token gap.
        tpot = None
        n_out = len(request.output_tokens)
        if request.first_token_at is not None and \
                request.finished_at is not None and n_out > 1:
            tpot = max(0.0, request.finished_at -
                       request.first_token_at) / (n_out - 1)
        self.observe(endpoint, outcome, len(request.prompt_tokens),
                     len(request.output_tokens), ttft, e2e,
                     tpot_s=tpot)

    def render(self, orch=None) -> str:
        with self._lock:
            lines = ['# TYPE xsky_serve_requests_total counter']
            for (endpoint, outcome), n in sorted(self._requests.items()):
                lines.append(
                    f'xsky_serve_requests_total{{endpoint="{endpoint}",'
                    f'outcome="{outcome}"}} {n}')
            lines += [
                '# TYPE xsky_serve_prompt_tokens_total counter',
                f'xsky_serve_prompt_tokens_total {self._prompt_tokens}',
                '# TYPE xsky_serve_generated_tokens_total counter',
                f'xsky_serve_generated_tokens_total '
                f'{self._generated_tokens}',
            ]
            lines += self._ttft.render('xsky_serve_ttft_seconds')
            lines += self._tpot.render('xsky_serve_tpot_seconds')
            lines += self._e2e.render('xsky_serve_e2e_latency_seconds')
            if self._phase:
                # Labelled histogram family: slo.Histogram.render is
                # label-free, so the {phase=...} series are laid out
                # by hand — same bucket/sum/count shape the scrape
                # parser round-trips.
                name = 'xsky_serve_phase_seconds'
                lines.append(f'# TYPE {name} histogram')
                for phase in sorted(self._phase):
                    hist = self._phase[phase]
                    for i, le in enumerate(hist.les):
                        lines.append(
                            f'{name}_bucket{{phase="{phase}",'
                            f'le="{_fmt_le(le)}"}} {hist.counts[i]}')
                    lines.append(f'{name}_sum{{phase="{phase}"}} '
                                 f'{hist.total:.6f}')
                    lines.append(f'{name}_count{{phase="{phase}"}} '
                                 f'{hist.n}')
        if orch is not None:
            active = len(orch._slot_req)
            free = len(orch._free_slots)
            lines += [
                '# TYPE xsky_serve_active_slots gauge',
                f'xsky_serve_active_slots {active}',
                '# TYPE xsky_serve_free_slots gauge',
                f'xsky_serve_free_slots {free}',
                '# TYPE xsky_serve_queue_depth gauge',
                f'xsky_serve_queue_depth {orch._pending.qsize()}',
            ]
            headroom = getattr(orch, 'last_admit_kv_headroom', None)
            if headroom is not None:
                lines += [
                    '# TYPE xsky_serve_kv_headroom_at_admit gauge',
                    f'xsky_serve_kv_headroom_at_admit {headroom:.4f}',
                ]
            deferred = list(getattr(orch, '_deferred', None) or [])
            waits = [time.perf_counter() - r.deferred_at
                     for r in deferred
                     if getattr(r, 'deferred_at', None) is not None]
            if waits:
                lines += [
                    '# TYPE xsky_serve_deferred_wait_seconds gauge',
                    f'xsky_serve_deferred_wait_seconds '
                    f'{max(waits):.4f}',
                ]
            rejects = getattr(orch, 'deadline_rejects', None)
            if rejects is not None:
                lines += [
                    '# TYPE xsky_serve_deadline_rejects_total counter',
                    f'xsky_serve_deadline_rejects_total {rejects}',
                ]
            wasted = getattr(orch, 'wasted_decode_steps', None)
            if wasted is not None:
                lines += [
                    '# TYPE xsky_serve_wasted_decode_steps_total '
                    'counter',
                    f'xsky_serve_wasted_decode_steps_total {wasted}',
                ]
            pages = getattr(orch.engine, 'kv_page_stats', None)
            if pages is not None:
                lines += [
                    '# TYPE xsky_serve_kv_pages_total gauge',
                    f"xsky_serve_kv_pages_total {pages['total']}",
                    '# TYPE xsky_serve_kv_pages_free gauge',
                    f"xsky_serve_kv_pages_free {pages['free']}",
                ]
            accept = getattr(orch, 'accept_stats', None)
            if accept is not None:
                lines += [
                    '# TYPE xsky_serve_spec_rounds_total counter',
                    f"xsky_serve_spec_rounds_total {accept['rounds']}",
                    '# TYPE xsky_serve_spec_proposed_total counter',
                    f"xsky_serve_spec_proposed_total "
                    f"{accept['proposed']}",
                    '# TYPE xsky_serve_spec_accepted_total counter',
                    f"xsky_serve_spec_accepted_total "
                    f"{accept['accepted']}",
                ]
            stats = orch.engine.prefix_cache_stats
            if stats is not None:
                lines += [
                    '# TYPE xsky_serve_prefix_cache_hits_total counter',
                    f'xsky_serve_prefix_cache_hits_total '
                    f'{stats["hits"]}',
                    '# TYPE xsky_serve_prefix_cache_misses_total '
                    'counter',
                    f'xsky_serve_prefix_cache_misses_total '
                    f'{stats["misses"]}',
                    '# TYPE xsky_serve_prefix_cache_tokens_reused_total'
                    ' counter',
                    f'xsky_serve_prefix_cache_tokens_reused_total '
                    f'{stats["tokens_reused"]}',
                    '# TYPE xsky_serve_prefix_cache_entries gauge',
                    f'xsky_serve_prefix_cache_entries '
                    f'{stats["entries"]}',
                ]
        return '\n'.join(lines) + '\n'
