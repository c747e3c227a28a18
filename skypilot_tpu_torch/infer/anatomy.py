"""Per-request anatomy recorder: where a request's lifetime went.

Counterpart of ``skypilot_tpu/infer/anatomy.py``, whole (the port imports
nothing of the reference); the port's orchestrator keeps the same
accumulators on its requests.

The SLO plane (serve/slo.py) can say *that* p99 TTFT burned; this
module says *where one request's time went* — the replica-side half of
the cross-hop waterfall `xsky serve trace` renders. Each finished
orchestrator Request carries phase accumulators maintained by the
orchestrator (pure float adds on the tick path — decode ticks amortize
ONE timestamp pair per fused batch of steps, attributed to the slots
resident that tick, never per token); this module folds them into one
bounded ring record per request.

Phase taxonomy (replica-side; the LB contributes lb_queue and the
relay remainder, see serve/slo.py's join):

  replica_queue   submit → first admission attempt took the request
  admit_deferred  parked in the deferred list waiting for KV headroom
  prefill         admission → first token in the slot cache
  decode          fused decode dispatch + device wait (batch-amortized)
  sampling_commit host commit of device tokens (batch-amortized)
  finish          unattributed remainder (handler wait, polling gaps)

Sealing happens on HTTP handler threads AFTER the request finished —
never inside ``Orchestrator.step`` or its decode tick; the append blocks
on nothing but one short lock. ``XSKY_ANATOMY=0`` disables both the
tick-path accumulators and sealing.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Dict, List, Optional

ENV_ANATOMY = 'XSKY_ANATOMY'
ENV_RING = 'XSKY_ANATOMY_RING_SIZE'

#: Replica-side phases, in waterfall order. The cross-hop join in
#: serve/slo.py prepends lb_queue/relay_connect from the LB record.
PHASES = ('replica_queue', 'admit_deferred', 'prefill', 'decode',
          'sampling_commit', 'finish')


def enabled() -> bool:
    return os.environ.get(ENV_ANATOMY, '1') != '0'


class AnatomyLog:
    """Bounded ring of sealed per-request anatomy records.

    Thread-safe; every mutator is one deque append under a short
    module lock (an infer-module lock, not a control-plane one), so
    record-keeping stays off the relay's and the tick's critical
    paths. Sized by ``XSKY_ANATOMY_RING_SIZE`` (default 2048 — the
    same ring-vs-burn-window sizing note as the LB request ring).
    """

    def __init__(self, maxlen: Optional[int] = None) -> None:
        if maxlen is None:
            try:
                maxlen = int(os.environ.get(ENV_RING, '2048'))
            except ValueError:
                # A typo'd observability knob must not take down the
                # data path it observes (RequestLog posture).
                maxlen = 2048
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, maxlen))

    def seal(self, request: Any, outcome: str = 'ok'
             ) -> Optional[Dict[str, Any]]:
        """Fold a finished orchestrator Request's accumulated phase
        timers into one anatomy record and append it. Returns the
        record (None when the request never got timestamps — e.g.
        submit itself failed). Called from handler threads only."""
        sub = request.submitted_at
        end = request.finished_at
        if not sub or end is None:
            return None
        total = max(0.0, end - sub)
        taken = request.taken_at
        first = request.first_token_at
        deferred = max(0.0, request.deferred_wait)
        replica_queue = max(0.0, (taken if taken is not None
                                  else end) - sub)
        prefill = 0.0
        if taken is not None and first is not None:
            prefill = max(0.0, first - taken - deferred)
        decode = max(0.0, request.decode_s)
        commit = max(0.0, request.commit_s)
        attributed = (replica_queue + deferred + prefill + decode +
                      commit)
        phases = {
            'replica_queue': replica_queue,
            'admit_deferred': deferred,
            'prefill': prefill,
            'decode': decode,
            'sampling_commit': commit,
            'finish': max(0.0, total - attributed),
        }
        rec = {
            'ts': time.time(),
            'request_id': (request.client_request_id
                           or str(request.request_id)),
            'trace_id': request.trace_id,
            'outcome': outcome,
            'total_s': total,
            'prompt_tokens': len(request.prompt_tokens),
            'output_tokens': len(request.output_tokens),
            'kv_headroom_at_admit': request.kv_headroom_at_admit,
            'phases': phases,
        }
        with self._lock:
            self._ring.append(rec)
        return rec

    def records(self, limit: Optional[int] = None,
                request_id: Optional[str] = None
                ) -> List[Dict[str, Any]]:
        """Newest-first copies, optionally filtered to one request id
        (either the LB-minted id or the orchestrator's numeric one)."""
        with self._lock:
            rows = list(self._ring)
        rows.reverse()
        if request_id is not None:
            rows = [r for r in rows if r['request_id'] == request_id]
        if limit is not None:
            rows = rows[:max(0, int(limit))]
        return [dict(r) for r in rows]


_log: Optional[AnatomyLog] = None
_log_lock = threading.Lock()


def get_log() -> AnatomyLog:
    """Process-wide recorder (lazy: the ring-size env is read at first
    use, so tests that set it before serving see it honored)."""
    global _log
    with _log_lock:
        if _log is None:
            _log = AnatomyLog()
        return _log


def reset_for_test() -> None:
    global _log
    with _log_lock:
        _log = None
