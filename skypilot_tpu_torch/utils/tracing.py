"""Request-scoped tracing for the serving replica: relay headers and spans.

Copy of what ``infer/server.py`` needs from ``skypilot_tpu/utils/
tracing.py`` (the port imports nothing of the reference):

  * :func:`extract_headers` reads the serve load balancer's cross-hop
    context (trace id, LB request id, remaining deadline) off an inbound
    request, so the replica's anatomy records join the LB's;
  * :func:`request_span` opens the root span of a request-scoped trace
    under a trace id minted upstream; the server records each deadline
    rejection as one (the reference journals it in its state DB, which
    the port does not carry);
  * :func:`annotate_append` adds to a list attribute of the current
    span: ``utils/chaos.py`` notes every fault it injects under it.

Finished spans go to a bounded in-process buffer (:func:`recent_spans`),
newest last, under the reference's row layout. Never-raise discipline:
tracing must not take down the path it measures. ``XSKY_TRACING=0``
makes :func:`request_span` return a no-op singleton.
"""
from __future__ import annotations

import collections
import contextvars
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

ENV_TRACING = 'XSKY_TRACING'               # "0" disables

# Cross-hop HTTP propagation (the serve LB → replica relay leg).
HEADER_TRACE_ID = 'X-Xsky-Trace-Id'
HEADER_REQUEST_ID = 'X-Xsky-Request-Id'
# Remaining end-to-end budget in SECONDS at injection time.
HEADER_DEADLINE_S = 'X-Xsky-Deadline-S'

# Spans kept in the in-process buffer.
SPAN_BUFFER = 1024

_ctx: 'contextvars.ContextVar[Any]' = contextvars.ContextVar(
    'xsky_trace', default=None)


def enabled() -> bool:
    return os.environ.get(ENV_TRACING, '1') != '0'


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def extract_headers(headers: Any
                    ) -> Tuple[Optional[str], Optional[str],
                               Optional[float]]:
    """(trace_id, request_id, deadline_s) from an inbound request's
    headers (an ``http.server`` message object or a plain dict). Missing
    or malformed values degrade to None: the replica serves untraced
    requests exactly as before. Never raises."""
    out = (None, None, None)
    try:
        trace_id = headers.get(HEADER_TRACE_ID) or None
        request_id = headers.get(HEADER_REQUEST_ID) or None
        raw = headers.get(HEADER_DEADLINE_S)
        deadline_s = float(raw) if raw else None
        return (trace_id, request_id, deadline_s)
    except Exception:  # pylint: disable=broad-except
        return out


def annotate_append(key: str, value: Any) -> None:
    """Append ``value`` to a list-valued attribute of the current span
    (chaos records every fault injected under the span there). Never
    raises."""
    try:
        cur = _ctx.get()
        if isinstance(cur, Span):
            cur.attrs.setdefault(key, []).append(value)
    except Exception:  # pylint: disable=broad-except
        pass


class _NoopSpan:
    """Singleton returned when tracing is disabled: nothing allocated,
    nothing recorded."""
    __slots__ = ()

    trace_id = None
    span_id = None

    def __enter__(self) -> '_NoopSpan':
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Span:
    """One traced operation. Context manager; records on exit."""

    __slots__ = ('trace_id', 'span_id', 'parent_span_id', 'name',
                 'attrs', 'status', '_start', '_token')

    def __init__(self, name: str, trace_id: str,
                 parent_span_id: Optional[str],
                 attrs: Dict[str, Any]) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_span_id = parent_span_id
        self.attrs = attrs
        self.status = 'OK'
        self._start = 0.0
        self._token = None

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> 'Span':
        self._start = time.time()
        self._token = _ctx.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _ctx.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.status = 'ERROR'
            self.attrs.setdefault('error', f'{exc_type.__name__}: '
                                           f'{str(exc)[:300]}')
        _record({
            'trace_id': self.trace_id, 'span_id': self.span_id,
            'parent_span_id': self.parent_span_id, 'name': self.name,
            'start_ts': self._start, 'end_ts': time.time(),
            'status': self.status, 'attrs': self.attrs or None,
        })
        return False


# ---- span buffer ----

_buffer_lock = threading.Lock()
_buffer: 'collections.deque' = collections.deque(maxlen=SPAN_BUFFER)


def _record(row: Dict[str, Any]) -> None:
    try:
        with _buffer_lock:
            _buffer.append(row)
    except Exception:  # pylint: disable=broad-except
        pass


def recent_spans(trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Copies of the buffered span rows, oldest first, optionally of one
    trace."""
    with _buffer_lock:
        rows = list(_buffer)
    return [dict(r) for r in rows
            if trace_id is None or r['trace_id'] == trace_id]


def request_span(trace_id: Optional[str], name: str, **attrs: Any) -> Any:
    """Root span of a request-scoped trace whose id was minted upstream;
    a fresh trace id when none was. The no-op span when tracing is
    disabled. Never raises."""
    try:
        if not enabled():
            return NOOP_SPAN
        parent = _ctx.get()
        if trace_id is None and isinstance(parent, Span):
            return Span(name, parent.trace_id, parent.span_id, attrs)
        return Span(name, trace_id or new_trace_id(), None, attrs)
    except Exception:  # pylint: disable=broad-except
        return NOOP_SPAN
