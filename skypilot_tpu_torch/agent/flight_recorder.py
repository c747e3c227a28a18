"""Training flight recorder: per-step anatomy ring + black-box dumps.

Copy of the workload half of ``skypilot_tpu/agent/flight_recorder.py``
(the port imports nothing of the reference), with the same record and
dump JSON, so the tools that read a rank's dump read the port's:

  * a bounded ring of **sealed step records**, each splitting one step
    into phases that sum EXACTLY to the step's wall-clock:
    ``data_wait`` (the ``train/data.py`` iterator hand-off), ``h2d``
    (host batch → device tensors), ``dispatch`` (the trainer's step
    call: the host's launch of the step's kernels, no device sync),
    ``device_compute`` (only when a caller synced and timed the
    device), ``ckpt_copy`` (checkpointd's on-step device→host
    snapshot), and ``other`` (the exact remainder);

  * **black-box dumps**: the sealed ring is written to
    ``$XSKY_FLIGHTREC_DIR/rank-<N>-<reason>-*.json`` on a fatal
    exception and on SIGTERM/preemption (:func:`install_crash_dumps`),
    and once per stall episode (:func:`note_stall`);

  * a **spool ride-along**: the newest K records ride the rank's
    telemetry sample as its ``flightrec`` key (``agent/telemetry.py``).

The reference's workload hooks are carried: the chaos points
``train.straggler_rank`` (inside :meth:`FlightRecorder.mark_compute`: the
rank really sleeps ``extra_s`` and the time lands in
``device_compute``) and ``train.data_stall`` (inside the ``data_wait``
bracket, ``stall_s``), and :func:`note_stall`, the black-box dump that
the telemetry heartbeat seals once per stall episode. Not carried over:
the control-plane half (``gang_waterfall``, ``record_train_anatomy``).

Stdlib-only and never-raise throughout: the recorder instruments the
very step loop whose throughput it measures — a full disk or a torn
ring must cost the record, never the step. With ``XSKY_FLIGHTREC=0``
every entry point is a dict lookup.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

ENV_ENABLED = 'XSKY_FLIGHTREC'            # "0" disables the recorder
ENV_RING_SIZE = 'XSKY_FLIGHTREC_RING_SIZE'
ENV_DIR = 'XSKY_FLIGHTREC_DIR'            # dump dir; unset ⇒ no dumps
ENV_TAIL = 'XSKY_FLIGHTREC_TAIL'          # records riding each sample
ENV_PUSH_INTERVAL = 'XSKY_FLIGHTREC_PUSH_INTERVAL_S'

# Seal taxonomy, in waterfall render order. `other` is the exact
# remainder — every sealed record's phases sum to its wall at 0.0
# error (float-identical, same accumulation order as the seal).
PHASES = ('data_wait', 'h2d', 'dispatch', 'device_compute',
          'ckpt_copy', 'other')

_DEFAULT_RING_SIZE = 512
_DEFAULT_TAIL = 8
_DEFAULT_PUSH_INTERVAL_S = 2.0

_DUMP_REASON_EXCEPTION = 'exception'
_DUMP_REASON_SIGTERM = 'sigterm'
_DUMP_REASON_STALL = 'stall_verdict'

CHAOS_DATA_STALL = 'train.data_stall'
CHAOS_STRAGGLER = 'train.straggler_rank'


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def enabled() -> bool:
    return os.environ.get(ENV_ENABLED, '1') != '0'


def dump_dir() -> Optional[str]:
    directory = os.environ.get(ENV_DIR)
    return os.path.expanduser(directory) if directory else None


def tail_len() -> int:
    return max(1, _env_int(ENV_TAIL, _DEFAULT_TAIL))


class FlightRecorder:
    """One rank's step-record ring + the in-progress (pending) step."""

    def __init__(self, maxlen: int, rank: int) -> None:
        self.rank = rank
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, maxlen))
        self._lock = threading.Lock()
        self._seq = 0                      # sealed records, lifetime
        self._pending: Dict[str, float] = {}
        self._pending_step: Optional[int] = None
        self._pending_t0: Optional[float] = None
        self._pending_synced = False
        self._last_push = 0.0
        self._stall_latched = False

    # ---- per-step accumulation (workload hot path) -------------------------

    def begin_step(self, step: int) -> None:
        """Open a step record; an unsealed predecessor is dropped (its
        marks would otherwise bleed into this step's seal)."""
        with self._lock:
            self._pending = {}
            self._pending_step = int(step)
            self._pending_t0 = time.perf_counter()
            self._pending_synced = False

    def mark(self, name: str, seconds: float) -> None:
        with self._lock:
            self._pending[name] = self._pending.get(name, 0.0) + \
                float(seconds)

    def mark_compute(self, dispatch_s: float,
                     device_s: Optional[float] = None,
                     synced: bool = False) -> None:
        """Record the step's dispatch/device split. A caller that
        synced the device passes its own ``(gap, device)`` pair; the
        recorder never syncs the device itself. Unsynced steps pass the
        cheap dispatch wall only; device time lands in ``other``."""
        try:
            from skypilot_tpu_torch.utils import chaos
            rule = chaos.inject(CHAOS_STRAGGLER, rank=self.rank,
                                step=self._pending_step)
            if rule is not None:
                # A straggler is slow FOR REAL: sleep inside the step so
                # the sealed wall stays honest, then attribute it to
                # device compute.
                extra = float(rule.get('extra_s', 0.25))
                time.sleep(extra)
                device_s = (device_s or 0.0) + extra
        except Exception:  # pylint: disable=broad-except
            pass
        with self._lock:
            self._pending['dispatch'] = \
                self._pending.get('dispatch', 0.0) + float(dispatch_s)
            if device_s is not None:
                self._pending['device_compute'] = \
                    self._pending.get('device_compute', 0.0) + \
                    float(device_s)
            if synced:
                self._pending_synced = True

    def seal(self, step: Optional[int] = None,
             wall_s: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Seal the pending step into the ring. Phases sum to
        ``wall_s`` float-exactly: ``other`` is the remainder, and the
        stored wall is re-derived with the same accumulation order a
        reader's ``sum(phases.values())`` uses."""
        now = time.perf_counter()
        with self._lock:
            if step is None:
                step = self._pending_step
            if step is None:
                return None
            if wall_s is None:
                wall_s = (now - self._pending_t0
                          if self._pending_t0 is not None else 0.0)
            attributed = 0.0
            phases: Dict[str, float] = {}
            for name in PHASES[:-1]:
                seconds = float(self._pending.get(name, 0.0))
                phases[name] = seconds
                attributed += seconds
            phases['other'] = max(0.0, float(wall_s) - attributed)
            record = {
                'step': int(step),
                'ts': time.time(),
                'wall_s': attributed + phases['other'],
                'phases': phases,
                'synced': self._pending_synced,
            }
            self._ring.append(record)
            self._seq += 1
            self._pending = {}
            self._pending_step = None
            self._pending_t0 = None
            self._pending_synced = False
            self._stall_latched = False
            return dict(record)

    # ---- read side ---------------------------------------------------------

    def records(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Sealed records, newest-first."""
        with self._lock:
            rows = list(self._ring)
        rows.reverse()
        if limit is not None:
            rows = rows[:max(0, int(limit))]
        return [dict(r) for r in rows]

    def tail(self, k: Optional[int] = None) -> List[Dict[str, Any]]:
        """The newest k records, OLDEST-first (the spool ride-along
        and dump shape — readers replay them in step order)."""
        k = k if k is not None else tail_len()
        with self._lock:
            rows = list(self._ring)[-max(1, int(k)):]
        return [dict(r) for r in rows]

    def sample_blob(self) -> Dict[str, Any]:
        """The ``flightrec`` key of this rank's telemetry sample."""
        with self._lock:
            seq = self._seq
        return {'ts': time.time(), 'seq': seq, 'tail': self.tail()}

    # ---- black-box dump ----------------------------------------------------

    def dump(self, reason: str,
             detail: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write the sealed ring as a black-box file (atomic tmp +
        rename). Returns the path, or None when no dir is configured."""
        directory = dump_dir()
        if directory is None:
            return None
        with self._lock:
            rows = [dict(r) for r in self._ring]
            seq = self._seq
        blob = {
            'reason': reason,
            'ts': time.time(),
            'rank': self.rank,
            'pid': os.getpid(),
            'seq': seq,
            'last_step': rows[-1]['step'] if rows else None,
            'detail': detail or {},
            'records': rows,
            'sealed': True,
        }
        os.makedirs(directory, exist_ok=True)
        # seq in the name: two dumps in the same millisecond (stall
        # latch re-armed by a fast seal) must not overwrite each other.
        path = os.path.join(
            directory,
            f'rank-{self.rank}-{reason}-'
            f'{int(time.time() * 1000)}-{seq}.json')
        tmp = f'{path}.tmp.{os.getpid()}'
        with open(tmp, 'w', encoding='utf-8') as f:
            f.write(json.dumps(blob, default=str))
        os.replace(tmp, path)
        return path


_recorder_lock = threading.Lock()
_recorder: Optional[FlightRecorder] = None
# (ENV_ENABLED, ENV_RING_SIZE, rank) raw values the cached recorder was
# built from (the rank: a per-card process's global rank, set by
# parallel.distributed.initialize, else the gang launcher's host rank)
# — the steady-state resolve on the step loop is dict
# lookups and a tuple compare (telemetry/profiler idiom).
_recorder_key = None


def _current() -> Optional[FlightRecorder]:
    global _recorder, _recorder_key
    key = (os.environ.get(ENV_ENABLED),
           os.environ.get(ENV_RING_SIZE),
           os.environ.get('XSKY_RANK') or os.environ.get('XSKY_HOST_RANK'))
    if key == _recorder_key:
        return _recorder
    if key[0] == '0':
        recorder = None
    else:
        try:
            rank = int(key[2] or 0)
        except ValueError:
            rank = 0
        maxlen = _env_int(ENV_RING_SIZE, _DEFAULT_RING_SIZE)
        with _recorder_lock:
            if _recorder is not None and \
                    _recorder._ring.maxlen == max(1, maxlen) and \
                    _recorder.rank == rank:
                recorder = _recorder
            else:
                recorder = FlightRecorder(maxlen, rank)
    _recorder = recorder
    _recorder_key = key
    return recorder


def get_recorder() -> Optional[FlightRecorder]:
    """The process's recorder, or None when disabled. Never raises."""
    try:
        return _current()
    except Exception:  # pylint: disable=broad-except
        return None


def reset_for_test() -> None:
    global _recorder, _recorder_key
    _recorder = None
    _recorder_key = None


# ---- workload-side hot-path helpers (all never-raise) ----------------------


def begin_step(step: int) -> None:
    """Open the step's record. NEVER raises; disabled ⇒ dict lookup."""
    try:
        rec = _current()
        if rec is not None:
            rec.begin_step(step)
    except Exception:  # pylint: disable=broad-except
        pass


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Bracket one phase of the pending step (``with
    flight_recorder.phase('data_wait'): ...``). The ``train.data_stall``
    chaos point fires INSIDE the ``data_wait`` bracket, so an injected
    stall is measured, and attributed, as real data wait."""
    try:
        rec = _current()
    except Exception:  # pylint: disable=broad-except
        rec = None
    if rec is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        if name == 'data_wait':
            try:
                from skypilot_tpu_torch.utils import chaos
                rule = chaos.inject(CHAOS_DATA_STALL, rank=rec.rank)
                if rule is not None:
                    time.sleep(float(rule.get('stall_s', 0.25)))
            except Exception:  # pylint: disable=broad-except
                pass
        yield
    finally:
        try:
            rec.mark(name, time.perf_counter() - t0)
        except Exception:  # pylint: disable=broad-except
            pass


def mark(name: str, seconds: float) -> None:
    """Accumulate externally-timed seconds into the pending step (the
    checkpointd ``ckpt_copy`` hook). NEVER raises."""
    try:
        rec = _current()
        if rec is not None:
            rec.mark(name, seconds)
    except Exception:  # pylint: disable=broad-except
        pass


def mark_compute(dispatch_s: float, device_s: Optional[float] = None,
                 synced: bool = False) -> None:
    """Record the step's dispatch/device marks (see
    :meth:`FlightRecorder.mark_compute`). NEVER raises."""
    try:
        rec = _current()
        if rec is not None:
            rec.mark_compute(dispatch_s, device_s, synced=synced)
    except Exception:  # pylint: disable=broad-except
        pass


def record_step(step: Optional[int] = None,
                phases: Optional[Dict[str, float]] = None,
                wall_s: Optional[float] = None) -> None:
    """Seal one step record and (interval-gated) push the ring tail
    onto this rank's telemetry sample as its ``flightrec`` key. NEVER
    raises — this is the step loop's per-iteration hook. ``phases``
    merges explicit phase seconds first (the drill/test path)."""
    try:
        _record_step(step, phases, wall_s)
    except Exception:  # pylint: disable=broad-except
        pass


def _record_step(step: Optional[int], phases: Optional[Dict[str, float]],
                 wall_s: Optional[float]) -> None:
    rec = _current()
    if rec is None:
        return
    if phases:
        for name, seconds in phases.items():
            rec.mark(name, seconds)
    if rec.seal(step=step, wall_s=wall_s) is None:
        return
    now = time.perf_counter()
    if now - rec._last_push < _env_float(ENV_PUSH_INTERVAL,
                                         _DEFAULT_PUSH_INTERVAL_S):
        return
    rec._last_push = now
    from skypilot_tpu_torch.agent import telemetry
    telemetry.emit(flightrec=rec.sample_blob())


def seal_dump(reason: str,
              detail: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Dump the ring as a black-box file; returns the path (None when
    disabled / no dir / nothing to write). NEVER raises — it runs from
    excepthooks, signal handlers and the heartbeat thread."""
    try:
        rec = _current()
        if rec is None:
            return None
        return rec.dump(reason, detail=detail)
    except Exception:  # pylint: disable=broad-except
        return None


def note_stall(progress_age_s: float) -> None:
    """Telemetry's heartbeat thread calls this when the rank's own
    progress goes stale: dump the black box ONCE per stall episode (the
    latch re-arms on the next sealed step). NEVER raises."""
    try:
        rec = _current()
        if rec is None or rec._stall_latched:
            return
        rec._stall_latched = True
        seal_dump(_DUMP_REASON_STALL,
                  detail={'progress_age_s': round(progress_age_s, 3)})
    except Exception:  # pylint: disable=broad-except
        pass


_hooks_installed = False


def install_crash_dumps() -> None:
    """Chain a black-box dump into ``sys.excepthook`` (fatal
    exception) and the SIGTERM handler (preemption). Idempotent,
    main-thread-only for the signal half, NEVER raises."""
    global _hooks_installed
    if _hooks_installed:
        return
    try:
        import signal
        import sys
        _hooks_installed = True
        prev_hook = sys.excepthook

        def _hook(exc_type, exc, tb):
            seal_dump(_DUMP_REASON_EXCEPTION,
                      detail={'error': repr(exc)})
            prev_hook(exc_type, exc, tb)

        sys.excepthook = _hook
        prev_term = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            seal_dump(_DUMP_REASON_SIGTERM)
            if callable(prev_term):
                prev_term(signum, frame)
            else:
                # Restore the default disposition and re-deliver: the
                # preemption still kills us, black box already sealed.
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)
    except Exception:  # pylint: disable=broad-except
        pass
