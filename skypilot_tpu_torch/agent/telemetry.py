"""Per-rank workload telemetry: heartbeat + progress samples on a spool.

Copy of the emitter half of ``skypilot_tpu/agent/telemetry.py`` (the
port imports nothing of the reference): a serving replica calls
:func:`emit` from its hot paths (``infer/server.py``'s loop and
``infer/metrics.py``'s request accounting). ``emit`` keeps one sample
(phase ``init``/``step``/``idle``, step index, step-time EMA, tokens/s,
host memory, last-progress time) and writes it atomically as one JSON
line to ``$XSKY_TELEMETRY_DIR/rank-<N>.json``; a heartbeat thread
re-touches ``hb_ts`` every interval, so a replica blocked inside a step
still proves its process is alive while its progress goes stale. The
control plane reads the spool with the reference's ``parse_sample`` and
tells a hung replica from a dead one; the line format is the
reference's.

The reference's workload hooks are carried: the ``telemetry.stall``
chaos point inside :func:`emit` (a fired rule freezes this rank's
progress while the heartbeat goes on: the hung-rank drill), and the
heartbeat thread's stall seal (once the rank's own progress is older
than ``XSKY_TELEMETRY_PROGRESS_STALE_S``, it seals the flight recorder's
black box, ``flight_recorder.note_stall``). The profiler's summary rides
the sample as its ``profile`` key (``agent/profiler.py``).

Not carried over: the control-plane side (reading the spool, verdicts),
which reads the port's samples with its own functions.

Never-raise discipline: telemetry instruments the loop whose throughput
it measures, so a full disk or a torn spool costs the sample, never the
step. With no ``XSKY_TELEMETRY_DIR`` set, :func:`emit` is one dict
lookup.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

ENV_DIR = 'XSKY_TELEMETRY_DIR'            # spool dir; unset ⇒ emit no-op
ENV_ENABLED = 'XSKY_TELEMETRY'            # "0" disables emit entirely
ENV_RANK = 'XSKY_HOST_RANK'               # set by the gang launcher
ENV_GLOBAL_RANK = 'XSKY_RANK'             # set per process per card
ENV_INTERVAL = 'XSKY_TELEMETRY_INTERVAL_S'
ENV_HB_STALE = 'XSKY_TELEMETRY_HB_STALE_S'
ENV_PROGRESS_STALE = 'XSKY_TELEMETRY_PROGRESS_STALE_S'
ENV_PULL_INTERVAL = 'XSKY_TELEMETRY_PULL_INTERVAL_S'

PHASE_INIT = 'init'
PHASE_STEP = 'step'
PHASE_IDLE = 'idle'

# Spool write + heartbeat cadence.
_DEFAULT_INTERVAL_S = 2.0
# Progress older than this (the rank's own clock) is a stall.
_DEFAULT_PROGRESS_STALE_S = 300.0

EMA_ALPHA = 0.2


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def interval_s() -> float:
    return _env_float(ENV_INTERVAL, _DEFAULT_INTERVAL_S)


def progress_stale_s() -> float:
    return _env_float(ENV_PROGRESS_STALE, _DEFAULT_PROGRESS_STALE_S)


def ema(prev: Optional[float], value: float,
        alpha: float = EMA_ALPHA) -> float:
    """Exponential moving average; first observation seeds it."""
    if prev is None:
        return float(value)
    return alpha * float(value) + (1.0 - alpha) * float(prev)


class _Emitter:
    """One rank's in-memory sample + spool writer + heartbeat thread."""

    def __init__(self, path: str, rank: int) -> None:
        self.path = path
        self.rank = rank
        now = time.time()
        self.sample: Dict[str, Any] = {
            'rank': rank,
            'pid': os.getpid(),
            'phase': None,
            'step': None,
            'step_time_ema_s': None,
            'tokens_per_sec': None,
            'host_mem_mb': None,
            'started_ts': now,
            'last_progress_ts': now,
            'hb_ts': now,
            'ts': now,
        }
        self._lock = threading.Lock()
        self._last_write = 0.0
        self._tokens_acc = 0.0
        self._tokens_at_write = 0.0
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    def update(self, phase: Optional[str], step: Optional[int],
               step_time_s: Optional[float],
               tokens_per_sec: Optional[float],
               tokens: Optional[float],
               extra: Dict[str, Any]) -> None:
        now = time.time()
        with self._lock:
            s = self.sample
            phase_changed = phase is not None and phase != s['phase']
            progressed = phase_changed
            if phase_changed:
                s['phase'] = phase
            if step is not None and step != s['step']:
                s['step'] = int(step)
                progressed = True
            if step_time_s is not None:
                s['step_time_ema_s'] = ema(s['step_time_ema_s'],
                                           step_time_s)
            if tokens_per_sec is not None:
                s['tokens_per_sec'] = ema(s['tokens_per_sec'],
                                          tokens_per_sec)
            if tokens is not None:
                self._tokens_acc += float(tokens)
            if extra:
                s.update(extra)
            if progressed:
                s['last_progress_ts'] = now
            s['hb_ts'] = now
            # Spool writes are interval-driven, never step-driven: only
            # phase transitions and the first emit force a write;
            # in-memory progress lands with the next interval or
            # heartbeat write.
            due = (self._last_write == 0.0 or phase_changed or
                   now - self._last_write >= interval_s())
            if due:
                self._write_locked(now)
        self._ensure_heartbeat()

    def _write_locked(self, now: float) -> None:
        """Serialize + atomically replace the spool file (caller holds
        the lock)."""
        s = self.sample
        # Token rate over the window since the previous write, which does
        # not exist on the first write: its tokens count in the second.
        window = now - self._last_write
        if self._last_write > 0 and window > 0 and \
                self._tokens_acc > self._tokens_at_write:
            rate = (self._tokens_acc - self._tokens_at_write) / window
            s['tokens_per_sec'] = ema(s['tokens_per_sec'], rate)
            self._tokens_at_write = self._tokens_acc
        try:
            import resource
            s['host_mem_mb'] = round(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                / 1024.0, 1)
        except Exception:  # pylint: disable=broad-except
            pass
        s['ts'] = now
        self._last_write = now
        tmp = f'{self.path}.tmp.{os.getpid()}'
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(tmp, 'w', encoding='utf-8') as f:
            f.write(json.dumps(s, default=str))
        os.replace(tmp, self.path)

    def _ensure_heartbeat(self) -> None:
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        self._hb_thread = threading.Thread(
            target=self._hb_loop, daemon=True,
            name=f'xsky-telemetry-hb-{self.rank}')
        self._hb_thread.start()

    def _hb_loop(self) -> None:
        """Re-touch hb_ts every interval: liveness proof independent of
        the (possibly blocked) workload thread. The wait is floored at
        50 ms so an interval of 0 never becomes a busy loop."""
        while not self._stop.wait(max(interval_s(), 0.05)):
            try:
                with self._lock:
                    self.sample['hb_ts'] = time.time()
                    self._write_locked(time.time())
                    progress_ts = self.sample.get('last_progress_ts')
                # The heartbeat thread is the thread still alive when the
                # workload wedges: once this rank's OWN progress goes
                # stale, seal the flight recorder's black box (latched
                # once per episode).
                age = time.time() - (progress_ts or 0)
                if progress_ts and age > progress_stale_s():
                    from skypilot_tpu_torch.agent import flight_recorder
                    flight_recorder.note_stall(age)
            except Exception:  # pylint: disable=broad-except
                pass

    def stop(self) -> None:
        self._stop.set()


_emitter_lock = threading.Lock()
_emitter: Optional[_Emitter] = None
# (ENV_DIR, ENV_RANK) raw values the cached emitter was built from: the
# steady-state resolve is two dict lookups and a tuple compare.
_emitter_key = None


def _current_emitter() -> Optional[_Emitter]:
    """Resolve (spool dir, rank) from the environment; rebuild the
    emitter when either changed."""
    global _emitter, _emitter_key
    if os.environ.get(ENV_ENABLED, '1') == '0':
        return None
    directory = os.environ.get(ENV_DIR)
    if not directory:
        return None
    # A process of a gang of one process per card carries its global
    # rank (set by parallel.distributed.initialize); one per host, the
    # gang launcher's host rank.
    rank_raw = os.environ.get(ENV_GLOBAL_RANK) or os.environ.get(
        ENV_RANK, '0')
    key = (directory, rank_raw)
    if key == _emitter_key and _emitter is not None:
        return _emitter
    try:
        rank = int(rank_raw)
    except ValueError:
        rank = 0
    path = os.path.join(os.path.expanduser(directory),
                        f'rank-{rank}.json')
    with _emitter_lock:
        if _emitter is None or _emitter.path != path:
            if _emitter is not None:
                _emitter.stop()
            _emitter = _Emitter(path, rank)
        _emitter_key = key
        return _emitter


def emit(phase: Optional[str] = None, step: Optional[int] = None,
         step_time_s: Optional[float] = None,
         tokens_per_sec: Optional[float] = None,
         tokens: Optional[float] = None, **extra: Any) -> None:
    """Record one telemetry observation for this rank. NEVER raises, and
    with no spool configured (``XSKY_TELEMETRY_DIR`` unset) returns after
    one env lookup.

    ``tokens`` is an incremental token count (serving); the emitter
    converts it to a rate over the write window. ``tokens_per_sec`` is a
    direct rate; both feed the sample's EMA.
    """
    try:
        emitter = _current_emitter()
        if emitter is None:
            return
        try:
            from skypilot_tpu_torch.utils import chaos
            # A fired rule freezes this rank's PROGRESS (the heartbeat
            # thread keeps beating): the hung-rank drill. The elastic
            # generation rides the context as in the reference.
            if chaos.inject('telemetry.stall', rank=emitter.rank,
                            generation=os.environ.get(
                                'XSKY_ELASTIC_GENERATION', '0')
                            ) is not None:
                return
        except Exception:  # pylint: disable=broad-except
            # Even a rule configured with `error` must only freeze the
            # emit, never take down the step loop it instruments.
            return
        emitter.update(phase, step, step_time_s, tokens_per_sec, tokens,
                       extra)
    except Exception:  # pylint: disable=broad-except
        pass


def reset_for_test() -> None:
    """Stop and drop the process's emitter (tests switch spools)."""
    global _emitter, _emitter_key
    with _emitter_lock:
        if _emitter is not None:
            _emitter.stop()
        _emitter = None
        _emitter_key = None
