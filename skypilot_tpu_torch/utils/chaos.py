"""Runtime fault injection: named chaos points on the workload's hot paths.

Copy of ``skypilot_tpu/utils/chaos.py`` (stdlib only; the port imports
nothing of the reference), so the reference's fault plans drive a port
workload too. The port's points: ``telemetry.stall`` (freezes a rank's
emit without killing the process, the hung-rank drill),
``train.straggler_rank`` and ``train.data_stall`` (the flight recorder),
``ckpt.write``, ``ckpt.replicate`` and ``ckpt.restore`` (checkpointd),
``infer.decode_stall`` (one decode tick) and
``profiler.dispatch_stall`` (a sampled step probe).

A *chaos point* is a named call site::

    chaos.inject('infer.decode_stall')

With no plan loaded the call is a no-op (one dict lookup; hit counters
stay untouched, nothing allocates). A plan comes from ``XSKY_CHAOS_PLAN``
— a JSON object, or a path to a JSON file (handy for subprocess trees:
the env var is inherited by spawned processes)::

    {
      "seed": 7,
      "points": {
        "ckpt.write":         {"first_n": 1, "error": "OSError"},
        "infer.decode_stall": {"skip_first": 2, "first_n": 3,
                               "latency_s": 0.05},
        "telemetry.stall":    {"probability": 0.05},
        "ckpt.restore":       [{"every_kth": 3, "error": "IOError"}]
      }
    }

Each point maps to one rule or a list of rules (evaluated in order; the
first rule whose selectors match fires). Hit numbers are 1-based and
per-process.

Selectors (ANDed within a rule):
  ``probability``  fire with this probability (seeded RNG → deterministic)
  ``first_n``      fire only on the first N eligible hits
  ``every_kth``    fire when the eligible hit number is a multiple of K
  ``skip_first``   the first N hits are never eligible
  ``match``        ``{ctx_key: value}`` — only hits whose call-site
                   context matches (e.g. ``{"rank": 0}``). Non-matching
                   hits do not advance the rule's hit numbering, so
                   ``{"match": {"rank": 1}, "first_n": 1}`` fires on
                   rank 1's first traversal no matter how many other
                   ranks hit the point before it.

Actions (applied when a rule fires):
  ``latency_s``    sleep this long before returning/raising
  ``error``        raise this exception type (resolved from builtins;
                   unknown names raise :class:`ChaosError`)
  ``signal``       send this signal (name like ``"SIGKILL"`` or a
                   number) to the CURRENT process, for crash-safety
                   drills. The fire is counted before the signal lands.
  anything else    returned to the call site in the fired rule dict for
                   site-specific handling (e.g. ``gap_s`` for
                   ``profiler.dispatch_stall``, ``extra_s`` for
                   ``train.straggler_rank``).

Two departures from the reference, both pinned by
``tests/test_torch_chaos.py``:
  * The reference appends every fire to the control plane's
    recovery-event journal (``state.record_recovery_event``), which the
    port does not carry. Here a fire is annotated on the current span of
    ``utils/tracing.py`` (``chaos_fires``: point, cause, measured
    latency) and counted in process (:func:`fired`; the reference also
    counts it in ``xsky_chaos_fires_total``, a metric the port does not
    carry).
  * Error names resolve from builtins, then :class:`ChaosError`; the
    reference looks in ``skypilot_tpu.exceptions`` first, so a name only
    that module defines (``CapacityError``) raises :class:`ChaosError`
    here.
"""
from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_plan: Optional['_Plan'] = None
_plan_src: Optional[str] = None   # env value the cached plan was parsed from
_direct = False                   # plan installed via load_plan(), not env
_bad_src: Optional[str] = None    # env value that failed to parse


class ChaosError(Exception):
    """Injected failure whose rule names no (or an unknown) error type."""


class ChaosPlanError(ValueError):
    """XSKY_CHAOS_PLAN is not valid JSON / not readable."""


def _resolve_signal(sig) -> int:
    import signal as signal_lib
    if isinstance(sig, str):
        num = getattr(signal_lib, sig, None)
        if num is None:
            raise ChaosError(f'unknown signal name {sig!r}')
        return int(num)
    return int(sig)


def _resolve_error(name: str) -> type:
    import builtins
    cls = getattr(builtins, name, None)
    if not (isinstance(cls, type) and issubclass(cls, BaseException)):
        return ChaosError
    return cls


class _Plan:

    def __init__(self, config: Dict[str, Any]) -> None:
        points = config.get('points') or {}
        self.rules: Dict[str, List[Dict[str, Any]]] = {
            point: list(rule) if isinstance(rule, list) else [rule]
            for point, rule in points.items()
        }
        self.rng = random.Random(config.get('seed'))
        self._lock = threading.Lock()
        self.hit_counts: Dict[str, int] = {}
        self.fired_counts: Dict[str, int] = {}
        # (point, rule index) → hits whose `match` selector passed; this
        # is the hit number skip_first/first_n/every_kth count against.
        self._rule_hits: Dict[Any, int] = {}

    def fire(self, point: str, ctx: Dict[str, Any]
             ) -> Optional[Dict[str, Any]]:
        with self._lock:
            hit = self.hit_counts.get(point, 0) + 1
            self.hit_counts[point] = hit
            rule = None
            for idx, r in enumerate(self.rules.get(point, ())):
                m = r.get('match')
                if m and any(ctx.get(k) != v for k, v in m.items()):
                    continue
                # Every matching rule's numbering advances on every
                # matching hit, fired or not — rule order never warps
                # another rule's skip_first/every_kth arithmetic.
                rhit = self._rule_hits.get((point, idx), 0) + 1
                self._rule_hits[(point, idx)] = rhit
                if rule is None and self._selected(r, rhit):
                    rule = r
            if rule is not None:
                self.fired_counts[point] = \
                    self.fired_counts.get(point, 0) + 1
        if rule is None:
            return None
        latency = rule.get('latency_s')
        measured_s = None
        if latency:
            # Record the MEASURED delay, not the configured one: an
            # oversleeping host (cgroup throttling, a loaded box) is
            # exactly the signal a latency drill exists to surface.
            t0 = time.monotonic()
            time.sleep(float(latency))
            measured_s = time.monotonic() - t0
        _record_fire(point, rule, ctx, measured_s)
        sig = rule.get('signal')
        if sig is not None:
            # Crash drill: the fire is already counted, so even SIGKILL
            # (unhandleable) leaves its trace on the span.
            os.kill(os.getpid(), _resolve_signal(sig))
        error = rule.get('error')
        if error:
            raise _resolve_error(error)(
                f'chaos: injected {error} at {point} (hit {hit})')
        return dict(rule)

    def _selected(self, rule: Dict[str, Any], hit: int) -> bool:
        eligible = hit - int(rule.get('skip_first', 0))
        if eligible < 1:
            return False
        if 'first_n' in rule and eligible > int(rule['first_n']):
            return False
        if 'every_kth' in rule and eligible % int(rule['every_kth']) != 0:
            return False
        if 'probability' in rule and \
                self.rng.random() >= float(rule['probability']):
            return False
        return True


def _record_fire(point: str, rule: Dict[str, Any], ctx: Dict[str, Any],
             measured_latency_s: Optional[float] = None) -> None:
    """Record the injected fault; never let observability kill the path.

    ``measured_latency_s`` is the actually-injected sleep (measured at
    the call site), noted on the active trace span, NOT the plan's
    configured value. ``ctx`` is the call site's context, which the
    reference journals with the fire and the port has no journal for.
    """
    del ctx
    if rule.get('error'):
        cause = rule['error']
    elif 'signal' in rule:
        cause = f'signal={rule["signal"]}'
    elif 'returncode' in rule:
        cause = f'returncode={rule["returncode"]}'
    else:
        cause = 'latency' if rule.get('latency_s') else 'fired'
    try:
        # Cross-link: the span this fault fired under carries every
        # chaos fire (point, cause, measured latency).
        from skypilot_tpu_torch.utils import tracing
        fire = {'point': point, 'cause': cause}
        if measured_latency_s is not None:
            fire['latency_s'] = round(measured_latency_s, 6)
        tracing.annotate_append('chaos_fires', fire)
    except Exception:  # pylint: disable=broad-except
        pass


def _parse(src: str) -> '_Plan':
    text = src.strip()
    if not text.startswith('{'):
        try:
            with open(os.path.expanduser(text), encoding='utf-8') as f:
                text = f.read()
        except OSError as e:
            raise ChaosPlanError(
                f'XSKY_CHAOS_PLAN file unreadable: {e}') from e
    try:
        config = json.loads(text)
    except ValueError as e:
        raise ChaosPlanError(f'XSKY_CHAOS_PLAN is not valid JSON: {e}') \
            from e
    if not isinstance(config, dict):
        raise ChaosPlanError('XSKY_CHAOS_PLAN must be a JSON object.')
    return _Plan(config)


def _current_plan() -> Optional['_Plan']:
    global _plan, _plan_src, _bad_src
    if _direct:
        return _plan
    src = os.environ.get('XSKY_CHAOS_PLAN')
    if not src:
        if _plan is not None:
            with _lock:
                if not _direct:
                    _plan, _plan_src = None, None
        return None
    if src == _bad_src:
        return None
    if src != _plan_src:
        with _lock:
            if src != _plan_src and src != _bad_src and not _direct:
                try:
                    _plan = _parse(src)
                    _plan_src = src
                except ChaosPlanError as e:
                    # A typo'd plan must never take down the recovery
                    # paths it instruments: log once, run chaos-free.
                    # (Counters stay empty, so a test driving a broken
                    # plan still fails loudly on its hit assertions.)
                    _bad_src = src
                    _plan, _plan_src = None, None
                    logger.error('Ignoring XSKY_CHAOS_PLAN: %s', e)
    return _plan


# ---- call-site API ---------------------------------------------------------


def inject(point: str, **ctx: Any) -> Optional[Dict[str, Any]]:
    """Evaluate the chaos point. Returns the fired rule dict (after
    applying latency and raising any configured error), or None.

    With no plan loaded this returns immediately without touching
    counters — instrumented hot paths pay one env lookup.
    """
    plan = _current_plan()
    if plan is None:
        return None
    return plan.fire(point, ctx)


def enabled() -> bool:
    return _current_plan() is not None


# ---- test / observability API ---------------------------------------------


def load_plan(config: Dict[str, Any]) -> None:
    """Install a plan programmatically (in-process tests). Pair with
    :func:`clear` — a directly-loaded plan shadows the env var."""
    global _plan, _plan_src, _direct
    with _lock:
        _plan = _Plan(config)
        _plan_src = None
        _direct = True


def clear() -> None:
    """Drop any loaded plan and all counters."""
    global _plan, _plan_src, _direct, _bad_src
    with _lock:
        _plan, _plan_src, _direct, _bad_src = None, None, False, None


def counters() -> Dict[str, int]:
    """Point → times the point was traversed (this process). Empty when
    no plan is loaded — the zero-overhead-when-disabled assertion."""
    plan = _current_plan()
    if plan is None:
        return {}
    with plan._lock:  # pylint: disable=protected-access
        return dict(plan.hit_counts)


def fired() -> Dict[str, int]:
    """Point → times a rule actually fired (this process)."""
    plan = _current_plan()
    if plan is None:
        return {}
    with plan._lock:  # pylint: disable=protected-access
        return dict(plan.fired_counts)


def hits(point: str) -> int:
    return counters().get(point, 0)

