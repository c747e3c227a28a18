"""Async multi-tier checkpoint & peer-restore plane (agent side).

Copy of ``skypilot_tpu/agent/checkpointd.py`` (the port imports nothing
of the reference; the module is framework-free), so no incarnation of
a preempted job starts from zero:

  * **off-step-path snapshots** — the step loop pays ONLY the
    device→host transfer (the ``payload_fn`` it passes to
    :func:`maybe_checkpoint`); serialize + local write + peer
    replication + the storage-tier save all run in a named daemon
    background thread (``xsky-ckptd``), latest-snapshot-wins;

  * **auto-tuned cadence** — the Young/Daly interval
    ``sqrt(2 · δ · MTTF)`` (checkpoint exactly when the marginal
    expected replay loss since the last snapshot, ``t/MTTF`` per
    second, crosses the amortized snapshot cost ``δ/t``), with δ the
    measured on-step snapshot cost EMA and MTTF from the
    ``XSKY_CKPT_MTTF_S`` hint the jobs controller derives from its
    recovery journal, clamped to
    ``[XSKY_CKPT_MIN_INTERVAL_S, XSKY_CKPT_MAX_INTERVAL_S]``;

  * **peer-tier replication** — each rank's newest shard + manifest
    (step, incarnation, rank, sha256 digest, ts) is copied to K gang
    peers' runtime roots. The gang launcher wires the dirs:
    ``XSKY_CKPT_DIR`` (own host) and ``XSKY_CKPT_PEER_DIRS`` (the K
    next hosts' roots). Peer copy requires the peer root to be
    filesystem-reachable (shared mounts); an unreachable peer costs
    its replica, never the snapshot;

  * **tiered restore** — :func:`restore` walks local → peer manifests
    (freshest valid copy wins; torn/corrupt manifests and
    digest-mismatched shards are discarded, never raised on) → the
    storage tier (caller-provided: the step directories of
    ``train/launch.py``) → cold start, under a ``jobs.ckpt_restore``
    span. The workload then emits ``resume_step``.

The reference's chaos points are carried: ``ckpt.write`` (an ``error``
rule drops that snapshot, ``latency_s`` models a slow disk),
``ckpt.replicate`` (a fault costs that peer's replica) and
``ckpt.restore`` (traversed by every fast-tier candidate read and by the
storage tier: a fault sends the walk on to the next copy or tier). Not
carried over: the control-plane side (``derive_mttf`` and the recovery
journal in the state DB). The reference's ``xsky_ckpt_{writes,restores,bytes}_total``
counters are kept in-process (:func:`counters`); the ``ckpt_step`` /
``ckpt_ts`` freshness fields ride the rank's telemetry sample as in the
reference.

Never-raise discipline throughout: the plane instruments the very
step loop whose goodput it protects — a full disk, a dead peer, or a
torn manifest must cost the snapshot or the tier, never the step.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

ENV_ENABLED = 'XSKY_CKPT'                 # "0" disables the plane
ENV_DIR = 'XSKY_CKPT_DIR'                 # local tier; unset ⇒ no-op
ENV_PEER_DIRS = 'XSKY_CKPT_PEER_DIRS'     # newline-separated peer dirs
ENV_REPLICAS = 'XSKY_CKPT_REPLICAS'       # K peers per shard
ENV_MIN_INTERVAL = 'XSKY_CKPT_MIN_INTERVAL_S'
ENV_MAX_INTERVAL = 'XSKY_CKPT_MAX_INTERVAL_S'
ENV_MTTF = 'XSKY_CKPT_MTTF_S'             # controller-derived hint
ENV_SCOPE = 'XSKY_CKPT_SCOPE'             # journal scope (job/<id>)
ENV_KEEP = 'XSKY_CKPT_KEEP'               # snapshots kept per dir

# Restore tiers, freshest-first. `cold` means nothing restorable was
# found anywhere — the incarnation starts from step 0.
TIER_LOCAL = 'local'
TIER_PEER = 'peer'
TIER_STORAGE = 'storage'
TIER_COLD = 'cold'

# Knobs the control plane forwards into the job spec env (the gang
# backend threads these; the per-rank dir/peer wiring stays with the
# gang launcher).
FORWARD_ENV = (ENV_ENABLED, ENV_MIN_INTERVAL, ENV_MAX_INTERVAL,
               ENV_MTTF, ENV_SCOPE, ENV_REPLICAS, ENV_KEEP)

_DEFAULT_MIN_INTERVAL_S = 15.0
_DEFAULT_MAX_INTERVAL_S = 600.0
# With no journal evidence and no hint: one failure per half hour —
# pessimistic enough that the Young interval stays well under the max
# clamp once a real snapshot cost is measured.
_DEFAULT_MTTF_S = 1800.0
_DEFAULT_REPLICAS = 1
_DEFAULT_KEEP = 2
# Snapshot-cost floor for the cadence math: a measured δ of ~0 (tiny
# payloads) must not drive the interval to zero before the min clamp.
_MIN_COST_S = 1e-3
_COST_EMA_ALPHA = 0.3

_MANIFEST_PREFIX = 'manifest-'
_SHARD_PREFIX = 'shard-'


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _ema(prev: Optional[float], value: float,
         alpha: float = _COST_EMA_ALPHA) -> float:
    if prev is None:
        return float(value)
    return alpha * float(value) + (1.0 - alpha) * prev


def min_interval_s() -> float:
    return max(0.05, _env_float(ENV_MIN_INTERVAL,
                                _DEFAULT_MIN_INTERVAL_S))


def max_interval_s() -> float:
    return max(min_interval_s(),
               _env_float(ENV_MAX_INTERVAL, _DEFAULT_MAX_INTERVAL_S))


def replicas() -> int:
    return max(0, int(_env_float(ENV_REPLICAS, _DEFAULT_REPLICAS)))


def keep_snapshots() -> int:
    return max(1, int(_env_float(ENV_KEEP, _DEFAULT_KEEP)))


def mttf_s() -> float:
    """The MTTF the cadence plans against: the controller-threaded
    hint (``XSKY_CKPT_MTTF_S``, derived from the recovery journal on
    every (re)submit), or the pessimistic default."""
    return max(1.0, _env_float(ENV_MTTF, _DEFAULT_MTTF_S))


class Snapshot:
    """One restore answer: the step to resume from, the deserialized
    payload (None for ``cold`` — and for ``storage`` the object the
    caller's ``storage_fn`` returned), and where it came from."""

    def __init__(self, step: int, payload: Any, tier: str,
                 latency_s: float, manifest: Optional[Dict[str, Any]]
                 = None) -> None:
        self.step = int(step)
        self.payload = payload
        self.tier = tier
        self.latency_s = latency_s
        self.manifest = manifest

    def __repr__(self) -> str:
        return (f'Snapshot(step={self.step}, tier={self.tier}, '
                f'latency_s={self.latency_s:.3f})')


class Cadence:
    """Checkpoint-interval controller: Young/Daly
    ``sqrt(2 · δ · MTTF)`` with δ the measured on-step snapshot cost
    EMA, clamped to the env window and quantized to whole steps of
    the telemetry plane's step-time EMA (replay is re-bought in whole
    steps, and a snapshot cannot fire mid-step anyway). ``due()`` is
    the step-path check — two float compares."""

    def __init__(self) -> None:
        self._cost_ema: Optional[float] = None
        self._step_ema: Optional[float] = None
        self._next = 0.0

    def observe_cost(self, cost_s: float) -> None:
        self._cost_ema = _ema(self._cost_ema, cost_s)

    def observe_step_time(self, step_time_s: float) -> None:
        if step_time_s and step_time_s > 0:
            self._step_ema = _ema(self._step_ema, step_time_s)

    def interval_s(self) -> float:
        delta = max(self._cost_ema or 0.0, _MIN_COST_S)
        optimal = math.sqrt(2.0 * delta * mttf_s())
        interval = min(max_interval_s(),
                       max(min_interval_s(), optimal))
        if self._step_ema:
            # Whole-step quantization, never below one step and never
            # above the ceiling (unless one step IS above it).
            steps = max(1, math.ceil(interval / self._step_ema))
            interval = min(max(max_interval_s(), self._step_ema),
                           steps * self._step_ema)
        return interval

    def due(self, now: Optional[float] = None) -> bool:
        now = now if now is not None else time.monotonic()
        return now >= self._next

    def arm(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.monotonic()
        self._next = now + self.interval_s()


class Checkpointer:
    """One rank's tiered snapshot pipeline + background writer."""

    def __init__(self, directory: str, rank: int = 0,
                 peer_dirs: Tuple[str, ...] = (),
                 incarnation: int = 0,
                 serializer: Callable[[Any], bytes] = pickle.dumps,
                 deserializer: Callable[[bytes], Any] = pickle.loads,
                 storage_save: Optional[Callable[[int, Any], None]]
                 = None) -> None:
        self.base_dir = os.path.expanduser(directory)
        self.rank = int(rank)
        self.peer_dirs = tuple(os.path.expanduser(p)
                               for p in peer_dirs if p)
        self.incarnation = int(incarnation)
        self.cadence = Cadence()
        self.last_step: Optional[int] = None
        self.last_storage_step: Optional[int] = None
        self._serializer = serializer
        self._deserializer = deserializer
        self._storage_save = storage_save
        self._cv = threading.Condition()
        self._pending: Optional[Tuple[int, Any]] = None
        self._busy = False
        self._stopped = False
        self._worker: Optional[threading.Thread] = None

    @classmethod
    def from_env(cls, fallback_dir: Optional[str] = None,
                 **overrides: Any) -> Optional['Checkpointer']:
        """Build from the gang-launcher env, or None when the plane is
        disabled (``XSKY_CKPT=0``) or no directory is configured."""
        if os.environ.get(ENV_ENABLED, '1') == '0':
            return None
        directory = os.environ.get(ENV_DIR) or fallback_dir
        if not directory:
            return None
        peers = tuple(
            p.strip() for p in
            (os.environ.get(ENV_PEER_DIRS) or '').splitlines()
            if p.strip())
        try:
            rank = int(os.environ.get('XSKY_HOST_RANK', '0') or 0)
        except ValueError:
            rank = 0
        try:
            incarnation = int(os.environ.get(
                'XSKY_ELASTIC_GENERATION', '0') or 0)
        except ValueError:
            incarnation = 0
        return cls(directory, rank=rank, peer_dirs=peers,
                   incarnation=incarnation, **overrides)

    # ---- write side --------------------------------------------------------

    def _rank_dir(self) -> str:
        return os.path.join(self.base_dir, f'rank-{self.rank}')

    def maybe_checkpoint_impl(self, step: int,
                              payload_fn: Callable[[], Any],
                              step_time_s: Optional[float] = None,
                              force: bool = False) -> bool:
        """The step-path half: cadence check, device→host transfer
        (``payload_fn``), enqueue. Everything else happens on the
        worker thread. Returns True when a snapshot was enqueued.
        Callers go through the module-level never-raise wrapper."""
        if step_time_s:
            self.cadence.observe_step_time(step_time_s)
        now = time.monotonic()
        if not force and not self.cadence.due(now):
            return False
        t0 = time.monotonic()
        payload = payload_fn()   # the device→host copy — the ONLY
        #                          cost the step path pays
        copy_s = time.monotonic() - t0
        self.cadence.observe_cost(copy_s)
        # The same copy is the step's `ckpt_copy` phase in the flight
        # recorder's seal (agent/flight_recorder.py).
        from skypilot_tpu_torch.agent import flight_recorder
        flight_recorder.mark('ckpt_copy', copy_s)
        self.cadence.arm(time.monotonic())
        with self._cv:
            if self._stopped:
                return False
            self._pending = (int(step), payload)   # latest wins
            self._ensure_worker_locked()
            self._cv.notify_all()
        return True

    def _ensure_worker_locked(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._worker = threading.Thread(
            target=self._worker_loop, daemon=True,
            name=f'xsky-ckptd-{self.rank}')
        self._worker.start()

    def _worker_loop(self) -> None:
        """Serialize + write local + replicate + storage save, one
        snapshot at a time, newest-wins. Dies with the process (daemon)
        — a snapshot lost to a crash is exactly what the next-older
        manifest and the peer tier exist for."""
        while True:
            with self._cv:
                while self._pending is None and not self._stopped:
                    self._cv.wait(0.5)
                if self._pending is None and self._stopped:
                    return
                step, payload = self._pending
                self._pending = None
                self._busy = True
            try:
                self._write_snapshot(step, payload)
            except Exception:  # pylint: disable=broad-except
                pass   # a failed write costs the snapshot, never the
                #        loop — the cadence re-arms regardless
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _write_snapshot(self, step: int, payload: Any) -> None:
        from skypilot_tpu_torch.utils import chaos
        # Chaos: an `error` rule drops this snapshot (the write arm of
        # the failure drills); `latency_s` models a slow disk.
        chaos.inject('ckpt.write', rank=self.rank, step=step)
        blob = self._serializer(payload)
        digest = hashlib.sha256(blob).hexdigest()
        rank_dir = self._rank_dir()
        os.makedirs(rank_dir, exist_ok=True)
        shard_name = f'{_SHARD_PREFIX}{step}.bin'
        manifest = {
            'step': int(step),
            'incarnation': self.incarnation,
            'rank': self.rank,
            'digest': digest,
            'shard': shard_name,
            'bytes': len(blob),
            'ts': time.time(),
        }
        _atomic_write(os.path.join(rank_dir, shard_name), blob)
        _atomic_write(
            os.path.join(rank_dir, f'{_MANIFEST_PREFIX}{step}.json'),
            json.dumps(manifest).encode())
        _prune_dir(rank_dir, keep_snapshots())
        self.last_step = int(step)
        self._account_write(manifest)
        self._replicate(blob, manifest)
        if self._storage_save is not None:
            self._storage_save(step, payload)
            self.last_storage_step = int(step)

    def _account_write(self, manifest: Dict[str, Any]) -> None:
        try:
            from skypilot_tpu_torch.agent import telemetry
            _inc('xsky_ckpt_writes_total', 1.0)
            _inc('xsky_ckpt_bytes_total', float(manifest['bytes']))
            # The freshness signal rides the rank's telemetry sample:
            # the pull→record path persists ckpt_step/ckpt_ts and the
            # server renders the scrape-time freshness-age gauge.
            telemetry.emit(ckpt_step=manifest['step'],
                           ckpt_ts=manifest['ts'])
        except Exception:  # pylint: disable=broad-except
            pass

    def _replicate(self, blob: bytes,
                   manifest: Dict[str, Any]) -> None:
        """Copy the newest shard + manifest (the in-memory blob — no
        re-read of the file just written) to the K peer roots, one
        thread per peer. Peer failures (chaos, unreachable DCN path,
        full disk) cost that replica only."""
        if not self.peer_dirs:
            return
        from concurrent import futures
        from skypilot_tpu_torch.utils import chaos
        from skypilot_tpu_torch.utils import tracing
        step = manifest['step']

        def _copy(peer_dir: str) -> bool:
            try:
                chaos.inject('ckpt.replicate', rank=self.rank,
                             step=step, peer=peer_dir)
                target = os.path.join(os.path.expanduser(peer_dir),
                                      f'peer-rank-{self.rank}')
                os.makedirs(target, exist_ok=True)
                _atomic_write(os.path.join(target, manifest['shard']),
                              blob)
                _atomic_write(
                    os.path.join(target,
                                 f'{_MANIFEST_PREFIX}{step}.json'),
                    json.dumps(manifest).encode())
                _prune_dir(target, keep_snapshots())
                return True
            except Exception:  # pylint: disable=broad-except
                return False

        try:
            with tracing.request_span(None, 'ckpt.replicate',
                                      rank=self.rank, step=step,
                                      peers=len(self.peer_dirs)):
                with futures.ThreadPoolExecutor(
                        len(self.peer_dirs)) as pool:
                    list(pool.map(_copy, self.peer_dirs))
        except Exception:  # pylint: disable=broad-except
            pass

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the worker drained (tests, final-save barriers).
        Returns False on timeout."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self._cv:
            while self._pending is not None or self._busy:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cv.wait(remaining if remaining is not None
                              else 0.5)
        return True

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    # ---- restore side ------------------------------------------------------

    def restore_impl(self, storage_fn: Optional[
            Callable[[], Optional[Tuple[int, Any]]]] = None,
            storage_step_fn: Optional[Callable[[], Optional[int]]]
            = None) -> Snapshot:
        """Tier walk under the restore span (callers go through the
        module-level never-raise wrapper)."""
        from skypilot_tpu_torch.utils import tracing
        with tracing.request_span(None, 'jobs.ckpt_restore',
                                  rank=self.rank,
                                  incarnation=self.incarnation):
            return self._restore_ladder(storage_fn, storage_step_fn)

    def _restore_ladder(self, storage_fn,
                        storage_step_fn=None) -> Snapshot:
        """Freshest-first across local → peer (torn/corrupt manifests
        discarded) → storage → cold. ``storage_step_fn`` (cheap
        latest-step probe) lets a fresher storage tier outrank stale
        fast-tier copies. Each candidate read traverses the
        ``ckpt.restore`` chaos point so fault plans can force every
        arm."""
        from skypilot_tpu_torch.utils import chaos
        t0 = time.monotonic()
        candidates = (self._scan_tier((self.base_dir,), TIER_LOCAL) +
                      self._scan_tier(self.peer_dirs, TIER_PEER))
        # Freshest first; at equal step the rank's OWN shard wins
        # over another rank's replica, then the local tier over a
        # peer copy (no transfer). Cross-rank restore stays allowed —
        # snapshots are gang-synchronized state, and after an elastic
        # shrink the renumbered rank's host holds the old rank's
        # shard by construction.
        candidates.sort(
            key=lambda c: (-c['manifest']['step'],
                           0 if c['manifest'].get('rank') == self.rank
                           else 1,
                           0 if c['tier'] == TIER_LOCAL else 1))
        best_seen = max((c['manifest']['step'] for c in candidates),
                        default=0)
        storage_step = None
        if storage_fn is not None and storage_step_fn is not None:
            try:
                storage_step = storage_step_fn()
            except Exception:  # pylint: disable=broad-except
                storage_step = None
        if storage_step is not None:
            best_seen = max(best_seen, int(storage_step))
        tried_storage = False
        for cand in candidates:
            manifest = cand['manifest']
            if not tried_storage and storage_step is not None and \
                    manifest['step'] < storage_step:
                # Storage holds something fresher than every
                # remaining fast-tier copy: try it now; on failure
                # keep walking the fast tiers.
                tried_storage = True
                snap = self._try_storage(storage_fn, t0, best_seen)
                if snap is not None:
                    return snap
            try:
                chaos.inject('ckpt.restore', tier=cand['tier'],
                             step=manifest['step'], rank=self.rank)
                blob = _read_verified(cand['dir'], manifest)
                if blob is None:
                    continue
                payload = self._deserializer(blob)
            except Exception:  # pylint: disable=broad-except
                continue   # corrupt shard / injected fault: next
                #            candidate (older copy, then next tier)
            snap = Snapshot(manifest['step'], payload, cand['tier'],
                            time.monotonic() - t0, manifest)
            self._account_restore(snap, best_seen)
            return snap
        if storage_fn is not None and not tried_storage:
            snap = self._try_storage(storage_fn, t0, best_seen)
            if snap is not None:
                return snap
        snap = Snapshot(0, None, TIER_COLD, time.monotonic() - t0)
        self._account_restore(snap, best_seen)
        return snap

    def _try_storage(self, storage_fn, t0: float,
                     best_seen: int) -> Optional[Snapshot]:
        from skypilot_tpu_torch.utils import chaos
        try:
            chaos.inject('ckpt.restore', tier=TIER_STORAGE,
                         rank=self.rank)
            result = storage_fn()
            if result is None:
                return None
            step, payload = result
        except Exception:  # pylint: disable=broad-except
            return None
        snap = Snapshot(step, payload, TIER_STORAGE,
                        time.monotonic() - t0)
        self._account_restore(snap, max(best_seen, int(step)))
        return snap

    @staticmethod
    def _scan_tier(dirs, tier: str) -> List[Dict[str, Any]]:
        """Every parseable manifest under the tier's base dirs.
        Unreadable dirs and torn manifests are simply absent."""
        out: List[Dict[str, Any]] = []
        for base in dirs:
            base = os.path.expanduser(base)
            try:
                subdirs = [os.path.join(base, d)
                           for d in os.listdir(base)]
            except OSError:
                continue
            for sub in subdirs:
                try:
                    names = os.listdir(sub)
                except OSError:
                    continue
                for name in names:
                    if not (name.startswith(_MANIFEST_PREFIX) and
                            name.endswith('.json')):
                        continue
                    manifest = _parse_manifest(
                        os.path.join(sub, name))
                    if manifest is not None:
                        out.append({'tier': tier, 'dir': sub,
                                    'manifest': manifest})
        return out

    def _account_restore(self, snap: Snapshot,
                         best_seen: int) -> None:
        """Count the restore and note it on the restore span (never
        raises): tier, latency, resumed step, and the replayed-step
        bound (the freshest step any manifest advertised minus what we
        actually resumed at). The reference also journals it in the
        control plane's state DB, which the port does not carry."""
        try:
            from skypilot_tpu_torch.utils import tracing
            _inc(f'xsky_ckpt_restores_total{{tier="{snap.tier}"}}', 1.0)
            with tracing.request_span(
                    None, 'job.ckpt_restored', tier=snap.tier,
                    rank=self.rank, resume_step=snap.step,
                    replayed_steps=max(0, best_seen - snap.step),
                    latency_s=round(snap.latency_s, 6),
                    incarnation=self.incarnation):
                pass
        except Exception:  # pylint: disable=broad-except
            pass


# ---- counters (the reference's /metrics names) ------------------------------

_counter_lock = threading.Lock()
_counters: Dict[str, float] = {}


def _inc(name: str, value: float) -> None:
    with _counter_lock:
        _counters[name] = _counters.get(name, 0.0) + value


def counters() -> Dict[str, float]:
    """Writes, bytes and restores (by tier) counted in this process,
    under the reference's ``xsky_ckpt_*_total`` names."""
    with _counter_lock:
        return dict(_counters)


# ---- manifest/shard helpers -------------------------------------------------


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'wb') as f:
        f.write(blob)
    os.replace(tmp, path)


def _parse_manifest(path: str) -> Optional[Dict[str, Any]]:
    """One manifest file → dict, or None when torn/invalid — a corrupt
    manifest is discarded evidence, never an error."""
    try:
        with open(path, 'rb') as f:
            manifest = json.loads(f.read().decode('utf-8'))
    except (OSError, ValueError):
        return None
    if not isinstance(manifest, dict):
        return None
    if not isinstance(manifest.get('step'), int) or \
            not isinstance(manifest.get('digest'), str) or \
            not isinstance(manifest.get('shard'), str):
        return None
    return manifest


def _read_verified(directory: str,
                   manifest: Dict[str, Any]) -> Optional[bytes]:
    """The shard bytes iff they match the manifest digest (a torn
    shard under a valid manifest is as discarded as a torn manifest)."""
    try:
        with open(os.path.join(directory, manifest['shard']),
                  'rb') as f:
            blob = f.read()
    except OSError:
        return None
    if hashlib.sha256(blob).hexdigest() != manifest['digest']:
        return None
    return blob


def _prune_dir(directory: str, keep: int) -> None:
    """Keep the newest ``keep`` (manifest, shard) pairs; older copies
    ARE the torn-write fallback, so never prune below 1."""
    try:
        steps = sorted(
            int(n[len(_MANIFEST_PREFIX):-len('.json')])
            for n in os.listdir(directory)
            if n.startswith(_MANIFEST_PREFIX) and n.endswith('.json')
            and n[len(_MANIFEST_PREFIX):-len('.json')].isdigit())
    except OSError:
        return
    for step in steps[:-keep] if len(steps) > keep else []:
        for name in (f'{_MANIFEST_PREFIX}{step}.json',
                     f'{_SHARD_PREFIX}{step}.bin'):
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass


# ---- process-wide checkpointer (mirrors telemetry's emitter) ---------------

_ckpt_lock = threading.Lock()
_checkpointer: Optional[Checkpointer] = None
_ckpt_key = None   # (dir, rank, peers) env values the cache was built from


def _current() -> Optional[Checkpointer]:
    """Resolve the process-wide checkpointer from the environment;
    rebuild when the gang wiring changed (a fresh incarnation in the
    same process). Steady state: two dict lookups + a tuple compare."""
    global _checkpointer, _ckpt_key
    if os.environ.get(ENV_ENABLED, '1') == '0':
        return None
    if _ckpt_key == '<installed>':
        # An explicitly installed pipeline (train/launch.py with its
        # storage tier wired) always wins over env resolution.
        return _checkpointer
    directory = os.environ.get(ENV_DIR)
    if not directory:
        return None
    key = (directory, os.environ.get('XSKY_HOST_RANK', '0'),
           os.environ.get(ENV_PEER_DIRS, ''))
    if key == _ckpt_key and _checkpointer is not None:
        return _checkpointer
    with _ckpt_lock:
        if key != _ckpt_key or _checkpointer is None:
            if _checkpointer is not None:
                _checkpointer.stop()
            _checkpointer = Checkpointer.from_env()
            _ckpt_key = key
        return _checkpointer


def install(checkpointer: Optional[Checkpointer]) -> None:
    """Install a custom-built checkpointer (``train/launch.py`` wires
    its storage tier in) as the process-wide one."""
    global _checkpointer, _ckpt_key
    with _ckpt_lock:
        if _checkpointer is not None and \
                _checkpointer is not checkpointer:
            _checkpointer.stop()
        _checkpointer = checkpointer
        _ckpt_key = '<installed>' if checkpointer is not None else None


def reset_for_test() -> None:
    install(None)
    with _counter_lock:
        _counters.clear()


def enabled() -> bool:
    return _current() is not None


# ---- never-raise entry points (the xskylint contract map names these) ------


def maybe_checkpoint(step: int, payload_fn: Callable[[], Any],
                     step_time_s: Optional[float] = None,
                     force: bool = False) -> bool:
    """Snapshot this rank's state if the cadence says so. NEVER raises
    and with the plane disabled (``XSKY_CKPT=0`` / no dir) returns
    after one env lookup — safe on any step loop. The step path pays
    only the cadence check and ``payload_fn`` (the device→host copy);
    serialize/write/replicate/storage ride the ``xsky-ckptd`` worker.
    """
    try:
        ckpt = _current()
        if ckpt is None:
            return False
        return ckpt.maybe_checkpoint_impl(step, payload_fn,
                                          step_time_s=step_time_s,
                                          force=force)
    except Exception:  # pylint: disable=broad-except
        return False


def restore(storage_fn: Optional[
        Callable[[], Optional[Tuple[int, Any]]]] = None,
        storage_step_fn: Optional[Callable[[], Optional[int]]] = None
        ) -> Optional[Snapshot]:
    """Restore the freshest valid snapshot: local → peer → storage →
    cold (a :class:`Snapshot` with ``tier='cold'``, step 0).
    ``storage_step_fn`` is a cheap latest-step probe that lets a
    fresher storage tier outrank stale fast-tier copies. NEVER
    raises; None only when the plane is disabled entirely."""
    fallback = None
    try:
        ckpt = _current()
        if ckpt is None:
            return fallback
        return ckpt.restore_impl(storage_fn, storage_step_fn)
    except Exception:  # pylint: disable=broad-except
        return fallback


def wait_idle(timeout: Optional[float] = None) -> bool:
    """Drain the background writer (end-of-run barrier). NEVER
    raises; True when idle (or no plane is active)."""
    try:
        ckpt = _current()
        if ckpt is None:
            return True
        return ckpt.wait_idle(timeout)
    except Exception:  # pylint: disable=broad-except
        return True
