"""Device performance profiling, workload half: step anatomy, compiles, HBM,
capture.

Copy of the workload side of ``skypilot_tpu/agent/profiler.py`` (the port
imports nothing of the reference), with the same env names, defaults and
summary keys, so the reference's control plane reads a port workload's
samples with its own ``record_profiles`` / ``verdicts_for``:

  * an **always-on step-anatomy sampler**: the workload's step loop
    (``train/trainer.py``, ``infer/orchestrator.py``) brackets every
    Nth step with a :func:`step_probe`, splitting the host **dispatch
    gap** (time for the step's call to return, its kernels queued) from
    **device compute** (timed around a wait for the card). Unsampled
    steps pay two dict lookups and an increment; a sampled step pays one
    wait for its stream;
  * a **compile listener**: the port compiles its kernels with ``nvcc``
    (``ops/kernels.py``), so a build that runs counts as one compile and
    its seconds; a library loaded from the content-hash cache counts
    nothing. Compiles after the warmup window are the recompile-storm
    signal, as in the reference;
  * **HBM watermarks** (bytes in use / limit / peak seen) from the
    caching allocator and the card's total memory (see
    :func:`_hbm_stats`);
  * an **on-demand deep capture** (``python -m
    skypilot_tpu_torch.agent.profiler capture --out DIR``): dispatch RTT,
    a device matmul's time, a first-launch probe, HBM stats, and a
    ``torch.profiler`` trace exported as Chrome JSON under ``DIR``.

The sampler's summary rides the telemetry spool as the ``profile`` key of
the rank's sample (``telemetry.emit(profile=...)``).

**Fake-profiler seam**: with ``XSKY_PROFILER_FAKE=1`` every device touch
is replaced by the reference's synthetic values (env-tunable). Chaos:
``profiler.dispatch_stall`` fires inside a sampled probe and inflates the
measured dispatch gap (rule key ``gap_s``, default 0.25).

Not carried over: the control-plane half (``verdicts_for``,
``record_profiles``, ``capture_summary_row``, the staleness rule and the
verdict thresholds' env names), which reads the port's samples
unchanged.

Never-raise discipline throughout: the sampler instruments the very step
loop whose throughput it measures. torch is imported only where a device
is touched, never at import.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

ENV_ENABLED = 'XSKY_PROFILE'                  # "0" disables the sampler
ENV_SAMPLE_EVERY = 'XSKY_PROFILE_SAMPLE_EVERY'
ENV_WARMUP_STEPS = 'XSKY_PROFILE_WARMUP_STEPS'
# Fake-profiler seam (CPU tests): synthetic device values.
ENV_FAKE = 'XSKY_PROFILER_FAKE'
ENV_FAKE_DISPATCH = 'XSKY_PROFILER_FAKE_DISPATCH_S'
ENV_FAKE_DEVICE = 'XSKY_PROFILER_FAKE_DEVICE_S'
ENV_FAKE_HBM_USE = 'XSKY_PROFILER_FAKE_HBM_USE'
ENV_FAKE_HBM_LIMIT = 'XSKY_PROFILER_FAKE_HBM_LIMIT'

# Sample every Nth step: a sampled step pays one wait for the card, so
# the default keeps it amortized while the EMAs converge within ~100
# steps.
_DEFAULT_SAMPLE_EVERY = 16
# Steps before compiles stop being "warmup": a healthy workload builds
# its kernels up front and then never again.
_DEFAULT_WARMUP_STEPS = 8

_DEFAULT_FAKE_DISPATCH_S = 0.001
_DEFAULT_FAKE_DEVICE_S = 0.004
_DEFAULT_FAKE_HBM_USE = 2 << 30
_DEFAULT_FAKE_HBM_LIMIT = 16 << 30

# The capture's matmul probe: one [1024, 1024] bf16 product, summed.
_CAPTURE_MATMUL = 1024
TRACE_FILE = 'trace.json'


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def warmup_steps() -> int:
    return _env_int(ENV_WARMUP_STEPS, _DEFAULT_WARMUP_STEPS)


def fake_mode() -> bool:
    return os.environ.get(ENV_FAKE, '0') not in ('0', '')


# ---- step-anatomy sampler (workload-process side) --------------------------


class _Anatomy:
    """One process's accumulated step anatomy."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        # Bumped un-locked on every step_probe() call (the hot path); a
        # rare GIL-raced loss of one increment only shifts which step
        # gets sampled.
        self.steps_seen = 0
        self.steps_sampled = 0
        self.dispatch_gap_ema_s: Optional[float] = None
        self.device_ema_s: Optional[float] = None
        self.compiles_total = 0
        self.compile_seconds_total = 0.0
        self.compiles_after_warmup = 0
        self.hbm_bytes_in_use: Optional[int] = None
        self.hbm_bytes_limit: Optional[int] = None
        self.hbm_peak_bytes: Optional[int] = None

    def note_compile(self, seconds: float) -> None:
        with self.lock:
            self.compiles_total += 1
            self.compile_seconds_total += float(seconds)
            if self.steps_seen > warmup_steps():
                self.compiles_after_warmup += 1

    def observe_step(self, dispatch_gap_s: float, device_s: float) -> None:
        from skypilot_tpu_torch.agent import telemetry
        hbm = _hbm_stats()
        with self.lock:
            self.steps_sampled += 1
            self.dispatch_gap_ema_s = telemetry.ema(
                self.dispatch_gap_ema_s, dispatch_gap_s)
            self.device_ema_s = telemetry.ema(self.device_ema_s, device_s)
            in_use = hbm.get('bytes_in_use')
            if in_use is not None:
                self.hbm_bytes_in_use = int(in_use)
                self.hbm_peak_bytes = max(self.hbm_peak_bytes or 0,
                                          int(in_use))
            limit = hbm.get('bytes_limit')
            if limit is not None:
                self.hbm_bytes_limit = int(limit)
            snap = self._snapshot_locked()
        # Outside the lock: emit serializes and may write the spool.
        telemetry.emit(profile=snap)

    def _snapshot_locked(self) -> Dict[str, Any]:
        gap, dev = self.dispatch_gap_ema_s, self.device_ema_s
        ratio = None
        if gap is not None and dev is not None and gap + dev > 0:
            ratio = gap / (gap + dev)
        return {
            'ts': time.time(),
            'steps_seen': self.steps_seen,
            'steps_sampled': self.steps_sampled,
            'dispatch_gap_ema_s': gap,
            'device_ema_s': dev,
            'dispatch_gap_ratio': ratio,
            'compiles_total': self.compiles_total,
            'compile_seconds_total': round(self.compile_seconds_total, 6),
            'compiles_after_warmup': self.compiles_after_warmup,
            'hbm_bytes_in_use': self.hbm_bytes_in_use,
            'hbm_bytes_limit': self.hbm_bytes_limit,
            'hbm_peak_bytes': self.hbm_peak_bytes,
        }

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            return self._snapshot_locked()


_anatomy_lock = threading.Lock()
_anatomy: Optional[_Anatomy] = None
# (ENV_ENABLED, ENV_SAMPLE_EVERY) raw values the cached config was built
# from: step_probe() is on the step loop, so the steady-state resolve is
# two dict lookups, a tuple compare and a modulo.
_cfg_key = None
_cfg: Optional[int] = None   # sample-every, or None when disabled


def _get_anatomy() -> _Anatomy:
    global _anatomy
    if _anatomy is None:
        with _anatomy_lock:
            if _anatomy is None:
                _anatomy = _Anatomy()
    return _anatomy


def snapshot() -> Dict[str, Any]:
    """The process's current profile summary (the spool's ``profile``)."""
    return _get_anatomy().snapshot()


def _sample_every() -> Optional[int]:
    """Sampling cadence, or None when the sampler is disabled."""
    global _cfg_key, _cfg
    key = (os.environ.get(ENV_ENABLED),
           os.environ.get(ENV_SAMPLE_EVERY))
    if key == _cfg_key:
        return _cfg
    if key[0] == '0':
        cfg = None
    else:
        try:
            cfg = max(1, int(key[1])) if key[1] else _DEFAULT_SAMPLE_EVERY
        except ValueError:
            cfg = _DEFAULT_SAMPLE_EVERY
    _cfg, _cfg_key = cfg, key
    return cfg


def _hbm_stats(device: Any = None) -> Dict[str, Any]:
    """bytes_in_use / bytes_limit of the card (best effort).

    The reference reads XLA's ``memory_stats()``: ``bytes_in_use``, the
    bytes its allocator has handed to live buffers, and ``bytes_limit``,
    the device memory that allocator may use. Their counterparts here
    are the caching allocator's ``allocated_bytes.all.current`` (bytes
    in live tensors; its reserved-but-free cache is not in use) and the
    card's total from ``torch.cuda.mem_get_info`` (what the caching
    allocator may grow to). A process that has touched no card (a CPU
    workload) reports ``{}``.
    """
    if fake_mode():
        return {
            'bytes_in_use': _env_int(ENV_FAKE_HBM_USE,
                                     _DEFAULT_FAKE_HBM_USE),
            'bytes_limit': _env_int(ENV_FAKE_HBM_LIMIT,
                                    _DEFAULT_FAKE_HBM_LIMIT),
        }
    try:
        import torch
        if not torch.cuda.is_initialized():
            return {}
        dev = torch.cuda.current_device() if device is None else device
        stats = torch.cuda.memory_stats(dev)
        return {'bytes_in_use': stats.get('allocated_bytes.all.current'),
                'bytes_limit': torch.cuda.mem_get_info(dev)[1]}
    except Exception:  # pylint: disable=broad-except
        return {}


def _cuda_devices(out: Any, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (nested dicts, lists
    and tuples), at most one tensor looked at per device."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            _cuda_devices(item, found)
    elif getattr(out, 'is_cuda', False) and out.device not in found:
        found.add(out.device)
    return found


def wait_for_device(out: Any) -> None:
    """Wait until the work queued for ``out`` is done: for CUDA tensors
    in ``out``, a synchronize of their device's current stream (the
    stream the step was queued on). Reads no value; a CPU ``out`` has
    nothing to wait for."""
    devices = _cuda_devices(out, set())
    if devices:
        import torch
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()


class _StepProbe:
    """Brackets ONE sampled step: dispatch gap vs device compute."""

    __slots__ = ('_anatomy', '_t0', '_t1')

    def __init__(self, anatomy: _Anatomy) -> None:
        self._anatomy = anatomy
        self._t0 = time.perf_counter()
        self._t1: Optional[float] = None

    def dispatched(self) -> None:
        """Mark the step's call returning (host dispatch done). Callers
        whose device wait is a separate blocking call (the serving
        tick's host copy) call this, then :meth:`done` after the wait;
        callers with the step output in hand just call ``done(out)``."""
        self._t1 = time.perf_counter()

    def done(self, out: Any = None) -> Optional[tuple]:
        """Finish the probe. NEVER raises — it sits on the step loop.

        The card's stream is waited on for the CUDA tensors of ``out``
        (:func:`wait_for_device`) to time device compute; with
        ``dispatched()`` already called and no ``out``, device time is
        the wall since the dispatch mark.

        Returns the measured ``(dispatch_gap_s, device_s)`` pair (None
        on failure) so the flight recorder's step seal shares THIS
        probe's timestamps: one device wait per sampled step.
        """
        try:
            t1 = self._t1 if self._t1 is not None else time.perf_counter()
            if out is not None and not fake_mode():
                try:
                    wait_for_device(out)
                except Exception:  # pylint: disable=broad-except
                    pass
            t2 = time.perf_counter()
            gap = t1 - self._t0
            device = t2 - t1
            if fake_mode():
                # Synthetic anatomy: the seam supplies the split.
                gap = _env_float(ENV_FAKE_DISPATCH,
                                 _DEFAULT_FAKE_DISPATCH_S)
                device = _env_float(ENV_FAKE_DEVICE,
                                    _DEFAULT_FAKE_DEVICE_S)
            try:
                from skypilot_tpu_torch.utils import chaos
                rule = chaos.inject(
                    'profiler.dispatch_stall',
                    rank=_env_int('XSKY_HOST_RANK', 0))
                if rule is not None:
                    # Inject a host-bound anatomy without slowing the
                    # step: the measured gap grows by the rule's gap_s.
                    gap += float(rule.get('gap_s', 0.25))
            except Exception:  # pylint: disable=broad-except
                pass
            self._anatomy.observe_step(gap, device)
            return (gap, device)
        except Exception:  # pylint: disable=broad-except
            return None


def step_probe() -> Optional[_StepProbe]:
    """Begin one step's anatomy probe, or None when this step is not
    sampled (the common path: two dict lookups, an increment and a
    modulo). Call right before dispatching the step; call ``.done(out)``
    right after. NEVER raises."""
    try:
        every = _sample_every()
        if every is None:
            return None
        anatomy = _get_anatomy()
        anatomy.steps_seen += 1
        if anatomy.steps_seen % every:
            return None
        return _StepProbe(anatomy)
    except Exception:  # pylint: disable=broad-except
        return None


def record_compile(seconds: float) -> None:
    """Count one compile event (the listener's entry point; also the
    fake seam's). NEVER raises."""
    try:
        _get_anatomy().note_compile(seconds)
    except Exception:  # pylint: disable=broad-except
        pass


_listener_installed = False


def ensure_compile_listener() -> None:
    """Start counting the port's compiles in this process (idempotent,
    never raises): from here on each ``nvcc`` build that
    ``ops/kernels.py`` runs reports its seconds through
    :func:`note_kernel_build`. In fake mode nothing is installed and
    nothing is latched, as in the reference: fake workloads drive
    :func:`record_compile` directly."""
    global _listener_installed
    if _listener_installed or fake_mode():
        return
    _listener_installed = True


def note_kernel_build(seconds: float) -> None:
    """``ops/kernels.py`` calls this after each ``nvcc`` build it ran (a
    library reused from the cache is no build): one compile once the
    listener is installed, nothing before. NEVER raises."""
    if _listener_installed:
        record_compile(seconds)


# ---- on-demand deep capture ------------------------------------------------


def run_capture(out_dir: str, duration_s: float = 1.0,
                device: Any = None) -> Dict[str, Any]:
    """Self-contained device deep-probe for one host.

    Measures, independently of any running workload: per-dispatch
    host → device round trip (``dispatch_rtt_ms``: a tiny op and a wait
    for the stream, repeated), a device matmul's time
    (``device_matmul_ms``), and ``probe_compile_s``: the first launch of
    an op that no workload of the port uses (``torch.special.bessel_j0``,
    which PyTorch builds at run time on the card), the nearest
    counterpart of the reference's cold ``jax.jit`` compile. Plus HBM
    stats and a ``torch.profiler`` trace of the probes exported as
    Chrome JSON (``trace.json``) under ``out_dir``. In fake mode every
    device touch is synthetic (env-tunable) and a ``capture.json``
    stands in for the trace.

    ``device`` None means the card (raises without one); ``'cpu'`` probes
    the CPU. Raises only for that and for an unwritable ``out_dir``.
    """
    os.makedirs(os.path.expanduser(out_dir), exist_ok=True)
    summary: Dict[str, Any] = {
        'ts': time.time(),
        'duration_s': duration_s,
        'out_dir': out_dir,
        'fake': fake_mode(),
    }
    if fake_mode():
        dispatch_s = _env_float(ENV_FAKE_DISPATCH,
                                _DEFAULT_FAKE_DISPATCH_S)
        device_s = _env_float(ENV_FAKE_DEVICE, _DEFAULT_FAKE_DEVICE_S)
        summary.update({
            'device_kind': 'fake-tpu',
            'num_devices': 1,
            'dispatch_rtt_ms': dispatch_s * 1000.0,
            'device_matmul_ms': device_s * 1000.0,
            'probe_compile_s': 0.01,
            'dispatch_probes': 16,
            **_hbm_stats(),
        })
        path = os.path.join(os.path.expanduser(out_dir), 'capture.json')
        with open(path, 'w', encoding='utf-8') as f:
            f.write(json.dumps(summary, default=str))
        summary['trace_files'] = ['capture.json']
        return summary
    from skypilot_tpu_torch import resolve_device
    return _real_capture(out_dir, duration_s, summary,
                         resolve_device(device))


def _real_capture(out_dir: str, duration_s: float, summary: Dict[str, Any],
                  device) -> Dict[str, Any]:
    import torch
    from torch import profiler as torch_profiler
    on_card = device.type == 'cuda'

    def wait() -> None:
        if on_card:
            torch.cuda.current_stream(device).synchronize()

    if on_card:
        summary['device_kind'] = torch.cuda.get_device_name(device)
        summary['num_devices'] = torch.cuda.device_count()
    else:
        summary['device_kind'] = 'cpu'
        summary['num_devices'] = 1
    activities = [torch_profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch_profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch_profiler.profile(activities=activities)
        prof.__enter__()
    except Exception:  # pylint: disable=broad-except
        prof = None
    try:
        budget = max(float(duration_s), 0.2)
        x = torch.zeros((3,), dtype=torch.float32, device=device)
        wait()   # the context exists before the first-launch probe
        t0 = time.perf_counter()
        _ = torch.special.bessel_j0(x)
        wait()
        summary['probe_compile_s'] = round(time.perf_counter() - t0, 6)
        # Dispatch RTT: tiny waited-on dispatches.
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < budget / 2 and n < 200:
            _ = x * 2 + 1
            wait()
            n += 1
        summary['dispatch_probes'] = n
        summary['dispatch_rtt_ms'] = round(
            (time.perf_counter() - t0) / max(n, 1) * 1000.0, 3)
        # Device step time: a bandwidth-ish matmul.
        m = torch.ones((_CAPTURE_MATMUL, _CAPTURE_MATMUL),
                       dtype=torch.bfloat16, device=device)
        _ = (m @ m).sum()
        wait()   # first launch outside the timing
        k = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < budget / 2 and k < 100:
            _ = (m @ m).sum()
            wait()
            k += 1
        summary['device_matmul_ms'] = round(
            (time.perf_counter() - t0) / max(k, 1) * 1000.0, 3)
        summary.update({'bytes_in_use': None, 'bytes_limit': None,
                        **_hbm_stats(device if on_card else None)})
    except Exception as e:  # pylint: disable=broad-except
        summary['error'] = f'{type(e).__name__}: {e}'
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(
                    os.path.expanduser(out_dir), TRACE_FILE))
            except Exception:  # pylint: disable=broad-except
                pass
    try:
        files = []
        for root, _, names in os.walk(os.path.expanduser(out_dir)):
            for name in names:
                files.append(os.path.relpath(os.path.join(root, name),
                                             os.path.expanduser(out_dir)))
        summary['trace_files'] = sorted(files)[:50]
    except OSError:
        pass
    return summary


def reset_for_test() -> None:
    global _anatomy, _cfg, _cfg_key
    with _anatomy_lock:
        _anatomy = None
    _cfg, _cfg_key = None, None


# ---- CLI (`python -m skypilot_tpu_torch.agent.profiler capture ...`) -------


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.agent.profiler',
        description='Per-host device profiling agent.')
    sub = parser.add_subparsers(dest='cmd', required=True)
    cap = sub.add_parser('capture', help='Run one deep device capture; '
                                         'prints a one-line JSON summary.')
    cap.add_argument('--out', required=True,
                     help='Directory for the capture artifacts.')
    cap.add_argument('--duration', type=float, default=1.0)
    cap.add_argument('--device', default=None,
                     help="'cpu' to probe the CPU; default: the card")
    args = parser.parse_args(argv)
    if args.cmd == 'capture':
        summary = run_capture(args.out, args.duration, args.device)
        print(json.dumps(summary, default=str))
        return 0
    return 2


if __name__ == '__main__':
    import sys
    sys.exit(main())
