"""Token data pipeline: native C++ loader with a pure-python twin.

Counterpart of ``skypilot_tpu/train/data.py`` (the port imports nothing
of the reference). Shards are raw little-endian uint32 token streams
(``*.bin``). Sample i is the token window ``[i*seq, i*seq + seq + 1)`` —
inputs and shifted targets come from one contiguous read. Epochs are
seeded shuffles; data-parallel hosts take strided slices of the same
permutation, so the fleet partitions each epoch without communication.

The native path (``skypilot_tpu_torch/native/dataloader.cc``, a copy of
the reference's source) mmaps shards and prefetches batches from worker
threads so host input prep overlaps device steps; it is compiled on
first use with g++ and cached under ``~/.xsky/native/`` (or
``$XSKY_NATIVE_CACHE``), keyed by source hash. When no compiler is
available the python loader provides the same semantics, just without
threaded prefetch. Each flavor gives the rows the reference's loader of
the same flavor gives for the same shards and seed.

One addition: ``skip(n_batches)`` on both loaders, which a resumed run
uses to continue the stream where its checkpoint left it.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'native', 'dataloader.cc')


def _cache_dir() -> str:
    return os.path.expanduser(
        os.environ.get('XSKY_NATIVE_CACHE', '~/.xsky/native'))


def build_native_lib() -> Optional[str]:
    """Compile (or reuse) libxsky_dataloader.so; None if unbuildable."""
    if not os.path.exists(_SOURCE):
        return None
    with open(_SOURCE, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f'libxsky_dataloader-{digest}.so')
    if os.path.exists(out):
        return out
    os.makedirs(_cache_dir(), exist_ok=True)
    tmp = f'{out}.tmp.{os.getpid()}'
    cmd = ['g++', '-O2', '-shared', '-fPIC', '-std=c++17', '-pthread',
           _SOURCE, '-o', tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        logger.warning(f'native dataloader build failed ({e}); using '
                       'the python loader.')
        return None


def _epoch_order(n_samples: int, seed: int, epoch: int,
                 host_rank: int, num_hosts: int) -> np.ndarray:
    """Identical permutation law to the C++ side (host-strided slice of
    a seeded shuffle) — but not bit-identical across implementations;
    determinism contracts hold within a loader flavor."""
    rng = np.random.Generator(np.random.PCG64(seed * 1000003 + epoch))
    order = rng.permutation(n_samples)
    return order[host_rank::num_hosts]


class PyTokenLoader:
    """Pure-python twin of the native loader (mmap via numpy)."""

    def __init__(self, paths: Sequence[str], batch: int, seq: int,
                 seed: int = 0, host_rank: int = 0,
                 num_hosts: int = 1) -> None:
        self.batch, self.seq = batch, seq
        self.seed = seed
        self.host_rank, self.num_hosts = host_rank, num_hosts
        self._shards = [np.memmap(p, dtype=np.uint32, mode='r')
                        for p in sorted(paths)]
        # Stay mmap-backed (no concatenate: it would copy multi-GB
        # datasets into RAM); rows are read per-shard with stitching
        # only at shard boundaries, like the C++ twin.
        self._offsets = np.cumsum(
            [0] + [int(s.shape[0]) for s in self._shards])
        total = int(self._offsets[-1])
        if total < seq + 1:
            raise ValueError(
                f'{total} tokens < one sample (seq {seq} + 1).')
        self.n_samples = (total - 1) // seq
        self._epoch = 0
        self._order = _epoch_order(self.n_samples, seed, 0, host_rank,
                                   num_hosts)
        self._pos = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def _read_range(self, start: int, count: int,
                    out: np.ndarray) -> None:
        done = 0
        while done < count:
            pos = start + done
            shard = int(np.searchsorted(self._offsets, pos,
                                        side='right')) - 1
            local = pos - int(self._offsets[shard])
            take = min(count - done,
                       int(self._shards[shard].shape[0]) - local)
            out[done:done + take] = self._shards[shard][local:
                                                        local + take]
            done += take

    def __next__(self) -> np.ndarray:
        rows = np.empty((self.batch, self.seq + 1), np.uint32)
        for b in range(self.batch):
            if self._pos >= len(self._order):
                self._epoch += 1
                self._order = _epoch_order(
                    self.n_samples, self.seed, self._epoch,
                    self.host_rank, self.num_hosts)
                self._pos = 0
            start = int(self._order[self._pos]) * self.seq
            self._read_range(start, self.seq + 1, rows[b])
            self._pos += 1
        return rows

    def skip(self, n_batches: int) -> None:
        """Advance past ``n_batches`` batches without reading them: the
        same position ``n_batches`` calls of ``next`` reach."""
        todo = n_batches * self.batch
        while todo > 0:
            if self._pos >= len(self._order):
                self._epoch += 1
                self._order = _epoch_order(
                    self.n_samples, self.seed, self._epoch,
                    self.host_rank, self.num_hosts)
                self._pos = 0
            take = min(todo, len(self._order) - self._pos)
            self._pos += take
            todo -= take

    def close(self) -> None:
        pass


class NativeTokenLoader:
    """ctypes wrapper over libxsky_dataloader.so."""

    def __init__(self, paths: Sequence[str], batch: int, seq: int,
                 seed: int = 0, workers: int = 2, host_rank: int = 0,
                 num_hosts: int = 1,
                 lib_path: Optional[str] = None) -> None:
        lib_path = lib_path or build_native_lib()
        if lib_path is None:
            raise RuntimeError('native dataloader unavailable')
        self.batch, self.seq = batch, seq
        self._lib = ctypes.CDLL(lib_path)
        self._lib.xsky_dl_open.restype = ctypes.c_void_p
        self._lib.xsky_dl_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        self._lib.xsky_dl_next.restype = ctypes.c_int
        self._lib.xsky_dl_next.argtypes = [ctypes.c_void_p,
                                           ctypes.c_void_p]
        self._lib.xsky_dl_num_samples.restype = ctypes.c_longlong
        self._lib.xsky_dl_num_samples.argtypes = [ctypes.c_void_p]
        self._lib.xsky_dl_close.argtypes = [ctypes.c_void_p]
        encoded = [p.encode() for p in sorted(paths)]
        arr = (ctypes.c_char_p * len(encoded))(*encoded)
        self._handle = self._lib.xsky_dl_open(
            arr, len(encoded), batch, seq, seed, workers, host_rank,
            num_hosts)
        if not self._handle:
            raise RuntimeError(
                f'xsky_dl_open failed for {list(paths)[:3]}... '
                '(missing/short shard?)')
        self.n_samples = int(
            self._lib.xsky_dl_num_samples(self._handle))

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty((self.batch, self.seq + 1), np.uint32)
        rc = self._lib.xsky_dl_next(
            self._handle, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise StopIteration
        return out

    def skip(self, n_batches: int) -> None:
        """Advance past ``n_batches`` batches. The C loader has no seek:
        its worker threads fill batches in order, so they are read and
        dropped."""
        for _ in range(n_batches):
            next(self)

    def close(self) -> None:
        if getattr(self, '_handle', None):
            self._lib.xsky_dl_close(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # pylint: disable=broad-except
            pass


def make_loader(paths: Sequence[str], batch: int, seq: int,
                seed: int = 0, workers: int = 2, host_rank: int = 0,
                num_hosts: int = 1, flavor: str = 'auto'):
    """Pick the loader flavor: 'native' | 'python' | 'auto'.

    The two flavors shuffle with different RNGs, so hosts MUST agree on
    one — a mixed fleet would break epoch disjointness (duplicated and
    skipped samples). 'auto' therefore only falls back to python on
    single-host runs; multi-host runs fail fast with instructions
    instead of silently degrading.
    """
    if flavor not in ('auto', 'native', 'python'):
        raise ValueError(f"flavor {flavor!r}: expected auto|native|python")
    if flavor != 'python':
        try:
            return NativeTokenLoader(paths, batch, seq, seed=seed,
                                     workers=workers,
                                     host_rank=host_rank,
                                     num_hosts=num_hosts)
        except (RuntimeError, OSError) as e:
            # OSError: stale/foreign-arch cached .so (shared home dirs
            # across heterogeneous hosts).
            if flavor == 'native':
                raise RuntimeError(
                    f'native data loader unavailable: {e}') from e
            if num_hosts > 1:
                raise RuntimeError(
                    f'native data loader unavailable on host '
                    f'{host_rank} ({e}). Multi-host runs must use one '
                    'flavor fleet-wide: install a C++ toolchain '
                    'everywhere, or pass --data-loader python on every '
                    'host.') from e
            logger.warning(f'{e}; falling back to python loader.')
    return PyTokenLoader(paths, batch, seq, seed=seed,
                         host_rank=host_rank, num_hosts=num_hosts)


def batches(loader, vocab_size: Optional[int] = None
            ) -> Iterator[Dict[str, np.ndarray]]:
    """Loader rows → trainer feed dicts (tokens + shifted targets), as
    numpy arrays; the launcher moves them to the device.

    The hand-off is the step loop's ``data_wait`` phase: the flight
    recorder brackets the blocking ``next()`` plus the clamp/shift prep
    (the whole host input-pipeline cost the device sits idle behind).
    """
    from skypilot_tpu_torch.agent import flight_recorder
    it = iter(loader)
    while True:
        with flight_recorder.phase('data_wait'):
            try:
                rows = next(it)
            except StopIteration:
                return
            if vocab_size is not None:
                # Clamp on the uint32 rows: tokens >= 2^31 would wrap
                # negative after astype and slip past a later clamp.
                rows = np.minimum(rows, np.uint32(vocab_size - 1))
            tokens = rows[:, :-1].astype(np.int32)
            targets = rows[:, 1:].astype(np.int32)
        yield {'tokens': tokens, 'targets': targets}


def expand_data_arg(spec: str) -> List[str]:
    """'--data dir | glob | file.bin[,file2.bin]' → shard paths."""
    import glob as glob_lib
    paths: List[str] = []
    for part in spec.split(','):
        part = os.path.expanduser(part.strip())
        if os.path.isdir(part):
            paths.extend(glob_lib.glob(os.path.join(part, '*.bin')))
        elif any(ch in part for ch in '*?['):
            paths.extend(glob_lib.glob(part))
        elif part:
            paths.append(part)
    if not paths:
        raise FileNotFoundError(f'No token shards match {spec!r}.')
    return sorted(paths)
