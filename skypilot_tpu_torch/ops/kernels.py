"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` source is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``. One source may hold several kernels,
each its own C symbol and its own ``Kernel`` (and launch count); the
source is still compiled once. Libraries land in ``csrc/build/`` (listed
in ``.gitignore``) under a name that hashes the sources and the flags, so
an edited kernel is rebuilt and an unchanged one is reused. Building
happens at first use; ``build_all`` compiles every registered source at
once, one ``nvcc`` process per source, all started together.

Nothing here runs at import: the CPU tests import every module of the
port on machines that have no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')
BUILD_DIR = os.path.join(CSRC_DIR, 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# Element-type codes of csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lock = threading.Lock()


class Kernel:
    """One kernel: its CUDA source, its C entry point, its launch count.

    ``launches`` counts successful launches of the kernel, incremented
    by ``launch`` and nowhere else, so a run can show that its main path
    went through the kernel and not through the plain version.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence) -> None:
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ''
        self._fn = None
        self._error_string = None
        REGISTRY.append(self)

    @property
    def path(self) -> str:
        return os.path.join(CSRC_DIR, self.source)

    def library_path(self) -> str:
        digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
        for name in sorted(os.listdir(CSRC_DIR)):
            if name == self.source or name.endswith('.cuh'):
                with open(os.path.join(CSRC_DIR, name), 'rb') as f:
                    digest.update(f.read())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR,
                            f'{stem}-{digest.hexdigest()[:16]}.so')

    @property
    def loaded(self) -> bool:
        return self._fn is not None

    def _load(self, lib_path: str) -> None:
        lib = ctypes.CDLL(lib_path)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.xsky_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._error_string = fn, err

    def launch(self, *args) -> None:
        """Call the C entry point; raise if the launch was refused."""
        if self._fn is None:
            build_all([self])
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(
                f'CUDA kernel {self.name} failed to launch: '
                f'{self._error_string(code).decode()} (code {code})')
        self.launches += 1


REGISTRY: List[Kernel] = []


def nvcc_path() -> str:
    found = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(found):
        raise RuntimeError(
            'nvcc not found: the CUDA kernels are built from csrc/ at '
            'first use and need the CUDA toolkit.')
    return found


def build_all(kernels: Optional[Sequence[Kernel]] = None
              ) -> Dict[str, float]:
    """Build (or reuse) and load every given kernel, default all of them.

    One nvcc per source, started together. Returns {source: seconds}
    spent building (0.0 for a library that was already built). Raises
    with nvcc's output if any build fails.
    """
    kernels = list(REGISTRY if kernels is None else kernels)
    with _lock:
        todo = [k for k in kernels if not k.loaded]
        seconds = {k.source: 0.0 for k in kernels}
        if not todo:
            return seconds
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = None
        procs = {}
        for k in todo:
            out = k.library_path()
            if os.path.exists(out) or k.source in procs:
                continue
            nvcc = nvcc or nvcc_path()
            tmp = f'{out}.{os.getpid()}.tmp'
            cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, k.path]
            procs[k.source] = (tmp, out, time.perf_counter(),
                               subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT,
                                                text=True))
        failures = []
        for source, (tmp, out, t0, proc) in procs.items():
            log, _ = proc.communicate()
            seconds[source] = time.perf_counter() - t0
            for k in todo:
                if k.source == source:
                    k.build_log = log
            if proc.returncode != 0:
                failures.append(f'--- {source} ---\n{log}')
                continue
            os.replace(tmp, out)
        if failures:
            raise RuntimeError('nvcc failed:\n' + '\n'.join(failures))
        for k in todo:
            k._load(k.library_path())
        return seconds


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device pointer of a tensor for a ctypes.c_void_p argument."""
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
