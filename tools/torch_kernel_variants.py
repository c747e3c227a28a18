#!/usr/bin/env python3
"""Design variants of the split-KV decode walk (K4), of the wgmma dQ
kernel (K3) and of the MLA tensor-core walk (K6), timed on one card
against the kernels as built.

Each variant is a copy of ``skypilot_tpu_torch/csrc/`` with one design
constant changed, built with the same nvcc flags as
``skypilot_tpu_torch/ops/kernels.py`` into a scratch directory and called
through the same C entry point. Variants and the kernels as built are
timed in turn (three rounds) at the main paths' shapes with
``chip_smoke.time_ms`` (device time: the device is held while the host
queues the calls), after checking that each gives the kernel's answer:

  * K4 at the dense serving shape (16 slots of 990-1064 rows, H32/8 D128
    bf16, four caches in turn so none sits in L2): the ring depth
    (kDecodeStages 3, 4), the split length (kDecodeSplitRows 64, 256) and
    the walk for groups of at most 8 heads used for every group;
  * K3 at the training shape (B4 S8192 H16/8 D128 bf16, causal): a
    three-stage (K, V) ring (kDqStages 3);
  * K6 at its main-path shape (16 slots of 990-1064 rows, 16 heads, r
    512, dr 64, bf16 cache, four caches in turn): splits of 128, 160 and
    256 rows, one consumer group, a ring of two stages; and, timed only
    since their answers are wrong, the walk without its score products,
    without its P·V products, with one bf16 term in place of three,
    without the q loads and without the combine pass: what each part
    costs.

    python3 tools/torch_kernel_variants.py [decode] [dq] [mla]

Prints one line per variant (mean device ms and the three rounds) and
writes them to ``chiprun_out/torch_kernel_variants.json``. Needs a CUDA
card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from skypilot_tpu_torch.ops import decode_attention as dec  # noqa: E402
from skypilot_tpu_torch.ops import flash_attention as fl  # noqa: E402
from skypilot_tpu_torch.ops import kernels  # noqa: E402
from skypilot_tpu_torch.ops import mla_decode as mla  # noqa: E402

# name: (source, {file: [(pattern, replacement)]})
DECODE_VARIANTS = {
    'decode: 3 ring stages': {
        'decode_common.cuh': [(r'kDecodeStages = \d+;', 'kDecodeStages = 3;')]},
    'decode: 4 ring stages': {
        'decode_common.cuh': [(r'kDecodeStages = \d+;', 'kDecodeStages = 4;')]},
    'decode: splits of 64 rows': {
        'decode_common.cuh': [(r'kDecodeSplitRows = \d+;',
                               'kDecodeSplitRows = 64;')]},
    'decode: splits of 256 rows': {
        'decode_common.cuh': [(r'kDecodeSplitRows = \d+;',
                               'kDecodeSplitRows = 256;')]},
    'decode: the groups-of-8 walk for every group': {
        'decode_attention.cu': [(r'if \(dp\.p\.groups <= 4\)',
                                 'if (dp.p.groups < 0)')]},
}
# The MLA tensor-core walk (K6). Those marked "without" drop work and
# give wrong answers: they are timed only, to show where the time goes.
MLA_VARIANTS = {
    'mla: splits of 128 rows': {
        'mla_common.cuh': [(r'kMlaSplitRows = \d+;', 'kMlaSplitRows = 128;')]},
    'mla: splits of 256 rows': {
        'mla_common.cuh': [(r'kMlaSplitRows = \d+;', 'kMlaSplitRows = 256;')]},
    'mla: splits of 160 rows': {
        'mla_common.cuh': [(r'kMlaSplitRows = \d+;', 'kMlaSplitRows = 160;')]},
    'mla: one consumer group': {
        'mla_common.cuh': [(r'const int groups = [^;]*;',
                            'const int groups = 1;')]},
    'mla: two stages': {
        'mla_common.cuh': [(r'kMlaStages = \d+;', 'kMlaStages = 2;')]},
    'mla: without the score products': {
        'mla_common.cuh': [(r'mma_bf16\(s\[k\], a, b0, b1\);', ';')]},
    'mla: without the P.V products': {
        'mla_common.cuh': [(r'mma_bf16\(o\[n\], a, bv\[0\], bv\[1\]\);',
                            ';'),
                           (r'if \(second\) mma_bf16\(o\[n \+ 1\], a, '
                            r'bv\[2\], bv\[3\]\);', ';')]},
    'mla: one bf16 term': {
        'mla_common.cuh': [(r'kMlaTerms = \d+;', 'kMlaTerms = 1;')]},
    'mla: without the q loads': {
        'mla_common.cuh': [(r'if \(h < p\.h && e < width\)\n',
                            'if (false)\n')]},
    'mla: without the combine': {
        'mla_common.cuh': [(r'mla_combine_kernel<<<[^;]*;', ';')]},
}
DQ_VARIANTS = {
    'dq: 3 ring stages': {
        'flash_bwd.cu': [(r'kDqStages = \d+;', 'kDqStages = 3;')]},
}


def build(variants, source, root):
    """Each variant's library, all nvcc runs started together →
    {name: (ctypes library, split rows)}."""
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = os.path.join(root, f'v{i}')
        shutil.copytree(kernels.CSRC_DIR, d,
                        ignore=shutil.ignore_patterns('build'))
        for fname, subs in edits.items():
            path = os.path.join(d, fname)
            with open(path) as f:
                text = f.read()
            for pattern, repl in subs:
                text, n = re.subn(pattern, repl, text)
                if n != 1:
                    raise SystemExit(f'{name}: {pattern} not found once')
            with open(path, 'w') as f:
                f.write(text)
        common = 'mla_common.cuh' if 'mla' in source else 'decode_common.cuh'
        with open(os.path.join(d, common)) as f:
            split_rows = int(re.search(r'k\w+SplitRows = (\d+);',
                                       f.read()).group(1))
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, '-o',
               os.path.join(d, 'lib.so'), os.path.join(d, source)]
        procs[name] = (d, split_rows,
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, split_rows, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed\n{log[-3000:]}')
        libs[name] = (ctypes.CDLL(os.path.join(d, 'lib.so')), split_rows)
    return libs


def rounds(fns, iters, warmup):
    """Each fn timed in turn, three rounds → {name: [ms, ms, ms]}."""
    out = {name: [] for name in fns}
    for _ in range(3):
        for name, fn in fns.items():
            out[name].append(cs.time_ms(fn, iters=iters, warmup=warmup))
    return out


def decode_variants(gen, root):
    libs = build(DECODE_VARIANTS, 'decode_attention.cu', root)
    bf16 = torch.bfloat16
    rng = np.random.default_rng(1)
    lengths = [int(x) for x in rng.integers(990, 1065, 16)]
    cases = [cs.decode_case(gen, 'bf16 main-path lengths', bf16, bf16,
                            lengths)[0][:4] for _ in range(4)]

    def variant(lib, split_rows):
        fn = lib.xsky_decode_attention
        fn.argtypes = dec.KERNEL.argtypes
        fn.restype = ctypes.c_int

        def call(q, k, v, lens):
            b, _, h, d = q.shape
            max_len, h_kv = k.shape[1], k.shape[2]
            splits = -(-max_len // split_rows)
            scratch = torch.empty(b * splits * h * (d + 2),
                                  dtype=torch.float32, device='cuda')
            out = torch.empty_like(q)
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                      lens.data_ptr(), out.data_ptr(), scratch.data_ptr(), b,
                      max_len, h, h_kv, d, splits, 0, d ** -0.5, 0.0,
                      kernels.DTYPE_CODES[q.dtype],
                      kernels.DTYPE_CODES[k.dtype],
                      kernels.stream_ptr(q.device))
            if code:
                raise RuntimeError(f'variant launch failed: code {code}')
            return out
        return call

    calls = {'decode: as built': dec.decode_attention}
    calls.update({name: variant(*lib) for name, lib in libs.items()})
    ref = dec.decode_attention_plain(*cases[0])
    for name, call in calls.items():
        cs.compare_blocks(name, call(*cases[0]), ref, bf16, block_rows=1)
    it = itertools.count()
    fns = {name: (lambda call=call: call(*cases[next(it) % 4]))
           for name, call in calls.items()}
    return rounds(fns, iters=40, warmup=4)


def mla_variants(gen, root):
    libs = build(MLA_VARIANTS, 'mla_decode.cu', root)
    rng = np.random.default_rng(10)
    lengths = [int(x) for x in rng.integers(990, 1065, 16)]
    cases = [cs.mla_case(gen, 'bf16 main-path lengths', torch.bfloat16,
                         lengths, check=False)[0] for _ in range(4)]

    def variant(lib, split_rows):
        fn = lib.xsky_mla_decode
        fn.argtypes = mla.KERNEL.argtypes
        fn.restype = ctypes.c_int

        def call(q_eff, q_rope, ckv, krope, lens):
            b, h, r = q_eff.shape
            max_len = ckv.shape[1]
            splits = -(-max_len // split_rows)
            acc = torch.empty((b, splits, h, r), dtype=torch.float32,
                              device='cuda')
            ml = torch.empty((b, splits, h, 2), dtype=torch.float32,
                             device='cuda')
            out = torch.zeros_like(q_eff)
            code = fn(*(t.data_ptr() for t in (q_eff, q_rope, ckv, krope,
                                               lens, out, acc, ml)),
                      b, max_len, h, r, q_rope.shape[-1],
                      mla.DEFAULT_BLOCK_KV, splits, cs.MLA_SCALE,
                      kernels.DTYPE_CODES[ckv.dtype],
                      kernels.stream_ptr(q_eff.device))
            if code:
                raise RuntimeError(f'variant launch failed: code {code}')
            return out
        return call

    calls = {'mla: as built': lambda *a: mla.mla_decode_attention(
        *a, cs.MLA_SCALE)}
    calls.update({name: variant(*lib) for name, lib in libs.items()})
    ref = mla.mla_decode_attention_plain(*cases[0], cs.MLA_SCALE)
    for name, call in calls.items():
        if 'without' in name or 'one bf16' in name:
            continue
        cs.compare(name, call(*cases[0]), ref, torch.float32)
    it = itertools.count()
    fns = {name: (lambda call=call: call(*cases[next(it) % 4]))
           for name, call in calls.items()}
    return rounds(fns, iters=40, warmup=4)


def dq_variants(gen, root):
    libs = build(DQ_VARIANTS, 'flash_bwd.cu', root)
    bf16 = torch.bfloat16
    b, s, h, h_kv, d = 4, 8192, 16, 8, 128
    q, dout = (cs.rand(gen, (b, s, h, d), bf16) for _ in range(2))
    k, v = (cs.rand(gen, (b, s, h_kv, d), bf16) for _ in range(2))
    out, lse = fl._flash_fwd(q, k, v, None)
    args = (q, k, v, None, out, dout, lse)

    def variant(lib):
        fn = lib.xsky_flash_bwd_dq
        fn.argtypes = fl.DQ_KERNEL.argtypes
        fn.restype = ctypes.c_int

        def call():
            dq = torch.empty_like(q)
            stats = fl.bwd_scratch(q)
            code = fn(*fl._bwd_common(*args), dq.data_ptr(),
                      stats.data_ptr(), 1,
                      *fl._shape_args(q, k, True, None, None, None))
            if code:
                raise RuntimeError(f'variant launch failed: code {code}')
            return dq
        return call

    calls = {'dq: as built': lambda: fl._flash_bwd_dq(*args)}
    calls.update({name: variant(lib) for name, (lib, _) in libs.items()})
    ref = calls['dq: as built']()
    for name, call in calls.items():
        if not torch.equal(call(), ref):
            raise AssertionError(f'{name}: other bits than the kernel')
    return rounds(calls, iters=5, warmup=1)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    smi = cs.nvidia_smi_line()
    print(f'card: {smi}; torch {torch.__version__}', flush=True)
    kernels.build_all()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    with tempfile.TemporaryDirectory() as root:
        only = sys.argv[1:]
        times = {}
        for name, run in (('decode', decode_variants), ('dq', dq_variants),
                          ('mla', mla_variants)):
            if not only or name in only:
                times.update(run(gen, os.path.join(root, name)))
    for name, ms in times.items():
        print(f'{name}: {np.mean(ms):.4f} ms (rounds {ms})', flush=True)
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out',
                           'torch_kernel_variants.json'), 'w') as f:
        json.dump({'card': smi, 'torch': torch.__version__, 'ms': times}, f,
                  indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
