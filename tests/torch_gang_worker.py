"""One rank of a CPU gang of the port's Trainer or launcher, for the
tests.

    python tests/torch_gang_worker.py SPEC RANK WORLD PORT OUT
    python tests/torch_gang_worker.py launch OUT [--fp32] -- ARGV...

SPEC is a ``torch.save`` of a list of cases, each a dict: ``model`` (a
port config), ``train`` (TrainConfig keyword arguments, ``mesh_plan``
a dict), ``init`` (the whole initial parameter tree as numpy arrays, or
None for the trainer's own draw), with LoRA ``adapters`` (numpy too, or
None), ``batches`` (global batches as numpy dicts). The process joins a gloo gang of WORLD ranks on 127.0.0.1:PORT
as rank RANK (one host each), runs every case (its rows of each batch,
one step per batch) and writes to OUT, per case: the losses and grad
norms of each step, the all-gathers each step made (counted when the
case asks, ``count_gathers``) and the whole state as ``host_state``
gathers it.
The second form runs ``train/launch.py`` with ARGV as one rank of the
gang its environment describes (``XSKY_*``), the model's config in fp32
with ``--fp32``, and writes to OUT (JSON) the losses and grad norms the
run returns on this rank and the step it started from;

    python tests/torch_gang_worker.py host OUT_DIR [--fp32] -- ARGV...

is the launcher of one host (``host_rank``): its ``--procs-per-host``
rank processes each write ``OUT_DIR/rank-<i>.json`` so. The fourth,

    python tests/torch_gang_worker.py call NAME SPEC RANK WORLD PORT OUT

runs ``CALLS[NAME]`` (a collective check of the mesh pieces) on the
``torch.save``d SPEC as rank RANK of a gloo gang and saves its result to
OUT (``call_gang``). The fifth,

    python tests/torch_gang_worker.py serve SPEC RANK WORLD PORT OUT

serves each case of SPEC (``serve_case``: a model, its whole initial tree
as numpy, a mesh plan, EngineConfig keywords and requests) as one rank of
a replica under that mesh: rank 0 drives an orchestrator through the
gang's engine proxy, the others follow (``infer/gang.py``); each rank
saves its slot-cache shape, its weight blocks' shapes and bytes, the
tokens of every decode step it ran, and rank 0 the requests' outputs
(``serve_gang``). Imports no JAX.
"""
from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from skypilot_tpu_torch import models  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.parallel import distributed  # noqa: E402
from skypilot_tpu_torch.train import trainer as trainer_lib  # noqa: E402


class _LiveGathered:
    """Counts the gathered layer weights (``mesh_lib.Sharded.gather``)
    whose storage is alive when the backward starts (the step's
    ``torch.autograd.grad``), through weak references to the storages."""

    def __init__(self):
        from torch.multiprocessing.reductions import StorageWeakRef
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        self.refs, self.live = [], []
        self._mesh, self._ref = mesh_lib, StorageWeakRef
        self._gather, self._grad = mesh_lib.Sharded.gather, torch.autograd.grad

    def __enter__(self):
        live = self

        def gather(sharded):
            full = live._gather(sharded)
            live.refs.append(live._ref(full.untyped_storage()))
            return full

        def grad(*args, **kwargs):
            live.live.append(sum(not r.expired() for r in live.refs))
            return live._grad(*args, **kwargs)
        self._mesh.Sharded.gather = gather
        torch.autograd.grad = grad
        return self

    def __exit__(self, *exc):
        self._mesh.Sharded.gather = self._gather
        torch.autograd.grad = self._grad


def run_case(case):
    kw = dict(case['train'])
    kw['mesh_plan'] = trainer_lib.MeshPlan(**kw['mesh_plan'])
    tr = trainer_lib.Trainer(
        trainer_lib.TrainConfig(model=case['model'], **kw), device='cpu')
    params = adapters = None
    if case.get('init') is not None:
        lib = models.module_for(case['model'])
        params = getattr(lib, 'params_from_numpy', llama.params_from_numpy)(
            case['init'], 'cpu')
    if case.get('adapters') is not None:
        adapters = llama.params_from_numpy(case['adapters'], 'cpu')
    state = tr.init_state(params, adapters=adapters)
    losses, norms, gathers, live = [], [], [], []
    real_gather = distributed.all_gather
    for batch in case['batches']:
        local = tr.local_rows({k: torch.from_numpy(v)
                               for k, v in batch.items()})
        calls = []
        if case.get('count_gathers'):
            distributed.all_gather = lambda *a, **k: (
                calls.append(1), real_gather(*a, **k))[1]
        try:
            with _LiveGathered() as watch:
                state, metrics = tr.step(state, local)
        finally:
            distributed.all_gather = real_gather
        losses.append(float(metrics['loss']))
        norms.append(float(metrics['grad_norm']))
        gathers.append(len(calls))
        live.append((len(watch.refs), watch.live))
    return {'losses': losses, 'grad_norms': norms, 'gathers': gathers,
            'live_gathered': live, 'state': tr.host_state(state)}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _wait(procs, timeout: float) -> None:
    """Wait for every process; kill them all when one fails or the
    timeout passes, and raise then."""
    import time
    deadline = time.monotonic() + timeout
    try:
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        codes = [p.poll() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(code != 0 for code in codes):
        raise RuntimeError(f'gang ranks exited with {codes} (None: killed '
                           f'after {timeout} s)')


class Gang:
    """``cases`` running on a fresh gang of ``world`` worker processes
    (gloo on a free local port), started at once; :meth:`results` waits
    for them (``_wait``)."""

    def __init__(self, cases, world: int, tmp_dir: str) -> None:
        import subprocess
        spec = os.path.join(tmp_dir, 'gang-spec.pt')
        torch.save(cases, spec)
        port = _free_port()
        self.outs = [os.path.join(tmp_dir, f'gang-out-{r}.pt')
                     for r in range(world)]
        env = dict(os.environ, OMP_NUM_THREADS='1')
        self.procs = []
        try:
            for r in range(world):
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), spec,
                     str(r), str(world), str(port), self.outs[r]],
                    env=env))
        except BaseException:
            self.kill()
            raise

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def results(self, timeout: float = 100.0):
        _wait(self.procs, timeout)
        return [torch.load(o, weights_only=False) for o in self.outs]


def run_gang(cases, world: int, tmp_dir: str, timeout: float = 100.0):
    """Each rank's results of ``cases`` on a gang of ``world``, in rank
    order."""
    return Gang(cases, world, tmp_dir).results(timeout)


def launch_gang(argv, world: int, tmp_dir: str, fp32: bool = True,
                env=None, timeout: float = 100.0):
    """``train/launch.py`` with ``argv`` on a gang of ``world`` processes
    (the gang env of ``world`` hosts on a free local port, ``env`` added)
    → each rank's JSON (``launch_rank``), in rank order."""
    import json
    import subprocess
    port = _free_port()
    outs = [os.path.join(tmp_dir, f'launch-rank-{r}.json')
            for r in range(world)]
    procs = []
    try:
        for r in range(world):
            rank_env = dict(os.environ, OMP_NUM_THREADS='1',
                            XSKY_NUM_HOSTS=str(world),
                            XSKY_HOST_RANK=str(r),
                            XSKY_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
                            **(env or {}))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), 'launch',
                 outs[r]] + (['--fp32'] if fp32 else []) + ['--'] +
                [str(a) for a in argv], env=rank_env))
    except BaseException:
        _wait(procs, 0)
        raise
    _wait(procs, timeout)
    results = []
    for o in outs:
        with open(o, encoding='utf-8') as f:
            results.append(json.load(f))
    return results


def launch_rank(argv):
    import dataclasses
    import json
    import logging
    from skypilot_tpu_torch.train import launch
    out, flags = argv[0], argv[1:argv.index('--')]
    if '--fp32' in flags:
        get_config = models.get_config
        models.get_config = lambda name: dataclasses.replace(
            get_config(name), dtype=torch.float32)
    logging.basicConfig(level=logging.INFO)
    try:
        run = launch.run(launch.parse_args(argv[argv.index('--') + 1:]))
    finally:
        distributed.shutdown()
    with open(out, 'w', encoding='utf-8') as f:
        json.dump({'losses': run['losses'], 'grad_norms': run['grad_norms'],
                   'start_step': run['start_step']}, f)


def split_roundtrip(spec, rank, world):
    """A leaf split along two dims at ``spec['plan']`` (its ``spec['axes']``
    per dim): this rank's block, the leaf gathered back from every
    rank's block, and what a step reads of it (its tensor dims kept)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.build_mesh(mesh_lib.MeshPlan(**spec['plan']))
    full = torch.from_numpy(spec['leaf'])
    split = mesh_lib.split_for(mesh, spec['axes'], tuple(full.shape))
    block = mesh_lib.shard(full, split)
    return {'block': block, 'whole': mesh_lib.gather(block, split),
            'step': mesh_lib.step_block(block, split),
            'cuts': [(c.dim, c.parts, c.index, c.axes) for c in split.cuts]}


def vocab_parallel(spec, rank, world):
    """The vocabulary-parallel embedding lookup and chunked cross-entropy
    over this rank's vocabulary blocks (every rank a tensor rank; the
    whole vocabulary for a world of one): the loss and the gradients of
    the table's rows, the head's columns and the hidden input."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    table = torch.from_numpy(spec['table']).chunk(world)[rank].clone()
    head = torch.from_numpy(spec['head']).chunk(world, 1)[rank].clone()
    hidden = torch.from_numpy(spec['hidden'])
    for t in (table, head, hidden):
        t.requires_grad_(True)
    split = mesh_lib.TensorSplit(world, rank, None) if world > 1 else None
    with mesh_lib.tensor_split(split):
        x = hidden + llama.embed_lookup(table, torch.from_numpy(
            spec['tokens']))
        loss = llama._chunked_ce(x, head, torch.from_numpy(spec['targets']),
                                 torch.from_numpy(spec['mask']),
                                 spec['chunk'])
        grads = torch.autograd.grad(loss, [table, head, hidden])
    return {'loss': loss.detach(), 'table': grads[0], 'head': grads[1],
            'hidden': grads[2]}


def expert_split_pieces(spec, rank, world):
    """A leaf split along an expert dim and an fsdp dim at
    ``spec['plan']``: its cuts, block, whole leaf and step block (as
    ``split_roundtrip``), the step cuts, and the statistics a reduction
    over each dim leaves: ``drop``'s cuts, and ``reduce_dim`` of the
    block's sum over that dim (the full leaf's sum over it, this rank's
    block of the rest)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    out = split_roundtrip(spec, rank, world)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshPlan(**spec['plan']))
    full = torch.from_numpy(spec['leaf'])
    split = mesh_lib.split_for(mesh, spec['axes'], tuple(full.shape))
    block = mesh_lib.shard(full, split)
    out['step_cuts'] = [(c.dim, c.axes) for c in split.step_cuts]
    out['kept'] = [c.kept for c in split.cuts]
    out['drop'], out['reduced'] = {}, {}
    for dim in range(full.ndim):
        dropped = split.drop(dim)
        out['drop'][dim] = (None if dropped is None else
                            [(c.dim, c.parts, c.index, c.axes)
                             for c in dropped.cuts])
        out['reduced'][dim] = split.reduce_dim(block.sum(dim), dim)
    out['norm'] = split.reduce(torch.sum(block * block))
    return out


def expert_grads(spec, rank, world):
    """The loss and the whole gradient of every parameter leaf at step 1
    of ``spec['case']`` at ``spec['plan']`` (the Trainer's own pieces:
    this rank's rows, ``_loss_and_grads``, the sums over its batch
    groups, then each leaf's blocks gathered), from ``spec['init']``."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    case = spec['case']
    kw = dict(case['train'])
    kw['mesh_plan'] = trainer_lib.MeshPlan(**kw['mesh_plan'])
    tr = trainer_lib.Trainer(
        trainer_lib.TrainConfig(model=case['model'], **kw), device='cpu')
    lib = models.module_for(case['model'])
    state = tr.init_state(getattr(lib, 'params_from_numpy',
                                  llama.params_from_numpy)(case['init'],
                                                           'cpu'))
    local = tr.local_rows({k: torch.from_numpy(v)
                           for k, v in case['batches'][0].items()})
    loss, grads = tr._loss_and_grads(state, local)
    if tr._batch is not None:
        grads = [g if group is None else distributed.all_reduce(g, group)
                 for g, group in zip(grads, tr._grad_groups)]
        loss = distributed.all_reduce(loss, tr._batch.group)
    splits = trainer_lib.param_leaves(tr._splits)
    return {'loss': loss, 'grads': [mesh_lib.gather(g, s)
                                    for g, s in zip(grads, splits)]}


CALLS = {'split_roundtrip': split_roundtrip, 'vocab_parallel': vocab_parallel,
         'expert_split_pieces': expert_split_pieces,
         'expert_grads': expert_grads}


def call_gang(name: str, spec, world: int, tmp_dir: str,
              timeout: float = 100.0):
    """``CALLS[name](spec, rank, world)`` on each rank of a fresh gloo
    gang of ``world`` processes → each rank's result, in rank order."""
    import subprocess
    path = os.path.join(tmp_dir, f'call-{name}-{world}.pt')
    torch.save(spec, path)
    port = _free_port()
    outs = [os.path.join(tmp_dir, f'call-{name}-{world}-{r}.pt')
            for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), 'call', name,
                 path, str(r), str(world), str(port), outs[r]], env=env))
    except BaseException:
        _wait(procs, 0)
        raise
    _wait(procs, timeout)
    return [torch.load(o, weights_only=False) for o in outs]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def serve_case(case, rank, channel):
    """One case of a serving gang on this rank (see the module doc)."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import gang as gang_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.ops import quantization as qops
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cfg = case['model']
    lib = models.module_for(cfg)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshPlan(**case['plan']))
    params = getattr(lib, 'params_from_numpy', llama.params_from_numpy)(
        case['init'], 'cpu')
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, **case['engine']), params,
        device='cpu', mesh=mesh)
    decoded = []
    step = engine._decode_step_impl

    def record(*args, **kwargs):
        out = step(*args, **kwargs)
        decoded.append(out[1][0].clone())
        return out
    engine._decode_step_impl = record
    out = {'k_shape': tuple(engine._k_shape),
           'shapes': _shapes(engine.params),
           'param_bytes': qops.params_nbytes(engine.params),
           'slot_block': engine.layout.slot_block, 'decoded': decoded}
    if rank != 0:
        gang_lib.follow(engine, channel)
        return out
    proxy = gang_lib.EngineProxy(engine, channel)
    orch = orch_lib.Orchestrator(proxy,
                                 decode_steps=case.get('decode_steps', 1))
    requests = [orch.submit(orch_lib.Request(**r))
                for r in case['requests']]
    orch.run_until_drained(max_steps=case.get('max_steps', 64))
    proxy.stop()
    out['outputs'] = [dict(tokens=r.output_tokens,
                           logprobs=r.token_logprobs,
                           top=r.top_logprobs, error=r.error)
                      for r in requests]
    return out


def serve_gang(cases, world: int, tmp_dir: str, timeout: float = 100.0,
               name: str = 'serve'):
    """``serve_case`` of each case on a fresh gloo gang of ``world``
    processes, started now → a callable that waits and returns each
    rank's results, in rank order."""
    import subprocess
    path = os.path.join(tmp_dir, f'{name}-spec.pt')
    torch.save(cases, path)
    port = _free_port()
    outs = [os.path.join(tmp_dir, f'{name}-out-{r}.pt')
            for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), 'serve', path,
                 str(r), str(world), str(port), outs[r]], env=env))
    except BaseException:
        _wait(procs, 0)
        raise

    def results():
        _wait(procs, timeout)
        return [torch.load(o, weights_only=False) for o in outs]
    return results


def host_rank(argv):
    """``host OUT_DIR [--fp32] -- ARGV``: ``train/launch.py``'s ``main``
    with ARGV, as the one launcher of a host: it starts the host's rank
    processes (``--procs-per-host``) as this same command, and each rank
    (``XSKY_LOCAL_RANK`` set) runs ``launch_rank`` into
    ``OUT_DIR/rank-<local rank>.json``. Exits with ``main``'s code."""
    from skypilot_tpu_torch.train import launch
    out_dir, sep = argv[0], argv.index('--')
    if distributed.is_rank_process():
        local = os.environ[distributed.ENV_LOCAL_RANK]
        launch_rank([os.path.join(out_dir, f'rank-{local}.json')] +
                    argv[1:])
        return 0
    # The launcher's rank processes run this command: ``python`` and
    # RANK_COMMAND, then the launcher's arguments.
    launch.RANK_COMMAND = (os.path.abspath(__file__), 'host',
                           *argv[:sep + 1])
    return launch.main(argv[sep + 1:])


def main(argv):
    if argv[0] == 'launch':
        return launch_rank(argv[1:])
    if argv[0] == 'host':
        sys.exit(host_rank(argv[1:]))
    if argv[0] == 'serve':
        spec, rank, world, port, out = argv[1:]
        distributed.initialize(f'127.0.0.1:{port}', int(world), int(rank))
        try:
            torch.set_num_threads(1)
            channel = distributed.CommandChannel()
            cases = torch.load(spec, weights_only=False)
            torch.save([serve_case(c, int(rank), channel) for c in cases],
                       out)
        finally:
            distributed.shutdown()
        return None
    if argv[0] == 'call':
        name, spec, rank, world, port, out = argv[1:]
        distributed.initialize(f'127.0.0.1:{port}', int(world), int(rank))
        try:
            torch.save(CALLS[name](torch.load(spec, weights_only=False),
                                   int(rank), int(world)), out)
        finally:
            distributed.shutdown()
        return None
    spec, rank, world, port, out = argv
    distributed.initialize(f'127.0.0.1:{port}', int(world), int(rank))
    try:
        cases = torch.load(spec, weights_only=False)
        torch.save([run_case(c) for c in cases], out)
    finally:
        distributed.shutdown()


if __name__ == '__main__':
    main(sys.argv[1:])
