"""Process groups from the gang launcher's environment, and the port's
collectives.

Counterpart of ``skypilot_tpu/parallel/distributed.py``. The gang
launcher exports ``XSKY_HOST_RANK``, ``XSKY_NUM_HOSTS`` and
``XSKY_COORDINATOR_ADDRESS`` (``host:port``) on every host; the
reference turns them into ``jax.distributed.initialize`` arguments and
runs one process per host. The port runs one process per card: a host
with ``k`` cards starts ``k`` processes, told apart by
``XSKY_LOCAL_RANK`` (0 .. k-1) and ``XSKY_LOCAL_SIZE`` (k, default 1),
and the process of local rank ``i`` on host ``h`` is rank ``h·k + i`` of
a world of ``num_hosts·k``. :func:`run_host` starts those ``k``
processes from the one process that the gang launcher runs on the host
(``train/launch.py --procs-per-host``), and :func:`initialize` brings up
the default ``torch.distributed`` process group over the coordinator's
TCP store; a single process stays a no-op, as in the reference.

The backend follows from the devices, and the choice is logged: gloo
for CPU tensors; NCCL where every rank has a card of its own; gloo
where ranks share a card (NCCL refuses two ranks on one device). The
ranks compare their cards' UUIDs through the store before the group is
made, so the backend is chosen once, never switched after a failure.

The collectives (:func:`all_gather`, :func:`reduce_scatter`,
:func:`all_reduce`) take a group and a tensor on the rank's device.
Under gloo a CUDA tensor is staged through host memory explicitly
(gloo's CUDA support varies by op and version); NCCL never stages. gloo
takes no bfloat16: an all-gather moves a bf16 block as its bytes (bit
for bit), and an all-reduce sums it in fp32, rounding once (bytes
cannot be summed). A failed collective raises: nothing carries on with
one rank.
"""
from __future__ import annotations

import ctypes
import datetime
import logging
import os
import pickle
import signal
import socket
import subprocess
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

ENV_LOCAL_RANK = 'XSKY_LOCAL_RANK'
ENV_LOCAL_SIZE = 'XSKY_LOCAL_SIZE'
# The pid of the launcher that started a host's rank processes.
ENV_LAUNCHER_PID = 'XSKY_LAUNCHER_PID'
# Global rank of this process, set by initialize() for the telemetry
# spool and the flight recorder's dump names.
ENV_RANK = 'XSKY_RANK'
# How long a rank waits for its peers (the store, any collective) before
# it fails.
TIMEOUT = datetime.timedelta(seconds=300)


def is_multihost() -> bool:
    return int(os.environ.get('XSKY_NUM_HOSTS', '1')) > 1


def gang_rank(host_rank: int, num_hosts: int, local_rank: int = 0,
              local_size: int = 1) -> Tuple[int, int]:
    """(rank, world size) of the process of ``local_rank`` on host
    ``host_rank``, each host running ``local_size`` processes."""
    if not 0 <= local_rank < local_size:
        raise ValueError(f'local rank {local_rank} outside a host of '
                         f'{local_size} processes')
    if not 0 <= host_rank < num_hosts:
        raise ValueError(f'host rank {host_rank} outside a gang of '
                         f'{num_hosts} hosts')
    return host_rank * local_size + local_rank, num_hosts * local_size


def local_card(local_rank: int) -> int:
    """The card index a process drives: its local rank, wrapped when the
    host runs more processes than it has cards (they share a card)."""
    return local_rank % max(torch.cuda.device_count(), 1)


def is_rank_process() -> bool:
    """Whether this process is one of a host's rank processes (its
    launcher set ``XSKY_LOCAL_RANK``): such a process never starts
    others."""
    return ENV_LOCAL_RANK in os.environ


def host_process_count(requested: str, device_type: str) -> int:
    """How many rank processes this host runs: ``requested`` as a count,
    or for ``'auto'`` one per card (one on the CPU or with no card)."""
    if requested != 'auto':
        count = int(requested)
        if count < 1:
            raise ValueError(f'--procs-per-host must be >= 1 or auto, got '
                             f'{requested}')
        return count
    if device_type != 'cuda':
        return 1
    return max(torch.cuda.device_count(), 1)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def bind_to_launcher() -> None:
    """In a rank process that :func:`run_host` started: ask the kernel to
    send this process SIGKILL when its launcher ends (Linux
    ``PR_SET_PDEATHSIG``), so no rank outlives the launcher, even one
    killed outright; exit at once if the launcher has already ended. Run
    in the rank itself, not between fork and exec, where a threaded
    launcher must run no Python. A no-op elsewhere and off Linux."""
    launcher = os.environ.get(ENV_LAUNCHER_PID)
    if launcher is None:
        return
    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):   # not Linux
        return
    prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    if os.getppid() != int(launcher):   # it ended before the prctl
        logger.error(f'The launcher (pid {launcher}) has ended; exiting.')
        os._exit(1)


def _exit_code(code: int) -> int:
    """A child's return code as a shell gives it (128 + N for signal N)."""
    return 128 - code if code < 0 else code


# How long a host's ranks have to end after SIGTERM before SIGKILL, and
# how often the launcher looks at them.
_GRACE_S = 10.0
_POLL_S = 0.1


def run_host(command: Sequence[str], count: int) -> int:
    """Run ``count`` rank processes of ``command`` on this host, the i-th
    with ``XSKY_LOCAL_RANK=i`` and ``XSKY_LOCAL_SIZE=count`` beside this
    process's env (and, for a host alone whose env names no coordinator,
    ``XSKY_COORDINATOR_ADDRESS`` on 127.0.0.1 and a free port), and
    return the host's exit code: 0 when every rank exits 0, else the
    first failing rank's code (128 + N for signal N), the others ended
    (SIGTERM, then SIGKILL after ``_GRACE_S``: a rank blocked in a
    collective does not see SIGTERM). SIGINT and SIGTERM sent to this
    process go to every rank, and the host's code is then 128 + that
    signal. No rank outlives this function, nor this process (each rank
    binds itself to it: :func:`bind_to_launcher`)."""
    env = dict(os.environ, **{ENV_LOCAL_SIZE: str(count),
                              ENV_LAUNCHER_PID: str(os.getpid())})
    if (int(env.get('XSKY_NUM_HOSTS', '1')) <= 1
            and not env.get('XSKY_COORDINATOR_ADDRESS')):
        env['XSKY_COORDINATOR_ADDRESS'] = f'127.0.0.1:{_free_port()}'
    procs: List[subprocess.Popen] = []
    received: List[int] = []

    def forward(signum, frame):
        del frame
        received.append(signum)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    handlers = {}
    for signum in (signal.SIGINT, signal.SIGTERM):
        try:
            handlers[signum] = signal.signal(signum, forward)
        except ValueError:   # not the main thread: nothing to forward
            pass
    failed = None
    try:
        for i in range(count):
            procs.append(subprocess.Popen(
                list(command), env=dict(env, **{ENV_LOCAL_RANK: str(i)})))
        logger.info(f'Started {count} rank processes on this host (pids '
                    f'{[p.pid for p in procs]}), coordinator '
                    f'{env["XSKY_COORDINATOR_ADDRESS"]}.')
        # The first failure seen is the cause; the others' (a peer gone
        # from a collective) its consequence.
        while failed is None:
            codes = [p.poll() for p in procs]
            failed = next((code for code in codes if code), None)
            if None not in codes:
                break
            time.sleep(_POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + _GRACE_S
        for p in procs:
            try:
                p.wait(max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for signum, handler in handlers.items():
            signal.signal(signum, handler)
    if received:   # the host was stopped: its ranks' codes follow
        return 128 + received[0]
    if failed is not None:
        logger.error(f'A rank process exited with {failed}; the host\'s '
                     f'ranks exited with {[p.returncode for p in procs]}.')
        return _exit_code(failed)
    return 0


def _choose_backend(store, rank: int, world: int, device_type: str) -> str:
    """'gloo' for the CPU or for ranks that share a card; 'nccl' when
    every rank's card is its own (card UUIDs compared through the
    store)."""
    if device_type != 'cuda':
        return 'gloo'
    uuid = str(torch.cuda.get_device_properties(
        torch.cuda.current_device()).uuid)
    store.set(f'xsky/card/{rank}', uuid)
    uuids = [store.get(f'xsky/card/{r}').decode() for r in range(world)]
    return 'nccl' if len(set(uuids)) == world else 'gloo'


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device_type: str = 'cpu') -> None:
    """Read the gang env (arguments win, as in the reference) and bring
    up the default process group; a no-op for a single process or when
    the group is already up. ``num_processes`` and ``process_id`` count
    hosts, as the reference's do; ``device_type`` is where this rank
    computes ('cuda' picks the card of its local rank first)."""
    coordinator_address = coordinator_address or os.environ.get(
        'XSKY_COORDINATOR_ADDRESS')
    num_hosts = num_processes if num_processes is not None else int(
        os.environ.get('XSKY_NUM_HOSTS', '1'))
    host_rank = process_id if process_id is not None else int(
        os.environ.get('XSKY_HOST_RANK', '0'))
    local_rank = int(os.environ.get(ENV_LOCAL_RANK, '0'))
    local_size = int(os.environ.get(ENV_LOCAL_SIZE, '1'))
    rank, world = gang_rank(host_rank, num_hosts, local_rank, local_size)
    bind_to_launcher()
    if world <= 1 or not coordinator_address:
        logger.debug('Single process; no process group to bring up.')
        return
    if dist.is_initialized():
        return
    if device_type == 'cuda':
        torch.cuda.set_device(local_card(local_rank))
    host, _, port = coordinator_address.rpartition(':')
    store = dist.TCPStore(host, int(port), world_size=world,
                          is_master=rank == 0, timeout=TIMEOUT)
    backend = _choose_backend(store, rank, world, device_type)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    global _STORE
    _STORE = store
    os.environ[ENV_RANK] = str(rank)
    shared = ' (ranks share a card)' if (
        device_type == 'cuda' and backend == 'gloo') else ''
    logger.info(
        f'torch.distributed up: rank {rank}/{world} (host {host_rank}/'
        f'{num_hosts}, local {local_rank}/{local_size}), backend '
        f'{backend}{shared}, coordinator {coordinator_address}.')


# The coordinator's store of the group ``initialize`` brought up.
_STORE = None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def agree(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank (a decision the ranks must share,
    such as a checkpoint due by rank 0's clock)."""
    if not dist.is_initialized():
        return flag
    box = [flag]
    dist.broadcast_object_list(box, src=0)
    return bool(box[0])


def shutdown() -> None:
    """Tear the default group down (each process once, at its end)."""
    global _STORE
    if dist.is_initialized():
        dist.destroy_process_group()
    _STORE = None


class CommandChannel:
    """Rank 0's commands to every other rank of the group, in order,
    through the coordinator's TCP store (:func:`initialize`): rank 0
    sends a picklable object (:meth:`send`), each other rank takes the
    next one (:meth:`recv`). A receiver waits without a limit: a follower of an idle
    serving replica waits for hours, where a collective would fail after
    ``TIMEOUT``. It fails when the store does (rank 0, which holds it,
    gone). Every ``_PRUNE_EVERY`` commands each receiver posts how far it
    has read, and rank 0 deletes the commands that every receiver has
    read, so the store holds a bounded backlog."""

    _KEY = 'xsky/cmd/'
    _READ = 'xsky/cmd-read/'
    _PRUNE_EVERY = 256
    # One wait on the store; a receiver that times out waits again.
    _WAIT = datetime.timedelta(hours=1)

    def __init__(self, store=None) -> None:
        self._store = store if store is not None else _STORE
        if self._store is None:
            raise RuntimeError('no process group: distributed.initialize '
                               'brings one up first')
        self._rank = rank()
        self._world = world_size()
        self._next = 0      # the next command's index
        self._pruned = 0    # rank 0: commands below this are deleted

    def send(self, obj) -> None:
        self._store.set(f'{self._KEY}{self._next}', pickle.dumps(obj))
        self._next += 1
        if self._next % self._PRUNE_EVERY == 0:
            self._prune()

    def recv(self):
        key = f'{self._KEY}{self._next}'
        while True:
            try:
                self._store.wait([key], self._WAIT)
                break
            except RuntimeError as e:   # DistStoreError where it exists
                if 'timeout' not in str(e).lower():
                    raise
        obj = pickle.loads(self._store.get(key))
        self._next += 1
        if self._next % self._PRUNE_EVERY == 0:
            self._store.set(f'{self._READ}{self._rank}', str(self._next))
        return obj

    def _prune(self) -> None:
        read = []
        for r in range(1, self._world):
            key = f'{self._READ}{r}'
            read.append(int(self._store.get(key))
                        if self._store.check([key]) else 0)
        upto = min(read, default=self._next)
        for i in range(self._pruned, upto):
            self._store.delete_key(f'{self._KEY}{i}')
        self._pruned = max(self._pruned, upto)


# ---- collectives ----

def _stages(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through host memory: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == 'gloo'


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor the collective sees: a contiguous host copy under gloo
    for a CUDA tensor, else ``t`` (contiguous)."""
    t = t.contiguous()
    return t.detach().cpu() if _stages(t, group) else t


def all_reduce(t: torch.Tensor, group=None, op: str = 'sum'
               ) -> torch.Tensor:
    """The sum (``op='max'``: the maximum) of ``t`` over ``group``, a new
    tensor on ``t``'s device (every rank gets the same bits). A 16-bit
    float goes over the wire in fp32 (gloo takes no bfloat16), so its sum
    is taken in fp32 and rounded once."""
    wide = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    buf = _wire(wide, group)
    if buf is wide:
        buf = wide.clone()
    dist.all_reduce(buf, op=(dist.ReduceOp.MAX if op == 'max'
                             else dist.ReduceOp.SUM), group=group)
    return buf.to(t.device, t.dtype)


def all_gather(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The shards of ``group``'s ranks, in group-rank order, concatenated
    along ``dim``."""
    n = dist.get_world_size(group)
    src = _wire(t.movedim(dim, 0), group)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    if dist.get_backend(group) == 'nccl':
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        # gloo: the list form, bit for bit (as bytes: gloo takes no
        # bfloat16).
        dist.all_gather(list(out.reshape(-1).view(torch.uint8).chunk(n)),
                        src.reshape(-1).view(torch.uint8), group=group)
    return out.to(t.device).movedim(0, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``, of which this rank keeps its
    block of ``dim`` (the inverse layout of :func:`all_gather`)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    if dist.get_backend(group) == 'nccl':
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)
    # gloo: the whole sum, then this rank's block.
    return all_reduce(t, group).chunk(n, dim)[me].contiguous()
