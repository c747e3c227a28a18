"""A serving replica under a mesh: a gang of rank processes, one per card.

The reference serves a mesh from one process that drives every device
(``jax.jit`` over a ``Mesh``); the port runs one process per card, as
its training does. Global rank 0 builds the orchestrator and the HTTP
server; every other rank follows. The orchestrator talks to an
:class:`EngineProxy`: each engine call that touches the device is sent
first to the followers (its name and host arguments, through the
coordinator's store: ``distributed.CommandChannel``) and then run on rank
0, so that every rank runs the same calls in the same order on its own
blocks (``InferenceEngine(mesh=...)``), and their collectives meet. The
followers run :func:`follow` until rank 0 sends them to stop. The
orchestrator does not change: what it keeps between calls (the decode
state, a prefill's KV, a chunked prefill in progress) is held by each
rank for itself, and an argument that is such a thing travels as a
reference to it; a tensor travels by value, a generator by its state.

The reference has no counterpart of this module.

A follower waits for rank 0's next call without a limit (an idle replica
may wait for hours, past ``distributed.TIMEOUT``). A follower whose call
raises exits with the error, and the host's launcher
(``distributed.run_host``) ends the gang with its code; rank 0 gone, the
store is gone and every follower fails.
"""
from __future__ import annotations

import functools
import weakref
from typing import Any, Callable, Dict, Optional

import torch

from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.parallel import distributed

# The engine calls that reach the device, mirrored on every rank (the
# orchestrator's call sites: ``grep -o "engine\\.[a-z_]*("
# infer/orchestrator.py``). ``verify_step`` waits for ROADMAP.md queue 1
# item 8f-ii.
MIRRORED = ('init_decode_state', 'prefill_insert_batch', 'prefill_any',
            'insert', 'start_chunked_prefill', 'decode_step',
            'decode_steps', 'decode_steps_masked', 'release_slot',
            'reserve_kv', 'release_kv')


class _State:
    """An argument that is the caller's decode state: each rank's own."""


class _Kv:
    """An argument that is the KV of the last prefill: each rank's own."""


class _Gen:
    """A generator argument, by its state (each rank draws the same)."""

    def __init__(self, state: torch.Tensor) -> None:
        self.state = state


def _is_state(value) -> bool:
    return isinstance(value, dict) and 'kv_k' in value


def _kept(result):
    """What a call's ``result`` gives later calls to pass back: ('state',
    the decode state), ('kv', a prefill's KV), ('chunk', a chunked
    prefill) or None."""
    if _is_state(result):
        return 'state', result
    if isinstance(result, tuple) and result and _is_state(result[0]):
        return 'state', result[0]
    if (isinstance(result, tuple) and len(result) >= 3
            and isinstance(result[1], dict)):   # (first, kv, true_len, ..)
        return 'kv', result[1]
    if isinstance(result, engine_lib.ChunkedPrefill):
        return 'chunk', result
    return None


class _MirroredPrefill:
    """Rank 0's handle of a chunked prefill that every rank runs: its
    ``step`` and ``finalize`` are mirrored; dropping it unfinished (a
    cancelled request) drops the followers' too, with the next call."""

    def __init__(self, proxy: 'EngineProxy', handle: int,
                 prefill: engine_lib.ChunkedPrefill) -> None:
        self._proxy = proxy
        self._handle = handle
        self._prefill = prefill
        weakref.finalize(self, proxy._dropped.append, handle)

    def step(self) -> bool:
        self._proxy._send({'chunk': self._handle, 'method': 'step'})
        return self._prefill.step()

    def finalize(self):
        self._proxy._send({'chunk': self._handle, 'method': 'finalize'})
        return self._proxy._keep(self._prefill.finalize())

    def __getattr__(self, name):
        return getattr(self._prefill, name)


class EngineProxy:
    """Rank 0's engine for the orchestrator: the calls in ``MIRRORED``
    go to every rank, then run here; everything else (the config, the
    device, host-side queries) is the engine's own."""

    def __init__(self, engine: engine_lib.InferenceEngine,
                 channel: distributed.CommandChannel) -> None:
        self.engine = engine
        self._channel = channel
        self._state = None
        self._kv = None
        self._chunks = 0
        self._dropped = []

    def __getattr__(self, name):
        if name in MIRRORED:
            return functools.partial(self._call, name)
        if name == 'verify_step':
            raise NotImplementedError(engine_lib.SPECULATIVE_MESH)
        return getattr(self.engine, name)

    def _send(self, msg: Dict[str, Any]) -> None:
        if self._dropped:   # the finalizers append to this one list
            msg['drop'] = list(self._dropped)
            del self._dropped[:len(msg['drop'])]
        self._channel.send(msg)

    def _encode(self, value):
        if _is_state(value):
            if value is not self._state:
                raise RuntimeError('a decode state other than the one the '
                                   'engine last returned')
            return _State()
        if isinstance(value, dict) and value is self._kv:
            return _Kv()
        if torch.is_tensor(value):
            return value.detach().cpu()
        if isinstance(value, torch.Generator):
            return _Gen(value.get_state())
        if isinstance(value, (list, tuple)):
            return type(value)(self._encode(v) for v in value)
        if isinstance(value, dict):
            return {k: self._encode(v) for k, v in value.items()}
        return value

    def _keep(self, result):
        kept = _kept(result)
        if kept is None:
            return result
        kind, value = kept
        if kind == 'state':
            self._state = value
        elif kind == 'kv':
            self._kv = value
        else:
            result = _MirroredPrefill(self, self._chunks, value)
            self._chunks += 1
        return result

    def _call(self, name: str, *args, **kwargs):
        self._send({'call': name, 'args': self._encode(args),
                    'kwargs': self._encode(kwargs)})
        return self._keep(getattr(self.engine, name)(*args, **kwargs))

    def barrier(self) -> None:
        """Every rank at this point of the calls (a collective: each
        follower has run every call before it)."""
        self._send({'barrier': True})
        distributed.barrier()

    def stop(self) -> None:
        """Let every follower return from :func:`follow`."""
        self._send({'stop': True})


def follow(engine: engine_lib.InferenceEngine,
           channel: distributed.CommandChannel,
           on_result: Optional[Callable[[str, Any], None]] = None) -> None:
    """Run rank 0's engine calls on this rank's ``engine``, in order, until
    rank 0 stops the gang. ``on_result(name, result)`` sees each call's
    result (the tests read the tokens every rank decoded)."""
    held: Dict[str, Any] = {'state': None, 'kv': None}
    chunks: Dict[int, engine_lib.ChunkedPrefill] = {}
    generator = torch.Generator(device=engine.device)

    def decode(value):
        if isinstance(value, _State):
            return held['state']
        if isinstance(value, _Kv):
            return held['kv']
        if isinstance(value, _Gen):
            generator.set_state(value.state)
            return generator
        if torch.is_tensor(value):
            return value.to(engine.device)
        if isinstance(value, (list, tuple)):
            return type(value)(decode(v) for v in value)
        if isinstance(value, dict):
            return {k: decode(v) for k, v in value.items()}
        return value

    n_chunks = 0
    while True:
        msg = channel.recv()
        for handle in msg.get('drop', ()):
            chunks.pop(handle, None)
        if 'stop' in msg:
            return
        if 'barrier' in msg:
            distributed.barrier()
            continue
        if 'chunk' in msg:
            name = msg['method']
            result = getattr(chunks[msg['chunk']], name)()
            if name == 'finalize':
                del chunks[msg['chunk']]
        else:
            name = msg['call']
            result = getattr(engine, name)(*decode(msg['args']),
                                           **decode(msg['kwargs']))
        kept = _kept(result)
        if kept is not None:
            kind, value = kept
            if kind == 'chunk':
                chunks[n_chunks] = value
                n_chunks += 1
            else:
                held[kind] = value
        if on_result is not None:
            on_result(name, result)
