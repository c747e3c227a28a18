"""HTTP serving entrypoint: the slot engine behind a JSON API, on one card.

    python -m skypilot_tpu_torch.infer.server --model llama3-8b \\
        --weight-dtype int8 --kv-dtype int8 --port 8080

Counterpart of ``skypilot_tpu/infer/server.py``: the same routes, the
same flags (a replica's command line carries over) and the same warm-up
before ``/health`` answers, over the port's engine. Two flags more:
``--device`` (default: the card; without one the server refuses to start
unless given ``--device cpu``) and ``--procs-per-host``.

Under ``--mesh`` (e.g. ``expert=8``, serve_mixtral.yaml's) a replica is a
gang of rank processes, one per card (``infer/gang.py``): the launcher
that the host runs starts ``--procs-per-host`` of them (``auto``: one per
card) as ``train/launch.py`` does, each brings up its process group from
the gang env and resolves the mesh over the world, and builds its blocks
of the weights (the training rules' tensor and expert splits, drawn or
converted whole a layer at a time and cut as they land) and of the slot
cache (``InferenceEngine(mesh=...)``). Global rank 0 warms up, serves
HTTP and mirrors every engine call to the others; ``/health`` answers
once every rank is warm.

Endpoints (the wire surface of an ``xsky serve`` replica):
  GET  /health              → 200 once the engine is warm
  POST /generate            → {"prompt_tokens": [...], "max_new_tokens",
                              "temperature", "top_k", "top_p"}
                              ⇒ {"output_tokens": [...]}
  GET  /v1/models           → OpenAI-style model listing
  POST /v1/completions      → OpenAI-compatible text completion
  POST /v1/chat/completions   (+ SSE streaming, stop sequences, echo;
                              shaping in infer/openai_api.py)
  GET  /metrics             → Prometheus text (infer/metrics.py)
  GET  /anatomy             → per-request anatomy records

The orchestrator thread runs continuous batching across concurrent
requests; HTTP handlers block on their request's completion.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import torch

from skypilot_tpu_torch import resolve_device
from skypilot_tpu_torch import models
from skypilot_tpu_torch.agent import telemetry
from skypilot_tpu_torch.infer import anatomy as anatomy_lib
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import gang as gang_lib
from skypilot_tpu_torch.infer import metrics as metrics_lib
from skypilot_tpu_torch.infer import openai_api
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.infer import tokenizer as tokenizer_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import quantization as qops
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)


class ServingLoop:
    """Owns the orchestrator; steps continuously while work exists.

    HTTP handler threads submit under the lock and then poll their own
    Request.done flag (set by the orchestrator thread): the decode step
    dominates latency, so 5 ms polling adds nothing measurable.
    """

    def __init__(self, orch: orch_lib.Orchestrator) -> None:
        self.orch = orch
        self._wake = threading.Event()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name='xsky-infer-loop', daemon=True)
        self._thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the loop thread after its current step, so the engine it
        holds can be freed. Requests still in flight are not finished."""
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout)

    def submit(self, request: orch_lib.Request) -> orch_lib.Request:
        """Enqueue without blocking (streaming handlers poll the
        request's output_tokens/done themselves)."""
        # Phase flips to `step` at request ARRIVAL, inside the lock after
        # the enqueue: the loop's idle emit shares the lock, so it can
        # never land after this one and hide a wedged first request
        # behind the idle exemption.
        with self._lock:
            self.orch.submit(request)
            telemetry.emit(phase=telemetry.PHASE_STEP)
        self._wake.set()
        return request

    def submit_and_wait(self, request: orch_lib.Request,
                        timeout: float = 600.0,
                        on_progress=None) -> orch_lib.Request:
        """Blocking submit. ``on_progress(request)`` runs whenever new
        tokens have landed (callers use it for stop-sequence checks; it
        may set request.cancel_requested)."""
        self.submit(request)
        deadline = time.time() + timeout
        seen = -1
        while not request.done and time.time() < deadline:
            if on_progress is not None:
                n = len(request.output_tokens)
                if n > seen:
                    seen = n
                    on_progress(request)
            time.sleep(0.005)
        if not request.done:
            request.error = request.error or 'server timeout'
            # The caller is gone: stop decoding for it, free the slot.
            request.cancel_requested = True
        return request

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=1.0)
            while not self._stop.is_set():
                with self._lock:
                    try:
                        self.orch.step()
                        busy = bool(self.orch._slot_req or
                                    self.orch._partials or
                                    self.orch._deferred or
                                    not self.orch._pending.empty())
                    except Exception as e:  # pylint: disable=broad-except
                        # A dead serving loop must not strand waiting
                        # handlers (they poll request.done): fail every
                        # in-flight request loudly and keep serving.
                        logger.exception('serving loop step failed')
                        self.orch.fail_all(f'engine step failed: {e}')
                        busy = False
                    if not busy:
                        # Declared idle under the same lock submit()
                        # emits phase=step under; the stall detector
                        # exempts phase=idle from the hung verdict.
                        telemetry.emit(phase=telemetry.PHASE_IDLE)
                if not busy:
                    self._wake.clear()
                    break


def build_handler(loop: ServingLoop, config: engine_lib.EngineConfig,
                  tokenizer=None, model_id: str = 'model',
                  metrics=None, max_queue: int = 0):
    """max_queue > 0 sheds load: requests beyond that many pending
    admissions get 429 instead of unbounded queueing (an overloaded
    replica should fail fast so the serve LB retries a healthier one).
    """
    if metrics is None:
        metrics = metrics_lib.ServeMetrics()
    anatomy_log = anatomy_lib.get_log()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt % args)

        def _attach_trace(self, request):
            """Adopt the LB relay's cross-hop context (trace id, LB
            request id, remaining deadline) onto the orchestrator Request
            BEFORE submit: the deadline admission gate and the anatomy
            join key both read it from there."""
            trace_id, req_id, deadline_s = tracing.extract_headers(
                self.headers)
            request.trace_id = trace_id
            request.client_request_id = req_id
            if deadline_s is not None:
                request.deadline_at = time.perf_counter() + deadline_s
            return request

        def _seal(self, request, outcome):
            """Fold the finished request into the anatomy ring and record
            a deadline rejection as a span of the request's trace (the
            reference journals it in its state DB) — handler thread, off
            the tick path; never lets observability take down the
            response path."""
            try:
                if anatomy_lib.enabled():
                    rec = anatomy_log.seal(request, outcome=outcome)
                    if rec is not None:
                        metrics.observe_phases(rec['phases'])
                if request.error and \
                        request.error.startswith('deadline exceeded'):
                    with tracing.request_span(
                            request.trace_id, 'serve.deadline_reject',
                            scope=f'replica/{model_id}',
                            cause=request.error,
                            request_id=(request.client_request_id
                                        or request.request_id),
                            max_new_tokens=request.max_new_tokens):
                        pass
            except Exception:  # pylint: disable=broad-except
                logger.debug('anatomy seal failed', exc_info=True)

        def _json(self, code, payload):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            if self.path == '/health':
                self._json(200, {'status': 'healthy',
                                 'max_slots': config.max_slots})
            elif self.path == '/v1/models':
                self._json(200, {'object': 'list', 'data': [
                    {'id': model_id, 'object': 'model',
                     'owned_by': 'xsky'}]})
            elif self.path == '/metrics':
                data = metrics.render(orch=loop.orch).encode()
                self.send_response(200)
                self.send_header('Content-Type', 'text/plain; '
                                 'version=0.0.4; charset=utf-8')
                self.send_header('Content-Length', str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path.startswith('/anatomy'):
                # Replica-side anatomy records, newest-first
                # (?limit=&request_id=).
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                try:
                    limit = int(q.get('limit', ['200'])[0])
                except ValueError:
                    limit = 200
                req_id = (q.get('request_id', [None])[0]) or None
                self._json(200, anatomy_log.records(
                    limit=limit, request_id=req_id))
            else:
                self._json(404, {'error': 'not found'})

        def do_POST(self):  # noqa: N802
            if max_queue and loop.orch._pending.qsize() >= max_queue:
                self._json(429, {'error': {
                    'message': 'server overloaded: admission queue is '
                               'full, retry another replica',
                    'type': 'overloaded_error'}})
                return
            if self.path == '/generate':
                self._generate()
            elif self.path == '/v1/completions':
                self._openai(chat=False)
            elif self.path == '/v1/chat/completions':
                self._openai(chat=True)
            else:
                self._json(404, {'error': 'not found'})

        def _read_json(self):
            """Body as a dict, or None (invalid JSON *or* a JSON
            scalar/array: handlers need .get to work)."""
            length = int(self.headers.get('Content-Length') or 0)
            try:
                body = json.loads(self.rfile.read(length))
            except json.JSONDecodeError:
                return None
            return body if isinstance(body, dict) else None

        def _generate(self):
            """Token-ids wire surface."""
            body = self._read_json()
            if body is None:
                self._json(400, {'error': 'bad json'})
                return
            prompt = body.get('prompt_tokens')
            if not isinstance(prompt, list) or not prompt:
                self._json(400, {'error': 'prompt_tokens required'})
                return
            request = orch_lib.Request(
                prompt_tokens=[int(t) for t in prompt],
                max_new_tokens=int(body.get('max_new_tokens', 128)),
                eos_token_id=body.get('eos_token_id'),
                temperature=float(body.get('temperature', 0.0)),
                top_k=int(body.get('top_k', 0)),
                top_p=float(body.get('top_p', 1.0)))
            self._attach_trace(request)
            t0 = time.perf_counter()
            loop.submit_and_wait(request)
            metrics.observe_request('/generate', request)
            self._seal(request,
                       outcome='error' if request.error else 'ok')
            if request.error:
                self._json(400, {'error': request.error})
                return
            self._json(200, {
                'output_tokens': request.output_tokens,
                'latency_s': round(time.perf_counter() - t0, 3),
            })

        def _openai(self, chat: bool):
            if tokenizer is None:
                self._json(503, {'error': {
                    'message': 'no tokenizer configured on this server',
                    'type': 'server_error'}})
                return
            body = self._read_json()
            if body is None:
                self._json(400, {'error': {
                    'message': 'request body is not valid JSON',
                    'type': 'invalid_request_error'}})
                return
            try:
                request, meta = openai_api.build_request(
                    body, tokenizer, config, model_id, chat,
                    admit_limit=loop.orch._admit_limit())
            except openai_api.ApiError as e:
                self._json(e.code, e.body())
                return
            endpoint = ('/v1/chat/completions' if chat
                        else '/v1/completions')
            self._attach_trace(request)
            if meta.stream:
                outcome = 'cancelled'
                try:
                    outcome = self._stream(request, meta)
                finally:
                    metrics.observe_request(endpoint, request,
                                            outcome=outcome)
                    self._seal(request, outcome=outcome)
                return
            siblings = [openai_api.clone_request(request)
                        for _ in range(meta.n - 1)]
            for sib in siblings:
                loop.submit(sib)
            self._await_with_stops(request, meta)
            # Siblings need the same stop-sequence cancellation as the
            # primary: without it a stopped sibling decodes its whole
            # budget, burning slots and stalling this response.
            deadline = time.time() + 600
            seen = {id(s): -1 for s in siblings}
            while (any(not s.done for s in siblings)
                   and time.time() < deadline):
                if meta.stop:
                    for sib in siblings:
                        if sib.done or sib.cancel_requested:
                            continue
                        # Decode only on new tokens (the same guard as
                        # submit_and_wait).
                        m = len(sib.output_tokens)
                        if m == seen[id(sib)]:
                            continue
                        seen[id(sib)] = m
                        sib_text = tokenizer.decode(
                            list(sib.output_tokens))
                        if openai_api.find_stop(sib_text,
                                                meta.stop) != -1:
                            sib.cancel_requested = True
                time.sleep(0.005)
            for sib in siblings:
                if not sib.done:
                    # Do not assemble a response from a request the
                    # orchestrator thread is still appending to.
                    sib.error = sib.error or 'server timeout'
                    sib.cancel_requested = True
            metrics.observe_request(endpoint, request)
            self._seal(request,
                       outcome='error' if request.error else 'ok')
            for sib in siblings:
                # Token counters see every choice's generation, but one
                # HTTP request stays ONE request in the count/latency
                # series and seals ONE anatomy record.
                metrics.observe_choice_tokens(sib)
            failed = request.error or next(
                (s.error for s in siblings if s.error), None)
            if failed:
                self._json(400, {'error': {'message': failed,
                                           'type': 'engine_error'}})
                return
            text, finish_reason = openai_api.finalize_text(
                meta, request, tokenizer)
            extra = []
            for sib in siblings:
                sib_text, sib_reason = openai_api.finalize_text(
                    meta, sib, tokenizer)
                extra.append((sib, sib_text, sib_reason))
            self._json(200, openai_api.response_body(
                meta, request, text, finish_reason, tokenizer=tokenizer,
                extra_choices=extra))

        def _await_with_stops(self, request, meta):
            """Blocking wait that still cancels on a stop-sequence hit:
            without it a stopped request keeps its decode slot until
            max_tokens though the text past the stop is discarded."""

            def check_stop(req):
                if req.cancel_requested:
                    return
                text = tokenizer.decode(list(req.output_tokens))
                if openai_api.find_stop(text, meta.stop) != -1:
                    req.cancel_requested = True

            loop.submit_and_wait(
                request,
                on_progress=check_stop if meta.stop else None)

        def _stream(self, request, meta) -> str:
            """Server-sent events; one chunk per newly safe text delta.
            Returns the metrics outcome ('ok'/'error'/'cancelled')."""
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.send_header('Cache-Control', 'no-cache')
            self.send_header('Connection', 'close')
            self.end_headers()
            emitter = openai_api.StreamEmitter(tokenizer, meta.stop)
            loop.submit(request)
            first = True
            deadline = time.time() + 600.0
            seen = -1
            try:
                if meta.echo and meta.kind == 'completion':
                    # OpenAI streams the echoed prompt as the first chunk.
                    prompt_text = meta.prompt_text or \
                        tokenizer.decode(meta.prompt_tokens)
                    self.wfile.write(openai_api.sse(
                        openai_api.chunk_body(meta, prompt_text, None,
                                              first=True)))
                    self.wfile.flush()
                    first = False
                timed_out = False
                while True:
                    if time.time() > deadline:
                        request.cancel_requested = True
                        timed_out = True
                        break
                    done = request.done
                    # Snapshot: the orchestrator thread appends
                    # concurrently; list() pins a consistent view.
                    tokens = list(request.output_tokens)
                    if len(tokens) == seen and not done:
                        time.sleep(0.005)  # nothing new: don't re-decode
                        continue
                    seen = len(tokens)
                    delta = emitter.push(tokens, final=done)
                    if delta or (first and meta.kind == 'chat'):
                        self.wfile.write(openai_api.sse(
                            openai_api.chunk_body(meta, delta, None,
                                                  first=first)))
                        self.wfile.flush()
                        first = False
                    if emitter.finished:  # stop-sequence hit
                        request.cancel_requested = True
                        break
                    if done:
                        break
                    time.sleep(0.005)
                error = request.error or \
                    ('server timeout' if timed_out else None)
                if error and not emitter.finished:
                    # Engine died / deadline: tell the client instead of
                    # dressing a truncation up as a clean finish.
                    self.wfile.write(openai_api.sse(
                        {'error': {'message': error,
                                   'type': 'engine_error'}}))
                    self.wfile.write(openai_api.SSE_DONE)
                    self.wfile.flush()
                    return 'error'
                finish_reason = emitter.finish_reason or (
                    'length' if len(request.output_tokens) >=
                    request.max_new_tokens else 'stop')
                self.wfile.write(openai_api.sse(openai_api.chunk_body(
                    meta, '', finish_reason)))
                self.wfile.write(openai_api.SSE_DONE)
                self.wfile.flush()
                return 'ok'
            except (BrokenPipeError, ConnectionResetError):
                # Client went away: free the slot at the next token.
                request.cancel_requested = True
                return 'cancelled'

    return Handler


def warm_up(orch: orch_lib.Orchestrator) -> None:
    """The reference's warm-up, before the server reports healthy: a
    greedy, a logprobs, a penalized and a sampled request, and every
    admission wave size up to max_slots. Here it builds each kernel (one
    nvcc per source on first launch) and fills the allocator's pools, so
    no request pays for either mid-serving."""
    orch.generate([[1, 2, 3]], max_new_tokens=2)
    orch.submit(orch_lib.Request(prompt_tokens=[1, 2, 3],
                                 max_new_tokens=2, logprobs=1))
    orch.run_until_drained()
    orch.submit(orch_lib.Request(prompt_tokens=[1, 2, 3],
                                 max_new_tokens=2,
                                 presence_penalty=0.1,
                                 frequency_penalty=0.1))
    orch.run_until_drained()
    max_slots = orch.engine.config.max_slots
    pow2 = 2
    while True:
        wave = min(pow2, max_slots)
        orch.generate([[1, 2, 3]] * wave, max_new_tokens=2)
        for _ in range(wave):
            orch.submit(orch_lib.Request(prompt_tokens=[1, 2, 3],
                                         max_new_tokens=2,
                                         temperature=0.8,
                                         top_k=5, top_p=0.9))
        orch.run_until_drained()
        if wave == max_slots:
            break
        pow2 *= 2


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.infer.server')
    parser.add_argument('--model', default='llama3-1b')
    parser.add_argument('--hf-checkpoint', default=None,
                        help='Local HuggingFace checkpoint dir '
                             '(config.json + safetensors or '
                             'pytorch_model*.bin), converted on the '
                             'host at start-up; replaces --model')
    parser.add_argument('--port', type=int, default=8080)
    parser.add_argument('--max-slots', type=int, default=16)
    parser.add_argument('--max-target-len', type=int, default=2048)
    parser.add_argument('--kv-dtype', default='bf16',
                        choices=['bf16', 'int8'],
                        help='int8 halves KV-cache memory (per-head '
                             'scales)')
    parser.add_argument('--weight-dtype', default='bf16',
                        choices=['bf16', 'int8', 'int4'],
                        help='int8 halves weight memory (per-channel '
                             'scales); int4 halves it again (packed '
                             'nibbles, group-128 scales)')
    parser.add_argument('--mesh', default=None,
                        help="e.g. 'tensor=4' to shard across cards: one "
                             'rank process per card (--procs-per-host)')
    parser.add_argument('--procs-per-host', default='auto',
                        help="Rank processes this launcher starts on its "
                             "host under --mesh, one per card: 'auto' "
                             '(the host\'s card count; 1 with --device '
                             'cpu or no card) or a count')
    parser.add_argument('--tokenizer', default='byte',
                        help="'byte' (built-in reversible byte-level) "
                             'or a local HuggingFace tokenizer path '
                             '(enables the /v1 text endpoints)')
    parser.add_argument('--draft-model', default=None,
                        help='Enable speculative decoding with this '
                             'draft model (same vocab as --model)')
    parser.add_argument('--spec-gamma', type=int, default=4,
                        help='Draft tokens proposed per speculative '
                             'round')
    parser.add_argument('--spec-ngram', action='store_true',
                        help='Draft-model-free speculation: propose '
                             'continuations by prompt lookup (n-gram '
                             'match against the request history), '
                             'verified in one target pass')
    parser.add_argument('--model-id', default=None,
                        help='Model id reported by /v1/models '
                             '(default: the --hf-checkpoint directory\'s '
                             'name, else --model)')
    parser.add_argument('--max-queue', type=int, default=64,
                        help='Pending-admission cap: beyond this the '
                             'replica sheds load with 429 so the serve '
                             'LB retries elsewhere. 0 = unbounded.')
    parser.add_argument('--decode-steps', type=int, default=4,
                        help='Decode steps fused per engine call '
                             '(streaming granularity and EOS latency '
                             'grow by the same factor). 1 = per-token.')
    parser.add_argument('--no-batched-admission', action='store_true',
                        help='Per-prompt prefill admission instead of '
                             'one forward per bucket group of a wave.')
    parser.add_argument('--kv-page-size', type=int, default=0,
                        help='Paged KV cache: tokens per page (must '
                             'divide max-target-len and every prefill '
                             'bucket). 0 (default) keeps the dense slot '
                             'cache')
    parser.add_argument('--kv-num-pages', type=int, default=0,
                        help='Pages in the paged-KV arena. 0 sizes it '
                             'to the dense cache footprint')
    parser.add_argument('--prefix-cache', type=int, default=0,
                        help='Prefix-cache entries (device-resident KV '
                             'reuse for shared prompt prefixes). 0 '
                             '(default) disables')
    parser.add_argument('--device', default=None,
                        help="Where the engine runs: the card by default "
                             "(the server refuses to start without one); "
                             "'cpu' to run on the CPU")
    args = parser.parse_args(argv)
    if args.mesh:
        from skypilot_tpu_torch.train.launch import parse_mesh
        try:
            args.mesh_plan = parse_mesh(args.mesh)
        except ValueError as e:
            parser.error(f'--mesh: {e}')
        if args.draft_model or args.spec_ngram:
            parser.error(f'--mesh: {engine_lib.SPECULATIVE_MESH}')
        msg = engine_lib.mesh_refusal(
            args.mesh_plan,
            None if args.hf_checkpoint else models.get_config(args.model),
            args.kv_page_size > 0)
        if msg:
            parser.error(f'--mesh: {msg}')
    else:
        args.mesh_plan = None
    return args


@dataclasses.dataclass
class Replica:
    """A warm replica: the HTTP server (not yet serving) and what it
    serves; under a mesh of more than one rank, ``gang`` is the engine
    the orchestrator talks to (``gang_lib.EngineProxy``)."""
    httpd: ThreadingHTTPServer
    loop: ServingLoop
    engine: engine_lib.InferenceEngine
    gang: Optional[gang_lib.EngineProxy] = None


def _orchestrator(args: argparse.Namespace,
                  engine: engine_lib.InferenceEngine
                  ) -> orch_lib.Orchestrator:
    """The replica's scheduler: draft-model speculation (the draft's
    weights seeded 1, the target's 0), prompt-lookup speculation, or
    plain continuous batching. A speculator refuses a paged engine
    (NotImplementedError), as in the reference."""
    if args.draft_model:
        draft_cfg = models.get_config(args.draft_model)
        if hasattr(draft_cfg, 'remat'):
            draft_cfg = dataclasses.replace(draft_cfg, remat=False)
        draft_config = engine_lib.EngineConfig(
            model=draft_cfg, max_slots=args.max_slots,
            max_target_len=args.max_target_len)
        gen = torch.Generator(device=engine.device)
        gen.manual_seed(1)
        draft_params = models.module_for(draft_cfg).init(
            draft_cfg, gen, device=engine.device)
        draft_engine = engine_lib.InferenceEngine(
            draft_config, draft_params, device=engine.device)
        orch = orch_lib.SpeculativeOrchestrator(
            engine, draft_engine, gamma=args.spec_gamma)
        logger.info('Speculative decoding: draft=%s gamma=%d',
                    args.draft_model, args.spec_gamma)
        if args.spec_ngram:
            logger.warning('--spec-ngram is ignored with --draft-model: '
                           'draft-model speculation takes precedence.')
    elif args.spec_ngram:
        orch = orch_lib.NgramSpeculator(engine, gamma=args.spec_gamma)
        logger.info('Prompt-lookup speculation: gamma=%d', args.spec_gamma)
    else:
        return orch_lib.Orchestrator(engine, decode_steps=args.decode_steps)
    if args.decode_steps != 1:
        logger.warning('--decode-steps is ignored with %s: speculation '
                       'already amortizes dispatch per round (γ+1 tokens).',
                       '--draft-model' if args.draft_model
                       else '--spec-ngram')
    return orch


def build_engine(args: argparse.Namespace) -> engine_lib.InferenceEngine:
    """The weights and the engine for ``args``: under ``--mesh`` this
    rank's blocks of both (the process group up: ``distributed.
    initialize``)."""
    device = resolve_device(args.device)
    hf_params = None
    if args.hf_checkpoint:
        # Convert on the HOST: the converter reads and stacks fp32
        # arrays, and a real checkpoint's fp32 tree is larger than
        # its bf16 one on the card.
        from skypilot_tpu_torch.models import convert as convert_lib
        model, hf_params = convert_lib.from_hf(args.hf_checkpoint,
                                               device='cpu')
        logger.info('Converted %s: %s, %.2fB params', args.hf_checkpoint,
                    type(model).__name__, model.num_params() / 1e9)
    else:
        model = models.get_config(args.model)
    if hasattr(model, 'remat'):
        model = dataclasses.replace(model, remat=False)
    model_lib = models.module_for(model)
    prefix_entries = args.prefix_cache
    if not engine_lib.supports_chunked_prefill(model_lib):
        prefix_entries = 0   # family lacks the chunked-prefill path
    weight_dtype = {'int8': torch.int8, 'int4': 'int4',
                    'bf16': torch.bfloat16}[args.weight_dtype]
    config = engine_lib.EngineConfig(
        model=model, max_slots=args.max_slots,
        max_target_len=args.max_target_len,
        kv_dtype=torch.int8 if args.kv_dtype == 'int8' else torch.bfloat16,
        weight_dtype=weight_dtype,
        prefix_cache_entries=prefix_entries,
        batched_admission=not args.no_batched_admission,
        kv_page_size=args.kv_page_size,
        kv_num_pages=args.kv_num_pages)
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    logger.info('Initializing %s on %s', args.hf_checkpoint or args.model,
                name)
    # The reference inits (or converts) and quantizes on the host, so that
    # the bf16 tree never reaches the chip. Here the quantized tree is
    # built on the card without it: a converted tree is quantized leaf by
    # leaf as it moves, and the seeded init quantizes each weight as it
    # draws it; a stacked weight goes one layer at a time both ways, so
    # no more than one layer of a bf16 stack is ever on the card
    # (Mixtral-8x7B's bf16 tree, 93.4 GB, is larger than the card).
    # Quantization is one fp32 division and round-half-even per value,
    # and each scale sees one layer, so the bytes are those of
    # quantize_params(init(...)); the engine's own quantize pass then
    # leaves the tree as it is. (A bf16 weight_dtype quantizes nothing.)
    # Under a mesh each leaf is cut to this rank's block as it lands (a
    # stack one layer at a time), so no rank holds a whole split leaf.
    mesh = splits = None
    if args.mesh_plan is not None:
        msg = engine_lib.mesh_refusal(args.mesh_plan, model, config.paged)
        if msg:
            raise NotImplementedError(msg)
        mesh = mesh_lib.build_mesh(args.mesh_plan)
        shapes = model_lib.init(model, device='meta')
        splits = mesh_lib.serving_splits(
            mesh, model_lib.logical_axes(model), shapes)
        logger.info('Rank %d of a %s mesh (%s)', mesh.rank, args.mesh,
                    mesh.shape)
    if hf_params is not None:
        params = qops.quantize_params_to(
            hf_params, weight_dtype, device,
            None if splits is None else mesh_lib.tree_cuts(splits))
        del hf_params
    elif splits is not None:
        with llama.draw_cuts(mesh_lib.draw_cuts_of(splits, shapes)):
            params = mesh_lib.block_tree(
                model_lib.init(model, device=device,
                               weight_dtype=weight_dtype), splits)
    else:
        params = model_lib.init(model, device=device,
                                weight_dtype=weight_dtype)
    if device.type == 'cuda':
        torch.cuda.empty_cache()   # the one-layer scratch of the build
    return engine_lib.InferenceEngine(config, params, device=device,
                                      mesh=mesh)


def build_replica(args: argparse.Namespace,
                  host: str = '0.0.0.0') -> Replica:
    """Weights, engine, warm-up, serving loop and HTTP server for
    ``args``; the server listens on (host, args.port) once the caller
    runs ``httpd.serve_forever()``. Under a mesh of several ranks this is
    global rank 0's part; the others run :func:`follow_replica`."""
    engine = build_engine(args)
    model = engine.config.model
    config = engine.config
    proxy = None
    if distributed.world_size() > 1:
        proxy = gang_lib.EngineProxy(engine, distributed.CommandChannel())
    orch = _orchestrator(args, proxy or engine)
    warm_up(orch)
    if proxy is not None:
        proxy.barrier()   # every rank warm
    loop = ServingLoop(orch)
    try:
        tokenizer = tokenizer_lib.get_tokenizer(args.tokenizer,
                                                model.vocab_size)
    except ValueError as e:
        # Tiny-vocab models can't host the byte tokenizer; the token-ids
        # endpoint still works, /v1 routes report 503.
        logger.warning('No tokenizer: %s', e)
        tokenizer = None
    default_id = (os.path.basename(args.hf_checkpoint.rstrip('/'))
                  if args.hf_checkpoint else args.model)
    httpd = ThreadingHTTPServer(
        (host, args.port),
        build_handler(loop, config, tokenizer=tokenizer,
                      model_id=args.model_id or default_id,
                      max_queue=args.max_queue))
    return Replica(httpd, loop, engine, proxy)


def follow_replica(args: argparse.Namespace) -> None:
    """A rank other than 0 of a replica under a mesh: its engine runs
    rank 0's calls until rank 0 stops the gang."""
    gang_lib.follow(build_engine(args), distributed.CommandChannel())


# A rank process of this host: this module, run again.
RANK_COMMAND = ('-m', 'skypilot_tpu_torch.infer.server')


def main(argv: Optional[List[str]] = None) -> int:
    """Serve as ``argv`` (default ``sys.argv[1:]``) says: one process, or
    under ``--mesh`` one rank of a gang, or, where ``--procs-per-host``
    comes to k > 1 and this process is no rank yet, the launcher of k
    rank processes of ``python`` + ``RANK_COMMAND`` + ``argv`` (its exit
    code: the first failing rank's)."""
    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else [str(a) for a in argv]
    args = parse_args(argv)
    if args.mesh_plan is None:
        replica = build_replica(args)
        logger.info('Serving on :%d', replica.httpd.server_address[1])
        replica.httpd.serve_forever()
        return 0
    device_type = torch.device(args.device).type if args.device else 'cuda'
    count = distributed.host_process_count(args.procs_per_host,
                                           device_type)
    if count > 1 and not distributed.is_rank_process():
        return distributed.run_host([sys.executable, *RANK_COMMAND, *argv],
                                    count)
    distributed.initialize(device_type=device_type)
    try:
        if distributed.rank() != 0:
            follow_replica(args)
            return 0
        replica = build_replica(args)
        logger.info('Serving on :%d (rank 0 of %d)',
                    replica.httpd.server_address[1],
                    distributed.world_size())
        try:
            replica.httpd.serve_forever()
        finally:
            if replica.gang is not None:
                replica.gang.stop()
    finally:
        distributed.shutdown()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
