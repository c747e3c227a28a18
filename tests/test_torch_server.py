"""The port's HTTP serving surface vs the JAX reference's, on the CPU.

One live server from each package (the reference's ``build_handler``
over its engine, the port's over its own), module-scoped, over the same
fp32 tiny Llama (``vocab_size=512``, so the byte tokenizer fits) with
the same weights. Every HTTP test sends the same requests to both and
compares what comes back: ``/generate`` tokens, completion and chat text,
logprobs (within LP_ATOL), ``n`` choices, echo, stop sequences,
streaming, the status and body of every bad request, ``/metrics`` names
and counters. Response ids and creation times are random by design and
are left out. Cancellation and ``fail_all`` run on both orchestrators.
The units (tokenizer, openai_api, metrics, anatomy, tracing headers,
the telemetry spool line read by the reference's ``parse_sample``) are
held against the reference's too.

Every HTTP call carries a timeout of at most 60 s, and each fixture shuts
its server down. The JAX side takes its XLA decode path
(XSKY_DECODE_ATTN=xla), so the KV caches are fp32: over a bf16 cache
that path reads its own roundings (it differs from the reference's
Pallas kernel by ~1e-3 in logprobs; the port matches the kernel).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.agent import telemetry as jax_telemetry
from skypilot_tpu.infer import anatomy as jax_anatomy
from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import metrics as jax_metrics
from skypilot_tpu.infer import openai_api as jax_openai
from skypilot_tpu.infer import orchestrator as jax_orch
from skypilot_tpu.infer import server as jax_server
from skypilot_tpu.infer import tokenizer as jax_tokenizer
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.utils import tracing as jax_tracing
from skypilot_tpu_torch.agent import telemetry
from skypilot_tpu_torch.infer import anatomy
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import metrics as metrics_lib
from skypilot_tpu_torch.infer import openai_api
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.infer import server as server_lib
from skypilot_tpu_torch.infer import tokenizer as tokenizer_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.utils import tracing

# fp32 logprobs through two layers in another summation order.
LP_ATOL = 1e-5
TIMEOUT = 60
JCFG = dataclasses.replace(jax_llama.LLAMA_TINY, vocab_size=512,
                           dtype=jax.numpy.float32)
TCFG = dataclasses.replace(llama.LLAMA_TINY, vocab_size=512,
                           dtype=torch.float32)
ENGINE = dict(max_slots=4, max_target_len=64, prefill_buckets=(16, 32))


@pytest.fixture(scope='module')
def servers(tmp_path_factory):
    """{'jax': url, 'port': url} over the same weights; torn down after
    the module."""
    saved = {k: os.environ.get(k) for k in ('XSKY_DECODE_ATTN',
                                            'XSKY_STATE_DB')}
    os.environ['XSKY_DECODE_ATTN'] = 'xla'
    # The reference journals deadline rejections in its state DB.
    os.environ['XSKY_STATE_DB'] = str(
        tmp_path_factory.mktemp('state') / 'state.db')
    jp = jax_llama.init(JCFG, jax.random.PRNGKey(0))
    tp = llama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 'cpu')
    jconfig = jax_engine.EngineConfig(model=JCFG, kv_dtype=jax.numpy.float32,
                                      **ENGINE)
    tconfig = engine_lib.EngineConfig(model=TCFG, kv_dtype=torch.float32,
                                      **ENGINE)
    jorch = jax_orch.Orchestrator(jax_engine.InferenceEngine(jconfig, jp))
    torch_orch = orch_lib.Orchestrator(
        engine_lib.InferenceEngine(tconfig, tp, device='cpu'))
    jorch.generate([[1, 2, 3]], max_new_tokens=2)
    torch_orch.generate([[1, 2, 3]], max_new_tokens=2)
    jloop = jax_server.ServingLoop(jorch)
    tloop = server_lib.ServingLoop(torch_orch)
    jhttpd = ThreadingHTTPServer(('127.0.0.1', 0), jax_server.build_handler(
        jloop, jconfig, tokenizer=jax_tokenizer.ByteTokenizer(512),
        model_id='tiny-test'))
    thttpd = ThreadingHTTPServer(('127.0.0.1', 0), server_lib.build_handler(
        tloop, tconfig, tokenizer=tokenizer_lib.ByteTokenizer(512),
        model_id='tiny-test'))
    for httpd in (jhttpd, thttpd):
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield {'jax': f'http://127.0.0.1:{jhttpd.server_address[1]}',
           'port': f'http://127.0.0.1:{thttpd.server_address[1]}'}
    for httpd in (jhttpd, thttpd):
        httpd.shutdown()
        httpd.server_close()
    tloop.close()
    for key, value in saved.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value


def _call(url, path, body=None, raw=None, headers=None):
    """(status, parsed JSON or text) of one request."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(
        url + path, data=data,
        headers={'Content-Type': 'application/json', **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            status, text = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


def _both(servers, path, body=None, **kw):
    return (_call(servers['jax'], path, body, **kw),
            _call(servers['port'], path, body, **kw))


def _strip(payload):
    """Drop what is random by design: response ids, creation times and
    the handler's wall-clock latency."""
    if isinstance(payload, dict):
        return {k: _strip(v) for k, v in payload.items()
                if k not in ('id', 'created', 'latency_s')}
    if isinstance(payload, list):
        return [_strip(v) for v in payload]
    return payload


def _assert_close(got, want, path='$'):
    """Equal structure; floats within LP_ATOL, everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], f'{path}.{k}')
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f'{path}[{i}]')
    elif isinstance(want, float):
        assert abs(got - want) <= LP_ATOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _agree(servers, path, body=None, **kw):
    (js, jp), (ts, tp) = _both(servers, path, body, **kw)
    assert ts == js, (ts, tp, jp)
    _assert_close(_strip(tp), _strip(jp))
    return ts, tp


# ---- live routes ----

def test_health_and_models_agree(servers):
    for path in ('/health', '/v1/models'):
        status, _ = _agree(servers, path)
        assert status == 200


@pytest.mark.parametrize('body', [
    {'prompt_tokens': [5, 6, 7], 'max_new_tokens': 8},
    {'prompt_tokens': list(range(3, 30)), 'max_new_tokens': 12},
    {'prompt_tokens': [104, 105], 'max_new_tokens': 6, 'eos_token_id': 2},
])
def test_generate_tokens_agree(servers, body):
    status, payload = _agree(servers, '/generate', body)
    assert status == 200 and payload['output_tokens']


@pytest.mark.parametrize('path,body', [
    ('/v1/completions', {'prompt': 'hello', 'max_tokens': 8,
                         'temperature': 0}),
    ('/v1/completions', {'prompt': 'zq', 'max_tokens': 4, 'echo': True,
                         'temperature': 0}),
    ('/v1/completions', {'prompt': [4, 107, 108], 'max_tokens': 4,
                         'echo': True, 'temperature': 0}),
    ('/v1/chat/completions', {'messages': [{'role': 'user',
                                            'content': 'hi'}],
                              'max_tokens': 6, 'temperature': 0}),
])
def test_text_and_echo_agree(servers, path, body):
    status, payload = _agree(servers, path, body)
    assert status == 200 and payload['usage']['completion_tokens'] >= 1


@pytest.mark.parametrize('path,body', [
    ('/v1/completions', {'prompt': 'hello', 'max_tokens': 5,
                         'temperature': 0, 'logprobs': 3}),
    ('/v1/chat/completions', {'messages': [{'role': 'user',
                                            'content': 'hi'}],
                              'max_tokens': 4, 'temperature': 0,
                              'logprobs': True, 'top_logprobs': 2}),
    ('/v1/completions', {'prompt': 'hello', 'max_tokens': 4,
                         'temperature': 0, 'n': 3, 'logprobs': 0}),
])
def test_logprobs_and_n_choices_agree(servers, path, body):
    status, payload = _agree(servers, path, body)
    assert status == 200
    assert len(payload['choices']) == body.get('n', 1)
    assert payload['choices'][0]['logprobs']


def test_stop_sequences_agree(servers):
    base = {'prompt': 'Once upon', 'max_tokens': 12, 'temperature': 0}
    _, full = _agree(servers, '/v1/completions', base)
    text = full['choices'][0]['text']
    anchors = [c for c in text[1:] if c.strip()]
    assert anchors, f'no stop anchor in {text!r}'
    for stop in (anchors[0], [anchors[0], 'NEVER']):
        # Usage counts the tokens decoded before the cancel landed, which
        # depends on when each handler polled: only the choices agree.
        (js, jp), (status, stopped) = _both(
            servers, '/v1/completions', {**base, 'stop': stop,
                                         'logprobs': 1})
        assert status == js == 200
        _assert_close(stopped['choices'], jp['choices'])
        choice = stopped['choices'][0]
        assert status == 200 and choice['finish_reason'] == 'stop'
        assert choice['text'] == text.split(anchors[0])[0]
        assert ''.join(choice['logprobs']['tokens']) == choice['text']


def _stream(url, path, body):
    """(joined text deltas, finish reason, first delta) of one SSE
    response."""
    req = urllib.request.Request(
        url + path, data=json.dumps({**body, 'stream': True}).encode(),
        headers={'Content-Type': 'application/json'})
    parts, finish = [], None
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        assert resp.headers['Content-Type'] == 'text/event-stream'
        for line in resp:
            line = line.decode().strip()
            if not line.startswith('data: '):
                continue
            if line == 'data: [DONE]':
                break
            choice = json.loads(line[len('data: '):])['choices'][0]
            parts.append(choice.get('text')
                         or choice.get('delta', {}).get('content', ''))
            finish = choice['finish_reason'] or finish
    return ''.join(parts), finish, parts[0]


@pytest.mark.parametrize('path,body', [
    ('/v1/completions', {'prompt': 'abc', 'max_tokens': 8,
                         'temperature': 0}),
    ('/v1/completions', {'prompt': 'zq', 'max_tokens': 4, 'echo': True,
                         'temperature': 0}),
    ('/v1/chat/completions', {'messages': [{'role': 'user',
                                            'content': 'yo'}],
                              'max_tokens': 5, 'temperature': 0}),
])
def test_streaming_equals_non_streaming(servers, path, body):
    _, whole = _agree(servers, path, body)
    choice = whole['choices'][0]
    want = choice.get('text', choice.get('message', {}).get('content'))
    streams = {name: _stream(servers[name], path, body)
               for name in ('jax', 'port')}
    assert streams['port'][:2] == streams['jax'][:2] == (
        want, choice['finish_reason'])
    if body.get('echo'):
        assert streams['port'][2] == body['prompt']


BAD = [
    ('/v1/completions', {'prompt': 'x', 'n': 9}),
    ('/v1/completions', {'prompt': 'x', 'n': 2, 'stream': True}),
    ('/v1/completions', {'prompt': 'x', 'logprobs': 50}),
    ('/v1/completions', {'prompt': 'x', 'logprobs': 3, 'stream': True}),
    ('/v1/completions', {'prompt': ['a', 'b']}),
    ('/v1/completions', {}),
    ('/v1/completions', {'prompt': 'x', 'max_tokens': 0}),
    ('/v1/completions', {'prompt': 'x', 'max_tokens': 'many'}),
    ('/v1/completions', {'prompt': 'x', 'stop': [1]}),
    ('/v1/completions', {'prompt': 'x', 'stop': ['a', 'b', 'c', 'd', 'e']}),
    ('/v1/completions', {'prompt': 'x' * 80}),
    ('/v1/completions', {'prompt': 'x', 'presence_penalty': 3.0}),
    ('/v1/completions', {'prompt': 'x', 'temperature': 'hot'}),
    ('/v1/chat/completions', {'messages': []}),
    ('/v1/chat/completions', {'messages': [{'role': 'user',
                                            'content': 'x'}],
                              'top_logprobs': 3}),
    ('/v1/chat/completions', {'messages': [{'role': 'user',
                                            'content': 'x'}],
                              'logprobs': 'yes'}),
    ('/generate', {'prompt_tokens': []}),
    ('/generate', {'max_new_tokens': 3}),
    ('/generate', {'prompt_tokens': list(range(3, 80))}),
    ('/nope', {'prompt': 'x'}),
]


@pytest.mark.parametrize('path,body', BAD)
def test_bad_requests_get_the_same_status_and_body(servers, path, body):
    status, payload = _agree(servers, path, body)
    assert status in (400, 404)
    assert 'error' in payload


@pytest.mark.parametrize('path', ['/v1/completions', '/generate',
                                  '/v1/chat/completions'])
@pytest.mark.parametrize('raw', [b'"just a string"', b'{not json'])
def test_bodies_that_are_not_objects_get_the_same_400(servers, path, raw):
    status, _ = _agree(servers, path, raw=raw)
    assert status == 400


def test_unknown_get_route_is_404_on_both(servers):
    status, _ = _agree(servers, '/nope')
    assert status == 404


def test_deadline_rejection_agrees_and_is_traced(servers):
    """A relayed deadline that cannot cover the request is rejected at
    admission with a 400 on both; the port records it as a span of the
    request's trace (the reference journals it)."""
    headers = {'X-Xsky-Trace-Id': 'trace-deadline-1',
               'X-Xsky-Request-Id': 'lb-42', 'X-Xsky-Deadline-S': '0'}
    (js, jp), (ts, tp) = _both(servers, '/generate',
                               {'prompt_tokens': [5, 6], 'max_new_tokens':
                                4}, headers=headers)
    assert ts == js == 400
    assert tp['error'].startswith('deadline exceeded at admit')
    assert jp['error'].startswith('deadline exceeded at admit')
    spans = tracing.recent_spans('trace-deadline-1')
    assert [s['name'] for s in spans] == ['serve.deadline_reject']
    assert spans[0]['attrs']['request_id'] == 'lb-42'
    (js, jrecs), (ts, trecs) = _both(servers, '/anatomy?request_id=lb-42')
    assert ts == js == 200
    assert ([(r['outcome'], r['trace_id'], sorted(r)) for r in trecs] ==
            [(r['outcome'], r['trace_id'], sorted(r)) for r in jrecs] ==
            [('error', 'trace-deadline-1', sorted(jrecs[0]))])


def test_metrics_names_and_counters_agree(servers):
    _agree(servers, '/v1/completions', {'prompt': 'metrics-probe',
                                        'max_tokens': 4, 'temperature': 0})
    texts = {}
    deadline = time.time() + 30
    for name in ('jax', 'port'):
        # The serving loop frees the slot after the response returns.
        while True:
            status, text = _call(servers[name], '/metrics')
            assert status == 200
            if 'xsky_serve_free_slots 4' in text or time.time() > deadline:
                break
            time.sleep(0.1)
        texts[name] = text

    def families(text):
        return {line.split()[2] for line in text.splitlines()
                if line.startswith('# TYPE')}

    def counters(text):
        # Not generated tokens: a stop-sequence request decodes on until
        # its handler polls the hit, which timing decides.
        return {line for line in text.splitlines()
                if line.startswith(('xsky_serve_requests_total',
                                    'xsky_serve_prompt_tokens_total',
                                    'xsky_serve_free_slots',
                                    'xsky_serve_queue_depth'))}

    assert families(texts['port']) == families(texts['jax'])
    assert counters(texts['port']) == counters(texts['jax'])
    assert 'xsky_serve_phase_seconds' in families(texts['port'])


def test_max_queue_sheds_load():
    """A full admission queue returns 429 instead of queueing forever."""
    import queue as queue_mod

    class FakeOrch:
        _pending = queue_mod.Queue()

        def _admit_limit(self):
            return 63

    class FakeLoop:
        orch = FakeOrch()

    for _ in range(4):
        FakeLoop.orch._pending.put(object())
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), server_lib.build_handler(
        FakeLoop(), engine_lib.EngineConfig(model=TCFG),
        tokenizer=tokenizer_lib.ByteTokenizer(512), max_queue=4))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        status, payload = _call(f'http://127.0.0.1:'
                                f'{httpd.server_address[1]}',
                                '/v1/completions', {'prompt': 'x'})
        assert status == 429
        assert payload['error']['type'] == 'overloaded_error'
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---- cancellation and fail_all, on both orchestrators ----

@pytest.fixture(scope='module')
def small_engines():
    """(jax engine, port engine) with two slots, bucket 16."""
    jp = jax_llama.init(JCFG, jax.random.PRNGKey(1))
    tp = llama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 'cpu')
    cfg = dict(max_slots=2, max_target_len=64, prefill_buckets=(16,))
    return (jax_engine.InferenceEngine(
        jax_engine.EngineConfig(model=JCFG, **cfg), jp),
        engine_lib.InferenceEngine(
            engine_lib.EngineConfig(model=TCFG, **cfg), tp, device='cpu'))


def _scenario(orch_mod, engine, kind):
    orch = orch_mod.Orchestrator(engine)
    if kind == 'mid_decode':
        request = orch.submit(orch_mod.Request(prompt_tokens=[1, 2, 3],
                                               max_new_tokens=50))
        orch.step()
        orch.step()
        request.cancel_requested = True
        orch.step()
        return ([request.done, request.output_tokens, request.error],
                len(orch._free_slots))
    if kind == 'queued':
        request = orch.submit(orch_mod.Request(prompt_tokens=[1, 2],
                                               max_new_tokens=10))
        request.cancel_requested = True
        orch.step()
        return ([request.done, request.output_tokens, request.error],
                len(orch._free_slots))
    active = orch.submit(orch_mod.Request(prompt_tokens=[1, 2],
                                          max_new_tokens=10))
    orch.step()
    queued = orch.submit(orch_mod.Request(prompt_tokens=[3],
                                          max_new_tokens=10))
    orch.fail_all('engine step failed: boom')
    return ([[r.done, r.output_tokens, r.error] for r in (active, queued)],
            len(orch._free_slots))


@pytest.mark.parametrize('kind', ['mid_decode', 'queued', 'fail_all'])
def test_cancel_and_fail_all_agree(monkeypatch, small_engines, kind):
    monkeypatch.setenv('XSKY_DECODE_ATTN', 'xla')
    jeng, teng = small_engines
    want = _scenario(jax_orch, jeng, kind)
    got = _scenario(orch_lib, teng, kind)
    assert got == want
    assert got[1] == 2   # every slot back in the pool
    if kind == 'mid_decode':
        assert got[0][0] and 0 < len(got[0][1]) < 50
    if kind == 'queued':
        assert got[0][:2] == [True, []]


def test_fail_all_unblocks_a_waiting_handler(small_engines):
    """A handler blocked in submit_and_wait returns with the error when
    an engine step raises: the loop fails every request and keeps
    serving."""
    _, teng = small_engines
    orch = orch_lib.Orchestrator(teng)

    def raising_step():
        raise RuntimeError('boom')

    orch.step = raising_step
    loop = server_lib.ServingLoop(orch)
    try:
        request = loop.submit_and_wait(
            orch_lib.Request(prompt_tokens=[1, 2], max_new_tokens=10),
            timeout=TIMEOUT)
        assert request.done
        assert request.error == 'engine step failed: boom'
        assert loop._thread.is_alive()
    finally:
        loop.close()


def test_serving_loop_close_stops_its_thread(small_engines):
    _, teng = small_engines
    loop = server_lib.ServingLoop(orch_lib.Orchestrator(teng))
    loop.close()
    assert not loop._thread.is_alive()


# ---- units against the reference's ----

TEXTS = ['hello', 'héllo wörld — ¡ünïcode! 中文', '', 'a中b']


@pytest.mark.parametrize('text', TEXTS)
def test_byte_tokenizer_and_incremental_decoder_match(text):
    tok, ref = tokenizer_lib.ByteTokenizer(512), jax_tokenizer.ByteTokenizer(
        512)
    tokens = tok.encode(text)
    assert tokens == ref.encode(text)
    assert tok.decode(tokens) == ref.decode(tokens) == text
    assert tok.decode([tok.BOS_ID, tok.EOS_ID, 600] + tokens[1:]) == text
    dec = tokenizer_lib.IncrementalDecoder(tok)
    ref_dec = jax_tokenizer.IncrementalDecoder(ref)
    body = tokens[1:]
    for i in range(1, len(body) + 1):
        final = i == len(body)
        assert dec.delta(body[:i], final) == ref_dec.delta(body[:i], final)
    assert dec.emitted == ref_dec.emitted == text
    messages = [{'role': 'system', 'content': 's'},
                {'role': 'user', 'content': text}]
    assert (tokenizer_lib.render_chat(messages, tok) ==
            jax_tokenizer.render_chat(messages, ref))


def test_tokenizer_refusals_match():
    for mod in (tokenizer_lib, jax_tokenizer):
        with pytest.raises(ValueError, match='vocab'):
            mod.ByteTokenizer(256)
    assert isinstance(tokenizer_lib.get_tokenizer('byte', 300),
                      tokenizer_lib.ByteTokenizer)


REQUESTS = [
    ({'prompt': 'hi'}, False),
    ({'prompt': [5, 6, 7], 'max_tokens': 3, 'stop': 'x'}, False),
    ({'prompt': 'x', 'logprobs': 0}, False),
    ({'prompt': 'x', 'logprobs': 3, 'n': 2, 'temperature': 0.5,
      'top_p': 0.9, 'top_k': 4, 'presence_penalty': 0.5,
      'frequency_penalty': -0.25}, False),
    ({'messages': [{'role': 'user', 'content': 'yo'}]}, True),
    ({'messages': [{'role': 'user', 'content': 'x'}], 'logprobs': True,
      'top_logprobs': 4}, True),
    ({'prompt': 'x' * 40}, False),
]


@pytest.mark.parametrize('body,chat', REQUESTS)
@pytest.mark.parametrize('admit_limit', [None, 63])
def test_build_request_matches(body, chat, admit_limit):
    """Accepted bodies give the same orchestrator Request fields and
    meta; refused ones the same status and message."""
    cfg = engine_lib.EngineConfig(model=TCFG, **ENGINE)
    jcfg = jax_engine.EngineConfig(model=JCFG, **ENGINE)
    outcomes = []
    for mod, tmod, config in ((openai_api, tokenizer_lib, cfg),
                              (jax_openai, jax_tokenizer, jcfg)):
        try:
            request, meta = mod.build_request(
                body, tmod.ByteTokenizer(512), config, 'm', chat,
                admit_limit=admit_limit)
        except mod.ApiError as e:
            outcomes.append(('error', e.code, e.body()))
            continue
        fields = dataclasses.asdict(request)
        meta_fields = {k: v for k, v in dataclasses.asdict(meta).items()
                       if k not in ('response_id', 'created')}
        outcomes.append(('ok', fields, meta_fields))
    assert outcomes[0] == outcomes[1]


def test_stream_emitter_matches():
    tok, ref = tokenizer_lib.ByteTokenizer(512), jax_tokenizer.ByteTokenizer(
        512)
    tokens = tok.encode('abcSTOPdef', add_bos=False)
    for stops in (['STOP'], ['LONGSTOP'], []):
        em = openai_api.StreamEmitter(tok, stops)
        ref_em = jax_openai.StreamEmitter(ref, stops)
        for i in range(1, len(tokens) + 1):
            final = i == len(tokens)
            assert em.push(tokens[:i], final) == ref_em.push(tokens[:i],
                                                             final)
        assert (em.finished, em.finish_reason) == (ref_em.finished,
                                                   ref_em.finish_reason)


def test_serve_metrics_render_the_same_text(monkeypatch):
    """The same observations render the same Prometheus text (histograms,
    phase series, choice tokens, labels)."""
    monkeypatch.delenv('XSKY_TELEMETRY_DIR', raising=False)
    texts = []
    for mod, req_mod in ((metrics_lib, orch_lib), (jax_metrics, jax_orch)):
        m = mod.ServeMetrics()
        m.observe('/generate', 'ok', 10, 5, ttft_s=0.03, e2e_s=0.3,
                  tpot_s=0.004)
        m.observe('/generate', 'error', 2, 0, ttft_s=None, e2e_s=None)
        request = req_mod.Request(prompt_tokens=[1, 2])
        request.output_tokens = [5, 6, 7]
        request.submitted_at, request.first_token_at = 1.0, 1.2
        request.finished_at = 1.5
        m.observe_request('/v1/completions', request, outcome='ok')
        m.observe_choice_tokens(request)
        m.observe_phases({'prefill': 0.02, 'decode': 0.4})
        texts.append(m.render())
    assert texts[0] == texts[1]


def test_anatomy_seal_matches():
    records = []
    for mod, req_mod in ((anatomy, orch_lib), (jax_anatomy, jax_orch)):
        request = req_mod.Request(prompt_tokens=[1, 2, 3])
        request.output_tokens = [4, 5]
        request.request_id = 7
        request.client_request_id = 'lb-7'
        request.trace_id = 't'
        request.submitted_at, request.taken_at = 10.0, 10.5
        request.first_token_at, request.finished_at = 11.0, 12.5
        request.deferred_wait, request.decode_s = 0.1, 0.8
        request.commit_s = 0.05
        log = mod.AnatomyLog(maxlen=2)
        rec = dict(log.seal(request, outcome='ok'))
        rec.pop('ts')
        records.append((rec, [r['request_id'] for r in log.records()]))
    assert records[0] == records[1]


@pytest.mark.parametrize('headers', [
    {}, {'X-Xsky-Trace-Id': 'abc', 'X-Xsky-Request-Id': 'r1',
         'X-Xsky-Deadline-S': '1.500'},
    {'X-Xsky-Deadline-S': 'soon'}, None,
])
def test_extract_headers_matches(headers):
    assert (tracing.extract_headers(headers) ==
            jax_tracing.extract_headers(headers))


def test_request_span_records_a_row(monkeypatch):
    with tracing.request_span('tr-1', 'unit.span', k=1):
        pass
    rows = tracing.recent_spans('tr-1')
    assert rows[-1]['name'] == 'unit.span' and rows[-1]['status'] == 'OK'
    assert rows[-1]['attrs'] == {'k': 1}
    monkeypatch.setenv('XSKY_TRACING', '0')
    assert tracing.request_span('tr-2', 'off') is tracing.NOOP_SPAN


def test_telemetry_spool_line_parses_with_the_reference(tmp_path,
                                                        monkeypatch):
    """The port's spool file is one JSON sample that the reference's
    parse_sample, read_spool and verdict read: a step is progress, an
    idle replica is never called hung. (The emitter is driven directly:
    the live servers' loops emit through the environment.)"""
    monkeypatch.delenv('XSKY_TELEMETRY_DIR', raising=False)
    assert telemetry._current_emitter() is None   # emit() is a no-op
    emitter = telemetry._Emitter(str(tmp_path / 'rank-3.json'), 3)
    try:
        emitter.update(telemetry.PHASE_STEP, 5, None, None, 12.0, {})
        sample = jax_telemetry.parse_sample(
            (tmp_path / 'rank-3.json').read_text())
        assert sample is not None
        assert (sample['rank'], sample['phase'], sample['step']) == (
            3, 'step', 5)
        assert jax_telemetry.verdict(sample) == jax_telemetry.VERDICT_OK
        emitter.update(telemetry.PHASE_IDLE, None, None, None, None, {})
        sample = jax_telemetry.read_spool(str(tmp_path))[3]
        assert sample['phase'] == 'idle'
        assert jax_telemetry.verdict(sample, now=sample['hb_ts'],
                                     progress_stale=0.0) == 'ok'
        assert set(sample) == set(jax_telemetry._Emitter(
            str(tmp_path / 'x.json'), 0).sample)
    finally:
        emitter.stop()


# ---- --hf-checkpoint: both packages convert and serve one checkpoint ----

def test_hf_checkpoint_replicas_serve_the_same_tokens(tmp_path,
                                                      monkeypatch):
    """A tiny HF Llama saved with ``save_pretrained``; each package's
    server main converts it (bf16, on the host) and serves it live. The
    greedy tokens of /generate agree, and /v1/models reports the
    directory's name."""
    transformers = pytest.importorskip('transformers')
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    ckpt = tmp_path / 'tiny-hf-llama'
    transformers.LlamaForCausalLM(cfg).save_pretrained(ckpt)
    monkeypatch.setenv('XSKY_STATE_DB', str(tmp_path / 'state.db'))
    flags = ['--hf-checkpoint', str(ckpt), '--port', '0', '--max-slots',
             '2', '--max-target-len', '128']
    started = []

    class Captured(ThreadingHTTPServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            started.append(self)

    monkeypatch.setattr(jax_server, 'ThreadingHTTPServer', Captured)
    monkeypatch.setattr('sys.argv', ['server'] + flags)
    jax_thread = threading.Thread(target=jax_server.main, daemon=True)
    jax_thread.start()
    replica = server_lib.build_replica(
        server_lib.parse_args(flags + ['--device', 'cpu']), host='127.0.0.1')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    deadline = time.time() + 240
    while not started and time.time() < deadline:
        time.sleep(0.1)
    assert started, 'the JAX server did not start'
    urls = {'jax': f'http://127.0.0.1:{started[0].server_address[1]}',
            'port': f'http://127.0.0.1:{replica.httpd.server_address[1]}'}
    try:
        assert _call(urls['jax'], '/health')[0] == 200
        for url in urls.values():
            status, models = _call(url, '/v1/models')
            assert status == 200
            assert models['data'][0]['id'] == 'tiny-hf-llama'
        for prompt in ([1, 2, 3], [200, 17, 5, 9, 44, 101, 7],
                       list(range(3, 40))):
            body = {'prompt_tokens': prompt, 'max_new_tokens': 8,
                    'temperature': 0.0}
            got = {name: _call(url, '/generate', body)
                   for name, url in urls.items()}
            assert got['port'][0] == got['jax'][0] == 200
            assert got['port'][1]['output_tokens'] == \
                got['jax'][1]['output_tokens']
            assert len(got['port'][1]['output_tokens']) == 8
    finally:
        for httpd in (started[0], replica.httpd):
            httpd.shutdown()
            httpd.server_close()
        replica.loop.close()
        jax_thread.join(timeout=30)


# ---- a Qwen replica ----

def test_qwen_replica_serves_the_engines_tokens():
    """``build_replica --model qwen3-tiny --device cpu``: /generate gives
    the tokens that the replica's own orchestrator generates for the same
    prompt (run with the serving loop held, its drain bounded)."""
    from skypilot_tpu_torch.models import qwen
    replica = server_lib.build_replica(server_lib.parse_args(
        ['--model', 'qwen3-tiny', '--device', 'cpu', '--port', '0',
         '--max-slots', '2', '--max-target-len', '64']), host='127.0.0.1')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    try:
        assert replica.engine.config.model == dataclasses.replace(
            qwen.QWEN3_TINY, remat=False)
        for prompt in ([1, 2, 3], [200, 17, 5, 9, 44, 101, 7],
                       list(range(3, 40))):
            status, served = _call(url, '/generate', {
                'prompt_tokens': prompt, 'max_new_tokens': 8})
            assert status == 200
            orch = replica.loop.orch
            with replica.loop._lock:
                request = orch.submit(orch_lib.Request(prompt_tokens=prompt,
                                                       max_new_tokens=8))
                orch.run_until_drained(max_steps=32)
            assert request.error is None
            assert served['output_tokens'] == request.output_tokens
            assert len(request.output_tokens) == 8
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()


# ---- speculative replicas ----

SPEC_REPLICAS = {
    # serve_qwen.yaml's flags at tiny widths.
    'ngram': (['--model', 'qwen3-tiny', '--spec-ngram'],
              orch_lib.NgramSpeculator),
    # A Llama draft for a Qwen target (same vocabulary); --spec-ngram is
    # ignored beside it, with the reference's warning.
    'draft': (['--model', 'qwen3-tiny', '--draft-model', 'tiny',
               '--spec-ngram'], orch_lib.SpeculativeOrchestrator),
}


@pytest.mark.parametrize('case', sorted(SPEC_REPLICAS))
def test_speculative_replica_serves_the_speculators_tokens(caplog, case):
    """A replica with a speculation flag serves, on the CPU, the tokens
    of its own speculator (run with the serving loop held, its drain
    bounded), and /metrics carries the xsky_serve_spec_* series of its
    accept_stats."""
    flags, kind = SPEC_REPLICAS[case]
    caplog.set_level('INFO', logger=server_lib.logger.name)
    replica = server_lib.build_replica(server_lib.parse_args(
        flags + ['--device', 'cpu', '--port', '0', '--max-slots', '2',
                 '--max-target-len', '64', '--spec-gamma', '3']),
        host='127.0.0.1')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    try:
        orch = replica.loop.orch
        assert type(orch) is kind and orch.gamma == 3
        assert '--decode-steps is ignored' in caplog.text
        if case == 'draft':
            assert '--spec-ngram is ignored with --draft-model' in caplog.text
            assert orch.draft.config.model.n_layers == \
                llama.LLAMA_TINY.n_layers
        copy = [5, 9, 2, 7] * 4
        for prompt in ([1, 2, 3], copy, list(range(3, 40))):
            status, served = _call(url, '/generate', {
                'prompt_tokens': prompt, 'max_new_tokens': 8})
            assert status == 200
            with replica.loop._lock:
                request = orch.submit(orch_lib.Request(prompt_tokens=prompt,
                                                       max_new_tokens=8))
                orch.run_until_drained(max_steps=32)
            assert request.error is None
            assert served['output_tokens'] == request.output_tokens
            assert len(request.output_tokens) == 8
        status, text = _call(url, '/metrics')
        assert status == 200
        with replica.loop._lock:
            stats = dict(orch.accept_stats)
        assert stats['rounds'] > 0
        for key, value in stats.items():
            assert f'xsky_serve_spec_{key}_total {value}' in text
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()


@pytest.mark.parametrize('flags', [['--spec-ngram'],
                                   ['--draft-model', 'tiny']])
def test_speculation_refuses_a_paged_engine_as_the_reference(flags):
    """No verify on the page arena: the replica raises the speculator's
    NotImplementedError (the reference's text) instead of quietly
    decoding without speculation."""
    with pytest.raises(NotImplementedError,
                       match='target model family has no verify_forward'):
        server_lib.build_replica(server_lib.parse_args(
            ['--model', 'tiny', '--device', 'cpu', '--port', '0',
             '--max-slots', '2', '--max-target-len', '64',
             '--kv-page-size', '16'] + flags), host='127.0.0.1')
