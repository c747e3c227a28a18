"""PyTorch port's Gemma family through the engine, orchestrator,
speculator and HTTP server vs the JAX reference's, on the CPU.

Greedy tokens of both engines: ``gemma2-tiny`` (a window of 8 on even
layers) with a 50-token prompt past the largest bucket, so that it is
prefilled in chunks across the window, and with a prefix-cache hit of 25
tokens (past the window too); ``gemma-tiny`` with int8 weights (the tied
embedding quantized by rows serves both the gather and the head); and
the decoupled ``gemma2-tiny`` at head_dim 32. ``NgramSpeculator`` over
``gemma2-tiny`` gives JAX's tokens and accept_stats, and plain greedy
tokens. A replica built by ``infer/server.py --model gemma2-tiny`` serves
its own orchestrator's tokens, with and without ``--spec-ngram``; a paged
Gemma-2 replica is refused with the reference's message.

Weights come from the JAX ``init`` in fp32 with every norm redrawn from a
numpy seed, as in test_torch_gemma.py; the JAX engines take their masked
XLA decode path (XSKY_DECODE_ATTN=xla, set for the module). Tolerances:
tokens, prefix-cache statistics and accept_stats identical.

Every test runs under a hard time limit of its own (``_time_limit``),
every drain has an explicit step bound, every HTTP request a timeout, and
every server is closed in a ``finally``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import orchestrator as jax_orch
from skypilot_tpu.models import gemma as jax_gemma
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.infer import server as server_lib
from skypilot_tpu_torch.models import gemma
from skypilot_tpu_torch.ops import quantization as qops

TEST_LIMIT_S = 120
HTTP_TIMEOUT_S = 60
MAX_STEPS = 64
MODS = {'jax': jax_orch, 'port': orch_lib}
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(0, 256, n)]
           for i, n in enumerate((3, 5, 12, 20, 31, 7))]
LONG_PROMPT = [int(t) for t in
               np.random.default_rng(7).integers(0, 256, 50)]
COPY = [int(t) for t in np.random.default_rng(29).integers(0, 256, 8)] * 3


@pytest.fixture(scope='module', autouse=True)
def _xla_decode_path():
    prev = os.environ.get('XSKY_DECODE_ATTN')
    os.environ['XSKY_DECODE_ATTN'] = 'xla'
    yield
    if prev is None:
        os.environ.pop('XSKY_DECODE_ATTN', None)
    else:
        os.environ['XSKY_DECODE_ATTN'] = prev


@pytest.fixture(autouse=True)
def _time_limit():
    """Fail a test that runs past TEST_LIMIT_S seconds (SIGALRM), so a
    hang costs one test, not the whole run."""
    def expire(signum, frame):
        del signum, frame
        raise TimeoutError(f'test ran past its {TEST_LIMIT_S} s limit')

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def _configs(name, **kw):
    return (dataclasses.replace(jax_gemma.CONFIGS[name], dtype=jnp.float32,
                                **kw),
            dataclasses.replace(gemma.CONFIGS[name], dtype=torch.float32,
                                **kw))


def _tree(jcfg, seed):
    """The JAX init as numpy arrays, every norm redrawn (0.3·N(0, 1))."""
    tree = jax.tree_util.tree_map(
        np.asarray, jax_gemma.init(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(100 + seed)
    for parent in (tree['layers'], tree):
        for key in [k for k in parent if k.endswith('_norm')]:
            parent[key] = (0.3 * rng.standard_normal(
                parent[key].shape)).astype(np.float32)
    return tree


def _drain(side, orch, prompts, new_tokens):
    """Submit and drain with an explicit bound on the steps."""
    requests = [orch.submit(MODS[side].Request(prompt_tokens=list(p),
                                               max_new_tokens=new_tokens))
                for p in prompts]
    orch.run_until_drained(max_steps=MAX_STEPS)
    assert all(r.done and r.error is None for r in requests)
    return [r.output_tokens for r in requests]


def _engines(jcfg, tcfg, tree, weights=None, **kw):
    common = dict(max_slots=4, max_target_len=64, prefill_buckets=(16, 32),
                  **kw)
    return {
        'jax': jax_engine.InferenceEngine(jax_engine.EngineConfig(
            model=jcfg, kv_dtype=jnp.float32,
            **({'weight_dtype': jnp.int8} if weights else {}), **common),
            jax.tree_util.tree_map(jnp.asarray, tree)),
        'port': engine_lib.InferenceEngine(engine_lib.EngineConfig(
            model=tcfg, kv_dtype=torch.float32,
            **({'weight_dtype': torch.int8} if weights else {}), **common),
            gemma.params_from_numpy(tree, 'cpu'), device='cpu'),
    }


# ---- engine and orchestrator ----

SERVE_CASES = {
    # A prompt past the largest bucket: chunks of 32 across the window.
    'chunked': ('gemma2-tiny', {}, {}, [LONG_PROMPT] + PROMPTS[:2]),
    # Two prompts sharing 25 tokens (a prefix-cache hit past the window).
    'prefix-cache': ('gemma2-tiny', {}, dict(prefix_cache_entries=4),
                     [LONG_PROMPT[:25] + [1, 2, 3],
                      LONG_PROMPT[:25] + [9, 8, 7, 6], PROMPTS[3]]),
    # int8 weights: the tied embedding quantized by rows.
    'int8-weights': ('gemma-tiny', {}, dict(weights='int8'), PROMPTS),
    # 4 heads of 32 over d_model 64.
    'decoupled-head-dim': ('gemma2-tiny', dict(head_dim=32), {},
                           PROMPTS[2:] + [LONG_PROMPT[:40]]),
}


@pytest.mark.parametrize('case', sorted(SERVE_CASES))
def test_engine_greedy_tokens_match_jax(case):
    name, widths, kw, prompts = SERVE_CASES[case]
    jcfg, tcfg = _configs(name, **widths)
    engines = _engines(jcfg, tcfg, _tree(jcfg, 1), **kw)
    out = {side: _drain(side, MODS[side].Orchestrator(eng, decode_steps=4),
                        prompts, 8)
           for side, eng in engines.items()}
    assert out['port'] == out['jax']
    assert all(len(t) == 8 for t in out['port'])
    jeng, teng = engines['jax'], engines['port']
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats
    if 'prefix' in case:
        assert teng.prefix_cache_stats['hits'] >= 1
    if 'weights' in kw:
        assert qops.is_quantized(teng.params['embed'])
        assert qops.is_quantized(teng.params['layers']['wq'])


def test_ngram_speculator_matches_jax_and_plain_greedy():
    """Prompt lookup over gemma2-tiny (a copy-heavy prompt of 24 tokens,
    past the window): tokens and accept_stats equal JAX's, and the tokens
    equal plain greedy decoding."""
    jcfg, tcfg = _configs('gemma2-tiny')
    engines = _engines(jcfg, tcfg, _tree(jcfg, 2))
    prompts = PROMPTS[:3] + [COPY]
    plain = {side: _drain(side, MODS[side].Orchestrator(eng), prompts, 10)
             for side, eng in engines.items()}
    assert plain['port'] == plain['jax']
    out = {}
    for side, eng in engines.items():
        spec = MODS[side].NgramSpeculator(eng, gamma=3)
        out[side] = (_drain(side, spec, prompts, 10),
                     dict(spec.accept_stats))
    assert out['port'] == out['jax']
    tokens, stats = out['port']
    assert tokens == plain['port']
    assert stats['rounds'] > 0 and stats['proposed'] > 0


# ---- the replica's HTTP server ----

def _call(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize('flags', [[], ['--spec-ngram', '--spec-gamma',
                                        '3']], ids=['plain', 'spec-ngram'])
def test_gemma_replica_serves_its_orchestrators_tokens(flags):
    """``build_replica --model gemma2-tiny --device cpu`` (and with
    ``--spec-ngram``): /generate gives the tokens that the replica's own
    orchestrator generates for the same prompt (run with the serving
    loop held, its drain bounded), prompts past the window of 8."""
    replica = server_lib.build_replica(server_lib.parse_args(
        ['--model', 'gemma2-tiny', '--device', 'cpu', '--port', '0',
         '--max-slots', '2', '--max-target-len', '64'] + flags),
        host='127.0.0.1')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    try:
        orch = replica.loop.orch
        assert replica.engine.config.model == dataclasses.replace(
            gemma.GEMMA2_TINY, remat=False)
        assert isinstance(orch, orch_lib.NgramSpeculator) == bool(flags)
        for prompt in ([1, 2, 3], COPY, list(range(3, 40))):
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
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()


def test_paged_gemma2_replica_is_refused_as_the_reference():
    with pytest.raises(NotImplementedError,
                       match='sliding_window is not supported with the '
                             'paged cache'):
        server_lib.build_replica(server_lib.parse_args(
            ['--model', 'gemma2-tiny', '--device', 'cpu', '--port', '0',
             '--max-slots', '2', '--max-target-len', '64',
             '--kv-page-size', '16']), host='127.0.0.1')
