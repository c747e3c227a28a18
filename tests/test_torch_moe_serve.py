"""PyTorch port's Mixtral family through the engine, orchestrator,
converter and HTTP server vs the JAX reference's, on the CPU.

Engine greedy tokens of both packages at fp32 ``moe-tiny``: a wave that
the engines pad to 4 rows at a capacity factor low enough that an expert
drops a real token; a prompt past the largest bucket (chunked prefill,
routed with capacity b x s); a prefix-cache hit; int8 weights; and
prompt-lookup speculation. A tiny Mixtral checkpoint in HF's layout with
a sliding window converts to the reference's tree bit for bit and gives
its logits (the window carried in the config, ignored by both models).
``moe-tiny`` replicas through ``infer/server.py`` (int8 weights built as
drawn, and ``--spec-ngram``; a converted checkpoint) serve their own
orchestrator's tokens; ``--mesh tensor=2`` and the paged cache are
refused.

Weights come from the JAX ``init`` in fp32 with the norm scales redrawn
from a numpy seed; the JAX engine takes its masked XLA decode path
(XSKY_DECODE_ATTN=xla) over fp32 caches. Tolerances: greedy tokens and
accept_stats identical; converted trees bit for bit; logits 1e-5 (fp32,
another summation order, as in test_torch_convert.py).

Every test here runs under a hard time limit of its own (``_time_limit``),
every drain passes an explicit step bound, every HTTP call a timeout, and
every replica is closed in ``finally``.
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
from skypilot_tpu.models import convert as jax_convert
from skypilot_tpu.models import moe as jax_moe
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.infer import server as server_lib
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.ops import quantization as qops

TEST_LIMIT_S = 120
HTTP_TIMEOUT_S = 60
MAX_STEPS = 64
LOGITS_ATOL = 1e-5
MODS = {'jax': jax_orch, 'port': orch_lib}
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(0, 256, n)]
           for i, n in enumerate((3, 5, 12, 14, 9, 7))]
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


@pytest.fixture(scope='module')
def tree():
    """The JAX init of fp32 moe-tiny as numpy arrays, norms redrawn."""
    jcfg = dataclasses.replace(jax_moe.MOE_TINY, dtype=jnp.float32)
    out = jax.tree_util.tree_map(
        np.asarray, jax_moe.init(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(101)
    for key in ('attn_norm', 'mlp_norm'):
        out['layers'][key] = (1 + 0.2 * rng.standard_normal(
            out['layers'][key].shape)).astype(np.float32)
    return out


def _drain(side, orch, prompts, new_tokens):
    """Submit and drain with an explicit bound on the steps."""
    requests = [orch.submit(MODS[side].Request(prompt_tokens=list(p),
                                               max_new_tokens=new_tokens))
                for p in prompts]
    orch.run_until_drained(max_steps=MAX_STEPS)
    assert all(r.done and r.error is None for r in requests)
    return [r.output_tokens for r in requests]


def _engines(tree, model_kw=None, weights=False, **kw):
    model_kw = model_kw or {}
    jcfg = dataclasses.replace(jax_moe.MOE_TINY, dtype=jnp.float32,
                               **model_kw)
    tcfg = dataclasses.replace(moe.MOE_TINY_F32, **model_kw)
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
            moe.params_from_numpy(tree, 'cpu'), device='cpu'),
    }


# ---- engine and orchestrator ----

SERVE_CASES = {
    # Three prompts, a wave padded to 4 rows (the pad row repeats row 0
    # and takes capacity), at a capacity factor that makes experts
    # overflow: a real token is dropped in the wave.
    'forced-drop': (dict(model_kw=dict(capacity_factor=0.25)),
                    PROMPTS[2:5]),
    # A prompt past the largest bucket: chunks of 32 through
    # verify_forward (capacity b x s, no mask).
    'chunked': ({}, [LONG_PROMPT] + PROMPTS[:2]),
    # Two prompts sharing 25 tokens (a prefix-cache hit).
    'prefix-cache': (dict(prefix_cache_entries=4),
                     [LONG_PROMPT[:25] + [1, 2, 3],
                      LONG_PROMPT[:25] + [9, 8, 7, 6], PROMPTS[3]]),
    # int8 weights: the expert stacks per (expert, output channel), the
    # router kept in fp32.
    'int8-weights': (dict(weights=True), PROMPTS),
}


@pytest.mark.parametrize('case', sorted(SERVE_CASES))
def test_engine_greedy_tokens_match_jax(tree, monkeypatch, case):
    kw, prompts = SERVE_CASES[case]
    engines = _engines(tree, **kw)
    waves = []
    real_route = moe.route

    def spy(config, router_w, x, token_mask=None, capacity=None, **kw):
        r = real_route(config, router_w, x, token_mask, capacity, **kw)
        if capacity is None:          # a prefill wave, not a decode step
            real = (token_mask != 0)[:, None]
            waves.append((x.shape[0], bool((real & ~r.keep).any())))
        return r

    monkeypatch.setattr(moe, 'route', spy)
    out = {side: _drain(side, MODS[side].Orchestrator(eng, decode_steps=4),
                        prompts, 8)
           for side, eng in engines.items()}
    assert out['port'] == out['jax']
    assert all(len(t) == 8 for t in out['port'])
    jeng, teng = engines['jax'], engines['port']
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats
    if case == 'forced-drop':
        assert waves and all(rows == 4 * 16 for rows, _ in waves)
        assert any(dropped for _, dropped in waves)
    if 'prefix' in case:
        assert teng.prefix_cache_stats['hits'] >= 1
    if 'weights' in kw:
        layers = teng.params['layers']
        assert qops.is_quantized(layers['w_gate'])
        assert layers['router'].dtype == torch.float32


def test_ngram_speculator_matches_jax_and_plain_greedy(tree):
    """Prompt lookup over moe-tiny (verify rounds routed with capacity
    b x (gamma + 1)): tokens and accept_stats equal JAX's, and the tokens
    equal plain greedy decoding."""
    engines = _engines(tree)
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


# ---- the converter ----

@pytest.fixture(scope='module')
def hf_dir(tmp_path_factory):
    """A tiny Mixtral in HF's layout (save_pretrained), with a window."""
    transformers = pytest.importorskip('transformers')
    cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2, sliding_window=8,
        max_position_embeddings=128, rope_theta=1e6,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.MixtralForCausalLM(cfg).eval()
    path = tmp_path_factory.mktemp('hf') / 'tiny-mixtral'
    model.save_pretrained(path)
    return str(path)


def test_converted_checkpoint_equals_jax_and_ignores_its_window(hf_dir):
    """The converted tree equals the reference's bit for bit (experts
    [L, E, in, out], the router fp32), the config carries the window of
    8 as the reference's does, and 24-token logits agree: neither model
    applies the window."""
    jcfg, jp = jax_convert.from_hf(hf_dir, dtype=jnp.float32)
    tcfg, tp = convert.from_hf(hf_dir, dtype=torch.float32, device='cpu')
    assert isinstance(tcfg, moe.MoEConfig)
    assert dataclasses.asdict(tcfg) == {
        **dataclasses.asdict(jcfg), 'dtype': torch.float32}
    assert tcfg.sliding_window == 8 and tcfg.n_experts == 4
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == 13
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy().view(np.int32),
                                      np.asarray(leaf).view(np.int32),
                                      err_msg=str(path))
    tokens = np.random.default_rng(3).integers(0, 256, (2, 24)).astype(
        np.int32)
    want = np.asarray(jax_moe.forward(jcfg, jp, jnp.asarray(tokens)))
    got = moe.forward(tcfg, tp, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_ATOL, rtol=0)


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


REPLICAS = {
    'int8': ['--model', 'moe-tiny', '--weight-dtype', 'int8'],
    'spec-ngram': ['--model', 'moe-tiny', '--spec-ngram', '--spec-gamma',
                   '3'],
    'hf-checkpoint-int8': ['--weight-dtype', 'int8'],
}


@pytest.mark.parametrize('case', sorted(REPLICAS))
def test_moe_replica_serves_its_orchestrators_tokens(hf_dir, case):
    """``build_replica --model moe-tiny --device cpu`` (int8 weights
    quantized as the init draws them, or ``--spec-ngram``), and a
    converted checkpoint with int8 weights: /generate gives the tokens
    that the replica's own orchestrator generates for the same prompt
    (run with the serving loop held, its drain bounded), and the int8
    trees hold the bytes of quantize_params of the full-precision
    tree."""
    flags = list(REPLICAS[case])
    if case.startswith('hf'):
        flags += ['--hf-checkpoint', hf_dir]
    replica = server_lib.build_replica(server_lib.parse_args(
        flags + ['--device', 'cpu', '--port', '0', '--max-slots', '2',
                 '--max-target-len', '64']), host='127.0.0.1')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    try:
        orch = replica.loop.orch
        assert isinstance(replica.engine.config.model, moe.MoEConfig)
        assert isinstance(orch, orch_lib.NgramSpeculator) == (
            case == 'spec-ngram')
        assert replica.engine.supports_chunked_prefill
        if 'int8' in case:
            full = (convert.from_hf(hf_dir, device='cpu')[1]
                    if case.startswith('hf')
                    else moe.init(moe.MOE_TINY, device='cpu'))
            want = qops.quantize_params(full)
            got = replica.engine.params
            for key in ('w_gate', 'w_down', 'wq'):
                assert torch.equal(got['layers'][key].q,
                                   want['layers'][key].q)
                assert torch.equal(got['layers'][key].scale,
                                   want['layers'][key].scale)
            assert torch.equal(got['layers']['router'],
                               want['layers']['router'])
            assert qops.params_nbytes(got) == qops.params_nbytes(want)
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


def test_mesh_and_paged_replicas_are_refused(capsys):
    """``--mesh expert=8`` (serve_mixtral.yaml's sharding) parses, and
    ``--mesh tensor=2`` exits naming queue 1 item 8b-ii (tensor
    parallelism for the routed families); a paged moe-tiny replica
    raises as the reference's engine does (no paged hook for the
    family)."""
    args = server_lib.parse_args(['--model', 'mixtral-8x7b', '--mesh',
                                  'expert=8'])
    assert args.mesh_plan.expert == 8
    with pytest.raises(SystemExit):
        server_lib.parse_args(['--model', 'mixtral-8x7b', '--mesh',
                               'tensor=2'])
    assert 'queue 1 item 8b-ii' in capsys.readouterr().err
    with pytest.raises(NotImplementedError,
                       match='moe has no paged_decode_forward hook'):
        server_lib.build_replica(server_lib.parse_args(
            ['--model', 'moe-tiny', '--device', 'cpu', '--port', '0',
             '--max-slots', '2', '--max-target-len', '64',
             '--kv-page-size', '16']), host='127.0.0.1')
