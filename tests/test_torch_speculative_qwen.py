"""PyTorch port's speculative decoding over a Qwen-3 target (QK-norm) vs
the JAX reference's, on the CPU: ``verify_step``, ``NgramSpeculator``,
and ``SpeculativeOrchestrator`` with a one-layer Llama draft and with the
target drafting for itself.

fp32 ``qwen3-tiny`` with its QK-norm scales redrawn from a numpy seed
(unit scales would not show a misplaced norm), carried across with
``params_from_numpy``; the JAX engines trace under XSKY_DECODE_ATTN=xla,
set here for the module as the reference's speculative tests set it.
Tolerances: tokens, ``n_emitted`` and ``accept_stats`` identical.

Every test runs under a hard time limit of its own (``_time_limit``) and
every drain has an explicit step bound.
"""
from __future__ import annotations

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import orchestrator as jax_orch
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import qwen as jax_qwen
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import qwen

TEST_LIMIT_S = 120
MAX_STEPS = 64
SLOTS = 4
MODS = {'jax': jax_orch, 'port': orch_lib}
PROMPTS = [[int(t) for t in np.random.default_rng(20 + i).integers(0, 256, n)]
           for i, n in enumerate((6, 3, 13))]
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


def _engines(jcfg, tcfg, tree, port_lib):
    common = dict(max_slots=SLOTS, max_target_len=64,
                  prefill_buckets=(16, 32))
    return {
        'jax': jax_engine.InferenceEngine(jax_engine.EngineConfig(
            model=jcfg, kv_dtype=jnp.float32, **common),
            jax.tree_util.tree_map(jnp.asarray, tree)),
        'port': engine_lib.InferenceEngine(engine_lib.EngineConfig(
            model=tcfg, kv_dtype=torch.float32, **common),
            port_lib.params_from_numpy(tree, 'cpu'), device='cpu'),
    }


@pytest.fixture(scope='module')
def target():
    jcfg = dataclasses.replace(jax_qwen.QWEN3_TINY, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_qwen.init(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(103)
    for key in ('q_norm', 'k_norm'):
        shape = tree['layers'][key].shape
        tree['layers'][key] = (
            1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    return _engines(jcfg, qwen.QWEN3_TINY_F32, tree, qwen)


@pytest.fixture(scope='module')
def draft():
    widths = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64)
    jcfg = dataclasses.replace(jax_llama.LLAMA_TINY, dtype=jnp.float32,
                               **widths)
    tcfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32,
                               **widths)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jcfg, jax.random.PRNGKey(7)))
    return _engines(jcfg, tcfg, tree, llama)


def _drain(side, orch, prompts, new_tokens):
    requests = [orch.submit(MODS[side].Request(prompt_tokens=list(p),
                                               max_new_tokens=new_tokens))
                for p in prompts]
    orch.run_until_drained(max_steps=MAX_STEPS)
    assert all(r.done and r.error is None for r in requests)
    return [r.output_tokens for r in requests]


def _plain(target, prompts, new_tokens):
    out = {side: _drain(side, MODS[side].Orchestrator(eng), prompts,
                        new_tokens) for side, eng in target.items()}
    assert out['port'] == out['jax']
    return out['port']


@pytest.mark.parametrize('kind', ['perfect', 'garbage'])
def test_verify_step_matches_jax(target, kind):
    """Perfect proposals are all accepted with the bonus continuing the
    chain; garbage ones emit exactly the next greedy token; emitted and
    n_emitted equal JAX's."""
    gamma = 4
    expected = _plain(target, [PROMPTS[0]], 8)[0]
    out = {}
    for side, eng in target.items():
        orch = MODS[side].Orchestrator(eng)
        orch.submit(MODS[side].Request(prompt_tokens=list(PROMPTS[0]),
                                       max_new_tokens=8))
        orch._admit_one()
        slot = next(iter(orch._slot_req))
        proposals = np.full((SLOTS, gamma), 255, np.int32)
        if kind == 'perfect':
            proposals[slot] = expected[1:1 + gamma]
        _, emitted, n_emitted = eng.verify_step(orch.state, proposals)
        out[side] = (np.asarray(emitted)[slot].tolist(),
                     int(np.asarray(n_emitted)[slot]))
    n = gamma + 1 if kind == 'perfect' else 1
    assert out['port'] == out['jax']
    assert out['port'][1] == n and out['port'][0][:n] == expected[1:1 + n]


@pytest.mark.parametrize('kind', ['ngram', 'llama-draft', 'self-draft'])
def test_speculators_match_jax_and_plain_greedy(target, draft, kind):
    """Tokens and accept_stats equal JAX's, the tokens equal plain greedy
    decoding, and the self-draft accepts every proposal."""
    prompts = PROMPTS + [COPY]
    expected = _plain(target, prompts, 10)
    out = {}
    for side in MODS:
        mod = MODS[side]
        if kind == 'ngram':
            spec = mod.NgramSpeculator(target[side], gamma=3)
        else:
            other = draft if kind == 'llama-draft' else target
            spec = mod.SpeculativeOrchestrator(target[side], other[side],
                                               gamma=4)
        out[side] = (_drain(side, spec, prompts, 10),
                     dict(spec.accept_stats))
    assert out['port'] == out['jax']
    tokens, stats = out['port']
    assert tokens == expected and stats['rounds'] > 0
    if kind == 'self-draft':
        assert stats['accepted'] == stats['proposed']
