"""PyTorch port's Qwen family through the engine, orchestrator and
trainer vs the JAX reference's, on the CPU: greedy tokens of both engines
(``qwen3-tiny`` with a prompt past the largest bucket, so it is prefilled
in chunks, and with a prefix-cache hit; ``qwen-tiny`` with int8 weights,
its biases kept in fp32), and three ``Trainer`` steps at ``qwen3-tiny``.

Weights come from the JAX ``init`` in fp32 with the Qwen leaves redrawn
from a numpy seed, as in test_torch_qwen.py; the JAX engine takes its
masked XLA decode path (XSKY_DECODE_ATTN=xla) over fp32 caches.
Tolerances: greedy tokens identical; trainer loss 1e-5 absolute,
gradient norm 1e-5 relative, parameters after three steps 5e-5 absolute
(as in test_torch_train.py, which says why).

Every test here runs under a hard time limit of its own (``_time_limit``)
and every serving loop drains with an explicit step bound.
"""
from __future__ import annotations

import dataclasses
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import orchestrator as jax_orch
from skypilot_tpu.models import qwen as jax_qwen
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.models import qwen
from skypilot_tpu_torch.ops import quantization as qops
from skypilot_tpu_torch.train import trainer

TEST_LIMIT_S = 120
LOSS_ATOL = 1e-5
TRAINER_PARAM_ATOL = 5e-5
NAMES = ('qwen-tiny', 'qwen3-tiny')
QWEN_LEAVES = {'qwen-tiny': ('bq', 'bk', 'bv'),
               'qwen3-tiny': ('q_norm', 'k_norm')}
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(0, 256, n)]
           for i, n in enumerate((3, 5, 12, 20, 31, 7))]
LONG_PROMPT = [int(t) for t in
               np.random.default_rng(7).integers(0, 256, 50)]


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


@pytest.fixture
def xla_decode(monkeypatch):
    monkeypatch.setenv('XSKY_DECODE_ATTN', 'xla')


def _configs(name, **kw):
    return (dataclasses.replace(jax_qwen.CONFIGS[name], dtype=jnp.float32,
                                **kw),
            dataclasses.replace(qwen.CONFIGS[name], dtype=torch.float32,
                                **kw))


@pytest.fixture(scope='module')
def params():
    """{name: (JAX tree, port tree)}: fp32, the same values."""
    out = {}
    for seed, name in enumerate(NAMES):
        jcfg, _ = _configs(name)
        tree = jax.tree_util.tree_map(
            np.asarray, jax_qwen.init(jcfg, jax.random.PRNGKey(seed)))
        rng = np.random.default_rng(100 + seed)
        for key in QWEN_LEAVES[name]:
            shape = tree['layers'][key].shape
            draw = rng.standard_normal(shape).astype(np.float32)
            tree['layers'][key] = (0.5 * draw if key.startswith('b')
                                   else 1 + 0.2 * draw)
        out[name] = (jax.tree_util.tree_map(jnp.asarray, tree),
                     qwen.params_from_numpy(tree, 'cpu'))
    return out


def _leaves(tree, prefix=''):
    """{'/path': leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_leaves(value, f'{prefix}/{key}'))
        return out
    return {prefix: tree}


# ---- engine and orchestrator ----

SERVE_CASES = {
    # qwen3-tiny: a prompt past the largest bucket (chunked prefill).
    'chunked': ('qwen3-tiny', {}, [LONG_PROMPT] + PROMPTS[:2]),
    # qwen3-tiny: two prompts sharing 25 tokens (a prefix-cache hit).
    'prefix-cache': ('qwen3-tiny', dict(prefix_cache_entries=4),
                     [LONG_PROMPT[:25] + [1, 2, 3],
                      LONG_PROMPT[:25] + [9, 8, 7, 6], PROMPTS[3]]),
    # qwen-tiny, int8 weights: the biases stay fp32 beside int8 matrices.
    'int8-weights': ('qwen-tiny', dict(weight_dtype='int8'), PROMPTS),
}
MAX_STEPS = 64


def _drain(orch_mod, orch, prompts, new_tokens):
    """Orchestrator.generate with an explicit bound on its steps."""
    requests = [orch.submit(orch_mod.Request(prompt_tokens=p,
                                             max_new_tokens=new_tokens))
                for p in prompts]
    orch.run_until_drained(max_steps=MAX_STEPS)
    return requests


@pytest.mark.parametrize('case', sorted(SERVE_CASES))
def test_engine_greedy_tokens_match_jax(params, xla_decode, case):
    name, kw, prompts = SERVE_CASES[case]
    kw = dict(kw)
    weights = kw.pop('weight_dtype', None)
    jcfg, tcfg = _configs(name)
    jp, tp = params[name]
    common = dict(max_slots=4, max_target_len=64, prefill_buckets=(16, 32),
                  **kw)
    jeng = jax_engine.InferenceEngine(jax_engine.EngineConfig(
        model=jcfg, kv_dtype=jnp.float32,
        **({'weight_dtype': jnp.int8} if weights else {}), **common), jp)
    teng = engine_lib.InferenceEngine(engine_lib.EngineConfig(
        model=tcfg, kv_dtype=torch.float32,
        **({'weight_dtype': torch.int8} if weights else {}), **common), tp,
        device='cpu')
    want = _drain(jax_orch, jax_orch.Orchestrator(jeng, decode_steps=4),
                  prompts, 8)
    torch_orch = orch_lib.Orchestrator(teng, decode_steps=4)
    got = _drain(orch_lib, torch_orch, prompts, 8)
    assert [r.output_tokens for r in got] == [r.output_tokens for r in want]
    assert all(r.error is None and len(r.output_tokens) == 8 for r in got)
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats
    assert sorted(torch_orch._free_slots) == [0, 1, 2, 3]
    if 'prefix' in case:
        assert teng.prefix_cache_stats['hits'] >= 1
    if weights:
        layers = teng.params['layers']
        assert qops.is_quantized(layers['wq'])
        assert all(layers[k].dtype == torch.float32
                   for k in QWEN_LEAVES[name])


# ---- training ----

def test_trainer_steps_match_jax():
    """Three adamw steps at qwen3-tiny from the JAX trainer's initial
    weights: losses, gradient norms and every parameter after them."""
    jcfg, tcfg = _configs('qwen3-tiny')
    common = dict(global_batch_size=4, seq_len=24, learning_rate=1e-3,
                  warmup_steps=2)
    jtr = jax_trainer.Trainer(
        jax_trainer.TrainConfig(model=jcfg,
                                mesh_plan=mesh_lib.MeshPlan(data=1),
                                **common),
        mesh=mesh_lib.build_mesh(mesh_lib.MeshPlan(data=1),
                                 devices=jax.devices()[:1]))
    ttr = trainer.Trainer(trainer.TrainConfig(model=tcfg, **common),
                          device='cpu')
    state_j = jtr.init_state()
    state_t = ttr.init_state(qwen.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, state_j['params']), 'cpu'))
    for step in range(3):
        rng = np.random.default_rng(10 + step)
        tokens = rng.integers(0, 256, (4, 24)).astype(np.int32)
        batch = {'tokens': tokens, 'targets': np.roll(tokens, -1, axis=1)}
        state_j, m_j = jtr.step(state_j, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        state_t, m_t = ttr.step(state_t, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        assert float(m_t['loss']) == pytest.approx(float(m_j['loss']),
                                                   abs=LOSS_ATOL)
        assert float(m_t['grad_norm']) == pytest.approx(
            float(m_j['grad_norm']), rel=1e-5)
    want, got = _leaves(state_j['params']), _leaves(state_t['params'])
    assert set(got) == set(want)
    for key, leaf in want.items():
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(leaf),
                                   atol=TRAINER_PARAM_ATOL, err_msg=key)
