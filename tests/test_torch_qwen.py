"""PyTorch port's Qwen family (``models/qwen.py``) vs the JAX reference,
on the CPU, at both tiny variants: ``qwen-tiny`` (Qwen-2: Q/K/V biases)
and ``qwen3-tiny`` (Qwen-3: per-head QK-norm).

Weights come from the JAX ``init`` in fp32 with the Qwen leaves redrawn
from a numpy seed (biases ~ 0.5·N(0, 1), norms ~ 1 + 0.2·N(0, 1): the
reference's zero biases and unit norms would hide a misplaced bias or
norm) and cross with ``params_from_numpy``; inputs are numpy arrays from
a seed. The JAX side's decode steps take its masked XLA path
(XSKY_DECODE_ATTN=xla) over fp32 caches, as the Llama parity tests run
it. Tolerances: logits 1e-4 and K/V 2e-5 absolute (two layers of fp32
products summed in another order, as in test_torch_llama.py); loss 1e-5
and gradients 2e-5 absolute (as in test_torch_train.py). The engine,
orchestrator and trainer against the JAX package's are in
test_torch_qwen_serve.py.

Every test here runs under a hard time limit of its own (``_time_limit``).
"""
from __future__ import annotations

import dataclasses
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import qwen as jax_qwen
from skypilot_tpu_torch import models
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.models import qwen

TEST_LIMIT_S = 120
LOGIT_ATOL = 1e-4
KV_ATOL = 2e-5
LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5
NAMES = ('qwen-tiny', 'qwen3-tiny')
QWEN_LEAVES = {'qwen-tiny': ('bq', 'bk', 'bv'),
               'qwen3-tiny': ('q_norm', 'k_norm')}


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


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _leaves(tree, prefix=''):
    """{'/path': leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_leaves(value, f'{prefix}/{key}'))
        return out
    return {prefix: tree}


# ---- the model ----

@pytest.mark.parametrize('name', NAMES)
def test_forward_logits_match_jax(params, name):
    jcfg, tcfg = _configs(name)
    jp, tp = params[name]
    tokens = _tokens(0, 2, 24)
    want = np.asarray(jax_qwen.forward(jcfg, jp, jnp.asarray(tokens)))
    got = qwen.forward(tcfg, tp, torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)


@pytest.mark.parametrize('name', NAMES)
def test_prefill_then_four_decode_steps_match_jax(params, name,
                                                  xla_decode):
    """prefill_hidden of three ragged prompts, its K/V written into an
    fp32 slot cache, then four decode_forward steps; slot 3 is inactive
    (position = max_len), so its writes are dropped on both sides."""
    jcfg, tcfg = _configs(name)
    jp, tp = params[name]
    tokens = _tokens(1, 3, 16)
    true_len = np.array([16, 5, 11], np.int32)
    hid_j, kv_j = jax_qwen.prefill_hidden(jcfg, jp, jnp.asarray(tokens),
                                          jnp.asarray(true_len))
    hid_t, kv_t = qwen.prefill_hidden(tcfg, tp,
                                      torch.from_numpy(tokens).long(),
                                      torch.from_numpy(true_len))
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j),
                               atol=LOGIT_ATOL)
    for key in ('k', 'v'):
        np.testing.assert_allclose(kv_t[key].numpy(), np.asarray(kv_j[key]),
                                   atol=KV_ATOL)
    logits_j = np.asarray(jax_qwen.lm_logits(jcfg, jp, hid_j))
    np.testing.assert_allclose(qwen.lm_logits(tcfg, tp, hid_t).numpy(),
                               logits_j, atol=LOGIT_ATOL)
    b, max_len = 4, 32
    shape = (jcfg.n_layers, b, max_len, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {key: np.zeros(shape, np.float32) for key in ('k', 'v')}
    for key in ('k', 'v'):
        cache[key][:, :3, :16] = np.asarray(kv_j[key])
    cache_j = {key: jnp.asarray(c) for key, c in cache.items()}
    cache_t = {key: torch.from_numpy(c.copy()) for key, c in cache.items()}
    positions = np.array([16, 5, 11, max_len], np.int32)
    next_tokens = np.concatenate([logits_j.argmax(-1), [9]]).astype(
        np.int32)
    for _ in range(4):
        step_j, cache_j = jax_qwen.decode_forward(
            jcfg, jp, jnp.asarray(next_tokens), jnp.asarray(positions),
            cache_j)
        step_t, cache_t = qwen.decode_forward(
            tcfg, tp, torch.from_numpy(next_tokens).long(),
            torch.from_numpy(positions), cache_t)
        np.testing.assert_allclose(step_t.numpy()[:3],
                                   np.asarray(step_j)[:3], atol=LOGIT_ATOL)
        for key in ('k', 'v'):
            np.testing.assert_allclose(cache_t[key].numpy(),
                                       np.asarray(cache_j[key]),
                                       atol=KV_ATOL)
        next_tokens = np.asarray(jnp.argmax(step_j, -1)).astype(np.int32)
        positions = np.where(positions < max_len, positions + 1,
                             positions).astype(np.int32)
    np.testing.assert_array_equal(cache_t['k'][:, 3].numpy(),
                                  cache['k'][:, 3])


@pytest.mark.parametrize('name', NAMES)
def test_verify_forward_matches_jax(params, name):
    """Several tokens a slot into a random fp32 cache, each slot at its
    own offsets (the masked multi-token path on both sides)."""
    jcfg, tcfg = _configs(name)
    jp, tp = params[name]
    rng = np.random.default_rng(2)
    shape = (jcfg.n_layers, 3, 32, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {key: rng.standard_normal(shape).astype(np.float32)
             for key in ('k', 'v')}
    tokens = _tokens(3, 3, 4)
    positions = np.array([[0, 1, 2, 3], [9, 10, 11, 12], [27, 28, 29, 30]],
                         np.int32)
    logits_j, kv_j = jax_qwen.verify_forward(
        jcfg, jp, jnp.asarray(tokens), jnp.asarray(positions),
        {key: jnp.asarray(c) for key, c in cache.items()})
    logits_t, kv_t = qwen.verify_forward(
        tcfg, tp, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions),
        {key: torch.from_numpy(c.copy()) for key, c in cache.items()})
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=LOGIT_ATOL)
    for key in ('k', 'v'):
        np.testing.assert_allclose(kv_t[key].numpy(), np.asarray(kv_j[key]),
                                   atol=KV_ATOL)


LOSS_CASES = {
    'plain': dict(),
    'loss_mask': dict(masked=True),
    'packing': dict(packing_reset_eos=7),
    'longer_than_ce_chunk': dict(ce_chunk=16, masked=True),
}


# Each case once, the two variants in turn (every case compiles the JAX
# gradient anew, the file's largest cost).
@pytest.mark.parametrize('name,case', [
    ('qwen-tiny', 'plain'), ('qwen3-tiny', 'loss_mask'),
    ('qwen-tiny', 'packing'), ('qwen3-tiny', 'longer_than_ce_chunk')])
def test_loss_and_every_gradient_match_jax(params, name, case):
    """loss_fn and the gradient of every leaf, the bias and norm leaves
    included."""
    kw = dict(LOSS_CASES[case])
    masked = kw.pop('masked', False)
    jcfg, tcfg = _configs(name, **kw)
    jp, tp = params[name]
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, (2, 40)).astype(np.int32)
    if 'packing_reset_eos' in kw:
        tokens[rng.random(tokens.shape) < 0.15] = kw['packing_reset_eos']
    targets = np.roll(tokens, -1, axis=1)
    mask = ((rng.random(tokens.shape) < 0.6).astype(np.float32)
            if masked else None)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_qwen.loss_fn(
            jcfg, p, jnp.asarray(tokens), jnp.asarray(targets),
            loss_mask=None if mask is None else jnp.asarray(mask)))(jp)
    tp = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
              if isinstance(v, dict) else v.clone().requires_grad_(True))
          for k, v in tp.items()}
    loss_t = qwen.loss_fn(
        tcfg, tp, torch.from_numpy(tokens).long(),
        torch.from_numpy(targets).long(),
        loss_mask=None if mask is None else torch.from_numpy(mask))
    loss_t.backward()
    assert loss_t.item() == pytest.approx(float(loss_j), abs=LOSS_ATOL)
    want, got = _leaves(grads_j), _leaves(tp)
    assert set(got) == set(want)
    assert {f'/layers/{k}' for k in QWEN_LEAVES[name]} <= set(got)
    for key, grad in want.items():
        np.testing.assert_allclose(got[key].grad.numpy(), np.asarray(grad),
                                   atol=GRAD_ATOL, err_msg=key)


@pytest.mark.parametrize('name', NAMES)
def test_params_from_numpy_round_trip(name):
    """The bf16 JAX tree crosses one to one by name, bit for bit, with
    the shapes and types of the port's own init, which draws from a
    seeded torch.Generator."""
    jcfg = jax_qwen.CONFIGS[name]
    jp = jax_qwen.init(jcfg, jax.random.PRNGKey(1))
    tp = qwen.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                'cpu')
    gen = torch.Generator()
    gen.manual_seed(0)
    own = qwen.init(qwen.CONFIGS[name], gen, device='cpu')
    want, got, mine = _leaves(jp), _leaves(tp), _leaves(own)
    assert set(got) == set(want) == set(mine)
    assert len(want) == 12 + len(QWEN_LEAVES[name])
    for key, leaf in want.items():
        assert got[key].dtype == torch.bfloat16 == mine[key].dtype
        assert tuple(got[key].shape) == leaf.shape == tuple(mine[key].shape)
        np.testing.assert_array_equal(got[key].view(torch.int16).numpy(),
                                      np.asarray(leaf).view(np.int16),
                                      err_msg=key)
    assert sum(t.numel() for t in mine.values()) == \
        qwen.CONFIGS[name].num_params()
    for key in QWEN_LEAVES[name]:
        fill = 0.0 if key.startswith('b') else 1.0
        assert bool((own['layers'][key] == fill).all())
    recast = qwen.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    'cpu', dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in _leaves(recast).values())


def test_configs_and_dispatch_match_jax():
    assert set(qwen.CONFIGS) == set(jax_qwen.CONFIGS)
    for name, tcfg in qwen.CONFIGS.items():
        jcfg = jax_qwen.CONFIGS[name]
        want = {k: v for k, v in dataclasses.asdict(jcfg).items()
                if k != 'dtype'}
        got = {k: v for k, v in dataclasses.asdict(tcfg).items()
               if k != 'dtype'}
        assert got == want, name
        assert tcfg.dtype == torch.bfloat16
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.train_flops_per_token() == jcfg.train_flops_per_token()
        assert models.get_config(name) is tcfg
        assert models.module_for(tcfg) is qwen
    for cfg in (qwen.QWEN_TINY_F32, qwen.QWEN3_TINY_F32):
        assert models.module_for(cfg) is qwen
    # Qwen2-7B's 28 query heads over 4 KV heads: a GQA group of 7.
    assert qwen.QWEN2_7B.n_heads // qwen.QWEN2_7B.n_kv_heads == 7
    assert engine_lib.supports_chunked_prefill(qwen)


def test_paged_cache_is_refused():
    """The reference has no paged hook for Qwen; the engine refuses the
    paged cache as for any family without one."""
    cfg = engine_lib.EngineConfig(model=qwen.QWEN3_TINY_F32, max_slots=2,
                                  max_target_len=64, prefill_buckets=(16,),
                                  kv_page_size=16, kv_dtype=torch.float32)
    params = qwen.init(qwen.QWEN3_TINY_F32, device='cpu')
    with pytest.raises(NotImplementedError,
                       match='qwen has no paged_decode_forward hook'):
        engine_lib.InferenceEngine(cfg, params, device='cpu')
