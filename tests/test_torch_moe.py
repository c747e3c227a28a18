"""PyTorch port's Mixtral family (``models/moe.py``) vs the JAX reference,
on the CPU, at fp32 ``moe-tiny`` (4 experts, 2 a token).

Weights come from the JAX ``init`` in fp32 with the norm scales redrawn
from a numpy seed (1 + 0.2·N(0, 1): unit norms would hide a misplaced
norm) and cross with ``params_from_numpy``; inputs are numpy arrays from
a seed. The JAX side's decode steps take its masked XLA path
(XSKY_DECODE_ATTN=xla) over fp32 caches, as the Llama parity tests run
it. Tolerances: logits and hidden states 1e-4, K/V 2e-5 absolute (two
layers of fp32 products summed in another order, as in
test_torch_llama.py); quantized trees and the born-quantized build bit
for bit; greedy tokens identical. The engine, the orchestrator and the
replica against the JAX package's are in test_torch_moe_serve.py.

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
from torch.utils._python_dispatch import TorchDispatchMode

from skypilot_tpu.models import moe as jax_moe
from skypilot_tpu.ops import quantization as jq
from skypilot_tpu_torch import models
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import quantization as qops
from skypilot_tpu_torch.train import trainer

TEST_LIMIT_S = 120
LOGIT_ATOL = 1e-4
KV_ATOL = 2e-5


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


def _configs(**kw):
    return (dataclasses.replace(jax_moe.MOE_TINY, dtype=jnp.float32, **kw),
            dataclasses.replace(moe.MOE_TINY_F32, **kw))


@pytest.fixture(scope='module')
def params():
    """(JAX tree, port tree): fp32, the same values."""
    jcfg, _ = _configs()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_moe.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(100)
    for key in ('attn_norm', 'mlp_norm'):
        shape = tree['layers'][key].shape
        tree['layers'][key] = (
            1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            moe.params_from_numpy(tree, 'cpu'))


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


def _bits(leaf):
    """The arrays of a leaf (a quantized leaf's values and scales), as
    numpy, for bit-for-bit comparisons across the two packages."""
    if hasattr(leaf, 'scale'):
        values = leaf.q_packed if hasattr(leaf, 'q_packed') else leaf.q
        return [np.asarray(values), np.asarray(leaf.scale).view(np.int32)]
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return [leaf.view(torch.int16).numpy()]
        return [leaf.numpy().view(np.int32)]
    leaf = np.asarray(leaf)
    return [leaf.view(np.int16 if leaf.dtype.itemsize == 2 else np.int32)]


def _assert_same_bits(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert type(got[key]).__name__ == type(leaf).__name__ or (
            torch.is_tensor(got[key]) and not hasattr(leaf, 'scale')), key
        for a, b in zip(_bits(got[key]), _bits(leaf), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=key)


# ---- the model ----

@pytest.mark.parametrize('masked', [False, True], ids=['plain', 'token_mask'])
def test_forward_logits_match_jax(params, masked):
    """forward at 2 x 24 tokens (capacity from 48 tokens, so experts
    overflow and drop as the reference's do); with a token mask the
    masked positions take no capacity on either side."""
    jcfg, tcfg = _configs()
    jp, tp = params
    tokens = _tokens(0, 2, 24)
    mask = (np.arange(24)[None, :] < np.array([[24], [13]])).astype(
        np.float32) if masked else None
    want = np.asarray(jax_moe.forward(
        jcfg, jp, jnp.asarray(tokens),
        token_mask=None if mask is None else jnp.asarray(mask)))
    got = moe.forward(tcfg, tp, torch.from_numpy(tokens).long(),
                      token_mask=None if mask is None
                      else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)


def test_prefill_then_four_decode_steps_match_jax(params, xla_decode):
    """prefill_hidden of three ragged prompts (pads masked out of
    routing), its K/V written into an fp32 slot cache, then four
    decode_forward steps (capacity = slots, the inactive slot routed
    too); slot 3 is inactive (position = max_len), so its writes are
    dropped on both sides."""
    jcfg, tcfg = _configs()
    jp, tp = params
    tokens = _tokens(1, 3, 16)
    true_len = np.array([16, 5, 11], np.int32)
    hid_j, kv_j = jax_moe.prefill_hidden(jcfg, jp, jnp.asarray(tokens),
                                         jnp.asarray(true_len))
    hid_t, kv_t = moe.prefill_hidden(tcfg, tp,
                                     torch.from_numpy(tokens).long(),
                                     torch.from_numpy(true_len))
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j),
                               atol=LOGIT_ATOL)
    for key in ('k', 'v'):
        np.testing.assert_allclose(kv_t[key].numpy(), np.asarray(kv_j[key]),
                                   atol=KV_ATOL)
    logits_j = np.asarray(jax_moe.lm_logits(jcfg, jp, hid_j))
    np.testing.assert_allclose(moe.lm_logits(tcfg, tp, hid_t).numpy(),
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
        step_j, cache_j = jax_moe.decode_forward(
            jcfg, jp, jnp.asarray(next_tokens), jnp.asarray(positions),
            cache_j)
        step_t, cache_t = moe.decode_forward(
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


def test_verify_forward_matches_jax(params):
    """Several tokens a slot into a random fp32 cache, each slot at its
    own offsets, routed with capacity b * s (the masked multi-token path
    on both sides)."""
    jcfg, tcfg = _configs()
    jp, tp = params
    rng = np.random.default_rng(2)
    shape = (jcfg.n_layers, 3, 32, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {key: rng.standard_normal(shape).astype(np.float32)
             for key in ('k', 'v')}
    tokens = _tokens(3, 3, 4)
    positions = np.array([[0, 1, 2, 3], [9, 10, 11, 12], [27, 28, 29, 30]],
                         np.int32)
    logits_j, kv_j = jax_moe.verify_forward(
        jcfg, jp, jnp.asarray(tokens), jnp.asarray(positions),
        {key: jnp.asarray(c) for key, c in cache.items()})
    logits_t, kv_t = moe.verify_forward(
        tcfg, tp, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions),
        {key: torch.from_numpy(c.copy()) for key, c in cache.items()})
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=LOGIT_ATOL)
    for key in ('k', 'v'):
        np.testing.assert_allclose(kv_t[key].numpy(), np.asarray(kv_j[key]),
                                   atol=KV_ATOL)


def test_sliding_window_is_ignored_as_in_the_reference(params, xla_decode):
    """The reference's Mixtral attention takes no window, though
    MoEConfig inherits sliding_window (a converted checkpoint fills it).
    At sliding_window=8 and 24 tokens the port's forward and decode equal
    the reference's and its own without a window, bit for bit; Llama's
    attention, which honours the window, gives other outputs at this
    length."""
    jcfg, tcfg = _configs(sliding_window=8)
    _, plain = _configs()
    jp, tp = params
    tokens = _tokens(4, 2, 24)
    want = np.asarray(jax_moe.forward(jcfg, jp, jnp.asarray(tokens)))
    got = moe.forward(tcfg, tp, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)
    assert torch.equal(got, moe.forward(plain, tp,
                                        torch.from_numpy(tokens).long()))
    # A decode step at position 20, past the window, over a random cache.
    rng = np.random.default_rng(5)
    shape = (jcfg.n_layers, 2, 32, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {key: rng.standard_normal(shape).astype(np.float32)
             for key in ('k', 'v')}
    pos = np.array([20, 23], np.int32)
    step_j, _ = jax_moe.decode_forward(
        jcfg, jp, jnp.asarray(tokens[:, 0]), jnp.asarray(pos),
        {key: jnp.asarray(c) for key, c in cache.items()})
    steps = [moe.decode_forward(
        cfg, tp, torch.from_numpy(tokens[:, 0]).long(),
        torch.from_numpy(pos),
        {key: torch.from_numpy(c.copy()) for key, c in cache.items()})[0]
        for cfg in (tcfg, plain)]
    np.testing.assert_allclose(steps[0].numpy(), np.asarray(step_j),
                               atol=LOGIT_ATOL)
    assert torch.equal(steps[0], steps[1])
    # What the window would change: Llama's windowed attention on the
    # same queries and keys differs from the causal one past row 8.
    q = torch.from_numpy(rng.standard_normal((1, 24, 4, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 24, 2, 16)).astype(
        np.float32))
    causal = attention_ops.dot_product_attention(q, k, k, causal=True)
    windowed = attention_ops.dot_product_attention(q, k, k, causal=True,
                                                   window=8)
    assert torch.equal(causal[:, :8], windowed[:, :8])
    assert not torch.allclose(causal[:, 8:], windowed[:, 8:], atol=1e-3)


def test_cached_decode_matches_full_forward():
    """The port's counterpart of the reference's
    test_moe_cached_decode_matches_full_forward: with a capacity factor
    that admits every assignment, the engine's slot-cache decode of
    bf16 moe-tiny gives the greedy tokens of full re-forwards."""
    c = dataclasses.replace(moe.MOE_TINY,
                            capacity_factor=float(moe.MOE_TINY.n_experts))
    weights = moe.init(c, device='cpu')
    engine = engine_lib.InferenceEngine(engine_lib.EngineConfig(
        model=c, max_slots=2, max_target_len=32, prefill_buckets=(16,)),
        weights, device='cpu')
    prompt = [5, 17, 3, 99, 42]
    tokens = list(prompt)
    for _ in range(6):
        logits = moe.forward(c, weights, torch.tensor([tokens]))
        tokens.append(int(logits[0, -1].argmax()))
    orch = orch_lib.Orchestrator(engine)
    request = orch.submit(orch_lib.Request(prompt_tokens=prompt,
                                           max_new_tokens=6))
    orch.run_until_drained(max_steps=32)
    assert request.output_tokens == tokens[len(prompt):]


# ---- weights ----

@pytest.mark.parametrize('bits', [8, 4])
def test_quantized_trees_equal_jax(bits):
    """quantize_params / quantize_params_int4 of the carried bf16 tree give
    the reference's bytes (the router and the norms stay as they are, the
    expert stacks [L, E, in, out] take per-(expert, output channel)
    scales), and the reference's quantized tree crosses unchanged."""
    jp = jax_moe.init(jax_moe.MOE_TINY, jax.random.PRNGKey(1))
    tp = moe.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               'cpu')
    jfn = jq.quantize_params if bits == 8 else jq.quantize_params_int4
    tfn = qops.quantize_params if bits == 8 else qops.quantize_params_int4
    want = jfn(jp)
    got = tfn(tp)
    _assert_same_bits(got, want)
    carried = moe.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, want), 'cpu')
    _assert_same_bits(carried, want)
    assert got['layers']['router'].dtype == torch.float32
    assert qops.is_quantized(got['layers']['w_gate'])
    assert qops.params_nbytes(got) == jq.params_nbytes(want)


class _LargestFloat(TorchDispatchMode):
    """Records the largest floating-point tensor any op makes."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if torch.is_tensor(t) and t.is_floating_point():
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize('name', ['moe-tiny', 'tiny', 'deepseek-tiny'])
@pytest.mark.parametrize('weight_dtype', [torch.int8, 'int4'],
                         ids=['int8', 'int4'])
def test_born_quantized_init_equals_quantize_params_of_init(name,
                                                            weight_dtype):
    """init(weight_dtype=...) — what the server builds — gives the bytes
    of quantize_params(init(...)) (Llama's and DeepSeek's replicas as
    before), and no floating-point tensor it makes is larger than one
    layer of the largest stack: a quantized stack is drawn and quantized
    a layer at a time, never whole in full precision."""
    cfg = models.get_config(name)
    lib = models.module_for(cfg)
    fn = (qops.quantize_params if weight_dtype == torch.int8
          else qops.quantize_params_int4)
    want = fn(lib.init(cfg, device='cpu'))
    with _LargestFloat() as seen:
        got = lib.init(cfg, device='cpu', weight_dtype=weight_dtype)
    _assert_same_bits(got, want)
    shapes = _leaves(lib.init(cfg, device='meta'))
    one_layer = max(int(np.prod(s.shape[1:])) for key, s in shapes.items()
                    if '_layers/' in key or key.startswith('/layers/'))
    unstacked = max(int(np.prod(s.shape)) for key, s in shapes.items()
                    if key in ('/embed', '/lm_head'))
    assert seen.largest <= max(one_layer, unstacked)
    if name == 'moe-tiny':
        stack = shapes['/layers/w_gate']
        assert seen.largest < int(np.prod(stack.shape))


def test_params_from_numpy_round_trip():
    """The bf16 JAX tree crosses one to one by name, bit for bit (the
    router fp32), with the shapes and types of the port's own init."""
    jp = jax_moe.init(jax_moe.MOE_TINY, jax.random.PRNGKey(1))
    tp = moe.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               'cpu')
    own = moe.init(moe.MOE_TINY, device='cpu')
    want, got, mine = _leaves(jp), _leaves(tp), _leaves(own)
    assert set(got) == set(want) == set(mine)
    for key, leaf in want.items():
        assert got[key].dtype == mine[key].dtype
        assert tuple(got[key].shape) == leaf.shape == tuple(mine[key].shape)
        for a, b in zip(_bits(got[key]), _bits(leaf)):
            np.testing.assert_array_equal(a, b, err_msg=key)
    assert mine['/layers/router'].dtype == torch.float32
    assert mine['/layers/w_gate'].dtype == torch.bfloat16
    assert sum(t.numel() for t in mine.values()) == \
        moe.MOE_TINY.num_params()
    recast = moe.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   'cpu', dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in _leaves(recast).values())


def test_configs_and_dispatch_match_jax():
    """The same named configs, fields and counts as the reference;
    MoEConfig dispatches to moe although it subclasses LlamaConfig."""
    assert set(moe.CONFIGS) == set(jax_moe.CONFIGS)
    for name, tcfg in moe.CONFIGS.items():
        jcfg = jax_moe.CONFIGS[name]
        want = {k: v for k, v in dataclasses.asdict(jcfg).items()
                if k != 'dtype'}
        got = {k: v for k, v in dataclasses.asdict(tcfg).items()
               if k != 'dtype'}
        assert got == want, name
        assert tcfg.dtype == torch.bfloat16
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.active_params() == jcfg.active_params()
        assert tcfg.train_flops_per_token() == jcfg.train_flops_per_token()
        assert models.get_config(name) is tcfg
        assert models.module_for(tcfg) is moe
    assert isinstance(moe.MIXTRAL_8X7B, llama.LlamaConfig)
    assert models.module_for(moe.MOE_TINY_F32) is moe
    assert models.module_for(llama.MISTRAL_7B) is llama
    # Mixtral-8x7B: 46.70 B parameters, 93.4 GB in bf16.
    assert round(moe.MIXTRAL_8X7B.num_params() / 1e9, 2) == 46.70
    assert engine_lib.supports_chunked_prefill(moe)


def test_training_and_the_paged_cache_are_refused():
    """Training is no longer refused (item 6.4 is done): forward's
    return_aux, loss_fn and so the Trainer's step run (their values
    against the reference are in test_torch_moe_train.py); the reference
    has no paged hook for this family, and the engine still refuses the
    paged cache as for any family without one."""
    cfg = moe.MOE_TINY_F32
    weights = moe.init(cfg, device='cpu')
    tokens = torch.zeros((1, 8), dtype=torch.long)
    logits, aux = moe.forward(cfg, weights, tokens, return_aux=True)
    assert logits.shape == (1, 8, cfg.vocab_size) and aux.ndim == 0
    assert torch.isfinite(moe.loss_fn(cfg, weights, tokens, tokens))
    tr = trainer.Trainer(trainer.TrainConfig(model=cfg, global_batch_size=1,
                                             seq_len=8), device='cpu')
    _, metrics = tr.step(tr.init_state(weights), {'tokens': tokens,
                                                  'targets': tokens})
    assert metrics['step'] == 1 and torch.isfinite(metrics['loss'])
    with pytest.raises(NotImplementedError,
                       match='moe has no paged_decode_forward hook'):
        engine_lib.InferenceEngine(engine_lib.EngineConfig(
            model=cfg, max_slots=2, max_target_len=64,
            prefill_buckets=(16,), kv_page_size=16,
            kv_dtype=torch.float32), weights, device='cpu')
