"""PyTorch port's Gemma family (``models/gemma.py``) vs the JAX reference,
on the CPU: ``gemma-tiny`` (Gemma-1: tied head, (1 + w) norms, GeGLU,
final softcap), ``gemma2-tiny`` (Gemma-2: output norms, attention softcap
50, explicit scale, a window of 8 on even layers) and ``gemma2-tiny-d32``,
a test-local Gemma-2 with head_dim 32 (4 heads x 32 = 128 != d_model 64,
so the head width is decoupled from the model width), defined on both
sides with ``dataclasses.replace``.

Weights come from the JAX ``init`` in fp32 with every norm redrawn from a
numpy seed (0.3·N(0, 1): the reference's zero norms are the identity
under (1 + w) and would hide a misplaced one) and cross with
``params_from_numpy``; inputs are numpy arrays from a seed, and every
sequence is longer than the window of 8. The JAX side's decode steps
take its masked XLA path (XSKY_DECODE_ATTN=xla). Tolerances: logits 1e-4
and K/V 2e-5 absolute (two layers of fp32 products summed in another
order, as in test_torch_qwen.py); over an int8 KV cache, logits 1e-3
and int8 values one step (a row on a rounding edge may quantize to the
neighbouring value); loss 1e-5 and gradients 2e-5 absolute (as in
test_torch_train.py); in bf16 the scaled embedding bit for bit and the
logits 0.1 absolute (bf16 products in another order through two layers;
the logits of this config span about ±30). The engine, orchestrator,
converter and server are in test_torch_gemma_serve.py and
test_torch_convert.py.

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

from skypilot_tpu.models import gemma as jax_gemma
from skypilot_tpu_torch import models
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.models import gemma
from skypilot_tpu_torch.ops import flash_attention as flash_ops
from skypilot_tpu_torch.train import trainer

TEST_LIMIT_S = 120
LOGIT_ATOL = 1e-4
INT8_LOGIT_ATOL = 1e-3
KV_ATOL = 2e-5
LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5
BF16_LOGIT_ATOL = 0.1
NAMES = ('gemma-tiny', 'gemma2-tiny', 'gemma2-tiny-d32')
# The decoupled variant: 4 heads of 32 over d_model 64.
VARIANTS = {'gemma2-tiny-d32': ('gemma2-tiny', dict(head_dim=32))}


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


def _configs(name, dtype=(jnp.float32, torch.float32), **kw):
    base, extra = VARIANTS.get(name, (name, {}))
    kw = {**extra, **kw}
    return (dataclasses.replace(jax_gemma.CONFIGS[base], dtype=dtype[0],
                                **kw),
            dataclasses.replace(gemma.CONFIGS[base], dtype=dtype[1], **kw))


def _jax_tree(name, seed, dtype=jnp.float32, **kw):
    """The JAX init as numpy arrays, every norm redrawn."""
    jcfg, _ = _configs(name, (dtype, torch.float32), **kw)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_gemma.init(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(100 + seed)
    norms = [(tree['layers'], key) for key in tree['layers']
             if key.endswith('_norm')] + [(tree, 'final_norm')]
    for parent, key in norms:
        draw = 0.3 * rng.standard_normal(parent[key].shape)
        parent[key] = draw.astype(parent[key].dtype)
    return tree


@pytest.fixture(scope='module')
def params():
    """{name: (JAX tree, port tree)}: fp32, the same values."""
    out = {}
    for seed, name in enumerate(NAMES):
        tree = _jax_tree(name, seed)
        out[name] = (jax.tree_util.tree_map(jnp.asarray, tree),
                     gemma.params_from_numpy(tree, 'cpu'))
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
    """24 tokens: the even layers of Gemma-2 see only their last 8."""
    jcfg, tcfg = _configs(name)
    jp, tp = params[name]
    tokens = _tokens(0, 2, 24)
    want = np.asarray(jax_gemma.forward(jcfg, jp, jnp.asarray(tokens)))
    got = gemma.forward(tcfg, tp, torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)
    # The final softcap holds the logits inside ±30.
    assert float(got.abs().max()) < 30.0


def _decode_run(name, jp, tp, cache, logit_atol):
    """prefill_hidden of three ragged prompts (16, 5 and 11 tokens), its
    K/V written into ``cache`` ({'k', 'v'}: numpy arrays or (int8,
    scale) pairs), then four decode_forward steps; slot 3 is inactive
    (position = max_len), so its writes are dropped on both sides. Cache
    values within KV_ATOL, int8 values within one step."""
    jcfg, tcfg = _configs(name)
    tokens = _tokens(1, 3, 16)
    true_len = np.array([16, 5, 11], np.int32)
    hid_j, _ = jax_gemma.prefill_hidden(jcfg, jp, jnp.asarray(tokens),
                                        jnp.asarray(true_len))
    logits_j = np.asarray(jax_gemma.lm_logits(jcfg, jp, hid_j))
    cache_j = jax.tree_util.tree_map(jnp.asarray, cache)
    cache_t = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                     cache)
    max_len = 32
    positions = np.array([16, 5, 11, max_len], np.int32)
    next_tokens = np.concatenate([logits_j.argmax(-1), [9]]).astype(
        np.int32)
    for _ in range(4):
        step_j, cache_j = jax_gemma.decode_forward(
            jcfg, jp, jnp.asarray(next_tokens), jnp.asarray(positions),
            cache_j)
        step_t, cache_t = gemma.decode_forward(
            tcfg, tp, torch.from_numpy(next_tokens).long(),
            torch.from_numpy(positions), cache_t)
        np.testing.assert_allclose(step_t.numpy()[:3],
                                   np.asarray(step_j)[:3], atol=logit_atol)
        flat_j = jax.tree_util.tree_leaves(cache_j)
        flat_t = jax.tree_util.tree_leaves(cache_t)
        for got, want in zip(flat_t, flat_j):
            np.testing.assert_allclose(
                got.numpy().astype(np.float32),
                np.asarray(want).astype(np.float32),
                atol=1 if got.dtype == torch.int8 else KV_ATOL)
        next_tokens = np.asarray(jnp.argmax(step_j, -1)).astype(np.int32)
        positions = np.where(positions < max_len, positions + 1,
                             positions).astype(np.int32)
    return cache_t


@pytest.mark.parametrize('name', NAMES)
def test_prefill_then_four_decode_steps_match_jax(params, name,
                                                  xla_decode):
    """The prefill's last hidden, K/V and logits, then four decode steps
    over an fp32 slot cache (positions 16-19 of slot 0 lie past the
    window of 8 on the even layers)."""
    jcfg, tcfg = _configs(name)
    jp, tp = params[name]
    tokens = _tokens(1, 3, 16)
    true_len = np.array([16, 5, 11], np.int32)
    hid_j, kv_j = jax_gemma.prefill_hidden(jcfg, jp, jnp.asarray(tokens),
                                           jnp.asarray(true_len))
    hid_t, kv_t = gemma.prefill_hidden(tcfg, tp,
                                       torch.from_numpy(tokens).long(),
                                       torch.from_numpy(true_len))
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j),
                               atol=LOGIT_ATOL)
    for key in ('k', 'v'):
        np.testing.assert_allclose(kv_t[key].numpy(), np.asarray(kv_j[key]),
                                   atol=KV_ATOL)
    np.testing.assert_allclose(
        gemma.lm_logits(tcfg, tp, hid_t).numpy(),
        np.asarray(jax_gemma.lm_logits(jcfg, jp, hid_j)), atol=LOGIT_ATOL)
    shape = (jcfg.n_layers, 4, 32, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {key: np.zeros(shape, np.float32) for key in ('k', 'v')}
    for key in ('k', 'v'):
        cache[key][:, :3, :16] = np.asarray(kv_j[key])
    cache_t = _decode_run(name, jp, tp, cache, LOGIT_ATOL)
    np.testing.assert_array_equal(cache_t['k'][:, 3].numpy(),
                                  cache['k'][:, 3])


@pytest.mark.parametrize('name', ('gemma-tiny', 'gemma2-tiny'))
def test_decode_over_an_int8_cache_matches_jax(params, name, xla_decode):
    """The same four decode steps over an int8 KV cache: (int8 values,
    fp32 scale) pairs filled with the prefill's rows, quantized by the
    JAX helper, and each step's new rows quantized on each side."""
    from skypilot_tpu.models import llama as jax_llama
    jcfg, _ = _configs(name)
    jp, tp = params[name]
    tokens = _tokens(1, 3, 16)
    _, kv_j = jax_gemma.prefill_hidden(jcfg, jp, jnp.asarray(tokens),
                                       jnp.asarray(np.array([16, 5, 11],
                                                            np.int32)))
    shape = (jcfg.n_layers, 4, 32, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {}
    for key in ('k', 'v'):
        rows = np.zeros(shape, np.float32)
        rows[:, :3, :16] = np.asarray(kv_j[key])
        q, scale = jax_llama.quantize_kv(jnp.asarray(rows))
        cache[key] = (np.asarray(q), np.asarray(scale))
    cache_t = _decode_run(name, jp, tp, cache, INT8_LOGIT_ATOL)
    assert cache_t['k'][0].dtype == torch.int8


@pytest.mark.parametrize('name', NAMES)
def test_verify_forward_matches_jax(params, name):
    """Several tokens a slot into a random fp32 cache, each slot at its
    own offsets (the masked multi-token path on both sides, the window
    cutting rows on the even layers)."""
    jcfg, tcfg = _configs(name)
    jp, tp = params[name]
    rng = np.random.default_rng(2)
    shape = (jcfg.n_layers, 3, 32, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {key: rng.standard_normal(shape).astype(np.float32)
             for key in ('k', 'v')}
    tokens = _tokens(3, 3, 4)
    positions = np.array([[0, 1, 2, 3], [9, 10, 11, 12], [27, 28, 29, 30]],
                         np.int32)
    logits_j, kv_j = jax_gemma.verify_forward(
        jcfg, jp, jnp.asarray(tokens), jnp.asarray(positions),
        {key: jnp.asarray(c) for key, c in cache.items()})
    logits_t, kv_t = gemma.verify_forward(
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
}


# Each case once, the variants in turn (every case computes the JAX
# gradient anew, the file's largest cost).
@pytest.mark.parametrize('name,case', [
    ('gemma-tiny', 'plain'), ('gemma2-tiny', 'loss_mask'),
    ('gemma2-tiny-d32', 'packing')])
def test_loss_and_every_gradient_match_jax(params, name, case):
    """loss_fn and the gradient of every leaf (the tied embedding takes
    both the gather's and the head's), 40 tokens a row."""
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
        lambda p: jax_gemma.loss_fn(
            jcfg, p, jnp.asarray(tokens), jnp.asarray(targets),
            loss_mask=None if mask is None else jnp.asarray(mask)))(jp)
    tp = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
              if isinstance(v, dict) else v.clone().requires_grad_(True))
          for k, v in tp.items()}
    loss_t = gemma.loss_fn(
        tcfg, tp, torch.from_numpy(tokens).long(),
        torch.from_numpy(targets).long(),
        loss_mask=None if mask is None else torch.from_numpy(mask))
    loss_t.backward()
    assert loss_t.item() == pytest.approx(float(loss_j), abs=LOSS_ATOL)
    want, got = _leaves(grads_j), _leaves(tp)
    assert set(got) == set(want)
    for key, grad in want.items():
        np.testing.assert_allclose(got[key].grad.numpy(), np.asarray(grad),
                                   atol=GRAD_ATOL, err_msg=key)


def test_bf16_embedding_normalizer_is_rounded_first():
    """At Gemma2-9B's d_model (3584) the normalizer sqrt(3584) = 59.87
    rounds to 60.0 in bf16 before the multiply, as the reference's
    jnp.asarray(d_model ** 0.5, dtype) does: the port's scaled embedding
    equals the reference's expression bit for bit (and the unrounded
    normalizer would not), and a bf16 forward at that width gives the
    reference's logits within BF16_LOGIT_ATOL."""
    kw = dict(d_model=3584, head_dim=32)
    jcfg, tcfg = _configs('gemma2-tiny', (jnp.bfloat16, torch.bfloat16),
                          **kw)
    tree = _jax_tree('gemma2-tiny', 5, dtype=jnp.bfloat16, **kw)
    tp = gemma.params_from_numpy(tree, 'cpu')
    tokens = _tokens(6, 2, 24)
    table = jnp.asarray(tree['embed'])
    want = np.asarray((table[jnp.asarray(tokens)].astype(jnp.bfloat16) *
                       jnp.asarray(3584 ** 0.5, jnp.bfloat16)
                       ).astype(jnp.float32))
    got = gemma._embed(tcfg, tp, torch.from_numpy(tokens).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    unrounded = (tp['embed'][torch.from_numpy(tokens).long()].float() *
                 3584 ** 0.5).to(torch.bfloat16)
    assert not torch.equal(unrounded, got)
    logits_j = jax_gemma.forward(jcfg, jax.tree_util.tree_map(
        jnp.asarray, tree), jnp.asarray(tokens))
    logits_t = gemma.forward(tcfg, tp, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=BF16_LOGIT_ATOL)


@pytest.mark.parametrize('name', ('gemma-tiny', 'gemma2-tiny'))
def test_params_from_numpy_round_trip(name):
    """The bf16 JAX tree crosses one to one by name, bit for bit, with
    the shapes and types of the port's own init, which draws from a
    seeded torch.Generator and zeroes every norm, as the reference."""
    jcfg = jax_gemma.CONFIGS[name]
    jp = jax_gemma.init(jcfg, jax.random.PRNGKey(1))
    tp = gemma.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 'cpu')
    gen = torch.Generator()
    gen.manual_seed(0)
    own = gemma.init(gemma.CONFIGS[name], gen, device='cpu')
    want, got, mine = _leaves(jp), _leaves(tp), _leaves(own)
    assert set(got) == set(want) == set(mine)
    assert len(want) == (13 if jcfg.gemma2 else 11)
    assert '/lm_head' not in mine
    for key, leaf in want.items():
        assert got[key].dtype == torch.bfloat16 == mine[key].dtype
        assert tuple(got[key].shape) == leaf.shape == tuple(mine[key].shape)
        np.testing.assert_array_equal(got[key].view(torch.int16).numpy(),
                                      np.asarray(leaf).view(np.int16),
                                      err_msg=key)
        if key.endswith('_norm'):
            assert bool((mine[key] == 0).all())
    assert sum(t.numel() for t in mine.values()) == \
        gemma.CONFIGS[name].num_params()


def test_configs_and_dispatch_match_jax():
    assert set(gemma.CONFIGS) == set(jax_gemma.CONFIGS)
    for name, tcfg in gemma.CONFIGS.items():
        jcfg = jax_gemma.CONFIGS[name]
        want = {k: v for k, v in dataclasses.asdict(jcfg).items()
                if k != 'dtype'}
        got = {k: v for k, v in dataclasses.asdict(tcfg).items()
               if k != 'dtype'}
        assert got == want, name
        assert tcfg.dtype == torch.bfloat16
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.train_flops_per_token() == jcfg.train_flops_per_token()
        assert models.get_config(name) is tcfg
        assert models.module_for(tcfg) is gemma
    for cfg in (gemma.GEMMA_TINY_F32, gemma.GEMMA2_TINY_F32):
        assert models.module_for(cfg) is gemma
    # Every public Gemma has head_dim 256, and Gemma2-9B's heads are
    # decoupled from its width (16 x 256 != 3584).
    assert {c.head_dim for n, c in gemma.CONFIGS.items()
            if 'tiny' not in n} == {256}
    nine = gemma.GEMMA2_9B
    assert nine.n_heads * nine.head_dim != nine.d_model
    assert round(nine.num_params() / 1e9, 2) == 9.24
    assert engine_lib.supports_chunked_prefill(gemma)
    with pytest.raises(ValueError, match='even n_layers'):
        dataclasses.replace(gemma.GEMMA2_TINY, n_layers=3)


@pytest.mark.parametrize('name', ('gemma-tiny', 'gemma2-tiny'))
def test_paged_cache_is_refused_as_in_the_reference(name):
    """The reference has no paged hook for Gemma; Gemma-2's window is
    refused first, with the reference's message."""
    cfg = engine_lib.EngineConfig(model=gemma.CONFIGS[name], max_slots=2,
                                  max_target_len=64, prefill_buckets=(16,),
                                  kv_page_size=16, kv_dtype=torch.float32)
    params = gemma.init(gemma.CONFIGS[name], device='cpu')
    match = ('sliding_window is not supported with the paged cache'
             if 'gemma2' in name else 'gemma has no paged_decode_forward')
    with pytest.raises(NotImplementedError, match=match):
        engine_lib.InferenceEngine(cfg, params, device='cpu')


# ---- the trainer's refusal on the card ----

def test_trainer_refuses_gemma_on_the_card_and_trains_it_on_the_cpu(
        monkeypatch):
    """On a CUDA device a config whose head_dim the flash backward does
    not take (every Gemma: 256) is refused, naming the ROADMAP item; on
    the CPU the same config builds (the plain backward takes any
    width). The device check is monkeypatched: there is no card here."""
    cfg = trainer.TrainConfig(model=gemma.GEMMA2_2B, global_batch_size=1,
                              seq_len=16)
    monkeypatch.setattr(trainer, 'resolve_device',
                        lambda device: torch.device('cuda', 0))
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    with pytest.raises(NotImplementedError,
                       match=r'Gemma training \(K2/K3 at D 256\)'):
        trainer.Trainer(cfg)
    monkeypatch.undo()
    assert trainer.Trainer(cfg, device='cpu').device.type == 'cpu'


def test_flash_backward_wrappers_refuse_head_dim_256():
    """The forward takes D 256, the backward does not yet: its wrappers
    raise before any launch, naming the ROADMAP item (a stand-in with a
    CUDA tensor's shape and flag: there is no card here, and the check
    reads nothing else)."""
    assert 256 in flash_ops.FWD_HEAD_DIMS
    assert 256 not in flash_ops.BWD_HEAD_DIMS

    class _Cuda:
        is_cuda = True
        shape = torch.Size((1, 8, 2, 256))

    for launch in (flash_ops._flash_bwd, flash_ops._flash_bwd_dq,
                   flash_ops._flash_bwd_dkv):
        with pytest.raises(ValueError,
                           match=r'Gemma training \(K2/K3 at D 256\)'):
            launch(_Cuda(), None, None, None, None, None, None)
