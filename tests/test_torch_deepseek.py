"""PyTorch port's DeepSeek family (MLA + DeepSeekMoE) vs the JAX
reference, on the CPU.

fp32 variants of the tiny configs (``deepseek-tiny``: q_lora, one dense
layer then MoE; ``deepseek-tiny-moe-only``: full-rank q, MoE only), with
the JAX ``init`` tree carried across. Inputs come from numpy seeds. The
JAX side takes its masked XLA decode branch (XSKY_DECODE_ATTN=xla), which
its own tests hold equal to its MLA kernel, to stay fast; the port's
decode wrappers take their plain versions, which
``tests/test_torch_mla.py`` holds against the JAX kernels. Tolerances:
1e-4 on logits (fp32 through a few layers in another summation order),
1e-5 on hidden states and caches; greedy tokens, page tables and routing
drops must be identical.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import orchestrator as jax_orch
from skypilot_tpu.models import deepseek as jax_deepseek
from skypilot_tpu_torch import models
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.models import deepseek
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe

LOGITS_ATOL = 1e-4
STATE_ATOL = 1e-5
NAMES = ('deepseek-tiny', 'deepseek-tiny-moe-only')
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(0, 256, n)]
           for i, n in enumerate((3, 5, 12, 9, 14, 7))]


def _configs(name, **kw):
    return (dataclasses.replace(jax_deepseek.CONFIGS[name],
                                dtype=jnp.float32, **kw),
            dataclasses.replace(deepseek.CONFIGS[name], dtype=torch.float32,
                                **kw))


@pytest.fixture(scope='module')
def params():
    out = {}
    for name in NAMES:
        jc, _ = _configs(name)
        jp = jax_deepseek.init(jc, jax.random.PRNGKey(0))
        out[name] = (jp, deepseek.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), 'cpu'))
    return out


@pytest.fixture
def xla_decode(monkeypatch):
    monkeypatch.setenv('XSKY_DECODE_ATTN', 'xla')


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


# ---- (1) parameters and configs ----

def test_params_from_numpy_and_init_match_the_jax_tree(params):
    jp, tp = params['deepseek-tiny']
    assert _shapes(tp) == _shapes(jax.tree_util.tree_map(np.asarray, jp))
    bf16 = deepseek.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), 'cpu', dtype=torch.bfloat16)
    assert bf16['moe_layers']['router'].dtype == torch.float32
    assert bf16['moe_layers']['w_gate'].dtype == torch.bfloat16
    init = deepseek.init(deepseek.DEEPSEEK_TINY, device='cpu')
    assert _shapes(init) == _shapes(tp)
    assert init['moe_layers']['router'].dtype == torch.float32
    assert init['dense_layers']['wo'].dtype == torch.bfloat16
    assert bool((init['moe_layers']['kv_norm'] == 1).all())
    lite = deepseek.DEEPSEEK_V2_LITE
    assert lite.num_params() == jax_deepseek.DEEPSEEK_V2_LITE.num_params()
    assert models.module_for(lite) is deepseek
    assert models.module_for(llama.LLAMA_TINY) is llama
    assert models.get_config('deepseek-v2-lite') is lite
    assert models.get_config('tiny') is llama.LLAMA_TINY
    with pytest.raises(KeyError, match='deepseek-tiny'):
        models.get_config('no-such-model')


# ---- (2) model level ----

@pytest.mark.parametrize('name', NAMES)
def test_forward_and_prefill_hidden_match_jax(params, name):
    jc, tc = _configs(name)
    jp, tp = params[name]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (3, 16)).astype(np.int32)
    want = np.asarray(jax_deepseek.forward(jc, jp, jnp.asarray(tokens)))
    got = deepseek.forward(tc, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_ATOL, rtol=0)
    true_len = np.array([16, 5, 11], np.int32)
    jh, jkv = jax_deepseek.prefill_hidden(jc, jp, jnp.asarray(tokens),
                                          jnp.asarray(true_len))
    th, tkv = deepseek.prefill_hidden(tc, tp, torch.from_numpy(tokens),
                                      torch.from_numpy(true_len))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=STATE_ATOL)
    for key in ('k', 'v'):
        assert tuple(tkv[key].shape) == jkv[key].shape
        np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                   atol=STATE_ATOL)


@pytest.mark.parametrize('name', NAMES)
def test_decode_forward_matches_jax(params, xla_decode, name):
    """Two steps over random slot caches; slot 2 is inactive (position at
    the cache length: its write is dropped)."""
    jc, tc = _configs(name)
    jp, tp = params[name]
    slots, cap = 4, 24
    rng = np.random.default_rng(2)
    shapes = deepseek.kv_cache_shapes(tc, slots, cap)
    cache = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    positions = np.array([3, 17, cap, 0], np.int32)
    tokens = rng.integers(0, 256, slots).astype(np.int32)
    jkv = {'k': jnp.asarray(cache[0]), 'v': jnp.asarray(cache[1])}
    tkv = {'k': torch.from_numpy(cache[0].copy()),
           'v': torch.from_numpy(cache[1].copy())}
    live = [0, 1, 3]
    for _ in range(2):
        jlogits, jkv = jax_deepseek.decode_forward(
            jc, jp, jnp.asarray(tokens), jnp.asarray(positions), jkv)
        tlogits, tkv = deepseek.decode_forward(
            tc, tp, torch.from_numpy(tokens), torch.from_numpy(positions),
            tkv)
        np.testing.assert_allclose(tlogits.numpy()[live],
                                   np.asarray(jlogits)[live],
                                   atol=LOGITS_ATOL, rtol=0)
        for key in ('k', 'v'):
            np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                       atol=STATE_ATOL)
        positions = positions + np.array([1, 1, 0, 1], np.int32)
        tokens = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


def test_paged_decode_forward_matches_jax(params, xla_decode):
    """Two steps over permuted tables with sentinel tails and an inactive
    slot (position past the table): logits of live slots, and the arenas'
    pages [0, P) (the port's spare page P takes the dropped writes)."""
    name = 'deepseek-tiny'
    jc, tc = _configs(name)
    jp, tp = params[name]
    slots, num_pages, page, nblk = 4, 12, 8, 4
    rng = np.random.default_rng(3)
    shapes = deepseek.paged_kv_cache_shapes(tc, num_pages, page)
    arena = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tables = np.full((slots, nblk), num_pages, np.int32)
    perm = rng.permutation(num_pages)
    tables[0, :3], tables[1, :2], tables[3, :4] = (perm[:3], perm[3:5],
                                                   perm[5:9])
    positions = np.array([17, 8, nblk * page, 30], np.int32)
    tokens = rng.integers(0, 256, slots).astype(np.int32)
    jkv = {'k': jnp.asarray(arena[0]), 'v': jnp.asarray(arena[1])}
    tkv = {key: torch.from_numpy(np.concatenate(
        [a, np.zeros_like(a[:, :1])], axis=1))
        for key, a in zip(('k', 'v'), arena)}
    live = [0, 1, 3]
    for _ in range(2):
        jlogits, jkv = jax_deepseek.paged_decode_forward(
            jc, jp, jnp.asarray(tokens), jnp.asarray(positions), jkv,
            jnp.asarray(tables))
        tlogits, tkv = deepseek.paged_decode_forward(
            tc, tp, torch.from_numpy(tokens), torch.from_numpy(positions),
            tkv, torch.from_numpy(tables))
        np.testing.assert_allclose(tlogits.numpy()[live],
                                   np.asarray(jlogits)[live],
                                   atol=LOGITS_ATOL, rtol=0)
        for key in ('k', 'v'):
            np.testing.assert_allclose(tkv[key][:, :num_pages].numpy(),
                                       np.asarray(jkv[key]), atol=STATE_ATOL)
        positions = positions + np.array([1, 1, 0, 1], np.int32)
        tokens = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


# ---- (3) engine and orchestrator ----

def _engines(params, name, max_target_len=32, **kw):
    model_kw = kw.pop('model_kw', {})
    jc, tc = _configs(name, **model_kw)
    jp, tp = params[name]
    jeng = jax_engine.InferenceEngine(jax_engine.EngineConfig(
        model=jc, max_slots=4, max_target_len=max_target_len,
        prefill_buckets=(16,), kv_dtype=jnp.float32, **kw), jp)
    teng = engine_lib.InferenceEngine(engine_lib.EngineConfig(
        model=tc, max_slots=4, max_target_len=max_target_len,
        prefill_buckets=(16,), kv_dtype=torch.float32, **kw), tp,
        device='cpu')
    return jeng, teng


SERVE_CASES = {
    'dense': ('deepseek-tiny', {}),
    'paged-deferral': ('deepseek-tiny-moe-only',
                       dict(kv_page_size=8, kv_num_pages=7)),
}


@pytest.mark.parametrize('case', sorted(SERVE_CASES))
def test_generate_matches_jax_engine(params, xla_decode, case):
    """Six prompts through four slots (a second wave follows releases), 6
    new tokens each, decode_steps=4: the same greedy tokens, page stats
    and block tables as the JAX engine."""
    name, kw = SERVE_CASES[case]
    jeng, teng = _engines(params, name, **kw)
    jorch = jax_orch.Orchestrator(jeng, decode_steps=4)
    torch_orch = orch_lib.Orchestrator(teng, decode_steps=4)
    want = jorch.generate(PROMPTS, max_new_tokens=6)
    treqs = [torch_orch.submit(orch_lib.Request(prompt_tokens=p,
                                                max_new_tokens=6))
             for p in PROMPTS]
    torch_orch.run_until_drained()
    assert [r.output_tokens for r in treqs] == want
    assert all(r.error is None and len(r.output_tokens) == 6 for r in treqs)
    assert teng.kv_page_stats == jeng.kv_page_stats
    if teng.config.paged:
        state = torch_orch.state
        c = teng.config.model
        assert tuple(state['kv_k'].shape) == (
            c.n_layers, teng.kv_page_stats['total'] + 1, 8, 1,
            c.kv_lora_rank)
        np.testing.assert_array_equal(state['block_tables'].numpy(),
                                      np.asarray(jorch.state['block_tables']))
    if 'deferral' in case:
        assert any(r.deferred_wait > 0 for r in treqs)


def test_padded_wave_sets_expert_capacity_as_the_reference(
        params, xla_decode, monkeypatch):
    """A 3-prompt wave, which the reference pads to 4 rows (the pad row
    repeats row 0 and takes expert capacity), at a capacity factor low
    enough that experts overflow: a real token is dropped in the wave, and
    the greedy tokens equal the JAX engine's."""
    kw = dict(model_kw=dict(capacity_factor=0.25))
    jeng, teng = _engines(params, 'deepseek-tiny', **kw)
    waves = []
    real_route = moe.route

    def spy(config, router_w, x, token_mask=None, capacity=None):
        r = real_route(config, router_w, x, token_mask, capacity)
        if capacity is None:          # a prefill wave, not a decode step
            real = (token_mask != 0)[:, None]
            waves.append((x.shape[0], bool((real & ~r.keep).any())))
        return r

    monkeypatch.setattr(moe, 'route', spy)
    prompts = PROMPTS[2:5]
    want = jax_orch.Orchestrator(jeng, decode_steps=4).generate(
        prompts, max_new_tokens=6)
    got = orch_lib.Orchestrator(teng, decode_steps=4).generate(
        prompts, max_new_tokens=6)
    assert got == want
    assert waves and all(rows == 4 * 16 for rows, _ in waves)
    assert any(dropped for _, dropped in waves)


@pytest.mark.parametrize('kw, match', [
    (dict(kv_dtype=torch.int8), 'custom cache layout'),
    (dict(kv_dtype=torch.int8, kv_page_size=8), 'with the paged cache'),
    (dict(prefix_cache_entries=2), 'prefix_cache_entries needs'),
])
def test_engine_rejections_match_reference(params, kw, match):
    jax_kw = dict(kw)
    if jax_kw.get('kv_dtype') is torch.int8:
        jax_kw['kv_dtype'] = jnp.int8
    jc, tc = _configs('deepseek-tiny')
    jp, tp = params['deepseek-tiny']
    base = dict(max_slots=2, max_target_len=32, prefill_buckets=(16,))
    with pytest.raises(NotImplementedError, match=match) as want:
        jax_engine.InferenceEngine(
            jax_engine.EngineConfig(model=jc, **base, **jax_kw), jp)
    with pytest.raises(NotImplementedError, match=match) as got:
        engine_lib.InferenceEngine(
            engine_lib.EngineConfig(model=tc, **base, **kw), tp,
            device='cpu')
    assert str(got.value) == str(want.value).replace(
        'skypilot_tpu.', 'skypilot_tpu_torch.')


@pytest.mark.parametrize('paged', [False, True])
def test_engine_refuses_more_heads_than_mla_decode_takes(paged):
    """The MLA decode kernels take at most 16 heads: a wider model is
    refused when its engine is built, not at its first decode step."""
    tc = dataclasses.replace(deepseek.DEEPSEEK_TINY, n_heads=32,
                             dtype=torch.float32)
    kw = dict(kv_page_size=8) if paged else {}
    with pytest.raises(NotImplementedError, match='at most 16 heads'):
        engine_lib.InferenceEngine(
            engine_lib.EngineConfig(model=tc, max_slots=2, max_target_len=32,
                                    prefill_buckets=(16,), **kw),
            {}, device='cpu')
    assert deepseek.DEEPSEEK_V2_LITE.n_heads == 16


def test_engine_allocates_the_compressed_layout(params):
    _, teng = _engines(params, 'deepseek-tiny')
    c = teng.config.model
    state = teng.init_decode_state()
    assert tuple(state['kv_k'].shape) == (c.n_layers, 4, 32, 1,
                                          c.kv_lora_rank)
    assert tuple(state['kv_v'].shape) == (c.n_layers, 4, 32, 1,
                                          c.qk_rope_head_dim)
    assert not teng.supports_chunked_prefill
    assert teng.max_admit_len == 16
    _, teng = _engines(params, 'deepseek-tiny', kv_page_size=8,
                       kv_num_pages=10)
    state = teng.init_decode_state()
    assert tuple(state['kv_v'].shape) == (c.n_layers, 11, 8, 1,
                                          c.qk_rope_head_dim)
