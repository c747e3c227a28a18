"""PyTorch port's weight quantization vs the JAX reference, on the CPU.

The same numpy inputs (from seeds) go through ``skypilot_tpu/ops/
quantization.py`` and the port's ``ops/quantization.py``:

* quantize / quantize4 / _pack4 / _unpack4 / dequantize*: bit for bit
  (int8 bytes, packed nibbles, fp32 scales), the short-axis group
  fallback and the odd-contraction ValueError included;
* the quantized matmul, embed_rows, tied_head and expert_matmul at fp32:
  within 1e-6 relative (the same fp32 products in another summation
  order); the int8 matmul at bf16 within 2^-7 of the output's largest
  magnitude (see BF16_TOL);
* whole trees (quantize_params, quantize_params_int4, the synthetic
  initializers, params_nbytes, params_from_numpy of a quantized JAX
  tree): the same keys, the same leaves quantized, the same bytes;
* the engine: greedy tokens with int8 and int4 weights equal the JAX
  engine's for LLAMA_TINY (int8 also with an int8 KV cache) and
  DEEPSEEK_TINY, fp32 variants (the JAX side takes its XLA decode path,
  XSKY_DECODE_ATTN=xla).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import orchestrator as jax_orch
from skypilot_tpu.models import deepseek as jax_deepseek
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.ops import quantization as jq
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.models import deepseek
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import quantization as qops

# fp32 products of the same values in another summation order.
FP32_RTOL = 1e-6
# bf16 int8 matmul: both sides round the product to bf16 once (after an
# fp32 sum in their own order) and round again at the scale multiply, so
# an element may differ by about two bf16 ulps (2^-8 relative each) of
# the largest output.
BF16_TOL = 2.0 ** -7


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_same_int8(tq, jqt):
    np.testing.assert_array_equal(tq.q.numpy(), _np(jqt.q))
    np.testing.assert_array_equal(tq.scale.numpy(), _np(jqt.scale))
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    assert tq.axis == jqt.axis


def _assert_same_int4(tq, jqt):
    np.testing.assert_array_equal(tq.q_packed.numpy(), _np(jqt.q_packed))
    np.testing.assert_array_equal(tq.scale.numpy(), _np(jqt.scale))
    assert (tq.axis, tq.group) == (jqt.axis, jqt.group)


# ---- quantize / dequantize / packing, bit for bit ----

@pytest.mark.parametrize('shape,axis', [((96, 40), -2), ((96, 40), -1),
                                        ((3, 64, 24), -2), ((3, 64, 24), 1),
                                        ((200, 32), -1)])
def test_quantize_and_dequantize_match_jax_bit_for_bit(shape, axis):
    w = _weights(1, shape)
    w[0] = 0.0   # an all-zero channel or row takes the 1e-8 floor
    want = jq.quantize(jnp.asarray(w), axis)
    got = qops.quantize(_t(w), axis)
    _assert_same_int8(got, want)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            qops.dequantize(got, tdt).float().numpy(),
            _np(jq.dequantize(want, jdt).astype(jnp.float32)))
    # bf16 weights quantize from their own values, as the engine does.
    wb = jnp.asarray(w, jnp.bfloat16)
    _assert_same_int8(qops.quantize(_t(_np(wb.astype(jnp.float32))).to(
        torch.bfloat16), axis), jq.quantize(wb, axis))


@pytest.mark.parametrize('shape,group', [((256, 48), 128), ((64, 8), 128),
                                         ((2, 384, 16), 128),
                                         ((32, 10), 8)])
def test_quantize4_and_dequantize4_match_jax_bit_for_bit(shape, group):
    """(64, 8) and (32, 10) at group 128 exercise the one-group fallback
    of a contraction shorter than the group."""
    w = _weights(2, shape)
    want = jq.quantize4(jnp.asarray(w), -2, group)
    got = qops.quantize4(_t(w), -2, group)
    _assert_same_int4(got, want)
    assert got.shape == tuple(shape) == tuple(want.shape)
    assert got.nbytes == want.nbytes
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            qops.dequantize4(got, tdt).float().numpy(),
            _np(jq.dequantize4(want, jdt).astype(jnp.float32)))


@pytest.mark.parametrize('axis', [-2, -1, -3])
def test_pack4_and_unpack4_match_jax(axis):
    q = np.random.default_rng(3).integers(-8, 8, (4, 6, 8)).astype(np.int8)
    packed = jq._pack4(jnp.asarray(q), axis)
    got = qops._pack4(_t(q), axis)
    np.testing.assert_array_equal(got.numpy(), _np(packed))
    np.testing.assert_array_equal(qops._unpack4(got, axis).numpy(), q)
    np.testing.assert_array_equal(qops._unpack4(got, axis).numpy(),
                                  _np(jq._unpack4(packed, axis)))


@pytest.mark.parametrize('shape,group', [((7, 4), 128), ((192, 4), 128),
                                         ((24, 4), 3)])
def test_quantize4_refuses_what_jax_refuses(shape, group):
    """Odd contraction, a contraction the group does not divide, and an
    odd group: both packages raise the same ValueError."""
    w = _weights(4, shape)
    with pytest.raises(ValueError) as want:
        jq.quantize4(jnp.asarray(w), -2, group)
    with pytest.raises(ValueError) as got:
        qops.quantize4(_t(w), -2, group)
    assert str(got.value) == str(want.value)


# ---- quantized products ----

def _assert_rel(got, want, rtol=FP32_RTOL):
    want = _np(want).astype(np.float32)
    got = got.float().numpy()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


@pytest.mark.parametrize('bits', [8, 4])
@pytest.mark.parametrize('preferred', [None, 'fp32'])
def test_quantized_matmul_matches_jax_at_fp32(bits, preferred):
    w = _weights(5, (256, 72))
    x = _weights(6, (3, 5, 256))
    jw = (jq.quantize if bits == 8 else jq.quantize4)(jnp.asarray(w))
    tw = (qops.quantize if bits == 8 else qops.quantize4)(_t(w))
    want = jq.matmul(jnp.asarray(x), jw,
                     preferred_element_type=(jnp.float32 if preferred
                                             else None))
    got = qops.matmul(_t(x), tw, preferred_element_type=(
        torch.float32 if preferred else None))
    assert got.dtype == torch.float32
    _assert_rel(got, want)


@pytest.mark.parametrize('bits', [8, 4])
def test_quantized_matmul_at_bf16(bits):
    """bf16 activations, no preferred type (the layer products): the
    scale is rounded to bf16 and applied after the bf16 product (int8),
    or the weight is dequantized to bf16 first (int4)."""
    w = _weights(7, (512, 96))
    x = np.asarray(jnp.asarray(_weights(8, (4, 512)), jnp.bfloat16)
                   .astype(jnp.float32))
    jw = (jq.quantize if bits == 8 else jq.quantize4)(jnp.asarray(w))
    tw = (qops.quantize if bits == 8 else qops.quantize4)(_t(w))
    want = jq.matmul(jnp.asarray(x, jnp.bfloat16), jw)
    got = qops.matmul(_t(x).to(torch.bfloat16), tw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _assert_rel(got, want.astype(jnp.float32), BF16_TOL)


def test_quantized_embed_rows_and_tied_head_match_jax():
    table = _weights(9, (300, 64))
    tokens = np.random.default_rng(10).integers(0, 300, (3, 7))
    jt = jq.quantize(jnp.asarray(table), -1)
    tt = qops.quantize(_t(table), -1)
    rows = qops.embed_rows(tt, _t(tokens))
    assert rows.dtype == torch.float32   # the scale's type
    np.testing.assert_array_equal(
        rows.numpy(), _np(jq.embed_rows(jt, jnp.asarray(tokens))))
    hidden = _weights(11, (2, 5, 64))
    _assert_rel(qops.tied_head(_t(hidden), tt),
                jq.tied_head(jnp.asarray(hidden), jt))
    _assert_rel(qops.tied_head(_t(hidden), _t(table)),
                jq.tied_head(jnp.asarray(hidden), jnp.asarray(table)))
    with pytest.raises(ValueError, match='per-row|contraction'):
        qops.embed_rows(qops.quantize(_t(table), -2), _t(tokens))


@pytest.mark.parametrize('bits', [8, 4])
@pytest.mark.parametrize('preferred', [None, 'fp32'])
def test_quantized_expert_matmul_matches_jax(bits, preferred):
    """[E, out] scales broadcast as [E, 1, out] over the [E, C, out]
    result."""
    w = _weights(12, (4, 64, 40))
    x = _weights(13, (4, 6, 64))
    jw = (jq.quantize if bits == 8 else jq.quantize4)(jnp.asarray(w))
    tw = (qops.quantize if bits == 8 else qops.quantize4)(_t(w))
    want = jq.expert_einsum('ecd,edf->ecf', jnp.asarray(x), jw,
                            preferred_element_type=(
                                jnp.float32 if preferred else None))
    got = qops.expert_matmul(_t(x), tw, torch.float32 if preferred else None)
    _assert_rel(got, want)


def test_quantized_branches_refuse_a_gradient():
    w = qops.quantize(_t(_weights(14, (32, 8))))
    x = torch.ones((2, 32), requires_grad=True)
    with pytest.raises(RuntimeError, match='no gradient'):
        qops.matmul(x, w)
    with pytest.raises(RuntimeError, match='no gradient'):
        qops.matmul(x, qops.quantize4(_t(_weights(14, (32, 8)))))
    with torch.no_grad():
        assert qops.matmul(x, w).shape == (2, 8)


def test_leading_axis_indexing_and_device_moves():
    w = _weights(15, (3, 64, 16))
    for quant in (qops.quantize, qops.quantize4):
        stacked = quant(_t(w))
        one = stacked[1]
        whole = quant(_t(w[1]))
        for a, b in zip(dataclasses.astuple(one), dataclasses.astuple(whole)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
            else:
                assert a == b
        assert one.shape == (64, 16) and stacked.to('cpu').shape == w.shape
        with pytest.raises(IndexError):
            one[0]


# ---- whole trees ----

JL = dataclasses.replace(jax_llama.LLAMA_TINY, dtype=jnp.float32)
TL = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
JD = dataclasses.replace(jax_deepseek.DEEPSEEK_TINY, dtype=jnp.float32)
TD = dataclasses.replace(deepseek.DEEPSEEK_TINY, dtype=torch.float32)
FAMILIES = {'llama': (jax_llama, llama, JL, TL),
            'deepseek': (jax_deepseek, deepseek, JD, TD)}


@pytest.fixture(scope='module')
def trees():
    out = {}
    for name, (jmod, tmod, jc, _) in FAMILIES.items():
        jp = jmod.init(jc, jax.random.PRNGKey(0))
        out[name] = (jp, tmod.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), 'cpu'))
    return out


def _assert_same_tree(got, want):
    assert set(got) == set(want)
    for key, g in got.items():
        w = want[key]
        if isinstance(g, dict):
            _assert_same_tree(g, w)
        elif isinstance(g, qops.Quantized4Tensor):
            assert isinstance(w, jq.Quantized4Tensor), key
            _assert_same_int4(g, w)
        elif isinstance(g, qops.QuantizedTensor):
            assert isinstance(w, jq.QuantizedTensor), key
            _assert_same_int8(g, w)
        else:
            assert not isinstance(w, (jq.QuantizedTensor,
                                      jq.Quantized4Tensor)), key
            np.testing.assert_array_equal(g.float().numpy(),
                                          _np(w).astype(np.float32))


@pytest.mark.parametrize('family', sorted(FAMILIES))
@pytest.mark.parametrize('bits', [8, 4])
def test_quantize_params_match_jax_and_cross_unchanged(trees, family, bits):
    """The port quantizes the carried tree to JAX's bytes; the JAX
    quantized tree, carried by params_from_numpy, holds the same bytes;
    both transforms are idempotent; the form that quantizes a tree on
    its way to a device, a stack one layer at a time (the server's),
    gives the same tree; params_nbytes agrees."""
    jp, tp = trees[family]
    jfn = jq.quantize_params if bits == 8 else jq.quantize_params_int4
    tfn = qops.quantize_params if bits == 8 else qops.quantize_params_int4
    want = jfn(jp)
    got = tfn(tp)
    _assert_same_tree(got, want)
    carried = FAMILIES[family][1].params_from_numpy(
        jax.tree_util.tree_map(np.asarray, want), 'cpu')
    _assert_same_tree(carried, want)
    again = tfn(got)
    _assert_same_tree(again, want)
    moved = qops.quantize_params_to(tp, torch.int8 if bits == 8
                                    else 'int4', 'cpu')
    _assert_same_tree(moved, want)
    assert qops.params_nbytes(got) == jq.params_nbytes(want)
    # DeepSeek's MLA projections and shared experts stay plain.
    if family == 'deepseek':
        for key in ('w_dq', 'w_uq', 'w_dkv', 'w_kr', 'w_ukv', 'ws_gate'):
            assert isinstance(got['moe_layers'].get(
                key, got['dense_layers'].get(key)), torch.Tensor)


@pytest.mark.parametrize('family', sorted(FAMILIES))
@pytest.mark.parametrize('bits', [8, 4])
def test_synthetic_quantized_params_match_jax_layout(family, bits):
    """The synthetic initializers: the same keys, the same leaves
    quantized with the same shapes, types and fan-in scales as JAX's
    (the random bytes differ: two generators), the other leaves ones;
    the shapes come from init on the meta device, so no full-precision
    weight is ever made."""
    jmod, tmod, jc, tc = FAMILIES[family]
    shapes = tmod.init(tc, device='meta')
    assert all(leaf.device.type == 'meta' for leaf in _leaves(shapes))
    jshapes = jax.eval_shape(functools.partial(jmod.init, jc),
                             jax.random.PRNGKey(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    if bits == 8:
        got = qops.synthetic_quantized_params(shapes, gen)
        want = jq.synthetic_quantized_params(jshapes, jax.random.PRNGKey(0))
    else:
        got = qops.synthetic_quantized4_params(shapes, gen)
        want = jq.synthetic_quantized4_params(jshapes,
                                              jax.random.PRNGKey(0))
    _assert_same_layout(got, want)
    assert qops.params_nbytes(got) == jq.params_nbytes(want)


def _leaves(tree):
    for value in tree.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


def _assert_same_layout(got, want):
    assert set(got) == set(want)
    for key, g in got.items():
        w = want[key]
        if isinstance(g, dict):
            _assert_same_layout(g, w)
            continue
        if qops.is_quantized(g) or isinstance(w, (jq.QuantizedTensor,
                                                  jq.Quantized4Tensor)):
            assert type(g).__name__ == type(w).__name__, key
        if qops.is_quantized(g):
            values = g.q_packed if hasattr(g, 'q_packed') else g.q
            wvalues = w.q_packed if hasattr(w, 'q_packed') else w.q
            assert values.dtype == torch.int8
            assert tuple(values.shape) == tuple(wvalues.shape), key
            assert g.shape == tuple(w.shape) and g.axis == w.axis
            np.testing.assert_array_equal(g.scale.numpy(), _np(w.scale))
            assert values.float().std() > 50   # random bytes, not zeros
        else:
            assert key not in qops._QUANT_AXES or g.ndim < 2, key
            assert g.dtype == {'float32': torch.float32,
                               'bfloat16': torch.bfloat16}[str(w.dtype)]
            assert bool((g == 1).all()) and tuple(g.shape) == w.shape


# ---- the engine ----

PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(0, 256, n)]
           for i, n in enumerate((3, 5, 12, 14, 9, 7))]
ENGINE_CASES = [('llama', 8, 'int8'), ('llama', 4, 'fp32'),
                ('deepseek', 8, 'fp32'), ('deepseek', 4, 'fp32')]


@pytest.mark.parametrize('family,bits,kv', ENGINE_CASES)
def test_quantized_engine_tokens_match_jax(trees, monkeypatch, family, bits,
                                           kv):
    """Six prompts through four slots (a second wave follows releases),
    eight new tokens each, decode fused four steps a tick."""
    monkeypatch.setenv('XSKY_DECODE_ATTN', 'xla')
    jp, tp = trees[family]
    _, _, jc, tc = FAMILIES[family]
    jkv, tkv = {'int8': (jnp.int8, torch.int8),
                'fp32': (jnp.float32, torch.float32)}[kv]
    jwd, twd = {8: (jnp.int8, torch.int8), 4: ('int4', 'int4')}[bits]
    common = dict(max_slots=4, max_target_len=32, prefill_buckets=(16,))
    jeng = jax_engine.InferenceEngine(jax_engine.EngineConfig(
        model=jc, kv_dtype=jkv, weight_dtype=jwd, **common), jp)
    teng = engine_lib.InferenceEngine(engine_lib.EngineConfig(
        model=tc, kv_dtype=tkv, weight_dtype=twd, **common), tp,
        device='cpu')
    assert qops.is_quantized(teng.params['lm_head'])
    want = jax_orch.Orchestrator(jeng, decode_steps=4).generate(
        PROMPTS, max_new_tokens=8)
    got = orch_lib.Orchestrator(teng, decode_steps=4).generate(
        PROMPTS, max_new_tokens=8)
    assert got == want
    assert all(len(t) == 8 for t in got)
