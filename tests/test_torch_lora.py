"""The port's LoRA (``train/lora.py`` and LoRA in ``Trainer``) vs the JAX
package's, on the CPU.

The JAX adapter tree (``init_lora`` from a PRNG key) crosses with
``params_from_numpy``; the port's own ``init_lora`` is held to the same
structure, shapes, types and scale. Tolerances, fp32 on both sides:
``merge`` 1e-6 absolute (one rank-r product per weight, summed in
another order); loss 1e-5 and adapter gradients 2e-5 absolute, and
three ``Trainer`` steps with the tolerances of ``test_torch_train.py``
(loss 1e-5, grad norm 1e-5 relative, adapters 5e-5 absolute). The
frozen base is compared bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import lora as jax_lora
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.models import deepseek
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.train import lora
from skypilot_tpu_torch.train import trainer

MERGE_ATOL = 1e-6
LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5
TRAINER_PARAM_ATOL = 5e-5

JCFG = dataclasses.replace(jax_llama.LLAMA_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
TARGETS = ('wq', 'wv', 'wo', 'w_up')


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    return llama.params_from_numpy(_np(tree), 'cpu')


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}/{k}'))
        return out
    return {prefix: tree}


def _batch(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    return {'tokens': tokens, 'targets': np.roll(tokens, -1, axis=1)}


@pytest.fixture(scope='module')
def trees():
    base = jax_llama.init(JCFG, jax.random.PRNGKey(1))
    adapters = jax_lora.init_lora(base, 4, jax.random.PRNGKey(2),
                                  targets=TARGETS)
    # Non-zero B, so the merge and the gradients of A are exercised.
    adapters = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                               x.shape), adapters)
    return base, adapters


def test_init_lora_has_the_jax_structure():
    base_j = jax_llama.init(JCFG, jax.random.PRNGKey(0))
    ref = _flat(jax_lora.init_lora(base_j, 8, jax.random.PRNGKey(1),
                                   targets=TARGETS))
    gen = torch.Generator()
    gen.manual_seed(1)
    got = _flat(lora.init_lora(llama.init(TCFG, device='cpu'), 8, gen,
                               targets=TARGETS))
    assert set(got) == set(ref)
    for name, want in ref.items():
        assert tuple(got[name].shape) == want.shape, name
        assert got[name].dtype == torch.float32
        if name.endswith('/b'):
            assert not got[name].any()
        else:
            d_in = want.shape[-2]
            # gaussian * d_in^-1/2 on both sides
            assert float(got[name].std()) * d_in ** 0.5 == pytest.approx(
                1.0, abs=0.1)
    assert lora.count_params(_to_torch(jax_lora.init_lora(
        base_j, 8, jax.random.PRNGKey(1), targets=TARGETS))) == \
        jax_lora.count_params(jax_lora.init_lora(
            base_j, 8, jax.random.PRNGKey(1), targets=TARGETS))


def test_unknown_targets_raise_as_in_jax():
    base_j = jax_llama.init(JCFG, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=r"\['w_uq'\] not found") as want:
        jax_lora.init_lora(base_j, 4, jax.random.PRNGKey(1),
                           targets=('wq', 'w_uq'))
    with pytest.raises(ValueError, match=r"\['w_uq'\] not found") as got:
        lora.init_lora(llama.init(TCFG, device='cpu'), 4, torch.Generator(),
                       targets=('wq', 'w_uq'))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match='not found'):
        trainer.Trainer(trainer.TrainConfig(
            model=TCFG, global_batch_size=2, seq_len=8, lora_rank=4,
            lora_targets=('q_proj',)), device='cpu').init_state()


def test_deepseek_lora_targets_wait_for_deepseek_training():
    """MLA targets (w_uq, w_ukv, wo) needed DeepSeek's loss_fn, which the
    port now has (item 6.4): the Trainer takes them, trains only the
    adapters and leaves the base as it was (the values against the JAX
    LoRA are in test_torch_deepseek_train.py)."""
    tr = trainer.Trainer(trainer.TrainConfig(
        model=dataclasses.replace(deepseek.DEEPSEEK_TINY,
                                  dtype=torch.float32),
        global_batch_size=2, seq_len=8, lora_rank=4,
        lora_targets=('w_uq', 'w_ukv', 'wo')), device='cpu')
    state = tr.init_state()
    base = [t.clone() for t in trainer.param_leaves(state['base'])]
    assert {k for group in state['params'].values() for k in group} == {
        'w_uq', 'w_ukv', 'wo'}
    tokens = torch.arange(16).reshape(2, 8)
    state, metrics = tr.step(state, {'tokens': tokens, 'targets': tokens})
    assert torch.isfinite(metrics['loss'])
    assert all(torch.equal(a, b) for a, b in zip(
        trainer.param_leaves(state['base']), base))


def test_merge_matches_jax(trees):
    base, adapters = trees
    want = _flat(jax_lora.merge(base, adapters, 32.0, 4))
    got = _flat(lora.merge(_to_torch(base), _to_torch(adapters), 32.0, 4))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w),
                                   atol=MERGE_ATOL, rtol=0, err_msg=name)
    exported = lora.merged_params(_to_torch(base), _to_torch(adapters),
                                  32.0, 4)
    assert not any(t.requires_grad for t in _flat(exported).values())


def test_loss_and_adapter_gradients_match_jax(trees):
    base, adapters = trees
    batch = _batch(4)

    def loss_j(ad):
        merged = jax_lora.merge(jax.lax.stop_gradient(base), ad, 32.0, 4)
        return jax_llama.loss_fn(JCFG, merged, jnp.asarray(batch['tokens']),
                                 jnp.asarray(batch['targets']))

    lj, gj = jax.value_and_grad(loss_j)(adapters)
    tbase, tad = _to_torch(base), _to_torch(adapters)
    leaves = trainer.param_leaves(tad)
    for p in leaves:
        p.requires_grad_(True)
    lt = llama.loss_fn(TCFG, lora.merge(tbase, tad, 32.0, 4),
                       torch.from_numpy(batch['tokens']),
                       torch.from_numpy(batch['targets']))
    grads = torch.autograd.grad(lt, leaves)
    assert float(lt.detach()) == pytest.approx(float(lj), abs=LOSS_ATOL)
    want = _flat(gj)
    got = dict(zip(_flat(tad), grads))
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(g),
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize('accum', [1, 2])
def test_three_lora_trainer_steps_match_jax(accum):
    common = dict(global_batch_size=4, seq_len=24, learning_rate=1e-3,
                  warmup_steps=2, lora_rank=4, lora_alpha=32.0,
                  lora_targets=TARGETS, accum_steps=accum)
    jtr = jax_trainer.Trainer(
        jax_trainer.TrainConfig(model=JCFG,
                                mesh_plan=mesh_lib.MeshPlan(data=1),
                                **common),
        mesh=mesh_lib.build_mesh(mesh_lib.MeshPlan(data=1),
                                 devices=jax.devices()[:1]))
    ttr = trainer.Trainer(trainer.TrainConfig(model=TCFG, **common),
                          device='cpu')
    state_j = jtr.init_state()
    base0 = _np(state_j['base'])
    state_t = ttr.init_state(_to_torch(state_j['base']),
                             adapters=_to_torch(state_j['params']))
    adapter_shapes = {tuple(p.shape)
                      for p in trainer.param_leaves(state_t['params'])}
    for step in range(3):
        batch = _batch(10 + step, b=4)
        state_j, m_j = jtr.step(state_j, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        state_t, m_t = ttr.step(state_t, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        assert float(m_t['loss']) == pytest.approx(float(m_j['loss']),
                                                   abs=LOSS_ATOL)
        assert float(m_t['grad_norm']) == pytest.approx(
            float(m_j['grad_norm']), rel=1e-5)
    want = _flat(state_j['params'])
    got = _flat(state_t['params'])
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(w), atol=TRAINER_PARAM_ATOL,
                                   err_msg=name)
    # The base is frozen: bit-identical, never given a gradient.
    for name, w in _flat(base0).items():
        t = _flat(state_t['base'])[name]
        assert not t.requires_grad and t.grad is None
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(_flat(state_j['base'])[name]), w)
    # Only adapter-sized tensors in the optimizer state.
    opt = [t for t in jax.tree_util.tree_leaves(state_t['opt_state'])
           if torch.is_tensor(t) and t.ndim]
    assert opt and all(tuple(t.shape) in adapter_shapes for t in opt)
    # Eval merges the adapters too.
    batch = _batch(20, b=4)
    assert float(ttr.eval_step(state_t, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})) == \
        pytest.approx(float(jtr.eval_step(
            state_j, {k: jnp.asarray(v) for k, v in batch.items()})),
            abs=LOSS_ATOL)


def test_lora_state_round_trips_through_the_host():
    tr = trainer.Trainer(trainer.TrainConfig(
        model=TCFG, global_batch_size=2, seq_len=8, lora_rank=2),
        device='cpu')
    state = tr.init_state()
    batch = {k: torch.from_numpy(v) for k, v in _batch(1, s=8).items()}
    state, _ = tr.step(state, batch)
    host = tr.host_state(state)
    state, m1 = tr.step(state, batch)
    again, m2 = tr.step(tr.load_state(host), batch)
    assert float(m1['loss']) == float(m2['loss'])
    for a, b in zip(trainer.param_leaves(state['params']),
                    trainer.param_leaves(again['params'])):
        assert b.requires_grad and torch.equal(a, b)
    assert not any(t.requires_grad
                   for t in trainer.param_leaves(again['base']))
    assert again['step'] == state['step'] == 2
