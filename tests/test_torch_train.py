"""PyTorch port's training half vs the JAX reference, on the CPU.

* ``loss_fn`` and the gradient of every parameter against JAX
  ``loss_fn`` (``jax.value_and_grad``) at LLAMA_TINY and MISTRAL_TINY in
  fp32: a loss mask, EOS packing, a sequence longer than the loss chunk,
  and every remat policy (same gradients as no remat; the products each
  policy keeps are really not recomputed);
* ``segments_from_eos`` against JAX;
* ``adamw`` and ``adafactor`` (with the global-norm clip and the
  schedule) against optax over three steps;
* three ``Trainer`` steps against the JAX ``Trainer`` on a one-device
  mesh, and ``eval_step`` and ``measure_throughput``.

Weights come from the JAX ``init`` and cross with ``params_from_numpy``;
batches are numpy arrays from a seed. Tolerances: loss 1e-5 and grads
2e-5 absolute (fp32 on both sides, sums in another order); optimizer and
trainer parameters 2e-5 absolute: adamw stores its first moment in bf16
on both sides, and a last-digit difference in a gradient can round it to
the neighbouring bf16 value (2^-8 relative), which Adam's mu / sqrt(nu)
passes on as up to about 4e-3 of the learning rate per step. Trainer
parameters after three steps: 5e-5 absolute, 5 % of one step at the
learning rate 1e-3: Adam normalizes each element by its own gradient
history, so an element whose gradient nearly cancels (an embedding row
seen only through masked positions) carries the gradient's relative
rounding error, not its absolute one, into the update.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.train import optim
from skypilot_tpu_torch.train import trainer

LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5
PARAM_ATOL = 2e-5
TRAINER_PARAM_ATOL = 5e-5

CONFIGS = {
    'llama_tiny': (jax_llama.LLAMA_TINY, llama.LLAMA_TINY),
    'mistral_tiny': (jax_llama.MISTRAL_TINY, llama.MISTRAL_TINY),
}


def _fp32(name, **kw):
    jcfg, tcfg = CONFIGS[name]
    return (dataclasses.replace(jcfg, dtype=jnp.float32, **kw),
            dataclasses.replace(tcfg, dtype=torch.float32, **kw))


def _to_torch(tree):
    return llama.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                   'cpu')


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _batch(seed, b, s, vocab=256, eos=None, masked=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    if eos is not None:
        tokens[rng.random((b, s)) < 0.15] = eos
    batch = {'tokens': tokens, 'targets': np.roll(tokens, -1, axis=1)}
    if masked:
        batch['mask'] = (rng.random((b, s)) < 0.6).astype(np.float32)
    return batch


LOSS_CASES = {
    'plain': dict(),
    'loss_mask': dict(masked=True),
    'packing': dict(eos=7),
    'longer_than_chunk': dict(chunk=16, masked=True),
}


@pytest.mark.parametrize('case', sorted(LOSS_CASES))
@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_loss_and_every_gradient_match_jax(name, case, monkeypatch):
    kw = dict(LOSS_CASES[case])
    chunk = kw.pop('chunk', None)
    if chunk is not None:
        monkeypatch.setattr(jax_llama, 'LOSS_CHUNK', chunk)
        monkeypatch.setattr(llama, 'LOSS_CHUNK', chunk)
    eos = kw.get('eos')
    jcfg, tcfg = _fp32(name, packing_reset_eos=eos)
    jp = jax_llama.init(jcfg, jax.random.PRNGKey(1))
    tp = _to_torch(jp)
    batch = _batch(2, 2, 40, **kw)
    mask = batch.get('mask')
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(
            jcfg, p, jnp.asarray(batch['tokens']),
            jnp.asarray(batch['targets']),
            loss_mask=None if mask is None else jnp.asarray(mask)))(jp)
    for t in jax.tree_util.tree_leaves(tp):
        t.requires_grad_(True)
    loss_t = llama.loss_fn(
        tcfg, tp, torch.from_numpy(batch['tokens']),
        torch.from_numpy(batch['targets']),
        loss_mask=None if mask is None else torch.from_numpy(mask))
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) < LOSS_ATOL
    flat = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert len(flat) == 12
    for path, g in flat:
        np.testing.assert_allclose(_leaf(tp, path).grad.numpy(),
                                   np.asarray(g), atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


# Weight products recomputed per layer in the backward: those the policy
# does not keep, except w_down, whose output no gradient needs.
RECOMPUTED = {'dots': 0, 'qkvo_gup': 0, 'qkvo_up': 1, 'qkvo': 2,
              'none': 6}


@pytest.mark.parametrize('policy', sorted(RECOMPUTED))
def test_remat_policies_give_the_same_gradients(policy):
    _, base = _fp32('llama_tiny', packing_reset_eos=5)
    batch = _batch(3, 2, 24, eos=5, masked=True)
    args = [torch.from_numpy(batch[k]) for k in ('tokens', 'targets',
                                                 'mask')]
    grads, counts = [], []
    for cfg in (base, dataclasses.replace(base, remat=True,
                                          remat_policy=policy)):
        params = llama.init(cfg, device='cpu')
        leaves = trainer.param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = llama.loss_fn(cfg, params, args[0], args[1],
                             loss_mask=args[2])
        with _CountMatmuls() as count:
            grads.append(torch.autograd.grad(loss, leaves))
        counts.append(count.mm)
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert counts[1] - counts[0] == RECOMPUTED[policy] * base.n_layers


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(llama.LLAMA_TINY, remat=True,
                              remat_policy='bogus')
    params = llama.init(cfg, device='cpu')
    params['embed'].requires_grad_(True)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match='Unknown remat_policy'):
        llama.loss_fn(cfg, params, tokens, tokens)


def test_segments_from_eos_matches_jax():
    tokens = _batch(4, 3, 50, vocab=9, eos=0)['tokens']
    tokens[1, 0] = 0
    tokens[2, -1] = 0
    seg_j, pos_j = jax_llama.segments_from_eos(jnp.asarray(tokens), 0)
    seg_t, pos_t = llama.segments_from_eos(torch.from_numpy(tokens), 0)
    assert seg_t.dtype == torch.int32
    np.testing.assert_array_equal(seg_t.numpy(), np.asarray(seg_j))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))


def test_num_params_and_flops_match_jax():
    for jcfg, tcfg in [(jax_llama.LLAMA3_1B, llama.LLAMA3_1B),
                       (jax_llama.LLAMA3_8B, llama.LLAMA3_8B)]:
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.train_flops_per_token() == jcfg.train_flops_per_token()


# ---- optimizer ----

def _opt_params():
    """A factored leaf (two dims >= 128), a 3-d factored leaf and two
    unfactored ones."""
    rng = np.random.default_rng(5)
    return {'w': rng.standard_normal((130, 160)).astype(np.float32) * 0.05,
            'stack': rng.standard_normal((2, 128, 140)).astype(
                np.float32) * 0.05,
            'narrow': rng.standard_normal((4, 200)).astype(np.float32),
            'norm': np.ones((64,), np.float32)}


@pytest.mark.parametrize('clip', ['triggered', 'not_triggered'])
@pytest.mark.parametrize('kind', ['adamw', 'adafactor'])
def test_optimizer_matches_optax_over_three_steps(kind, clip):
    cfg = trainer.TrainConfig(learning_rate=1e-2, warmup_steps=2,
                              optimizer=kind, weight_decay=0.1,
                              grad_clip_norm=1.0 if clip == 'triggered'
                              else 1e4)
    opt_j = jax_trainer.make_optimizer(cfg)
    opt_t = trainer.make_optimizer(cfg)
    params = _opt_params()
    names = sorted(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    state_j = opt_j.init(jp)
    state_t = opt_t.init(tp)
    # Jitted, as the JAX Trainer runs it: XLA then keeps the bf16 first
    # moment's products in fp32 until the store, as the port does.
    update_j = jax.jit(opt_j.update)
    rng = np.random.default_rng(6)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd_j, state_j = update_j({k: jnp.asarray(v)
                                       for k, v in grads.items()},
                                  state_j, jp)
        jp = optax.apply_updates(jp, upd_j)
        upd_t, state_t = opt_t.update(
            [torch.from_numpy(grads[k]) for k in names], state_t, tp)
        optim.apply_updates(tp, upd_t)
        for k, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       atol=PARAM_ATOL, err_msg=k)


def test_schedule_matches_optax():
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 100, 10_000)
    got = optim.warmup_cosine_decay_schedule(0.0, 3e-4, 100, 10_000)
    for count in (0, 1, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6,
                                           abs=1e-12)


def test_global_norm_clip_matches_optax():
    grads = [np.full((3, 4), 2.0, np.float32), np.ones((5,), np.float32)]
    for max_norm in (1.0, 100.0):
        want = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)[0]
        got = optim.ClipByGlobalNorm(max_norm).update(
            [torch.from_numpy(g) for g in grads], None, None)[0]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# ---- trainer ----

TRAINER_CASES = {
    'adamw': dict(),
    'adafactor': dict(optimizer='adafactor'),
    'accum_2': dict(accum_steps=2),
    'masked_accum_2': dict(accum_steps=2, masked=True),
}


@pytest.mark.parametrize('case', sorted(TRAINER_CASES))
def test_trainer_steps_match_jax(case):
    kw = dict(TRAINER_CASES[case])
    masked = kw.pop('masked', False)
    jcfg, tcfg = _fp32('llama_tiny')
    common = dict(global_batch_size=4, seq_len=24, learning_rate=1e-3,
                  warmup_steps=2, **kw)
    jtr = jax_trainer.Trainer(
        jax_trainer.TrainConfig(model=jcfg,
                                mesh_plan=mesh_lib.MeshPlan(data=1),
                                **common),
        mesh=mesh_lib.build_mesh(mesh_lib.MeshPlan(data=1),
                                 devices=jax.devices()[:1]))
    ttr = trainer.Trainer(trainer.TrainConfig(model=tcfg, **common),
                          device='cpu')
    state_j = jtr.init_state()
    state_t = ttr.init_state(_to_torch(state_j['params']))
    for step in range(3):
        batch = _batch(10 + step, 4, 24, masked=masked)
        state_j, m_j = jtr.step(state_j, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        state_t, m_t = ttr.step(state_t, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        assert float(m_t['loss']) == pytest.approx(float(m_j['loss']),
                                                   abs=LOSS_ATOL)
        assert float(m_t['grad_norm']) == pytest.approx(
            float(m_j['grad_norm']), rel=1e-5)
        assert m_t['step'] == int(m_j['step']) == step + 1
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            state_j['params'])[0]:
        np.testing.assert_allclose(
            _leaf(state_t['params'], path).detach().numpy(),
            np.asarray(leaf), atol=TRAINER_PARAM_ATOL,
            err_msg=jax.tree_util.keystr(path))
    batch = _batch(20, 4, 24, masked=True)
    loss_j = jtr.eval_step(state_j, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    loss_t = ttr.eval_step(state_t, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    assert float(loss_t) == pytest.approx(float(loss_j), abs=LOSS_ATOL)


def test_measure_throughput_has_the_jax_keys():
    cfg = trainer.TrainConfig(model=llama.LLAMA_TINY, global_batch_size=2,
                              seq_len=16, accum_steps=2)
    out = trainer.measure_throughput(trainer.Trainer(cfg, device='cpu'),
                                     num_steps=2, warmup=1)
    assert set(out) == {'tokens_per_sec', 'tokens_per_sec_per_chip',
                        'model_tflops_per_sec_per_chip', 'step_time_s',
                        'loss', 'num_devices', 'first_loss'}
    assert out['num_devices'] == 1 and np.isfinite(out['loss'])
    assert out['tokens_per_sec'] > 0


def test_synthetic_batch_is_seeded_by_the_step():
    tr = trainer.Trainer(trainer.TrainConfig(model=llama.LLAMA_TINY,
                                             global_batch_size=2,
                                             seq_len=8), device='cpu')
    a, b = tr.synthetic_batch(0), tr.synthetic_batch(0)
    torch.testing.assert_close(a['tokens'], b['tokens'])
    assert not torch.equal(a['tokens'], tr.synthetic_batch(1)['tokens'])
    torch.testing.assert_close(a['targets'], torch.roll(a['tokens'], -1, 1))
    assert int(a['tokens'].max()) < llama.LLAMA_TINY.vocab_size


@pytest.mark.parametrize('kw', [dict(lora_rank=4),
                                dict(mesh_plan=trainer.MeshPlan(stage=2)),
                                dict(mesh_plan=trainer.MeshPlan(fsdp=2))],
                         ids=['lora', 'pipeline', 'fsdp'])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        trainer.Trainer(trainer.TrainConfig(model=llama.LLAMA_TINY, **kw),
                        device='cpu')
