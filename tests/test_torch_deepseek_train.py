"""DeepSeek training in the PyTorch port (``models/deepseek.py``) vs the
JAX reference, on the CPU, at fp32 ``deepseek-tiny`` (q_lora, one dense
layer then MoE) and ``deepseek-tiny-moe-only`` (full-rank q, MoE only).

* The configs: every field of the reference's ``DeepSeekConfig`` (the
  training fields included), ``num_params``, ``active_params`` and
  ``train_flops_per_token`` for every named config.
* ``forward(return_aux=True)``: logits and the routed layers' mean
  load-balance term, with a token mask.
* ``loss_fn`` (the chunked cross-entropy, chunks shorter than the
  sequence) and the gradient of every leaf (the router included) against
  ``jax.value_and_grad`` of the reference's ``loss_fn``, with a
  ``token_mask``, a ``loss_mask`` and a capacity that drops real tokens.
* remat on against remat off under every policy: the same loss and
  gradients; under 'dots' the backward recomputes no 2-D weight product.
* ``Trainer`` steps against the JAX ``Trainer`` on a one-device mesh
  (``deepseek-tiny-moe-only``, masks, two accumulated microbatches), and
  the Trainer built on a (monkeypatched) card: DeepSeek's attention is
  the plain path, so the flash head-dim guard does not apply.
* LoRA on ``deepseek-tiny``'s MLA weights (``w_uq,w_ukv,wo``) against the
  JAX LoRA: the loss, the adapters' gradients, three ``Trainer`` steps
  and the frozen base bit for bit.
* ``train/launch.py --model deepseek-tiny --device cpu``: a run resumed
  from its checkpoint equals an uninterrupted one bit for bit, and a LoRA
  launch trains only the adapters.
* ``pipelined_loss_fn`` raises, naming ROADMAP.md queue 1 item 8.

Weights are the port's seeded fp32 ``init`` as numpy arrays (the
reference's tree), norm scales redrawn from a numpy seed, given to both
sides (``params_from_numpy`` on the port's); the Trainer tests start from
the JAX Trainer's own init. Inputs are numpy arrays from a seed.
Tolerances (fp32 on both sides, sums in another order): the aux term 1e-6, logits 1e-4 (as test_torch_deepseek.py),
losses 1e-5, gradients and adapter gradients 2e-5 absolute, grad norms
1e-5 relative, parameters after three steps 5e-5 absolute (as
test_torch_train.py and test_torch_lora.py); remat on and off 1e-6.

Every test here runs under a hard time limit of its own (``_time_limit``).
"""
from __future__ import annotations

import dataclasses
import logging
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from skypilot_tpu.models import deepseek as jax_deepseek
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import lora as jax_lora
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch import models
from skypilot_tpu_torch.agent import checkpointd
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.models import deepseek
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.train import launch
from skypilot_tpu_torch.train import lora
from skypilot_tpu_torch.train import trainer

TEST_LIMIT_S = 120
AUX_ATOL = 1e-6
LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5
NORM_RTOL = 1e-5
PARAM_ATOL = 5e-5
REMAT_ATOL = 1e-6
NAMES = ('deepseek-tiny', 'deepseek-tiny-moe-only')
B, S = 2, 24
# Chunks of the cross-entropy shorter than the sequence, so the chunked
# path (two chunks and a padded third) runs.
CE_CHUNK = 10
MLA_TARGETS = ('w_uq', 'w_ukv', 'wo')


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


def _configs(name, **kw):
    return (dataclasses.replace(jax_deepseek.CONFIGS[name],
                                dtype=jnp.float32, **kw),
            dataclasses.replace(deepseek.CONFIGS[name], dtype=torch.float32,
                                **kw))


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f'{prefix}/{key}'))
        return out
    return {prefix: tree}


@pytest.fixture(scope='module')
def trees():
    """{name: an fp32 tree as numpy arrays}: the port's seeded init (the
    reference's names, shapes and distribution), every norm scale redrawn
    (1 + 0.2 N(0, 1)), so a misplaced norm shows."""
    out = {}
    rng = np.random.default_rng(102)
    for name in NAMES:
        _, tcfg = _configs(name)
        gen = torch.Generator()
        gen.manual_seed(1)
        tree = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.numpy())
                for k, v in deepseek.init(tcfg, gen, device='cpu').items()}
        for group in ('dense_layers', 'moe_layers'):
            for key, value in tree.get(group, {}).items():
                if key.endswith('norm'):
                    tree[group][key] = (1 + 0.2 * rng.standard_normal(
                        value.shape)).astype(np.float32)
        out[name] = tree
    return out


def _port(tree):
    return deepseek.params_from_numpy(tree, 'cpu')


def _adapters(tree):
    """A JAX LoRA adapter tree on the port's side (no router to keep)."""
    return llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), 'cpu')


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _batch(seed, b=B, s=S, masked=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    batch = {'tokens': tokens, 'targets': np.roll(tokens, -1, axis=1)}
    if masked:
        batch['mask'] = (rng.random((b, s)) < 0.6).astype(np.float32)
        real = np.ones((b, s), np.float32)
        for row in range(b):
            real[row, s - 4 - 3 * row:] = 0.0
        batch['token_mask'] = real
    return batch


def _port_loss(cfg, params, batch, masked):
    return deepseek.loss_fn(
        cfg, params, torch.from_numpy(batch['tokens']),
        torch.from_numpy(batch['targets']),
        loss_mask=torch.from_numpy(batch['mask']) if masked else None,
        token_mask=torch.from_numpy(batch['token_mask']) if masked else None)


# ---- configs ----

def test_configs_match_the_reference():
    for name, jcfg in jax_deepseek.CONFIGS.items():
        tcfg = deepseek.CONFIGS[name]
        want = {k: v for k, v in dataclasses.asdict(jcfg).items()
                if k != 'dtype'}
        got = {k: v for k, v in dataclasses.asdict(tcfg).items()
               if k != 'dtype'}
        assert got == want, name
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.active_params() == jcfg.active_params()
        assert tcfg.train_flops_per_token() == jcfg.train_flops_per_token()
        assert models.get_config(name) is tcfg
    lite = deepseek.DEEPSEEK_V2_LITE
    assert (lite.max_seq_len, lite.remat, lite.remat_policy,
            lite.ce_chunk, lite.router_aux_coef) == (4096, True, 'dots',
                                                     2048, 0.01)
    assert round(lite.num_params() / 1e9, 2) == 15.71


# ---- forward and the loss ----

@pytest.mark.parametrize('name', NAMES)
def test_forward_return_aux_matches_jax(trees, name):
    jcfg, tcfg = _configs(name)
    batch = _batch(5, masked=True)
    jl, ja = jax_deepseek.forward(
        jcfg, _jax(trees[name]), jnp.asarray(batch['tokens']),
        return_aux=True, token_mask=jnp.asarray(batch['token_mask']))
    tl, ta = deepseek.forward(
        tcfg, _port(trees[name]), torch.from_numpy(batch['tokens']),
        return_aux=True, token_mask=torch.from_numpy(batch['token_mask']))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    assert float(ta) == pytest.approx(float(ja), abs=AUX_ATOL)
    assert float(ta) > 0


LOSS_CASES = {
    'plain': dict(),
    'masks-and-drop': dict(masked=True, capacity_factor=0.5),
}
# (name, case) pairs: both configs with the masks and a drop, the one
# with a dense layer and q_lora also without.
LOSS_RUNS = [('deepseek-tiny', 'plain'), ('deepseek-tiny', 'masks-and-drop'),
             ('deepseek-tiny-moe-only', 'masks-and-drop')]


@pytest.fixture(scope='module')
def jax_losses(trees):
    """jax.value_and_grad of the reference's loss_fn, per (name, case)."""
    out = {}
    for name, case in LOSS_RUNS:
        kw = dict(LOSS_CASES[case])
        masked = kw.pop('masked', False)
        jcfg, _ = _configs(name, ce_chunk=CE_CHUNK, **kw)
        batch = _batch(7, masked=masked)

        def loss(p, batch=batch, jcfg=jcfg, masked=masked):
            return jax_deepseek.loss_fn(
                jcfg, p, jnp.asarray(batch['tokens']),
                jnp.asarray(batch['targets']),
                loss_mask=jnp.asarray(batch['mask']) if masked else None,
                token_mask=(jnp.asarray(batch['token_mask']) if masked
                            else None))

        out[name, case] = jax.jit(jax.value_and_grad(loss))(
            _jax(trees[name]))
    return out


@pytest.mark.parametrize('name,case', LOSS_RUNS)
def test_loss_and_every_gradient_match_jax(trees, jax_losses, name, case):
    kw = dict(LOSS_CASES[case])
    masked = kw.pop('masked', False)
    _, tcfg = _configs(name, ce_chunk=CE_CHUNK, **kw)
    batch = _batch(7, masked=masked)
    params = _port(trees[name])
    leaves = _flat(params)
    for p in leaves.values():
        p.requires_grad_(True)
    if 'capacity_factor' in kw:
        from skypilot_tpu_torch.models import moe
        x = torch.randn(B * S, tcfg.d_model)
        r = moe.route(tcfg, params['moe_layers']['router'][0].detach(), x)
        assert not bool(r.keep.all()), 'no choice was dropped'
    loss = _port_loss(tcfg, params, batch, masked)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    want_loss, want_grads = jax_losses[name, case]
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 abs=LOSS_ATOL)
    want = _flat(want_grads)
    assert set(grads) == set(want) and '/moe_layers/router' in want
    for key, g in want.items():
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(g),
                                   atol=GRAD_ATOL, err_msg=key)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('policy', ['dots', 'none', 'qkvo_gup'])
def test_remat_gives_the_same_loss_and_gradients(trees, policy):
    name = 'deepseek-tiny'
    batch = _batch(9, masked=True)
    results = []
    for remat in (False, True):
        _, tcfg = _configs(name, remat=remat, remat_policy=policy)
        params = _port(trees[name])
        leaves = list(_flat(params).values())
        for p in leaves:
            p.requires_grad_(True)
        loss = _port_loss(tcfg, params, batch, masked=True)
        with _CountMatmuls() as count:
            grads = torch.autograd.grad(loss, leaves)
        results.append((loss.detach(), grads, count.mm))
    (l0, g0, mm0), (l1, g1, mm1) = results
    assert float(l1) == pytest.approx(float(l0), abs=REMAT_ATOL)
    for got, want in zip(g1, g0):
        torch.testing.assert_close(got, want, atol=REMAT_ATOL, rtol=0)
    if policy == 'dots':
        assert mm1 == mm0
    else:
        assert mm1 > mm0


def test_unknown_remat_policy_raises(trees):
    _, tcfg = _configs('deepseek-tiny', remat=True, remat_policy='bogus')
    params = _port(trees['deepseek-tiny'])
    params['embed'].requires_grad_(True)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match='Unknown remat_policy'):
        deepseek.loss_fn(tcfg, params, tokens, tokens)


# ---- Trainer steps ----

# deepseek-tiny (its dense layer, q_lora) steps through both Trainers in
# the LoRA test below.
TRAINER_CASES = {
    'deepseek-tiny-moe-only': dict(accum_steps=2, masked=True),
}


def _jax_trainer(jcfg, **common):
    plan = mesh_lib.MeshPlan(data=1)
    return jax_trainer.Trainer(
        jax_trainer.TrainConfig(model=jcfg, mesh_plan=plan, **common),
        mesh=mesh_lib.build_mesh(plan, devices=jax.devices()[:1]))


def _three_steps(jtr, ttr, state_j, state_t, masked):
    for step in range(3):
        batch = _batch(20 + step, b=4, masked=masked)
        state_j, m_j = jtr.step(state_j, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        state_t, m_t = ttr.step(state_t, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        assert float(m_t['loss']) == pytest.approx(float(m_j['loss']),
                                                   abs=LOSS_ATOL)
        assert float(m_t['grad_norm']) == pytest.approx(
            float(m_j['grad_norm']), rel=NORM_RTOL)
    want = _flat(state_j['params'])
    got = _flat(state_t['params'])
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(w),
                                   atol=PARAM_ATOL, err_msg=key)
    return state_j, state_t


@pytest.mark.parametrize('name', sorted(TRAINER_CASES))
def test_trainer_steps_match_jax(name):
    """Three steps: loss and grad norm each step, then every parameter."""
    kw = dict(TRAINER_CASES[name])
    masked = kw.pop('masked', False)
    jcfg, tcfg = _configs(name)
    common = dict(global_batch_size=4, seq_len=S, learning_rate=1e-3,
                  warmup_steps=2, **kw)
    jtr = _jax_trainer(jcfg, **common)
    ttr = trainer.Trainer(trainer.TrainConfig(model=tcfg, **common),
                          device='cpu')
    state_j = jtr.init_state()
    state_t = ttr.init_state(_port(jax.tree_util.tree_map(
        np.asarray, state_j['params'])))
    _three_steps(jtr, ttr, state_j, state_t, masked)


def test_trainer_builds_deepseek_on_the_card(monkeypatch):
    """DeepSeek's attention is the plain path ('xla': qk head dim 192, v
    head dim 128), so the flash backward's head-dim guard does not apply
    and the Trainer builds on a card; a config sent to the flash kernels
    is still held to their head dims. The device check is monkeypatched:
    there is no card here."""
    cfg = trainer.TrainConfig(model=deepseek.DEEPSEEK_V2_LITE,
                              global_batch_size=1, seq_len=16)
    monkeypatch.setattr(trainer, 'resolve_device',
                        lambda device: torch.device('cuda', 0))
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    assert trainer.Trainer(cfg).device == torch.device('cuda', 0)
    flash = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attention_impl='auto'))
    with pytest.raises(NotImplementedError, match='head_dim None'):
        trainer.Trainer(flash)


# ---- LoRA on the MLA weights ----

def test_lora_loss_and_adapter_gradients_match_jax(trees):
    jcfg, tcfg = _configs('deepseek-tiny')
    base = _jax(trees['deepseek-tiny'])
    adapters = jax_lora.init_lora(base, 4, jax.random.PRNGKey(2),
                                  targets=MLA_TARGETS)
    # Non-zero B, so the gradients of A are exercised too.
    adapters = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                               x.shape), adapters)
    batch = _batch(4, masked=True)

    def loss_j(ad):
        merged = jax_lora.merge(jax.lax.stop_gradient(base), ad, 32.0, 4)
        return jax_deepseek.loss_fn(
            jcfg, merged, jnp.asarray(batch['tokens']),
            jnp.asarray(batch['targets']), loss_mask=jnp.asarray(
                batch['mask']),
            token_mask=jnp.asarray(batch['token_mask']))

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(adapters)
    tad = _adapters(adapters)
    leaves = _flat(tad)
    for p in leaves.values():
        p.requires_grad_(True)
    lt = _port_loss(tcfg, lora.merge(_port(trees['deepseek-tiny']), tad,
                                     32.0, 4), batch, masked=True)
    grads = dict(zip(leaves, torch.autograd.grad(lt, list(
        leaves.values()))))
    assert float(lt.detach()) == pytest.approx(float(lj), abs=LOSS_ATOL)
    want = _flat(gj)
    assert set(grads) == set(want)
    assert {key.split('/')[2] for key in want} == set(MLA_TARGETS)
    for key, g in want.items():
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(g),
                                   atol=GRAD_ATOL, err_msg=key)


def test_three_lora_trainer_steps_match_jax():
    """Only the adapters train, as in the reference; the base stays
    bit-identical."""
    jcfg, tcfg = _configs('deepseek-tiny')
    common = dict(global_batch_size=4, seq_len=S, learning_rate=1e-3,
                  warmup_steps=2, lora_rank=4, lora_alpha=32.0,
                  lora_targets=MLA_TARGETS)
    jtr = _jax_trainer(jcfg, **common)
    ttr = trainer.Trainer(trainer.TrainConfig(model=tcfg, **common),
                          device='cpu')
    state_j = jtr.init_state()
    base = _port(jax.tree_util.tree_map(np.asarray, state_j['base']))
    before = {k: t.clone() for k, t in _flat(base).items()}
    state_t = ttr.init_state(base, adapters=_adapters(state_j['params']))
    _, state_t = _three_steps(jtr, ttr, state_j, state_t, masked=False)
    for key, t in _flat(state_t['base']).items():
        assert torch.equal(t, before[key]), key


# ---- the launcher ----

@pytest.fixture
def isolated(tmp_path, monkeypatch):
    """A fresh process-wide checkpointer and flight recorder, no
    telemetry spool."""
    monkeypatch.delenv('XSKY_CKPT_DIR', raising=False)
    monkeypatch.delenv('XSKY_TELEMETRY_DIR', raising=False)
    checkpointd.reset_for_test()
    flight_recorder.reset_for_test()
    yield
    checkpointd.reset_for_test()


def _launch_args(*flags):
    return launch.parse_args(['--model', 'deepseek-tiny',
                              '--global-batch-size', '2', '--seq-len', '16',
                              '--log-every', '1', '--device', 'cpu']
                             + [str(f) for f in flags])


def test_deepseek_launch_resumes_bit_for_bit(isolated, tmp_path, caplog):
    """deepseek-tiny as named (bf16, synthetic batches): 4 steps
    straight, or 2 with checkpoints and then --resume auto to 4; the
    resumed losses and the final tree equal the uninterrupted run's."""
    solid = launch.run(_launch_args('--steps', 4))
    ckpt = str(tmp_path / 'ckpt')
    launch.run(_launch_args('--steps', 2, '--checkpoint-every', 1,
                            '--checkpoint-dir', ckpt))
    with caplog.at_level(logging.INFO, logger=launch.__name__):
        resumed = launch.run(_launch_args('--steps', 4, '--resume', 'auto',
                                          '--checkpoint-dir', ckpt))
    assert 'Resumed from checkpoint step 2.' in caplog.text
    assert resumed['losses'] == {k: solid['losses'][k] for k in (3, 4)}
    assert all(np.isfinite(v) for v in solid['losses'].values())
    final, again = (_flat(run['state']['params']) for run in (solid,
                                                              resumed))
    assert final['/moe_layers/router'].dtype == torch.float32
    for key, t in final.items():
        assert torch.equal(t, again[key]), key


def test_deepseek_lora_launch_trains_the_mla_adapters(isolated):
    """--lora-rank 4 --lora-targets w_uq,w_ukv,wo: the adapters cover
    the dense and the routed layers' MLA weights, the optimizer holds
    adapter-sized tensors only, and the loss is finite."""
    out = launch.run(_launch_args('--steps', 2, '--lora-rank', 4,
                                  '--lora-targets', ','.join(MLA_TARGETS)))
    adapters = _flat(out['state']['params'])
    assert {key.rsplit('/', 1)[0] for key in adapters} == {
        '/dense_layers/w_uq', '/dense_layers/w_ukv', '/dense_layers/wo',
        '/moe_layers/w_uq', '/moe_layers/w_ukv', '/moe_layers/wo'}
    shapes = {tuple(t.shape) for t in adapters.values()}
    opt = []

    def walk(x):
        if torch.is_tensor(x):
            opt.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(out['state']['opt_state'])
    assert opt and all(tuple(t.shape) in shapes for t in opt if t.ndim)
    assert all(np.isfinite(v) for v in out['losses'].values())


def test_pipelined_loss_is_refused_naming_its_item(trees):
    _, tcfg = _configs('deepseek-tiny-moe-only')
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match='queue 1 item 8'):
        deepseek.pipelined_loss_fn(tcfg, _port(trees[
            'deepseek-tiny-moe-only']), tokens, tokens, None, 2)
