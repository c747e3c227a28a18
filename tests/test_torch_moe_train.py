"""Mixtral training in the PyTorch port (``models/moe.py``) vs the JAX
reference, on the CPU, at fp32 ``moe-tiny`` (4 experts, 2 a token).

* The routed MLP's gathers: their gradients (gathers too) against
  autograd's scatter-add, zero for a token whose choices all dropped.
* The router's load-balance term alone: ``route(..., with_aux=True)``
  against the third output of the reference's ``route``, without a mask,
  with a token mask, and with a capacity that drops real tokens (the
  term counts dropped choices too).
* ``forward(return_aux=True)``: logits and the layers' mean term.
* ``loss_fn`` and the gradient of every leaf (the router included)
  against ``jax.value_and_grad`` of the reference's ``loss_fn``, with a
  ``token_mask``, a ``loss_mask`` and a capacity that drops real tokens.
* remat on against remat off: the same loss and gradients, and the
  products of the 2-D weights (wq, wk, wv, wo, the router) kept, not
  recomputed, while the batched expert products are.
* Three ``Trainer`` steps against the JAX ``Trainer`` on a one-device
  mesh (adamw; and a batch with ``token_mask`` and ``mask`` accumulated
  over two microbatches).
* ``train/launch.py --model moe-tiny --device cpu``: a run resumed from
  its checkpoint equals an uninterrupted one bit for bit.
* ``pipelined_loss_fn`` raises, naming ROADMAP.md queue 1 item 8.

Weights come from the JAX ``init`` in fp32 with the norm scales redrawn
from a numpy seed and cross with ``params_from_numpy``; inputs are numpy
arrays from a seed. Tolerances (fp32 on both sides, sums in another
order): the aux term 1e-6, logits 1e-4 (as test_torch_moe.py), losses
1e-5, gradients 2e-5 absolute, grad norms 1e-5 relative, parameters after
three steps 5e-5 absolute (as test_torch_train.py); remat on and off
1e-6.

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

from skypilot_tpu.models import moe as jax_moe
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.agent import checkpointd
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.train import launch
from skypilot_tpu_torch.train import trainer

TEST_LIMIT_S = 120
AUX_ATOL = 1e-6
LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5
NORM_RTOL = 1e-5
PARAM_ATOL = 5e-5
REMAT_ATOL = 1e-6
B, S = 2, 16


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


def _configs(**kw):
    return (dataclasses.replace(jax_moe.MOE_TINY, dtype=jnp.float32, **kw),
            dataclasses.replace(moe.MOE_TINY_F32, **kw))


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f'{prefix}/{key}'))
        return out
    return {prefix: tree}


@pytest.fixture(scope='module')
def tree():
    """The JAX init in fp32 as numpy arrays, norms redrawn."""
    jcfg, _ = _configs()
    out = jax.tree_util.tree_map(
        np.asarray, jax_moe.init(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(101)
    for key in ('attn_norm', 'mlp_norm'):
        shape = out['layers'][key].shape
        out['layers'][key] = (1 + 0.2 * rng.standard_normal(shape)).astype(
            np.float32)
    return out


def _port(tree):
    return moe.params_from_numpy(tree, 'cpu')


def _batch(seed, b=B, s=S, masked=False):
    """Tokens and targets; with ``masked`` a loss mask and a token mask
    whose rows end in pads."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    batch = {'tokens': tokens, 'targets': np.roll(tokens, -1, axis=1)}
    if masked:
        batch['mask'] = (rng.random((b, s)) < 0.6).astype(np.float32)
        real = np.ones((b, s), np.float32)
        for row in range(b):
            real[row, s - 3 - 2 * row:] = 0.0
        batch['token_mask'] = real
    return batch


# ---- the load-balance term ----

ROUTE_CASES = {
    'no-mask': dict(capacity=None, masked=False),
    'token-mask': dict(capacity=None, masked=True),
    'forced-drop': dict(capacity=4, masked=False),
    'token-mask-and-drop': dict(capacity=4, masked=True),
}


@pytest.mark.parametrize('case', sorted(ROUTE_CASES))
def test_aux_term_matches_the_reference_route(tree, case):
    kw = ROUTE_CASES[case]
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(3)
    t = 40
    x = rng.standard_normal((t, tcfg.d_model)).astype(np.float32)
    mask = np.ones(t, np.float32)
    if kw['masked']:
        mask[25:] = 0.0
    router = tree['layers']['router'][0]
    _, _, want = jax_moe.route(
        jcfg, jnp.asarray(router), jnp.asarray(x),
        token_mask=jnp.asarray(mask) if kw['masked'] else None,
        capacity=kw['capacity'])
    r = moe.route(tcfg, torch.from_numpy(router), torch.from_numpy(x),
                  token_mask=torch.from_numpy(mask) if kw['masked'] else None,
                  capacity=kw['capacity'], with_aux=True)
    assert r.aux.dtype == torch.float32 and r.aux.ndim == 0
    assert float(r.aux) == pytest.approx(float(want), abs=AUX_ATOL)
    if kw['capacity'] is not None:
        real = mask.astype(bool)[:, None]
        assert (real & ~r.keep.numpy()).any(), 'no real choice was dropped'
    # Serving's routing is unchanged and computes no term.
    plain = moe.route(tcfg, torch.from_numpy(router), torch.from_numpy(x),
                      capacity=kw['capacity'])
    assert plain.aux is None


def test_aux_term_is_one_at_perfect_balance():
    """Every expert gets the same share of choices and the same mean
    probability: E * sum(1/E * 1/E) * k / k = 1."""
    _, tcfg = _configs()
    e, d = tcfg.n_experts, tcfg.d_model
    x = torch.eye(d)[:e].repeat(3, 1)                    # 12 tokens
    router = torch.zeros((d, e))
    router[:e, :e] = 5.0 * torch.eye(e) + 4.0 * torch.roll(torch.eye(e), 1, 1)
    r = moe.route(tcfg, router, x, with_aux=True)
    assert float(r.aux) == pytest.approx(1.0, abs=1e-6)


def test_dispatch_and_combine_gradients_are_the_transposes():
    """The routed MLP's gathers take gathers as their gradients: equal to
    autograd's scatter-add of the same indexing at fp32, and exactly zero
    for a token whose every choice was dropped."""
    _, tcfg = _configs()
    gen = torch.Generator()
    gen.manual_seed(11)
    t, d, k, e, cap = 24, tcfg.d_model, 2, 4, 4
    x = torch.randn((t, d), generator=gen, requires_grad=True)
    expert = torch.randint(0, e, (t, k), generator=gen)
    place = torch.randint(0, 2 * cap, (t, k), generator=gen)
    # Distinct places among the kept choices, as route() gives them.
    dest = torch.full((t * k,), e * cap, dtype=torch.long)
    used = set()
    for i, (ex, pl) in enumerate(zip(expert.reshape(-1).tolist(),
                                     place.reshape(-1).tolist())):
        if pl < cap and (ex, pl) not in used:
            used.add((ex, pl))
            dest[i] = ex * cap + pl
    dest[:k] = e * cap                         # token 0: every choice dropped
    choice = torch.full((e * cap + 1,), t * k, dtype=torch.long)
    choice[dest] = torch.arange(t * k)
    choice = choice[:e * cap]
    w = torch.randn((d, d), generator=gen, requires_grad=True)
    up = torch.randn((e * cap, d), generator=gen)
    grads = []
    for dispatch, combine in (
            (lambda: moe._Dispatch.apply(x, choice, dest, k),
             lambda y: moe._Combine.apply(y, dest, choice)),
            (lambda: torch.cat([x, x.new_zeros((1, d))])[choice // k],
             lambda y: torch.cat([y, y.new_zeros((1, d))])[dest])):
        y = torch.tanh(dispatch() @ w) * up
        loss = (combine(y).reshape(t, k, d) ** 2).sum()
        grads.append(torch.autograd.grad(loss, (x, w)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-6)
    assert torch.equal(grads[0][0][0], torch.zeros(d))


# ---- forward and the loss ----

def test_forward_return_aux_matches_jax(tree):
    jcfg, tcfg = _configs()
    batch = _batch(5, masked=True)
    jl, ja = jax_moe.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(batch['tokens']), return_aux=True,
                             token_mask=jnp.asarray(batch['token_mask']))
    tl, ta = moe.forward(tcfg, _port(tree), torch.from_numpy(batch['tokens']),
                         return_aux=True,
                         token_mask=torch.from_numpy(batch['token_mask']))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    assert float(ta) == pytest.approx(float(ja), abs=AUX_ATOL)
    # Without the term the logits are the same and nothing else returns.
    logits = moe.forward(tcfg, _port(tree), torch.from_numpy(batch['tokens']),
                         token_mask=torch.from_numpy(batch['token_mask']))
    assert torch.equal(logits, tl)


LOSS_CASES = {
    'plain': dict(),
    'masks-and-drop': dict(masked=True, capacity_factor=0.5),
}


@pytest.fixture(scope='module')
def jax_losses(tree):
    """jax.value_and_grad of the reference's loss_fn for each case."""
    out = {}
    for case, kw in LOSS_CASES.items():
        kw = dict(kw)
        masked = kw.pop('masked', False)
        jcfg, _ = _configs(**kw)
        batch = _batch(7, masked=masked)

        def loss(p, batch=batch, jcfg=jcfg, masked=masked):
            return jax_moe.loss_fn(
                jcfg, p, jnp.asarray(batch['tokens']),
                jnp.asarray(batch['targets']),
                loss_mask=jnp.asarray(batch['mask']) if masked else None,
                token_mask=(jnp.asarray(batch['token_mask']) if masked
                            else None))

        out[case] = jax.value_and_grad(loss)(
            jax.tree_util.tree_map(jnp.asarray, tree))
    return out


def _port_loss(cfg, params, batch, masked):
    return moe.loss_fn(
        cfg, params, torch.from_numpy(batch['tokens']),
        torch.from_numpy(batch['targets']),
        loss_mask=torch.from_numpy(batch['mask']) if masked else None,
        token_mask=torch.from_numpy(batch['token_mask']) if masked else None)


@pytest.mark.parametrize('case', sorted(LOSS_CASES))
def test_loss_and_every_gradient_match_jax(tree, jax_losses, case):
    kw = dict(LOSS_CASES[case])
    masked = kw.pop('masked', False)
    _, tcfg = _configs(**kw)
    batch = _batch(7, masked=masked)
    params = _port(tree)
    leaves = _flat(params)
    for p in leaves.values():
        p.requires_grad_(True)
    if 'capacity_factor' in kw:
        # The capacity really drops real tokens' choices.
        x = torch.randn(B * S, tcfg.d_model)
        r = moe.route(tcfg, params['layers']['router'][0].detach(), x)
        assert not bool(r.keep.all())
    loss = _port_loss(tcfg, params, batch, masked)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    want_loss, want_grads = jax_losses[case]
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 abs=LOSS_ATOL)
    want = _flat(want_grads)
    assert set(grads) == set(want) and '/layers/router' in want
    for key, g in want.items():
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(g),
                                   atol=GRAD_ATOL, err_msg=key)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0
        self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        elif func is torch.ops.aten.bmm.default:
            self.bmm += 1
        return func(*args, **(kwargs or {}))


def test_remat_gives_the_same_loss_and_gradients(tree):
    """remat keeps the products of the layer's 2-D weights whatever
    remat_policy says (the reference's dots_with_no_batch_dims_saveable):
    the backward recomputes no mm, but each layer's batched products
    again: the plain attention's two and the experts' gate, up and down
    (the recompute stops before the combine product, whose output no
    gradient needs)."""
    batch = _batch(9, masked=True)
    results = []
    for remat in (False, True):
        _, tcfg = _configs(remat=remat, remat_policy='none')
        params = _port(tree)
        leaves = list(_flat(params).values())
        for p in leaves:
            p.requires_grad_(True)
        loss = _port_loss(tcfg, params, batch, masked=True)
        with _CountProducts() as count:
            grads = torch.autograd.grad(loss, leaves)
        results.append((loss.detach(), grads, count.mm, count.bmm))
    (l0, g0, mm0, bmm0), (l1, g1, mm1, bmm1) = results
    assert float(l1) == pytest.approx(float(l0), abs=REMAT_ATOL)
    for got, want in zip(g1, g0):
        torch.testing.assert_close(got, want, atol=REMAT_ATOL, rtol=0)
    assert mm1 == mm0
    assert bmm1 - bmm0 == 5 * moe.MOE_TINY.n_layers


# ---- Trainer steps ----

TRAINER_CASES = {
    'adamw': dict(),
    'masked-accum-2': dict(accum_steps=2, masked=True),
}


@pytest.mark.parametrize('case', sorted(TRAINER_CASES))
def test_trainer_steps_match_jax(case):
    """Three steps: loss and grad norm each step, then every parameter."""
    kw = dict(TRAINER_CASES[case])
    masked = kw.pop('masked', False)
    jcfg, tcfg = _configs()
    plan = mesh_lib.MeshPlan(data=1)
    common = dict(global_batch_size=4, seq_len=S, learning_rate=1e-3,
                  warmup_steps=2, **kw)
    jtr = jax_trainer.Trainer(
        jax_trainer.TrainConfig(model=jcfg, mesh_plan=plan, **common),
        mesh=mesh_lib.build_mesh(plan, devices=jax.devices()[:1]))
    ttr = trainer.Trainer(trainer.TrainConfig(model=tcfg, **common),
                          device='cpu')
    state_j = jtr.init_state()
    state_t = ttr.init_state(_port(jax.tree_util.tree_map(
        np.asarray, state_j['params'])))
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
    return launch.parse_args(['--model', 'moe-tiny', '--global-batch-size',
                              '2', '--seq-len', '16', '--log-every', '1',
                              '--device', 'cpu'] + [str(f) for f in flags])


def test_moe_launch_resumes_bit_for_bit(isolated, tmp_path, caplog):
    """moe-tiny as named (bf16, synthetic batches): 4 steps straight, or
    2 with checkpoints and then --resume auto to 4; the resumed losses
    and the final tree (the fp32 router included) equal the
    uninterrupted run's."""
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
    assert final['/layers/router'].dtype == torch.float32
    for key, t in final.items():
        assert torch.equal(t, again[key]), key


def test_pipelined_loss_is_refused_naming_its_item(tree):
    _, tcfg = _configs()
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match='queue 1 item 8'):
        moe.pipelined_loss_fn(tcfg, _port(tree), tokens, tokens, None, 2)
