"""Gemma training in the PyTorch port vs the JAX reference, on the CPU.

* The flash gradient at head_dim 256 (every Gemma's): ``jax.grad`` of
  ``skypilot_tpu.ops.flash_attention.flash_attention`` (the Pallas
  kernels in interpret mode, blocks of 128) against the port's
  ``flash_attention``, whose backward on CPU tensors is
  ``flash_attention_bwd_plain``, at S 256 with Gemma-2's options
  (softcap 50, a window, scale 1/16) over GQA groups 1, 2 and 8.
* Three ``Trainer`` steps against the JAX ``Trainer`` on a one-device
  mesh: fp32 ``gemma-tiny``, ``gemma2-tiny`` and ``gemma2-tiny`` at
  head_dim 256 (``dataclasses.replace``, on both sides).
* ``train/launch.py --model gemma2-tiny --device cpu``: a resumed run's
  losses equal an uninterrupted run's bit for bit; and the JAX and the
  port's launchers, each from its own converter's output for one tiny
  Gemma-2 checkpoint in HF's layout (written here), give the same losses.
* LoRA on ``gemma2-tiny`` against the JAX LoRA: the loss, the adapters'
  gradients, three ``Trainer`` steps, and the frozen base bit for bit.

Inputs and batches come from numpy seeds; weights from the JAX ``init``
(fp32) cross with ``params_from_numpy``. Tolerances, fp32 on both sides,
sums in another order: flash gradients 2e-5 absolute (their largest
elements reach 12, and the two sides differ by at most 3.4e-6 here);
losses 1e-5, grad norms 1e-5 relative, parameters after three steps
5e-5 absolute (as test_torch_train.py and test_torch_lora.py); adapter
gradients 2e-5 absolute; the two launchers' losses 1e-4 (as
test_torch_launch.py).

Every test here runs under a hard time limit of its own (``_time_limit``).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import gemma as jax_gemma
from skypilot_tpu.ops import flash_attention as jax_flash
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import lora as jax_lora
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch import models
from skypilot_tpu_torch.agent import checkpointd
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.models import gemma
from skypilot_tpu_torch.ops import flash_attention
from skypilot_tpu_torch.train import launch
from skypilot_tpu_torch.train import lora
from skypilot_tpu_torch.train import trainer

TEST_LIMIT_S = 120
FLASH_GRAD_ATOL = 2e-5
LOSS_ATOL = 1e-5
NORM_RTOL = 1e-5
PARAM_ATOL = 5e-5
ADAPTER_GRAD_ATOL = 2e-5
CROSS_LOSS_ATOL = 1e-4
# The tiny Gemma configs of both packages in fp32; 'gemma2-tiny-d256'
# has 4 heads of 256 over d_model 64, as phase [29] of chip_smoke.py.
VARIANTS = {'gemma-tiny': ('gemma-tiny', {}),
            'gemma2-tiny': ('gemma2-tiny', {}),
            'gemma2-tiny-d256': ('gemma2-tiny', dict(head_dim=256))}


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
    base, extra = VARIANTS[name]
    kw = {**extra, **kw}
    return (dataclasses.replace(jax_gemma.CONFIGS[base], dtype=jnp.float32,
                                **kw),
            dataclasses.replace(gemma.CONFIGS[base], dtype=torch.float32,
                                **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    return gemma.params_from_numpy(_np(tree), 'cpu')


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f'{prefix}/{key}'))
        return out
    return {prefix: tree}


def _batch(seed, b=4, s=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    return {'tokens': tokens, 'targets': np.roll(tokens, -1, axis=1)}


def _mesh():
    plan = mesh_lib.MeshPlan(data=1)
    return plan, mesh_lib.build_mesh(plan, devices=jax.devices()[:1])


def _assert_trees_close(got, want, atol):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(w),
                                   atol=atol, err_msg=key)


# ---- the flash gradient at head_dim 256 ----

@pytest.mark.parametrize('groups', [1, 2, 8])
def test_flash_gradient_matches_jax_at_head_dim_256(groups):
    """S 256, 8 query heads over 8 / groups KV heads, Gemma-2's softcap
    50 and scale 1/16, a window of 100; segment ids at group 2."""
    b, s, h, d = 1, 256, 8, 256
    rng = np.random.default_rng(groups)
    q, dout = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((b, s, h // groups, d)).astype(np.float32)
            for _ in range(2))
    seg = None
    if groups == 2:
        seg = (np.arange(s)[None, :] >= 150).astype(np.int32)
    kw = dict(causal=True, window=100, logit_softcap=50.0, scale=1 / 16)

    def loss(q_, k_, v_):
        out = jax_flash.flash_attention(
            q_, k_, v_, block_q=128, block_kv=128,
            segment_ids=None if seg is None else jnp.asarray(seg), **kw)
        return jnp.sum(out * jnp.asarray(dout))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention.flash_attention(
        tq, tk, tv, segment_ids=None if seg is None else torch.from_numpy(
            seg), **kw)
    out.backward(torch.from_numpy(dout))
    for name, g, w in zip('qkv', (tq.grad, tk.grad, tv.grad), want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=FLASH_GRAD_ATOL, err_msg=f'd{name}')


# ---- Trainer steps ----

TRAINER_CASES = {
    'gemma-tiny': dict(),
    'gemma2-tiny': dict(optimizer='adafactor', accum_steps=2),
    'gemma2-tiny-d256': dict(optimizer='adafactor', accum_steps=2),
}


@pytest.mark.parametrize('name', sorted(TRAINER_CASES))
def test_trainer_steps_match_jax(name):
    """Three steps (24 tokens a row, past Gemma-2's window of 8): loss
    and grad norm each step, then every parameter."""
    jcfg, tcfg = _configs(name)
    plan, mesh = _mesh()
    common = dict(global_batch_size=4, seq_len=24, learning_rate=1e-3,
                  warmup_steps=2, **TRAINER_CASES[name])
    jtr = jax_trainer.Trainer(
        jax_trainer.TrainConfig(model=jcfg, mesh_plan=plan, **common),
        mesh=mesh)
    ttr = trainer.Trainer(trainer.TrainConfig(model=tcfg, **common),
                          device='cpu')
    state_j = jtr.init_state()
    state_t = ttr.init_state(_to_torch(state_j['params']))
    for step in range(3):
        batch = _batch(10 + step)
        state_j, m_j = jtr.step(state_j, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        state_t, m_t = ttr.step(state_t, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        assert float(m_t['loss']) == pytest.approx(float(m_j['loss']),
                                                   abs=LOSS_ATOL)
        assert float(m_t['grad_norm']) == pytest.approx(
            float(m_j['grad_norm']), rel=NORM_RTOL)
    _assert_trees_close(state_t['params'], state_j['params'], PARAM_ATOL)


# ---- the launcher ----

@pytest.fixture
def isolated(tmp_path, monkeypatch):
    """A fresh process-wide checkpointer and flight recorder, no
    telemetry spool, the native loader's cache under tmp_path."""
    monkeypatch.setenv('XSKY_NATIVE_CACHE', str(tmp_path / 'native'))
    monkeypatch.delenv('XSKY_CKPT_DIR', raising=False)
    monkeypatch.delenv('XSKY_TELEMETRY_DIR', raising=False)
    checkpointd.reset_for_test()
    flight_recorder.reset_for_test()
    yield
    checkpointd.reset_for_test()


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp('tokens')
    rng = np.random.default_rng(0)
    for i in range(2):
        rng.integers(0, 256, 1500).astype('<u4').tofile(
            root / f'part-{i}.bin')
    return str(root)


def _launch_args(*flags):
    return launch.parse_args(['--model', 'gemma2-tiny', '--global-batch-size',
                              '2', '--seq-len', '16', '--log-every', '1',
                              '--device', 'cpu'] + [str(f) for f in flags])


def test_gemma2_launch_resumes_bit_for_bit(isolated, shards, tmp_path,
                                           caplog):
    """gemma2-tiny as named (bf16) over token shards: 5 steps straight,
    or 3 with checkpoints and then --resume auto to 5; the resumed steps'
    losses and the final tree (tied embedding, the four norms a layer)
    equal the uninterrupted run's."""
    flags = ['--data', shards, '--data-loader', 'python', '--optimizer',
             'adafactor']
    solid = launch.run(_launch_args('--steps', 5, *flags))
    ckpt = str(tmp_path / 'ckpt')
    first = launch.run(_launch_args('--steps', 3, '--checkpoint-every', 1,
                                    '--checkpoint-dir', ckpt, *flags))
    with caplog.at_level(logging.INFO, logger=launch.__name__):
        resumed = launch.run(_launch_args('--steps', 5, '--resume', 'auto',
                                          '--checkpoint-dir', ckpt, *flags))
    assert 'Resumed from checkpoint step 3.' in caplog.text
    assert resumed['start_step'] == 3
    assert first['losses'] == {k: solid['losses'][k] for k in (1, 2, 3)}
    assert resumed['losses'] == {k: solid['losses'][k] for k in (4, 5)}
    final = _flat(solid['state']['params'])
    assert {'/embed', '/layers/post_attn_norm', '/layers/post_ffw_norm'} <= (
        set(final))
    again = _flat(resumed['state']['params'])
    assert set(again) == set(final)
    for key, t in final.items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, again[key]), key


def _write_hf_gemma2(root):
    """gemma2-tiny's widths in HF's Gemma-2 layout: config.json and one
    safetensors file of fp32 weights from a numpy seed, no lm_head
    (tied), the four norms a layer."""
    from safetensors.numpy import save_file
    cfg = gemma.GEMMA2_TINY
    rng = np.random.default_rng(7)
    d, hd = cfg.d_model, cfg.head_dim

    def draw(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    tensors = {'model.embed_tokens.weight': draw(cfg.vocab_size, d),
               'model.norm.weight': draw(d)}
    for i in range(cfg.n_layers):
        p = f'model.layers.{i}.'
        tensors.update({
            p + 'self_attn.q_proj.weight': draw(cfg.n_heads * hd, d),
            p + 'self_attn.k_proj.weight': draw(cfg.n_kv_heads * hd, d),
            p + 'self_attn.v_proj.weight': draw(cfg.n_kv_heads * hd, d),
            p + 'self_attn.o_proj.weight': draw(d, cfg.n_heads * hd),
            p + 'mlp.gate_proj.weight': draw(cfg.d_ff, d),
            p + 'mlp.up_proj.weight': draw(cfg.d_ff, d),
            p + 'mlp.down_proj.weight': draw(d, cfg.d_ff),
            **{p + f'{n}.weight': draw(d) for n in (
                'input_layernorm', 'post_attention_layernorm',
                'pre_feedforward_layernorm', 'post_feedforward_layernorm')}})
    config = {'model_type': 'gemma2', 'vocab_size': cfg.vocab_size,
              'hidden_size': d, 'intermediate_size': cfg.d_ff,
              'num_hidden_layers': cfg.n_layers,
              'num_attention_heads': cfg.n_heads,
              'num_key_value_heads': cfg.n_kv_heads, 'head_dim': hd,
              'max_position_embeddings': cfg.max_seq_len,
              'rope_theta': cfg.rope_theta, 'rms_norm_eps': cfg.norm_eps,
              'tie_word_embeddings': True, 'query_pre_attn_scalar': 24,
              'sliding_window': cfg.sliding_window,
              'attn_logit_softcapping': cfg.attn_logit_softcap,
              'final_logit_softcapping': cfg.final_logit_softcap}
    root.mkdir(parents=True)
    (root / 'config.json').write_text(json.dumps(config))
    save_file(tensors, str(root / 'model.safetensors'))
    return str(root)


def test_both_launchers_give_the_same_gemma2_losses(isolated, shards,
                                                    tmp_path, monkeypatch):
    """The JAX and the port's launchers, in-process, on the same token
    shards (python loader), each from its own converter's fp32 output for
    one HF-layout gemma2-tiny checkpoint, ``gemma2-tiny`` in fp32 in both
    (``get_config`` patched): per-step losses within CROSS_LOSS_ATOL."""
    from skypilot_tpu import models as jax_models
    from skypilot_tpu.models import convert as jax_convert
    from skypilot_tpu.train import launch as jax_launch
    from skypilot_tpu_torch.models import convert
    monkeypatch.setenv('XSKY_STATE_DB', str(tmp_path / 'state.db'))
    jcfg, tcfg = _configs('gemma2-tiny')
    monkeypatch.setattr(jax_models, 'get_config', lambda name: jcfg)
    monkeypatch.setattr(models, 'get_config', lambda name: tcfg)
    src = _write_hf_gemma2(tmp_path / 'hf')
    jax_convert.main(['--src', src, '--out', str(tmp_path / 'jax-params'),
                      '--dtype', 'f32'])
    convert.main(['--src', src, '--out', str(tmp_path / 'port-params'),
                  '--dtype', 'f32', '--device', 'cpu'])
    common = ['--model', 'gemma2-tiny', '--global-batch-size', '8',
              '--seq-len', '16', '--steps', '3', '--log-every', '1',
              '--optimizer', 'adamw', '--learning-rate', '1e-2', '--data',
              shards, '--data-loader', 'python']
    monkeypatch.setattr(sys, 'argv', ['launch'] + common + [
        '--init-params', str(tmp_path / 'jax-params'),
        '--metrics-file', str(tmp_path / 'jax.jsonl')])
    assert jax_launch.main() == 0
    launch.main(common + ['--init-params', str(tmp_path / 'port-params'),
                          '--metrics-file', str(tmp_path / 'port.jsonl'),
                          '--device', 'cpu'])
    rows = {name: [json.loads(line) for line in
                   (tmp_path / f'{name}.jsonl').read_text().splitlines()]
            for name in ('jax', 'port')}
    assert [r['step'] for r in rows['port']] == [1, 2, 3]
    for got, want in zip(rows['port'], rows['jax']):
        assert got['loss'] == pytest.approx(want['loss'],
                                            abs=CROSS_LOSS_ATOL)
    # The converted weights, not a random init, started both runs.
    assert rows['port'][0]['loss'] != pytest.approx(np.log(256), abs=1e-3)


# ---- LoRA ----

LORA_TARGETS = ('wq', 'wk', 'wv', 'wo')


def test_gemma2_lora_loss_and_adapter_gradients_match_jax():
    jcfg, tcfg = _configs('gemma2-tiny')
    base = jax_gemma.init(jcfg, jax.random.PRNGKey(1))
    adapters = jax_lora.init_lora(base, 4, jax.random.PRNGKey(2),
                                  targets=LORA_TARGETS)
    # Non-zero B, so the gradients of A are exercised too.
    adapters = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                               x.shape), adapters)
    batch = _batch(4, b=2)

    def loss_j(ad):
        merged = jax_lora.merge(jax.lax.stop_gradient(base), ad, 32.0, 4)
        return jax_gemma.loss_fn(jcfg, merged, jnp.asarray(batch['tokens']),
                                 jnp.asarray(batch['targets']))

    lj, gj = jax.value_and_grad(loss_j)(adapters)
    tad = _to_torch(adapters)
    leaves = trainer.param_leaves(tad)
    for p in leaves:
        p.requires_grad_(True)
    lt = gemma.loss_fn(tcfg, lora.merge(_to_torch(base), tad, 32.0, 4),
                       torch.from_numpy(batch['tokens']),
                       torch.from_numpy(batch['targets']))
    grads = dict(zip(_flat(tad), torch.autograd.grad(lt, leaves)))
    assert float(lt.detach()) == pytest.approx(float(lj), abs=LOSS_ATOL)
    want = _flat(gj)
    assert set(grads) == set(want)
    for key, g in want.items():
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(g),
                                   atol=ADAPTER_GRAD_ATOL, err_msg=key)


def test_three_gemma2_lora_trainer_steps_match_jax():
    """Only the adapters train, as in the reference; the base stays
    bit-identical and the optimizer holds adapter-sized tensors only."""
    jcfg, tcfg = _configs('gemma2-tiny')
    plan, mesh = _mesh()
    common = dict(global_batch_size=4, seq_len=24, learning_rate=1e-3,
                  warmup_steps=2, lora_rank=4, lora_alpha=32.0,
                  lora_targets=LORA_TARGETS)
    jtr = jax_trainer.Trainer(
        jax_trainer.TrainConfig(model=jcfg, mesh_plan=plan, **common),
        mesh=mesh)
    ttr = trainer.Trainer(trainer.TrainConfig(model=tcfg, **common),
                          device='cpu')
    state_j = jtr.init_state()
    base0 = _np(state_j['base'])
    state_t = ttr.init_state(_to_torch(state_j['base']),
                             adapters=_to_torch(state_j['params']))
    for step in range(3):
        batch = _batch(30 + step)
        state_j, m_j = jtr.step(state_j, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        state_t, m_t = ttr.step(state_t, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        assert float(m_t['loss']) == pytest.approx(float(m_j['loss']),
                                                   abs=LOSS_ATOL)
        assert float(m_t['grad_norm']) == pytest.approx(
            float(m_j['grad_norm']), rel=NORM_RTOL)
    _assert_trees_close(state_t['params'], state_j['params'], PARAM_ATOL)
    adapter_shapes = {tuple(p.shape)
                      for p in trainer.param_leaves(state_t['params'])}
    for key, w in _flat(base0).items():
        t = _flat(state_t['base'])[key]
        assert not t.requires_grad and t.grad is None
        np.testing.assert_array_equal(t.numpy(), w, err_msg=key)
    opt = [t for t in jax.tree_util.tree_leaves(state_t['opt_state'])
           if torch.is_tensor(t) and t.ndim]
    assert opt and all(tuple(t.shape) in adapter_shapes for t in opt)
