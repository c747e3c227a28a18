"""PyTorch port's sequence classifier vs the JAX reference, on the CPU.

``skypilot_tpu_torch/train/classify.py`` against
``skypilot_tpu/train/classify.py`` at LLAMA_TINY (max_seq_len 32, fp32),
C = 2 and 3: ``logits_fn``, ``_loss`` and the gradient of every leaf with
ragged lengths; three AdamW steps in full mode (``lm_head``, which the
loss never reads, decays as optax decays it) and head-only (the trunk
bit-identical); ``jsonl_batches`` bit for bit; the synthetic set's
classes and bands; the CLI's JSON line; the refusal without a card.

Weights come from the JAX ``init`` and cross with ``params_from_numpy``;
batches are numpy arrays from a seed. Tolerances are those of
``tests/test_torch_train.py`` (fp32 on both sides, sums in another
order): loss 1e-5 and gradients 2e-5 absolute, parameters after three
AdamW steps 5e-5 absolute (Adam normalizes each element by its own
gradient history, so a nearly cancelling gradient's relative rounding
error reaches the update). Every test runs under its own 120 s SIGALRM.
"""
from __future__ import annotations

import dataclasses
import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.train import classify as jax_classify
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.train import classify
from skypilot_tpu_torch.train import optim

LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5
PARAM_ATOL = 5e-5
TEST_LIMIT_S = 120
SEQ = 32
LR = 1e-3
WEIGHT_DECAY = 0.1


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


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for the port's tiny models. Under a whole run's
    load (six pytest workers and the gang tests' rank processes on the
    same cores) torch's OpenMP threads wait on one another at every small
    op: the 60-step training test took 94.6-120 s there against 2 s alone
    (0.8 s on one thread, 35 s on the default threads beside eight busy
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _configs(num_classes, **kw):
    jmodel = dataclasses.replace(jax_llama.LLAMA_TINY, max_seq_len=SEQ,
                                 dtype=jnp.float32)
    tmodel = dataclasses.replace(llama.LLAMA_TINY, max_seq_len=SEQ,
                                 dtype=torch.float32)
    common = dict(num_classes=num_classes, seq_len=SEQ, batch_size=4,
                  learning_rate=LR, weight_decay=WEIGHT_DECAY, **kw)
    return (jax_classify.ClassifyConfig(model=jmodel, **common),
            classify.ClassifyConfig(model=tmodel, **common))


@pytest.fixture(scope='module')
def jax_params():
    """The JAX init tree as numpy arrays, per class count."""
    out = {}
    for c in (2, 3):
        jcfg, _ = _configs(c)
        out[c] = jax.tree_util.tree_map(
            np.asarray, jax_classify.init(jcfg, jax.random.PRNGKey(c)))
    return out


def _batch(seed, num_classes, b=4, ragged=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 256, (b, SEQ)).astype(np.int32)
    true_len = (rng.integers(1, SEQ + 1, b) if ragged
                else np.full(b, SEQ)).astype(np.int32)
    for row, n in enumerate(true_len):
        tokens[row, n:] = 0
    label = rng.integers(0, num_classes, b).astype(np.int32)
    return {'tokens': tokens, 'true_len': true_len, 'label': label}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f'{prefix}/{k}'))
        return out
    return {prefix: tree}


@pytest.mark.parametrize('num_classes', [2, 3])
def test_logits_loss_and_every_gradient_match_jax(jax_params, num_classes):
    jcfg, tcfg = _configs(num_classes)
    tree = jax_params[num_classes]
    batch = _batch(num_classes, num_classes)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    want_logits = jax_classify.logits_fn(jcfg, jparams,
                                         jnp.asarray(batch['tokens']),
                                         jnp.asarray(batch['true_len']))
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jax_classify._loss(jcfg, p, _to_jax(batch)))(jparams)

    params = classify.params_from_numpy(tree, 'cpu')
    leaves = _leaves(params)
    for p in leaves.values():
        p.requires_grad_(True)
    tb = _to_torch(batch)
    logits = classify.logits_fn(tcfg, params, tb['tokens'], tb['true_len'])
    assert logits.dtype == torch.float32
    assert logits.shape == (4, num_classes)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=LOSS_ATOL)
    loss = classify._loss(tcfg, params, tb)
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 abs=LOSS_ATOL)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    want = _leaves(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(want) == set(leaves)
    for name, g in zip(leaves, grads):
        if g is None:
            # The loss never reads the LM head: JAX's gradient is zeros.
            assert name == '/trunk/lm_head'
            assert not want[name].any()
            continue
        np.testing.assert_allclose(g.numpy(), want[name], atol=GRAD_ATOL,
                                   err_msg=name)


def _jax_steps(jcfg, tree, batches):
    tx = optax.adamw(LR, weight_decay=WEIGHT_DECAY)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = jax_classify.init_opt_state(jcfg, tx, params)
    step = jax_classify.make_train_step(jcfg, tx)
    losses = []
    for batch in batches:
        params, opt_state, loss = step(params, opt_state, _to_jax(batch))
        losses.append(float(loss))
    return losses, _leaves(jax.tree_util.tree_map(np.asarray, params))


def _port_steps(tcfg, tree, batches):
    tx = optim.adamw(lambda count: LR, weight_decay=WEIGHT_DECAY)
    params = classify.params_from_numpy(tree, 'cpu')
    opt_state = classify.init_opt_state(tcfg, tx, params)
    step = classify.make_train_step(tcfg, tx)
    losses = []
    for batch in batches:
        params, opt_state, loss = step(params, opt_state, _to_torch(batch))
        losses.append(float(loss))
    return losses, {k: v.detach().numpy() for k, v in
                    _leaves(params).items()}


@pytest.mark.parametrize('head_only', [False, True],
                         ids=['full', 'head_only'])
def test_three_adamw_steps_match_jax(jax_params, head_only):
    jcfg, tcfg = _configs(3, head_only=head_only)
    tree = jax_params[3]
    batches = [_batch(10 + i, 3) for i in range(3)]
    want_losses, want = _jax_steps(jcfg, tree, batches)
    losses, got = _port_steps(tcfg, tree, batches)
    np.testing.assert_allclose(losses, want_losses, atol=LOSS_ATOL)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, atol=PARAM_ATOL,
                                   err_msg=name)
    before = _leaves(tree)
    lm_head = '/trunk/lm_head'
    if head_only:
        # A truly frozen trunk: bit-identical after the steps, and the
        # head moved (test_head_only_freezes_trunk in the reference).
        for name in before:
            if name.startswith('/trunk/'):
                np.testing.assert_array_equal(got[name], before[name])
        assert not np.array_equal(got['/head/w'], before['/head/w'])
    else:
        # The LM head's gradient is zero, yet AdamW's decay shrinks it:
        # three steps of (1 - lr * wd).
        np.testing.assert_allclose(
            got[lm_head], before[lm_head] * (1 - LR * WEIGHT_DECAY) ** 3,
            rtol=1e-6)
        assert not np.array_equal(got[lm_head], before[lm_head])


def test_jsonl_batches_are_bit_identical_to_jax(tmp_path):
    jcfg, tcfg = _configs(2)
    jcfg = dataclasses.replace(jcfg, batch_size=3, seq_len=8)
    tcfg = dataclasses.replace(tcfg, batch_size=3, seq_len=8)
    rng = np.random.default_rng(5)
    rows = [{'tokens': [int(t) for t in rng.integers(1, 256, n)],
             'label': int(rng.integers(0, 2))}
            for n in (0, 3, 8, 11, 1, 20, 5, 7, 9, 2, 14)]
    path = tmp_path / 'data.jsonl'
    path.write_text('\n'.join(json.dumps(r) for r in rows) + '\n\n')
    for split in ('all', 'train', 'eval'):
        want = jax_classify.jsonl_batches(jcfg, str(path), split=split)
        got = classify.jsonl_batches(tcfg, str(path), split=split,
                                     device='cpu')
        for _ in range(5):   # past one cycle of every split
            w, g = next(want), next(got)
            assert set(g) == set(w)
            for key in w:
                assert g[key].dtype == torch.int32
                np.testing.assert_array_equal(g[key].numpy(),
                                              np.asarray(w[key]),
                                              err_msg=f'{split}/{key}')
    with pytest.raises(ValueError, match='no rows'):
        empty = tmp_path / 'empty.jsonl'
        empty.write_text('\n')
        next(classify.jsonl_batches(tcfg, str(empty), device='cpu'))


def test_synthetic_set_covers_every_class_inside_its_band():
    _, tcfg = _configs(4)
    tcfg = dataclasses.replace(tcfg, batch_size=64)
    gen = torch.Generator()
    gen.manual_seed(0)
    batch = next(classify.synthetic_batches(tcfg, gen))
    tokens, label = batch['tokens'].numpy(), batch['label'].numpy()
    assert set(label.tolist()) == {0, 1, 2, 3}
    assert (batch['true_len'].numpy() == SEQ).all()
    band = (256 - 2) // 4
    shared = (tokens >= 1) & (tokens < band)
    own = ((tokens >= label[:, None] * band + 1)
           & (tokens < (label[:, None] + 1) * band))
    assert (shared | own).all()
    # About a fifth of the tokens are the shared 'stopwords' (class 0's
    # own band is the shared one, so count the other classes' rows).
    assert 0.15 < shared[label > 0].mean() < 0.25


def test_train_learns_the_synthetic_set_on_the_cpu():
    """The reference's test_learns_synthetic_sentiment, at its settings
    but in fp32 (bf16 products are slow on the CPU)."""
    model = dataclasses.replace(llama.LLAMA_TINY, max_seq_len=SEQ,
                                dtype=torch.float32)
    cfg = classify.ClassifyConfig(model=model, num_classes=2, seq_len=SEQ,
                                  batch_size=8, learning_rate=1e-3)
    metrics = classify.train(cfg, steps=60, log_every=0, device='cpu')
    assert metrics['eval_accuracy'] >= 0.8, metrics
    assert np.isfinite(metrics['loss'])


def test_main_prints_the_reference_keys(capsys):
    assert classify.main(['--model', 'tiny', '--steps', '2', '--seq-len',
                          '16', '--batch-size', '4', '--device',
                          'cpu']) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {'metric', 'value', 'loss', 'model', 'steps'}
    assert line['metric'] == 'classify_eval_accuracy'
    assert line['model'] == 'tiny' and line['steps'] == 2
    assert np.isfinite(line['loss']) and 0.0 <= line['value'] <= 1.0


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    _, tcfg = _configs(2)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        classify.train(tcfg, steps=1)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        classify.main(['--model', 'tiny', '--steps', '1'])
