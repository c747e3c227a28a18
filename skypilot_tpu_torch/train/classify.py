"""Sequence-classification fine-tune in PyTorch: a linear head over the
last-token hidden state of an in-tree Llama.

Counterpart of ``skypilot_tpu/train/classify.py`` (the BASELINE "BERT-base
GLUE fine-tune E2E" target, twin of the reference's
``examples/huggingface_glue_imdb_app.yaml``):
``examples/tpu/finetune_classifier.yaml`` runs it as ``--model 1b --steps
500 --batch-size 32 --seq-len 256 --lr 1e-4``. The trunk is the serving
trunk (``llama.prefill_hidden``, so positions are the reference's), its
KV dropped; the head ``w [D, C]``, ``b [C]`` is fp32; the loss is the
mean fp32 softmax cross-entropy with integer labels; the optimizer is
``train/optim.py``'s ``adamw`` at a constant learning rate with the
given weight decay, as ``optax.adamw`` is in the reference.

*Full mode* optimizes every trunk leaf, ``lm_head`` included, which the
loss never reads: its gradient is zero and AdamW's decay still shrinks
it, as optax does. *head_only* keeps the optimizer state to the head, so
the trunk stays bit-identical; its forward runs under
``torch.no_grad()``.

``main`` asks the trunk for the flash attention kernels at every length
(``attention_impl='flash'``), where the reference's 'auto' takes the
plain attention below 1024 tokens: on the card the trunk's attention is
the hand-written forward (K1) and, in full mode, its backward (K2, K3),
so a 256-token batch never materializes fp32 scores; on the CPU both
take plain versions of the same function.

Data: JSONL rows ``{"tokens": [...], "label": n}`` (pre-tokenized), or a
built-in synthetic sentiment-style set drawn from a ``torch.Generator``
(the same construction as the reference's; its values differ from
``jax.random``'s). ``python -m skypilot_tpu_torch.train.classify --steps
200`` prints one JSON line with the final eval accuracy. Every entry
point runs on the card unless the caller passes ``device='cpu'``
(``--device cpu``).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import Device, resolve_device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.train import optim
from skypilot_tpu_torch.train.trainer import param_leaves

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]

MODELS = {'tiny': llama.LLAMA_TINY, '1b': llama.LLAMA3_1B,
          '8b': llama.LLAMA3_8B}


@dataclasses.dataclass(frozen=True)
class ClassifyConfig:
    model: llama.LlamaConfig
    num_classes: int = 2
    seq_len: int = 128
    batch_size: int = 16
    learning_rate: float = 3e-4
    head_only: bool = False   # freeze the trunk, train only the head
    weight_decay: float = 0.01


def init(config: ClassifyConfig, generator: Optional[torch.Generator] = None,
         device: Device = None) -> Dict[str, Params]:
    """{'trunk': LM params, 'head': {'w' [D, C], 'b' [C]}}: the trunk from
    ``llama.init``, then ``w`` ~ N(0, 1)/sqrt(D) in fp32 and ``b`` zeros,
    all drawn from ``generator`` (seeded 0 if None), which must live on
    ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    d = config.model.d_model
    trunk = llama.init(config.model, generator, device)
    w = torch.randn((d, config.num_classes), generator=generator,
                    dtype=torch.float32, device=device) / math.sqrt(d)
    return {'trunk': trunk,
            'head': {'w': w, 'b': torch.zeros((config.num_classes,),
                                              dtype=torch.float32,
                                              device=device)}}


def params_from_numpy(tree: Dict[str, Params], device: Device
                      ) -> Dict[str, Params]:
    """The JAX ``init`` tree ({'trunk', 'head'}) as numpy arrays → the
    port's tree, leaf by leaf (``llama.params_from_numpy``)."""
    return {name: llama.params_from_numpy(tree[name], device)
            for name in ('trunk', 'head')}


def _hidden(config: ClassifyConfig, trunk: Params, tokens: torch.Tensor,
            true_len: torch.Tensor) -> torch.Tensor:
    hidden, _ = llama.prefill_hidden(config.model, trunk, tokens, true_len)
    return hidden


def _head_logits(head: Params, hidden: torch.Tensor) -> torch.Tensor:
    return hidden.float() @ head['w'] + head['b']


def logits_fn(config: ClassifyConfig, params: Dict[str, Params],
              tokens: torch.Tensor, true_len: torch.Tensor) -> torch.Tensor:
    """[B, S] tokens (+ per-row lengths) → [B, C] fp32 class logits."""
    return _head_logits(params['head'],
                        _hidden(config, params['trunk'], tokens, true_len))


def _nll(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    picked = logits.gather(-1, label.long()[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - picked).mean()


def _loss(config: ClassifyConfig, params, batch: Batch) -> torch.Tensor:
    return _nll(logits_fn(config, params, batch['tokens'],
                          batch['true_len']), batch['label'])


def make_train_step(config: ClassifyConfig, tx: optim.Transform):
    """→ ``step(params, opt_state, batch) -> (params, opt_state, loss)``;
    the parameters are updated in place, loss is a 0-dim device tensor.

    head_only truly freezes the trunk: the optimizer state and updates
    cover ONLY the head subtree, because adamw's weight decay shrinks
    every optimized leaf whatever its gradient. In full mode a leaf the
    loss never reads (``lm_head``) gets a zero gradient, not a skip."""

    def step(params, opt_state, batch):
        if config.head_only:
            leaves = param_leaves(params['head'])
            with torch.no_grad():
                hidden = _hidden(config, params['trunk'], batch['tokens'],
                                 batch['true_len'])
            for p in leaves:
                p.requires_grad_(True)
            loss = _nll(_head_logits(params['head'], hidden),
                        batch['label'])
        else:
            leaves = param_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss = _loss(config, params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        updates, opt_state = tx.update(grads, opt_state, leaves)
        optim.apply_updates(leaves, updates)
        return params, opt_state, loss.detach()

    return step


def init_opt_state(config: ClassifyConfig, tx: optim.Transform, params):
    return tx.init(param_leaves(params['head'] if config.head_only
                                else params))


@torch.no_grad()
def eval_accuracy(config: ClassifyConfig, params, batch: Batch
                  ) -> torch.Tensor:
    logits = logits_fn(config, params, batch['tokens'], batch['true_len'])
    return (torch.argmax(logits, dim=-1) == batch['label'].long()
            ).float().mean()


# ---------------------------------------------------------------------------
# Data


def synthetic_batches(config: ClassifyConfig, generator: torch.Generator,
                      ) -> Iterator[Batch]:
    """Sentiment-style synthetic set: each class draws its tokens from
    its own band of the vocabulary with 20% shared 'stopwords', so the
    task is learnable but not trivial. Drawn on the generator's device."""
    vocab = config.model.vocab_size
    n = config.num_classes
    band = max(2, (vocab - 2) // n)   # one vocab band per class
    b, s = config.batch_size, config.seq_len
    kw = dict(generator=generator, device=generator.device)
    while True:
        label = torch.randint(0, n, (b,), **kw)
        class_tok = torch.randint(1, band, (b, s), **kw) + label[:, None] * band
        shared = torch.randint(1, band, (b, s), **kw)
        use_shared = torch.rand((b, s), **kw) < 0.2
        tokens = torch.where(use_shared, shared, class_tok) % vocab
        yield {'tokens': tokens.to(torch.int32),
               'true_len': torch.full((b,), s, dtype=torch.int32,
                                      device=generator.device),
               'label': label.to(torch.int32)}


def jsonl_batches(config: ClassifyConfig, path: str, split: str = 'all',
                  device: Device = None) -> Iterator[Batch]:
    """Cycle over pre-tokenized JSONL rows, padded/truncated to seq_len;
    true_len keeps the real length (at least 1) for last-token pooling.

    split: 'all' | 'train' | 'eval' — train/eval hold out every 5th row
    so the reported accuracy is held-out, not training-set. The batches
    are built in numpy as the reference builds them, one transfer each.
    """
    device = resolve_device(device)
    rows: List[Tuple[List[int], int]] = []
    with open(path, encoding='utf-8') as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            rows.append((list(row['tokens']), int(row['label'])))
    if split == 'train':
        rows = [r for i, r in enumerate(rows) if i % 5 != 0]
    elif split == 'eval':
        rows = [r for i, r in enumerate(rows) if i % 5 == 0]
    if not rows:
        raise ValueError(f'no rows in {path} (split={split!r})')
    i = 0
    while True:
        toks = np.zeros((config.batch_size, config.seq_len), np.int32)
        lens = np.empty((config.batch_size,), np.int32)
        labels = np.empty((config.batch_size,), np.int32)
        for b in range(config.batch_size):
            t, label = rows[i % len(rows)]
            i += 1
            t = t[:config.seq_len]
            toks[b, :len(t)] = t
            lens[b] = max(1, len(t))
            labels[b] = label
        yield {'tokens': torch.from_numpy(toks).to(device),
               'true_len': torch.from_numpy(lens).to(device),
               'label': torch.from_numpy(labels).to(device)}


# ---------------------------------------------------------------------------
# Driver


def _generator(seed: int, stream: int, device: torch.device
               ) -> torch.Generator:
    """One of a seed's independent draw streams (0 the weights, 1 the
    training set, 2 the held-out set: the reference's fold_in)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed << 8) + stream)
    return gen


def train(config: ClassifyConfig,
          steps: int,
          data: Optional[Iterator[Batch]] = None,
          eval_data: Optional[Iterator[Batch]] = None,
          eval_batches: int = 4,
          seed: int = 0,
          log_every: int = 20,
          device: Device = None) -> Dict[str, float]:
    """eval_data defaults to fresh draws from the synthetic stream
    (held-out by construction). For file-backed data pass a held-out
    iterator (jsonl_batches(..., split='eval')) — evaluating on the
    training iterator would report training-set accuracy."""
    device = resolve_device(device)
    params = init(config, _generator(seed, 0, device), device)
    tx = optim.adamw(lambda count: config.learning_rate,
                     weight_decay=config.weight_decay)
    opt_state = init_opt_state(config, tx, params)
    step_fn = make_train_step(config, tx)
    batches = data if data is not None else synthetic_batches(
        config, _generator(seed, 1, device))
    if eval_data is None:
        eval_data = (synthetic_batches(config, _generator(seed, 2, device))
                     if data is None else batches)
    loss = None
    for i in range(steps):
        batch = next(batches)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if log_every and (i + 1) % log_every == 0:
            print(f'# step {i + 1}/{steps} loss={float(loss):.4f}',
                  flush=True)
    accs = [float(eval_accuracy(config, params, next(eval_data)))
            for _ in range(eval_batches)]
    return {'loss': float(loss) if loss is not None else float('nan'),
            'eval_accuracy': sum(accs) / len(accs)}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.train.classify',
        description='Sequence-classification fine-tune (GLUE twin).')
    parser.add_argument('--steps', type=int, default=200)
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--seq-len', type=int, default=128)
    parser.add_argument('--num-classes', type=int, default=2)
    parser.add_argument('--lr', type=float, default=3e-4)
    parser.add_argument('--data', default=None,
                        help='JSONL of {"tokens": [...], "label": n}; '
                             'default: built-in synthetic set')
    parser.add_argument('--head-only', action='store_true')
    parser.add_argument('--model', default='tiny', choices=sorted(MODELS))
    parser.add_argument('--device', default=None,
                        help="'cpu' to train on the CPU; default: the card")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    model = dataclasses.replace(MODELS[args.model], max_seq_len=args.seq_len,
                                attention_impl='flash')
    config = ClassifyConfig(model=model, num_classes=args.num_classes,
                            seq_len=args.seq_len,
                            batch_size=args.batch_size,
                            learning_rate=args.lr,
                            head_only=args.head_only)
    data = eval_data = None
    if args.data:
        data = jsonl_batches(config, args.data, split='train', device=device)
        eval_data = jsonl_batches(config, args.data, split='eval',
                                  device=device)
    metrics = train(config, steps=args.steps, data=data,
                    eval_data=eval_data, device=device)
    print(json.dumps({'metric': 'classify_eval_accuracy',
                      'value': round(metrics['eval_accuracy'], 4),
                      'loss': round(metrics['loss'], 4),
                      'model': args.model, 'steps': args.steps}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
