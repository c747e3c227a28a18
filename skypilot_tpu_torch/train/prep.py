"""Corpus prep: text files → token shards the data loader reads.

    python -m skypilot_tpu_torch.train.prep --out corpus.bin \
        --tokenizer byte --vocab-size 32768 docs/*.txt

Counterpart of ``skypilot_tpu/train/prep.py``, over the port's
tokenizer (``infer/tokenizer.py``); the shards are byte for byte the
reference's.

Output is the loader's shard format (train/data.py: raw little-endian
uint32 token stream). Documents are separated by the tokenizer's EOS
token, which pairs with training's ``--packing-reset-eos``: attention
and RoPE then reset at exactly these boundaries. `--tokenizer` takes
``byte`` (the built-in reversible byte-level tokenizer — no files, no
egress) or a local HuggingFace tokenizer directory.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

import numpy as np

from skypilot_tpu_torch.infer import tokenizer as tokenizer_lib


def prep_files(paths: List[str], out: str, tokenizer,
               append_eos: bool = True,
               vocab_size: int = 0) -> dict:
    """Tokenize `paths` into one shard at `out`; returns a summary.

    With vocab_size > 0, ids outside the model vocab fail fast: the
    training loader clamps out-of-range ids silently (data.batches'
    vocab guard), so an HF tokenizer larger than the model's embedding
    would otherwise corrupt the corpus with no error anywhere.
    """
    n_tokens = 0
    n_docs = 0
    eos = getattr(tokenizer, 'eos_token_id', None)
    with open(out, 'wb') as sink:
        for path in paths:
            with open(path, 'r', encoding='utf-8', errors='replace') as f:
                text = f.read()
            if not text:
                continue
            tokens = tokenizer.encode(text)
            if append_eos and eos is not None:
                tokens = list(tokens) + [eos]
            arr = np.asarray(tokens, dtype=np.uint32)
            if arr.size == 0:
                continue   # text normalized/encoded to nothing
            if vocab_size and int(arr.max()) >= vocab_size:
                raise ValueError(
                    f'{path}: token id {int(arr.max())} >= model vocab '
                    f'{vocab_size} — this tokenizer does not fit the '
                    'target model (the loader would silently clamp '
                    'these ids at training time).')
            arr.astype('<u4').tofile(sink)
            n_tokens += arr.size
            n_docs += 1
    return {'out': out, 'documents': n_docs, 'tokens': n_tokens,
            'eos_separated': bool(append_eos and eos is not None)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Tokenize text files into training shards.')
    parser.add_argument('inputs', nargs='+', help='UTF-8 text files')
    parser.add_argument('--out', required=True,
                        help='Output shard path (*.bin)')
    parser.add_argument('--tokenizer', default='byte',
                        help="'byte' or a local HF tokenizer dir")
    parser.add_argument('--vocab-size', type=int, default=32_768,
                        help='Model vocab (byte tokenizer bound check)')
    parser.add_argument('--no-eos', action='store_true',
                        help='Do not separate documents with EOS '
                             '(disables packing_reset_eos pairing)')
    args = parser.parse_args(argv)
    tokenizer = tokenizer_lib.get_tokenizer(args.tokenizer,
                                            args.vocab_size)
    summary = prep_files(args.inputs, args.out, tokenizer,
                         append_eos=not args.no_eos,
                         vocab_size=args.vocab_size)
    print(json.dumps(summary))
    return 0


if __name__ == '__main__':
    sys.exit(main())
