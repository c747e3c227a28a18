"""Tokenizers for the text serving surface (OpenAI-compatible API).

Counterpart of ``skypilot_tpu/infer/tokenizer.py``, the same classes and
functions (the port imports nothing of the reference). The serving
framework owns its endpoint, so it owns tokenization too. Two
implementations:

* ``ByteTokenizer`` — UTF-8 bytes shifted past the special ids. Needs
  no vocabulary files (a replica need not reach a model hub), is fully
  reversible for arbitrary text, and works with
  any model config whose vocab covers 256 + 3 specials. The default.
* ``HFTokenizer`` — wraps a local ``transformers`` tokenizer directory
  for real checkpoints (``--tokenizer /path/to/tokenizer``).

``IncrementalDecoder`` turns a growing token list into text deltas for
server-sent-event streaming, holding back partial UTF-8 sequences.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence


class ByteTokenizer:
    """Reversible byte-level fallback tokenizer.

    Layout: 0=pad, 1=bos, 2=eos, then byte b ↦ token 3+b.
    """

    PAD_ID = 0
    BOS_ID = 1
    EOS_ID = 2
    _OFFSET = 3

    def __init__(self, vocab_size: int) -> None:
        if vocab_size < self._OFFSET + 256:
            raise ValueError(
                f'ByteTokenizer needs vocab ≥ {self._OFFSET + 256}, '
                f'model has {vocab_size}.')
        self.vocab_size = vocab_size

    @property
    def eos_token_id(self) -> int:
        return self.EOS_ID

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        tokens = [self._OFFSET + b for b in text.encode('utf-8')]
        return ([self.BOS_ID] + tokens) if add_bos else tokens

    def decode(self, tokens: Sequence[int]) -> str:
        # Ids past the byte range (a model vocab may exceed 259) have
        # no text: skip them like the specials below OFFSET.
        data = bytes(t - self._OFFSET for t in tokens
                     if self._OFFSET <= t < self._OFFSET + 256)
        return data.decode('utf-8', errors='replace')


class HFTokenizer:
    """A local HuggingFace tokenizer (no hub download: pass a path)."""

    def __init__(self, name_or_path: str) -> None:
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(name_or_path)

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._tok.eos_token_id

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return list(self._tok.encode(text,
                                     add_special_tokens=add_bos))

    def decode(self, tokens: Sequence[int]) -> str:
        return self._tok.decode(list(tokens),
                                skip_special_tokens=True)

    def apply_chat_template(self,
                            messages: List[Dict[str, str]]) -> Optional[str]:
        if getattr(self._tok, 'chat_template', None):
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        return None


def get_tokenizer(spec: str, vocab_size: int) -> Any:
    """``'byte'`` → ByteTokenizer; anything else is a local HF path."""
    if spec == 'byte':
        return ByteTokenizer(vocab_size)
    return HFTokenizer(spec)


def render_chat(messages: List[Dict[str, str]],
                tokenizer: Any = None) -> str:
    """Messages → prompt text. Uses the tokenizer's own chat template
    when it has one; otherwise a simple generic role format."""
    if tokenizer is not None and hasattr(tokenizer,
                                         'apply_chat_template'):
        rendered = tokenizer.apply_chat_template(messages)
        if rendered is not None:
            return rendered
    parts = [f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}"
             for m in messages]
    parts.append('<|assistant|>\n')
    return '\n'.join(parts)


class IncrementalDecoder:
    """Text deltas from a growing token list (decode-all, emit-suffix).

    Decoding the full list every call keeps multi-token characters
    correct; a trailing U+FFFD is held back as a likely partial UTF-8
    sequence that the next token will complete.
    """

    def __init__(self, tokenizer: Any) -> None:
        self._tokenizer = tokenizer
        self.emitted = ''

    def delta(self, tokens: Sequence[int], final: bool = False) -> str:
        full = self._tokenizer.decode(tokens)
        if not final and full.endswith('�'):
            full = full[:-1]
        out = full[len(self.emitted):]
        self.emitted = full
        return out
