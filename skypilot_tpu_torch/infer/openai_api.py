"""OpenAI-compatible request/response shaping for the serving endpoint.

Counterpart of ``skypilot_tpu/infer/openai_api.py``, whole (the port
imports nothing of the reference): ``/v1/completions`` and
``/v1/chat/completions`` over the port's orchestrator. Pure shaping
logic lives in this module (testable without HTTP); the HTTP routes are
in ``infer/server.py``.

Supported: prompt as text / token list, ``max_tokens``, ``temperature``,
``top_p``/``top_k``, ``stop`` (string or list), ``stream`` (SSE),
``echo``, ``logprobs`` (completions int ≤ 5 / chat ``logprobs`` +
``top_logprobs``), ``n`` ≤ 8 (non-streamed). Rejected clearly:
batched prompts, ``n`` with ``stream``, ``logprobs`` with ``stream``.
"""
from __future__ import annotations

import dataclasses
import json
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.infer import tokenizer as tokenizer_lib


class ApiError(Exception):
    """Maps to an OpenAI-style error body with an HTTP status."""

    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code

    def body(self) -> Dict[str, Any]:
        return {'error': {'message': str(self),
                          'type': 'invalid_request_error'}}


@dataclasses.dataclass
class RequestMeta:
    """Everything the response shaping needs beyond the orch Request."""
    kind: str                    # 'completion' | 'chat'
    model_id: str
    stream: bool
    stop: List[str]
    echo: bool
    prompt_text: str             # '' when prompt came as token ids
    prompt_tokens: List[int]
    n: int = 1                   # parallel choices (non-streamed)
    # None = logprobs off; else the requested ALTERNATIVE count (0..5 —
    # 0 means chosen-token logprob only, per the OpenAI shape):
    logprobs: Optional[int] = None
    response_id: str = ''
    created: int = 0

    def __post_init__(self) -> None:
        prefix = 'cmpl' if self.kind == 'completion' else 'chatcmpl'
        self.response_id = f'{prefix}-{uuid.uuid4().hex[:24]}'
        self.created = int(time.time())


def _parse_prompt(body: Dict[str, Any],
                  tokenizer: Any) -> Tuple[str, List[int]]:
    prompt = body.get('prompt')
    if isinstance(prompt, list) and len(prompt) == 1 and \
            isinstance(prompt[0], str):
        prompt = prompt[0]  # single-element batch: allowed
    if isinstance(prompt, str):
        return prompt, tokenizer.encode(prompt)
    if isinstance(prompt, list) and prompt and \
            all(isinstance(t, int) for t in prompt):
        return '', list(prompt)  # pre-tokenized (OpenAI allows this)
    if isinstance(prompt, list):
        raise ApiError(400, 'batched prompts are not supported; send '
                            'one request per prompt')
    raise ApiError(400, "'prompt' (string or token list) is required")


def _parse_chat_prompt(body: Dict[str, Any],
                       tokenizer: Any) -> Tuple[str, List[int]]:
    messages = body.get('messages')
    if not isinstance(messages, list) or not messages or not all(
            isinstance(m, dict) and isinstance(m.get('content'), str)
            for m in messages):
        raise ApiError(400, "'messages' must be a non-empty list of "
                            "{role, content} objects")
    text = tokenizer_lib.render_chat(messages, tokenizer)
    return text, tokenizer.encode(text)


def build_request(body: Dict[str, Any], tokenizer: Any,
                  engine_config: Any, model_id: str,
                  chat: bool,
                  admit_limit: Optional[int] = None
                  ) -> Tuple[orch_lib.Request, RequestMeta]:
    """Validate an API body into an orchestrator Request + meta.

    `admit_limit` overrides the prompt-length cap (servers whose engine
    has the chunked-prefill path admit beyond the largest bucket —
    pass orchestrator._admit_limit()). Raises ApiError on anything
    malformed or unsupported.
    """
    stream = bool(body.get('stream', False))
    try:
        n = int(body.get('n', 1))
    except (TypeError, ValueError):
        raise ApiError(400, "'n' must be an integer")
    if not 1 <= n <= 8:
        raise ApiError(400, "'n' must be between 1 and 8")
    if n > 1 and stream:
        raise ApiError(400, "'n' > 1 is not supported with streaming")
    logprobs = _parse_logprobs(body, chat)
    if logprobs is not None and stream:
        raise ApiError(400, "'logprobs' is not supported with "
                            'streaming')
    if chat:
        prompt_text, prompt_tokens = _parse_chat_prompt(body, tokenizer)
    else:
        prompt_text, prompt_tokens = _parse_prompt(body, tokenizer)

    limit = admit_limit if admit_limit is not None else min(
        engine_config.max_prompt_len, engine_config.max_target_len - 1)
    if len(prompt_tokens) > limit:
        raise ApiError(400, f'prompt is {len(prompt_tokens)} tokens; '
                            f'this server accepts at most {limit}')

    budget = engine_config.max_target_len - len(prompt_tokens)
    max_tokens = body.get('max_tokens')
    if max_tokens is None:
        # OpenAI defaults completions to 16; chat fills the budget.
        max_tokens = 16 if not chat else budget
    try:
        max_tokens = int(max_tokens)
    except (TypeError, ValueError):
        raise ApiError(400, "'max_tokens' must be an integer")
    if max_tokens < 1:
        raise ApiError(400, "'max_tokens' must be ≥ 1")
    max_tokens = min(max_tokens, budget)

    stop = body.get('stop') or []
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, list) or not all(
            isinstance(s, str) and s for s in stop):
        raise ApiError(400, "'stop' must be a string or list of strings")
    if len(stop) > 4:
        raise ApiError(400, "at most 4 'stop' sequences")

    try:
        temperature = float(body.get('temperature', 1.0))
        top_p = float(body.get('top_p', 1.0))
        top_k = int(body.get('top_k', 0))
        presence = float(body.get('presence_penalty', 0.0))
        frequency = float(body.get('frequency_penalty', 0.0))
    except (TypeError, ValueError):
        raise ApiError(400, 'temperature/top_p/top_k/penalties must '
                            'be numbers')
    for name, value in (('presence_penalty', presence),
                        ('frequency_penalty', frequency)):
        if not -2.0 <= value <= 2.0:
            raise ApiError(400, f"'{name}' must be in [-2, 2]")

    request = orch_lib.Request(
        prompt_tokens=prompt_tokens,
        max_new_tokens=max_tokens,
        eos_token_id=getattr(tokenizer, 'eos_token_id', None),
        temperature=temperature,
        top_k=top_k,
        top_p=top_p,
        presence_penalty=presence,
        frequency_penalty=frequency,
        # The orchestrator records max(alts, 1) alternatives; the
        # response body slices down to the exact requested count.
        logprobs=0 if logprobs is None else max(logprobs, 1))
    meta = RequestMeta(kind='chat' if chat else 'completion',
                       model_id=model_id,
                       stream=stream,
                       stop=stop,
                       echo=bool(body.get('echo', False)),
                       prompt_text=prompt_text,
                       prompt_tokens=prompt_tokens,
                       n=n,
                       logprobs=logprobs)
    return request, meta


def _parse_logprobs(body: Dict[str, Any], chat: bool) -> Optional[int]:
    """Completions: `logprobs: N` (int ≤ 5). Chat: `logprobs: true` +
    optional `top_logprobs: N`. Returns the requested ALTERNATIVE
    count (0..5), or None when logprobs are off — 0 is a valid request
    meaning chosen-token logprobs with no alternatives."""
    cap = orch_lib.LOGPROBS_K
    if chat:
        flag = body.get('logprobs', False)
        if not isinstance(flag, bool):
            raise ApiError(400, "chat 'logprobs' must be a boolean")
        if not flag:
            if body.get('top_logprobs'):
                raise ApiError(400, "'top_logprobs' needs "
                                    "'logprobs': true")
            return None
        top = body.get('top_logprobs', 0)
        try:
            top = int(top)
        except (TypeError, ValueError):
            raise ApiError(400, "'top_logprobs' must be an integer")
        if not 0 <= top <= cap:
            raise ApiError(400, f"'top_logprobs' must be 0..{cap}")
        return top
    lp = body.get('logprobs')
    if lp is None or lp is False:
        return None   # NOT `in (None, False)`: 0 == False is a hit
    try:
        lp = int(lp)
    except (TypeError, ValueError):
        raise ApiError(400, "'logprobs' must be an integer")
    if not 0 <= lp <= cap:
        raise ApiError(400, f"'logprobs' must be 0..{cap}")
    return lp


def clone_request(request: orch_lib.Request) -> orch_lib.Request:
    """A fresh Request with the same decoding parameters (for n > 1 —
    output bookkeeping must not be shared)."""
    return orch_lib.Request(
        prompt_tokens=request.prompt_tokens,
        max_new_tokens=request.max_new_tokens,
        eos_token_id=request.eos_token_id,
        temperature=request.temperature,
        top_k=request.top_k,
        top_p=request.top_p,
        presence_penalty=request.presence_penalty,
        frequency_penalty=request.frequency_penalty,
        logprobs=request.logprobs)


def find_stop(text: str, stops: List[str]) -> int:
    """Earliest index where any stop sequence begins, or -1."""
    best = -1
    for stop in stops:
        idx = text.find(stop)
        if idx != -1 and (best == -1 or idx < best):
            best = idx
    return best


def finalize_text(meta: RequestMeta, request: orch_lib.Request,
                  tokenizer: Any) -> Tuple[str, str]:
    """(text, finish_reason) for a finished non-streamed request."""
    text = tokenizer.decode(request.output_tokens)
    finish_reason = ('length' if len(request.output_tokens) >=
                     request.max_new_tokens else 'stop')
    idx = find_stop(text, meta.stop)
    if idx != -1:
        text, finish_reason = text[:idx], 'stop'
    if meta.echo and meta.kind == 'completion':
        # prompt_text is '' when the prompt arrived as token ids —
        # reconstruct it so echo still echoes.
        prompt_text = meta.prompt_text or \
            tokenizer.decode(meta.prompt_tokens)
        text = prompt_text + text
    return text, finish_reason


def _usage(meta: RequestMeta,
           request: orch_lib.Request) -> Dict[str, int]:
    return {'prompt_tokens': len(meta.prompt_tokens),
            'completion_tokens': len(request.output_tokens),
            'total_tokens': (len(meta.prompt_tokens) +
                             len(request.output_tokens))}


def _logprobs_block(meta: RequestMeta, request: orch_lib.Request,
                    tokenizer: Any, text: str
                    ) -> Optional[Dict[str, Any]]:
    """The per-choice `logprobs` object in the OpenAI shape.

    Completions: {tokens, token_logprobs, top_logprobs, text_offset}.
    Chat: {content: [{token, logprob, top_logprobs: [...]}]}. Token
    strings decode one token at a time (byte-exactness is not
    guaranteed across merges — standard for this field). Entries are
    truncated to the RETURNED `text` (stop sequences cut generation
    mid-list, and cancel latency can overshoot by a few tokens), and
    the alternative count is exactly meta.logprobs (the orchestrator
    records at least one alternative even for a 0-alternative ask).
    """
    alts = meta.logprobs
    if alts is None or not request.logprobs:
        return None
    n = len(request.token_logprobs)
    toks = request.output_tokens[:n]
    # Token strings as joint-decode diffs: their concatenation is
    # EXACTLY tokenizer.decode(toks) (per-token decode is not —
    # multi-byte characters split across tokens), so offsets and
    # stop-truncation line up with the returned text. Diffs use a
    # small sliding window (two ≤W+1-token decodes per token, O(n·W)
    # total — a full cumulative decode per token would be O(n²));
    # if windowing ever disagrees with the joint decode (a merge
    # spanning the window), fall back to the exact cumulative pass.
    full_join = tokenizer.decode(toks)
    window = 8
    tok_strs = []
    for i in range(n):
        lo = max(0, i + 1 - window)
        head = tokenizer.decode(toks[lo:i]) if i > lo else ''
        tok_strs.append(tokenizer.decode(toks[lo:i + 1])[len(head):])
    if ''.join(tok_strs) != full_join:
        tok_strs, prev = [], ''
        for i in range(n):
            cur = tokenizer.decode(toks[:i + 1])
            tok_strs.append(cur[len(prev):])
            prev = cur
    # Echoed completions prepend the prompt (reconstructed when it
    # arrived as token ids): offsets are relative to the full text.
    base = 0
    if meta.echo and meta.kind == 'completion':
        base = len(meta.prompt_text or
                   tokenizer.decode(meta.prompt_tokens))
    gen_text = text[base:]
    if gen_text == full_join:
        # Untruncated: every recorded token is returned (a trailing
        # empty diff — incomplete UTF-8 tail — must not be dropped).
        keep = n
        offsets, pos = [], 0
        for ts in tok_strs:
            offsets.append(base + pos)
            pos += len(ts)
    else:
        keep, pos = 0, 0
        offsets = []
        for ts in tok_strs:
            if pos >= len(gen_text):
                break
            offsets.append(base + pos)
            pos += len(ts)
            keep += 1
    tok_strs = tok_strs[:keep]
    token_lps = request.token_logprobs[:keep]
    top_lps = request.top_logprobs[:keep]
    if meta.kind == 'chat':
        content = []
        for ts, lp, top in zip(tok_strs, token_lps, top_lps):
            ranked = sorted(top.items(), key=lambda kv: -kv[1])[:alts]
            content.append({
                'token': ts, 'logprob': lp,
                'top_logprobs': [
                    {'token': tokenizer.decode([tid]), 'logprob': v}
                    for tid, v in ranked],
            })
        return {'content': content}
    tops = []
    for top in top_lps:
        merged: Dict[str, float] = {}
        for tid, v in sorted(top.items(), key=lambda kv: -kv[1])[:alts]:
            key = tokenizer.decode([tid])
            # Distinct ids can decode to the same string (specials,
            # unmapped ids); keep the most probable one.
            merged[key] = max(v, merged.get(key, v))
        tops.append(merged)
    return {
        'tokens': tok_strs,
        'token_logprobs': token_lps,
        'top_logprobs': tops,
        'text_offset': offsets,
    }


def response_body(meta: RequestMeta, request: orch_lib.Request,
                  text: str, finish_reason: str,
                  tokenizer: Any = None,
                  extra_choices: Optional[List[Tuple[
                      orch_lib.Request, str, str]]] = None
                  ) -> Dict[str, Any]:
    """One response document; extra_choices carries the n>1 siblings
    as (request, text, finish_reason) for indices 1..n-1."""
    all_choices = [(request, text, finish_reason)]
    all_choices += extra_choices or []

    choices = []
    for idx, (req, txt, reason) in enumerate(all_choices):
        if meta.kind == 'chat':
            choice: Dict[str, Any] = {
                'index': idx,
                'message': {'role': 'assistant', 'content': txt},
                'finish_reason': reason,
            }
        else:
            choice = {'index': idx, 'text': txt,
                      'finish_reason': reason}
        if req.logprobs and tokenizer is not None:
            choice['logprobs'] = _logprobs_block(meta, req, tokenizer,
                                                 txt)
        choices.append(choice)
    obj = 'chat.completion' if meta.kind == 'chat' else 'text_completion'
    usage = _usage(meta, request)
    for req, _, _ in all_choices[1:]:
        usage['completion_tokens'] += len(req.output_tokens)
        usage['total_tokens'] += len(req.output_tokens)
    return {'id': meta.response_id, 'object': obj,
            'created': meta.created, 'model': meta.model_id,
            'choices': choices, 'usage': usage}


def chunk_body(meta: RequestMeta, text: str,
               finish_reason: Optional[str],
               first: bool = False) -> Dict[str, Any]:
    if meta.kind == 'chat':
        delta: Dict[str, Any] = {}
        if first:
            delta['role'] = 'assistant'
        if text:
            delta['content'] = text
        choice: Dict[str, Any] = {'index': 0, 'delta': delta,
                                  'finish_reason': finish_reason}
        obj = 'chat.completion.chunk'
    else:
        choice = {'index': 0, 'text': text,
                  'finish_reason': finish_reason}
        obj = 'text_completion'
    return {'id': meta.response_id, 'object': obj,
            'created': meta.created, 'model': meta.model_id,
            'choices': [choice]}


def sse(payload: Dict[str, Any]) -> bytes:
    return f'data: {json.dumps(payload)}\n\n'.encode()


SSE_DONE = b'data: [DONE]\n\n'


class StreamEmitter:
    """Incremental text emission with stop-sequence hold-back.

    Deltas are only released once they can no longer be a prefix of a
    stop sequence still in flight; on a stop hit, the text before the
    stop is emitted and ``finished`` flips so the caller can cancel
    the underlying request.
    """

    def __init__(self, tokenizer: Any, stops: List[str]) -> None:
        self._decoder = tokenizer_lib.IncrementalDecoder(tokenizer)
        self._stops = stops
        self._holdback = max((len(s) for s in stops), default=1) - 1
        self._text = ''
        self._sent = 0
        self.finished = False
        self.finish_reason: Optional[str] = None

    def push(self, tokens: List[int], final: bool = False) -> str:
        """Feed the full token list so far; returns newly safe text."""
        if self.finished:
            return ''
        self._text += self._decoder.delta(tokens, final=final)
        idx = find_stop(self._text, self._stops)
        if idx != -1:
            self.finished = True
            self.finish_reason = 'stop'
            out = self._text[self._sent:idx]
            self._sent = idx
            return out
        safe_upto = len(self._text) if final else \
            max(self._sent, len(self._text) - self._holdback)
        out = self._text[self._sent:safe_upto]
        self._sent = safe_upto
        return out
