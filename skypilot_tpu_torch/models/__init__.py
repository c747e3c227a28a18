"""Model families of the port: the Llama family (MISTRAL shares
``LlamaConfig``), Qwen-2/Qwen-3 (``QwenConfig``) and DeepSeek (MLA +
DeepSeekMoE). Each family module exposes the serving surface the engine
dispatches on: ``init``, ``prefill_hidden``, ``decode_forward`` and
``lm_logits``; the Llama and Qwen families also have the trainer's
``loss_fn`` and ``verify_forward`` (the engine's chunked prefill and
prefix cache); Llama and DeepSeek have ``paged_decode_forward`` (Qwen
has no paged hook, as in the reference), and DeepSeek declares its
compressed cache layout (``kv_cache_shapes``,
``paged_kv_cache_shapes``)."""
from __future__ import annotations

from typing import Any


def _families():
    from skypilot_tpu_torch.models import deepseek
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import qwen
    return llama, qwen, deepseek


def module_for(config: Any):
    """Return the model module owning ``config``."""
    llama, qwen, deepseek = _families()
    if isinstance(config, deepseek.DeepSeekConfig):
        return deepseek
    if isinstance(config, llama.LlamaConfig):
        return llama
    if isinstance(config, qwen.QwenConfig):
        return qwen
    raise TypeError(f'Unknown model config type: {type(config)!r} (the '
                    'port has the Llama, Qwen and DeepSeek families so '
                    'far)')


def get_config(name: str):
    """Look up a named config across the port's families."""
    families = _families()
    for mod in families:
        if name in mod.CONFIGS:
            return mod.CONFIGS[name]
    known = sorted(set().union(*(mod.CONFIGS for mod in families)))
    raise KeyError(f'Unknown model {name!r}; known: {known}')
