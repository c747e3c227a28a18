"""Model families of the port: the Llama family (MISTRAL shares
``LlamaConfig``), the Mixtral family (``MoEConfig``, a ``LlamaConfig``
with routed experts), Qwen-2/Qwen-3 (``QwenConfig``), Gemma-1/Gemma-2
(``GemmaConfig``) and DeepSeek (MLA + DeepSeekMoE). Each family module
exposes the serving surface the engine dispatches on: ``init``,
``prefill_hidden``, ``decode_forward`` and ``lm_logits``; the Llama,
Mixtral, Qwen and Gemma families also have ``verify_forward`` (the
engine's chunked prefill and prefix cache), and every family the
trainer's ``loss_fn`` (Mixtral's and DeepSeek's with the router's
load-balance term); Llama and DeepSeek have
``paged_decode_forward`` (Mixtral, Qwen and Gemma have no paged hook, as
in the reference), and DeepSeek declares its
compressed cache layout (``kv_cache_shapes``,
``paged_kv_cache_shapes``)."""
from __future__ import annotations

from typing import Any


def _families():
    from skypilot_tpu_torch.models import deepseek
    from skypilot_tpu_torch.models import gemma
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.models import qwen
    return llama, moe, qwen, gemma, deepseek


def module_for(config: Any):
    """Return the model module owning ``config``."""
    llama, moe, qwen, gemma, deepseek = _families()
    if isinstance(config, deepseek.DeepSeekConfig):
        return deepseek
    # MoEConfig subclasses LlamaConfig: it is checked first.
    if isinstance(config, moe.MoEConfig):
        return moe
    if isinstance(config, llama.LlamaConfig):
        return llama
    if isinstance(config, qwen.QwenConfig):
        return qwen
    if isinstance(config, gemma.GemmaConfig):
        return gemma
    raise TypeError(f'Unknown model config type: {type(config)!r} (the '
                    'port has the Llama, Mixtral, Qwen, Gemma and '
                    'DeepSeek families)')


def get_config(name: str):
    """Look up a named config across the port's families."""
    families = _families()
    for mod in families:
        if name in mod.CONFIGS:
            return mod.CONFIGS[name]
    known = sorted(set().union(*(mod.CONFIGS for mod in families)))
    raise KeyError(f'Unknown model {name!r}; known: {known}')
