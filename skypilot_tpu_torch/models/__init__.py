"""Model families of the port (Llama-family first; MISTRAL shares
``LlamaConfig``). Each family module exposes the serving surface the
engine dispatches on: ``init``, ``prefill_hidden``, ``decode_forward``
and ``lm_logits``."""
from __future__ import annotations

from typing import Any


def module_for(config: Any):
    """Return the model module owning ``config``."""
    from skypilot_tpu_torch.models import llama
    if isinstance(config, llama.LlamaConfig):
        return llama
    raise TypeError(f'Unknown model config type: {type(config)!r} (the '
                    'port has the Llama family only so far)')
