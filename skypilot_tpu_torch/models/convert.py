"""HuggingFace checkpoint → the port's param tree.

Counterpart of ``skypilot_tpu/models/convert.py`` for the Llama family
(Llama-3 and Mistral, which share ``LlamaConfig``), Qwen-2/Qwen-3
(``QwenConfig``: Q/K/V biases detected from ``q_proj.bias``, QK-norm
from ``q_norm.weight``) and Gemma-1/Gemma-2 (``GemmaConfig``: the head
tied to the embedding, Gemma-2's renamed norms, softcaps, attention
scale and window) and Mixtral (``MoEConfig``: per-expert ``w1``/``w3``/
``w2`` stacked into ``w_gate``/``w_up``/``w_down`` ``[L, E, in, out]``,
the router kept in fp32):

    from skypilot_tpu_torch.models import convert
    config, params = convert.from_hf('/ckpts/Llama-3.1-8B', device='cpu')

or from the CLI (writes the port's format, which ``train/launch.py
--init-params`` reads):

    python -m skypilot_tpu_torch.models.convert \\
        --src /ckpts/Llama-3.1-8B --out /ckpts/llama31-xsky

The source is a directory of ``*.safetensors`` files, read tensor by
tensor by a small numpy reader of the format (an 8-byte header length,
a JSON header, raw little-endian bytes; bf16 read as uint16 and widened
to fp32), so no ``safetensors`` package is needed; or
``pytorch_model*.bin`` files, read with ``torch.load(...,
weights_only=True)``; or an in-memory transformers model. Layer weights
stack to the ``[L, in, out]`` layout with the contraction transposed
from torch's ``[out, in]``; the cast to the model type happens on the
target device, so the tree equals the reference's bit for bit.

The output is ``params.pt`` (``torch.save`` of the tree, host tensors)
beside the reference's ``xsky_model.json`` metadata.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import struct
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import Device, resolve_device
from skypilot_tpu_torch.models import gemma
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.models import qwen

Params = Dict[str, Any]

PARAMS_FILE = 'params.pt'
META_FILE = 'xsky_model.json'

_ST_DTYPES = {'F64': np.float64, 'F32': np.float32, 'F16': np.float16,
              'BF16': np.uint16, 'I64': np.int64, 'I32': np.int32,
              'I16': np.int16, 'I8': np.int8, 'U8': np.uint8}


class SafetensorsFile:
    """Lazy reader of one ``.safetensors`` file: ``keys()`` and
    ``get(name)`` → a numpy array (bf16 widened exactly to fp32)."""

    def __init__(self, path: str) -> None:
        with open(path, 'rb') as f:
            (header_len,) = struct.unpack('<Q', f.read(8))
            header = json.loads(f.read(header_len).decode('utf-8'))
        header.pop('__metadata__', None)
        self._header = header
        self._data = np.memmap(path, dtype=np.uint8, mode='r',
                               offset=8 + header_len)

    def keys(self):
        return self._header.keys()

    def get(self, name: str) -> np.ndarray:
        info = self._header[name]
        start, end = info['data_offsets']
        if info['dtype'] not in _ST_DTYPES:
            raise ValueError(f'{name}: unsupported safetensors dtype '
                             f'{info["dtype"]!r}')
        raw = self._data[start:end].view(
            np.dtype(_ST_DTYPES[info['dtype']]).newbyteorder('<'))
        if info['dtype'] == 'BF16':
            raw = (raw.astype(np.uint32) << 16).view(np.float32)
        return np.asarray(raw).reshape(info['shape'])


class _TensorSource:
    """Uniform tensor access over safetensors shards / torch bins /
    an in-memory transformers model's state_dict."""

    def __init__(self, src) -> None:
        self._get: Callable[[str], np.ndarray]
        if not isinstance(src, (str, os.PathLike)):
            state = {k: v.detach().cpu().float().numpy()
                     for k, v in src.state_dict().items()}
            # transformers state_dicts may or may not carry the
            # 'model.' prefix depending on how the module was built.
            self._keys = set(state)
            self._get = state.__getitem__
            self.config = json.loads(src.config.to_json_string())
            return
        src = str(src)
        with open(os.path.join(src, 'config.json'),
                  encoding='utf-8') as f:
            self.config = json.load(f)
        st_files = sorted(
            f for f in os.listdir(src) if f.endswith('.safetensors'))
        if st_files:
            self._where = {}
            for name in st_files:
                handle = SafetensorsFile(os.path.join(src, name))
                for key in handle.keys():
                    self._where[key] = handle
            self._keys = set(self._where)
            self._get = lambda k: self._where[k].get(k)
            return
        bins = sorted(f for f in os.listdir(src)
                      if f.endswith('.bin') and 'pytorch_model' in f)
        if not bins:
            raise FileNotFoundError(
                f'{src}: no *.safetensors or pytorch_model*.bin')
        state = {}
        for b in bins:
            state.update(torch.load(os.path.join(src, b),
                                    map_location='cpu',
                                    weights_only=True))
        state = {k: v.float().numpy() for k, v in state.items()}
        self._keys = set(state)
        self._get = state.__getitem__

    def __contains__(self, key: str) -> bool:
        return key in self._keys or f'model.{key}' in self._keys

    def get(self, key: str) -> np.ndarray:
        if key in self._keys:
            return np.asarray(self._get(key), np.float32)
        return np.asarray(self._get(f'model.{key}'), np.float32)


def _stack(source: _TensorSource, template: str, n_layers: int,
           transpose: bool) -> np.ndarray:
    rows = []
    for i in range(n_layers):
        t = source.get(template.format(i=i))
        rows.append(t.T if transpose else t)
    return np.stack(rows)


def _detect_family(hf_config: dict) -> str:
    mt = hf_config.get('model_type', '')
    if mt in ('qwen2', 'qwen3'):
        return 'qwen'
    if mt in ('gemma', 'gemma2'):
        return 'gemma'
    if mt in ('llama', 'mistral'):
        return 'llama'
    if mt == 'mixtral':
        return 'moe'
    raise ValueError(f'Unsupported HF model_type {mt!r} (supported: '
                     'llama, mistral, qwen2, qwen3, gemma, mixtral)')


def _common_layers(source: _TensorSource, n_layers: int,
                   mlp: Optional[Params] = None) -> Params:
    """The attention projections, the MLP and the two norms of every
    layer, stacked, in the model's order: the dense SwiGLU weights, or
    ``mlp`` (name → stacked array) in their place."""
    p = 'layers.{i}.'
    layers = {
        'wq': _stack(source, p + 'self_attn.q_proj.weight', n_layers,
                     transpose=True),
        'wk': _stack(source, p + 'self_attn.k_proj.weight', n_layers,
                     transpose=True),
        'wv': _stack(source, p + 'self_attn.v_proj.weight', n_layers,
                     transpose=True),
        'wo': _stack(source, p + 'self_attn.o_proj.weight', n_layers,
                     transpose=True),
    }
    if mlp is None:
        mlp = {ours: _stack(source, p + f'mlp.{theirs}.weight', n_layers,
                            transpose=True)
               for ours, theirs in (('w_gate', 'gate_proj'),
                                    ('w_up', 'up_proj'),
                                    ('w_down', 'down_proj'))}
    layers.update(mlp)
    layers['attn_norm'] = _stack(source, p + 'input_layernorm.weight',
                                 n_layers, transpose=False)
    layers['mlp_norm'] = _stack(source, p + 'post_attention_layernorm.weight',
                                n_layers, transpose=False)
    return layers


def _lm_head(source: _TensorSource, hf: dict) -> np.ndarray:
    if not hf.get('tie_word_embeddings', False):
        if 'lm_head.weight' not in source:
            # Falling back to the tied embedding here would produce
            # wrong logits with no error — fail loudly like the rest of
            # the converter does for unsupported variants.
            raise ValueError(
                'checkpoint declares tie_word_embeddings=false but has '
                'no lm_head.weight tensor; refusing to silently reuse '
                'the embedding as the output head')
        return source.get('lm_head.weight').T
    return source.get('embed_tokens.weight').T


def _rope_scaling_tuple(hf: dict):
    """HF rope_scaling → the (factor, low, high, orig_ctx) tuple; None
    when absent/default; raise on schemes the RoPE does not implement
    (silently dropping one changes attention)."""
    rs = hf.get('rope_scaling')
    if not rs:
        return None
    rope_type = rs.get('rope_type') or rs.get('type')
    if rope_type in (None, 'default'):
        return None
    if rope_type == 'llama3':
        return (float(rs['factor']),
                float(rs.get('low_freq_factor', 1.0)),
                float(rs.get('high_freq_factor', 4.0)),
                int(rs['original_max_position_embeddings']))
    raise ValueError(f'Unsupported rope_scaling type {rope_type!r} '
                     "(supported: 'llama3', 'default').")


def _check_head_dim(hf: dict) -> None:
    derived = hf['hidden_size'] // hf['num_attention_heads']
    explicit = hf.get('head_dim')
    if explicit is not None and explicit != derived:
        raise ValueError(
            f"checkpoint head_dim {explicit} != hidden_size/num_heads "
            f'{derived}; this family config derives head_dim, so the '
            'converted weights would not reshape (e.g. Mistral-Nemo).')


def _caster(dtype: torch.dtype,
            device: torch.device) -> Callable[[np.ndarray], torch.Tensor]:
    def cast(a: np.ndarray) -> torch.Tensor:
        # fp32 onto the device, then the round to the model type there.
        # A copy: the reader's arrays may be views of a read-only map.
        return torch.from_numpy(np.array(a, np.float32, order='C')).to(
            device).to(dtype)
    return cast


def _convert_llama(source: _TensorSource, dtype: torch.dtype,
                   device: torch.device):
    hf = source.config
    n_layers = hf['num_hidden_layers']
    _check_head_dim(hf)
    config = llama.LlamaConfig(
        vocab_size=hf['vocab_size'],
        d_model=hf['hidden_size'],
        n_layers=n_layers,
        n_heads=hf['num_attention_heads'],
        n_kv_heads=hf.get('num_key_value_heads',
                          hf['num_attention_heads']),
        d_ff=hf['intermediate_size'],
        max_seq_len=hf.get('max_position_embeddings', 8192),
        rope_theta=float(hf.get('rope_theta', 10_000.0)),
        norm_eps=float(hf.get('rms_norm_eps', 1e-5)),
        sliding_window=hf.get('sliding_window'),
        rope_scaling=_rope_scaling_tuple(hf),
        dtype=dtype,
    )

    cast = _caster(dtype, device)
    params = {
        'embed': cast(source.get('embed_tokens.weight')),
        'layers': {k: cast(v) for k, v in
                   _common_layers(source, n_layers).items()},
        'final_norm': cast(source.get('norm.weight')),
        'lm_head': cast(_lm_head(source, hf)),
    }
    return config, params


def _convert_qwen(source: _TensorSource, dtype: torch.dtype,
                  device: torch.device):
    hf = source.config
    n_layers = hf['num_hidden_layers']
    if _rope_scaling_tuple(hf) is not None:
        raise ValueError('rope_scaling is not supported for qwen '
                         'conversion yet.')
    qkv_bias = 'layers.0.self_attn.q_proj.bias' in source
    qk_norm = 'layers.0.self_attn.q_norm.weight' in source
    config = qwen.QwenConfig(
        vocab_size=hf['vocab_size'],
        d_model=hf['hidden_size'],
        n_layers=n_layers,
        n_heads=hf['num_attention_heads'],
        n_kv_heads=hf.get('num_key_value_heads',
                          hf['num_attention_heads']),
        head_dim=hf.get('head_dim', hf['hidden_size'] //
                        hf['num_attention_heads']),
        d_ff=hf['intermediate_size'],
        max_seq_len=hf.get('max_position_embeddings', 8192),
        rope_theta=float(hf.get('rope_theta', 1e6)),
        norm_eps=float(hf.get('rms_norm_eps', 1e-6)),
        qkv_bias=qkv_bias,
        qk_norm=qk_norm,
        dtype=dtype,
    )
    cast = _caster(dtype, device)
    layers = {k: cast(v) for k, v in
              _common_layers(source, n_layers).items()}
    p = 'layers.{i}.self_attn.'
    extra = {}
    if qkv_bias:
        extra.update(bq='q_proj.bias', bk='k_proj.bias', bv='v_proj.bias')
    if qk_norm:
        extra.update(q_norm='q_norm.weight', k_norm='k_norm.weight')
    for ours, theirs in extra.items():
        layers[ours] = cast(_stack(source, p + theirs, n_layers,
                                   transpose=False))
    params = {
        'embed': cast(source.get('embed_tokens.weight')),
        'layers': layers,
        'final_norm': cast(source.get('norm.weight')),
        'lm_head': cast(_lm_head(source, hf)),
    }
    return config, params


def _convert_gemma(source: _TensorSource, dtype: torch.dtype,
                   device: torch.device):
    hf = source.config
    n_layers = hf['num_hidden_layers']
    gemma2 = hf.get('model_type') == 'gemma2'
    if _rope_scaling_tuple(hf) is not None:
        raise ValueError('rope_scaling is not supported for gemma '
                         'conversion yet.')
    attn_scale = None
    if gemma2:
        scalar = hf.get('query_pre_attn_scalar')
        if scalar:
            attn_scale = float(scalar) ** -0.5
    config = gemma.GemmaConfig(
        vocab_size=hf['vocab_size'],
        d_model=hf['hidden_size'],
        n_layers=n_layers,
        n_heads=hf['num_attention_heads'],
        n_kv_heads=hf.get('num_key_value_heads',
                          hf['num_attention_heads']),
        head_dim=hf.get('head_dim', hf['hidden_size'] //
                        hf['num_attention_heads']),
        d_ff=hf['intermediate_size'],
        max_seq_len=hf.get('max_position_embeddings', 8192),
        rope_theta=float(hf.get('rope_theta', 10_000.0)),
        norm_eps=float(hf.get('rms_norm_eps', 1e-6)),
        final_logit_softcap=hf.get('final_logit_softcapping'),
        gemma2=gemma2,
        attn_logit_softcap=(hf.get('attn_logit_softcapping')
                            if gemma2 else None),
        attn_scale=attn_scale,
        sliding_window=hf.get('sliding_window') if gemma2 else None,
        dtype=dtype,
    )
    cast = _caster(dtype, device)
    # Gemma's norms share the (1 + w) convention with the port's model,
    # so the weights map directly; the head is tied to the embedding.
    layers = _common_layers(source, n_layers)
    if gemma2:
        p = 'layers.{i}.'
        # Gemma-2 renames: input_layernorm stays the pre-attention norm;
        # post_attention_layernorm becomes an output norm; the pre-MLP
        # norm is pre_feedforward_layernorm.
        layers['post_attn_norm'] = layers.pop('mlp_norm')
        layers['mlp_norm'] = _stack(
            source, p + 'pre_feedforward_layernorm.weight', n_layers,
            transpose=False)
        layers['post_ffw_norm'] = _stack(
            source, p + 'post_feedforward_layernorm.weight', n_layers,
            transpose=False)
    params = {
        'embed': cast(source.get('embed_tokens.weight')),
        'layers': {k: cast(v) for k, v in layers.items()},
        'final_norm': cast(source.get('norm.weight')),
    }
    return config, params


def _convert_mixtral(source: _TensorSource, dtype: torch.dtype,
                     device: torch.device):
    hf = source.config
    n_layers = hf['num_hidden_layers']
    n_experts = hf['num_local_experts']
    _check_head_dim(hf)
    config = moe.MoEConfig(
        vocab_size=hf['vocab_size'],
        d_model=hf['hidden_size'],
        n_layers=n_layers,
        n_heads=hf['num_attention_heads'],
        n_kv_heads=hf.get('num_key_value_heads',
                          hf['num_attention_heads']),
        d_ff=hf['intermediate_size'],
        max_seq_len=hf.get('max_position_embeddings', 8192),
        rope_theta=float(hf.get('rope_theta', 1e6)),
        norm_eps=float(hf.get('rms_norm_eps', 1e-5)),
        # Carried as the reference carries it; the model's attention
        # takes no window, as the reference's does not.
        sliding_window=hf.get('sliding_window'),
        rope_scaling=_rope_scaling_tuple(hf),
        n_experts=n_experts,
        experts_per_token=hf.get('num_experts_per_tok', 2),
        dtype=dtype,
    )
    cast = _caster(dtype, device)
    p = 'layers.{i}.'

    def expert_stack(name: str) -> np.ndarray:
        # [L, E, in, out]: each expert's [out, in] matrix transposed;
        # w1 = gate (the silu input), w3 = up, w2 = down.
        return np.stack([
            np.stack([source.get(
                p.format(i=i) +
                f'block_sparse_moe.experts.{e}.{name}.weight').T
                for e in range(n_experts)])
            for i in range(n_layers)])

    layers = _common_layers(source, n_layers, mlp={
        'router': _stack(source, p + 'block_sparse_moe.gate.weight',
                         n_layers, transpose=True),
        'w_gate': expert_stack('w1'),
        'w_up': expert_stack('w3'),
        'w_down': expert_stack('w2')})
    # The router stays fp32, as the model's init draws it.
    fp32 = _caster(torch.float32, device)
    layers = {k: (fp32 if k == 'router' else cast)(v)
              for k, v in layers.items()}
    params = {
        'embed': cast(source.get('embed_tokens.weight')),
        'layers': layers,
        'final_norm': cast(source.get('norm.weight')),
        'lm_head': cast(_lm_head(source, hf)),
    }
    return config, params


_CONVERTERS = {'llama': _convert_llama, 'qwen': _convert_qwen,
               'gemma': _convert_gemma, 'moe': _convert_mixtral}


def from_hf(src, dtype: Optional[torch.dtype] = None,
            device: Device = None) -> Tuple[Any, Params]:
    """(config, params) from a local HF checkpoint directory or an
    in-memory transformers model. ``dtype`` defaults to bfloat16; the
    tree lands on ``device`` (the card unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    dtype = dtype or torch.bfloat16
    source = _TensorSource(src)
    return _CONVERTERS[_detect_family(source.config)](source, dtype, device)


def load(path: str, device: Device = None) -> Params:
    """The param tree a ``main`` run wrote to ``path``, on ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return torch.load(os.path.join(path, PARAMS_FILE), map_location=device,
                      weights_only=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Convert a local HF checkpoint to the port\'s param '
                    'layout (params.pt + xsky_model.json).')
    parser.add_argument('--src', required=True,
                        help='HF checkpoint dir (config.json + '
                             'safetensors or pytorch_model*.bin)')
    parser.add_argument('--out', required=True,
                        help='Output dir')
    parser.add_argument('--dtype', default='bf16',
                        choices=['bf16', 'f32'])
    parser.add_argument('--device', default=None,
                        help="Where the cast runs: the card by default; "
                             "'cpu' to convert on the CPU")
    args = parser.parse_args(argv)
    config, params = from_hf(
        args.src, torch.bfloat16 if args.dtype == 'bf16' else torch.float32,
        device=args.device)
    os.makedirs(args.out, exist_ok=True)
    host = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                if isinstance(v, dict) else v.cpu())
            for k, v in params.items()}
    tmp = os.path.join(args.out, f'{PARAMS_FILE}.tmp.{os.getpid()}')
    torch.save(host, tmp)
    os.replace(tmp, os.path.join(args.out, PARAMS_FILE))
    meta = dataclasses.asdict(config)
    meta['dtype'] = args.dtype
    meta['family'] = type(config).__name__
    with open(os.path.join(args.out, META_FILE), 'w',
              encoding='utf-8') as f:
        json.dump(meta, f, indent=1, default=str)
    print(json.dumps({'out': args.out,
                      'family': meta['family'],
                      'params': int(config.num_params())}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
