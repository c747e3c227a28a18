"""The port's checkpoint converter (``models/convert.py``) vs the JAX
package's, on the CPU.

A tiny ``LlamaForCausalLM`` (and a Mistral one) is built with
``transformers`` and saved with ``save_pretrained`` into ``tmp_path``;
both packages convert it. In fp32 the trees agree bit for bit and the
logits of the two ``forward`` functions within 1e-5 (fp32, another
summation order); in bf16 the trees agree bit for bit too. The port's
own safetensors reader and the ``.bin`` path read what the
``safetensors`` package reads, also for a bf16 file. Tiny Qwen-2 (Q/K/V
biases) and Qwen-3 (QK-norm, an explicit head_dim) checkpoints, written
here from a numpy seed, convert to the JAX converter's trees bit for
bit, in fp32 and bf16, and its logits within 1e-5; rope_scaling is
refused for Qwen as in the reference. The Gemma and Mixtral families
raise, naming ROADMAP.md queue 1 item 6.
"""
from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import convert as jax_convert
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import qwen as jax_qwen
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import qwen

transformers = pytest.importorskip('transformers')

LOGITS_ATOL = 1e-5
TOKENS = [[5, 17, 3, 99, 42, 7, 1, 250], [9, 8, 7, 6, 5, 4, 3, 2]]


def _tiny_hf(kind='llama', dtype=torch.float32, **overrides):
    kwargs = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128,
                  rms_norm_eps=1e-5, rope_theta=10_000.0,
                  tie_word_embeddings=False)
    kwargs.update(overrides)
    torch.manual_seed(0)
    if kind == 'mistral':
        cfg = transformers.MistralConfig(sliding_window=4, **kwargs)
        model = transformers.MistralForCausalLM(cfg)
    else:
        cfg = transformers.LlamaConfig(**kwargs)
        model = transformers.LlamaForCausalLM(cfg)
    return model.to(dtype).eval()


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}/{k}'))
        return out
    return {prefix: tree}


def _bits(x):
    """Raw bits of a tree leaf (torch or JAX), for bit-for-bit checks."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32)
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x.view(np.int32)


@pytest.fixture(scope='module')
def saved(tmp_path_factory):
    """{'llama', 'mistral', 'bin', 'bf16'}: checkpoint dirs written by
    save_pretrained (safetensors unless named 'bin')."""
    root = tmp_path_factory.mktemp('hf')
    out = {}
    for name, model, safe in (
            ('llama', _tiny_hf(), True),
            ('mistral', _tiny_hf('mistral'), True),
            ('bin', _tiny_hf(), False),
            ('bf16', _tiny_hf(dtype=torch.bfloat16,
                              rope_scaling={'rope_type': 'llama3',
                                            'factor': 8.0,
                                            'low_freq_factor': 1.0,
                                            'high_freq_factor': 4.0,
                                            'original_max_position_'
                                            'embeddings': 32}), True)):
        path = root / name
        model.save_pretrained(path, safe_serialization=safe)
        out[name] = str(path)
    return out


@pytest.mark.parametrize('name', ['llama', 'mistral', 'bin'])
def test_fp32_trees_equal_jax_and_logits_agree(saved, name):
    jcfg, jp = jax_convert.from_hf(saved[name], dtype=jnp.float32)
    tcfg, tp = convert.from_hf(saved[name], dtype=torch.float32,
                               device='cpu')
    assert dataclasses.asdict(tcfg) == {
        **dataclasses.asdict(jcfg), 'dtype': torch.float32}
    want, got = _flat(jp), _flat(tp)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == torch.float32 and got[key].device.type == \
            'cpu'
        np.testing.assert_array_equal(_bits(got[key]), _bits(w),
                                      err_msg=key)
    logits_j = jax_llama.forward(jcfg, jp, jnp.asarray(TOKENS, jnp.int32))
    logits_t = llama.forward(tcfg, tp, torch.tensor(TOKENS))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=LOGITS_ATOL, rtol=0)


def test_bf16_trees_equal_jax(saved):
    jcfg, jp = jax_convert.from_hf(saved['bf16'])
    tcfg, tp = convert.from_hf(saved['bf16'], device='cpu')
    assert tcfg.rope_scaling == jcfg.rope_scaling == (8.0, 1.0, 4.0, 32)
    want, got = _flat(jp), _flat(tp)
    for key, w in want.items():
        assert got[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got[key]), _bits(w),
                                      err_msg=key)


def test_readers_read_what_safetensors_reads(saved):
    from safetensors.torch import load_file
    for name in ('llama', 'bf16'):
        want = load_file(f'{saved[name]}/model.safetensors')
        reader = convert.SafetensorsFile(f'{saved[name]}/model.safetensors')
        assert set(reader.keys()) == set(want)
        for key, w in want.items():
            np.testing.assert_array_equal(
                reader.get(key).astype(np.float32), w.float().numpy(),
                err_msg=key)
    # The .bin checkpoint holds the same weights as the safetensors one.
    from_bin = convert._TensorSource(saved['bin'])
    from_st = convert._TensorSource(saved['llama'])
    for key in load_file(f'{saved["llama"]}/model.safetensors'):
        np.testing.assert_array_equal(from_bin.get(key), from_st.get(key))


def test_in_memory_model_converts_like_its_directory(saved):
    _, from_dir = convert.from_hf(saved['llama'], dtype=torch.float32,
                                  device='cpu')
    _, from_module = convert.from_hf(_tiny_hf(), dtype=torch.float32,
                                     device='cpu')
    for key, t in _flat(from_dir).items():
        assert torch.equal(_flat(from_module)[key], t), key


@pytest.mark.parametrize('family,item', [
    ('gemma', '6.2'), ('mixtral', '6.3')])
def test_other_families_name_their_roadmap_item(family, item):
    small = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=1, num_attention_heads=4,
                 num_key_value_heads=2)
    cfg = {'gemma': transformers.GemmaConfig,
           'mixtral': transformers.MixtralConfig}[family](**small)
    model = transformers.AutoModelForCausalLM.from_config(cfg)
    jax_convert.from_hf(model, dtype=jnp.float32)   # the reference takes it
    with pytest.raises(NotImplementedError, match=f'queue 1 item {item}'):
        convert.from_hf(model, device='cpu')


def _write_qwen(root, kind, **overrides):
    """A tiny checkpoint in HF's Qwen layout, written here: config.json and
    one safetensors file of fp32 weights from a numpy seed. Qwen-2 carries
    Q/K/V biases; Qwen-3 carries q_norm/k_norm and a head_dim (32) that
    hidden_size / heads (16) does not give."""
    from safetensors.numpy import save_file
    rng = np.random.default_rng(0 if kind == 'qwen2' else 1)
    d, ff, vocab, h, kvh, layers = 64, 128, 256, 4, 2, 2
    hd = 16 if kind == 'qwen2' else 32

    def draw(*shape, mean=0.0):
        return (mean + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    tensors = {'model.embed_tokens.weight': draw(vocab, d),
               'model.norm.weight': draw(d, mean=1.0),
               'lm_head.weight': draw(vocab, d)}
    for i in range(layers):
        p = f'model.layers.{i}.'
        tensors.update({
            p + 'self_attn.q_proj.weight': draw(h * hd, d),
            p + 'self_attn.k_proj.weight': draw(kvh * hd, d),
            p + 'self_attn.v_proj.weight': draw(kvh * hd, d),
            p + 'self_attn.o_proj.weight': draw(d, h * hd),
            p + 'mlp.gate_proj.weight': draw(ff, d),
            p + 'mlp.up_proj.weight': draw(ff, d),
            p + 'mlp.down_proj.weight': draw(d, ff),
            p + 'input_layernorm.weight': draw(d, mean=1.0),
            p + 'post_attention_layernorm.weight': draw(d, mean=1.0)})
        if kind == 'qwen2':
            tensors.update({p + 'self_attn.q_proj.bias': draw(h * hd),
                            p + 'self_attn.k_proj.bias': draw(kvh * hd),
                            p + 'self_attn.v_proj.bias': draw(kvh * hd)})
        else:
            tensors.update({
                p + 'self_attn.q_norm.weight': draw(hd, mean=1.0),
                p + 'self_attn.k_norm.weight': draw(hd, mean=1.0)})
    config = {'model_type': kind, 'vocab_size': vocab, 'hidden_size': d,
              'intermediate_size': ff, 'num_hidden_layers': layers,
              'num_attention_heads': h, 'num_key_value_heads': kvh,
              'max_position_embeddings': 128, 'rope_theta': 1e6,
              'rms_norm_eps': 1e-6, 'tie_word_embeddings': False,
              **({'head_dim': hd} if kind == 'qwen3' else {}), **overrides}
    root.mkdir(parents=True, exist_ok=True)
    (root / 'config.json').write_text(json.dumps(config))
    save_file(tensors, str(root / 'model.safetensors'))
    return str(root)


@pytest.mark.parametrize('kind', ['qwen2', 'qwen3'])
def test_qwen_trees_equal_jax_and_logits_agree(kind, tmp_path):
    src = _write_qwen(tmp_path / kind, kind)
    jcfg, jp = jax_convert.from_hf(src, dtype=jnp.float32)
    tcfg, tp = convert.from_hf(src, dtype=torch.float32, device='cpu')
    assert isinstance(tcfg, qwen.QwenConfig)
    assert dataclasses.asdict(tcfg) == {
        **dataclasses.asdict(jcfg), 'dtype': torch.float32}
    assert (tcfg.qkv_bias, tcfg.qk_norm) == (kind == 'qwen2',
                                             kind == 'qwen3')
    want, got = _flat(jp), _flat(tp)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(_bits(got[key]), _bits(w),
                                      err_msg=key)
    logits_j = jax_qwen.forward(jcfg, jp, jnp.asarray(TOKENS, jnp.int32))
    logits_t = qwen.forward(tcfg, tp, torch.tensor(TOKENS))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=LOGITS_ATOL, rtol=0)
    _, jp16 = jax_convert.from_hf(src)
    _, tp16 = convert.from_hf(src, device='cpu')
    for key, w in _flat(jp16).items():
        got16 = _flat(tp16)[key]
        assert got16.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got16), _bits(w), err_msg=key)


@pytest.mark.parametrize('scaling,match', [
    ({'rope_type': 'llama3', 'factor': 8.0,
      'original_max_position_embeddings': 32},
     'rope_scaling is not supported for qwen'),
    ({'rope_type': 'yarn', 'factor': 2.0}, 'Unsupported rope_scaling')])
def test_qwen_rope_scaling_is_refused_like_jax(tmp_path, scaling, match):
    src = _write_qwen(tmp_path / 'qwen3', 'qwen3', rope_scaling=scaling)
    with pytest.raises(ValueError, match=match):
        jax_convert.from_hf(src, dtype=jnp.float32)
    with pytest.raises(ValueError, match=match):
        convert.from_hf(src, dtype=torch.float32, device='cpu')


def test_refusals_match_jax(saved, tmp_path):
    """A declared-untied head without lm_head, an unknown rope scaling and
    an explicit head_dim that does not derive raise as in the reference."""
    cases = [
        ('no lm_head', dict(tie_word_embeddings=False), 'lm_head'),
        ('yarn', dict(rope_scaling={'rope_type': 'yarn', 'factor': 2.0}),
         'Unsupported rope_scaling'),
        ('head_dim', dict(head_dim=32), 'head_dim'),
    ]
    for name, change, match in cases:
        src = convert._TensorSource(saved['llama'])
        src.config = {**src.config, **change}
        jsrc = jax_convert._TensorSource(saved['llama'])
        jsrc.config = dict(src.config)
        if name == 'no lm_head':
            src._keys.discard('lm_head.weight')
            jsrc._keys.discard('lm_head.weight')
        with pytest.raises(ValueError, match=match):
            jax_convert._convert_llama(jsrc, jnp.float32)
        with pytest.raises(ValueError, match=match):
            convert._convert_llama(src, torch.float32, torch.device('cpu'))


def test_main_writes_params_and_the_reference_metadata(saved, tmp_path,
                                                       capsys, monkeypatch):
    out = tmp_path / 'out'
    assert convert.main(['--src', saved['llama'], '--out', str(out),
                         '--dtype', 'f32', '--device', 'cpu']) == 0
    printed = json.loads(capsys.readouterr().out)
    jcfg, _ = jax_convert.from_hf(saved['llama'], dtype=jnp.float32)
    assert printed == {'out': str(out), 'family': 'LlamaConfig',
                       'params': jcfg.num_params()}
    meta = json.loads((out / 'xsky_model.json').read_text())
    want = json.loads(json.dumps({**dataclasses.asdict(jcfg),
                                  'dtype': 'f32', 'family': 'LlamaConfig'},
                                 default=str))
    assert meta == want
    _, tp = convert.from_hf(saved['llama'], dtype=torch.float32,
                            device='cpu')
    loaded = convert.load(str(out), device='cpu')
    for key, t in _flat(tp).items():
        assert torch.equal(_flat(loaded)[key], t), key
    # Like every entry point of the port: the card unless asked for the
    # CPU.
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        convert.load(str(out))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        convert.from_hf(saved['llama'])
