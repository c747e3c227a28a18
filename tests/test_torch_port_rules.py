"""Rules the PyTorch port keeps, checked on the CPU.

* No module of ``skypilot_tpu_torch`` (nor ``chip_smoke.py``) imports
  jax or anything of ``skypilot_tpu``.
* Entry points (the engine, ``init``, the ``Trainer``) run on the card
  unless the caller asks for the CPU: without a card and without
  ``device='cpu'`` they raise.
* Every CUDA source under ``csrc/`` is built by the kernel registry, and
  a kernel wrapper handed a non-CPU tensor launches or raises — it never
  falls back to its plain version.
* ``chip_smoke.py`` fails without a card, and alone in a directory.
"""
from __future__ import annotations

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import decode_attention
from skypilot_tpu_torch.ops import flash_attention
from skypilot_tpu_torch.ops import kernels
from skypilot_tpu_torch.ops import mla_decode
from skypilot_tpu_torch.train import trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / 'skypilot_tpu_torch').rglob('*.py')) + [
    REPO / 'chip_smoke.py']


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    banned = [m for m in _imported_modules(path)
              if m.split('.')[0] in ('jax', 'jaxlib', 'skypilot_tpu',
                                     'flax', 'optax')]
    assert not banned, f'{path} imports {banned}'


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    cfg = engine_lib.EngineConfig(model=llama.LLAMA_TINY, max_slots=2,
                                  max_target_len=32, prefill_buckets=(16,))
    params = llama.init(llama.LLAMA_TINY, device='cpu')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        engine_lib.InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        llama.init(llama.LLAMA_TINY)
    engine = engine_lib.InferenceEngine(cfg, params, device='cpu')
    assert engine.device.type == 'cpu'
    train_cfg = trainer.TrainConfig(model=llama.LLAMA_TINY,
                                    global_batch_size=2, seq_len=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        trainer.Trainer(train_cfg)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        trainer.measure_throughput(trainer.Trainer(train_cfg), num_steps=1)
    assert trainer.Trainer(train_cfg, device='cpu').device.type == 'cpu'


def test_every_cuda_source_is_built():
    csrc = pathlib.Path(kernels.CSRC_DIR)
    sources = {p.name for p in csrc.glob('*.cu')}
    assert sources == {k.source for k in kernels.REGISTRY}
    assert {k.name for k in kernels.REGISTRY} == {
        'flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq', 'decode_attention',
        'paged_decode_attention', 'mla_decode', 'paged_mla_decode'}
    for kern in (flash_attention.KERNEL, flash_attention.DKV_KERNEL,
                 flash_attention.DQ_KERNEL, decode_attention.KERNEL,
                 decode_attention.PAGED_KERNEL, mla_decode.KERNEL,
                 mla_decode.PAGED_KERNEL):
        assert kern in kernels.REGISTRY
    # The dense and the paged decode kernels (K4/K5, and the MLA pair
    # K6/K7) are two sources, two libraries and two launch counts; a
    # shared header reaches both.
    assert (decode_attention.KERNEL.library_path() !=
            decode_attention.PAGED_KERNEL.library_path())
    assert (csrc / 'decode_common.cuh').exists()
    assert (mla_decode.KERNEL.library_path() !=
            mla_decode.PAGED_KERNEL.library_path())
    assert (csrc / 'mla_common.cuh').exists()
    # The two backward kernels share one source and so one library.
    assert (flash_attention.DKV_KERNEL.library_path() ==
            flash_attention.DQ_KERNEL.library_path() !=
            flash_attention.KERNEL.library_path())


def test_wrappers_never_fall_back_on_a_device_tensor():
    """A tensor that is not on the CPU goes to the kernel's launcher,
    which raises for anything but a CUDA tensor; no launch is counted."""
    q = torch.zeros((1, 64, 4, 16), device='meta')
    k = torch.zeros((1, 64, 2, 16), device='meta')
    before = flash_attention.KERNEL.launches
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        flash_attention.flash_attention(q, k, k)
    assert flash_attention.KERNEL.launches == before
    qd = torch.zeros((2, 1, 4, 16), device='meta')
    cache = torch.zeros((2, 32, 2, 16), device='meta')
    lengths = torch.zeros((2,), dtype=torch.int32, device='meta')
    before = decode_attention.KERNEL.launches
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        decode_attention.decode_attention(qd, cache, cache, lengths)
    assert decode_attention.KERNEL.launches == before
    pages = torch.zeros((6, 8, 2, 16), device='meta')
    tables = torch.zeros((2, 4), dtype=torch.int32, device='meta')
    before = decode_attention.PAGED_KERNEL.launches
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        decode_attention.paged_decode_attention(qd, pages, pages, lengths,
                                                tables)
    assert decode_attention.PAGED_KERNEL.launches == before
    q_eff = torch.zeros((2, 4, 32), device='meta')
    q_rope = torch.zeros((2, 4, 8), device='meta')
    latents = torch.zeros((2, 32, 32), device='meta')
    ropes = torch.zeros((2, 32, 8), device='meta')
    before = mla_decode.KERNEL.launches
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        mla_decode.mla_decode_attention(q_eff, q_rope, latents, ropes,
                                        lengths, 0.1)
    assert mla_decode.KERNEL.launches == before
    before = mla_decode.PAGED_KERNEL.launches
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        mla_decode.paged_mla_decode_attention(
            q_eff, q_rope, latents.reshape(8, 8, 32), ropes.reshape(8, 8, 8),
            lengths, tables, 0.1)
    assert mla_decode.PAGED_KERNEL.launches == before
    # The gradient: its launcher raises on a non-CUDA device tensor, and
    # no backward launch is counted.
    q.requires_grad_(True)
    before = [kern.launches for kern in (flash_attention.DKV_KERNEL,
                                         flash_attention.DQ_KERNEL)]
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        flash_attention._flash_bwd(q, k, k, None, q, q,
                                   torch.zeros((1, 4, 64), device='meta'))
    assert [flash_attention.DKV_KERNEL.launches,
            flash_attention.DQ_KERNEL.launches] == before


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    run = subprocess.run([sys.executable, str(REPO / 'chip_smoke.py')],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert run.returncode != 0
    assert '"ok": true' not in run.stdout
    shutil.copy(REPO / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    alone = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                           capture_output=True, text=True,
                           env=dict(env, PYTHONPATH=''), timeout=120)
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout
