"""Rules the PyTorch port keeps, checked on the CPU.

* No module of ``skypilot_tpu_torch`` (nor ``chip_smoke.py``) imports
  jax or anything of ``skypilot_tpu``.
* Entry points run on the card unless the caller asks for the CPU:
  without a card and without ``device='cpu'`` they raise.
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


def test_every_cuda_source_is_built():
    csrc = pathlib.Path(kernels.CSRC_DIR)
    sources = {p.name for p in csrc.glob('*.cu')}
    assert sources == {k.source for k in kernels.REGISTRY}
    assert {k.name for k in kernels.REGISTRY} == {'flash_fwd',
                                                  'decode_attention'}
    assert flash_attention.KERNEL in kernels.REGISTRY
    assert decode_attention.KERNEL in kernels.REGISTRY


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
