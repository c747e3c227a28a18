"""Tensor-parallel training of the port over two gloo ranks, on the CPU
(``--mesh data=1,fsdp=1,tensor=2``): every dense case of
``torch_gang_cases.py`` (Llama at d_model 128 with adafactor and
per-layer remat; Llama tiny with adamw, a loss mask and
``accum_steps=2``; Qwen-2 tiny with its Q/K/V biases; Qwen-3 tiny with
QK-norm and adafactor; Gemma-2 tiny with its tied head, softcaps, window
and a loss mask) on one gang, after 3 steps equal to the one-rank port
``Trainer`` and to the JAX ``Trainer`` at the same plan within the
tolerances stated there (loss, grad norm, every parameter and optimizer
leaf, gathered; adamw's parameters against the one-rank port at
``ADAMW_JAX_PARAM_ATOL``, see ``check``); every rank bit for bit the
same.
"""
from __future__ import annotations

import signal

import pytest

import torch_gang_cases as cases_lib

DENSE = ['gemma2', 'llama_adafactor', 'llama_adamw_mask_accum2', 'qwen2',
         'qwen3']
PLANS = {'tensor2': (dict(data=1, fsdp=1, tensor=2), 2, DENSE)}
PAIRS = [(p, c) for p in sorted(PLANS) for c in PLANS[p][2]]


@pytest.fixture(autouse=True)
def _time_limit():
    def _fail(signum, frame):
        raise TimeoutError('test exceeded its 120 s budget')
    old = signal.signal(signal.SIGALRM, _fail)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    return cases_lib.run_plans(PLANS, tmp_path_factory)


@pytest.mark.parametrize('plan,case', PAIRS,
                         ids=[f'{p}-{c}' for p, c in PAIRS])
def test_gang_steps_equal_one_rank_and_jax(runs, plan, case):
    cases_lib.check(runs[plan][case], case,
                    adamw_params_atol=cases_lib.ADAMW_JAX_PARAM_ATOL)
