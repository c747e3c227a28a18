"""Tensor parallelism beside the other axes, on gangs of four gloo ranks
on the CPU, after 3 steps equal to the one-rank port ``Trainer`` and to
the JAX ``Trainer`` at the same plan within the tolerances stated in
``torch_gang_cases.py`` (adamw's parameters against the one-rank port at
``ADAMW_JAX_PARAM_ATOL``, see ``check``); every rank bit for bit the same:

* ``fsdp2_tensor2`` (``data=1,fsdp=2,tensor=2``, the recipe's layout:
  ``wq`` split (None, fsdp, tensor), the embedding (tensor, fsdp)):
  Llama at d_model 128 with adafactor, whose factored statistics average
  over an fsdp dim and a tensor dim, Qwen-3 and Gemma-2;
* ``data2_tensor2``: Llama tiny with adamw, a loss mask and
  ``accum_steps=2``, and Qwen-2 with its biases;
* ``tensor4`` on Llama tiny and Gemma-2 tiny (4 query heads over 2 KV
  heads: two ranks share each KV head, one query head each).
"""
from __future__ import annotations

import signal

import pytest

import torch_gang_cases as cases_lib

PLANS = {
    'fsdp2_tensor2': (dict(data=1, fsdp=2, tensor=2), 4,
                      ['gemma2', 'llama_adafactor', 'qwen3']),
    'data2_tensor2': (dict(data=2, fsdp=1, tensor=2), 4,
                      ['llama_adamw_mask_accum2', 'qwen2']),
    'tensor4': (dict(data=1, fsdp=1, tensor=4), 4,
                ['gemma2', 'llama_adamw_mask_accum2']),
}
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
