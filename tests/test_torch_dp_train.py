"""Data-parallel training of the port over gloo ranks, on the CPU:
``--mesh data=2`` on two ranks (every case of ``torch_gang_cases.py`` but
LoRA) and ``data=2,fsdp=2`` on four (once: Llama with adafactor and
``moe-tiny``, whose capacity and load-balance statistics span all four
ranks), after 3 steps equal to the one-rank port ``Trainer`` and to the
JAX ``Trainer`` at the same plan within the tolerances stated there;
every rank bit for bit the same.
"""
from __future__ import annotations

import signal

import pytest

import torch_gang_cases as cases_lib

PLANS = {
    'data2': (dict(data=2), 2, sorted(set(cases_lib.CASES) - {'lora'})),
    'data2_fsdp2': (dict(data=2, fsdp=2), 4,
                    ['llama_adafactor', 'moe_tiny']),
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
    cases_lib.check(runs[plan][case], case)
