"""FSDP training of the port over two gloo ranks, on the CPU
(``--mesh data=1,fsdp=2``): every case of ``torch_gang_cases.py`` (Llama
at d_model 128 with adafactor and per-layer remat, whose factored
statistics span the sharded embed dim; Llama tiny with adamw, a loss
mask and ``accum_steps=2``; ``moe-tiny`` and ``deepseek-tiny`` with their
load-balance terms; LoRA) on one gang, after 3 steps equal to the
one-rank port ``Trainer`` and to the JAX ``Trainer`` at the same plan
within the tolerances stated there; every rank bit for bit the same.
Also: a factored statistic spans the sharded dim.
"""
from __future__ import annotations

import signal

import pytest

import torch_gang_cases as cases_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import optim

PLANS = {'fsdp2': (dict(data=1, fsdp=2), 2, sorted(cases_lib.CASES))}
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


def test_a_factored_statistic_spans_the_sharded_dim():
    """The adafactor case has leaves whose factored row or column
    statistic is a mean over the dim fsdp splits."""
    cfg = cases_lib.MODELS['llama_wide'][1]
    specs = {path: mesh_lib.logical_to_spec(axes) for path, axes in
             cases_lib.walk_specs(llama.logical_axes(cfg))}
    spanning = []
    for path, leaf in cases_lib.walk(llama.init(cfg, device='meta')):
        dims = optim._factored_dims(tuple(leaf.shape), 128)
        if dims is not None and specs[path].index('fsdp') in dims:
            spanning.append(path)
    assert ('embed',) in spanning and ('layers', 'w_down') in spanning
