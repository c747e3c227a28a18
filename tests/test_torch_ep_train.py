"""Expert parallelism of the port over gloo ranks, on the CPU: the routed
families' experts split over the mesh's ``expert`` axis, each rank
running the (token, choice) pairs routed to its experts and the routed
output summed over the group (``mesh_lib.expert_split``).

* ``expert2`` (``data=1,fsdp=1,expert=2``, two ranks) and
  ``fsdp2_expert2`` (``data=1,fsdp=2,expert=2``, four ranks: the expert
  stacks cut along their expert dim and their embed dim) on ``moe-tiny``,
  ``deepseek-tiny`` (shared experts and a dense first layer, replicated
  over ``expert``) and ``moe-tiny`` at capacity factor 0.5 with remat and
  adafactor (choices dropped; the factored statistics over blocks of
  both cuts): after 3 steps equal to the one-rank port ``Trainer`` and to
  the JAX ``Trainer`` at the same plan within the tolerances stated in
  ``torch_gang_cases.py``; every rank bit for bit the same;
* the step-1 loss and every whole gradient at both plans against one
  rank's, at a load-balance coefficient of 1 so that the term's share of
  the router's gradient is large: the router's gradient leaves the
  backward whole on each expert rank and the load-balance term counts
  once. A router gradient summed over the expert ranks after the fact
  (twice the one-rank gradient), or the term counted once per expert
  rank, would be off by far more than the tolerance, which the test
  checks too.
"""
from __future__ import annotations

import dataclasses
import signal

import pytest
import torch

import torch_gang_cases as cases_lib
import torch_gang_worker
from skypilot_tpu_torch.models import moe

ROUTED = ['deepseek_tiny', 'moe_drop', 'moe_tiny']
PLANS = {
    'expert2': (dict(data=1, fsdp=1, expert=2), 2, ROUTED),
    'fsdp2_expert2': (dict(data=1, fsdp=2, expert=2), 4, ROUTED),
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
    torch.set_num_threads(1)
    return cases_lib.run_plans(PLANS, tmp_path_factory)


@pytest.mark.parametrize('plan,case', PAIRS,
                         ids=[f'{p}-{c}' for p, c in PAIRS])
def test_gang_steps_equal_one_rank_and_jax(runs, plan, case):
    cases_lib.check(runs[plan][case], case)


def _grad_case(plan, aux_coef=1.0):
    model = dataclasses.replace(cases_lib.MODELS['moe_drop'][1],
                                router_aux_coef=aux_coef)
    return dict(model=model, init=cases_lib.jax_init('moe_drop')[0],
                batches=cases_lib.batches(False)[:1],
                train=dict(global_batch_size=cases_lib.BATCH,
                           seq_len=cases_lib.SEQ, mesh_plan=plan))


@pytest.mark.parametrize('plan', ['expert2', 'fsdp2_expert2'])
def test_router_gradient_is_whole_and_the_load_balance_term_counts_once(
        tmp_path, plan):
    mesh_plan, world, _ = PLANS[plan]
    ranks = torch_gang_worker.call_gang(
        'expert_grads', dict(case=_grad_case(mesh_plan)), world,
        str(tmp_path))
    one, doubled = (torch_gang_worker.expert_grads(
        dict(case=_grad_case({}, coef)), 0, 1) for coef in (1.0, 2.0))
    names = [path for path, _ in cases_lib.walk(
        moe.init(cases_lib.MODELS['moe_drop'][1], device='meta'))]
    for rank in ranks:
        assert torch.equal(rank['loss'], ranks[0]['loss'])
        torch.testing.assert_close(rank['loss'], one['loss'],
                                   atol=cases_lib.ATOL, rtol=0)
        for name, got, want in zip(names, rank['grads'], one['grads']):
            torch.testing.assert_close(got, want, atol=cases_lib.ATOL,
                                       rtol=cases_lib.ATOL,
                                       msg=lambda m: f'{name}: {m}')
    # The faults this comparison rules out would be far outside its
    # tolerance: the router's gradient summed over the two expert ranks
    # after the fact (twice the one-rank gradient), and the load-balance
    # term counted by each (twice its coefficient).
    router = names.index(('layers', 'router'))
    g = one['grads'][router]
    assert float(g.abs().max()) > 1e3 * cases_lib.ATOL
    assert float((doubled['grads'][router] - g).abs().max()) > (
        1e3 * cases_lib.ATOL)


def test_the_capacity_drop_case_drops_choices():
    """At capacity factor 0.5 the experts' places hold half of a batch's
    choices: every layer of every step drops some."""
    cfg = cases_lib.MODELS['moe_drop'][1]
    tokens = cases_lib.BATCH * cases_lib.SEQ
    cap = moe.expert_capacity(cfg, tokens)
    assert cap == 32
    assert cap * cfg.n_experts < tokens * cfg.experts_per_token
