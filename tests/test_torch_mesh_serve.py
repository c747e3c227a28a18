"""A serving replica under a mesh: gloo gangs of port ranks vs one rank
and the JAX sharded engine, on the CPU.

Each tiny fp32 family (Llama, Qwen-2, Gemma-2, Mixtral's moe-tiny,
DeepSeek) serves the same requests three ways: a gang of port ranks at a
mesh plan (``tests/torch_gang_worker.py serve``: rank 0's orchestrator
drives the gang's engine proxy, the others follow, ``infer/gang.py``),
one port rank, and for the greedy prompts the JAX ``InferenceEngine(
config, params, mesh=...)`` on the 8 CPU devices (its XLA decode path,
``XSKY_DECODE_ATTN=xla``, as ``tests/unit_tests/test_inference.py``
runs it). Plans: ``tensor=2``, ``data=2`` and ``data=2,tensor=2`` for
the dense families; ``expert=2``, ``data=2`` and ``data=2,expert=2`` for
the routed ones. The requests: two greedy prompts (one asking for
logprobs), one sampled at temperature 0.8 with top-p 0.9, one with
presence and frequency penalties, and (where the family has the chunked
path) one longer than the largest bucket; five requests for four slots,
so one waits for a release.

Caches are fp32 on both sides. Tolerances: tokens identical (greedy, sampled and penalized, against one
rank; greedy against JAX); logprobs within 1e-5 of one rank's (fp32, the
tensor split's partial sums added in another order); every rank's
decoded tokens identical, bit for bit. Each rank holds its slots' and KV
heads' block of the cache and its tensor or expert blocks of the weights.

Every test runs under its own 120 s SIGALRM; every drain is bounded; the
gangs are started once for the module, in two waves, and reaped.
"""
from __future__ import annotations

import os
import signal

import jax
import numpy as np
import pytest
import torch

import torch_gang_cases as cases_lib
import torch_gang_worker
from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import orchestrator as jax_orch
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu_torch import models
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import orchestrator as orch_lib
from skypilot_tpu_torch.infer import sampling
from skypilot_tpu_torch.models import llama

TEST_LIMIT_S = 120
LOGPROB_ATOL = 1e-5
N_NEW = 6
# fp32 caches on both sides (a bf16 cache rounds K and V where each
# package's attention reads them back in its own order).
ENGINE = dict(max_slots=4, max_target_len=64, prefill_buckets=(16, 32),
              kv_dtype=torch.float32)
FAMILIES = {'llama': 'llama_tiny', 'qwen2': 'qwen_tiny',
            'gemma2': 'gemma2_tiny', 'moe': 'moe_tiny',
            'deepseek': 'deepseek_tiny'}
DENSE = ('llama', 'qwen2', 'gemma2')
ROUTED = ('moe', 'deepseek')
# plan name -> (mesh plan, world, families)
PLANS = {
    'tensor2': (dict(tensor=2), 2, DENSE),
    'data2': (dict(data=2), 2, DENSE + ROUTED),
    'data2_tensor2': (dict(data=2, tensor=2), 4, DENSE),
    'expert2': (dict(expert=2), 2, ROUTED),
    'data2_expert2': (dict(data=2, expert=2), 4, ROUTED),
}
# The JAX sharded engine's plan on the 8 CPU devices, per kind.
JAX_PLANS = {'dense': dict(data=4, tensor=2), 'routed': dict(data=4,
                                                             expert=2)}


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 256, n)]


GREEDY = [_prompt(1, 5), _prompt(2, 12)]
LONG = _prompt(3, 40)       # past the largest bucket: chunked prefill


def requests(family):
    out = [dict(prompt_tokens=GREEDY[0], max_new_tokens=N_NEW, logprobs=2),
           dict(prompt_tokens=GREEDY[1], max_new_tokens=N_NEW),
           dict(prompt_tokens=_prompt(4, 9), max_new_tokens=N_NEW,
                temperature=0.8, top_p=0.9),
           dict(prompt_tokens=_prompt(5, 7), max_new_tokens=N_NEW,
                presence_penalty=0.5, frequency_penalty=0.3)]
    if family != 'deepseek':    # no chunked path for the MLA cache
        out.append(dict(prompt_tokens=LONG, max_new_tokens=N_NEW))
    return out


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        del signum, frame
        raise TimeoutError(f'test ran past its {TEST_LIMIT_S} s limit')

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(scope='module', autouse=True)
def _xla_decode_path():
    prev = os.environ.get('XSKY_DECODE_ATTN')
    os.environ['XSKY_DECODE_ATTN'] = 'xla'
    yield
    if prev is None:
        os.environ.pop('XSKY_DECODE_ATTN', None)
    else:
        os.environ['XSKY_DECODE_ATTN'] = prev


def _init(family):
    return jax.tree_util.tree_map(
        np.asarray, cases_lib._jax_base(FAMILIES[family]))


def _port_config(family):
    return cases_lib.MODELS[FAMILIES[family]][1]


def _case(family, plan):
    return dict(model=_port_config(family), init=_init(family), plan=plan,
                engine=ENGINE, requests=requests(family))


# The gangs run in two waves, the two-rank plans together and then the
# four-rank ones, so that a loaded run is not oversubscribed further.
WAVES = (('tensor2', 'data2', 'expert2'), ('data2_tensor2', 'data2_expert2'))


@pytest.fixture(scope='module')
def gangs(tmp_path_factory):
    """Every plan's gang → plan → each rank's results (a list over the
    plan's families)."""
    out = {}
    for wave in WAVES:
        waits = {}
        for name in wave:
            plan, world, families = PLANS[name]
            tmp = str(tmp_path_factory.mktemp(name))
            waits[name] = torch_gang_worker.serve_gang(
                [_case(f, plan) for f in families], world, tmp,
                timeout=110.0, name=name)
        out.update({name: wait() for name, wait in waits.items()})
    return out


def _one_rank(family):
    torch.set_num_threads(1)
    cfg = _port_config(family)
    lib = models.module_for(cfg)
    params = getattr(lib, 'params_from_numpy', llama.params_from_numpy)(
        _init(family), 'cpu')
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, **ENGINE), params, device='cpu')
    orch = orch_lib.Orchestrator(engine)
    reqs = [orch.submit(orch_lib.Request(**r)) for r in requests(family)]
    orch.run_until_drained(max_steps=64)
    return engine, [dict(tokens=r.output_tokens, logprobs=r.token_logprobs,
                         top=r.top_logprobs, error=r.error) for r in reqs]


@pytest.fixture(scope='module')
def one_rank():
    return {f: _one_rank(f) for f in FAMILIES}


@pytest.fixture(scope='module')
def jax_greedy():
    """The JAX sharded engine's greedy tokens for the greedy prompts."""
    out = {}
    for family in FAMILIES:
        cfg = cases_lib.MODELS[FAMILIES[family]][0]
        plan = jax_mesh.MeshPlan(**JAX_PLANS[
            'routed' if family in ROUTED else 'dense'])
        mesh = jax_mesh.build_mesh(plan)
        params = cases_lib._jax_base(FAMILIES[family])
        config = jax_engine.EngineConfig(
            model=cfg, **dict(ENGINE, kv_dtype=jax.numpy.float32))
        engine = jax_engine.InferenceEngine(config, params, mesh=mesh)
        prompts = GREEDY + ([LONG] if family != 'deepseek' else [])
        out[family] = jax_orch.Orchestrator(engine).generate(
            prompts, max_new_tokens=N_NEW)
    return out


CASES = [(plan, family) for plan, (_, _, families) in PLANS.items()
         for family in families]


@pytest.mark.parametrize('plan,family', CASES,
                         ids=[f'{p}-{f}' for p, f in CASES])
def test_gang_serves_one_ranks_tokens(gangs, one_rank, jax_greedy, plan,
                                      family):
    """Greedy, sampled and penalized tokens equal one rank's, the greedy
    ones the JAX sharded engine's, logprobs within 1e-5, and every rank
    decoded the same tokens, bit for bit."""
    ranks = gangs[plan]
    i = PLANS[plan][2].index(family)
    got = ranks[0][i]['outputs']
    want = one_rank[family][1]
    assert all(r['error'] is None for r in got)
    assert [r['tokens'] for r in got] == [r['tokens'] for r in want]
    assert all(len(r['tokens']) == N_NEW for r in got)
    greedy = [got[0]['tokens'], got[1]['tokens']] + (
        [got[4]['tokens']] if family != 'deepseek' else [])
    assert greedy == jax_greedy[family]
    np.testing.assert_allclose(got[0]['logprobs'], want[0]['logprobs'],
                               atol=LOGPROB_ATOL, rtol=0)
    for g, w in zip(got[0]['top'], want[0]['top']):
        assert g.keys() == w.keys()
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   atol=LOGPROB_ATOL, rtol=0)
    steps = [r[i]['decoded'] for r in ranks]
    assert steps[0], 'no decode step ran'
    for other in steps[1:]:
        assert len(other) == len(steps[0])
        for a, b in zip(steps[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize('plan,family', CASES,
                         ids=[f'{p}-{f}' for p, f in CASES])
def test_each_rank_holds_its_blocks(gangs, one_rank, plan, family):
    """The slot cache holds this rank's slots (data) and KV heads
    (tensor; the MLA latent splits its slots only), and the weights this
    rank's tensor or expert blocks (whole over data): a whole cache or a
    whole tree on a rank fails here."""
    mesh, world, families = PLANS[plan]
    i = families.index(family)
    engine = one_rank[family][0]
    whole = engine._k_shape
    data, tensor, expert = (mesh.get(a, 1) for a in ('data', 'tensor',
                                                       'expert'))
    cfg = _port_config(family)
    for rank, result in enumerate(gangs[plan]):
        r = result[i]
        shape = list(whole)
        shape[1] //= data
        if family != 'deepseek':
            shape[3] //= min(tensor, cfg.n_kv_heads)
        assert r['k_shape'] == tuple(shape)
        lo, hi = r['slot_block']
        assert hi - lo == whole[1] // data
        assert lo == (rank // (tensor * expert)) * (hi - lo)
        wq = r['shapes']['layers' if family != 'deepseek'
                         else 'moe_layers']
        if tensor > 1:
            assert wq['wq'][-1] == cfg.n_heads * cfg.head_dim // tensor
            assert r['shapes']['embed'][0] == cfg.vocab_size // tensor
            if 'lm_head' in r['shapes']:    # Gemma's head is tied
                assert (r['shapes']['lm_head'][-1]
                        == cfg.vocab_size // tensor)
        if expert > 1:
            assert wq['w_gate'][1] == cfg.n_experts // expert
        if tensor == expert == 1:
            assert r['param_bytes'] == _nbytes(engine.params)
        else:
            assert r['param_bytes'] < _nbytes(engine.params)


def _nbytes(params):
    from skypilot_tpu_torch.ops import quantization as qops
    return qops.params_nbytes(params)


def test_sampled_rows_take_the_global_draws():
    """A rank's rows of a sampled batch take the noise one process draws
    for the whole batch: the gang's sampled tokens (a request on the
    second slot block at data=2) equal one rank's only so; local draws
    (each block drawing from the start of the stream) differ."""
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn(4, 256, generator=gen)
    temps = torch.full((4,), 0.9)
    top_p = torch.full((4,), 0.95)
    whole = sampling.sample_batched(
        logits, torch.Generator().manual_seed(0), temps, None, top_p)
    rows = sampling.sample_batched(
        logits[2:], torch.Generator().manual_seed(0), temps[2:], None,
        top_p[2:], rows=(4, 2))
    local = sampling.sample_batched(
        logits[2:], torch.Generator().manual_seed(0), temps[2:], None,
        top_p[2:])
    assert torch.equal(rows, whole[2:])
    assert not torch.equal(local, whole[2:])


def test_the_sampled_request_ran_on_the_second_slot_block(gangs):
    """The orchestrator fills the highest free slot first, so at data=2
    the first requests (the sampled one among them) decode on rank 1's
    slots: the sampled-token check above covers a rank whose rows do not
    start the batch."""
    ranks = gangs['data2']
    assert ranks[1][0]['slot_block'] == (2, 4)
    assert ranks[0][0]['outputs'][2]['tokens']


def test_uneven_slots_and_unported_plans_are_refused():
    """max_slots that data x fsdp does not divide, the paged cache, the
    routed families at tensor > 1 (8b-ii), sequence (8c) and stage (8d)
    are refused when the engine is built, each naming where the work
    stands."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    plan = mesh_lib.MeshPlan(data=1)
    mesh = mesh_lib.build_mesh(plan, world=1, rank=0)
    cfg = _port_config('llama')
    params = llama.init(cfg, device='cpu')
    with pytest.raises(NotImplementedError, match='the paged cache'):
        engine_lib.InferenceEngine(
            engine_lib.EngineConfig(model=cfg, kv_page_size=16, **ENGINE),
            params, device='cpu', mesh=mesh)
    for plan_kw, model, item in [
            (dict(data=1, tensor=2), _port_config('moe'), '8b-ii'),
            (dict(data=1, sequence=2), cfg, '8c'),
            (dict(data=1, stage=2), cfg, '8d')]:
        msg = engine_lib.mesh_refusal(mesh_lib.MeshPlan(**plan_kw), model)
        assert f'queue 1 item {item}' in msg
    two = mesh_lib.build_mesh(mesh_lib.MeshPlan(data=2), world=2, rank=0)
    with pytest.raises(ValueError, match='does not split into 2'):
        mesh_lib.serving_layout(two, 3)
