"""Cases, runs and checks shared by the port's sharded-training tests
(``test_torch_fsdp_train.py``, ``test_torch_dp_train.py``,
``test_torch_tp_train.py``, ``test_torch_tp_mesh_train.py``,
``test_torch_ep_train.py``).

A case is a tiny fp32 model and its TrainConfig keywords; it runs 3 steps
on the same global batches (numpy, from a seed) three ways: the JAX
``Trainer`` at a plan on the 8-device CPU mesh, the one-rank port
``Trainer``, and a gang of port ranks (``torch_gang_worker.Gang``), the
port's from the JAX initial trees (and LoRA adapters) carried across.

Tolerances (fp32 on every side, sums over ranks in another order): loss
1e-5 absolute, grad norm 1e-5 relative, parameters and optimizer state
1e-5 absolute. Against JAX, adamw's parameters are held at 5e-5 as in
``test_torch_train.py``, and its bf16 first moment at one bf16 step
(2^-8 relative): it is stored in bf16 on both sides, and a last-digit
difference in a gradient can round it to the neighbouring bf16 value.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gang_worker
from skypilot_tpu import models as jax_models
from skypilot_tpu.models import deepseek as jax_deepseek
from skypilot_tpu.models import gemma as jax_gemma
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import moe as jax_moe
from skypilot_tpu.models import qwen as jax_qwen
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch import models
from skypilot_tpu_torch.models import deepseek
from skypilot_tpu_torch.models import gemma
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.models import qwen
from skypilot_tpu_torch.train import trainer

ATOL = 1e-5
ADAMW_JAX_PARAM_ATOL = 5e-5
STEPS = 3
BATCH, SEQ = 8, 16

_WIDE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=256, max_seq_len=128, remat=True,
             remat_policy='qkvo_gup')
MODELS = {
    'llama_wide': (jax_llama.LlamaConfig(dtype=jnp.float32, **_WIDE),
                   llama.LlamaConfig(dtype=torch.float32, **_WIDE)),
    'llama_tiny': (dataclasses.replace(jax_llama.LLAMA_TINY,
                                       dtype=jnp.float32),
                   dataclasses.replace(llama.LLAMA_TINY,
                                       dtype=torch.float32)),
    'moe_tiny': (dataclasses.replace(jax_moe.MOE_TINY, dtype=jnp.float32),
                 moe.MOE_TINY_F32),
    'deepseek_tiny': (dataclasses.replace(jax_deepseek.DEEPSEEK_TINY,
                                          dtype=jnp.float32),
                      dataclasses.replace(deepseek.DEEPSEEK_TINY,
                                          dtype=torch.float32)),
    # moe-tiny at capacity factor 0.5 (32 places an expert for the
    # batch's 128 tokens x 2 choices over 4 experts: choices are
    # dropped), with per-layer remat.
    'moe_drop': (dataclasses.replace(jax_moe.MOE_TINY, dtype=jnp.float32,
                                     capacity_factor=0.5, remat=True),
                 dataclasses.replace(moe.MOE_TINY_F32, capacity_factor=0.5,
                                     remat=True)),
    # The dense families a tensor split takes besides Llama: Qwen-2's
    # Q/K/V biases, Qwen-3's QK-norm, Gemma-2's tied head, softcaps,
    # window (8, under SEQ) and output norms.
    'qwen_tiny': (dataclasses.replace(jax_qwen.QWEN_TINY, dtype=jnp.float32),
                  qwen.QWEN_TINY_F32),
    'qwen3_tiny': (dataclasses.replace(jax_qwen.QWEN3_TINY,
                                       dtype=jnp.float32),
                   qwen.QWEN3_TINY_F32),
    'gemma2_tiny': (dataclasses.replace(jax_gemma.GEMMA2_TINY,
                                        dtype=jnp.float32),
                    gemma.GEMMA2_TINY_F32),
}
# name -> (model, TrainConfig keywords, a loss mask in the batches)
CASES = {
    # adafactor factors the embedding's, wq/wk/wv's and w_down's
    # statistics over the embed dim that fsdp splits.
    'llama_adafactor': ('llama_wide', dict(optimizer='adafactor'), False),
    'llama_adamw_mask_accum2': ('llama_tiny', dict(accum_steps=2), True),
    'moe_tiny': ('moe_tiny', dict(), False),
    'deepseek_tiny': ('deepseek_tiny', dict(), False),
    'lora': ('llama_tiny', dict(lora_rank=4, lora_alpha=32.0,
                                lora_targets=('wq', 'wv', 'wo')), False),
}


# The tensor-parallel cases (tests/test_torch_tp_*.py): the two Llama
# cases above and one case of each other dense family.
TENSOR_CASES = {
    'qwen2': ('qwen_tiny', dict(), False),
    'qwen3': ('qwen3_tiny', dict(optimizer='adafactor'), False),
    'gemma2': ('gemma2_tiny', dict(), True),
}
# The expert-parallel cases (tests/test_torch_ep_train.py): the routed
# cases above and one with a capacity drop, whose adafactor statistics
# span the expert blocks.
EXPERT_CASES = {
    'moe_drop': ('moe_drop', dict(optimizer='adafactor'), False),
}
ALL_CASES = {**CASES, **TENSOR_CASES, **EXPERT_CASES}


def batches(masked: bool):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)
        batch = {'tokens': tokens, 'targets': np.roll(tokens, -1, axis=1)}
        if masked:
            batch['mask'] = (rng.random((BATCH, SEQ)) < 0.6).astype(
                np.float32)
        out.append(batch)
    return out


def common(case):
    model, kw, masked = ALL_CASES[case]
    return model, dict(global_batch_size=BATCH, seq_len=SEQ,
                       learning_rate=1e-2 if 'lora_rank' in kw else 1e-3,
                       warmup_steps=2, **kw), masked


@functools.lru_cache(maxsize=None)
def _jax_base(model):
    cfg = MODELS[model][0]
    return jax.jit(functools.partial(jax_models.module_for(cfg).init, cfg))(
        jax.random.PRNGKey(0))


def jax_init(case):
    """The initial trees the JAX Trainer draws (its init, and with LoRA
    its adapters, from its own ``init_state``), as numpy arrays."""
    model, kw, _ = common(case)
    if 'lora_rank' not in kw:
        return jax.tree_util.tree_map(np.asarray, _jax_base(model)), None
    plan = jax_mesh.MeshPlan(data=1)
    state = jax_trainer.Trainer(
        jax_trainer.TrainConfig(model=MODELS[model][0], mesh_plan=plan,
                                **kw),
        mesh=jax_mesh.build_mesh(plan, devices=jax.devices()[:1])
    ).init_state()
    return (jax.tree_util.tree_map(np.asarray, state['base']),
            jax.tree_util.tree_map(np.asarray, state['params']))


def jax_run(case, plan, world, init):
    """The JAX Trainer at ``plan`` on ``world`` CPU devices: per step
    loss and grad norm, and its last state."""
    model, kw, masked = common(case)
    jplan = jax_mesh.MeshPlan(**plan)
    tr = jax_trainer.Trainer(
        jax_trainer.TrainConfig(model=MODELS[model][0], mesh_plan=jplan,
                                **kw),
        mesh=jax_mesh.build_mesh(jplan, devices=jax.devices()[:world]))
    state = tr.init_state()
    key = 'base' if 'lora_rank' in kw else 'params'
    for want, got in zip(jax.tree_util.tree_leaves(init[0]),
                         jax.tree_util.tree_leaves(state[key])):
        np.testing.assert_array_equal(np.asarray(got), want)
    metrics = []
    for batch in batches(masked):
        state, m = tr.step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        metrics.append((float(m['loss']), float(m['grad_norm'])))
    return metrics, state


def port_one_rank(case, init, adapters):
    model, kw, masked = common(case)
    cfg = MODELS[model][1]
    tr = trainer.Trainer(trainer.TrainConfig(model=cfg, **kw), device='cpu')
    lib = models.module_for(cfg)
    state = tr.init_state(
        getattr(lib, 'params_from_numpy', llama.params_from_numpy)(
            init, 'cpu'),
        adapters=(llama.params_from_numpy(adapters, 'cpu')
                  if adapters is not None else None))
    metrics = []
    for batch in batches(masked):
        state, m = tr.step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        metrics.append((float(m['loss']), float(m['grad_norm'])))
    return metrics, tr.host_state(state)


def run_plans(plans, tmp_path_factory):
    """Per plan name and case: (the JAX run, the one-rank port run, each
    rank's gang result). ``plans``: name -> (plan, world, cases). The
    gangs start first and run while the JAX and one-rank runs are made."""
    cases = sorted({c for _, _, cs in plans.values() for c in cs})
    inits = {c: jax_init(c) for c in cases}
    gangs = {}
    try:
        for name, (plan, world, plan_cases) in plans.items():
            specs = []
            for c in plan_cases:
                model, kw, masked = common(c)
                specs.append(dict(model=MODELS[model][1],
                                  train=dict(kw, mesh_plan=plan),
                                  init=inits[c][0], adapters=inits[c][1],
                                  batches=batches(masked)))
            gangs[name] = torch_gang_worker.Gang(
                specs, world, str(tmp_path_factory.mktemp(name)))
        one_rank = {c: port_one_rank(c, *inits[c]) for c in cases}
        out = {}
        for name, (plan, world, plan_cases) in plans.items():
            jax_runs = {c: jax_run(c, plan, world, inits[c])
                        for c in plan_cases}
            gang = gangs[name].results()
            out[name] = {c: (jax_runs[c], one_rank[c],
                             [rank[i] for rank in gang])
                         for i, c in enumerate(plan_cases)}
        return out
    finally:
        for g in gangs.values():
            g.kill()


def walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (i,))
    elif torch.is_tensor(tree):
        yield path, tree


def walk_specs(tree, path=()):
    """(path, leaf) of every leaf of a tree of logical axes or specs."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk_specs(v, path + (k,))
    else:
        yield path, tree


def assert_trees_close(got, want, atol):
    got, want = dict(walk(got)), dict(walk(want))
    assert set(got) == set(want)
    for path, w in want.items():
        torch.testing.assert_close(got[path], w, atol=atol, rtol=0,
                                   msg=lambda m: f'{path}: {m}')


def _jax_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _opt_fields(state_j):
    """Field name → the JAX optimizer state's tree of that field (mu,
    nu; v_row, v_col, v)."""
    fields = {}
    for node in jax.tree_util.tree_leaves(
            state_j['opt_state'], is_leaf=lambda x: hasattr(x, '_fields')):
        if hasattr(node, '_fields'):
            for f in node._fields:
                if f in ('mu', 'nu', 'v_row', 'v_col', 'v'):
                    fields[f] = getattr(node, f)
    return fields


def check(run, case, adamw_params_atol=ATOL):
    """The gang against itself (every rank bit for bit), the one-rank
    port and JAX. ``adamw_params_atol``: adamw's parameters against the
    one-rank port (the tensor tests hold them at ADAMW_JAX_PARAM_ATOL, as
    against JAX: a tensor split sums Qwen-2's K bias gradient, which
    cancels to ~1e-8 in RoPE's slowest dims, in another order, and Adam
    scales a gradient that small by 1/(|g| + 1e-8))."""
    (metrics_j, state_j), (metrics_1, host_1), ranks = run
    kw = common(case)[1]
    for rank in ranks:
        for step, (loss, norm) in enumerate(zip(rank['losses'],
                                                rank['grad_norms'])):
            assert loss == ranks[0]['losses'][step]
            assert norm == ranks[0]['grad_norms'][step]
            for want_loss, want_norm in (metrics_1[step], metrics_j[step]):
                assert loss == pytest.approx(want_loss, abs=ATOL)
                assert norm == pytest.approx(want_norm, rel=ATOL)
        assert_trees_close(rank['state'], ranks[0]['state'], atol=0)
    host = ranks[0]['state']
    # Against the one-rank port: the whole state, optimizer included.
    adamw = kw.get('optimizer') != 'adafactor'
    assert_trees_close({k: v for k, v in host.items() if k != 'params'},
                       {k: v for k, v in host_1.items() if k != 'params'},
                       ATOL)
    assert_trees_close(host['params'], host_1['params'],
                       adamw_params_atol if adamw else ATOL)
    # Against JAX: parameters and the optimizer's moments.
    key = 'params'
    param_atol = (ADAMW_JAX_PARAM_ATOL if kw.get('optimizer') != 'adafactor'
                  else ATOL)
    paths = [p for p, _ in walk(host[key])]
    for path, t in walk(host[key]):
        np.testing.assert_allclose(
            t.numpy(), _jax_leaf(state_j[key], path), atol=param_atol,
            err_msg=str(path))
    inner = host['opt_state'][1][0]
    for field, tree_j in _opt_fields(state_j).items():
        for path, t in zip(paths, inner[field]):
            # The bf16 first moment: up to one bf16 step (2^-8 relative)
            # where a gradient's last digit rounds it the other way.
            np.testing.assert_allclose(
                t.float().numpy(),
                _jax_leaf(tree_j, path).astype(np.float32), atol=ATOL,
                rtol=2 ** -8 if t.dtype == torch.bfloat16 else 0,
                err_msg=f'{field} {path}')


