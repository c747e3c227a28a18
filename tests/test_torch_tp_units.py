"""The tensor-parallel pieces of the port, on the CPU:

* a leaf split along two dims (an fsdp dim and a tensor dim) on four
  gloo ranks (``torch_gang_worker.call_gang``): each rank's block is the
  block JAX's ``NamedSharding`` gives its device, the blocks gather back
  to the leaf bit for bit, and a step reads the fsdp dim gathered and the
  tensor dim as the rank's block;
* ``logical_to_spec`` and ``split_for`` over every leaf of every dense
  family at ``data=1,fsdp=2,tensor=2``: the cut dims and their axes are
  the reference's ``PartitionSpec``, and every rank's block is the one
  ``NamedSharding`` gives its device;
* the vocabulary-parallel embedding lookup and chunked cross-entropy on
  2 and 4 gloo ranks against the whole vocabulary on one process
  (targets and tokens in every block, a padded last chunk, a chunk
  whose mask is all zero): loss and the gradients of the table, the
  head and the hidden input, within 1e-6 (fp32, sums over ranks in
  another order);
* ``kv_heads``: the KV heads a rank's query heads read, also when more
  ranks than KV heads share one; the head-count refusal;
* the 8b-ii refusals: the routed families and LoRA at ``tensor=2``, by
  ``Trainer`` and by the launcher's ``resolve_plan``.
"""
from __future__ import annotations

import dataclasses
import signal

import jax
import numpy as np
import pytest
import torch

import torch_gang_worker
from skypilot_tpu import models as jax_models
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu_torch import models
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import launch
from skypilot_tpu_torch.train import trainer

DENSE_CONFIGS = ['tiny', 'mistral-tiny', 'qwen-tiny', 'qwen3-tiny',
                 'gemma-tiny', 'gemma2-tiny']
PLAN = dict(data=1, fsdp=2, tensor=2)
ATOL = 1e-6


@pytest.fixture(autouse=True)
def _time_limit():
    def _fail(signum, frame):
        raise TimeoutError('test exceeded its 120 s budget')
    old = signal.signal(signal.SIGALRM, _fail)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _jax_blocks(plan, spec, shape):
    """Device id -> the index JAX's NamedSharding gives it, per dim."""
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshPlan(**plan),
                                devices=jax.devices()[:4])
    return {d.id: index for d, index in jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec(*spec)).devices_indices_map(
            shape).items()}


def test_a_two_dim_split_shards_and_gathers_back_bit_for_bit(tmp_path):
    leaf = np.random.default_rng(0).standard_normal((8, 12)).astype(
        np.float32)
    axes = ('tensor', 'fsdp')   # the embedding's ('vocab', 'embed')
    ranks = torch_gang_worker.call_gang(
        'split_roundtrip', dict(plan=PLAN, leaf=leaf, axes=axes), 4,
        str(tmp_path))
    want = _jax_blocks(PLAN, axes, leaf.shape)
    for rank, got in enumerate(ranks):
        assert [c[3] for c in got['cuts']] == [('tensor',), ('fsdp',)]
        np.testing.assert_array_equal(got['block'].numpy(),
                                      leaf[want[rank]])
        np.testing.assert_array_equal(got['whole'].numpy(), leaf)
        rows = want[rank][0]
        np.testing.assert_array_equal(got['step'].numpy(), leaf[rows])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize('name', DENSE_CONFIGS)
def test_every_dense_leaf_splits_as_the_reference_at_fsdp2_tensor2(
        name, monkeypatch):
    # No process group: the groups are stand-ins named by their axes.
    monkeypatch.setattr(mesh_lib.Mesh, 'group',
                        lambda self, axes: tuple(axes))
    cfg = models.get_config(name)
    jcfg = jax_models.get_config(name)
    lib = models.module_for(cfg)
    shapes = dict(_leaves(lib.init(cfg, device='meta')))
    jaxes = jax_models.module_for(jcfg).logical_axes(jcfg)
    split_dims = set()
    for rank in range(4):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshPlan(**PLAN), world=4,
                                   rank=rank)
        splits = dict(_leaves(mesh_lib.tree_splits(
            mesh, lib.logical_axes(cfg),
            lib.init(cfg, device='meta'))))
        for path, leaf in shapes.items():
            want = tuple(jax_mesh.logical_to_spec(_get(jaxes, path)))
            split = splits[path]
            got = [None] * leaf.ndim
            for c in (split.cuts if split is not None else ()):
                got[c.dim] = c.axes[0] if len(c.axes) == 1 else c.axes
                split_dims.add((path[-1], c.axes))
            assert tuple(got) == want, (path, got, want)
            index = _jax_blocks(PLAN, want, tuple(leaf.shape))[rank]
            whole = np.arange(leaf.numel()).reshape(leaf.shape)
            block = mesh_lib.shard(torch.from_numpy(whole), split)
            np.testing.assert_array_equal(block.numpy(), whole[index])
    # The recipe's two-dim splits are there: heads, MLP and vocabulary
    # over tensor beside the embed dims over fsdp; wk and wv whole on
    # the tensor ranks.
    assert ('wq', ('tensor',)) in split_dims
    assert ('w_down', ('tensor',)) in split_dims
    assert ('embed', ('tensor',)) in split_dims
    assert ('wk', ('tensor',)) not in split_dims


def _vocab_spec(seed, vocab=64, d=8, b=2, s=11, chunk=4):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int64)
    targets = rng.integers(0, vocab, (b, s)).astype(np.int64)
    # Every block of every split holds some target and some token.
    tokens[0, :8] = targets[1, :8] = np.arange(8) * (vocab // 8)
    mask = (rng.random((b, s)) < 0.7).astype(np.float32)
    mask[:, chunk:2 * chunk] = 0.0   # a chunk that counts nothing
    return dict(table=rng.standard_normal((vocab, d)).astype(np.float32),
                head=rng.standard_normal((d, vocab)).astype(np.float32),
                hidden=rng.standard_normal((b, s, d)).astype(np.float32),
                tokens=tokens, targets=targets, mask=mask, chunk=chunk)


@pytest.mark.parametrize('world', [2, 4])
def test_vocab_parallel_embedding_and_cross_entropy_equal_the_whole(
        world, tmp_path):
    spec = _vocab_spec(world)
    whole = torch_gang_worker.vocab_parallel(spec, 0, 1)
    ranks = torch_gang_worker.call_gang('vocab_parallel', spec, world,
                                        str(tmp_path))
    for rank, got in enumerate(ranks):
        torch.testing.assert_close(got['loss'], whole['loss'], atol=ATOL,
                                   rtol=0)
        torch.testing.assert_close(got['hidden'], whole['hidden'],
                                   atol=ATOL, rtol=0)
        torch.testing.assert_close(
            got['table'], whole['table'].chunk(world)[rank], atol=ATOL,
            rtol=0)
        torch.testing.assert_close(
            got['head'], whole['head'].chunk(world, 1)[rank], atol=ATOL,
            rtol=0)


@pytest.mark.parametrize('parts,want', [
    (1, [(0, 8)]),
    (2, [(0, 4), (4, 8)]),
    (4, [(0, 2), (2, 4), (4, 6), (6, 8)]),
    (8, [(i, i + 1) for i in range(8)]),
    (16, [(i // 2, i // 2 + 1) for i in range(16)]),
])
def test_a_rank_reads_the_kv_heads_of_its_query_heads(parts, want):
    cfg = dataclasses.replace(llama.LLAMA3_8B)   # 32 query, 8 KV heads
    llama.check_tensor_heads(cfg, parts)
    for rank, heads in enumerate(want):
        split = mesh_lib.TensorSplit(parts, rank, None) if parts > 1 \
            else None
        with mesh_lib.tensor_split(split):
            assert llama.kv_heads(cfg) == heads


def test_tensor_splits_that_break_the_gqa_layout_are_refused():
    cfg = dataclasses.replace(llama.LLAMA_TINY, n_heads=6, n_kv_heads=3,
                              d_model=48)
    for parts in (4, 2):   # 6 heads over 4; 3 KV heads over 2
        with pytest.raises(ValueError, match='equal GQA blocks'):
            llama.check_tensor_heads(cfg, parts)


@pytest.mark.parametrize('name,lora', [('moe-tiny', 0),
                                       ('deepseek-tiny', 0), ('tiny', 4)],
                         ids=['moe-tiny', 'deepseek-tiny', 'lora'])
def test_routed_families_and_lora_at_tensor_2_name_8b_ii(name, lora):
    cfg = models.get_config(name)
    plan = trainer.MeshPlan(data=1, tensor=2)
    with pytest.raises(NotImplementedError, match='queue 1 item 8b-ii'):
        trainer.Trainer(trainer.TrainConfig(model=cfg, mesh_plan=plan,
                                            lora_rank=lora), device='cpu')
    with pytest.raises(SystemExit, match='queue 1 item 8b-ii'):
        launch.resolve_plan(plan, 2, cfg, lora)
    # The dense families resolve.
    assert launch.resolve_plan(plan, 2, models.get_config('tiny')) == \
        trainer.MeshPlan(data=1, tensor=2)
