"""The port's rank mesh and sharding rules (``parallel/mesh.py``) against
the reference's (``skypilot_tpu/parallel/mesh.py``), on the CPU with no
process group:

* ``MeshPlan.resolve`` and its errors, word for word;
* ``build_mesh``'s rank grid, with and without ``num_slices``, equal to
  the device-id grid of the JAX ``build_mesh`` on the 8-device CPU mesh
  for the reference tests' plans (and the same refusal);
* each rank's block of a split dim (``Mesh.axes_index``) is the block
  JAX's ``NamedSharding`` gives that device, for the batch rows over
  ``('data', 'fsdp')`` and an embed dim over ``fsdp``;
* the rules, and ``logical_to_spec`` over every leaf of every family's
  ``logical_axes`` (tiny configs), equal the JAX ones; each family's
  ``logical_axes`` is the reference's tree and mirrors its ``init``;
* an expert stack ``('layers', 'expert', 'embed', 'mlp')`` at
  ``data=1,fsdp=2,expert=2`` on four gloo ranks
  (``torch_gang_worker.call_gang``): ``split_for`` cuts its expert dim
  (kept) and its embed dim (gathered in a step), each rank's block is
  the one ``NamedSharding`` gives its device, the blocks gather back bit
  for bit, a step reads the embed dim gathered and the rank's experts,
  ``drop`` and ``reduce_dim`` over each dim (the expert cut's among
  them) give the full leaf's statistics, and ``reduce`` its sum of
  squares.
"""
from __future__ import annotations

import signal

import jax
import numpy as np
import pytest
import torch

import torch_gang_worker
from skypilot_tpu import models as jax_models
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu_torch import models
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import trainer

FAMILY_CONFIGS = ['tiny', 'mistral-tiny', 'qwen-tiny', 'qwen3-tiny',
                  'gemma-tiny', 'gemma2-tiny', 'moe-tiny', 'deepseek-tiny',
                  'deepseek-tiny-moe-only']

# The plans of tests/unit_tests/test_model_and_trainer.py (TestMesh,
# TestShardedTraining), with their slice counts.
GRID_PLANS = [
    (dict(fsdp=4), 1), (dict(fsdp=4, tensor=2), 1), (dict(fsdp=8), 1),
    (dict(data=2, fsdp=2, tensor=2), 1),
    (dict(data=2, fsdp=2, sequence=1, tensor=2), 1), (dict(data=8), 1),
    (dict(data=2, fsdp=2, tensor=2), 2), (dict(data=4, fsdp=2), 2),
    (dict(), 4),
    # multislice_moe.yaml's layout (data=2,fsdp=-1,expert=8 over 2
    # slices) at 8 devices.
    (dict(data=2, fsdp=-1, expert=2), 2),
]


@pytest.fixture(autouse=True)
def _time_limit():
    def _fail(signum, frame):
        raise TimeoutError('test exceeded its 120 s budget')
    old = signal.signal(signal.SIGALRM, _fail)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def test_mesh_plan_and_axes_are_the_reference_s():
    assert mesh_lib.MESH_AXES == jax_mesh.MESH_AXES
    assert trainer.MeshPlan is mesh_lib.MeshPlan
    assert trainer.MESH_AXES == mesh_lib.MESH_AXES
    for kw, n in ((dict(), 8), (dict(fsdp=4), 8), (dict(data=2, fsdp=-1), 8),
                  (dict(data=1, fsdp=-1, tensor=4), 8), (dict(data=1), 1),
                  (dict(stage=2, expert=2), 8)):
        want = jax_mesh.MeshPlan(**kw).resolve(n)
        got = mesh_lib.MeshPlan(**kw).resolve(n)
        assert got.axis_sizes() == want.axis_sizes()
    for kw, n in ((dict(data=-1, fsdp=-1), 8), (dict(fsdp=3), 8),
                  (dict(data=3, fsdp=3), 8), (dict(data=2), 1)):
        with pytest.raises(ValueError) as want:
            jax_mesh.MeshPlan(**kw).resolve(n)
        with pytest.raises(ValueError) as got:
            mesh_lib.MeshPlan(**kw).resolve(n)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize('kw,slices', GRID_PLANS,
                         ids=[f'{k}-{s}' for k, s in GRID_PLANS])
def test_rank_grid_equals_the_jax_device_grid(kw, slices):
    devices = jax.devices()[:8]
    want = jax_mesh.build_mesh(jax_mesh.MeshPlan(**kw), devices=devices,
                               num_slices=slices)
    got = mesh_lib.build_mesh(mesh_lib.MeshPlan(**kw), num_slices=slices,
                              world=8, rank=0)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.devices, ids)
    assert got.shape == dict(want.shape)
    for r in range(8):
        coords = mesh_lib.build_mesh(mesh_lib.MeshPlan(**kw),
                                     num_slices=slices, world=8,
                                     rank=r).coords
        assert got.devices[tuple(coords[a] for a in
                                 mesh_lib.MESH_AXES)] == r


def test_multislice_refusals_are_the_reference_s():
    for kw, n, slices in ((dict(data=3, fsdp=2), 6, 2),
                          (dict(data=1, fsdp=4), 4, 2)):
        with pytest.raises(ValueError) as want:
            jax_mesh.build_mesh(jax_mesh.MeshPlan(**kw),
                                devices=jax.devices()[:n],
                                num_slices=slices)
        with pytest.raises(ValueError) as got:
            mesh_lib.build_mesh(mesh_lib.MeshPlan(**kw), num_slices=slices,
                                world=n, rank=0)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize('spec,shape', [
    ((('data', 'fsdp'), None), (16, 4)),   # batch rows
    ((None, 'fsdp'), (8, 16)),             # an embed dim
    (('fsdp', None), (8, 3)),
])
@pytest.mark.parametrize('kw', [dict(data=2, fsdp=2, tensor=2),
                                dict(fsdp=4, tensor=2), dict(data=8)],
                         ids=['d2f2t2', 'f4t2', 'd8'])
def test_each_rank_holds_the_block_jax_gives_its_device(kw, spec, shape):
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshPlan(**kw),
                                devices=jax.devices()[:8])
    index_map = jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec(*spec)).devices_indices_map(shape)
    for device, index in index_map.items():
        mesh = mesh_lib.build_mesh(mesh_lib.MeshPlan(**kw), world=8,
                                   rank=device.id)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            parts = mesh.axes_size(axes)
            block = shape[dim] // parts
            assert (index[dim].start or 0) == mesh.axes_index(axes) * block
            split = mesh_lib.Split((shape[dim],), (mesh_lib.Cut(
                0, parts, mesh.axes_index(axes), None, axes),))
            block_of = mesh_lib.shard(torch.arange(shape[dim]), split)
            assert block_of.tolist() == list(range(shape[dim]))[index[dim]]


def test_rules_are_the_reference_s():
    assert mesh_lib.DEFAULT_RULES == jax_mesh.DEFAULT_RULES
    assert mesh_lib.PIPELINE_RULES == jax_mesh.PIPELINE_RULES
    for axes in (('batch', None, 'embed'), ('vocab', 'embed'),
                 ('layers', 'expert', 'embed', 'mlp'), (None,),
                 ('batch', 'activation_length', 'activation_heads')):
        for rules in ('DEFAULT_RULES', 'PIPELINE_RULES'):
            assert mesh_lib.logical_to_spec(
                axes, getattr(mesh_lib, rules)) == tuple(
                    jax_mesh.logical_to_spec(axes,
                                             getattr(jax_mesh, rules)))


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


@pytest.mark.parametrize('name', FAMILY_CONFIGS)
def test_logical_axes_and_specs_are_the_reference_s(name):
    cfg = models.get_config(name)
    jcfg = jax_models.get_config(name)
    axes = models.module_for(cfg).logical_axes(cfg)
    jaxes = jax_models.module_for(jcfg).logical_axes(jcfg)
    assert axes == jaxes
    shapes = dict(_leaves(models.module_for(cfg).init(cfg, device='meta')))
    assert set(shapes) == set(p for p, _ in _leaves(axes))
    for path, leaf_axes in _leaves(axes):
        assert len(leaf_axes) == shapes[path].ndim, path
        for rules in ('DEFAULT_RULES', 'PIPELINE_RULES'):
            got = mesh_lib.logical_to_spec(leaf_axes,
                                           getattr(mesh_lib, rules))
            want = jax_mesh.logical_to_spec(_get(jaxes, path),
                                            getattr(jax_mesh, rules))
            assert got == tuple(want), (path, rules)


EXPERT_PLAN = dict(data=1, fsdp=2, expert=2)
EXPERT_AXES = ('layers', 'expert', 'embed', 'mlp')


def test_an_expert_stack_splits_on_two_dims_and_gathers_back(tmp_path):
    leaf = np.random.default_rng(0).standard_normal((2, 4, 8, 6)).astype(
        np.float32)
    spec = mesh_lib.logical_to_spec(EXPERT_AXES)
    assert spec == (None, 'expert', 'fsdp', 'tensor')
    ranks = torch_gang_worker.call_gang(
        'expert_split_pieces', dict(plan=EXPERT_PLAN, leaf=leaf, axes=spec),
        4, str(tmp_path))
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshPlan(**EXPERT_PLAN),
                                devices=jax.devices()[:4])
    want = {d.id: index for d, index in jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec(*spec)).devices_indices_map(
            leaf.shape).items()}
    whole = torch.from_numpy(leaf)
    for rank, got in enumerate(ranks):
        assert [c[3] for c in got['cuts']] == [('expert',), ('fsdp',)]
        assert got['kept'] == [True, False]
        assert got['step_cuts'] == [(2, ('fsdp',))]
        np.testing.assert_array_equal(got['block'].numpy(),
                                      leaf[want[rank]])
        np.testing.assert_array_equal(got['whole'].numpy(), leaf)
        experts = want[rank][1]
        np.testing.assert_array_equal(got['step'].numpy(),
                                      leaf[:, experts])
        # A statistic reduced over one dim keeps the other dims' cuts,
        # renumbered; over dim 1 or 2 it is summed over that cut's ranks.
        e, f = got['cuts'][0][2], got['cuts'][1][2]
        assert got['drop'] == {
            0: [(0, 2, e, ('expert',)), (1, 2, f, ('fsdp',))],
            1: [(1, 2, f, ('fsdp',))],
            2: [(1, 2, e, ('expert',))],
            3: [(1, 2, e, ('expert',)), (2, 2, f, ('fsdp',))]}
        for dim, reduced in got['reduced'].items():
            full = whole.sum(dim)
            rest = tuple(ix for d, ix in enumerate(want[rank]) if d != dim)
            torch.testing.assert_close(reduced, full[rest], atol=1e-5,
                                       rtol=0)
        torch.testing.assert_close(got['norm'], torch.sum(whole * whole),
                                   atol=1e-4, rtol=1e-6)


# ---- the serving layout: slots over data x fsdp, weights over tensor and
# expert --------------------------------------------------------------------

def _no_groups(monkeypatch):
    """Layouts and splits made with no process group (every group None)."""
    monkeypatch.setattr(mesh_lib.Mesh, 'group', lambda self, axes: None)


@pytest.mark.parametrize('kw', [dict(data=2, fsdp=2, tensor=2),
                                dict(data=4, expert=2), dict(data=8),
                                dict(data=1, fsdp=2, tensor=4)],
                         ids=['d2f2t2', 'd4e2', 'd8', 'f2t4'])
def test_a_rank_serves_the_cache_block_jax_gives_its_device(kw,
                                                            monkeypatch):
    """Each rank's slots and KV heads are the block of the reference's
    KV-cache spec, ``(None, ('data', 'fsdp'), None, 'tensor', None)``,
    that ``NamedSharding`` gives its device (at tensor 4 over 2 KV heads
    two ranks share each head, as the reference replicates it)."""
    _no_groups(monkeypatch)
    from skypilot_tpu_torch.models import llama
    cfg = models.get_config('tiny')        # 4 query heads, 2 KV heads
    slots, kvh = 8, cfg.n_kv_heads
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshPlan(**kw),
                                devices=jax.devices()[:8])
    spec = jax.sharding.PartitionSpec(None, ('data', 'fsdp'), None,
                                      'tensor' if kw.get('tensor', 1) <= kvh
                                      else None, None)
    index_map = jax.sharding.NamedSharding(jmesh, spec).devices_indices_map(
        (2, slots, 16, kvh, 16))
    for device, index in index_map.items():
        mesh = mesh_lib.build_mesh(mesh_lib.MeshPlan(**kw), world=8,
                                   rank=device.id)
        layout = mesh_lib.serving_layout(mesh, slots)
        first, stop = layout.slot_block
        assert (first, stop) == (index[1].start or 0, index[1].stop or slots)
        with mesh_lib.tensor_split(layout.tensor):
            heads = llama.kv_heads(cfg)
        want = range(kvh)[index[3]]
        if kw.get('tensor', 1) > kvh:      # a shared head: the rank's own
            group = kw['tensor'] // kvh
            want = range(mesh.coords['tensor'] // group,
                         mesh.coords['tensor'] // group + 1)
        assert heads == (want.start, want.stop)


def _int8(shape, seed=0):
    from skypilot_tpu_torch.ops import quantization as qops
    w = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return w, qops.quantize(w, -2)


@pytest.mark.parametrize('dim', [1, 2], ids=['contraction', 'columns'])
@pytest.mark.parametrize('kind', ['int8', 'int4'])
def test_quantized_blocks_put_back_equal_the_whole_leaf(kind, dim):
    """A quantized stacked weight [L, in, out] cut along its contraction
    rows or its output columns: the blocks' values and scales, put back
    together, are the whole leaf's (int8 scales per output column stay
    whole under a row cut; int4's row groups go with their scales), and
    each block dequantizes to the whole leaf's dequantized block."""
    from skypilot_tpu_torch.ops import quantization as qops
    w = torch.randn((2, 512, 64), generator=torch.Generator().manual_seed(1))
    whole = (qops.quantize(w, -2) if kind == 'int8'
             else qops.quantize4(w, -2, 128))
    parts = 2
    blocks = [qops.block(whole, ((dim, parts, i),)) for i in range(parts)]
    deq = (qops.dequantize if kind == 'int8' else qops.dequantize4)
    full = deq(whole, torch.float32)
    for i, b in enumerate(blocks):
        torch.testing.assert_close(deq(b, torch.float32),
                                   full.chunk(parts, dim)[i], rtol=0,
                                   atol=0)
    if kind == 'int8':
        q = torch.cat([b.q for b in blocks], dim)
        scale = (blocks[0].scale if dim == 1 else
                 torch.cat([b.scale for b in blocks], dim - 1))
        assert torch.equal(q, whole.q) and torch.equal(scale, whole.scale)
        if dim == 1:
            assert all(torch.equal(b.scale, whole.scale) for b in blocks)
    else:
        assert torch.equal(torch.cat([b.q_packed for b in blocks], dim),
                           whole.q_packed)
        assert torch.equal(torch.cat([b.scale for b in blocks], dim),
                           whole.scale)


def test_an_int4_cut_inside_a_row_group_is_refused():
    from skypilot_tpu_torch.ops import quantization as qops
    w = torch.randn((256, 64), generator=torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match='cuts a group'):
        qops.block(qops.quantize4(w, -2, 128), ((0, 4, 1),))


@pytest.mark.parametrize('weight_dtype', [None, 'int8', 'int4'])
@pytest.mark.parametrize('name,kw', [
    ('tiny', dict(data=1, tensor=2)), ('qwen-tiny', dict(data=1, tensor=2)),
    ('gemma2-tiny', dict(data=1, tensor=2)),
    ('moe-tiny', dict(data=1, expert=2)),
    ('deepseek-tiny', dict(data=1, expert=2))],
    ids=['llama', 'qwen', 'gemma2', 'moe', 'deepseek'])
def test_blocks_drawn_as_init_draws_are_the_whole_init_cut(
        name, kw, weight_dtype, monkeypatch):
    """A rank's tree drawn with its cuts (``llama.draw_cuts``: each
    weight drawn whole, a stack one layer at a time, quantized, then cut;
    the constant leaves cut after) equals the whole ``init`` (quantized
    as drawn) cut afterwards (``mesh_lib.block_tree``), bit for bit, leaf
    by leaf, on every rank of the plan; the serving splits cut only
    tensor and expert dims. int4 under a tensor split whose row cut
    falls inside a row group is refused."""
    _no_groups(monkeypatch)
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import quantization as qops
    cfg = models.get_config(name)
    lib = models.module_for(cfg)
    wd = {'int8': torch.int8, 'int4': 'int4', None: None}[weight_dtype]
    whole = lib.init(cfg, device='cpu', weight_dtype=wd)
    shapes = lib.init(cfg, device='meta')
    for rank in range(2):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshPlan(**kw), world=2,
                                   rank=rank)
        splits = mesh_lib.serving_splits(mesh, lib.logical_axes(cfg),
                                         shapes)
        assert all(c.kept for s in _tree_leaves(splits) if s is not None
                   for c in s.cuts)
        if weight_dtype == 'int4' and 'tensor' in kw:
            # wo's and w_down's contraction rows are cut: 32 and 64 rows
            # a block, inside the tiny models' row groups (64 and 128).
            with pytest.raises(ValueError, match='cuts a group'):
                with llama.draw_cuts(mesh_lib.draw_cuts_of(splits, shapes)):
                    lib.init(cfg, device='cpu', weight_dtype=wd)
            continue
        with llama.draw_cuts(mesh_lib.draw_cuts_of(splits, shapes)):
            drawn = mesh_lib.block_tree(
                lib.init(cfg, device='cpu', weight_dtype=wd), splits)
        want = mesh_lib.block_tree(whole, splits)
        for got_leaf, want_leaf in zip(_tree_leaves(drawn), _tree_leaves(want)):
            if qops.is_quantized(want_leaf):
                for f in ('q', 'q_packed', 'scale'):
                    if hasattr(want_leaf, f):
                        assert torch.equal(getattr(got_leaf, f),
                                           getattr(want_leaf, f))
            else:
                assert torch.equal(got_leaf, want_leaf)
        assert qops.params_nbytes(drawn) < qops.params_nbytes(whole)
        assert _tree_leaves(mesh_lib.tree_cuts(splits)) == [
            mesh_lib.split_cuts(s) for s in _tree_leaves(splits)]


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]
