"""The rank mesh and logical-axis sharding rules.

Counterpart of ``skypilot_tpu/parallel/mesh.py``. The reference lays its
devices out as a ``jax.sharding.Mesh`` over ``MESH_AXES`` and lets XLA
insert the collectives; the port lays the ``torch.distributed`` ranks out
the same way (:func:`build_mesh`: rank r sits where device r sits in the
reference's mesh) and makes the collectives itself:

* every parameter leaf carries a :class:`Split` (from its family's
  ``logical_axes`` through :func:`logical_to_spec`): one :class:`Cut`
  per split dim (its mesh axes, its group, this rank's block), so that
  under fsdp x tensor ``wq`` is cut along its embed dim over ``fsdp`` and
  its heads over ``tensor``. :func:`shard` takes the block,
  :func:`gather` puts the leaf back together;
* inside a training step a stacked layer leaf is a :class:`Sharded`
  view: indexing it by layer gives that layer's block, and
  :func:`gathered` (called where a family's layer starts) all-gathers
  its fsdp dims with a gradient that is reduce-scattered back
  (:class:`_Gather`); a tensor dim stays this rank's block. The
  families call it inside their per-layer checkpoint, whose recompute
  gathers again; without one, :func:`regathering` saves the block in the
  gathered weight's place. No gathered weight is kept for the backward;
* :func:`batch_split` marks the rows of one global batch as split over
  a group of ranks: the families' losses then divide by the global token
  count (:func:`batch_total`) and the router counts its capacity and
  load-balance statistics over the global batch (:func:`batch_offsets`),
  as the reference's SPMD step computes them. Each rank's loss is then
  its share of the global loss, and the shares sum to it;
* :func:`tensor_split` tells the families the tensor group (Megatron's
  layout, with its collectives explicit where the reference's XLA
  inserts them): a replicated activation enters a head-, MLP- or
  vocabulary-split product through :func:`tensor_input` (identity; its
  gradient summed over the group), and a row-split product's partial
  leaves through :func:`tensor_sum` (summed over the group; its
  gradient as it is). A whole leaf that each rank reads for its own
  heads alone (``wk``, ``wv``) goes through :func:`tensor_input` too, so
  every gradient leaves the backward whole on each tensor rank and the
  trainer sums over the batch ranks only;
* :func:`expert_split` tells the routed families the expert group: each
  rank holds the experts of its block and reads the same rows as the
  other ranks of the group (the batch splits over ``('data', 'fsdp')``
  only, as in the reference). The activation entering the dispatch and
  the gate values entering the combine go through :func:`expert_input`,
  and the routed output leaves through :func:`expert_sum`, so that here
  too every gradient leaves the backward whole on each rank.

The ``data``, ``fsdp``, ``expert`` and ``tensor`` axes train above 1;
``Trainer`` refuses the others.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef

from skypilot_tpu_torch.parallel import distributed

# Canonical mesh axis order: outermost (slowest) first.
MESH_AXES = ('data', 'stage', 'fsdp', 'sequence', 'expert', 'tensor')


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Degree of each parallelism axis. -1 on `data` means 'absorb rest'."""
    data: int = -1
    stage: int = 1      # pipeline stages
    fsdp: int = 1       # param/grad/optimizer sharding (ZeRO-3 twin)
    sequence: int = 1   # context parallelism (ring attention axis)
    expert: int = 1     # MoE expert parallelism
    tensor: int = 1     # megatron-style tensor parallelism

    def resolve(self, num_devices: int) -> 'MeshPlan':
        sizes = dataclasses.asdict(self)
        fixed = math.prod(v for v in sizes.values() if v != -1)
        free = [k for k, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError('At most one mesh axis may be -1.')
        if free:
            if num_devices % fixed:
                raise ValueError(
                    f'{num_devices} devices not divisible by fixed axes '
                    f'product {fixed} ({sizes}).')
            sizes[free[0]] = num_devices // fixed
        elif fixed != num_devices:
            raise ValueError(
                f'Mesh plan {sizes} needs {fixed} devices, got '
                f'{num_devices}.')
        return MeshPlan(**sizes)

    def axis_sizes(self) -> Tuple[int, ...]:
        d = dataclasses.asdict(self)
        return tuple(d[a] for a in MESH_AXES)


class Mesh:
    """The ranks arranged over ``MESH_AXES`` (``devices``: an int array of
    ranks, the reference's device-id grid), and the process groups along
    them, made on first use (every rank makes every group, in one
    order)."""

    def __init__(self, plan: MeshPlan, devices: np.ndarray,
                 rank: int = 0) -> None:
        self.plan = plan
        self.devices = devices
        self.rank = rank
        self.size = int(devices.size)
        self.coords = dict(zip(MESH_AXES, (
            int(i) for i in np.argwhere(devices == rank)[0])))
        self._groups: Dict[Tuple[str, ...], Any] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(MESH_AXES, self.devices.shape))

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axes_index(self, axes: Sequence[str]) -> int:
        """This rank's position along ``axes`` (the first the slowest),
        as JAX numbers the blocks of a dim split over several axes."""
        index = 0
        for a in axes:
            index = index * self.shape[a] + self.coords[a]
        return index

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only
        along ``axes`` (in ``axes_index`` order); None for one rank."""
        axes = tuple(a for a in MESH_AXES if a in axes
                     and self.shape[a] > 1)
        if not axes:
            return None
        if axes not in self._groups:
            moved = np.moveaxis(
                self.devices, [MESH_AXES.index(a) for a in axes],
                range(self.devices.ndim - len(axes), self.devices.ndim))
            rows = moved.reshape(-1, self.axes_size(axes))
            mine = None
            for row in rows:   # every rank makes every group, in order
                g = torch.distributed.new_group([int(r) for r in row])
                if self.rank in row:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]


def build_mesh(plan: Optional[MeshPlan] = None, num_slices: int = 1,
               world: Optional[int] = None,
               rank: Optional[int] = None) -> Mesh:
    """The ranks of this world (``distributed.world_size()`` unless
    given) laid out as ``plan`` resolves against it, in ``MESH_AXES``
    order. With ``num_slices > 1`` the 'data' axis is laid across slices
    first (each slice a contiguous block of ranks), as the reference's
    layout for devices without slice topology gives."""
    world = distributed.world_size() if world is None else world
    rank = distributed.rank() if rank is None else rank
    plan = (plan or MeshPlan()).resolve(world)
    shape = plan.axis_sizes()
    if num_slices > 1:
        if plan.data % num_slices:
            raise ValueError(
                f'data axis ({plan.data}) must be a multiple of num_slices '
                f'({num_slices}) for multislice layout.')
        if world % num_slices:
            raise ValueError(
                f'{world} devices not divisible into {num_slices} slices.')
        per_slice = world // num_slices
        ici_shape = (plan.data // num_slices,) + shape[1:]
        slabs = [np.arange(s * per_slice, (s + 1) * per_slice).reshape(
            ici_shape) for s in range(num_slices)]
        devices = np.concatenate(slabs, axis=0)
    else:
        devices = np.arange(world).reshape(shape)
    return Mesh(plan, devices, rank)


# ---- logical axis rules ---------------------------------------------------
# Arrays are annotated with logical axis names; these rules map them onto
# mesh axes (first matching rule wins). MaxText-style layout.

LogicalRules = Tuple[Tuple[str, Any], ...]

DEFAULT_RULES: LogicalRules = (
    ('batch', ('data', 'fsdp')),          # activations: batch over dp+fsdp
    ('activation_length', 'sequence'),    # context parallelism
    ('activation_embed', None),
    ('activation_heads', 'tensor'),
    ('activation_kv', None),
    ('activation_mlp', 'tensor'),
    ('embed', 'fsdp'),                    # params: embed dim over fsdp
    ('heads', 'tensor'),
    ('kv', None),
    ('mlp', 'tensor'),
    ('vocab', 'tensor'),
    ('expert', 'expert'),
    ('layers', None),                     # stacked-layer leading axis
    ('stage', 'stage'),
)

# Pipeline-parallel layout: the stacked layer axis is sharded over the
# 'stage' mesh axis so each pipeline stage holds (and updates) only its
# own block of layers. Everything else is unchanged.
PIPELINE_RULES: LogicalRules = tuple(
    ('layers', 'stage') if name == 'layers' else (name, target)
    for name, target in DEFAULT_RULES)

# One entry per dim: None, a mesh axis, or a tuple of mesh axes (the
# entries of a jax PartitionSpec).
PartitionSpec = Tuple[Any, ...]


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: LogicalRules = DEFAULT_RULES) -> PartitionSpec:
    rule_map = dict(rules)
    spec: List[Any] = []
    used: set = set()
    for name in logical_axes:
        target = rule_map.get(name) if name is not None else None
        if target is None:
            spec.append(None)
            continue
        targets = target if isinstance(target, tuple) else (target,)
        # A mesh axis may shard at most one array dimension.
        targets = tuple(t for t in targets if t not in used)
        used.update(targets)
        if not targets:
            spec.append(None)
        elif len(targets) == 1:
            spec.append(targets[0])
        else:
            spec.append(targets)
    return tuple(spec)


# ---- splits: one leaf's block on this rank --------------------------------

@dataclasses.dataclass(frozen=True)
class Cut:
    """Dim ``dim`` of a leaf cut into ``parts`` equal blocks over the
    ranks of ``group`` (the mesh ``axes``), this rank holding block
    ``index``."""
    dim: int
    parts: int
    index: int
    group: Any
    axes: Tuple[str, ...] = ()

    @property
    def kept(self) -> bool:
        """Whether a step keeps this dim's block (a tensor dim: heads,
        MLP columns, vocabulary; an expert dim: the rank's experts)
        rather than gathering it (an fsdp dim)."""
        return 'tensor' in self.axes or 'expert' in self.axes


@dataclasses.dataclass(frozen=True)
class Split:
    """How one leaf of the full ``shape`` lies on this rank: one Cut per
    split dim, in dim order (at most two: an fsdp dim and a tensor or an
    expert dim).
    ``group`` holds the ranks of every cut's axes together (the ranks
    that hold the leaf's blocks)."""
    shape: Tuple[int, ...]
    cuts: Tuple[Cut, ...]
    group: Any = None

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(a for c in self.cuts for a in c.axes)

    def cut(self, dim: int) -> Optional[Cut]:
        for c in self.cuts:
            if c.dim == dim:
                return c
        return None

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Σ of ``t`` over the ranks that hold the leaf's blocks."""
        return distributed.all_reduce(t, self.group)

    def reduce_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Σ of ``t`` over the ranks that hold the blocks of dim ``dim``
        (``t`` as it is where that dim is whole)."""
        c = self.cut(dim)
        return t if c is None else distributed.all_reduce(t, c.group)

    def drop(self, dim: int) -> Optional['Split']:
        """The split of a statistic that reduces the leaf over ``dim``:
        the other dims' cuts, or None where none is left (the statistic
        is then whole on every rank)."""
        cuts = tuple(dataclasses.replace(c, dim=c.dim - (dim < c.dim))
                     for c in self.cuts if c.dim != dim)
        if not cuts:
            return None
        shape = self.shape[:dim] + self.shape[dim + 1:]
        group = self.group if len(cuts) == len(self.cuts) else cuts[0].group
        return Split(shape, cuts, group)

    @property
    def step_cuts(self) -> Tuple[Cut, ...]:
        """The cuts a step gathers (every one but the tensor and expert
        dims)."""
        return tuple(c for c in self.cuts if not c.kept)


def split_for(mesh: Mesh, spec: PartitionSpec,
              shape: Sequence[int]) -> Optional[Split]:
    """The Split of a leaf of ``shape`` under ``spec`` on this rank, or
    None when no dim is split over more than one rank."""
    cuts = []
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        axes = tuple(a for a in axes if mesh.shape[a] > 1)
        if not axes:
            continue
        parts = mesh.axes_size(axes)
        if shape[dim] % parts:
            raise ValueError(
                f'dim {dim} of a leaf of shape {tuple(shape)} does not '
                f'split into {parts} equal blocks (spec {spec}).')
        cuts.append(Cut(dim, parts, mesh.axes_index(axes),
                        mesh.group(axes), axes))
    if not cuts:
        return None
    group = (cuts[0].group if len(cuts) == 1 else
             mesh.group(tuple(a for c in cuts for a in c.axes)))
    return Split(tuple(shape), tuple(cuts), group)


def tree_splits(mesh: Mesh, logical_tree, shape_tree,
                rules: LogicalRules = DEFAULT_RULES):
    """The Split (or None) of every leaf of ``shape_tree`` (tensors, meta
    ones will do) under its logical axes in ``logical_tree``: the
    counterpart of the reference's ``tree_shardings``."""
    if isinstance(shape_tree, dict):
        return {k: tree_splits(mesh, logical_tree[k], v, rules)
                for k, v in shape_tree.items()}
    return split_for(mesh, logical_to_spec(logical_tree, rules),
                     shape_tree.shape)


def shard(leaf: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    """This rank's block of ``leaf`` (a contiguous copy), or ``leaf``."""
    if split is None:
        return leaf
    for c in split.cuts:
        leaf = leaf.chunk(c.parts, c.dim)[c.index]
    return leaf.contiguous()


def _gather_cuts(block: torch.Tensor, cuts) -> torch.Tensor:
    for c in cuts:
        block = distributed.all_gather(block, c.dim, c.group)
    return block


def gather(block: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    """The whole leaf from every rank's block (a collective: each rank
    of the split's group calls it; one all-gather per cut, in dim
    order), or ``block``."""
    if split is None:
        return block
    return _gather_cuts(block.detach(), split.cuts)


def step_block(block: torch.Tensor, split: Split) -> torch.Tensor:
    """What a step reads of a leaf (no gradient): its step cuts
    gathered, its tensor and expert dims this rank's block."""
    return _gather_cuts(block.detach(), split.step_cuts)


class _Gather(torch.autograd.Function):
    """All-gather of a block along its step cuts in the forward; the
    gradient is the sum over each cut's group, scattered back to the
    blocks (in the reverse order)."""

    @staticmethod
    def forward(ctx, block, split):
        ctx.split = split
        return _gather_cuts(block, split.step_cuts)

    @staticmethod
    def backward(ctx, grad):
        for c in reversed(ctx.split.step_cuts):
            grad = distributed.reduce_scatter(grad, c.dim, c.group)
        return grad, None


class Sharded:
    """A stacked leaf inside a sharded step: ``block`` of the full
    ``split.shape``. ``view[i]`` is layer i's block (a Sharded of one
    dim fewer); :meth:`gather` all-gathers its step cuts with a gradient
    (a tensor or expert dim stays this rank's block). ``shape``/``ndim``
    are the full leaf's; ``storage_ptr`` is the storage of the last
    gathered tensor, which a checkpoint's save policy and
    ``regathering`` match."""

    def __init__(self, block: torch.Tensor, split: Split) -> None:
        self.block = block
        self.split = split
        self.shape = torch.Size(split.shape)
        self.ndim = len(split.shape)
        self._gathered_ptr: Optional[int] = None

    def __getitem__(self, i: int) -> 'Sharded':
        if not isinstance(i, int) or self.split.cut(0) is not None:
            raise TypeError('a Sharded leaf is indexed by layer only')
        return Sharded(self.block[i], self.split.drop(0))

    def gather(self) -> torch.Tensor:
        full = _Gather.apply(self.block, self.split)
        self._gathered_ptr = full.untyped_storage().data_ptr()
        if _REGATHER is not None:
            _REGATHER[self._gathered_ptr] = (
                StorageWeakRef(full.untyped_storage()), self.block,
                self.split)
        return full

    def storage_ptr(self) -> Optional[int]:
        return self._gathered_ptr


def gathered(layer_params: Dict[str, Any]) -> Dict[str, Any]:
    """A layer's weights as a step reads them: each Sharded entry
    all-gathered along its step cuts (with its gradient), the rest as
    they are. Families call this where a layer starts, inside the
    layer's checkpoint."""
    if not any(isinstance(w, Sharded) for w in layer_params.values()):
        return layer_params
    return {k: w.gather() if isinstance(w, Sharded) else w
            for k, w in layer_params.items()}


# storage of a gathered layer weight -> (a weak reference to that
# storage, the weight's block, its split), while ``regathering`` is
# active.
_REGATHER: Optional[Dict[int, Tuple[Any, torch.Tensor, Split]]] = None


class _Block(NamedTuple):
    """A saved tensor that is a gathered weight or a view of one (a
    slice, a transpose): the weight's block and split, and where the
    saved tensor lies in the gathered weight's storage."""
    block: torch.Tensor
    split: Split
    size: Tuple[int, ...]
    stride: Tuple[int, ...]
    offset: int


def _pack(t: torch.Tensor):
    """``t`` as autograd saves it: a gathered weight, or any view of one
    (``llama.local_kv``'s slice of ``wk``, a transpose), by its block and
    its place in the gathered storage; anything else as it is. Matched
    by storage, through a weak reference, so nothing here keeps the
    gathered storage alive."""
    if _REGATHER is None:
        return t
    entry = _REGATHER.get(t.untyped_storage().data_ptr())
    if entry is None or entry[0].expired():
        return t
    return _Block(entry[1], entry[2], tuple(t.size()), tuple(t.stride()),
                  t.storage_offset())


def _unpack(saved):
    """The saved tensor again: for a ``_Block`` the weight gathered anew
    (its storage laid out as the first gather's) and the same view of
    it, bit for bit what was saved."""
    if isinstance(saved, _Block):
        full = step_block(saved.block, saved.split)
        return full.as_strided(saved.size, saved.stride, saved.offset)
    return saved


@contextlib.contextmanager
def regathering():
    """Within (a sharded step's forward and backward): a gathered layer
    weight, or a view of one, that autograd saves for the backward is
    saved as its block and gathered again when the backward reads it, so
    no gathered weight outlives its layer's forward. A checkpointed
    layer's own hooks come first: there the recompute gathers again."""
    global _REGATHER
    prev, _REGATHER = _REGATHER, {}
    try:
        with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
            yield
    finally:
        _REGATHER = prev


def is_stacked(logical_axes: Sequence[Optional[str]]) -> bool:
    return bool(logical_axes) and logical_axes[0] == 'layers'


def step_view(params, splits, logical_tree):
    """The parameter tree a sharded step's loss reads: stacked layer
    leaves as Sharded views (gathered a layer at a time by the layer),
    every other split leaf gathered now (with its gradient); a dim split
    over ``tensor`` stays this rank's block, and a leaf split over
    tensor dims alone is read as it is."""
    if isinstance(params, dict):
        return {k: step_view(params[k], splits[k], logical_tree[k])
                for k in params}
    if splits is None or not splits.step_cuts:
        return params   # whole, or split over tensor dims alone
    if is_stacked(logical_tree):
        return Sharded(params, splits)
    return _Gather.apply(params, splits)


# ---- the batch split over ranks ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """The rows of one global batch split in rank order over ``group``:
    ``parts`` equal blocks, this rank holding block ``index``."""
    parts: int
    index: int
    group: Any


_BATCH: Optional[BatchSplit] = None


@contextlib.contextmanager
def batch_split(split: Optional[BatchSplit]):
    """Within: the families' batch statistics are global over ``split``
    (no-op for None). Active around a sharded step's forward and
    backward (a checkpoint's recompute reads the statistics again)."""
    global _BATCH
    prev, _BATCH = _BATCH, split
    try:
        yield
    finally:
        _BATCH = prev


def current_batch_split() -> Optional[BatchSplit]:
    return _BATCH


def batch_total(count):
    """A per-rank count (tensor or number) summed over the ranks that
    split the batch: the global count. Carries no gradient."""
    if _BATCH is None:
        return count
    if not torch.is_tensor(count):
        return count * _BATCH.parts
    return distributed.all_reduce(count.detach(), _BATCH.group)


def batch_offsets(counts: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For a per-rank count tensor: (the sum over the ranks before this
    one, the sum over every rank), both shaped as ``counts``."""
    if _BATCH is None:
        return torch.zeros_like(counts), counts
    rows = distributed.all_gather(counts.detach()[None], 0, _BATCH.group)
    return rows[:_BATCH.index].sum(0), rows.sum(0)


# ---- the tensor region: heads, mlp and vocabulary over ranks ----------------

@dataclasses.dataclass(frozen=True)
class TensorSplit:
    """The heads, MLP columns and vocabulary of a model split in rank
    order over ``group`` (the mesh's ``tensor`` axis): ``parts`` equal
    blocks, this rank holding block ``index``."""
    parts: int
    index: int
    group: Any

    def block(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this rank's block of ``n`` (heads, rows)."""
        size = n // self.parts
        return self.index * size, (self.index + 1) * size


_TENSOR: Optional[TensorSplit] = None


@contextlib.contextmanager
def tensor_split(split: Optional[TensorSplit]):
    """Within: the families read their weights as this rank's tensor
    blocks (no-op for None). Active around a sharded step's forward and
    backward (a checkpoint's recompute runs the collectives again)."""
    global _TENSOR
    prev, _TENSOR = _TENSOR, split
    try:
        yield
    finally:
        _TENSOR = prev


def current_tensor_split() -> Optional[TensorSplit]:
    return _TENSOR


class _TensorInput(torch.autograd.Function):
    """Identity in the forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_reduce(grad, ctx.group), None


class _TensorSum(torch.autograd.Function):
    """The sum over the group in the forward; the gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return distributed.all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tensor_input(x: torch.Tensor) -> torch.Tensor:
    """``x``, whole on every rank of the tensor group, as read by this
    rank's own heads, MLP columns or vocabulary block: the identity, with
    its gradient (each rank's part) summed over the group, so that it
    leaves whole. The replicated activation entering a split product
    goes through it, and so does a whole leaf that each rank reads for
    its own heads alone (wk, wv). As it is outside ``tensor_split``."""
    if _TENSOR is None:
        return x
    return _TensorInput.apply(x, _TENSOR.group)


def tensor_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every tensor rank's part ``x`` (after a row-split
    product: ``wo``, ``w_down``, the vocabulary-split embedding), whole
    on every rank; its gradient passes as it is. As it is outside
    ``tensor_split``."""
    if _TENSOR is None:
        return x
    return _TensorSum.apply(x, _TENSOR.group)


# ---- the expert region: routed experts over ranks ---------------------------

_EXPERT: Optional[TensorSplit] = None


@contextlib.contextmanager
def expert_split(split: Optional[TensorSplit]):
    """Within: the routed families hold the experts of this rank's block
    of the group (the mesh's ``expert`` axis; a :class:`TensorSplit` of
    its ranks) and run only the (token, choice) pairs routed to them
    (no-op for None). Active around a sharded step's forward and
    backward."""
    global _EXPERT
    prev, _EXPERT = _EXPERT, split
    try:
        yield
    finally:
        _EXPERT = prev


def current_expert_split() -> Optional[TensorSplit]:
    return _EXPERT


def expert_input(x: torch.Tensor) -> torch.Tensor:
    """``x``, whole on every rank of the expert group, as read by this
    rank's experts alone (the activation entering the dispatch, the gate
    values entering the combine): the identity, with its gradient (each
    rank's part) summed over the group. As it is outside
    ``expert_split``."""
    if _EXPERT is None:
        return x
    return _TensorInput.apply(x, _EXPERT.group)


def expert_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every expert rank's part ``x`` (the routed output of
    its experts), whole on every rank; its gradient passes as it is. As
    it is outside ``expert_split``."""
    if _EXPERT is None:
        return x
    return _TensorSum.apply(x, _EXPERT.group)


# ---- serving: slots over the batch axes, weights over tensor and expert -----

# The mesh axes a serving replica's slots split over (the reference's
# KV-cache spec: slots over ('data', 'fsdp'), KV heads over 'tensor').
SLOT_AXES = ('data', 'fsdp')


@dataclasses.dataclass(frozen=True)
class ServingLayout:
    """How one replica's engine lies on this rank: its ``slots`` split in
    rank order into ``parts`` equal blocks over ``group`` (the ranks along
    ``SLOT_AXES``), this rank decoding block ``index``; the heads, MLP
    columns and vocabulary over ``tensor`` and the routed experts over
    ``expert`` (each a :class:`TensorSplit`, or None for one rank). The
    weights are whole over the slot axes."""
    slots: int
    parts: int
    index: int
    group: Any
    tensor: Optional[TensorSplit]
    expert: Optional[TensorSplit]

    @property
    def local_slots(self) -> int:
        return self.slots // self.parts

    @property
    def slot_block(self) -> Tuple[int, int]:
        """[first, stop) of the slots this rank decodes."""
        first = self.index * self.local_slots
        return first, first + self.local_slots


def serving_layout(mesh: Mesh, slots: int) -> ServingLayout:
    """The serving layout of ``slots`` decode slots on this rank of
    ``mesh``; makes its process groups (every rank, in one order)."""
    parts = mesh.axes_size(SLOT_AXES)
    if slots % parts:
        raise ValueError(
            f'max_slots {slots} does not split into {parts} equal blocks '
            f'over the mesh\'s data x fsdp ranks ({mesh.shape["data"]} x '
            f'{mesh.shape["fsdp"]}): give a multiple of {parts}.')
    group = mesh.group(SLOT_AXES)
    splits = {}
    for axis in ('tensor', 'expert'):
        n = mesh.shape[axis]
        splits[axis] = (TensorSplit(n, mesh.coords[axis], mesh.group((axis,)))
                        if n > 1 else None)
    return ServingLayout(slots, parts, mesh.axes_index(SLOT_AXES), group,
                         splits['tensor'], splits['expert'])


def serving_splits(mesh: Mesh, logical_tree, shape_tree,
                   rules: LogicalRules = DEFAULT_RULES):
    """The Split (or None) of every leaf of ``shape_tree`` as a serving
    replica holds it: the training rules' cuts over ``tensor`` and
    ``expert`` alone (a leaf is whole over the slot axes, which split
    slots, not weights)."""
    if isinstance(shape_tree, dict):
        return {k: serving_splits(mesh, logical_tree[k], v, rules)
                for k, v in shape_tree.items()}
    split = split_for(mesh, logical_to_spec(logical_tree, rules),
                      shape_tree.shape)
    cuts = () if split is None else tuple(c for c in split.cuts if c.kept)
    if not cuts:
        return None
    group = (cuts[0].group if len(cuts) == 1 else
             mesh.group(tuple(a for c in cuts for a in c.axes)))
    return Split(split.shape, cuts, group)


def split_cuts(split: Optional[Split]) -> Tuple[Tuple[int, int, int], ...]:
    """``split``'s cuts as ``qops.block`` takes them: (dim, parts,
    index) each."""
    if split is None:
        return ()
    return tuple((c.dim, c.parts, c.index) for c in split.cuts)


def draw_cuts_of(splits, shapes) -> Dict[Tuple[str, Tuple[int, ...]],
                                         Tuple[Tuple[int, int, int], ...]]:
    """{(leaf name, whole shape): its cuts} over a tree of Splits and the
    tree of shapes it splits (a family's meta ``init``): what
    ``llama.draw_cuts`` takes. Leaves of one name and shape (the
    attention of DeepSeek's dense and routed layers) share their logical
    axes, hence their cuts."""
    out: Dict[Tuple[str, Tuple[int, ...]], Any] = {}

    def walk(split, shape, name):
        if isinstance(shape, dict):
            for k in shape:
                walk(split[k], shape[k], k)
            return
        key, cuts = (name, tuple(shape.shape)), split_cuts(split)
        if out.setdefault(key, cuts) != cuts:
            raise ValueError(f'leaves {key} are cut two ways')
    walk(splits, shapes, None)
    return out


def block_tree(params, splits):
    """This rank's blocks of ``params``: a leaf of the whole shape is cut
    (``qops.block``), a leaf already of its block's shape kept."""
    from skypilot_tpu_torch.ops import quantization as qops
    if isinstance(params, dict):
        return {k: block_tree(params[k], splits[k]) for k in params}
    if splits is None or tuple(params.shape) != tuple(splits.shape):
        return params
    return qops.block(params, split_cuts(splits))


def tree_cuts(splits):
    """``split_cuts`` of every leaf of a tree of Splits."""
    if isinstance(splits, dict):
        return {k: tree_cuts(v) for k, v in splits.items()}
    return split_cuts(splits)
