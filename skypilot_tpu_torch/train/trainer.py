"""Trainer over one card or a mesh of ranks: TrainConfig, Trainer,
measure_throughput.

Counterpart of ``skypilot_tpu/train/trainer.py``. The step runs eagerly: the model's loss (``loss_fn`` of the config's family,
remat as the config says), its gradient, gradient accumulation over
strided microbatches, the optimizer chain of ``make_optimizer`` and an
in-place parameter update (the JAX step donates the old state instead).
With ``lora_rank > 0`` the base weights are frozen and only the LoRA
adapters (``train/lora.py``) train, merged into the base inside the
loss. Every step emits the telemetry heartbeat and marks its dispatch
time in the flight recorder; every Nth step (``XSKY_PROFILE_SAMPLE_EVERY``)
is sampled by the profiler's step probe (``agent/profiler.py``), which
waits for the card once and hands its (dispatch gap, device) pair to the
flight recorder as a synced record. Unsampled steps never wait for the
card. ``host_state`` and ``load_state`` carry the state to the host and
back for checkpoints (``train/launch.py``).

Over ``torch.distributed`` ranks (one per card, ``parallel/distributed``)
the mesh plan's ``data``, ``fsdp``, ``expert`` and ``tensor`` axes train
as the reference's sharded step does, its collectives made explicit
(``parallel/mesh.py``): each rank holds its blocks of the parameters and
optimizer state (the families' ``logical_axes`` under ``DEFAULT_RULES``:
embed dims over ``fsdp``; heads, MLP and vocabulary over ``tensor``; the
routed experts over ``expert``, as in the reference); the global batch's
rows split over ``('data', 'fsdp')`` in rank order, so the tensor and
expert ranks see the same rows; a layer's weights are all-gathered along
their fsdp dims where the layer starts, inside its checkpoint, and their
gradients reduce-scattered back (a layer without a checkpoint keeps its
block for the backward, ``mesh_lib.regathering``); the dense families
read their tensor blocks Megatron-style (``mesh_lib.tensor_split``) and
the routed families run their own experts (``mesh_lib.expert_split``),
so every gradient leaves the backward whole on each tensor and expert
rank; the remaining gradients are summed over the batch ranks that hold
the same block. Each rank's loss is its share of the global
(mask-)weighted mean (``mesh_lib.batch_split``), so the update equals the
one-rank update on the whole batch. The sequence and stage axes are not
ported yet (ROADMAP.md queue 1 items 8c, 8d), nor the tensor axis for
the routed families, LoRA or beside the expert axis, nor LoRA at expert
> 1 (8b-ii).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch import Device, models, resolve_device
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.agent import profiler
from skypilot_tpu_torch.agent import telemetry
from skypilot_tpu_torch.models import deepseek
from skypilot_tpu_torch.models import gemma
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.models import qwen
from skypilot_tpu_torch.ops import flash_attention as flash_ops
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import lora as lora_lib
from skypilot_tpu_torch.train import optim

Batch = Dict[str, torch.Tensor]

# Re-exported: the plan moved to parallel/mesh.py, as in the reference.
MESH_AXES = mesh_lib.MESH_AXES
MeshPlan = mesh_lib.MeshPlan
# The axes the batch rows split over (PartitionSpec(('data', 'fsdp'),
# None) in the reference).
BATCH_AXES = ('data', 'fsdp')


@dataclasses.dataclass
class TrainConfig:
    model: llama.LlamaConfig = dataclasses.field(
        default_factory=lambda: llama.LLAMA3_8B)
    mesh_plan: MeshPlan = dataclasses.field(default_factory=MeshPlan)
    global_batch_size: int = 8
    seq_len: int = 2048
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    optimizer: str = 'adamw'   # 'adamw' | 'adafactor'
    n_microbatches: int = 4    # GPipe microbatches when mesh stage > 1
    # > 1: gradient accumulation — the step runs that many strided
    # microbatches and applies ONE averaged optimizer update.
    accum_steps: int = 1
    seed: int = 0
    # LoRA fine-tuning: rank 0 = full fine-tune; rank > 0 freezes the
    # base weights (held outside the optimizer) and trains only A/B
    # adapters on `lora_targets`, merged inside the step's loss.
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ('wq', 'wk', 'wv', 'wo')


def make_optimizer(config: TrainConfig,
                   splits=None) -> optim.Transform:
    """The reference's chain; ``splits`` (one ``mesh_lib.Split`` or None
    per optimized leaf) when the leaves are blocks of sharded ones."""
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, config.learning_rate, config.warmup_steps, 10_000)
    if config.optimizer == 'adafactor':
        opt = optim.adafactor(learning_rate=schedule, splits=splits)
    else:
        opt = optim.adamw(schedule, b1=0.9, b2=0.95,
                          weight_decay=config.weight_decay,
                          mu_dtype=torch.bfloat16)
    return optim.Chain(optim.ClipByGlobalNorm(config.grad_clip_norm,
                                              splits), opt)


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The parameter tensors in a fixed order (the tree's own)."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params]


# The mesh axes not ported yet, each with its sub-item of ROADMAP.md
# queue 1 item 8.
UNPORTED_AXES = {
    'sequence': ('8c', 'sequence parallelism (ring and Ulysses attention)'),
    'stage': ('8d', 'pipeline parallelism'),
}
# The families whose heads, MLP and vocabulary split over the tensor
# axis (Megatron's layout); the routed families and LoRA adapters over
# split weights wait for item 8b-ii.
TENSOR_FAMILIES = (llama, qwen, gemma)


def unported_axis_message(axis: str, size: int) -> str:
    item, what = UNPORTED_AXES[axis]
    return (f'mesh {axis}={size}: {what} is not ported yet (ROADMAP.md '
            f'queue 1 item {item}); the port trains over data, fsdp, '
            'expert and tensor.')


def unported_tensor_message(size: int, model, lora_rank: int
                            ) -> Optional[str]:
    """Why ``tensor=size`` cannot train ``model`` (with LoRA adapters of
    ``lora_rank``) yet, or None where it can."""
    if size <= 1:
        return None
    module = models.module_for(model)
    if module not in TENSOR_FAMILIES:
        what = f'the routed family {module.__name__.rsplit(".", 1)[-1]}'
    elif lora_rank > 0:
        what = 'LoRA adapters over split weights'
    else:
        return None
    return (f'mesh tensor={size}: tensor parallelism for {what} is not '
            'ported yet (ROADMAP.md queue 1 item 8b-ii); the dense '
            'families train at tensor > 1 without LoRA.')


def unported_expert_message(plan: MeshPlan, lora_rank: int
                            ) -> Optional[str]:
    """Why ``plan``'s expert axis cannot train (with LoRA adapters of
    ``lora_rank``) yet, or None where it can."""
    if plan.expert <= 1:
        return None
    if plan.tensor > 1:
        what = (f'mesh expert={plan.expert} x tensor={plan.tensor}: tensor '
                'parallelism beside expert parallelism')
    elif lora_rank > 0:
        what = f'mesh expert={plan.expert}: LoRA adapters at expert > 1'
    else:
        return None
    return (f'{what} is not ported yet (ROADMAP.md queue 1 item 8b-ii); '
            'the port trains the full model at expert > 1 with tensor 1.')


def unported_mesh_message(plan: MeshPlan, model, lora_rank: int
                          ) -> Optional[str]:
    """Why ``plan`` cannot train ``model`` (with LoRA adapters of
    ``lora_rank``) yet, naming its sub-item of ROADMAP.md queue 1 item
    8, or None where it can: the one list of refusals that ``Trainer``
    and ``train/launch.py``'s ``resolve_plan`` share."""
    for axis in UNPORTED_AXES:
        size = getattr(plan, axis)
        if size > 1:
            return unported_axis_message(axis, size)
    msg = unported_expert_message(plan, lora_rank)
    if msg or model is None:
        return msg
    return unported_tensor_message(plan.tensor, model, lora_rank)


def _check_mesh(plan: MeshPlan, config: 'TrainConfig') -> None:
    msg = unported_mesh_message(plan, config.model, config.lora_rank)
    if msg:
        raise NotImplementedError(msg)


def _ordered_like(tree, ref):
    """``tree`` with every dict's keys in ``ref``'s order (a tree from
    elsewhere, such as the JAX package's sorted one, takes the family's
    ``init`` order, which the leaves' splits follow)."""
    if not isinstance(ref, dict):
        return tree
    if set(tree) != set(ref):
        raise ValueError(f'parameter tree keys {sorted(tree)} differ from '
                         f"the model's {sorted(ref)}")
    return {k: _ordered_like(tree[k], ref[k]) for k in ref}


def _map_splits(fn, tree, splits):
    """``fn(tensor, split)`` over a state tree and its splits tree (the
    same structure, a split or None where the tree has a tensor; None for
    a subtree that is whole)."""
    if isinstance(tree, dict):
        return {k: _map_splits(fn, v, None if splits is None else splits[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _map_splits(fn, v, None if splits is None else splits[i])
            for i, v in enumerate(tree))
    return fn(tree, splits) if torch.is_tensor(tree) else tree


class Trainer:
    """Initializes state and runs train and eval steps on this rank's
    device, over ``mesh`` (``mesh_lib.build_mesh(config.mesh_plan)``
    over the ranks of the default process group unless given)."""

    def __init__(self, config: TrainConfig, device: Device = None,
                 mesh: Optional[mesh_lib.Mesh] = None) -> None:
        self.config = config
        if config.accum_steps < 1:
            raise ValueError(f'accum_steps must be >= 1, got '
                             f'{config.accum_steps}')
        if config.global_batch_size % config.accum_steps:
            raise ValueError(
                f'global_batch_size {config.global_batch_size} not '
                f'divisible by accum_steps {config.accum_steps}')
        _check_mesh(config.mesh_plan, config)
        self.mesh = mesh if mesh is not None else mesh_lib.build_mesh(
            config.mesh_plan)
        _check_mesh(self.mesh.plan, config)
        self._model_lib = models.module_for(config.model)
        self.device = resolve_device(device)
        # Only a model whose attention goes to the flash kernels needs
        # their head dims; 'xla' (DeepSeek's, whose qk and v head dims
        # differ) trains on the plain attention, as in the reference.
        head_dim = getattr(config.model, 'head_dim', None)
        if (self.device.type == 'cuda'
                and config.model.attention_impl != 'xla'
                and head_dim not in flash_ops.BWD_HEAD_DIMS):
            raise NotImplementedError(
                f'head_dim {head_dim}: the flash backward kernels take '
                f'{flash_ops.BWD_HEAD_DIMS} on the card, so this model '
                'cannot train there.')
        if self.device.type == 'cuda' and self.device.index is None:
            # What tensors report, so that devices compare equal.
            self.device = torch.device('cuda', torch.cuda.current_device())
        self._setup_sharding()
        self.optimizer = make_optimizer(config, self._opt_splits)
        # Host-side step telemetry: dispatch-to-dispatch wall time (no
        # device sync).
        self._host_step = 0
        self._last_step_t: Optional[float] = None
        # Kernel builds count in the process's profile from here on
        # (count and seconds, recompile-storm detection); step()
        # brackets sampled steps with a probe.
        profiler.ensure_compile_listener()

    # ---- sharding ----

    def _setup_sharding(self) -> None:
        """The batch rows' split, each model leaf's split (``_splits``,
        a tree like the params: with LoRA the base's), and each optimized
        leaf's split and the group its gradient is summed over. Every
        process group is made here, in one order on every rank."""
        c, mesh = self.config, self.mesh
        self._logical = self._model_lib.logical_axes(c.model)
        rows = mesh.axes_size(BATCH_AXES)
        self._batch = None
        if rows > 1:
            if c.global_batch_size % (rows * c.accum_steps):
                raise ValueError(
                    f'global_batch_size {c.global_batch_size} does not '
                    f'split into {rows} ranks x {c.accum_steps} '
                    'accumulation microbatches of equal rows.')
            self._batch = mesh_lib.BatchSplit(
                rows, mesh.axes_index(BATCH_AXES), mesh.group(BATCH_AXES))
        parts = mesh.shape['tensor']
        self._tensor = None
        if parts > 1:
            llama.check_tensor_heads(c.model, parts)
            self._tensor = mesh_lib.TensorSplit(
                parts, mesh.coords['tensor'], mesh.group(('tensor',)))
        parts = mesh.shape['expert']
        self._expert = None
        if parts > 1:
            self._expert = mesh_lib.TensorSplit(
                parts, mesh.coords['expert'], mesh.group(('expert',)))
        shapes = self._model_lib.init(c.model, device='meta')
        self._splits = mesh_lib.tree_splits(mesh, self._logical, shapes)
        self._sharded = any(s is not None
                            for s in param_leaves(self._splits))
        if self._lora:   # adapters whole on every rank, as the reference
            n_opt = len(param_leaves(lora_lib.init_lora(
                shapes, c.lora_rank, torch.Generator(),
                targets=tuple(c.lora_targets))))
            opt = [None] * n_opt
        else:
            opt = param_leaves(self._splits)
        self._opt_splits = opt if self._sharded else None
        # A leaf's gradient is summed over the batch ranks that hold the
        # same block (its split's own axes were summed by the gather's
        # reduce-scatter). Never over tensor or expert: a leaf whole on
        # those ranks leaves the backward whole on each (the families
        # read it on the replicated side, or through
        # mesh_lib.tensor_input / expert_input), and an expert block's
        # gradient is made on its own rank alone.
        self._grad_groups = [
            mesh.group(tuple(a for a in BATCH_AXES
                             if s is None or a not in s.axes))
            for s in opt]

    def _shard_tree(self, tree, splits):
        """This rank's blocks of a whole tree (copies), or the tree."""
        if not self._sharded:
            return tree
        return _map_splits(mesh_lib.shard, tree, splits)

    def batch_rows(self) -> Tuple[int, int]:
        """(this rank's block, the number of blocks) of a global batch's
        rows, which split over the data and fsdp ranks alone: (0, 1)
        where they do not split."""
        if self._batch is None:
            return 0, 1
        return self._batch.index, self._batch.parts

    def local_rows(self, batch: Batch) -> Batch:
        """This rank's rows of a global batch: block ``index`` of the
        batch split in rank order (the batch as it is on one rank)."""
        if self._batch is None:
            return batch
        b = self._batch
        return {k: v.chunk(b.parts)[b.index].contiguous()
                for k, v in batch.items()}

    # ---- state ----

    @property
    def _lora(self) -> bool:
        return self.config.lora_rank > 0

    def _check_device(self, tree) -> None:
        for p in param_leaves(tree):
            if p.device != self.device:
                raise ValueError(f'a parameter lies on {p.device}, the '
                                 f'trainer on {self.device}')

    def init_state(self, params: Optional[Dict[str, Any]] = None,
                   adapters: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        """{'params', 'opt_state', 'step'}, and with LoRA also 'base'.

        ``params`` (the model's whole weights) defaults to the family's
        ``init`` from a generator seeded with config.seed (the JAX
        PRNG's draws cannot be reproduced); on one rank given params are
        used as they are, and updated in place by every step. With LoRA
        they are the frozen base, and 'params' holds the adapters:
        ``adapters`` as given, else ``init_lora`` from a CPU generator
        seeded with config.seed + 1. Only 'params' enters the optimizer.
        On a sharded mesh every rank draws (or is given) the same whole
        tree and keeps its blocks of it."""
        c = self.config
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(c.seed)
            params = self._model_lib.init(c.model, gen, device=self.device)
        params = _ordered_like(params, self._splits)
        self._check_device(params)
        state: Dict[str, Any] = {}
        if self._lora:
            for p in param_leaves(params):
                p.requires_grad_(False)
            if adapters is None:
                gen = torch.Generator()   # the same draws on every device
                gen.manual_seed(c.seed + 1)
                adapters = lora_lib.init_lora(params, c.lora_rank, gen,
                                              targets=tuple(c.lora_targets))
            self._check_device(adapters)
            state['base'] = self._shard_tree(params, self._splits)
            params = adapters
        else:
            params = self._shard_tree(params, self._splits)
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        state.update(params=params, opt_state=self.optimizer.init(leaves),
                     step=0)
        return state

    def _state_splits(self) -> Dict[str, Any]:
        """The split of every tensor of the state (None: whole)."""
        if not self._sharded:
            return {}
        out = {'opt_state': self.optimizer.state_splits(self._opt_splits)}
        if self._lora:
            out['base'] = self._splits
        else:
            out['params'] = self._splits
        return out

    def host_state(self, state: Dict[str, Any],
                   keep: bool = True) -> Optional[Dict[str, Any]]:
        """A copy of the whole ``state`` on the host, for a checkpoint:
        parameters, optimizer state (its counts included), step, and with
        LoRA the base. On a sharded mesh every rank gathers the blocks (a
        collective: each rank calls it) into the tree a one-rank run
        holds; a rank that writes no checkpoint passes ``keep=False`` and
        keeps none of it (None). Later steps do not change it."""
        def to_host(t, split):
            t = mesh_lib.gather(t.detach(), split)
            if not keep:
                return None
            return t.clone() if t.device.type == 'cpu' else t.cpu()
        splits = self._state_splits()
        host = {k: _map_splits(to_host, v, splits.get(k))
                for k, v in state.items()}
        return host if keep else None

    def load_state(self, host: Dict[str, Any]) -> Dict[str, Any]:
        """A state from ``host_state``'s copy (or its unpickled form) on
        this trainer's device and mesh, whatever mesh wrote it, with the
        leaves' roles as ``init_state`` gives them: 'params' requires
        grad, the LoRA base does not."""
        splits = self._state_splits()

        def place(t, split):
            return mesh_lib.shard(t, split).to(self.device, copy=True)
        state = {k: _map_splits(place, v, splits.get(k))
                 for k, v in host.items()}
        for p in param_leaves(state['params']):
            p.requires_grad_(True)
        if 'base' in state:
            for p in param_leaves(state['base']):
                p.requires_grad_(False)
        return state

    # ---- step ----

    def _forward_loss(self, state: Dict[str, Any], params,
                      batch: Batch) -> torch.Tensor:
        """The model loss for ``params``: shared by the training step
        and the (grad-free) eval step. With LoRA ``params`` are the
        adapters, merged into the frozen base first."""
        c = self.config
        if self._lora:
            params = lora_lib.merge(state['base'], params, c.lora_alpha,
                                    c.lora_rank, splits=self._splits)
        if self._sharded:
            params = mesh_lib.step_view(params, self._splits, self._logical)
        kwargs = {}
        if self._model_lib in (moe, deepseek):
            # Routed families: pads stay out of routing (the loss mask,
            # which targets count, is a separate matter).
            kwargs['token_mask'] = batch.get('token_mask')
        return self._model_lib.loss_fn(c.model, params,
                                       batch['tokens'], batch['targets'],
                                       loss_mask=batch.get('mask'),
                                       **kwargs)

    def _loss_and_grads(self, state, batch: Batch
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """This rank's share of the loss and its gradients (the shares
        of a batch split over ranks sum to the global ones; blocks of a
        sharded leaf already hold their group's sum)."""
        params = state['params']
        leaves = param_leaves(params)
        with mesh_lib.batch_split(self._batch), \
                mesh_lib.tensor_split(self._tensor), \
                mesh_lib.expert_split(self._expert), (
                mesh_lib.regathering() if self._sharded
                else contextlib.nullcontext()):
            loss = self._forward_loss(state, params, batch)
            grads = list(torch.autograd.grad(loss, leaves))
        return loss.detach(), grads

    def step(self, state: Dict[str, Any], batch: Batch
             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """One optimizer step → (state, metrics). The parameters in
        ``state`` are updated in place; loss and grad_norm stay 0-dim
        tensors on the device (reading them waits for the step). Every
        Nth step is anatomy-sampled: the probe waits for the card once
        and the flight recorder gets the probe's own (dispatch gap,
        device) pair as a synced record; other steps give it the
        dispatch wall only (the host's launch of the step's kernels; no
        device wait). The telemetry heartbeat gets the step."""
        probe = profiler.step_probe()
        t0 = time.perf_counter()
        out = self._step(state, batch)
        dispatch_s = time.perf_counter() - t0
        marks = probe.done(out) if probe is not None else None
        if marks is not None:
            flight_recorder.mark_compute(marks[0], marks[1], synced=True)
        else:
            flight_recorder.mark_compute(dispatch_s)
        self._note_step()
        return out

    def _note_step(self) -> None:
        """Per-step telemetry heartbeat (phase/step/step-time/tokens-s)
        — a no-op single env lookup outside a gang job, and never a
        device sync either way."""
        now = time.perf_counter()
        c = self.config
        if self._last_step_t is not None:
            dt = now - self._last_step_t
            telemetry.emit(
                phase=telemetry.PHASE_STEP, step=self._host_step,
                step_time_s=dt,
                tokens_per_sec=(c.global_batch_size * c.seq_len / dt
                                if dt > 0 else None))
        else:
            telemetry.emit(phase=telemetry.PHASE_STEP,
                           step=self._host_step)
        self._host_step += 1
        self._last_step_t = now

    def _step(self, state: Dict[str, Any], batch: Batch
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        accum = self.config.accum_steps
        params = state['params']
        leaves = param_leaves(params)
        if accum > 1:
            # Microbatch i holds rows {i, A + i, 2A + i, ...}, as the JAX
            # step's reshape + swap gives. The family loss is a
            # (mask-)weighted mean per microbatch, so microbatches are
            # combined weighted by their token counts.
            g_sum = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            l_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            w_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(accum):
                mb = {k: v[i::accum].contiguous() for k, v in batch.items()}
                loss, grads = self._loss_and_grads(state, mb)
                # The microbatch's global token count: every rank
                # weights its share alike.
                with mesh_lib.batch_split(self._batch):
                    if 'mask' in mb:
                        w = mesh_lib.batch_total(mb['mask'].sum().float())
                    else:
                        w = torch.tensor(float(mesh_lib.batch_total(
                            mb['tokens'].numel())), device=self.device)
                for acc, g in zip(g_sum, grads):
                    acc.add_(w * g.float())
                l_sum = l_sum + w * loss
                w_sum = w_sum + w
                del grads
            # A fully-masked batch is a harmless zero-gradient step.
            w_safe = torch.clamp(w_sum, min=1.0)
            grads = [(g / w_safe).to(p.dtype) for g, p in zip(g_sum, leaves)]
            del g_sum
            loss = l_sum / w_safe
        else:
            loss, grads = self._loss_and_grads(state, batch)
        with torch.no_grad():
            if self._batch is not None:
                grads = [g if group is None else
                         distributed.all_reduce(g, group)
                         for g, group in zip(grads, self._grad_groups)]
                loss = distributed.all_reduce(loss, self._batch.group)
            grad_norm = optim.global_norm(grads, self._opt_splits)
            updates, opt_state = self.optimizer.update(
                grads, state['opt_state'], leaves)
            del grads
            optim.apply_updates(leaves, updates)
        new_state = {'params': params, 'opt_state': opt_state,
                     'step': state['step'] + 1}
        if self._lora:
            new_state['base'] = state['base']
        return new_state, {'loss': loss, 'grad_norm': grad_norm,
                           'step': new_state['step']}

    @torch.no_grad()
    def eval_step(self, state: Dict[str, Any], batch: Batch
                  ) -> torch.Tensor:
        """Loss only (no gradient, no update): the validation pass, over
        the global batch whose rows this rank holds."""
        with mesh_lib.batch_split(self._batch), \
                mesh_lib.tensor_split(self._tensor), \
                mesh_lib.expert_split(self._expert):
            loss = self._forward_loss(state, state['params'], batch)
        if self._batch is not None:
            loss = distributed.all_reduce(loss, self._batch.group)
        return loss

    # ---- data ----

    def synthetic_batch(self, step: int = 0) -> Batch:
        """Uniform random tokens from a generator seeded by ``step``
        (int64, torch's index type); targets are tokens shifted by one.
        The global batch is drawn whole; this rank's rows are returned."""
        c = self.config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step)
        tokens = torch.randint(0, c.model.vocab_size,
                               (c.global_batch_size, c.seq_len),
                               generator=gen, device=self.device)
        return self.local_rows({'tokens': tokens,
                                'targets': torch.roll(tokens, -1, 1)})


def measure_throughput(trainer: Trainer, num_steps: int = 10,
                       warmup: int = 2) -> Dict[str, float]:
    """Tokens/s and model FLOP/s of the training step: the JAX keys, and
    ``first_loss`` (the first warm-up step's), so a caller can see the
    loss move on the repeated batch."""
    state = trainer.init_state()
    batch = trainer.synthetic_batch()
    first_loss = None
    for _ in range(warmup):
        state, metrics = trainer.step(state, batch)
        if first_loss is None:
            first_loss = float(metrics['loss'])
    float(metrics['loss'])  # waits for the warm-up steps
    t0 = time.perf_counter()
    for _ in range(num_steps):
        state, metrics = trainer.step(state, batch)
    final_loss = float(metrics['loss'])
    dt = time.perf_counter() - t0
    c = trainer.config
    tokens = num_steps * c.global_batch_size * c.seq_len
    tokens_per_sec = tokens / dt
    n_devices = trainer.mesh.size
    model_cfg = dataclasses.replace(c.model, max_seq_len=c.seq_len)
    flops_per_token = model_cfg.train_flops_per_token()
    return {
        'tokens_per_sec': tokens_per_sec,
        'tokens_per_sec_per_chip': tokens_per_sec / n_devices,
        'model_tflops_per_sec_per_chip':
            tokens_per_sec * flops_per_token / n_devices / 1e12,
        'step_time_s': dt / num_steps,
        'loss': final_loss,
        'first_loss': first_loss,
        'num_devices': n_devices,
    }
