"""Trainer on one card: TrainConfig, Trainer, measure_throughput.

Counterpart of ``skypilot_tpu/train/trainer.py`` for one device. The
step runs eagerly: the model's loss (``loss_fn`` of the config's family,
remat as the config says), its gradient, gradient accumulation over
strided microbatches, the optimizer chain of ``make_optimizer`` and an
in-place parameter update (the JAX step donates the old state instead).
With ``lora_rank > 0`` the base weights are frozen and only the LoRA
adapters (``train/lora.py``) train, merged into the base inside the
loss. Every step emits the telemetry heartbeat and marks its dispatch
time in the flight recorder, without syncing the device.
``host_state`` and ``load_state`` carry the state to the host and back
for checkpoints (``train/launch.py``).

Not ported yet (ROADMAP.md queue 1): pipeline and sharded meshes (item
8), and the profiler's sampled step probe (item 7).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch import Device, models, resolve_device
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.agent import telemetry
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import flash_attention as flash_ops
from skypilot_tpu_torch.train import lora as lora_lib
from skypilot_tpu_torch.train import optim

Batch = Dict[str, torch.Tensor]

# Canonical mesh axis order (``skypilot_tpu/parallel/mesh.py``):
# outermost first.
MESH_AXES = ('data', 'stage', 'fsdp', 'sequence', 'expert', 'tensor')


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Degree of each parallelism axis (the JAX ``MeshPlan``'s fields).
    -1 on ``data`` absorbs the devices left; the port trains on one."""
    data: int = -1
    stage: int = 1
    fsdp: int = 1
    sequence: int = 1
    expert: int = 1
    tensor: int = 1

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


def make_optimizer(config: TrainConfig) -> optim.Transform:
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, config.learning_rate, config.warmup_steps, 10_000)
    if config.optimizer == 'adafactor':
        opt = optim.adafactor(learning_rate=schedule)
    else:
        opt = optim.adamw(schedule, b1=0.9, b2=0.95,
                          weight_decay=config.weight_decay,
                          mu_dtype=torch.bfloat16)
    return optim.Chain(optim.ClipByGlobalNorm(config.grad_clip_norm), opt)


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The parameter tensors in a fixed order (the tree's own)."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params]


def _tree_map(fn, tree):
    """``fn`` on every tensor of a state tree (dicts, lists, tuples);
    other leaves (Python ints, None) as they are."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def _check_mesh(plan: MeshPlan) -> None:
    if plan.stage > 1:
        raise NotImplementedError(
            'Pipeline parallelism (mesh stage > 1) is not ported yet: '
            'ROADMAP.md queue 1 item 8, "more than one card".')
    sharded = {name: n for name, n in dataclasses.asdict(plan).items()
               if name not in ('data', 'stage') and n > 1}
    if sharded or plan.data > 1:
        raise NotImplementedError(
            f'The port trains on one card; mesh axes {sharded or plan} '
            'are not ported yet: ROADMAP.md queue 1 item 8, "more than '
            'one card".')


class Trainer:
    """Initializes state and runs train and eval steps on one device."""

    def __init__(self, config: TrainConfig, device: Device = None) -> None:
        self.config = config
        if config.accum_steps < 1:
            raise ValueError(f'accum_steps must be >= 1, got '
                             f'{config.accum_steps}')
        if config.global_batch_size % config.accum_steps:
            raise ValueError(
                f'global_batch_size {config.global_batch_size} not '
                f'divisible by accum_steps {config.accum_steps}')
        _check_mesh(config.mesh_plan)
        self._model_lib = models.module_for(config.model)
        if not hasattr(self._model_lib, 'loss_fn'):
            raise NotImplementedError(
                f'{self._model_lib.__name__} has no loss_fn yet, so it '
                'cannot train (full or LoRA): ROADMAP.md queue 1 item '
                '6.4, "DeepSeek training".')
        self.device = resolve_device(device)
        head_dim = getattr(config.model, 'head_dim', None)
        if (self.device.type == 'cuda'
                and head_dim not in flash_ops.BWD_HEAD_DIMS):
            raise NotImplementedError(
                f'head_dim {head_dim}: the flash backward kernels take '
                f'{flash_ops.BWD_HEAD_DIMS} on the card, so this model '
                'cannot train there.')
        if self.device.type == 'cuda' and self.device.index is None:
            # What tensors report, so that devices compare equal.
            self.device = torch.device('cuda', torch.cuda.current_device())
        self.optimizer = make_optimizer(config)
        # Host-side step telemetry: dispatch-to-dispatch wall time (no
        # device sync).
        self._host_step = 0
        self._last_step_t: Optional[float] = None

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

        ``params`` (the model's weights) defaults to the family's
        ``init`` from a generator seeded with config.seed (the JAX
        PRNG's draws cannot be reproduced); given params are used as
        they are, and updated in place by every step. With LoRA they
        are the frozen base, and 'params' holds the adapters:
        ``adapters`` as given, else ``init_lora`` from a CPU generator
        seeded with config.seed + 1. Only 'params' enters the
        optimizer."""
        c = self.config
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(c.seed)
            params = self._model_lib.init(c.model, gen, device=self.device)
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
            state['base'] = params
            params = adapters
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        state.update(params=params, opt_state=self.optimizer.init(leaves),
                     step=0)
        return state

    def host_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A copy of ``state`` on the host, for a checkpoint: parameters,
        optimizer state (its counts included), step, and with LoRA the
        base. Later steps do not change it."""
        def to_host(t):
            t = t.detach()
            return t.clone() if t.device.type == 'cpu' else t.cpu()
        return _tree_map(to_host, state)

    def load_state(self, host: Dict[str, Any]) -> Dict[str, Any]:
        """A state from ``host_state``'s copy (or its unpickled form) on
        this trainer's device, with the leaves' roles as ``init_state``
        gives them: 'params' requires grad, the LoRA base does not."""
        state = _tree_map(
            lambda t: t.to(self.device, copy=True), host)
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
                                    c.lora_rank)
        return self._model_lib.loss_fn(c.model, params,
                                       batch['tokens'], batch['targets'],
                                       loss_mask=batch.get('mask'))

    def _loss_and_grads(self, state, batch: Batch
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        params = state['params']
        leaves = param_leaves(params)
        loss = self._forward_loss(state, params, batch)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def step(self, state: Dict[str, Any], batch: Batch
             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """One optimizer step → (state, metrics). The parameters in
        ``state`` are updated in place; loss and grad_norm stay 0-dim
        tensors on the device (reading them waits for the step). The
        flight recorder gets the step's dispatch wall (the host's
        launch of its kernels; no device sync), and the telemetry
        heartbeat its step."""
        t0 = time.perf_counter()
        out = self._step(state, batch)
        flight_recorder.mark_compute(time.perf_counter() - t0)
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
                if 'mask' in mb:
                    w = mb['mask'].sum().float()
                else:
                    w = torch.tensor(float(mb['tokens'].numel()),
                                     device=self.device)
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
            grad_norm = optim.global_norm(grads)
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
        """Loss only (no gradient, no update): the validation pass."""
        return self._forward_loss(state, state['params'], batch)

    # ---- data ----

    def synthetic_batch(self, step: int = 0) -> Batch:
        """Uniform random tokens from a generator seeded by ``step``
        (int64, torch's index type); targets are tokens shifted by one."""
        c = self.config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step)
        tokens = torch.randint(0, c.model.vocab_size,
                               (c.global_batch_size, c.seq_len),
                               generator=gen, device=self.device)
        return {'tokens': tokens, 'targets': torch.roll(tokens, -1, 1)}


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
    n_devices = 1
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
