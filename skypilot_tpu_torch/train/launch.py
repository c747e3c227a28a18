"""Training entrypoint for task ``run:`` sections, on one card or a gang
of ranks (one process per card).

    python -m skypilot_tpu_torch.train.launch \\
        --model llama3-1b --mesh data=1,fsdp=-1 \\
        --global-batch-size 4 --seq-len 8192 --steps 5000 \\
        --checkpoint-dir /ckpt --resume auto

Counterpart of ``skypilot_tpu/train/launch.py``, with every flag of the
reference and two more: ``--device`` (the card by default: without one
the launcher refuses to start unless given ``--device cpu``) and
``--procs-per-host`` (``auto``: one rank process per card). The
reference runs one process per host; the port runs one per card, so the
one launcher the gang starts on a host with k > 1 cards starts k rank
processes of itself with the same arguments (``XSKY_LOCAL_RANK``,
``XSKY_LOCAL_SIZE``; ``distributed.run_host``), forwards SIGINT and
SIGTERM to them and exits with the first failing rank's code, or 0 when
every rank succeeded; a recipe's command line runs unchanged. A rank
process (``XSKY_LOCAL_RANK`` set) never starts others. It brings
up the process group from the gang env (``parallel/distributed.py``),
resolves ``--mesh`` against its ranks (``--num-slices`` lays ``data``
across slices), builds the ``Trainer``, feeds it token shards
(``train/data.py``: each rank reads its strided share of every epoch) or
synthetic batches, checkpoints so that a preempted job relaunched with
``--resume auto`` picks up from its last step, and logs throughput in
the reference's terms (TFLOP/s per device). Logs and the metrics file
come from rank 0.

Checkpoints: the storage tier is ``--checkpoint-dir`` itself, one
directory per step (``<dir>/<step>/state.pt``, ``torch.save`` of the
trainer's host state: the whole tree, whatever the mesh), written under
a temporary name and renamed, so a killed write leaves the previous
step intact; the newest 3 are kept (the reference's orbax
``max_to_keep=3``). On one process the fast tiers (``<dir>/fast-tier``
or ``$XSKY_CKPT_DIR``, and peers) hold pickled host copies, written off
the step path by the checkpointd worker. On a gang, as in the
reference, only the storage tier, which every rank must see (a shared
mount, as the reference's bucket): every rank joins the gathers of the
state, rank 0 alone keeps it and writes it synchronously, and the ranks
meet at a barrier; every rank
restores from it onto its own mesh, so a checkpoint written at one mesh
resumes at another (the elastic remesh). The reference writes orbax's
distributed checkpoint there instead of one gathered file.

One difference from the reference: a resumed run with ``--data``
continues the token stream where the checkpoint left it (its loader
skips the batches the checkpointed steps consumed); the reference
restarts the stream at its first batch.

The mesh's ``tensor`` axis splits the dense families' heads, MLP and
vocabulary over ranks (``train_llama3_8b.yaml``'s ``--mesh
data=1,fsdp=-1,tensor=4``), and its ``expert`` axis the routed
families' experts (``train_deepseek_moe.yaml``'s ``--mesh
data=-1,fsdp=4,expert=8``). The batch rows split over ``data`` and
``fsdp`` only, so the ranks of one (data, fsdp) coordinate read the same
rows of ``--data``. Not ported yet: ``--attention ring|ulysses``, the
mesh axes sequence and stage above 1, tensor above 1 for the routed
families, with LoRA or beside expert, and LoRA at expert above 1, exit
naming their sub-items of ROADMAP.md queue 1 item 8 (8b-ii, 8c, 8d).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import shutil
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from skypilot_tpu_torch import models, resolve_device
from skypilot_tpu_torch.agent import checkpointd
from skypilot_tpu_torch.agent import flight_recorder
from skypilot_tpu_torch.agent import profiler
from skypilot_tpu_torch.agent import telemetry
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import trainer as trainer_lib

logger = logging.getLogger(__name__)

STATE_FILE = 'state.pt'
MAX_TO_KEEP = 3


def elastic_generation() -> int:
    """The gang incarnation this process runs in (0 = first launch).
    Set by the jobs controller on every elastic shrink/grow-back and
    relaunch resubmit."""
    try:
        return int(os.environ.get('XSKY_ELASTIC_GENERATION', '0') or 0)
    except ValueError:
        return 0


def per_host_batch(global_batch: int, num_hosts: int) -> int:
    """Per-host batch rows for this gang size.

    Normally ``global_batch`` must divide evenly. Under an elastic
    shrink the controller relaunches the SAME run command over fewer
    hosts, so a batch sized for the full gang may not divide — inside
    an elastic incarnation (``XSKY_ELASTIC_GENERATION`` set) the
    per-host batch rounds DOWN (effective global batch shrinks by the
    remainder; logged, never silent) instead of refusing to remesh.
    """
    if num_hosts <= 0:
        raise ValueError(f'num_hosts must be positive, got {num_hosts}')
    if global_batch % num_hosts == 0:
        return global_batch // num_hosts
    if elastic_generation() > 0:
        per_host = max(1, global_batch // num_hosts)
        logger.warning(
            f'Elastic remesh: global batch {global_batch} does not '
            f'divide across {num_hosts} surviving hosts; running '
            f'{per_host}/host (effective global batch '
            f'{per_host * num_hosts}).')
        return per_host
    raise ValueError(
        f'global batch {global_batch} not divisible by {num_hosts} '
        'hosts.')


def parse_mesh(spec: str) -> trainer_lib.MeshPlan:
    """'data=2,fsdp=-1,tensor=4' → MeshPlan."""
    kwargs = {}
    for part in (spec or '').split(','):
        if not part:
            continue
        key, _, value = part.partition('=')
        key = key.strip()
        if key not in trainer_lib.MESH_AXES:
            raise ValueError(f'Unknown mesh axis {key!r}; expected one of '
                             f'{trainer_lib.MESH_AXES}')
        kwargs[key] = int(value)
    return trainer_lib.MeshPlan(**kwargs)


def resolve_plan(plan: trainer_lib.MeshPlan, world: int, model=None,
                 lora_rank: int = 0) -> trainer_lib.MeshPlan:
    """``plan`` resolved against the gang's ``world`` ranks; exits when
    it does not fit them, or names its sub-item of ROADMAP.md queue 1
    item 8 for an axis not ported yet (``Trainer``'s refusals,
    ``trainer_lib.unported_mesh_message``: 8b-ii for ``tensor`` over a
    routed ``model``, beside ``expert`` or with LoRA adapters of
    ``lora_rank``, and for LoRA at ``expert`` > 1)."""
    msg = trainer_lib.unported_mesh_message(plan, model, lora_rank)
    if msg:
        raise SystemExit(f'--mesh: {msg}')
    try:
        return plan.resolve(world)
    except ValueError as e:
        raise SystemExit(
            f'--mesh {plan} does not fit this gang of {world} rank(s) '
            f'({e}); run one process per card.') from e


class StepCheckpoints:
    """The storage tier: ``<root>/<step>/state.pt`` per step, the newest
    ``max_to_keep`` kept. A step directory appears only once complete
    (written as ``.tmp-<step>-<pid>``, then renamed); anything else in
    the root is ignored."""

    def __init__(self, root: str, max_to_keep: int = MAX_TO_KEEP) -> None:
        self.root = os.path.abspath(os.path.expanduser(root))
        self.max_to_keep = max_to_keep
        os.makedirs(self.root, exist_ok=True)

    def steps(self) -> List[int]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and os.path.isfile(
            os.path.join(self.root, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, host_state: Dict[str, Any]) -> None:
        final = os.path.join(self.root, str(step))
        if os.path.isfile(os.path.join(final, STATE_FILE)):
            return   # the end-of-run save may repeat a step
        tmp = os.path.join(self.root, f'.tmp-{step}-{os.getpid()}')
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host_state, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)   # a torn older copy
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.root, str(old)),
                          ignore_errors=True)

    def restore(self, step: int) -> Dict[str, Any]:
        return torch.load(os.path.join(self.root, str(step), STATE_FILE),
                          map_location='cpu', weights_only=True)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.train.launch')
    parser.add_argument('--model', default='llama3-8b')
    parser.add_argument('--mesh', default='data=-1')
    parser.add_argument('--attention', default=None,
                        choices=[None, 'auto', 'ring', 'ulysses', 'flash'])
    parser.add_argument('--num-slices', type=int, default=1)
    parser.add_argument('--global-batch-size', type=int, default=8)
    parser.add_argument('--seq-len', type=int, default=2048)
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--n-microbatches', type=int, default=4)
    parser.add_argument('--accum-steps', type=int, default=1,
                        help='Gradient-accumulation microbatches per '
                             'optimizer step (activation memory drops '
                             'to one microbatch)')
    parser.add_argument('--optimizer', default='adamw')
    parser.add_argument('--learning-rate', type=float, default=3e-4)
    parser.add_argument('--data', default=None,
                        help='Token shards: dir | glob | a.bin,b.bin '
                             '(uint32 streams; native loader w/ python '
                             'fallback). Default: synthetic batches.')
    parser.add_argument('--data-workers', type=int, default=2)
    parser.add_argument('--eval-data', default=None,
                        help='Validation shards (same forms as --data); '
                             'enables periodic eval-loss passes')
    parser.add_argument('--eval-every', type=int, default=200,
                        help='Steps between eval passes (with '
                             '--eval-data)')
    parser.add_argument('--eval-batches', type=int, default=8,
                        help='Batches averaged per eval pass (a fresh '
                             'loader each pass → the same leading '
                             'slice of the eval set every time)')
    parser.add_argument('--data-loader', default='auto',
                        choices=['auto', 'native', 'python'],
                        help='Loader flavor; hosts must agree (the two '
                             'flavors shuffle differently).')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--init-params', default=None,
                        help='Params dir (models.convert output) to '
                             'initialize weights from — fine-tune a '
                             'real HF checkpoint. Model dims must '
                             'match --model. With --lora-rank these '
                             'become the frozen base.')
    parser.add_argument('--metrics-file', default=None,
                        help='Append one JSON line per log window '
                             '(step, loss, tok/s, TFLOP/s/chip).')
    parser.add_argument('--checkpoint-every', type=int, default=0,
                        help='Fixed checkpoint cadence in steps; 0 '
                             '(default) auto-tunes from measured '
                             'snapshot cost and the MTTF hint '
                             '(agent/checkpointd.py — Young interval, '
                             'clamped by XSKY_CKPT_{MIN,MAX}_'
                             'INTERVAL_S)')
    parser.add_argument('--resume', default='none',
                        choices=['none', 'auto'])
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='LoRA rank (0 = full fine-tune)')
    parser.add_argument('--lora-alpha', type=float, default=16.0)
    parser.add_argument('--packing-reset-eos', type=int, default=None,
                        help='EOS token id for packed-sequence '
                             'training: attention is blocked across '
                             'document boundaries and RoPE positions '
                             'restart per document (segment masks ride '
                             'the flash kernels)')
    parser.add_argument('--lora-targets', default='wq,wk,wv,wo',
                        help='comma-separated weight names to adapt')
    parser.add_argument('--device', default=None,
                        help="Where training runs: the card by default "
                             "(the launcher refuses to start without "
                             "one); 'cpu' to run on the CPU")
    parser.add_argument('--procs-per-host', default='auto',
                        help="Rank processes this launcher starts on its "
                             "host, one per card: 'auto' (the host's "
                             "card count; 1 with --device cpu or no "
                             "card) or a count. One stays this process.")
    return parser.parse_args(argv)


def _init_params(args, trainer: trainer_lib.Trainer) -> Dict[str, Any]:
    """The converted tree of ``--init-params``, shape-checked against
    ``--model`` and cast on the host to the model's types, then placed
    on the card. No random tree is drawn first, so only one full tree
    ever lives on the card."""
    from skypilot_tpu_torch.models import convert
    model = trainer.config.model
    target = models.module_for(model).init(model, device='meta')
    restored = convert.load(os.path.abspath(args.init_params), device='cpu')
    ref_shapes = _tree_shapes(target)
    got_shapes = _tree_shapes(restored)
    if ref_shapes != got_shapes:
        raise ValueError(
            f'--init-params does not match --model {args.model}: '
            f'expected {ref_shapes}, got {got_shapes}')

    def place(t, want):
        return t.to(want.dtype).to(trainer.device)

    return {k: ({kk: place(vv, target[k][kk]) for kk, vv in v.items()}
                if isinstance(v, dict) else place(v, target[k]))
            for k, v in restored.items()}


def _tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _write_metrics(path: str, row: Dict[str, Any]) -> None:
    with open(path, 'a', encoding='utf-8') as mf:
        mf.write(json.dumps(row) + '\n')


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Train as ``args`` say; returns what the run did: the final
    ``state`` and ``trainer``, ``start_step``, the logged ``losses``,
    ``grad_norms`` and ``eval_losses`` ({step: value}, the global ones on
    every rank), ``restore`` (tier and seconds, when resumed) and the
    ``data`` loader's class name."""
    # Black-box dumps BEFORE anything can fail: a fatal exception or a
    # SIGTERM/preemption from here on seals the flight-recorder ring
    # to $XSKY_FLIGHTREC_DIR for post-mortem step anatomy.
    flight_recorder.install_crash_dumps()
    telemetry.emit(phase=telemetry.PHASE_INIT,
                   gang_size=int(os.environ.get('XSKY_NUM_HOSTS', '1')
                                 or 1),
                   elastic_generation=elastic_generation())
    # Compile listener BEFORE any kernel build: the first step's builds
    # are the biggest a run does, and must land in the profile's count.
    profiler.ensure_compile_listener()
    if args.attention in ('ring', 'ulysses'):
        raise SystemExit(f'--attention {args.attention} shards the '
                         'sequence over several cards, which is not '
                         'ported yet: ROADMAP.md queue 1 item 8c.')
    device = resolve_device(args.device)
    distributed.initialize(device_type=device.type)
    world, rank = distributed.world_size(), distributed.rank()
    plan = resolve_plan(parse_mesh(args.mesh), world,
                        models.get_config(args.model), args.lora_rank)
    try:
        mesh = mesh_lib.build_mesh(plan, num_slices=args.num_slices)
    except ValueError as e:
        raise SystemExit(f'--num-slices {args.num_slices}: {e}') from e
    if device.type == 'cuda':
        device = torch.device('cuda', torch.cuda.current_device())
    if rank:   # logs and the metrics file come from rank 0
        logger.setLevel(logging.WARNING)

    model = models.get_config(args.model)
    model = dataclasses.replace(model, max_seq_len=max(
        model.max_seq_len, args.seq_len))
    if args.attention:
        model = dataclasses.replace(model, attention_impl=args.attention)
    if args.packing_reset_eos is not None:
        model = dataclasses.replace(
            model, packing_reset_eos=args.packing_reset_eos)
    config = trainer_lib.TrainConfig(
        model=model,
        mesh_plan=plan,
        global_batch_size=args.global_batch_size,
        seq_len=args.seq_len,
        optimizer=args.optimizer,
        learning_rate=args.learning_rate,
        n_microbatches=args.n_microbatches,
        accum_steps=args.accum_steps,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        lora_targets=tuple(t.strip() for t in args.lora_targets.split(',')
                           if t.strip()),
    )
    telemetry.emit(phase=telemetry.PHASE_INIT, step=0)
    trainer = trainer_lib.Trainer(config, device=device, mesh=mesh)

    manager = None
    start_step = 0
    state = None
    restore = None
    ckpt = None
    storage_cadence = checkpointd.Cadence()

    gang_saved = [None]   # the step of the gang's last save

    def save_whole(step: int) -> None:
        """The storage save of a gang: every rank gathers, rank 0
        keeps the whole state and writes it, all meet behind it."""
        host = trainer.host_state(state, keep=rank == 0)
        if rank == 0:
            manager.save(step, host)
        del host
        distributed.barrier()
        gang_saved[0] = step

    if args.checkpoint_dir:
        manager = StepCheckpoints(args.checkpoint_dir)

        def _storage_save(step: int, payload) -> None:
            # Runs on the xsky-ckptd worker, off the step path.
            manager.save(step, payload)

        def _storage_restore():
            step = manager.latest_step()
            if step is None:
                return None
            return step, trainer.load_state(manager.restore(step))

        # One process holds the whole state, so the fast tiers (local
        # shard + peer replicas) carry it, as on a single-process run
        # of the reference; a gang keeps the storage tier only.
        if world == 1:
            ckpt = checkpointd.Checkpointer.from_env(
                fallback_dir=os.path.join(args.checkpoint_dir, 'fast-tier'),
                storage_save=_storage_save)
            checkpointd.install(ckpt)
        if args.resume == 'auto':
            t0_restore = time.perf_counter()
            snap = (checkpointd.restore(
                        storage_fn=_storage_restore,
                        storage_step_fn=manager.latest_step)
                    if world == 1 and checkpointd.enabled() else None)
            tier = None
            if snap is not None and snap.step > 0 and \
                    snap.tier in (checkpointd.TIER_LOCAL,
                                  checkpointd.TIER_PEER):
                # Fast tier: the pickled host state back onto the card.
                start_step, tier = snap.step, snap.tier
                state = trainer.load_state(snap.payload)
            elif snap is not None and \
                    snap.tier == checkpointd.TIER_STORAGE:
                start_step, state, tier = snap.step, snap.payload, snap.tier
            elif (snap is None or
                  snap.tier == checkpointd.TIER_COLD) and \
                    manager.latest_step() is not None:
                # No fast tier — or the never-raise ladder fell to cold
                # while the storage tier still holds a checkpoint:
                # restore directly and fail LOUDLY rather than silently
                # restarting a resumable job from step 0.
                start_step = manager.latest_step()
                state = trainer.load_state(manager.restore(start_step))
                tier = 'direct'
            if state is not None:
                restore = {'tier': tier,
                           'seconds': time.perf_counter() - t0_restore}
                logger.info(f'Resumed from checkpoint step {start_step}.')
                logger.info(f'Restore: {tier} tier in '
                            f'{restore["seconds"]:.3f} s.')
    if state is None:
        if args.init_params:
            params = _init_params(args, trainer)
            state = trainer.init_state(params)
            key = 'base' if args.lora_rank > 0 else 'params'
            logger.info(f'Initialized {key} from {args.init_params}.')
        else:
            state = trainer.init_state()

    # Declare the resume point BEFORE the first step: the goodput
    # ledger charges steps at-or-below the prior incarnation's max
    # committed step to `restart_replay`.
    telemetry.emit(phase=telemetry.PHASE_INIT, resume_step=start_step)

    from skypilot_tpu_torch.train import data as data_lib
    feed = None
    loader = None
    # The batch rows split over the data and fsdp ranks: the tensor and
    # expert ranks of one (data, fsdp) coordinate load the same rows.
    row_block, row_blocks = trainer.batch_rows()
    if args.data:
        # Each rank loads only its rows of the global batch; the
        # block-strided epoch permutation keeps blocks disjoint.
        paths = data_lib.expand_data_arg(args.data)
        loader = data_lib.make_loader(
            paths, batch=per_host_batch(args.global_batch_size, row_blocks),
            seq=args.seq_len,
            seed=args.seed, workers=args.data_workers,
            host_rank=row_block, num_hosts=row_blocks,
            flavor=args.data_loader)
        logger.info(
            f'Data: {len(paths)} shard(s), {loader.n_samples} samples '
            f'of seq {args.seq_len} ({type(loader).__name__}).')
        if start_step:
            loader.skip(start_step)
        feed = data_lib.batches(loader, vocab_size=model.vocab_size)

    if args.eval_data:
        # Fail at launch, not hundreds of steps in when the first eval
        # fires.
        per_host_batch(args.global_batch_size, row_blocks)

    def to_device(host_batch):
        return {k: torch.from_numpy(v).to(trainer.device)
                for k, v in host_batch.items()}

    def run_eval(state) -> float:
        """Mean loss over the leading eval batches (fresh loader each
        pass: deterministic slice, no epoch drift across passes)."""
        paths = data_lib.expand_data_arg(args.eval_data)
        eval_loader = data_lib.make_loader(
            paths, batch=per_host_batch(args.global_batch_size, row_blocks),
            seq=args.seq_len, seed=args.seed, workers=1,
            host_rank=row_block, num_hosts=row_blocks,
            flavor=args.data_loader)
        try:
            eval_feed = data_lib.batches(eval_loader,
                                         vocab_size=model.vocab_size)
            losses = []
            for _ in range(args.eval_batches):
                losses.append(trainer.eval_step(state,
                                                to_device(next(eval_feed))))
            return float(sum(float(l) for l in losses) / len(losses))
        finally:
            eval_loader.close()

    tokens_per_step = args.global_batch_size * args.seq_len
    flops_per_token = dataclasses.replace(
        model, max_seq_len=args.seq_len).train_flops_per_token()
    losses: Dict[int, float] = {}
    grad_norms: Dict[int, float] = {}
    metrics_file = args.metrics_file if rank == 0 else None
    eval_losses: Dict[int, float] = {}
    snapped = None   # the step of the last snapshot handed to checkpointd
    t0 = time.perf_counter()
    window_t0, window_steps = t0, 0
    try:
        for step in range(start_step, args.steps):
            # Flight-recorder step record: data_wait brackets the feed
            # hand-off (inside data_lib.batches), h2d the host→device
            # copy, dispatch the trainer's step call, ckpt_copy the
            # checkpointd snapshot below; the end-of-body seal makes
            # the phases sum exactly to this iteration's wall.
            flight_recorder.begin_step(step)
            if feed is not None:
                host_batch = next(feed)
                with flight_recorder.phase('h2d'):
                    batch = to_device(host_batch)
            else:
                with flight_recorder.phase('h2d'):
                    batch = trainer.synthetic_batch(step)
            state, metrics = trainer.step(state, batch)
            window_steps += 1
            if (step + 1) % args.log_every == 0:
                loss = float(metrics['loss'])  # waits for the step
                losses[step + 1] = loss
                grad_norms[step + 1] = float(metrics['grad_norm'])
                dt = time.perf_counter() - window_t0
                tps = window_steps * tokens_per_step / dt
                tflops = tps * flops_per_token / world / 1e12
                logger.info(
                    f'step {step + 1}/{args.steps} loss={loss:.4f} '
                    f'{tps:,.0f} tok/s '
                    f'({tflops:.1f} model-TFLOP/s/chip)')
                if metrics_file:
                    _write_metrics(metrics_file, {
                        'step': step + 1,
                        'loss': round(loss, 6),
                        'tokens_per_sec': round(tps, 1),
                        'model_tflops_per_chip': round(tflops, 2),
                        'grad_norm': round(grad_norms[step + 1], 4),
                        'time': time.time(),
                    })
                window_t0, window_steps = time.perf_counter(), 0
            if args.eval_data and (step + 1) % args.eval_every == 0:
                eval_loss = run_eval(state)
                eval_losses[step + 1] = eval_loss
                logger.info(f'step {step + 1} eval_loss={eval_loss:.4f} '
                            f'({args.eval_batches} batches)')
                if metrics_file:
                    _write_metrics(metrics_file, {
                        'step': step + 1,
                        'eval_loss': round(eval_loss, 6),
                        'time': time.time(),
                    })
                # Eval wall time must not pollute the throughput window.
                window_t0, window_steps = time.perf_counter(), 0
            if manager is not None:
                due_fixed = (args.checkpoint_every > 0 and
                             (step + 1) % args.checkpoint_every == 0)
                if ckpt is None and world > 1:
                    # The gang's synchronous save; the auto cadence is
                    # rank 0's, so every rank saves at the same step.
                    due = due_fixed or (args.checkpoint_every == 0 and
                                        distributed.agree(
                                            storage_cadence.due()))
                    if due:
                        t0_save = time.perf_counter()
                        save_whole(step + 1)
                        storage_cadence.observe_cost(
                            time.perf_counter() - t0_save)
                        storage_cadence.arm()
                elif ckpt is not None:
                    # Off-step-path snapshot: the loop pays only the
                    # device→host copy (payload_fn); serialize + local
                    # write + peer replicate + the storage save all ride
                    # the xsky-ckptd worker. Fixed --checkpoint-every
                    # forces the cadence; 0 lets it auto-tune.
                    if (args.checkpoint_every == 0 or due_fixed) and \
                            checkpointd.maybe_checkpoint(
                                step + 1, lambda: trainer.host_state(state),
                                force=due_fixed):
                        snapped = step + 1
                elif due_fixed or (args.checkpoint_every == 0 and
                                   storage_cadence.due()):
                    # No async pipeline (the plane disabled via
                    # XSKY_CKPT=0): keep the synchronous save so
                    # periodic checkpointing never silently vanishes.
                    t0_save = time.perf_counter()
                    manager.save(step + 1, trainer.host_state(state))
                    storage_cadence.observe_cost(
                        time.perf_counter() - t0_save)
                    storage_cadence.arm()
            flight_recorder.record_step(step)
        if manager is not None:
            # The final checkpoint rides the same pipeline (fast tiers
            # stay fresh for the next incarnation) unless the last step
            # already handed it over, then the writer drains so the
            # direct save below never races it.
            if ckpt is not None and snapped != args.steps:
                checkpointd.maybe_checkpoint(
                    args.steps, lambda: trainer.host_state(state),
                    force=True)
            drained = checkpointd.wait_idle(timeout=600)
            if world > 1:
                if gang_saved[0] != args.steps:
                    save_whole(args.steps)
            elif drained and (ckpt is None or
                              ckpt.last_storage_step != args.steps):
                manager.save(args.steps, trainer.host_state(state))
    finally:
        if loader is not None:
            loader.close()
        if ckpt is not None:
            checkpointd.install(None)   # stops the worker thread
    total = time.perf_counter() - t0
    telemetry.emit(phase=telemetry.PHASE_IDLE)
    logger.info(f'Done: {args.steps - start_step} steps in {total:.1f}s.')
    return {'state': state, 'trainer': trainer, 'start_step': start_step,
            'losses': losses, 'grad_norms': grad_norms,
            'eval_losses': eval_losses,
            'restore': restore, 'seconds': total,
            'data': type(loader).__name__ if loader is not None else None}


# A rank process of this host: this module, run again.
RANK_COMMAND = ('-m', 'skypilot_tpu_torch.train.launch')


def main(argv: Optional[List[str]] = None) -> int:
    """Train as ``argv`` (default ``sys.argv[1:]``) says, in this process
    or, where ``--procs-per-host`` comes to k > 1 and this process is no
    rank yet, in k rank processes of ``python`` + ``RANK_COMMAND`` +
    ``argv``; returns the exit code."""
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format='%(asctime)s %(name)s: %(message)s')
    argv = sys.argv[1:] if argv is None else [str(a) for a in argv]
    args = parse_args(argv)
    count = distributed.host_process_count(
        args.procs_per_host,
        torch.device(args.device).type if args.device else 'cuda')
    if count > 1 and not distributed.is_rank_process():
        return distributed.run_host([sys.executable, *RANK_COMMAND, *argv],
                                    count)
    try:
        run(args)
    finally:
        distributed.shutdown()
    return 0


if __name__ == '__main__':
    sys.exit(main())
