"""Slot-based inference engine: prefill / insert / decode in PyTorch.

Counterpart of ``skypilot_tpu/infer/engine.py``:

  * A fixed pool of ``max_slots`` decode slots shares one KV cache:
    dense, [L, slots, max_len, KVH, HD] (bf16, fp32, or an int8 values +
    fp32 scale pair), or paged (``kv_page_size`` > 0), a page arena
    [L, pages + 1, page, KVH, HD] with a block table per slot
    (``infer/paged_kv.py``; the last page is the spare one that takes
    writes routed to the sentinel). The cache and the per-slot state are
    updated in place.
  * Prefill runs a wave of prompts at one padded bucket length, and its
    prefix K/V is written into the claimed slots. The wave is exactly as
    many rows as prompts (the JAX engine pads waves to a power of two to
    bound its compiled variants), except for a family with routed
    experts, where the pad rows change which tokens an expert drops and
    the reference's padding is kept.
  * The cache layout is the family's: [.., KVH, HD] K and V, or what the
    family declares (``kv_cache_shapes``, ``paged_kv_cache_shapes``: MLA's
    compressed latent and shared RoPE key).
  * Decode advances ALL slots one token per step. Inactive slots write
    nothing (their cache write is masked) and their tokens are ignored.
    ``decode_steps_masked`` runs n steps with the EOS/budget finish rules
    on the device (the orchestrator's fast tick); ``decode_steps`` runs n
    steps without them (the legacy tick, whose host drops the tokens of
    a slot that finished mid-batch).

  * A prompt longer than the largest bucket, or one whose prefix is in
    the prefix cache, is prefilled in bucket-sized chunks against a
    one-slot scratch cache (``ChunkedPrefill``, ``prefill_any``).

  * ``weight_dtype`` int8 or ``'int4'`` quantizes the weight matrices
    when the engine is built (``ops/quantization.py``: int8 per output
    channel, or int4 in groups of 128 with int8 for the embedding); the
    model's products then run on the quantized weights.

  * ``verify_step`` scores a slot's last token and γ proposals in one
    multi-token pass (speculative decoding's greedy verification) on the
    dense cache; a paged engine opts out, as in the reference.

  * Under a mesh (``mesh``: a ``parallel/mesh.py`` rank mesh, one
    process per card) the engine is one rank of a replica, laid out as
    the reference's engine shards its cache: this rank's block of the
    slots over ``('data', 'fsdp')`` and its KV heads over ``'tensor'``
    (a custom cache layout, MLA's latent, splits its slots only), its
    blocks of the weights that the training rules split over ``tensor``
    (heads, MLP columns, vocabulary) and ``expert`` (the routed
    experts), whole over the slot axes. Every rank runs every engine
    call in the same order (``infer/gang.py``): a prefill wave is
    computed whole on every rank, each writing its own slots' rows; a
    decode step runs this rank's slots, samples them with the noise one
    process would draw for the whole batch, and all-gathers the tokens
    over the slot group. The per-slot state (lengths, tokens, flags,
    counts) is whole on every rank. The vocabulary-split head's logits
    are all-gathered over the tensor group before sampling (B x V fp32
    a step), so every rank samples from the same bits. The paged cache
    is refused under a mesh, as in the reference, and so are the axes
    and families not ported yet.

Every method runs on the engine's device under ``torch.no_grad``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import Device, resolve_device
from skypilot_tpu_torch import models
from skypilot_tpu_torch.agent import profiler
from skypilot_tpu_torch.infer import paged_kv
from skypilot_tpu_torch.infer import sampling
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import quantization as qops
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib

# The reference's refusal (skypilot_tpu/infer/engine.py).
PAGED_MESH = ('mesh sharding is not supported with the paged cache (the '
              'page arena has no slot axis to shard).')
# Speculation under a mesh: ROADMAP.md queue 1 item 8f-ii.
SPECULATIVE_MESH = ('speculative decoding under a mesh is not ported yet '
                    '(ROADMAP.md queue 1 item 8f-ii); serve under a mesh '
                    'without --draft-model or --spec-ngram.')


def mesh_refusal(plan, model, paged: bool = False) -> Optional[str]:
    """Why the port cannot serve ``model`` at the mesh ``plan`` (a
    ``mesh_lib.MeshPlan``) yet, naming where the work stands, or None
    where it can: the paged cache (the reference's text), the axes not
    ported (``sequence``, 8c; ``stage``, 8d) and tensor parallelism for
    the routed families (8b-ii), the refusals the Trainer shares."""
    if plan is None:
        return None
    if paged:
        return PAGED_MESH
    from skypilot_tpu_torch.train import trainer as trainer_lib
    return trainer_lib.unported_mesh_message(plan, model, 0)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    model: llama.LlamaConfig = dataclasses.field(
        default_factory=lambda: llama.LLAMA3_8B)
    max_slots: int = 8               # concurrent decode sequences
    max_target_len: int = 2048       # prompt + generation budget per slot
    prefill_buckets: Tuple[int, ...] = (128, 256, 512, 1024)
    # bf16 (or fp32), or torch.int8 for a quantized cache (per-head
    # symmetric scales, dequantized inside the decode kernel).
    kv_dtype: torch.dtype = torch.bfloat16
    # Weight storage for serving: the model's own type (bf16 default:
    # no quantization), torch.int8 (per-channel scales) or 'int4'
    # (packed nibbles, group-128 scales).
    weight_dtype: Any = torch.bfloat16
    # > 0 enables the host-side LRU of device-resident KV prefixes:
    # requests sharing a prompt prefix (the usual shared system prompt)
    # skip recomputing it; the cached rows are copied into the
    # chunked-prefill scratch cache and only the suffix runs through the
    # trunk. Entry count, not bytes: one entry holds one prompt's
    # [L, true_len, KVH, HD] K+V.
    prefix_cache_entries: int = 0
    # > 0 switches the KV cache to the paged layout: a shared page arena
    # and a block table per slot. Admission is then gated by free pages
    # for each request's actual budget (prompt + max_new_tokens), not by
    # a worst-case max_target_len reservation; see infer/paged_kv.py.
    # Must divide max_target_len and every prefill bucket.
    kv_page_size: int = 0
    # Pages in the arena; 0 sizes it to the dense cache's footprint
    # (max_slots * max_target_len / kv_page_size).
    kv_num_pages: int = 0
    # Batched prefill admission (one forward per bucket group of a
    # wave); False admits prompt by prompt.
    batched_admission: bool = True

    @property
    def paged(self) -> bool:
        return self.kv_page_size > 0

    @property
    def max_prompt_len(self) -> int:
        return self.prefill_buckets[-1]


def _logprobs_info(logits: torch.Tensor, tokens: torch.Tensor, k: int):
    """(chosen_lp [B], top_vals [B, k], top_ids [B, k]) from fp32 logits
    [B, V] and sampled tokens [B]; None when k == 0."""
    if k == 0:
        return None
    logp = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(logp, -1, tokens.long()[:, None])[:, 0]
    top_vals, top_ids = torch.topk(logp, k, dim=-1)
    return chosen, top_vals, top_ids.to(torch.int32)


def supports_chunked_prefill(model_lib) -> bool:
    """Whether a family module can serve the chunked-prefill path:
    verify_forward (multi-token decode into a cache) plus the standard
    [L, B, len, KVH, HD] layout."""
    return (hasattr(model_lib, 'verify_forward')
            and not hasattr(model_lib, 'kv_cache_shapes'))


def _kv_nbytes(entry) -> int:
    return sum(a.numel() * a.element_size() for a in entry.values())


class PrefixCache:
    """Host-side LRU of device-resident KV prefixes.

    Keyed by the full prompt token tuple; a lookup may reuse any leading
    subrange of an entry (K/V rows are positionwise: row i depends only
    on tokens[:i+1], so the longest common prefix of a cached prompt and
    a new prompt is always valid context). Tensors stay on the device;
    eviction frees them by dropping the reference.

    Bounded by entry count AND bytes: one 8B-scale entry is hundreds of
    MB of device memory, so an entry-only bound would let a handful of
    long prompts quietly pin gigabytes.
    """

    DEFAULT_MAX_BYTES = 1 << 30
    # Reusing fewer rows than this costs more in scratch-cache setup than
    # it saves in trunk FLOPs.
    MIN_REUSE = 16

    def __init__(self, max_entries: int,
                 max_bytes: Optional[int] = None) -> None:
        self._entries: 'collections.OrderedDict' = collections.OrderedDict()
        self._max = max_entries
        self._max_bytes = (self.DEFAULT_MAX_BYTES if max_bytes is None
                           else max_bytes)
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0

    def lookup(self, prompt_tokens) -> Tuple[int, Any]:
        """→ (usable_len, kv dict [L, 1, usable_len, KVH, HD]) or
        (0, None)."""
        pt = tuple(prompt_tokens)
        best_len, best_key = 0, None
        for key, (_, klen) in self._entries.items():
            cap = min(klen, len(pt) - 1)
            # Longest common prefix by bisection on C-speed slice
            # compares (this runs on the admission path).
            if key[:cap] == pt[:cap]:
                lcp = cap
            else:
                lo, hi = 0, cap - 1
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    if key[:mid] == pt[:mid]:
                        lo = mid
                    else:
                        hi = mid - 1
                lcp = lo
            if lcp > best_len:
                best_len, best_key = lcp, key
        if best_len < self.MIN_REUSE:
            self.misses += 1
            return 0, None
        self._entries.move_to_end(best_key)
        kv, _ = self._entries[best_key]
        self.hits += 1
        self.tokens_reused += best_len
        return best_len, {'k': kv['k'][:, :, :best_len],
                          'v': kv['v'][:, :, :best_len]}

    def store(self, prompt_tokens, kv, true_len: int) -> None:
        if true_len < self.MIN_REUSE:
            return   # lookup() could never reuse it: dead entry
        pt = tuple(prompt_tokens)
        if pt in self._entries:
            self._entries.move_to_end(pt)
            return
        # Copies, not views: a view would keep the whole bucket-sized
        # (or max_target_len-sized) source alive.
        entry = {'k': kv['k'][:, :, :true_len].clone(),
                 'v': kv['v'][:, :, :true_len].clone()}
        nbytes = _kv_nbytes(entry)
        if nbytes > self._max_bytes:
            return   # one entry alone would blow the budget
        self._entries[pt] = (entry, true_len)
        self._bytes += nbytes
        while (len(self._entries) > self._max
               or self._bytes > self._max_bytes):
            _, (old, _) = self._entries.popitem(last=False)
            self._bytes -= _kv_nbytes(old)


class InferenceEngine:
    """Owns params + KV cache; exposes prefill/insert/decode."""

    def __init__(self, config: EngineConfig, params: llama.Params,
                 device: Device = None, mesh=None) -> None:
        self.device = resolve_device(device)
        # Kernel builds count in the process's profile from here on.
        profiler.ensure_compile_listener()
        self._model_lib = models.module_for(config.model)
        if config.kv_dtype not in (torch.bfloat16, torch.float32,
                                   torch.int8):
            raise ValueError(f'kv_dtype {config.kv_dtype}: need bf16, '
                             'fp32 or int8')
        self.config = config
        c = config.model
        msg = mesh_refusal(mesh and mesh.plan, c, config.paged)
        if msg:
            raise NotImplementedError(msg)
        self.mesh = mesh
        # This rank's place in the replica (None: one process), and the
        # split of each weight leaf (``mesh_lib.serving_splits``).
        self.layout: Optional[mesh_lib.ServingLayout] = None
        self.splits = None
        if mesh is not None:
            self.layout = mesh_lib.serving_layout(mesh, config.max_slots)
            if self.layout.tensor is not None:
                llama.check_tensor_heads(c, self.layout.tensor.parts)
            self.splits = mesh_lib.serving_splits(
                mesh, self._model_lib.logical_axes(c),
                self._model_lib.init(c, device='meta'))
        if (self.splits is not None
                and qops.leaf_quantizer(config.weight_dtype) is not None):
            _check_quantized_blocks(params, self.splits)
        if config.weight_dtype == torch.int8:
            params = qops.quantize_params(params)
        elif config.weight_dtype == 'int4':
            params = qops.quantize_params_int4(params)
        if self.splits is not None:
            # Whole leaves are quantized first, then cut (int8 scales
            # must see every contraction row).
            params = mesh_lib.block_tree(params, self.splits)
        self.params = params
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        n_kv = None   # a custom cache layout has no KV heads
        if hasattr(c, 'n_kv_heads'):
            with self._region():
                n_kv = llama.local_kv_heads(c)
        self._n_kv = n_kv
        slots = (config.max_slots if self.layout is None
                 else self.layout.local_slots)
        self._page_alloc: Optional[paged_kv.PageAllocator] = None
        if config.paged:
            page = config.kv_page_size
            if config.kv_dtype == torch.int8:
                raise NotImplementedError(
                    'int8 KV is not supported with the paged cache.')
            if getattr(c, 'sliding_window', None) is not None:
                raise NotImplementedError(
                    'sliding_window is not supported with the paged '
                    'cache.')
            if not hasattr(self._model_lib, 'paged_decode_forward'):
                raise NotImplementedError(
                    f'{self._model_lib.__name__} has no '
                    'paged_decode_forward hook; use the dense cache.')
            bad = [n for n in (config.max_target_len,
                               *config.prefill_buckets) if n % page]
            if bad:
                raise ValueError(
                    f'kv_page_size {page} must divide max_target_len '
                    f'and every prefill bucket; offending sizes: {bad}')
            blocks_per_slot = config.max_target_len // page
            num_pages = (config.kv_num_pages or
                         config.max_slots * blocks_per_slot)
            self._page_alloc = paged_kv.PageAllocator(
                num_pages, page, blocks_per_slot)
            # One page more than the allocator hands out: the spare page
            # at the sentinel index (see llama.paged_cache_attend).
            if hasattr(self._model_lib, 'paged_kv_cache_shapes'):
                self._k_shape, self._v_shape = (
                    self._model_lib.paged_kv_cache_shapes(
                        c, num_pages + 1, page))
            else:
                self._k_shape = self._v_shape = (
                    c.n_layers, num_pages + 1, page, c.n_kv_heads,
                    c.head_dim)
        elif hasattr(self._model_lib, 'kv_cache_shapes'):
            # Families with a non-[KVH, HD] cache layout (MLA's
            # compressed latent) declare their own shapes.
            self._k_shape, self._v_shape = self._model_lib.kv_cache_shapes(
                c, slots, config.max_target_len)
            if config.kv_dtype == torch.int8:
                raise NotImplementedError(
                    'int8 KV is not supported for families with a '
                    'custom cache layout (the compressed MLA cache is '
                    'already ~20x smaller than a dense KV cache).')
        else:
            self._k_shape = self._v_shape = (
                c.n_layers, slots, config.max_target_len, n_kv, c.head_dim)
        # A family with routed experts: its prefill waves are padded as
        # the reference pads them (see _wave_rows).
        self._routed = hasattr(c, 'n_experts')
        self._prefix_cache: Optional[PrefixCache] = None
        if config.prefix_cache_entries > 0:
            if not self.supports_chunked_prefill:
                raise NotImplementedError(
                    'prefix_cache_entries needs the chunked-prefill path '
                    '(verify_forward + the standard KV layout); '
                    f'{self._model_lib.__name__} lacks it.')
            self._prefix_cache = PrefixCache(config.prefix_cache_entries)

    # ---- the mesh ----

    @contextlib.contextmanager
    def _region(self):
        """Within: the model reads this rank's tensor and expert blocks
        (a no-op for one process)."""
        lay = self.layout
        with mesh_lib.tensor_split(lay and lay.tensor), \
                mesh_lib.expert_split(lay and lay.expert):
            yield

    def _whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits of the whole vocabulary: a tensor split's blocks
        all-gathered over its group (the same bits on every rank)."""
        if self.layout is None or self.layout.tensor is None:
            return logits
        return distributed.all_gather(logits, -1, self.layout.tensor.group)

    def _local(self, t):
        """This rank's slots' rows of a per-slot tensor (None passes)."""
        if t is None or self.layout is None:
            return t
        first, stop = self.layout.slot_block
        return t[first:stop]

    def _all_slots(self, t: torch.Tensor) -> torch.Tensor:
        """Every slot's rows of a per-slot tensor of this rank's slots:
        all-gathered over the slot group."""
        if self.layout is None or self.layout.parts == 1:
            return t
        return distributed.all_gather(t, 0, self.layout.group)

    # ---- state ----

    @property
    def _kv_quantized(self) -> bool:
        return self.config.kv_dtype == torch.int8

    def _make_cache(self, shape):
        """One cache entry: plain tensor, or (int8, fp32 scale) pair."""
        if not self._kv_quantized:
            return torch.zeros(shape, dtype=self.config.kv_dtype,
                               device=self.device)
        return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                            device=self.device))

    def init_decode_state(self) -> Dict[str, Any]:
        cfg = self.config
        slots = cfg.max_slots
        state = {
            'kv_k': self._make_cache(self._k_shape),
            'kv_v': self._make_cache(self._v_shape),
            # per-slot: index the NEXT token will be written at
            'lengths': torch.zeros((slots,), dtype=torch.int32,
                                   device=self.device),
            'tokens': torch.zeros((slots,), dtype=torch.int32,
                                  device=self.device),
            'active': torch.zeros((slots,), dtype=torch.bool,
                                  device=self.device),
            # per-slot generated-token counts (uint8 saturating) for the
            # presence / frequency penalties.
            'counts': torch.zeros((slots, cfg.model.vocab_size),
                                  dtype=torch.uint8, device=self.device),
        }
        if self._page_alloc is not None:
            pa = self._page_alloc
            # All-sentinel tables: every unadmitted slot's writes go to
            # the spare page. The tables live on the device and change
            # only at insert / release.
            state['block_tables'] = torch.full(
                (slots, pa.blocks_per_slot), pa.sentinel,
                dtype=torch.int32, device=self.device)
        return state

    @property
    def kv_page_stats(self) -> Optional[Dict[str, int]]:
        """Free/total pages for the serving gauges; None when dense."""
        pa = self._page_alloc
        if pa is None:
            return None
        return {'total': pa.num_pages, 'free': pa.free_pages,
                'page_size': pa.page_size}

    # ---- paged-KV admission ----

    def reserve_kv(self, slot: int, prompt_len: int, max_new: int) -> bool:
        """Reserve KV capacity for a request's full budget before
        admission. Dense engines always admit (the slot IS the
        reservation); paged engines take pages for prompt + max_new up
        front so the fused decode loop can never outrun its pages. False
        means "no headroom now", and the caller defers."""
        if self._page_alloc is None:
            return True
        return self._page_alloc.allocate(slot, prompt_len + max_new)

    def release_kv(self, slot: int) -> None:
        """Host-side page release for claimed-but-never-finished paths
        (admission failure, cancellation). Finish paths go through
        release_slot, which also sentinels the device table row."""
        if self._page_alloc is not None:
            self._page_alloc.release(slot)

    def kv_admissible(self, prompt_len: int, max_new: int) -> bool:
        """Whether a request's KV budget could EVER fit: checked at
        admission so a too-big request is rejected up front instead of
        parking in the deferred queue forever and deadlocking the drain.
        (Bounded by per-slot table rows as well as total pages.)"""
        pa = self._page_alloc
        if pa is None:
            return True
        need = pa.pages_for(prompt_len + max_new)
        return need <= min(pa.num_pages, pa.blocks_per_slot)

    # ---- prefill ----

    def bucket_for(self, length: int) -> int:
        for b in self.config.prefill_buckets:
            if length <= b:
                return b
        raise ValueError(
            f'Prompt length {length} exceeds max prefill bucket '
            f'{self.config.prefill_buckets[-1]}.')

    def _sampling_args(self, temps, top_ks, top_ps):
        """Per-row host arrays → device tensors; disabled filters fold to
        None and an all-greedy batch gets no generator (no noise is
        drawn)."""
        temps = np.asarray(temps, np.float32)
        top_ks = np.asarray(top_ks, np.int32)
        top_ps = np.asarray(top_ps, np.float32)
        dev = self.device
        return (torch.as_tensor(temps, device=dev),
                torch.as_tensor(top_ks, device=dev)
                if (top_ks > 0).any() else None,
                torch.as_tensor(top_ps, device=dev)
                if (top_ps < 1.0).any() else None,
                self._generator if (temps > 0).any() else None)

    @torch.no_grad()
    def _prefill_batch(self, tokens, true_lens, temperature, top_k, top_p,
                       generator, logprobs_k: int = 0):
        """Batched prefill: tokens [B, bucket] (one shared bucket),
        true_lens [B] → (first_tokens [B], kv [L, B, bucket, KVH, HD],
        lp-info-or-None).

        Only the hidden state at true_len-1 goes through the LM head:
        projecting the whole padded bucket would burn bucket × vocab
        products on the time-to-first-token path for one useful row.
        """
        c = self.config.model
        with self._region():
            last_hidden, kv = self._model_lib.prefill_hidden(
                c, self.params, tokens, true_lens)
            logits = self._whole_logits(
                self._model_lib.lm_logits(c, self.params, last_hidden))
        first_tokens = sampling.sample_batched(logits, generator,
                                               temperature, top_k, top_p)
        return (first_tokens, kv,
                _logprobs_info(logits, first_tokens, logprobs_k))

    def _pad_prompts(self, prompts):
        bucket = self.bucket_for(max(len(p) for p in prompts))
        tokens = np.zeros((len(prompts), bucket), np.int64)
        for i, prompt in enumerate(prompts):
            tokens[i, :len(prompt)] = prompt
        true_lens = np.array([len(p) for p in prompts], np.int64)
        return (torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(true_lens, device=self.device))

    @torch.no_grad()
    def _insert_batch(self, state, kv, first_tokens, true_lens, slots,
                      host_slots):
        """Write a batched prefill into decode slots (in place): cache
        rows [0, bucket) of each slot from its prefix, the rest zeroed,
        and the slot's length, token, active flag and counts reset. Under
        a mesh only this rank's slots (``host_slots``, the slots as a
        host list) are written into its cache."""
        cfg = self.config
        slots = slots.long()
        k = kv['k'][:, :, :cfg.max_target_len]
        v = kv['v'][:, :, :cfg.max_target_len]
        rows = local = slots
        if self.layout is not None:
            first, stop = self.layout.slot_block
            mine = [i for i, s in enumerate(host_slots)
                    if first <= s < stop]
            rows = torch.as_tensor(mine, dtype=torch.long,
                                   device=self.device)
            local = torch.as_tensor([host_slots[i] - first for i in mine],
                                    dtype=torch.long, device=self.device)
            k, v = k[:, rows], v[:, rows]
        if len(local):
            llama.write_cache_slots(state['kv_k'], k, local)
            llama.write_cache_slots(state['kv_v'], v, local)
        self._set_slots(state, first_tokens, true_lens, slots)
        return state

    def _set_slots(self, state, first_tokens, true_lens, slots) -> None:
        """Reset the per-slot state of freshly inserted slots (in place)."""
        state['lengths'][slots] = true_lens.to(torch.int32)
        state['tokens'][slots] = first_tokens.to(torch.int32)
        state['active'][slots] = True
        state['counts'][slots] = 0
        state['counts'][slots, first_tokens.long()] = 1

    @torch.no_grad()
    def _insert_batch_paged(self, state, kv, first_tokens, true_lens, slots,
                            tables: np.ndarray):
        """Paged twin of _insert_batch: the prefill prefix reshapes into
        page-sized blocks and is written through each row's block table.
        ``tables`` [B, blocks_per_slot] (host, from the allocator) carries
        sentinel entries beyond each row's reservation, so blocks past it
        (prefill-bucket padding, never-live rows) are not written; real
        prompt rows always land (the reservation covers prompt + max_new
        by construction). The live (row, block) pairs are chosen here on
        the host, where the tables come from: no device sync, and no
        out-of-range index ever reaches the device."""
        cfg = self.config
        page = cfg.kv_page_size
        slots = slots.long()
        k = kv['k'][:, :, :cfg.max_target_len]
        v = kv['v'][:, :, :cfg.max_target_len]
        n_layers, b, length = k.shape[:3]
        nblk = length // page
        dest = tables[:, :nblk]
        rows, blks = np.nonzero(dest < self._page_alloc.sentinel)
        dev = self.device
        pages = torch.as_tensor(dest[rows, blks].astype(np.int64), device=dev)
        rows = torch.as_tensor(rows, device=dev)
        blks = torch.as_tensor(blks, device=dev)
        for key, src in (('kv_k', k), ('kv_v', v)):
            blocks = src.reshape(n_layers, b, nblk, page, *src.shape[3:])
            state[key][:, pages] = blocks[:, rows, blks].to(state[key].dtype)
        state['block_tables'][slots] = torch.as_tensor(tables, device=dev)
        self._set_slots(state, first_tokens, true_lens, slots)
        return state

    @property
    def supports_batched_prefill(self) -> bool:
        """Batched admission rides the plain bucket path; the prefix
        cache works on individual prompts, so engines with it enabled
        keep per-prompt admission (reuse beats dispatch fusion)."""
        return self._prefix_cache is None

    def _wave_rows(self, n: int) -> int:
        """Rows of the prefill forward for a wave of n prompts. The
        reference pads a wave to min(max_slots, next power of two) rows,
        repeating row 0, to bound its compiled variants. For a family with
        routed experts the pad rows take expert capacity, which decides
        which tokens overflow an expert, so such waves are padded the same
        way; other families run exactly n rows (the same tokens)."""
        if not self._routed:
            return n
        return min(self.config.max_slots, 1 << max(0, n - 1).bit_length())

    def _slot_tables(self, slots) -> np.ndarray:
        return np.stack([self._page_alloc.table_row(s) for s in slots])

    def prefill_insert_batch(self, state, requests_args, slots):
        """Admit a wave of requests: one forward + one insert.

        requests_args: list of (prompt_tokens, SamplingParams), all with
        len(prompt) ≤ max_prompt_len; slots: one free slot per request.
        Returns (state, first_tokens host list)."""
        n = len(requests_args)
        if not 0 < n == len(slots) <= self.config.max_slots:
            raise ValueError(f'{n} requests for {len(slots)} slots')
        # Pad rows repeat row 0 (see _wave_rows); their outputs are dropped.
        rows = requests_args + [requests_args[0]] * (self._wave_rows(n) - n)
        tokens, true_lens = self._pad_prompts([p for p, _ in rows])
        temps, top_k, top_p, gen = self._sampling_args(
            *zip(*[(sp.temperature, sp.top_k, sp.top_p) for _, sp in rows]))
        first_tokens, kv, _ = self._prefill_batch(
            tokens, true_lens, temps, top_k, top_p, gen)
        if len(rows) > n:
            first_tokens, true_lens = first_tokens[:n], true_lens[:n]
            kv = {key: val[:, :n] for key, val in kv.items()}
        slot_ids = torch.as_tensor(list(slots), device=self.device)
        if self._page_alloc is not None:
            state = self._insert_batch_paged(
                state, kv, first_tokens, true_lens, slot_ids,
                self._slot_tables(slots))
        else:
            state = self._insert_batch(state, kv, first_tokens, true_lens,
                                       slot_ids, list(slots))
        return state, first_tokens.tolist()

    def prefill(self, prompt_tokens,
                sampling_params: Optional[sampling.SamplingParams] = None,
                logprobs_k: int = 0):
        """Run prefill on one prompt → (first_token, kv, true_len), or
        (first_token, kv, true_len, lp_info) when logprobs_k > 0. The
        single-row case of ``_prefill_batch``; the engine's generator
        draws any sampling noise."""
        sp = sampling_params or sampling.SamplingParams()
        tokens, true_lens = self._pad_prompts([prompt_tokens])
        temps, top_k, top_p, gen = self._sampling_args(
            [sp.temperature], [sp.top_k], [sp.top_p])
        first, kv, lp = self._prefill_batch(tokens, true_lens, temps,
                                            top_k, top_p, gen, logprobs_k)
        if logprobs_k > 0:
            return first[0], kv, len(prompt_tokens), lp
        return first[0], kv, len(prompt_tokens)

    # ---- chunked prefill + prefix reuse ----

    @property
    def supports_chunked_prefill(self) -> bool:
        """See the module-level supports_chunked_prefill predicate."""
        return supports_chunked_prefill(self._model_lib)

    @property
    def max_admit_len(self) -> int:
        """Longest admissible prompt: the per-slot KV budget minus one
        row for the first generated token when chunking is available,
        else the largest prefill bucket."""
        if self.supports_chunked_prefill:
            return self.config.max_target_len - 1
        return min(self.config.max_prompt_len,
                   self.config.max_target_len - 1)

    @property
    def prefix_cache_stats(self) -> Optional[Dict[str, int]]:
        pc = self._prefix_cache
        if pc is None:
            return None
        return {'hits': pc.hits, 'misses': pc.misses,
                'tokens_reused': pc.tokens_reused,
                'entries': len(pc._entries)}

    @torch.no_grad()
    def _chunk_forward(self, scratch_kv, tokens, start: int, last_idx: int,
                       need_logits: bool):
        """One prompt chunk through the trunk against the scratch cache
        (written in place).

        tokens [1, C] fill rows start..start+C-1; with need_logits the
        row at ``last_idx`` (chunk-relative) comes back as [1, V] logits.
        Only that one row goes through the LM head, and intermediate
        chunks skip the head altogether: [1, C, V] fp32 logits would be
        0.5 GB a chunk at C 1024 and a 128k vocabulary.
        """
        c = self.config.model
        positions = start + torch.arange(tokens.shape[1],
                                         device=self.device)[None, :]
        with self._region():
            hidden, new_kv = self._model_lib.verify_hidden(
                c, self.params, tokens, positions, scratch_kv)
            if not need_logits:
                return None, new_kv
            return (self._whole_logits(self._model_lib.lm_logits(
                c, self.params, hidden[:, last_idx])), new_kv)

    def _make_scratch_cache(self, prefix_kv=None) -> Dict[str, torch.Tensor]:
        """[L, 1, max_target_len, KVH, HD] scratch in the model's type,
        optionally seeded with a cached prefix (rows beyond it start zero
        and are overwritten by the chunk passes)."""
        c = self.config.model
        shape = (c.n_layers, 1, self.config.max_target_len, self._n_kv,
                 c.head_dim)
        scratch = {key: torch.zeros(shape, dtype=c.dtype, device=self.device)
                   for key in ('k', 'v')}
        if prefix_kv is not None:
            n = prefix_kv['k'].shape[2]
            for key in ('k', 'v'):
                scratch[key][:, :, :n] = prefix_kv[key]
        return scratch

    def start_chunked_prefill(self, prompt_tokens, sampling_params=None,
                              logprobs_k: int = 0,
                              _prefix=None) -> 'ChunkedPrefill':
        """Begin a stepwise chunked prefill (one chunk per .step() call):
        the orchestrator interleaves these steps with decode ticks so a
        long prompt never stalls running streams for its whole
        prefill."""
        if not self.supports_chunked_prefill:
            raise ValueError(
                f'Prompt length {len(prompt_tokens)} exceeds max '
                f'prefill bucket {self.config.max_prompt_len} and '
                f'{self._model_lib.__name__} has no chunked-prefill '
                'path.')
        if len(prompt_tokens) > self.max_admit_len:
            raise ValueError(f'Prompt length {len(prompt_tokens)} '
                             f'exceeds max_admit_len '
                             f'{self.max_admit_len}.')
        return ChunkedPrefill(self, list(prompt_tokens),
                              sampling_params or sampling.SamplingParams(),
                              logprobs_k, _prefix=_prefix)

    def prefill_any(self, prompt_tokens,
                    sampling_params: Optional[sampling.SamplingParams]
                    = None, logprobs_k: int = 0):
        """prefill() for prompts of any length ≤ max_admit_len.

        Consults the prefix cache first; a hit copies the cached rows
        into a scratch cache and runs only the suffix. Prompts beyond
        the largest bucket run bucket-sized chunks through
        _chunk_forward (the padded rows of the last chunk write garbage
        beyond true_len: harmless, every row past a slot's live frontier
        is rewritten by decode before it is ever read). Returns
        (first_token, kv, true_len) exactly like prefill() (+ lp_info
        when logprobs_k > 0).
        """
        true_len = len(prompt_tokens)
        prefix = None
        if self._prefix_cache is not None:
            prefix = self._prefix_cache.lookup(prompt_tokens)
        if (true_len <= self.config.max_prompt_len
                and (prefix is None or prefix[0] == 0)):
            out = self.prefill(prompt_tokens, sampling_params, logprobs_k)
            if self._prefix_cache is not None:
                self._prefix_cache.store(prompt_tokens, out[1], true_len)
            return out
        cp = self.start_chunked_prefill(prompt_tokens, sampling_params,
                                        logprobs_k, _prefix=prefix)
        while not cp.step():
            pass
        return cp.finalize()

    # ---- insert / release ----

    def insert(self, state, kv, first_token, true_len: int, slot: int):
        """Write one prefill prefix into decode slot ``slot``: the B=1
        case of ``_insert_batch`` (or its paged twin, which requires a
        prior reserve_kv(slot, ...))."""
        dev = self.device
        args = (state, kv, torch.as_tensor(first_token, device=dev).reshape(1),
                torch.as_tensor([true_len], device=dev),
                torch.as_tensor([slot], device=dev))
        if self._page_alloc is not None:
            return self._insert_batch_paged(*args, self._slot_tables([slot]))
        return self._insert_batch(*args, [slot])

    def release_slot(self, state, slot: int):
        state['active'][slot] = False
        if self._page_alloc is not None:
            # Free the pages AND sentinel the device table row: a
            # released slot still ticking inside a fused batch must
            # never write into a page handed to a new request.
            self._page_alloc.release(slot)
            state['block_tables'][slot] = self._page_alloc.sentinel
        return state

    # ---- decode ----

    @torch.no_grad()
    def _decode_step_impl(self, state, temperatures, top_k, top_p,
                          generator, logprobs_k: int = 0, penalties=None):
        """One step for every slot. Per-slot sampling params [slots]
        (temp 0 → greedy, top_k 0 / top_p 1 → filter off); ``penalties``
        = (presence [slots], frequency [slots]) enables the OpenAI
        repetition penalties. Returns (new_state, (next_tokens, lp))."""
        c = self.config.model
        cap = self.config.max_target_len
        kv = {'k': state['kv_k'], 'v': state['kv_v']}
        # Inactive slots "write" at max_target_len, which the dense cache
        # write masks out and the paged one routes to the spare page, so
        # a slot finished mid-fused-batch never writes post-EOS KV (the
        # JAX scatter drops it instead).
        write_pos = torch.where(state['active'], state['lengths'], cap)
        if self._page_alloc is not None:
            logits, new_kv = self._model_lib.paged_decode_forward(
                c, self.params, state['tokens'], write_pos, kv,
                state['block_tables'])
        else:
            # Under a mesh: this rank's slots, and the whole vocabulary.
            with self._region():
                logits, new_kv = self._model_lib.decode_forward(
                    c, self.params, self._local(state['tokens']),
                    self._local(write_pos), kv)
                logits = self._whole_logits(logits)
        counts = state['counts']
        if penalties is not None:
            presence, frequency = (self._local(p) for p in penalties)
            cnt = self._local(counts).float()
            logits = (logits - presence[:, None] * (cnt > 0)
                      - frequency[:, None] * cnt)
        rows = (None if self.layout is None else
                (self.config.max_slots, self.layout.slot_block[0]))
        next_tokens = sampling.sample_batched(
            logits, generator, self._local(temperatures), self._local(top_k),
            self._local(top_p), rows=rows)
        lp = _logprobs_info(logits, next_tokens, logprobs_k)
        next_tokens = self._all_slots(next_tokens)
        if lp is not None:
            lp = tuple(self._all_slots(a) for a in lp)
        if penalties is not None:
            # Saturating add at uint8 max; inactive slots excluded.
            slots_idx = torch.arange(counts.shape[0], device=self.device)
            tok = next_tokens.long()
            cur = counts[slots_idx, tok]
            bump = (state['active'] & (cur < 255)).to(torch.uint8)
            counts[slots_idx, tok] = cur + bump
        new_state = {
            'kv_k': new_kv['k'], 'kv_v': new_kv['v'],
            'lengths': torch.where(
                state['active'],
                (state['lengths'] + 1).clamp(max=cap), state['lengths']),
            'tokens': torch.where(state['active'], next_tokens,
                                  state['tokens']),
            'active': state['active'],
            'counts': counts,
        }
        if 'block_tables' in state:
            new_state['block_tables'] = state['block_tables']
        return new_state, (next_tokens, lp)

    @torch.no_grad()
    def _decode_steps_masked(self, state, temperatures, top_k, top_p,
                             n: int, generator, eos_ids, remaining,
                             logprobs_k: int = 0, penalties=None):
        """n decode steps with DEVICE-SIDE finish detection.

        eos_ids [slots] int32 (< 0 = no EOS for that slot): a slot
        sampling its EOS is deactivated in-loop — the EOS step's row
        comes back with valid=False and later steps neither sample for
        the slot nor write its KV. remaining [slots] int32: token budget,
        decremented per kept token; a slot reaching zero keeps that
        token and deactivates after it. Returns (state, remaining,
        (tokens [n, slots], valid [n, slots], lp)); nothing here waits
        for the device.
        """
        tokens, valid, lps = [], [], []
        for _ in range(n):
            prev_active = state['active']
            state, (next_tokens, lp) = self._decode_step_impl(
                state, temperatures, top_k, top_p, generator, logprobs_k,
                penalties)
            hit_eos = prev_active & (eos_ids >= 0) & (next_tokens == eos_ids)
            keep = prev_active & ~hit_eos
            remaining = remaining - keep.to(remaining.dtype)
            state['active'] = keep & ~(keep & (remaining <= 0))
            tokens.append(next_tokens)
            valid.append(keep)
            lps.append(lp)
        lp = (tuple(torch.stack(parts) for parts in zip(*lps))
              if logprobs_k else None)
        return state, remaining, (torch.stack(tokens), torch.stack(valid),
                                  lp)

    def decode_steps_masked(self, state, n: int, temperatures, top_k,
                            top_p, eos_ids, remaining, generator,
                            logprobs_k: int = 0, penalties=None):
        """Public fused-masked decode → (state, remaining, tokens, valid,
        lp). The sampling tensors are taken as given: the orchestrator
        keeps them on the device and rebuilds them only on admit /
        release."""
        state, remaining, (tokens, valid, lp) = self._decode_steps_masked(
            state, temperatures, top_k, top_p, n, generator, eos_ids,
            remaining, logprobs_k, penalties)
        return state, remaining, tokens, valid, lp

    def _decode_args(self, temperatures, top_k, top_p, generator,
                     penalties):
        """Per-slot host arrays → the device tensors ``_decode_step_impl``
        takes (see ``decode_step``)."""
        slots = self.config.max_slots
        if temperatures is None and top_k is None and top_p is None:
            # All greedy: nothing goes to the device and no noise is
            # drawn, so a run of draft steps never waits on the host.
            temps = top_k = top_p = gen = None
        else:
            temps, top_k, top_p, gen = self._sampling_args(
                np.zeros(slots) if temperatures is None else temperatures,
                np.zeros(slots) if top_k is None else top_k,
                np.ones(slots) if top_p is None else top_p)
            if gen is not None and generator is not None:
                gen = generator
        if penalties is not None:
            penalties = tuple(torch.as_tensor(np.asarray(a, np.float32),
                                              device=self.device)
                              for a in penalties)
        return temps, top_k, top_p, gen, penalties

    def decode_step(self, state, temperatures=None, top_k=None,
                    top_p=None, logprobs_k: int = 0, penalties=None,
                    generator: Optional[torch.Generator] = None):
        """Advance every slot one token. Returns (state, tokens [slots])
        — or (state, tokens, lp) when logprobs_k > 0.

        Per-slot host arrays [max_slots]: temperatures (0 = greedy),
        top_k (0 = off), top_p (1 = off), penalties = (presence,
        frequency) (0 = off); None means disabled for all slots. Any
        sampling noise is drawn from ``generator`` (the JAX engine's
        ``key``), else from the engine's own generator.
        """
        temps, top_k, top_p, gen, penalties = self._decode_args(
            temperatures, top_k, top_p, generator, penalties)
        state, (tokens, lp) = self._decode_step_impl(
            state, temps, top_k, top_p, gen, logprobs_k, penalties)
        if logprobs_k > 0:
            return state, tokens, lp
        return state, tokens

    def decode_steps(self, state, n: int, temperatures=None, top_k=None,
                     top_p=None, logprobs_k: int = 0, penalties=None,
                     generator: Optional[torch.Generator] = None):
        """Advance every slot n tokens in one call, with no finish
        masking: the legacy tick's fused decode.

        Returns (state, tokens [n, slots]) — or (state, tokens, lp) with
        lp = (chosen [n, slots], top_vals [n, slots, k], top_ids) when
        logprobs_k > 0. Arguments as ``decode_step``. A slot that hits
        EOS or its budget mid-batch decodes on for the rest of the n
        steps (at most n-1 wasted steps; its writes stay in its own
        rows, which are released before anything reads them); the host
        drops those tokens. Nothing here waits for the device.
        """
        temps, top_k, top_p, gen, penalties = self._decode_args(
            temperatures, top_k, top_p, generator, penalties)
        tokens, lps = [], []
        for _ in range(n):
            state, (next_tokens, lp) = self._decode_step_impl(
                state, temps, top_k, top_p, gen, logprobs_k, penalties)
            tokens.append(next_tokens)
            lps.append(lp)
        tokens = torch.stack(tokens)
        if logprobs_k > 0:
            return state, tokens, tuple(torch.stack(parts)
                                        for parts in zip(*lps))
        return state, tokens

    # ---- speculative verification ----

    @property
    def supports_verify(self) -> bool:
        """Paged engines opt out: verify_forward writes [B, S] positions
        straight into per-slot rows, which the page arena does not expose
        (speculation then refuses the engine)."""
        return (hasattr(self._model_lib, 'verify_forward')
                and self._page_alloc is None and self.mesh is None)

    @torch.no_grad()
    def verify_step(self, state, proposals):
        """Greedy speculative verification: one target pass for γ+1
        tokens.

        proposals [B, γ] (a tensor, or a host array): the next γ tokens
        proposed per slot. The target scores [t0, d1..dγ] (t0 = each
        slot's last accepted token) in ONE verify_forward; d_{i+1}
        survives while it equals the target's argmax after d_1..d_i, and
        the first mismatch is replaced by the target's own argmax (the
        bonus token), so every round emits at least one token and the
        output equals plain greedy decoding.

        Returns (state, emitted [B, γ+1], n_emitted [B]), all on the
        device. The cache is written in place at rows length..length+γ
        (none at or past max_target_len); rows before each slot's length
        are untouched, and rejected rows lie past the new length, where
        later writes overwrite them: rollback is just the length.
        """
        if self.mesh is not None:
            raise NotImplementedError(SPECULATIVE_MESH)
        proposals = torch.as_tensor(proposals, device=self.device).to(
            torch.int32)
        gamma = proposals.shape[1]
        c = self.config.model
        tokens_in = torch.cat([state['tokens'][:, None], proposals], dim=1)
        steps = torch.arange(gamma + 1, device=self.device)
        positions = state['lengths'][:, None] + steps[None, :]
        kv = {'k': state['kv_k'], 'v': state['kv_v']}
        logits, new_kv = self._model_lib.verify_forward(
            c, self.params, tokens_in, positions, kv)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)     # [B, γ+1]
        matches = (proposals == preds[:, :-1]).to(torch.int32)   # [B, γ]
        accepted = torch.cumprod(matches, dim=1).sum(dim=1)      # [B]
        bonus = torch.gather(preds, 1, accepted[:, None].long())[:, 0]
        idx = steps[None, :]
        emitted = torch.where(
            idx < accepted[:, None],
            torch.cat([proposals, torch.zeros_like(bonus)[:, None]], dim=1),
            torch.where(idx == accepted[:, None], bonus[:, None], 0))
        n_emitted = (accepted + 1).to(torch.int32)
        active = state['active']
        new_state = {
            'kv_k': new_kv['k'], 'kv_v': new_kv['v'],
            'lengths': torch.where(
                active, (state['lengths'] + n_emitted).clamp(
                    max=self.config.max_target_len), state['lengths']),
            'tokens': torch.where(active, bonus, state['tokens']),
            'active': active,
            # Not updated: speculation only runs rounds where no slot is
            # penalized (the orchestrator falls back otherwise), and stale
            # counts are neutral at penalty 0.
            'counts': state['counts'],
        }
        return new_state, emitted.to(torch.int32), n_emitted

    def sync_slots_from(self, state, other_state):
        """Align this (draft) state's bookkeeping with the target's after
        a speculative round: lengths, tokens and active are copied over;
        the cache keeps whatever the draft wrote (rows past a slot's
        length are dead, rows before it hold the accepted tokens).

        The per-slot tensors are COPIED, not aliased: both engines update
        their state in place (insert, release), and a shared tensor would
        move the other engine's slots too."""
        state = dict(state)
        for key in ('lengths', 'tokens', 'active'):
            state[key] = other_state[key].clone()
        return state


def _check_quantized_blocks(params, splits) -> None:
    """Refuse full-precision leaves given as blocks to an engine that
    quantizes: their int8 scales would see one block of the contraction
    rows, not the whole leaf's (quantize whole leaves, then cut, as
    ``qops.block`` does)."""
    if isinstance(params, dict):
        for key, value in params.items():
            if isinstance(value, dict):
                _check_quantized_blocks(value, splits[key])
            elif (splits[key] is not None and not qops.is_quantized(value)
                  and qops.quantizes(key, value.shape)
                  and tuple(value.shape) != tuple(splits[key].shape)):
                raise ValueError(
                    f'{key}: a full-precision block of shape '
                    f'{tuple(value.shape)} (whole {splits[key].shape}) '
                    'cannot be quantized: give whole leaves or blocks '
                    'quantized whole, then cut.')


class ChunkedPrefill:
    """Stepwise chunked prefill: one device chunk per step() call.

    Owns the scratch cache and position cursor between steps so the
    orchestrator can interleave prompt chunks with decode ticks: a long
    prompt then adds at most one chunk of latency per emitted token wave
    instead of stalling every running stream for its whole prefill.
    finalize() samples the first token and returns exactly what
    prefill_any returns.
    """

    def __init__(self, engine: InferenceEngine, prompt_tokens,
                 sampling_params, logprobs_k: int = 0,
                 _prefix=None) -> None:
        self.engine = engine
        self.prompt_tokens = prompt_tokens
        self.true_len = len(prompt_tokens)
        self._sp = sampling_params
        self._logprobs_k = logprobs_k
        cache = engine._prefix_cache
        if _prefix is None and cache is not None:
            _prefix = cache.lookup(prompt_tokens)
        prefix_len, prefix_kv = _prefix if _prefix is not None else (0, None)
        self._scratch = engine._make_scratch_cache(prefix_kv)
        self._pos = prefix_len
        self._chunk = engine.config.max_prompt_len
        self._row_logits = None

    @property
    def done(self) -> bool:
        return self._pos >= self.true_len

    def step(self) -> bool:
        """Run one chunk; returns True when the prefill is complete."""
        if self.done:
            return True
        engine = self.engine
        remaining = self.true_len - self._pos
        size = (self._chunk if remaining > self._chunk
                else engine.bucket_for(remaining))
        n_real = min(remaining, size)
        padded = np.zeros((1, size), np.int64)
        padded[0, :n_real] = self.prompt_tokens[self._pos:self._pos + n_real]
        last = self._pos + size >= self.true_len
        self._row_logits, self._scratch = engine._chunk_forward(
            self._scratch, torch.as_tensor(padded, device=engine.device),
            self._pos, n_real - 1, last)
        self._pos += n_real
        return self.done

    def finalize(self):
        """→ (first_token, kv, true_len[, lp]) like prefill_any()."""
        if not self.done:
            raise RuntimeError('finalize() before the last chunk ran')
        engine = self.engine
        sp = self._sp
        temps, top_k, top_p, gen = engine._sampling_args(
            [sp.temperature], [sp.top_k], [sp.top_p])
        first = sampling.sample_batched(self._row_logits, gen, temps, top_k,
                                        top_p)
        if engine._prefix_cache is not None:
            engine._prefix_cache.store(self.prompt_tokens, self._scratch,
                                       self.true_len)
        if self._logprobs_k > 0:
            lp = _logprobs_info(self._row_logits, first, self._logprobs_k)
            return first[0], self._scratch, self.true_len, lp
        return first[0], self._scratch, self.true_len
