#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: require CUDA, print the card's name and power limit, turn
     TF32 off for fp32 products;
  2. build: compile every kernel source in skypilot_tpu_torch/csrc/ (one
     nvcc per source, all at once) and print the build seconds, and the
     registers and spilled bytes of each source and of each wgmma
     kernel;
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main paths' shapes and in the window / segment /
     softcap / int8 / ragged-length cases, in bf16 and fp32, with each
     error beside its tolerance (flash outputs and gradients also
     blockwise, decode outputs per (slot, head), and four planted faults
     must be rejected); the flash kernels also at the wgmma kernels'
     tile edges (S 127, 129, 1000 x GQA groups 1, 2, 4 x D 64, 128), the
     forward at the training shape (row 0 against the plain version,
     then timed beside SDPA), and two dK/dV and two dQ runs at the
     training shape must be bit-identical; dense decode also at its
     split-KV walk's edges (128-row splits); kernel, plain and library
     device times (see time_ms) and the least time the card could take
     (bound): the flash forward,
     the flash backward pair (dK/dV, dQ), dense decode, paged decode, and
     the absorbed-MLA decode pair (dense K6, paged K7: ragged lengths,
     length 0, inactive slots, sentinel tables, pages of 1-256 rows,
     4 heads and r + dr up to 1024, K7 bit for bit equal to K6 on an
     identity table, two calls bit-identical, and planted faults: a slot
     without one split must be rejected, and p without its third bf16
     term is rejected or its distance from the tolerance logged); the
     flash forward and dense decode also at Qwen2-7B's heads (28 over 4
     KV heads, a GQA group of 7), checked and timed (the gqa7_* keys);
  4. serving main path: Llama-3-8B (bf16, random weights from a seeded
     torch.Generator) served by InferenceEngine + Orchestrator: 16
     prompts of ~1000 tokens, 64 new tokens each;
  5. small serving end to end: an fp32 model at LLAMA_TINY widths with
     prefill bucket 1024 (so the flash kernel runs) served on the card and
     on the CPU (plain versions); the greedy tokens must be identical;
  6. training main path: Llama-3-1B (LLAMA3_1B, all 16 layers, bf16,
     random weights) trained by Trainer through measure_throughput at
     seq 8192, global batch 4, remat 'qkvo_gup', adafactor: 2 warm-up
     and 5 measured steps on one repeated batch; the loss must be finite
     and fall;
  7. small training check: LLAMA_TINY widths in fp32 at seq 1024 with EOS
     packing, adamw, accum_steps=2: three steps on the card (kernels) and
     on the CPU (plain versions) must agree;
  8. paged serving main path: the same Llama-3-8B served from a shared
     page arena (32 slots over 2048 pages of 16 rows: the memory that gives
     phase 4 its 16 dense slots): (a) 32 prompts of ~1000 tokens, 64 new
     tokens each, more than the arena holds at once, so some requests are
     deferred and admitted later; (b) a second engine with the prefix
     cache on: two 3000-token prompts prefilled in three chunks each
     between decode ticks, and four prompts sharing their first 768 tokens;
  9. small paged end to end: fp32 LLAMA_TINY widths, paged + chunked +
     prefix cache, on the card and on the CPU; the greedy tokens must be
     identical;
 10. DeepSeek serving main path: DeepSeek-V2-Lite (all 27 layers, public
     widths, bf16, random weights) from a dense slot cache, the traffic
     of phase 4 (16 prompts of ~1000 tokens, 64 new tokens each): K6 in
     every layer of every decode step, no other kernel (prefill attention
     is the plain path: qk dim 192 differs from v dim 128);
 11. DeepSeek paged main path: the same model and weights over 2048 pages
     of 16 rows, the traffic of phase 8(a), with deferral: K7 only;
 12. small DeepSeek end to end: fp32 DEEPSEEK_TINY widths, a dense and a
     paged engine, a wave padded to 4 rows, on the card and on the CPU;
     the greedy tokens must be identical;
 13. int8 replica: bench.py serve's first rung through the port's HTTP
     server (infer/server.py on 127.0.0.1): Llama-3-8B (4 of its 32
     layers since phase 39 joined the script, 8 since 38, 16 since 37), int8
     weights
     quantized on the card as the seeded init draws them, int8 KV, 16
     slots, max_target_len 2048, decode_steps 16; a prompt sent alone
     must give Orchestrator.generate's tokens on the same engine,
     then 16 concurrent POST /generate of 512-token prompts, 128 new
     tokens each: every request whole, K4 only, /metrics counters equal
     to what was sent; tok/s, mean TTFT (/metrics), peak memory, weight
     bytes (K4 only: 512-token prompts take the plain prefill attention,
     below the flash kernel's 1024, as in the reference);
 14. int4 replica: the same with int4 weights (bench.py's second rung)
     and 16 concurrent requests;
 15. small quantized models: fp32 LLAMA_TINY and DEEPSEEK_TINY widths with
     int8 and int4 weights (Llama int8 also over an int8 KV cache),
     quantized on the card and on the CPU to the same bytes, greedy tokens
     on the card equal to the CPU's; at full width, the int8 and int4
     matmul ([16, 4096] x [4096, 14336]), the fp32-output LM head and the
     int8 expert product at DeepSeek-V2-Lite's widths against their plain
     form (dequantize to fp32, fp32 product), and the quantized embedding
     rows equal to the CPU's bit for bit;
 16. launch, checkpoint, resume: python -m skypilot_tpu_torch.train.launch
     (run in-process, so the launch counts stay readable) at phase 6's
     configuration (Llama-3-1B bf16, seq 8192, global batch 4, qkvo_gup,
     adafactor) over uint32 token shards written from a numpy seed and
     read by the native loader (g++ build): 6 steps uninterrupted; 3 steps
     with --checkpoint-every 3; then --steps 6 --resume auto on the same
     directory, which must log "Resumed from checkpoint step 3", run only
     steps 4-6 and give the uninterrupted run's losses within rel 1e-4;
     the metrics file has the reference's keys; tokens/s, the step loop's
     cost of a save, restore seconds, checkpoint bytes and the flight
     recorder's phase shares;
 17. LoRA: examples/tpu/lora_finetune_llama3.yaml on one card (Llama-3-8B
     bf16, rank 16, alpha 32, wq,wk,wv,wo, adamw, lr 1e-3, seq 8192,
     global batch 4 in 4 accumulated rows) for 3 steps on a repeated
     batch: loss finite and falling, the base bit-identical to its seeded
     init, the optimizer state adapter-sized only; tokens/s, model
     TFLOP/s, peak memory;
 18. the converter and the server's --hf-checkpoint: a random Llama-3-1B
     (4 of its 16 layers; 8 before phase 39) written in HF's layout (config.json + bf16
     safetensors from numpy), converted (equal bit for bit to the tree
     built directly from the same tensors) and served by
     infer/server.py; the greedy tokens of three prompts (16, 300 and
     1000 tokens) equal Orchestrator.generate on the directly built tree:
     K1 and K4 only;
 19. small checks, card vs CPU (fp32 LLAMA_TINY widths, seq 1024): the
     converter's fp32 and bf16 trees equal bit for bit; three launcher
     steps from one --init-params and --data, full and LoRA, give the
     same losses within phase 7's tolerance;
 20. Qwen3-8B replica: examples/tpu/serve_qwen.yaml's command without its
     speculative flags (phase 23 adds them) through infer/server.py on
     127.0.0.1: --model qwen3-8b --max-slots 32 --max-target-len 4096,
     bf16, random weights from a seeded generator; three prompts (16, 300
     and 1000 tokens) one at a time, then 32 concurrent prompts of
     1000-1024 tokens, 32 new tokens each: K1 and K4 only, counted from
     the served requests alone; the three served prompts' tokens equal
     Orchestrator.generate on the same engine; tok/s, mean TTFT
     (/metrics), peak memory;
 21. Qwen2-7B (28 query heads over 4 KV heads: GQA group 7, Q/K/V biases)
     served by InferenceEngine + Orchestrator: 16 slots, max_target_len
     2048, bucket 1024, 16 prompts of 1000-1024 tokens, 32 new tokens:
     K1 and K4 only, at group 7;
 22. small Qwen checks, card vs CPU: fp32 qwen-tiny and qwen3-tiny widths
     with random biases and norm scales, bucket 1024: the greedy tokens,
     a chunked prefill with a prefix-cache hit against the whole prompt
     in one 2048 bucket, and loss_fn with every gradient at seq 1024;
 23. serve_qwen.yaml as written: phase 20's replica with --spec-ngram
     --spec-gamma 4 (prompt-lookup speculation), phase 20's 32 prompts plus
     4 copy-heavy ones (a 64-token block 8 times) and one sampled request,
     so that plain rounds run too: two prompts one at a time give the
     speculator's own generate; K1 launches once per layer for each
     prompt in the 1024 bucket (admission is one at a time) and K4 once
     per layer per plain round, none in a verify round; every greedy
     stream equals plain greedy decoding on the same engine, or parts
     from it at a tie (the plain margin between the two tokens at most
     twice the largest logit difference of the decode and verify paths
     there); tok/s, mean TTFT, the spec counters of /metrics, acceptance
     and peak memory beside phase 20's;
 24. draft-model speculation: --model llama3-8b --draft-model llama3-1b
     is refused with the reference's ValueError (the repo's llama3-1b has
     a 32,768-token vocabulary); served instead through the HTTP handler
     as the server wires it: Llama-3-8B with a draft at llama3-1b's widths
     and Llama-3's vocabulary, 16 slots x 2048, 16 prompts of 960-1024
     tokens and one sampled request; the checks of phase 23, with K1 for
     both engines' prefills and K4 for the draft's 5 steps a speculative
     round and the target's plain rounds; then a Llama-3-1B self-draft
     (one engine, its own draft) must accept at least half its proposals;
 25. small speculative checks, card vs CPU: fp32 LLAMA_TINY and
     qwen3-tiny targets, bucket 1024: NgramSpeculator and
     SpeculativeOrchestrator (a one-layer draft, and the target drafting
     for itself) give plain greedy tokens and equal accept_stats on both;
     the self-draft accepts every proposal.
 26. Gemma2-9B replica: infer/server.py --model gemma2-9b --max-slots 8
     --max-target-len 8192 on 127.0.0.1, bf16, random weights from a
     seeded generator (head_dim 256, softcap 50, scale 1/16, a window of
     4096 on even layers, a tied soft-capped head); a prompt of 6000-8000
     tokens alone (prefilled in 1024-token chunks, then decoded over its
     even layers' live window alone), then 8 concurrent prompts of
     1000-1024 tokens, 32 new tokens each: K1 = 42 layers x
     prefill waves in the 1024 bucket, K4 = 42 x decode steps, no other
     kernel; the long prompts' served tokens equal Orchestrator.generate
     on the same engine; tok/s, mean TTFT (/metrics), peak memory;
 27. small Gemma checks, card vs CPU: fp32 gemma-tiny, gemma2-tiny and
     gemma2-tiny at head_dim 256 (so K1 and K4 run at D 256 inside a
     model), random norms, bucket 1024: served greedy tokens,
     NgramSpeculator's tokens equal plain greedy, a chunked prefill with a
     prefix-cache hit against the whole prompt in one 2048 bucket; only K1
     and K4 on the card.
 28. Gemma2-2B training: python -m skypilot_tpu_torch.train.launch
     in-process, --model gemma2-2b --seq-len 8192 --global-batch-size 1
     --optimizer adafactor (bf16, random weights from the seeded init,
     head_dim 256, softcap 50, scale 1/16, a window of 4096 on even
     layers, the tied fp32 head; 4 of its 26 layers since phase 39
     joined the script, 8 since 38, 14 before) over uint32 token shards: 5 steps (2
     warm-up, 3 measured); 2 steps with --checkpoint-every 2, then --steps 4
     --resume auto, whose losses must equal the uninterrupted run's
     within rel 1e-4; K1 = 2 x 14 layers x steps (the remat policy
     recomputes attention), K2 = K3 = 14 x steps, nothing else; tokens/s,
     model TFLOP/s and its share of 989, peak memory, the flight
     recorder's phase shares, and the fp32 head's forward and backward
     timed alone against a step;
 29. small Gemma training checks, card (kernels, TF32 off) vs CPU (plain
     versions): fp32 gemma-tiny, gemma2-tiny and gemma2-tiny at head_dim
     256, random norms, seq 1024: three Trainer steps each (adafactor,
     accum_steps=2) and three LoRA steps on the head_dim-256 config; the
     losses, grad norms and every parameter agree, the LoRA base stays
     bit-identical, and only K1-K3 run on the card.
 30. Mixtral-8x7B replica: infer/server.py --model mixtral-8x7b
     --weight-dtype int8 --max-slots 16 --max-target-len 4096 (the slots
     and cache of examples/tpu/serve_mixtral.yaml, whose --mesh expert=8
     is refused) on 127.0.0.1, random weights quantized on the card as
     the seeded init draws them (the bf16 tree, 93.4 GB, is larger than
     the card): the build's time, weight bytes and peak memory (it must
     stay under half a bf16 expert stack above the finished tree); a
     3500-token prompt alone (prefilled in 1024-token chunks), then 16
     concurrent prompts of 256-1536 tokens, 32 new tokens each: K1 = 32
     layers x prefill waves in the 1024 bucket, K4 = 32 x decode steps,
     no other kernel; /metrics counters equal what was sent; the prompt
     sent alone gives Orchestrator.generate's tokens on the same engine;
     tok/s, mean TTFT (/metrics), peak memory; then the largest wave (16
     x 1024 tokens) alone, its time and peak memory, and one decode
     step's device time (the profiler's kernel sum);
 31. small Mixtral checks, card vs CPU: fp32 moe-tiny with random norms,
     bucket 1024: greedy tokens of a 3-prompt wave padded to 4 rows at
     capacity factor 0.25 (experts drop real tokens: counted), a chunked
     prefill with a prefix-cache hit equal to the whole prompt in one
     2048 bucket, and int8 weights (the same bytes on both); only K1 and
     K4 on the card.
 32. Mixtral-8x7B training: its public widths cut to 2 of 32 layers by
     the card's memory (AdamW's 8 bytes a parameter), bf16, remat, seeded
     random weights, Trainer with adamw (warm-up 1) at seq 4096, global
     batch 2, 4 steps (1 warm-up, 3 measured) over seeded token batches:
     each step's loss and load-balance term apart (finite, the term
     positive), tokens/s, model TFLOP/s, peak memory; K1 = 2 x 2 layers x
     steps (remat), K2 = K3 = 2 x steps, nothing else;
 33. DeepSeek-V2-Lite training: (a) cut to 4 layers (1 dense + 3
     routed), full-parameter, the same optimizer, seq 4096, batch 1, 4
     steps, logged as [32]; (b) all 27 layers with LoRA through
     train/launch.py (--lora-rank 16 --lora-targets wq,w_ukv,wo --seq-len
     4096 --global-batch-size 1, in-process, over uint32 token shards, 4
     steps): the frozen base's bytes, the adapters' count, losses,
     tokens/s, peak memory; no kernel runs in either (plain attention);
 34. small Mixtral and DeepSeek training checks, card vs CPU: fp32
     moe-tiny at capacity factor 0.5 (K1-K3 at seq 1024),
     deepseek-tiny and deepseek-tiny-moe-only, with a token mask and a
     loss mask: the loss, its load-balance term and every gradient (two
     card runs bit-identical), two Trainer steps; train/launch.py --model
     moe-tiny resumed from a checkpoint within rel 1e-4.
 35. the classifier: python -m skypilot_tpu_torch.train.classify with
     examples/tpu/finetune_classifier.yaml's flags (--model 1b
     --batch-size 32 --seq-len 256 --lr 1e-4) and 60 steps in place of
     its 500, in-process (Llama-3-1B bf16, random weights, the synthetic
     set): the reference's JSON keys, a finite loss, K1 = 16 layers x
     (steps + 4 held-out batches), K2 = K3 = 16 x steps, nothing else;
     tokens/s of the step loop, peak memory, eval accuracy; then
     --head-only for 5 steps: K1 only, every trunk leaf bit-identical;
     then the reference test's small check (fp32 LLAMA_TINY, seq 32, B8,
     lr 1e-3, 60 steps, the flash kernels at D16): eval accuracy >= 0.8
     and every loss on the card equal to the CPU's within 1e-4;
 36. the workload hooks: a Llama-3-1B engine (8 slots x 2048, bucket
     1024) serves 8 prompts of 960-1024 tokens, 32 new, with the
     profiler sampling every 2nd tick onto a telemetry spool, by the fast
     tick and by the legacy tick (XSKY_DECODE_FAST_TICK=0) at
     decode_steps 1 and 4: equal greedy streams, K1 = 16 x flash waves and
     K4 = 16 x decode steps on each, and a spool profile with sampled
     steps, device time, a dispatch-gap ratio in (0, 1), HBM in use below
     the card's total and no compile after warm-up; then a chaos plan
     (infer.decode_stall on 2 ticks at 0.2 s, profiler.dispatch_stall at
     0.5 s): the fires counted, the two ticks >= 0.2 s longer, the sampled
     gap >= 0.5 s; 4 Llama-3-1B Trainer steps (seq 2048) sampled every
     2nd: the sampled flight-recorder records synced with device time;
     python -m skypilot_tpu_torch.agent.profiler capture as a subprocess:
     the reference's keys, the card's name, positive times, a parseable
     Chrome trace;
 37. data-parallel and FSDP training over torch.distributed ranks:
     Llama-3-1B bf16 (16 layers, remat qkvo_gup, adafactor, global batch
     4, seq 4096, synthetic batches, the warm-up cut to 1 step) through
     python -m skypilot_tpu_torch.train.launch: (a) one rank in-process
     at --mesh data=1, 3 steps; one gang of two rank processes on the
     one card, started by one launcher (train/launch.py's main with
     --procs-per-host 2; gloo, since they share the card), runs in turn
     (b) --mesh data=1,fsdp=2, 1 step, checkpointing at step 1, (c)
     --mesh data=2, 1 step, and (f) fp32 at d_model 128 (seq 1024, so
     K1-K3 run) at fsdp=2: (b) and (c) give one rank's step-1 loss
     within rel 1e-3 and grad norm within rel 1e-2, both ranks the same,
     the metrics file from rank 0 alone; (d) one rank resumes (b)'s
     checkpoint at --mesh data=1 to step 3: steps 2 and 3 within rel
     1e-2 of (a)'s; (e) each fsdp rank's parameter bytes exactly half of
     (a)'s, optimizer-state bytes and peak memory printed beside a
     one-rank run's at the same per-rank batch, K1 = 2 x 16 x steps and
     K2 = K3 = 16 x steps on every rank, nothing else; (f) two ranks'
     parameters after 2 steps within 1e-5 of one rank's on the card;
     then on the same gang at --mesh data=1,fsdp=1,tensor=2 (g)
     Llama-3-8B's widths at 1 of 32 layers, 2 steps and their
     checkpoint, which one rank's Trainer loads for step 3 (steps 1-3
     within rel 1e-3 of one rank's), and (h) Gemma2-2B's at 2
     of 26 layers, 1 step, each beside one rank's run;
 38. expert parallelism, each gang started by one launcher with
     --procs-per-host: (a) Mixtral-8x7B's widths at 1 of 32 layers (bf16,
     remat, adamw, seq 4096, B2) at --mesh data=1,fsdp=1,expert=2, two
     ranks, 2 steps and their checkpoint, which one rank's Trainer loads
     for step 3 (step 2's update is the first at a nonzero learning
     rate); (b) DeepSeek-V2-Lite's at 2 of 27 layers (one dense, one
     routed) at
     data=1,fsdp=2,expert=2, four ranks, 1 step; each beside one rank's
     run of the same flags: every step's loss and grad norm within rel
     1e-5, every rank the same, each rank's parameters exactly its
     blocks' count, peaks printed, the resumed step 3 within rel 1e-5 of
     one rank's, K1 = 2 x 1 and K2 = K3 = 1 a step on each rank of (a),
     nothing in (b), and (b)'s share of dropped (token, choice) pairs
     above 0.
 39. serving under a mesh, each replica a gang of rank processes that
     one `python -m skypilot_tpu_torch.infer.server --procs-per-host N`
     launcher starts (the ranks share the card over gloo; requests over
     HTTP to 127.0.0.1; each rank's kernels counted in its own process,
     chip_smoke.serve_rank): (a) serve_mixtral.yaml's replica at --mesh
     expert=2 (Mixtral-8x7B, 32 layers, int8 weights, 16 slots x 4096)
     against [30]'s outputs: the 3500-token single (32 new tokens)
     equal to [30]'s or parting at a near-tie, its first-token logprobs
     within MESH_LP_ATOL, then [30]'s 16 concurrent prompts; each rank's
     weights its blocks' bytes, its cache [30]'s; SIGTERM ends the gang;
     (b) Llama-3-8B's widths at 4 of 32 layers at --mesh data=2,tensor=2
     (four ranks, 16 slots x 2048: a greedy, a sampled and a penalized
     single, then 16 concurrent prompts of 960-1024 tokens) beside one
     rank of the same depth and seed: each rank's cache a quarter of one
     rank's, 16 query and 4 KV heads a rank, a follower SIGKILLed
     mid-decode fails the request and the gang (137); (c)
     DeepSeek-V2-Lite's widths at 4 of 27 layers at --mesh
     data=2,expert=2 (8 slots x 2048, K6 on 4 local slots a rank). Every
     rank decodes the same tokens, bit for bit; K1, K4, K6 per rank as
     derived from its own waves and steps.
Phase 3 also holds K2 and K3 at Mixtral's training heads (bf16 B2 S4096
H32/8 D128, causal: checked blockwise, two runs bit-identical, timed
beside the plain backward and SDPA's): the `mixtral` entries of K2's and
K3's records.
Phase 3 also holds K1 at D 256 (Gemma's head dim: tile edges, Gemma2-9B's
wave of 8192 tokens with and without its window, Gemma-2B's and
Gemma-7B's heads, bf16 and fp32, timed), K2 and K3 at D 256 (tile edges
at GQA groups 1, 2 and 8 with segment ids, then B1 S8192 waves on
Gemma2-2B's and Gemma2-9B's heads with softcap 50, scale 1/16 and the
window of 4096 or none, and Gemma-2B's and Gemma-7B's heads, in bf16 and
fp32: checked, two runs bit-identical, timed beside the plain backward
and SDPA's), K4 at D 256 (8 slots x 8192, window 4096, softcap 50,
scale 1/16: bf16, fp32 and int8 caches, GQA groups 1, 2 and 8, timed)
and K5 at D 256; they land in the kernels line as the `d256` entries.
Phase 2 fails if a D 256 instantiation of the flash backward spills.
Before each main path (4, 6, 8a, 8b, 10, 11, 13, 14, each run of 16, 17,
18, 20, 21, each launcher run of 34) every kernel's launch count is set
to 0; just after, the kernels of that path must each have run, and no
other. Phases 23, 24 (and its self-draft), 26, each run of 28, 30, 32
and both runs of 33, both runs of 35, each served run of 36 and each
rank of each run of 37 and 38 (its own process: counted there and
reported in its JSON) hold each kernel to the count derived from the run's
prefills, steps and rounds, every other kernel to 0. A phase's first
line says when it began.

The second-to-last lines are the kernels' JSON record and the
`nvidia-smi` name/power-limit line; the last line is
{"ok": true, "device": {...}}. Nothing of JAX is imported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import functools
import itertools
import json
import logging
import os
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from skypilot_tpu_torch.ops import decode_attention as decode_ops  # noqa: E402
from skypilot_tpu_torch.ops import flash_attention as flash_ops  # noqa: E402
from skypilot_tpu_torch.ops import kernels  # noqa: E402
from skypilot_tpu_torch.ops import mla_decode as mla_ops  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core
# and fp32 non-tensor-core rates, and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# Tolerances, kernel vs plain version on the same inputs. fp32: both
# compute in fp32 and differ by summation order only. bf16: the plain
# versions compute in fp32 and round the output once; the flash kernel
# also rounds P to bf16 before P·V (as the Pallas kernel does), so
# outputs may differ by one or two bf16 ulps (2^-8 relative each).
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RTOL = {torch.float32: 0.0, torch.bfloat16: 1e-2}
LSE_ATOL = 1e-3
# Flash outputs and gradients, kernel vs plain version, are also judged
# in each block of 64 rows of one head against the reference's own size
# there (flash_ops.gradient_errors): under a causal mask both shrink along
# the sequence (an output row's spread is about sqrt(e / pos)), so one
# absolute tolerance would pass a wrong later block. Limits on the
# blockwise relative error ||got-want||/||want|| and on the largest
# element error over the block's RMS. fp32 sums over up to S rows in
# another order. bf16 also rounds P and dS to bf16 before their products
# (as the Pallas kernels do) and the result on the way out. Over the
# cases below, on an H100, the kernels read at most 3.5e-3 and 5.7e-2 for
# bf16 outputs, 5.1e-3 and 8.2e-2 for bf16 gradients (the tile-edge cases
# at S 129 the largest), 8.4e-7 and 2.2e-5 for fp32 outputs, 1.1e-6 and
# 3.1e-5 for fp32 gradients; a 10 % error confined to some blocks reads
# 0.1 and above (the planted faults below).
BLOCK_NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
BLOCK_ELEM_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.15}

REPLACES = {
    'flash_fwd': 'skypilot_tpu/ops/flash_attention.py:64',
    'flash_bwd_dkv': 'skypilot_tpu/ops/flash_attention.py:300',
    'flash_bwd_dq': 'skypilot_tpu/ops/flash_attention.py:360',
    'decode_attention': 'skypilot_tpu/ops/decode_attention.py:73',
    'paged_decode_attention': 'skypilot_tpu/ops/decode_attention.py:143',
    'mla_decode': 'skypilot_tpu/ops/mla_decode.py:41',
    'paged_mla_decode': 'skypilot_tpu/ops/mla_decode.py:149',
}
SERVE_KERNELS = ('flash_fwd', 'decode_attention')
PAGED_SERVE_KERNELS = ('flash_fwd', 'paged_decode_attention')
TRAIN_KERNELS = ('flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq')
DEEPSEEK_KERNELS = ('mla_decode',)
PAGED_DEEPSEEK_KERNELS = ('paged_mla_decode',)


_START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's first line (it starts with '[') also says
    when the phase began, in seconds since the script started."""
    if msg.startswith('['):
        msg = f'{msg} (at {time.perf_counter() - _START:.1f} s)'
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# Attempts of time_ms, each with twice the last one's hold.
TIMING_ATTEMPTS = 3


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over iters runs, by CUDA events. The
    device is first held busy (torch.cuda._sleep) for three times as long
    as the host takes to queue the runs (at least 10 ms), so the events
    bracket device work only, not the host's enqueue rate: a decode
    kernel takes less device time than its Python wrapper takes host
    time. A host that did not finish queueing before the hold ran out
    (a pause of its own: a call of 0.1 ms once took 1.6 ms) voids the
    attempt, and the next one holds twice as long; raises after
    TIMING_ATTEMPTS voided attempts."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    call_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_ms = max(10.0, 1.0 + 3 * iters * call_ms)
    for _ in range(TIMING_ATTEMPTS):
        # Cycles at 2 GHz, above the card's clock: the hold lasts at
        # least hold_ms.
        torch.cuda._sleep(int(hold_ms * 2e6))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued_ms <= hold_ms:
            return start.elapsed_time(end) / iters
        log(f'  timing: the host took {queued_ms:.2f} ms to queue {iters} '
            f'runs, past the {hold_ms:.2f} ms hold; timing again')
        hold_ms *= 2
    raise AssertionError(f'timing: the host took {queued_ms:.2f} ms to '
                         f'queue {iters} runs, past the {hold_ms / 2:.2f} '
                         'ms hold, so the events would include host time')


def busy_ms(fn) -> tuple:
    """(device ms, wall ms) of one fn() call after a warm one: the device
    time is the sum of its kernels' times in a torch.profiler trace (one
    stream, so they do not overlap). For a call that launches more
    kernels than the launch queue holds, where time_ms's hold cannot
    cover the host's queueing."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = sum(evt.device_time_total for evt in prof.events()
                 if evt.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    if not device:
        raise AssertionError('the profiler saw no device time')
    return device, wall


def host_ms(fn, iters: int = 20) -> float:
    """Host time of one fn() call (checks, scratch, launch), the calls
    queued back to back without a synchronize in between."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return dt


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            dtype, atol=None, rtol=None) -> float:
    atol = ATOL[dtype] if atol is None else atol
    rtol = RTOL[dtype] if rtol is None else rtol
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    max_err = float(err.max())
    log(f'  {name}: max_abs_err={max_err:.3e} (tolerance atol={atol:g} '
        f'rtol={rtol:g})')
    if not torch.isfinite(got.float()).all() or bool(bad.any()):
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version (max_abs_err={max_err:.3e})')
    return max_err


def compare_blocks(name: str, got: torch.Tensor, want: torch.Tensor,
                   dtype, block_rows: int = 64) -> float:
    """A gradient or a forward output [B, S, H, D] against the plain
    version's, blockwise (see BLOCK_NORM_TOL) → its largest absolute
    error. A decode output [B, 1, H, D] is judged per (slot, head) with
    block_rows=1."""
    norm_err, elem_err = flash_ops.gradient_errors(got, want, block_rows)
    max_err = float((got.float() - want.float()).abs().max())
    log(f'  {name}: block rel err {norm_err:.3e} (limit '
        f'{BLOCK_NORM_TOL[dtype]:g}), element err / block rms '
        f'{elem_err:.3e} (limit {BLOCK_ELEM_TOL[dtype]:g}); mean |ref| '
        f'{float(want.float().abs().mean()):.3e}, max_abs_err '
        f'{max_err:.3e}')
    if not (norm_err <= BLOCK_NORM_TOL[dtype]
            and elem_err <= BLOCK_ELEM_TOL[dtype]):
        raise AssertionError(f'{name}: kernel disagrees with the plain '
                             f'version (block rel err {norm_err:.3e}, '
                             f'element err {elem_err:.3e})')
    return max_err


def expect_rejected(name: str, got: torch.Tensor, want: torch.Tensor,
                    dtype, block_rows: int = 64) -> None:
    """A planted fault must fail compare_blocks: the check can see it."""
    try:
        compare_blocks(f'planted fault, {name}', got, want, dtype,
                       block_rows)
    except AssertionError:
        log('    rejected, as it must be')
        return
    raise AssertionError(f'the gradient check passed a planted fault: '
                         f'{name}')


def rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device='cuda').to(dtype)


# ---- phase 3: kernel checks ----

def segments_for(b, s):
    """Three packed documents per row, boundaries differing by row."""
    cuts = torch.tensor([[s // 3 + 7 * i, 2 * s // 3 - 5 * i]
                         for i in range(b)], device='cuda')
    pos = torch.arange(s, device='cuda')[None, :]
    return ((pos >= cuts[:, :1]).int() + (pos >= cuts[:, 1:]).int()
            ).to(torch.int32).contiguous()


def flash_case(gen, label, dtype, b, s, h, h_kv, d, causal=True,
               window=None, segments=False, softcap=None, scale=None):
    q = rand(gen, (b, s, h, d), dtype)
    k = rand(gen, (b, s, h_kv, d), dtype)
    v = rand(gen, (b, s, h_kv, d), dtype)
    seg = segments_for(b, s) if segments else None
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale_override=scale)
    out, lse = flash_ops._flash_fwd(q, k, v, seg, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_ops.flash_attention_plain(
        q, k, v, causal=causal, window=window, segment_ids=seg,
        logit_softcap=softcap, scale=scale)
    err = compare(f'flash {label} out', out, ref_out, dtype)
    compare_blocks(f'flash {label} out', out, ref_out, dtype)
    compare(f'flash {label} lse', lse, ref_lse, torch.float32,
            atol=LSE_ATOL, rtol=0.0)
    return (q, k, v, seg, kw), err


# Tile edges of the wgmma kernels (128-row query blocks and key tiles in
# the forward, 128-key blocks and 64-row query tiles in dK/dV): each
# (S, GQA group, D) at B2 with 4 query heads, cycling through the mask
# variants.
EDGE_SHAPES = list(itertools.product((127, 129, 1000), (1, 2, 4), (64, 128)))
EDGE_VARIANTS = ({}, {'window': 100}, {'segments': True},
                 {'softcap': 30.0, 'scale': 0.1}, {'causal': False})


def edge_cases():
    for i, (s, groups, d) in enumerate(EDGE_SHAPES):
        kw = EDGE_VARIANTS[i % len(EDGE_VARIANTS)]
        tag = ' '.join(f'{k}={v}' for k, v in kw.items()) or 'causal'
        yield (f'bf16 edge S{s} H4/{4 // groups} D{d} {tag}',
               (2, s, 4, 4 // groups, d), kw)


def check_flash(gen) -> dict:
    log('[3] flash_fwd: kernel vs plain version')
    for label, shape, kw in edge_cases():
        flash_case(gen, label, torch.bfloat16, *shape, **kw)
    for dtype in (torch.bfloat16, torch.float32):
        name = 'bf16' if dtype == torch.bfloat16 else 'fp32'
        flash_case(gen, f'{name} B4 S1024 H32/8 D128 causal', dtype,
                   4, 1024, 32, 8, 128)
        flash_case(gen, f'{name} window=100 S300', dtype, 2, 300, 4, 2,
                   64, window=100)
        flash_case(gen, f'{name} segments S300', dtype, 2, 300, 4, 2, 64,
                   segments=True)
        flash_case(gen, f'{name} softcap=30 scale=0.1 S300', dtype, 2,
                   300, 4, 2, 64, softcap=30.0, scale=0.1)
        flash_case(gen, f'{name} non-causal S200 D32', dtype, 2, 200, 4,
                   1, 32, causal=False)
        flash_case(gen, f'{name} D16 S1024 (LLAMA_TINY widths)', dtype,
                   2, 1024, 4, 2, 16)
    # The main path's prefill wave: 16 prompts in one 1024 bucket.
    (q, k, v, _, kw), err = flash_case(
        gen, 'bf16 main-path B16 S1024 H32/8 D128', torch.bfloat16,
        16, 1024, 32, 8, 128)
    times = flash_timings('main-path', q, k, v, kw)
    del q, k, v
    gqa7 = flash_group7(gen)
    train = flash_train_shape(gen)
    gemma = flash_head_dim_256(gen)
    return {'name': 'flash_fwd', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
            'replaces': REPLACES['flash_fwd'], 'max_abs_err': err,
            **times, **gqa7, **train, 'd256': gemma}


def flash_timings(label, q, k, v, kw) -> dict:
    """Kernel, plain and SDPA (library) device times of one causal bf16
    forward at q's shape, beside its bound, and the wrapper's host time."""
    b, s, h, d = q.shape
    ms = time_ms(lambda: flash_ops._flash_fwd(q, k, v, None, **kw))
    # Host time of one wrapper call (checks, tensor maps, launch).
    wrapper_ms = host_ms(lambda: flash_ops._flash_fwd(q, k, v, None, **kw))
    plain_ms = time_ms(lambda: flash_ops.flash_attention_plain(q, k, v),
                       iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    elem = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * elem + (
        b * h * s * 4)
    # Causal: each row attends to itself and the keys before it.
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)
    bound, bound_by = bound_ms(nbytes, flops, q.dtype)
    log(f'  flash {label} timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, SDPA (library) {library_ms:.4f} ms, bound '
        f'{bound:.4f} ms ({bound_by}); {flops / ms / 1e9:.2f} TFLOP/s; '
        f'wrapper host time {wrapper_ms:.4f} ms a call')
    return {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': bound_by, 'library_ms': library_ms,
            'host_ms': wrapper_ms}


def flash_group7(gen) -> dict:
    """Qwen2-7B's heads, 28 query heads over 4 KV heads (a GQA group of
    7): B2 in bf16 and fp32 against the plain version, then phase [21]'s
    prefill wave (B16 S1024) against it and timed → the record's gqa7_*
    entries."""
    errs = []
    for dtype, name in ((torch.bfloat16, 'bf16'), (torch.float32, 'fp32')):
        errs.append(flash_case(gen, f'{name} B2 S1024 H28/4 D128 causal '
                               '(GQA group 7)', dtype, 2, 1024, 28, 4,
                               128)[1])
    (q, k, v, _, kw), err = flash_case(
        gen, 'bf16 B16 S1024 H28/4 D128 causal (GQA group 7, the wave of '
        '[21])', torch.bfloat16, 16, 1024, 28, 4, 128)
    times = flash_timings('GQA group 7 wave', q, k, v, kw)
    return {'gqa7_shape': 'B16 S1024 H28/4 D128 causal',
            'gqa7_max_abs_err': max(errs + [err]),
            **{f'gqa7_{key}': value for key, value in times.items()}}


def causal_pairs(s: int, window=None) -> int:
    """(query, key) pairs a causal attention over s rows computes: each
    row attends to itself and the keys before it, at most ``window``."""
    rows = np.arange(1, s + 1)
    return int((rows if window is None else np.minimum(rows, window)).sum())


# Gemma's head dim: K1 at Gemma2-9B's prefill wave (B1 S8192, 16 query
# heads over 8, softcap 50, scale 1/16, with the even layers' window of
# 4096 and without), in bf16 and fp32, and at Gemma-2B's (8 over 1) and
# Gemma-7B's (16 over 16) heads; first at the wgmma kernel's tile edges
# (64-key tiles at D 256).
D256_EDGES = list(itertools.product((127, 129, 1000), (1, 2, 8)))
D256_WAVES = (
    ('bf16 Gemma2-9B wave B1 S8192 H16/8 D256, window 4096', torch.bfloat16,
     16, 8, 4096, 50.0),
    ('bf16 Gemma2-9B wave B1 S8192 H16/8 D256, no window', torch.bfloat16,
     16, 8, None, 50.0),
    ('fp32 Gemma2-9B wave B1 S8192 H16/8 D256, window 4096', torch.float32,
     16, 8, 4096, 50.0),
    ('fp32 Gemma2-9B wave B1 S8192 H16/8 D256, no window', torch.float32,
     16, 8, None, 50.0),
    ('bf16 Gemma-2B wave B1 S8192 H8/1 D256', torch.bfloat16, 8, 1, None,
     None),
    ('bf16 Gemma-7B wave B1 S8192 H16/16 D256', torch.bfloat16, 16, 16,
     None, None))


def flash_head_dim_256(gen) -> list:
    """K1 at D 256 against its plain version: the tile edges, then each
    wave of D256_WAVES checked and timed beside its bound (the pairs its
    mask keeps) and SDPA's time at the same shapes without the softcap
    and the window (one PyTorch call takes neither) → one record each."""
    for i, (s, groups) in enumerate(D256_EDGES):
        kw = EDGE_VARIANTS[i % len(EDGE_VARIANTS)]
        tag = ' '.join(f'{k}={v}' for k, v in kw.items()) or 'causal'
        flash_case(gen, f'bf16 edge S{s} H8/{8 // groups} D256 {tag}',
                   torch.bfloat16, 2, s, 8, 8 // groups, 256, **kw)
    out = []
    for label, dtype, h, h_kv, window, softcap in D256_WAVES:
        b, s, d = 1, 8192, 256
        (q, k, v, _, kw), err = flash_case(
            gen, label, dtype, b, s, h, h_kv, d, window=window,
            softcap=softcap, scale=d ** -0.5)
        ms = time_ms(lambda: flash_ops._flash_fwd(q, k, v, None, **kw),
                     iters=5, warmup=1)
        plain_ms = time_ms(lambda: flash_ops.flash_attention_plain(
            q, k, v, window=window, logit_softcap=softcap,
            scale=d ** -0.5), iters=2, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True, scale=d ** -0.5),
            iters=5, warmup=1)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size(
        ) + b * h * s * 4
        flops = 4.0 * b * h * d * causal_pairs(s, window)
        bound, bound_by = bound_ms(nbytes, flops, dtype)
        log(f'  flash {label} timing: kernel {ms:.4f} ms, plain '
            f'{plain_ms:.4f} ms, SDPA (library, causal, no softcap or '
            f'window) {library_ms:.4f} ms, bound {bound:.4f} ms '
            f'({bound_by}); {flops / ms / 1e9:.2f} TFLOP/s')
        out.append({'shape': label, 'max_abs_err': err, 'ms': ms,
                    'plain_ms': plain_ms, 'bound_ms': bound,
                    'bound_by': bound_by, 'library_ms': library_ms,
                    'library': 'SDPA, causal, without softcap and window'})
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def flash_train_shape(gen) -> dict:
    """The forward at the training path's shape (B4 S8192 H16/8 D128,
    causal): batch row 0 against the plain version (which holds fp32
    [H, S, S] scores), then kernel, SDPA and bound times at B4."""
    dtype = torch.bfloat16
    b, s, h, h_kv, d = 4, 8192, 16, 8, 128
    q = rand(gen, (b, s, h, d), dtype)
    k, v = (rand(gen, (b, s, h_kv, d), dtype) for _ in range(2))
    out, lse = flash_ops._flash_fwd(q, k, v, None)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_ops.flash_attention_plain(
        *(t[:1].contiguous() for t in (q, k, v)))
    label = 'bf16 training shape B4 S8192 H16/8 D128 (row 0 vs plain)'
    err = compare(f'flash {label} out', out[:1], ref_out, dtype)
    compare_blocks(f'flash {label} out', out[:1], ref_out, dtype)
    compare(f'flash {label} lse', lse[:1], ref_lse, torch.float32,
            atol=LSE_ATOL, rtol=0.0)
    # The check must see a fault on the V side (a wrong V panel or ring
    # stage, a bad rescale) confined to the later rows, where the output
    # is smallest: the output 10 % low past row 4096. One absolute
    # tolerance cannot: its verdict is printed beside.
    bad_out = out[:1].clone()
    bad_out[:, s // 2:] *= 0.9
    loose = (bad_out.float() - ref_out.float()).abs() <= (
        ATOL[dtype] + RTOL[dtype] * ref_out.float().abs())
    log(f'  planted fault, out x 0.9 past row 4096: the absolute check '
        f'alone would {"pass" if bool(loose.all()) else "reject"} it')
    expect_rejected('out x 0.9 past row 4096', bad_out, ref_out, dtype)
    del out, lse, ref_out, ref_lse, bad_out, loose
    torch.cuda.empty_cache()
    ms = time_ms(lambda: flash_ops._flash_fwd(q, k, v, None), iters=5,
                 warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=5, warmup=1)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + (
        b * h * s * 4)
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)
    bound, bound_by = bound_ms(nbytes, flops, dtype)
    log(f'  flash training-shape timing: kernel {ms:.4f} ms, SDPA (library) '
        f'{library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); '
        f'{flops / ms / 1e9:.2f} TFLOP/s')
    return {'train_shape': 'B4 S8192 H16/8 D128 causal', 'train_ms': ms,
            'train_max_abs_err': err, 'train_bound_ms': bound,
            'train_library_ms': library_ms}


def flash_bwd_case(gen, label, dtype, b, s, h, h_kv, d, causal=True,
                   window=None, segments=False, softcap=None, scale=None):
    """Both backward kernels vs the plain backward on one forward's
    output and LSE → (inputs, {kernel name: max error})."""
    q, dout = (rand(gen, (b, s, h, d), dtype) for _ in range(2))
    k, v = (rand(gen, (b, s, h_kv, d), dtype) for _ in range(2))
    seg = segments_for(b, s) if segments else None
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale_override=scale)
    out, lse = flash_ops._flash_fwd(q, k, v, seg, **kw)
    dq = flash_ops._flash_bwd_dq(q, k, v, seg, out, dout, lse, **kw)
    dk, dv = flash_ops._flash_bwd_dkv(q, k, v, seg, out, dout, lse, **kw)
    torch.cuda.synchronize()
    ref = flash_ops.flash_attention_bwd_plain(
        q, k, v, out, dout, lse, causal=causal, window=window,
        segment_ids=seg, logit_softcap=softcap, scale=scale)
    errs = {'flash_bwd_dq': compare_blocks(f'bwd {label} dq', dq, ref[0],
                                         dtype)}
    errs['flash_bwd_dkv'] = max(
        compare_blocks(f'bwd {label} dk', dk, ref[1], dtype),
        compare_blocks(f'bwd {label} dv', dv, ref[2], dtype))
    return (q, k, v, seg, out, dout, lse, kw), errs


def check_flash_bwd(gen) -> dict:
    log('[3] flash backward (dK/dV, dQ): kernels vs plain version')
    for label, shape, kw in edge_cases():
        flash_bwd_case(gen, label, torch.bfloat16, *shape, **kw)
    for dtype in (torch.bfloat16, torch.float32):
        name = 'bf16' if dtype == torch.bfloat16 else 'fp32'
        flash_bwd_case(gen, f'{name} B2 S1024 H16/8 D128 causal', dtype,
                       2, 1024, 16, 8, 128)
        flash_bwd_case(gen, f'{name} window=100 S300', dtype, 2, 300, 4, 2,
                       64, window=100)
        flash_bwd_case(gen, f'{name} segments S300', dtype, 2, 300, 4, 2,
                       64, segments=True)
        flash_bwd_case(gen, f'{name} softcap=30 scale=0.1 S300', dtype, 2,
                       300, 4, 2, 64, softcap=30.0, scale=0.1)
        flash_bwd_case(gen, f'{name} non-causal S200 D32', dtype, 2, 200, 4,
                       1, 32, causal=False)
        flash_bwd_case(gen, f'{name} D16 S1024 (LLAMA_TINY widths)', dtype,
                       2, 1024, 4, 2, 16)
    # The training path's shape: B4 S8192 H16/8 D128 bf16, causal. The
    # plain backward holds several fp32 [B, H, S, S] tensors (17 GB each
    # at B4), so the comparison and its timing run on batch row 0 only.
    dtype = torch.bfloat16
    b, s, h, h_kv, d = 4, 8192, 16, 8, 128
    q, dout = (rand(gen, (b, s, h, d), dtype) for _ in range(2))
    k, v = (rand(gen, (b, s, h_kv, d), dtype) for _ in range(2))
    out, lse = flash_ops._flash_fwd(q, k, v, None)
    row0 = [t[:1].contiguous() for t in (q, k, v, out, dout, lse)]
    dq = flash_ops._flash_bwd_dq(q, k, v, None, out, dout, lse)
    dk, dv = flash_ops._flash_bwd_dkv(q, k, v, None, out, dout, lse)
    torch.cuda.synchronize()
    ref = flash_ops.flash_attention_bwd_plain(*row0)
    label = 'bf16 main-path B4 S8192 H16/8 D128 (row 0 vs plain)'
    errs = {'flash_bwd_dq': compare_blocks(f'bwd {label} dq', dq[:1], ref[0],
                                         dtype),
            'flash_bwd_dkv': max(
                compare_blocks(f'bwd {label} dk', dk[:1], ref[1], dtype),
                compare_blocks(f'bwd {label} dv', dv[:1], ref[2], dtype))}
    # The check must see a fault confined to the later rows, where the
    # gradients are smallest: dK 10 % low past row 4096, and dQ from an
    # LSE 0.1 too high on one 64-row tile (P 10 % low there).
    bad_dk = dk[:1].clone()
    bad_dk[:, s // 2:] *= 0.9
    expect_rejected('dk x 0.9 past row 4096', bad_dk, ref[1], dtype)
    bad_lse = row0[5].clone()
    bad_lse[:, :, 6016:6080] += 0.1
    bad_dq = flash_ops._flash_bwd_dq(*row0[:3], None, *row0[3:5], bad_lse)
    expect_rejected('dq with the LSE + 0.1 on rows 6016-6079', bad_dq,
                    ref[0], dtype)
    del ref, bad_dk, bad_dq
    args = (q, k, v, None, out, dout, lse)
    # Neither kernel has atomics: a second run gives the same bits.
    dk2, dv2 = flash_ops._flash_bwd_dkv(*args)
    dq2 = flash_ops._flash_bwd_dq(*args)
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError('flash_bwd_dkv: two runs on the same inputs '
                             'differ')
    if not torch.equal(dq, dq2):
        raise AssertionError('flash_bwd_dq: two runs on the same inputs '
                             'differ')
    log('  flash_bwd_dkv, flash_bwd_dq: two runs at the training shape '
        'bit-identical')
    del dk2, dv2, dq2
    plain_b1_ms = time_ms(lambda: flash_ops.flash_attention_bwd_plain(
        *row0), iters=2, warmup=1)
    torch.cuda.empty_cache()
    library, backend, _ = sdpa_backward(q, k, v, dout)
    # Kernels and the library in turn, three rounds.
    runs = {'flash_bwd_dq': [], 'flash_bwd_dkv': [], 'library': []}
    for _ in range(3):
        runs['flash_bwd_dq'].append(time_ms(
            lambda: flash_ops._flash_bwd_dq(*args), iters=5, warmup=1))
        runs['flash_bwd_dkv'].append(time_ms(
            lambda: flash_ops._flash_bwd_dkv(*args), iters=5, warmup=1))
        runs['library'].append(time_ms(library, iters=5, warmup=1))
    ms = {name: float(np.mean(t)) for name, t in runs.items()}
    library_ms = ms['library']
    log(f'  backward timings over three rounds (ms): {runs}')
    del library
    records = {}
    for name, (nbytes, flops) in flash_bwd_work(q, k, v, dout, lse).items():
        bound, bound_by = bound_ms(nbytes, flops, dtype)
        log(f'  {name} main-path timing: kernel {ms[name]:.4f} ms, bound '
            f'{bound:.4f} ms ({bound_by}); '
            f'{flops / ms[name] / 1e9:.2f} TFLOP/s')
        records[name] = {
            'name': name, 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/flash_bwd.cu',
            'replaces': REPLACES[name], 'max_abs_err': errs[name],
            'ms': ms[name], 'ms_rounds': runs[name],
            'library_ms_rounds': runs['library'], 'plain_ms': plain_b1_ms,
            'plain_shape': 'B1 (dq, dk and dv together)',
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms,
            'library_call': f'backward of F.scaled_dot_product_attention('
                            f'is_causal=True, enable_gqa=True) ({backend}): '
                            'dq, dk, dv'}
    log(f'  plain backward at B1 (dq, dk, dv together) {plain_b1_ms:.4f} '
        f'ms; SDPA backward ({backend}, B4) {library_ms:.4f} ms')
    gemma = flash_bwd_head_dim_256(gen)
    for name in records:
        records[name]['d256'] = gemma[name]
    mixtral = flash_bwd_mixtral(gen)
    for name in records:
        records[name]['mixtral'] = mixtral[name]
    return records


# Mixtral's training heads ([32]): B2 S4096, 32 query heads over 8 KV
# heads (group 4) of 128, causal, bf16.
MIXTRAL_BWD = dict(b=2, s=4096, h=32, h_kv=8, d=128)


def flash_bwd_mixtral(gen) -> dict:
    """K2 and K3 at Mixtral-8x7B's training shape against the plain
    backward (blockwise), two runs bit-identical, then timed beside their
    bounds, the plain backward (dq, dk and dv together) and SDPA's
    backward (the three in turn over three rounds) → {kernel name: one
    record}."""
    m = MIXTRAL_BWD
    dtype = torch.bfloat16
    label = (f'bf16 Mixtral-8x7B training B{m["b"]} S{m["s"]} '
             f'H{m["h"]}/{m["h_kv"]} D{m["d"]} causal')
    (q, k, v, _, o, dout, lse, _), errs = flash_bwd_case(
        gen, label, dtype, m['b'], m['s'], m['h'], m['h_kv'], m['d'])
    args = (q, k, v, None, o, dout, lse)
    first = flash_ops._flash_bwd(*args)
    if not all(torch.equal(x, y) for x, y in zip(
            first, flash_ops._flash_bwd(*args))):
        raise AssertionError(f'{label}: two backward runs differ')
    del first
    library, backend, _ = sdpa_backward(q, k, v, dout)
    runs = {'flash_bwd_dkv': [], 'flash_bwd_dq': [], 'plain': [],
            'library': []}
    for _ in range(3):
        runs['flash_bwd_dkv'].append(time_ms(
            lambda: flash_ops._flash_bwd_dkv(*args), iters=5, warmup=1))
        runs['flash_bwd_dq'].append(time_ms(
            lambda: flash_ops._flash_bwd_dq(*args), iters=5, warmup=1))
        runs['plain'].append(time_ms(
            lambda: flash_ops.flash_attention_bwd_plain(q, k, v, o, dout,
                                                        lse),
            iters=1, warmup=1))
        runs['library'].append(time_ms(library, iters=5, warmup=1))
    del library
    ms = {name: float(np.mean(t)) for name, t in runs.items()}
    out, line = {}, []
    for name, (nbytes, flops) in flash_bwd_work(q, k, v, dout, lse).items():
        bound, bound_by = bound_ms(nbytes, flops, dtype)
        out[name] = {
            'shape': label, 'max_abs_err': errs[name], 'ms': ms[name],
            'ms_rounds': runs[name], 'plain_ms': ms['plain'],
            'plain_shape': 'dq, dk and dv together',
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': ms['library'],
            'library': f'SDPA backward ({backend}), causal: dq, dk, dv'}
        line.append(f'{name} {ms[name]:.4f} ms (bound {bound:.4f}, '
                    f'{bound_by}; {flops / ms[name] / 1e9:.2f} TFLOP/s)')
    log(f'  {label} timing over three rounds: {", ".join(line)}; plain '
        f'(dq, dk, dv) {ms["plain"]:.4f} ms; SDPA backward ({backend}) '
        f'{ms["library"]:.4f} ms; two runs bit-identical; rounds {runs}')
    del q, k, v, o, dout, lse, args
    release_card()
    return out


# Gemma's head dim in the backward: K2 and K3 at B1 S8192 on each Gemma's
# heads, softcap 50 and scale 1/16 on Gemma-2's with the even layers'
# window of 4096 and without (Gemma-1: neither softcap nor window), in
# bf16 and fp32; first at the tile edges (D256_EDGES: 64-key dK/dV blocks
# and 64-row query tiles, 128-row dQ blocks and 32-key tiles; 32-row
# tiles in fp32).
D256_BWD_WAVES = (
    ('Gemma2-2B H8/4, window 4096', 8, 4, 4096, 50.0),
    ('Gemma2-2B H8/4, no window', 8, 4, None, 50.0),
    ('Gemma2-9B H16/8, window 4096', 16, 8, 4096, 50.0),
    ('Gemma2-9B H16/8, no window', 16, 8, None, 50.0),
    ('Gemma-2B H8/1', 8, 1, None, None),
    ('Gemma-7B H16/16', 16, 16, None, None))


def flash_bwd_work(q, k, v, dout, lse, window=None) -> dict:
    """What K2 and K3 must do at these inputs, for their bounds: each input
    (q, k, v, out, dout, lse) read once and each output written once, and
    four products (S, dP, dV, dK) or three (S, dP, dQ) over the pairs the
    mask keeps → {kernel name: (bytes, operations)}."""
    b, s, h, d = q.shape
    elem = q.element_size()
    inputs = (2 * q.numel() + k.numel() + v.numel() + dout.numel()) * elem \
        + lse.numel() * 4
    product = 2.0 * b * h * d * causal_pairs(s, window)
    return {'flash_bwd_dkv': (inputs + (k.numel() + v.numel()) * elem,
                              4 * product),
            'flash_bwd_dq': (inputs + q.numel() * elem, 3 * product)}


def sdpa_backward(q, k, v, dout):
    """The backward of one causal SDPA call at these shapes (dq, dk and
    dv; no softcap or window, which no one PyTorch call takes): each of
    PyTorch's fused backends that takes them is timed and the fastest
    kept; where none does, its math backend (which holds the S x S
    scores: 2.1 GB a copy in fp32 at B1 H8 S8192) → (a function that runs
    it, backend name, ms). A yardstick only: the port never calls it."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dout_t = dout.transpose(1, 2)
    best = None
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        if backend == SDPBackend.MATH and best is not None:
            break
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter('ignore')   # why a backend declines
                out = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True,
                    scale=q.shape[-1] ** -0.5)
            run = functools.partial(torch.autograd.grad, out, (qt, kt, vt),
                                    dout_t, retain_graph=True)
            ms = time_ms(run, iters=3, warmup=1)
        except RuntimeError:   # this backend does not take these shapes
            if backend == SDPBackend.MATH:
                raise
            continue
        if best is None or ms < best[2]:
            best = (run, backend.name, ms)
        del out, run
    return best


def flash_bwd_head_dim_256(gen) -> dict:
    """K2 and K3 at D 256 against the plain backward: the tile edges in
    bf16 and fp32, then each wave of D256_BWD_WAVES in both, checked and
    timed beside its bound (the pairs its mask keeps), the plain backward
    (dq, dk and dv together) and SDPA's backward → {kernel name: one
    record per wave}."""
    for dtype, name in ((torch.bfloat16, 'bf16'), (torch.float32, 'fp32')):
        for i, (s, groups) in enumerate(D256_EDGES):
            kw = EDGE_VARIANTS[i % len(EDGE_VARIANTS)]
            tag = ' '.join(f'{k}={v}' for k, v in kw.items()) or 'causal'
            flash_bwd_case(gen, f'{name} edge S{s} H8/{8 // groups} D256 '
                           f'{tag}', dtype, 2, s, 8, 8 // groups, 256, **kw)
    out = {'flash_bwd_dkv': [], 'flash_bwd_dq': []}
    b, s, d = 1, 8192, 256
    for dtype, name in ((torch.bfloat16, 'bf16'), (torch.float32, 'fp32')):
        for wave, h, h_kv, window, softcap in D256_BWD_WAVES:
            label = f'{name} B1 S8192 D256 {wave}' + (
                ', softcap 50' if softcap else '')
            (q, k, v, _, o, dout, lse, kw), errs = flash_bwd_case(
                gen, label, dtype, b, s, h, h_kv, d, window=window,
                softcap=softcap, scale=d ** -0.5)
            args = (q, k, v, None, o, dout, lse)
            first = flash_ops._flash_bwd(*args, **kw)
            if not all(torch.equal(x, y) for x, y in zip(
                    first, flash_ops._flash_bwd(*args, **kw))):
                raise AssertionError(f'{label}: two backward runs differ')
            del first
            ms = {'flash_bwd_dkv': time_ms(lambda: flash_ops._flash_bwd_dkv(
                      *args, **kw), iters=3, warmup=1),
                  'flash_bwd_dq': time_ms(lambda: flash_ops._flash_bwd_dq(
                      *args, **kw), iters=3, warmup=1)}
            plain_ms = time_ms(lambda: flash_ops.flash_attention_bwd_plain(
                q, k, v, o, dout, lse, window=window, logit_softcap=softcap,
                scale=d ** -0.5), iters=1, warmup=1)
            library = sdpa_backward(q, k, v, dout)
            backend, library_ms = library[1:]
            del library
            torch.cuda.empty_cache()
            work = flash_bwd_work(q, k, v, dout, lse, window)
            line = []
            for kname, (nbytes, flops) in work.items():
                bound, bound_by = bound_ms(nbytes, flops, dtype)
                out[kname].append({
                    'shape': label, 'max_abs_err': errs[kname],
                    'ms': ms[kname], 'plain_ms': plain_ms,
                    'plain_shape': 'dq, dk and dv together',
                    'bound_ms': bound, 'bound_by': bound_by,
                    'library_ms': library_ms,
                    'library': f'SDPA backward ({backend}), causal, without '
                               'softcap and window: dq, dk, dv'})
                line.append(f'{kname} {ms[kname]:.4f} ms (bound {bound:.4f},'
                            f' {bound_by}; {flops / ms[kname] / 1e9:.2f} '
                            'TFLOP/s)')
            log(f'  {label} timing: {", ".join(line)}; plain (dq, dk, dv) '
                f'{plain_ms:.4f} ms; SDPA backward ({backend}, causal, no '
                f'softcap or window) {library_ms:.4f} ms; two runs '
                'bit-identical')
            del q, k, v, o, dout, lse, args
            torch.cuda.empty_cache()
    return out


def decode_case(gen, label, q_dtype, kv_dtype, lengths, b=16, max_len=2048,
                h=32, h_kv=8, d=128, window=None, softcap=None,
                scale=None):
    from skypilot_tpu_torch.models import llama
    q = rand(gen, (b, 1, h, d), q_dtype)
    k = rand(gen, (b, max_len, h_kv, d), torch.float32)
    v = rand(gen, (b, max_len, h_kv, d), torch.float32)
    if kv_dtype == torch.int8:
        k, v = llama.quantize_kv(k), llama.quantize_kv(v)
    else:
        k, v = k.to(kv_dtype), v.to(kv_dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    kw = dict(window=window, logit_softcap=softcap, scale=scale)
    out = decode_ops.decode_attention(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    ref = decode_ops.decode_attention_plain(q, k, v, lens, **kw)
    err = compare(f'decode {label}', out, ref, q_dtype)
    # Also per (slot, head) against the reference's own size there: an
    # output averaged over ~1000 rows is small, and one absolute tolerance
    # would pass a lost split (the planted fault in check_decode).
    compare_blocks(f'decode {label}', out, ref, q_dtype, block_rows=1)
    empty = [i for i, n in enumerate(lengths) if n == 0]
    if empty:
        # The JAX kernel's answer for a length-0 slot: the mean of its
        # first min(256, max_len) V rows, dequantized.
        v_rows = v[0].float() * v[1] if kv_dtype == torch.int8 else v.float()
        mean = v_rows[empty, :min(decode_ops.EMPTY_SLOT_ROWS, max_len)].mean(
            dim=1).repeat_interleave(h // h_kv, dim=1)[:, None]
        compare(f'decode {label}, length-0 slots vs mean of first rows',
                out[empty], mean, q_dtype)
    return (q, k, v, lens, kw), err


def without_split(q, k, v, lens, slot: int, split: int) -> torch.Tensor:
    """What a combine that lost one split's partial state gives for one
    slot of a bf16 cache: the plain attention over the slot's live rows
    less the split's SPLIT_ROWS rows → [1, H, D]."""
    _, _, h, d = q.shape
    h_kv = k.shape[2]
    rows = decode_ops.SPLIT_ROWS
    keep = torch.arange(k.shape[1], device='cuda') < int(lens[slot])
    keep[split * rows:(split + 1) * rows] = False
    qg = q[slot, 0].float().reshape(h_kv, h // h_kv, d)
    s = torch.einsum('hgd,khd->hgk', qg, k[slot].float()) * d ** -0.5
    p = torch.softmax(s.masked_fill(~keep, -torch.inf), dim=-1)
    out = torch.einsum('hgk,khd->hgd', p, v[slot].float())
    return out.reshape(1, h, d).to(q.dtype)


def check_decode(gen) -> dict:
    log('[3] decode_attention: kernel vs plain version')
    ragged = [0, 1, 255, 256, 257, 2048, 2100, 7, 1000, 1500, 31, 64,
              513, 777, 1999, 128]
    # The split-KV walk's edges (splits of SPLIT_ROWS = 128 rows): one
    # split exactly and one split +- 1, two splits +- 1, max_len and one
    # past it, length 0 twice; under window=100 most of these start their
    # window inside a split.
    edges = [128, 127, 129, 0, 256, 255, 257, 2048, 2049, 0, 1, 384, 130,
             2047, 1100, 1025]
    bf16, fp32 = torch.bfloat16, torch.float32
    decode_case(gen, 'bf16 cache, ragged lengths', bf16, bf16, ragged)
    decode_case(gen, 'fp32 cache, ragged lengths', fp32, fp32, ragged)
    decode_case(gen, 'fp32 q over bf16 cache', fp32, bf16, ragged)
    decode_case(gen, 'int8 pair (bf16 q)', bf16, torch.int8, ragged)
    decode_case(gen, 'int8 pair (fp32 q)', fp32, torch.int8, ragged)
    decode_case(gen, 'bf16 window=300', bf16, bf16, ragged, window=300)
    decode_case(gen, 'bf16 softcap=30 scale=0.1', bf16, bf16, ragged,
                softcap=30.0, scale=0.1)
    decode_case(gen, 'fp32 D16 G2 (LLAMA_TINY widths)', fp32, fp32,
                [0, 1, 15, 16, 17, 1040], b=6, max_len=1040, h=4,
                h_kv=2, d=16)
    decode_case(gen, 'bf16 cache, split edges', bf16, bf16, edges)
    decode_case(gen, 'bf16 window=100, split edges', bf16, bf16, edges,
                window=100)
    decode_case(gen, 'int8 pair (bf16 q), split edges', bf16, torch.int8,
                edges)
    decode_case(gen, 'int8 pair window=100, split edges', bf16, torch.int8,
                edges, window=100)
    decode_case(gen, 'fp32 cache, split edges', fp32, fp32, edges)
    decode_case(gen, 'fp32 cache window=100, split edges', fp32, fp32,
                edges, window=100)
    decode_case(gen, 'fp32 D16 G2, split edges', fp32, fp32,
                [0, 127, 128, 129, 1040, 256], b=6, max_len=1040, h=4,
                h_kv=2, d=16)
    decode_case(gen, 'fp32 D16 G2 window=100, split edges', fp32, fp32,
                [0, 127, 128, 129, 1040, 257], b=6, max_len=1040, h=4,
                h_kv=2, d=16, window=100)
    # The main path's decode steps: 16 slots holding ~1000-token
    # prompts plus up to 64 generated tokens.
    rng = np.random.default_rng(1)
    lengths = [int(x) for x in rng.integers(990, 1065, 16)]
    cases = [decode_case(gen, 'bf16 main-path lengths', bf16, bf16,
                         lengths) for _ in range(4)]
    (_, _, _, lens, kw), err = cases[0]
    # The check must see one split's partial state lost (slot 3, rows
    # 128-255): the whole output of the case, that slot recomputed without
    # them.
    q, k, v, _, _ = cases[0][0]
    out = decode_ops.decode_attention(q, k, v, lens)
    ref = decode_ops.decode_attention_plain(q, k, v, lens)
    bad = out.clone()
    bad[3] = without_split(q, k, v, lens, 3, 1)
    loose = (bad.float() - ref.float()).abs() <= (
        ATOL[bf16] + RTOL[bf16] * ref.float().abs())
    log(f'  planted fault, slot 3 without split 1: the absolute check alone '
        f'would {"pass" if bool(loose.all()) else "reject"} it')
    expect_rejected('decode slot 3 without split 1', bad, ref, bf16,
                    block_rows=1)
    del out, ref, bad, loose
    times = decode_timings('main-path', cases)
    del cases
    gqa7 = decode_group7(gen)
    gemma = decode_head_dim_256(gen)
    return {'name': 'decode_attention', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/decode_attention.cu',
            'replaces': REPLACES['decode_attention'], 'max_abs_err': err,
            **times, **gqa7, 'd256': gemma}


def decode_timings(label, cases) -> dict:
    """Kernel and masked-SDPA (library) device times over three rounds in
    turn, the plain version's, the bound and the wrapper's host time, for
    decode cases of one shape and one set of options, launched in turn.
    The library call masks what the kernel's window masks and scales as
    it does, without its softcap (SDPA takes none); over an int8 cache
    there is no one library call (library_ms None)."""
    # Rotate over the caches (4 x 134 MB at 16 slots x 2048 rows) so that
    # no launch finds its K/V in the 50 MB L2, as each layer's cache is
    # cold on the path.
    it = itertools.count()

    def case():
        return cases[next(it) % len(cases)][0]

    def run_kernel():
        q, k, v, ln, kw = case()
        decode_ops.decode_attention(q, k, v, ln, **kw)

    def run_plain():
        q, k, v, ln, kw = case()
        decode_ops.decode_attention_plain(q, k, v, ln, **kw)

    def run_library():
        q, k, v, ln, kw = case()
        pos = torch.arange(k.shape[1], device='cuda')[None, :]
        length = ln[:, None].long()
        mask = pos < length
        if kw['window'] is not None:
            mask &= pos >= length - kw['window']
        F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :], enable_gqa=True,
            scale=kw['scale'])

    q, k, _, lens, kw = cases[0][0]
    quantized = isinstance(k, tuple)
    # Kernel and library in turn, three rounds.
    rounds = {'kernel': [], 'library': []}
    for _ in range(3):
        rounds['kernel'].append(time_ms(run_kernel, iters=40, warmup=4))
        if not quantized:
            rounds['library'].append(time_ms(run_library, iters=20,
                                             warmup=4))
    ms = float(np.mean(rounds['kernel']))
    library_ms = None if quantized else float(np.mean(rounds['library']))
    plain_ms = time_ms(run_plain, iters=8, warmup=2)
    wrapper_ms = host_ms(run_kernel)
    log(f'  decode {label} timings over three rounds (ms): {rounds}; '
        f'wrapper host time {wrapper_ms:.4f} ms a call')
    b, _, h, d = q.shape
    values = k[0] if quantized else k
    h_kv, max_len = values.shape[2], values.shape[1]
    length = lens.clamp(0, max_len)
    first = (length - kw['window']).clamp(min=0) if kw['window'] else 0
    live = int((length - first).sum())
    row_bytes = h_kv * (d * values.element_size() + (4 if quantized else 0))
    nbytes = 2 * q.numel() * q.element_size() + 4 * b + 2 * live * row_bytes
    flops = 4.0 * live * h * d
    bound, bound_by = bound_ms(nbytes, flops, torch.bfloat16)
    library = ('none (int8 cache)' if quantized else
               f'masked SDPA{" (no softcap)" if kw["logit_softcap"] else ""}')
    log(f'  decode {label} timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, {library} (library) {library_ms} ms, '
        f'bound {bound:.4f} ms ({bound_by}); '
        f'{nbytes / ms / 1e6:.1f} GB/s of live KV')
    return {'ms': ms, 'ms_rounds': rounds['kernel'], 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms,
            'library_ms_rounds': rounds['library'], 'host_ms': wrapper_ms}


# Gemma's decode step at D 256: 8 slots over an 8192-row cache (phase
# [26]'s replica), lengths 4500-8100 under the even layers' window of
# 4096 with softcap 50 and scale 1/16; Gemma2-9B's heads (16 over 8) over
# bf16, fp32 and int8 caches, and Gemma-7B's (16 over 16, group 1) and
# Gemma-2B's (8 over 1, group 8) over bf16.
D256_DECODE = (('bf16 cache', torch.bfloat16, torch.bfloat16, 16, 8),
               ('fp32 cache', torch.float32, torch.float32, 16, 8),
               ('int8 pair (bf16 q)', torch.bfloat16, torch.int8, 16, 8),
               ('bf16 cache, group 1 (Gemma-7B heads)', torch.bfloat16,
                torch.bfloat16, 16, 16),
               ('bf16 cache, group 8 (Gemma-2B heads)', torch.bfloat16,
                torch.bfloat16, 8, 1))


def decode_head_dim_256(gen) -> list:
    """K4 at D 256 against its plain version, each case of D256_DECODE
    over two caches, then timed beside its bound → one record each."""
    rng = np.random.default_rng(26)
    lengths = [int(x) for x in rng.integers(4500, 8101, 8)]
    out = []
    for label, q_dtype, kv_dtype, h, h_kv in D256_DECODE:
        full = f'{label} 8 slots x 8192 H{h}/{h_kv} D256 window 4096'
        cases = [decode_case(gen, full, q_dtype, kv_dtype, lengths, b=8,
                             max_len=8192, h=h, h_kv=h_kv, d=256,
                             window=4096, softcap=50.0, scale=1 / 16)
                 for _ in range(2)]
        times = decode_timings(full, cases)
        out.append({'shape': full, 'lengths': lengths,
                    'max_abs_err': max(err for _, err in cases), **times})
        del cases
        torch.cuda.empty_cache()
    return out


def decode_group7(gen) -> dict:
    """Qwen2-7B's decode step: 16 slots over a 2048-row cache, 28 query
    heads over 4 KV heads (a GQA group of 7, which the walk for groups of
    up to 8 takes with one idle head), ragged lengths around 1000 and one
    empty slot, in bf16 and fp32 against the plain version; the bf16 case
    timed → the record's gqa7_* entries."""
    rng = np.random.default_rng(7)
    lengths = [0] + [int(x) for x in rng.integers(990, 1060, 15)]
    shape = dict(h=28, h_kv=4, d=128)
    errs = [decode_case(gen, 'fp32 cache, GQA group 7 (H28/4 D128)',
                        torch.float32, torch.float32, lengths, **shape)[1]]
    cases = [decode_case(gen, 'bf16 cache, GQA group 7 (H28/4 D128)',
                         torch.bfloat16, torch.bfloat16, lengths, **shape)
             for _ in range(4)]
    errs += [err for _, err in cases]
    times = decode_timings('GQA group 7', cases)
    return {'gqa7_shape': 'B16 K2048 H28/4 D128, lengths 0 and 990-1059',
            'gqa7_max_abs_err': max(errs),
            **{f'gqa7_{key}': value for key, value in times.items()}}


def paged_case(gen, label, q_dtype, kv_dtype, lengths, allocated=None,
               num_pages=2048, page=16, nblk=256, h=32, h_kv=8, d=128,
               softcap=None, scale=None, check=True):
    """K5 vs its plain version. Each slot's table row is its own random
    permutation of the arena's pages, so no slot's pages are contiguous;
    entries past a slot's allocation (by default what its length needs)
    hold the sentinel (== num_pages)."""
    b = len(lengths)
    q = rand(gen, (b, 1, h, d), q_dtype)
    k = rand(gen, (num_pages, page, h_kv, d), kv_dtype)
    v = rand(gen, (num_pages, page, h_kv, d), kv_dtype)
    perm = torch.stack([torch.randperm(num_pages, generator=gen,
                                       device='cuda')[:nblk]
                        for _ in range(b)])
    blocks = torch.tensor([-(-min(n, nblk * page) // page) for n in
                           (lengths if allocated is None else allocated)],
                          device='cuda')
    held = torch.arange(nblk, device='cuda')[None, :] < blocks[:, None]
    tables = torch.where(held, perm, num_pages).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    kw = dict(logit_softcap=softcap, scale=scale)
    err = None
    if check:
        out = decode_ops.paged_decode_attention(q, k, v, lens, tables, **kw)
        torch.cuda.synchronize()
        ref = decode_ops.paged_decode_attention_plain(q, k, v, lens, tables,
                                                      **kw)
        err = compare(f'paged decode {label}', out, ref, q_dtype)
        empty = [i for i, n in enumerate(lengths) if n == 0]
        if empty:
            # The JAX kernel's answer for a length-0 slot: the mean of
            # the `page` V rows of its first clamped page.
            first = tables[empty, 0].long().clamp(0, num_pages - 1)
            mean = v[first].float().mean(dim=1).repeat_interleave(
                h // h_kv, dim=1)[:, None]
            compare(f'paged decode {label}, length-0 slots vs mean of '
                    'their first page', out[empty], mean, q_dtype)
    return (q, k, v, lens, tables, kw), err


def check_paged_decode(gen) -> dict:
    log('[3] paged_decode_attention: kernel vs plain version')
    bf16, fp32 = torch.bfloat16, torch.float32
    cap = 256 * 16
    # Ragged lengths around page edges; slot 3 has length 0 and an
    # allocated first block, slot 4 length 0 and an all-sentinel row, slot
    # 5 is inactive (length past the table, all-sentinel row); the others
    # end in sentinel tails.
    ragged = [1, 16, 17, 0, 0, cap + 1, cap, 1000, 3064, 255, 256, 257]
    held = [1, 16, 17, 16, 0, 0, cap, 1000, 3064, 255, 256, 257]
    paged_case(gen, 'bf16 arena, ragged lengths', bf16, bf16, ragged, held)
    paged_case(gen, 'fp32 arena, ragged lengths', fp32, fp32, ragged, held)
    paged_case(gen, 'fp32 q over bf16 arena', fp32, bf16, ragged, held)
    paged_case(gen, 'bf16 softcap=30 scale=0.1', bf16, bf16, ragged, held,
               softcap=30.0, scale=0.1)
    paged_case(gen, 'fp32 page 8, D16 G2 (LLAMA_TINY widths)', fp32, fp32,
               [0, 1, 8, 9, 65, 64, 30], [8, 1, 8, 9, 0, 64, 30],
               num_pages=40, page=8, nblk=8, h=4, h_kv=2, d=16)
    paged_case(gen, 'bf16 page 256, D64 G8', bf16, bf16, [0, 300, 1025, 256],
               [256, 300, 1025, 256], num_pages=24, page=256, nblk=5, h=8,
               h_kv=1, d=64)
    paged_case(gen, 'bf16 page 8, 8192-block table rows', bf16, bf16,
               [65536, 12345, 3], num_pages=8192, page=8, nblk=8192, h=4,
               h_kv=2, d=64)
    # D 256 through K4's walk (Gemma's width; Gemma has no paged engine).
    d256 = max(paged_case(
        gen, f'{name} page 16, H16/8 D256 softcap=50 scale=1/16', dtype,
        dtype, [0, 1, 17, 300, 4000, 1000], [16, 1, 17, 300, 4000, 1000],
        num_pages=1024, page=16, nblk=256, h=16, h_kv=8, d=256,
        softcap=50.0, scale=1 / 16)[1]
        for name, dtype in (('bf16', bf16), ('fp32', fp32)))
    # On a contiguous identity table K5 walks the same rows in the same
    # order as K4 (they share one row walk, csrc/decode_common.cuh), so
    # live slots must agree bit for bit.
    for dtype in (bf16, fp32):
        b, page, nblk, h, h_kv, d = 16, 16, 128, 32, 8, 128
        q = rand(gen, (b, 1, h, d), dtype)
        k = rand(gen, (b, nblk * page, h_kv, d), dtype)
        v = rand(gen, (b, nblk * page, h_kv, d), dtype)
        lens = torch.randint(1, nblk * page + 1, (b,), generator=gen,
                             device='cuda', dtype=torch.int32)
        tables = torch.arange(b * nblk, dtype=torch.int32,
                              device='cuda').reshape(b, nblk)
        dense = decode_ops.decode_attention(q, k, v, lens)
        paged = decode_ops.paged_decode_attention(
            q, k.reshape(b * nblk, page, h_kv, d),
            v.reshape(b * nblk, page, h_kv, d), lens, tables)
        torch.cuda.synchronize()
        if not torch.equal(dense, paged):
            raise AssertionError(
                'paged decode on an identity table differs from dense '
                f'decode ({dtype}): max_abs_err '
                f'{float((dense.float() - paged.float()).abs().max()):.3e}')
        log(f'  paged decode on an identity table == dense decode, bit for '
            f'bit ({dtype})')
    # The paged main path's decode steps: 32 slots over 2048 pages of 16
    # rows, ~1000-token prompts plus up to 64 generated tokens, a few
    # slots near a 3000-token prompt's end.
    rng = np.random.default_rng(2)
    lengths = [int(x) for x in rng.integers(990, 1101, 32)]
    lengths[5], lengths[17], lengths[30] = 3064, 3001, 3050
    cases = [paged_case(gen, 'bf16 main-path lengths', bf16, bf16, lengths,
                        check=i == 0) for i in range(2)]
    (q, k, v, lens, tables, _), err = cases[0]
    # Two arenas (2 x 134 MB) in turn: each launch reads more live K/V
    # than the 50 MB L2 holds, and never the arena it read last.
    it = itertools.count()

    def run_kernel():
        q, k, v, ln, tb, _ = cases[next(it) % 2][0]
        decode_ops.paged_decode_attention(q, k, v, ln, tb)

    def run_plain():
        q, k, v, ln, tb, _ = cases[next(it) % 2][0]
        decode_ops.paged_decode_attention_plain(q, k, v, ln, tb)

    def run_library():
        # The nearest library route: gather each slot's pages into a
        # dense [B, K, Hkv, D] view, then masked SDPA.
        q, k, v, ln, tb, _ = cases[next(it) % 2][0]
        safe = tb.long().clamp(0, k.shape[0] - 1)
        b = q.shape[0]
        kd = k[safe].reshape(b, -1, *k.shape[2:])
        vd = v[safe].reshape(b, -1, *v.shape[2:])
        pos = torch.arange(kd.shape[1], device='cuda')[None, :]
        mask = (pos < ln[:, None].long())[:, None, None, :]
        F.scaled_dot_product_attention(
            q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    ms = time_ms(run_kernel, iters=40, warmup=4)
    plain_ms = time_ms(run_plain, iters=8, warmup=2)
    library_ms = time_ms(run_library, iters=20, warmup=4)
    # One block walks one slot's rows, so the three long slots set the
    # time above; the same arenas with every slot near 1000 rows, as in
    # phase [8](a), for comparison with the dense kernel's timing.
    even = torch.tensor([min(n, 1100) for n in lengths], dtype=torch.int32,
                        device='cuda')

    def run_even():
        q, k, v, _, tb, _ = cases[next(it) % 2][0]
        decode_ops.paged_decode_attention(q, k, v, even, tb)

    even_ms = time_ms(run_even, iters=40, warmup=4)
    b, _, h, d = q.shape
    page, h_kv = k.shape[1], k.shape[2]
    live = int(lens.clamp(max=tables.shape[1] * page).sum())
    nbytes = (2 * q.numel() * q.element_size() + 4 * b +
              tables.numel() * 4 + 2 * live * h_kv * d * k.element_size())
    flops = 4.0 * live * h * d
    bound, bound_by = bound_ms(nbytes, flops, bf16)
    log(f'  paged decode main-path timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, page gather + masked SDPA (library) '
        f'{library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); '
        f'{nbytes / ms / 1e6:.1f} GB/s of live KV ({live} live rows); '
        f'with every slot at most 1100 rows ({int(even.sum())} live rows) '
        f'kernel {even_ms:.4f} ms')
    return {'name': 'paged_decode_attention', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_decode_attention.cu',
            'replaces': REPLACES['paged_decode_attention'],
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms, 'ms_at_most_1100_rows': even_ms,
            'd256_max_abs_err': d256}


# ---- phase 3: the MLA decode kernels (K6 dense, K7 paged) ----

# DeepSeek-V2-Lite's MLA widths: 16 heads, latent rank 512, RoPE key 64;
# the absorbed step's scale is (qk_nope + qk_rope) ** -0.5.
MLA_H, MLA_R, MLA_DR = 16, 512, 64
MLA_SCALE = 192 ** -0.5
# bf16 terms of each fp32 operand that is not from the cache (q and p) in
# the kernels' tensor-core walk over a bf16 cache.
MLA_TERMS = 3


def mla_inputs(gen, b, h=MLA_H, r=MLA_R, dr=MLA_DR):
    return rand(gen, (b, h, r), torch.float32), rand(gen, (b, h, dr),
                                                     torch.float32)


def mla_case(gen, label, kv_dtype, lengths, max_len=2048, h=MLA_H,
             r=MLA_R, dr=MLA_DR, check=True):
    """K6 vs its plain version. Both compute in fp32 and differ only by
    summation order (over a bf16 cache the kernel's three-term products
    are the fp32 products), so the fp32 tolerance holds for a bf16 cache
    too."""
    b = len(lengths)
    q_eff, q_rope = mla_inputs(gen, b, h, r, dr)
    ckv = rand(gen, (b, max_len, r), kv_dtype)
    krope = rand(gen, (b, max_len, dr), kv_dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    err = None
    if check:
        out = mla_ops.mla_decode_attention(q_eff, q_rope, ckv, krope, lens,
                                           MLA_SCALE)
        torch.cuda.synchronize()
        ref = mla_ops.mla_decode_attention_plain(q_eff, q_rope, ckv, krope,
                                                 lens, MLA_SCALE)
        err = compare(f'mla decode {label}', out, ref, torch.float32)
        empty = [i for i, n in enumerate(lengths) if n == 0]
        if empty:
            # The JAX kernel's answer for a length-0 slot: the mean of its
            # first min(256, K) c_kv rows.
            mean = ckv[empty, :min(mla_ops.DEFAULT_BLOCK_KV, max_len)].float(
            ).mean(dim=1)[:, None].expand(len(empty), h, r)
            compare(f'mla decode {label}, length-0 slots vs mean of first '
                    'rows', out[empty], mean, torch.float32)
    return (q_eff, q_rope, ckv, krope, lens), err


def mla_bound(q_eff, q_rope, live, elem, extra_bytes=0):
    """(bound ms, what bounds it, bytes, products): each input read once
    (queries fp32, the live cache rows in the cache's type), the fp32
    output written once; the products at the bf16 tensor-core peak,
    counted MLA_TERMS times: over a bf16 cache the kernels keep the math
    fp32 by splitting q and p into three bf16 terms
    (csrc/mla_common.cuh), so each fp32 product costs three bf16 ones."""
    b, h, r = q_eff.shape
    dr = q_rope.shape[-1]
    nbytes = ((q_eff.numel() + q_rope.numel() + b * h * r) * 4 + 4 * b +
              live * (r + dr) * elem + extra_bytes)
    flops = 2.0 * live * h * ((r + dr) + r) * MLA_TERMS
    return bound_ms(nbytes, flops, torch.bfloat16) + (nbytes, flops)


def mla_faulty(q_eff, q_rope, ckv, krope, lens, slot, drop_split=None,
               p_terms=MLA_TERMS):
    """One slot's output [H, r] over its live rows as a faulty kernel
    would give it: without the rows of split `drop_split` (a partial lost
    in the merge), or with each probability cut to its first `p_terms`
    bf16 terms (the kernel's split of p)."""
    keep = torch.arange(int(lens[slot]), device='cuda')
    if drop_split is not None:
        keep = keep[keep // mla_ops.SPLIT_ROWS != drop_split]
    c, k = ckv[slot, keep].float(), krope[slot, keep].float()
    s = (q_eff[slot] @ c.T + q_rope[slot] @ k.T) * MLA_SCALE
    e = torch.exp(s - s.max(dim=1, keepdim=True).values)
    p = sum(t.float() for t in mla_ops.bf16_terms(e, p_terms))
    return (p @ c) / e.sum(dim=1, keepdim=True)


def mla_planted_faults(name, out, ref, dense, slot) -> None:
    """The unchanged fp32 comparison must reject `slot` without its split
    1; p without its lo term is rejected, or the log says by how much it
    stays inside the tolerance."""
    bad = out.clone()
    bad[slot] = mla_faulty(*dense, slot, drop_split=1)
    try:
        compare(f'planted fault, {name} slot {slot} without split 1', bad,
                ref, torch.float32)
    except AssertionError:
        log('    rejected, as it must be')
    else:
        raise AssertionError(f'the {name} check passed a slot without one '
                             'split')
    lens = dense[-1]
    two = torch.stack([mla_faulty(*dense, i, p_terms=MLA_TERMS - 1)
                       if int(lens[i]) else ref[i]
                       for i in range(len(lens))])
    err = float((two - ref).abs().max())
    atol = ATOL[torch.float32]
    if err > atol:
        log(f'  planted fault, {name} without p\'s lo term: max_abs_err '
            f'{err:.3e}, rejected')
    else:
        log(f'  planted fault, {name} without p\'s lo term: max_abs_err '
            f'{err:.3e}, inside the fp32 tolerance {atol:g} by '
            f'{atol / err:.1f}x: the comparison cannot see it')


def mla_repeat(name, fn) -> None:
    """Two calls on the same inputs give the same bits: the combine merges
    a slot's splits in split order, whichever split ended last."""
    first, again = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError(f'{name}: two calls on the same inputs differ')
    log(f'  {name}: two calls on the same inputs, bit for bit equal')


def check_mla_decode(gen) -> dict:
    log('[3] mla_decode (K6): kernel vs plain version')
    bf16, fp32 = torch.bfloat16, torch.float32
    max_len = 2048
    ragged = [1, 255, 256, 257, max_len, 0, max_len + 1, 1000]
    errs = [mla_case(gen, f'{name} cache, lengths 1/255/256/257/K, length '
                     '0, inactive K+1', dtype, ragged)[1]
            for dtype, name in ((bf16, 'bf16'), (fp32, 'fp32'))]
    tiny = [0, 1, 31, 33, 127, 129, 300]
    errs += [mla_case(gen, f'{name} cache, DEEPSEEK_TINY widths (4 of 16 '
                      'heads, 40 of 48 columns)', dtype, tiny, max_len=300,
                      h=4, r=32, dr=8)[1]
             for dtype, name in ((bf16, 'bf16'), (fp32, 'fp32'))]
    errs.append(mla_case(gen, 'bf16 cache, r + dr = 1024 (a one-stage ring)',
                         bf16, [0, 1, 129, 1000, max_len], dr=512)[1])
    rng = np.random.default_rng(10)
    lengths = [int(x) for x in rng.integers(990, 1065, 16)]
    errs.append(mla_case(gen, 'fp32 main-path lengths', fp32, lengths)[1])
    # The main path's decode steps: 16 slots, bf16 cache. Four caches in
    # turn (4 x 38 MB): no launch finds its rows in the 50 MB L2.
    cases = [mla_case(gen, 'bf16 main-path lengths', bf16, lengths,
                      check=i == 0) for i in range(4)]
    err = cases[0][1]
    errs.append(err)
    log(f'  largest mla decode error over these {len(errs)} cases: '
        f'{max(errs):.3e} (fp32 tolerance {ATOL[fp32]:g})')
    dense = cases[0][0]
    out = mla_ops.mla_decode_attention(*dense, MLA_SCALE)
    ref = mla_ops.mla_decode_attention_plain(*dense, MLA_SCALE)
    mla_planted_faults('mla decode', out, ref, dense, slot=3)
    mla_repeat('mla decode (bf16, main-path lengths)',
               lambda: mla_ops.mla_decode_attention(*dense, MLA_SCALE))
    del out, ref
    # The library yardstick's inputs, prepared outside the timed region:
    # [q_eff | q_rope] in the cache's type against one KV head
    # [c_kv | k_rope], value c_kv, a length mask.
    lib = []
    for (q_eff, q_rope, ckv, krope, lens), _ in cases:
        q = torch.cat([q_eff, q_rope], -1).to(bf16)[:, :, None]
        k = torch.cat([ckv, krope], -1)[:, None]
        pos = torch.arange(max_len, device='cuda')[None, :]
        mask = (pos < lens[:, None].long())[:, None, None, :]
        lib.append((q, k, ckv[:, None], mask))
    it = itertools.count()

    def run_kernel():
        mla_ops.mla_decode_attention(*cases[next(it) % 4][0], MLA_SCALE)

    def run_plain():
        mla_ops.mla_decode_attention_plain(*cases[next(it) % 4][0],
                                           MLA_SCALE)

    def run_library():
        q, k, v, mask = lib[next(it) % 4]
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                       scale=MLA_SCALE, enable_gqa=True)

    ms = time_ms(run_kernel, iters=40, warmup=4)
    plain_ms = time_ms(run_plain, iters=8, warmup=2)
    library_ms = time_ms(run_library, iters=20, warmup=4)
    q_eff, q_rope, ckv, _, lens = cases[0][0]
    live = int(lens.clamp(max=max_len).sum())
    bound, bound_by, nbytes, flops = mla_bound(q_eff, q_rope, live,
                                               ckv.element_size())
    log(f'  mla decode main-path timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, masked SDPA (library) {library_ms:.4f} ms, '
        f'bound {bound:.4f} ms ({bound_by}; bf16 cache bytes, products x'
        f'{MLA_TERMS} at the bf16 peak); {live} live rows, '
        f'{nbytes / ms / 1e6:.1f} GB/s, {flops / ms / 1e9:.2f} TFLOP/s bf16')
    return {'name': 'mla_decode', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/mla_decode.cu',
            'replaces': REPLACES['mla_decode'], 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': bound_by, 'library_ms': library_ms}


def paged_mla_case(gen, label, kv_dtype, lengths, allocated=None,
                   num_pages=2048, page=16, nblk=256, h=MLA_H, r=MLA_R,
                   dr=MLA_DR, check=True):
    """K7 vs its plain version: each slot's table row its own random
    permutation of the arena's pages, sentinel (== num_pages) past its
    allocation (by default what its length needs)."""
    b = len(lengths)
    q_eff, q_rope = mla_inputs(gen, b, h, r, dr)
    ckv = rand(gen, (num_pages, page, r), kv_dtype)
    krope = rand(gen, (num_pages, page, dr), kv_dtype)
    perm = torch.stack([torch.randperm(num_pages, generator=gen,
                                       device='cuda')[:nblk]
                        for _ in range(b)])
    blocks = torch.tensor([-(-min(n, nblk * page) // page) for n in
                           (lengths if allocated is None else allocated)],
                          device='cuda')
    held = torch.arange(nblk, device='cuda')[None, :] < blocks[:, None]
    tables = torch.where(held, perm, num_pages).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    err = None
    if check:
        out = mla_ops.paged_mla_decode_attention(q_eff, q_rope, ckv, krope,
                                                 lens, tables, MLA_SCALE)
        torch.cuda.synchronize()
        ref = mla_ops.paged_mla_decode_attention_plain(
            q_eff, q_rope, ckv, krope, lens, tables, MLA_SCALE)
        err = compare(f'paged mla decode {label}', out, ref, torch.float32)
        empty = [i for i, n in enumerate(lengths) if n == 0]
        if empty:
            first = tables[empty, 0].long().clamp(0, num_pages - 1)
            mean = ckv[first].float().mean(dim=1)[:, None].expand(
                len(empty), h, r)
            compare(f'paged mla decode {label}, length-0 slots vs mean of '
                    'their first page', out[empty], mean, torch.float32)
    return (q_eff, q_rope, ckv, krope, lens, tables), err


def check_paged_mla_decode(gen) -> dict:
    log('[3] paged_mla_decode (K7): kernel vs plain version')
    bf16, fp32 = torch.bfloat16, torch.float32
    cap = 256 * 16
    # Slot 3: length 0 with an allocated first block; slot 4: length 0,
    # all-sentinel row; slot 5: inactive (length past the table,
    # all-sentinel row); the others end in sentinel tails.
    ragged = [1, 16, 17, 0, 0, cap + 1, cap, 1000, 3064, 255, 256, 257]
    held = [1, 16, 17, 16, 0, 0, cap, 1000, 3064, 255, 256, 257]
    errs = [paged_mla_case(gen, f'{name} arena, ragged lengths', dtype,
                           ragged, held)[1]
            for dtype, name in ((bf16, 'bf16'), (fp32, 'fp32'))]
    errs += [paged_mla_case(gen, f'{name} page 8, DEEPSEEK_TINY widths',
                            dtype, [0, 1, 8, 9, 65, 64, 30],
                            [8, 1, 8, 9, 0, 64, 30], num_pages=40, page=8,
                            nblk=8, h=4, r=32, dr=8)[1]
             for dtype, name in ((bf16, 'bf16'), (fp32, 'fp32'))]
    # Pages of one row and of 256 rows (one bulk copy a row either way).
    errs.append(paged_mla_case(gen, 'bf16 page 1', bf16, [0, 1, 2, 129, 640],
                               [1, 1, 2, 129, 640], num_pages=4096, page=1,
                               nblk=640)[1])
    errs.append(paged_mla_case(gen, 'bf16 page 256', bf16, [0, 300, 1025, 256],
                               [256, 300, 1025, 256], num_pages=24, page=256,
                               nblk=5)[1])
    # On a contiguous identity table K7 walks the same rows in the same
    # order as K6 (one shared split walk, csrc/mla_common.cuh).
    for dtype in (bf16, fp32):
        b, page, nblk = 16, 16, 128
        q_eff, q_rope = mla_inputs(gen, b)
        ckv = rand(gen, (b, nblk * page, MLA_R), dtype)
        krope = rand(gen, (b, nblk * page, MLA_DR), dtype)
        lens = torch.randint(1, nblk * page + 1, (b,), generator=gen,
                             device='cuda', dtype=torch.int32)
        tables = torch.arange(b * nblk, dtype=torch.int32,
                              device='cuda').reshape(b, nblk)
        dense = mla_ops.mla_decode_attention(q_eff, q_rope, ckv, krope, lens,
                                             MLA_SCALE)
        paged = mla_ops.paged_mla_decode_attention(
            q_eff, q_rope, ckv.reshape(-1, page, MLA_R),
            krope.reshape(-1, page, MLA_DR), lens, tables, MLA_SCALE)
        torch.cuda.synchronize()
        if not torch.equal(dense, paged):
            raise AssertionError(
                'paged mla decode on an identity table differs from dense '
                f'({dtype}): max_abs_err '
                f'{float((dense - paged).abs().max()):.3e}')
        log(f'  paged mla decode on an identity table == dense mla decode, '
            f'bit for bit ({dtype})')
    # The paged main path's decode steps: 32 slots over 2048 pages of 16
    # rows, ~1000-token prompts plus up to 64 generated tokens, three slots
    # near a 3000-token prompt's end. Three arenas in turn (3 x 38 MB).
    rng = np.random.default_rng(11)
    lengths = [int(x) for x in rng.integers(990, 1101, 32)]
    lengths[5], lengths[17], lengths[30] = 3064, 3001, 3050
    errs.append(paged_mla_case(gen, 'fp32 main-path lengths', fp32,
                               lengths)[1])
    cases = [paged_mla_case(gen, 'bf16 main-path lengths', bf16, lengths,
                            check=i == 0) for i in range(3)]
    err = cases[0][1]
    errs.append(err)
    log(f'  largest paged mla decode error over these {len(errs)} cases: '
        f'{max(errs):.3e} (fp32 tolerance {ATOL[fp32]:g})')
    paged = cases[0][0]
    q_eff, q_rope, ckv, krope, lens, tables = paged
    safe = tables.long().clamp(0, ckv.shape[0] - 1)
    dense = (q_eff, q_rope, ckv[safe].reshape(len(lens), -1, MLA_R),
             krope[safe].reshape(len(lens), -1, MLA_DR), lens)
    out = mla_ops.paged_mla_decode_attention(*paged, MLA_SCALE)
    ref = mla_ops.paged_mla_decode_attention_plain(*paged, MLA_SCALE)
    mla_planted_faults('paged mla decode', out, ref, dense, slot=5)
    mla_repeat('paged mla decode (bf16, main-path lengths)',
               lambda: mla_ops.paged_mla_decode_attention(*paged, MLA_SCALE))
    del out, ref, dense, safe
    it = itertools.count()

    def run_kernel():
        mla_ops.paged_mla_decode_attention(*cases[next(it) % 3][0],
                                           MLA_SCALE)

    def run_plain():
        mla_ops.paged_mla_decode_attention_plain(*cases[next(it) % 3][0],
                                                 MLA_SCALE)

    def run_library():
        # Gather each slot's pages into a dense view, then masked SDPA.
        q_eff, q_rope, ckv, krope, ln, tb = cases[next(it) % 3][0]
        safe = tb.long().clamp(0, ckv.shape[0] - 1)
        b = q_eff.shape[0]
        kd = torch.cat([ckv[safe], krope[safe]], -1).reshape(b, 1, -1,
                                                            MLA_R + MLA_DR)
        q = torch.cat([q_eff, q_rope], -1).to(kd.dtype)[:, :, None]
        pos = torch.arange(kd.shape[2], device='cuda')[None, :]
        mask = (pos < ln[:, None].long())[:, None, None, :]
        F.scaled_dot_product_attention(q, kd, kd[..., :MLA_R],
                                       attn_mask=mask, scale=MLA_SCALE,
                                       enable_gqa=True)

    ms = time_ms(run_kernel, iters=40, warmup=4)
    plain_ms = time_ms(run_plain, iters=8, warmup=2)
    library_ms = time_ms(run_library, iters=10, warmup=2)
    q_eff, q_rope, ckv, _, lens, tables = cases[0][0]
    live = int(lens.clamp(max=tables.shape[1] * ckv.shape[1]).sum())
    bound, bound_by, nbytes, flops = mla_bound(
        q_eff, q_rope, live, ckv.element_size(), tables.numel() * 4)
    log(f'  paged mla decode main-path timing: kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, page gather + masked SDPA (library) '
        f'{library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; bf16 cache '
        f'bytes, products x{MLA_TERMS} at the bf16 peak); {live} live rows, '
        f'{nbytes / ms / 1e6:.1f} GB/s, {flops / ms / 1e9:.2f} TFLOP/s bf16')
    return {'name': 'paged_mla_decode', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_mla_decode.cu',
            'replaces': REPLACES['paged_mla_decode'], 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': bound_by, 'library_ms': library_ms}


def zero_launches() -> None:
    for kern in kernels.REGISTRY:
        kern.launches = 0


def check_launches(path: str, launches: dict, wanted, n_layers: int) -> None:
    """The path's kernels each ran a positive multiple of n_layers times;
    every other kernel not at all."""
    for name, n in launches.items():
        if name in wanted and (n == 0 or n % n_layers):
            raise AssertionError(f'{name}: {n} launches on the {path} path '
                                 f'(want a positive multiple of {n_layers} '
                                 'layers)')
        if name not in wanted and n:
            raise AssertionError(f'{name}: {n} launches on the {path} '
                                 'path, which should not run it')


# ---- phases 4 and 8: serving main paths ----

def serve_and_check(orch, cfg, prompts, new_tokens: int):
    """Submit, drain, require every request whole → (requests, seconds)."""
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    t0 = time.perf_counter()
    requests = [orch.submit(orch_lib.Request(prompt_tokens=p,
                                             max_new_tokens=new_tokens))
                for p in prompts]
    orch.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for r in requests:
        if r.error or len(r.output_tokens) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(
                f'request {r.request_id}: error={r.error}, '
                f'{len(r.output_tokens)} tokens')
    stats = orch.engine.kv_page_stats      # None for a dense cache
    if (stats and stats['free'] != stats['total']) or len(
            orch._free_slots) != orch.engine.config.max_slots:
        raise AssertionError(f'pages or slots not given back after the '
                             f'drain: {stats}, {len(orch._free_slots)} '
                             'free slots')
    return requests, dt


def mean_ms(requests) -> float:
    return float(np.mean([r.first_token_at - r.submitted_at
                          for r in requests])) * 1e3


def main_path(records: dict) -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import llama
    cfg = llama.LLAMA3_8B
    log(f'[4] main path: Llama-3-8B bf16 ({cfg.n_layers} layers, '
        f'd_model {cfg.d_model}, vocab {cfg.vocab_size}), random init')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = llama.init(cfg, gen)
    torch.cuda.synchronize()
    log(f'  init {time.perf_counter() - t0:.2f} s, '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=16,
                                max_target_len=2048,
                                prefill_buckets=(1024,)), params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(960, 1025, 16)]
    new_tokens = 64
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('serving', launches, SERVE_KERNELS, cfg.n_layers)
    for name in SERVE_KERNELS:
        records[name]['launches_by_path'] = {'serve': launches[name]}
    out_tokens = sum(len(r.output_tokens) for r in requests)
    log(f'  16 requests x {new_tokens} tokens done in {dt:.3f} s: '
        f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
        f'{mean_ms(requests):.1f} ms, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
        f'launches {launches} on {nvidia_smi_line()}')
    del orch, engine, params
    release_card()


# ---- phase 5: small model, card vs CPU ----

def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def small_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    log('[5] small end to end: fp32 LLAMA_TINY widths, bucket 1024, '
        'card (kernels) vs CPU (plain versions)')
    gen = torch.Generator()
    gen.manual_seed(3)
    cpu_params = llama.init(cfg, gen, device='cpu')
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (1024, 700, 913, 1000, 64)]
    outputs = {}
    before = {k.name: k.launches for k in kernels.REGISTRY}
    for device in ('cuda', 'cpu'):
        params = to_device(cpu_params, device)
        engine = engine_lib.InferenceEngine(
            engine_lib.EngineConfig(model=cfg, max_slots=4,
                                    max_target_len=1040,
                                    prefill_buckets=(1024,),
                                    kv_dtype=torch.float32),
            params, device=device)
        outputs[device] = orch_lib.Orchestrator(
            engine, decode_steps=4).generate(prompts, max_new_tokens=12)
    used = {k.name: k.launches - before[k.name] for k in kernels.REGISTRY}
    log(f'  card tokens {outputs["cuda"]}')
    log(f'  cpu tokens  {outputs["cpu"]}; card kernel launches {used}')
    if outputs['cuda'] != outputs['cpu']:
        raise AssertionError('greedy tokens differ between the card and '
                             'the CPU')
    if not all(used[name] for name in SERVE_KERNELS):
        raise AssertionError(f'a kernel did not run on the card: {used}')


# ---- phase 6: training main path ----

def train_main_path(records: dict) -> dict:
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer as trainer_lib
    cfg = dataclasses.replace(llama.LLAMA3_1B, remat=True,
                              remat_policy='qkvo_gup')
    # The learning rate only sets how fast the repeated batch's loss
    # falls (the check below); it does not change the step's work.
    tcfg = trainer_lib.TrainConfig(model=cfg, global_batch_size=4,
                                   seq_len=8192, optimizer='adafactor',
                                   learning_rate=3e-3, warmup_steps=2)
    log(f'[6] training main path: Llama-3-1B bf16 ({cfg.n_layers} layers, '
        f'd_model {cfg.d_model}, vocab {cfg.vocab_size}), seq '
        f'{tcfg.seq_len}, batch {tcfg.global_batch_size}, remat '
        f'{cfg.remat_policy}, {tcfg.optimizer}; random init')
    trainer = trainer_lib.Trainer(tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    result = trainer_lib.measure_throughput(trainer, num_steps=5, warmup=2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('training', launches, TRAIN_KERNELS, cfg.n_layers)
    for name in TRAIN_KERNELS:
        records[name].setdefault('launches_by_path', {})['train'] = (
            launches[name])
    first, last = result['first_loss'], result['loss']
    if not (np.isfinite(first) and np.isfinite(last) and last < first):
        raise AssertionError(f'training loss {first} -> {last}: want finite '
                             'and falling on the repeated batch')
    tflops = result['model_tflops_per_sec_per_chip']
    log(f'  7 steps (2 warm-up + 5 measured) in {dt:.3f} s with init: '
        f'{result["tokens_per_sec"]:.1f} tokens/s, step '
        f'{result["step_time_s"]:.4f} s, model {tflops:.2f} TFLOP/s = '
        f'{tflops / (PEAK_FLOPS[torch.bfloat16] / 1e12):.4f} of the bf16 '
        f'peak; loss {first:.4f} -> {last:.4f}; peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
        f'{launches} on {nvidia_smi_line()}')
    log(f'  measure_throughput: {json.dumps(result)}')
    del trainer
    release_card()
    return result


# ---- phase 7: small training check, card vs CPU ----

# Card vs CPU after three fp32 steps: the kernels and the plain versions
# sum in other orders (~1e-6 relative); Adam normalizes each element by
# its own gradient history, which carries a nearly cancelling gradient's
# relative error into the update, up to a few % of one step at lr 1e-3.
TRAIN_LOSS_ATOL = 1e-4
TRAIN_NORM_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-4


def small_train_check() -> None:
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer as trainer_lib
    eos = 7
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32,
                              packing_reset_eos=eos)
    tcfg = trainer_lib.TrainConfig(model=cfg, global_batch_size=2,
                                   seq_len=1024, optimizer='adamw',
                                   accum_steps=2, learning_rate=1e-3,
                                   warmup_steps=2)
    log('[7] small training check: fp32 LLAMA_TINY widths, seq 1024, EOS '
        'packing, adamw, accum_steps=2, 3 steps: card (kernels) vs CPU '
        '(plain versions)')
    gen = torch.Generator()
    gen.manual_seed(5)
    cpu_params = llama.init(cfg, gen, device='cpu')
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 1024))
    tokens[rng.random(tokens.shape) < 0.01] = eos
    batch = {'tokens': torch.from_numpy(tokens),
             'targets': torch.from_numpy(np.roll(tokens, -1, axis=1))}
    runs = {}
    before = {k.name: k.launches for k in kernels.REGISTRY}
    for device in ('cuda', 'cpu'):
        tr = trainer_lib.Trainer(tcfg, device=device)
        state = tr.init_state(to_device(
            {k: (v.clone() if torch.is_tensor(v) else
                 {kk: vv.clone() for kk, vv in v.items()})
             for k, v in cpu_params.items()}, device))
        on_device = {k: v.to(device) for k, v in batch.items()}
        metrics = []
        for _ in range(3):
            state, m = tr.step(state, on_device)
            metrics.append((float(m['loss']), float(m['grad_norm'])))
        runs[device] = (metrics, trainer_lib.param_leaves(state['params']))
    used = {k.name: k.launches - before[k.name] for k in kernels.REGISTRY}
    log(f'  card (loss, grad_norm) {runs["cuda"][0]}')
    log(f'  cpu  (loss, grad_norm) {runs["cpu"][0]}; card kernel launches '
        f'{used}')
    for (lc, nc), (lp, npl) in zip(runs['cuda'][0], runs['cpu'][0]):
        if abs(lc - lp) > TRAIN_LOSS_ATOL or abs(nc - npl) > (
                TRAIN_NORM_RTOL * abs(npl)):
            raise AssertionError('loss or grad norm differs between the '
                                 'card and the CPU')
    err = max(float((pc.detach().cpu() - pp.detach()).abs().max())
              for pc, pp in zip(runs['cuda'][1], runs['cpu'][1]))
    log(f'  final params: max_abs_err={err:.3e} (tolerance '
        f'atol={TRAIN_PARAM_ATOL:g}); losses atol {TRAIN_LOSS_ATOL:g}, '
        f'grad norms rtol {TRAIN_NORM_RTOL:g}')
    if err > TRAIN_PARAM_ATOL:
        raise AssertionError('parameters differ between the card and the '
                             'CPU after three steps')
    if not all(used[name] for name in TRAIN_KERNELS):
        raise AssertionError(f'a kernel did not run on the card: {used}')


# ---- phase 8: paged serving main path ----

def release_card() -> None:
    """Free what a finished phase held on the card. The step counter below
    makes its engine a reference cycle, which only the collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def count_decode_steps(engine) -> list:
    """Wrap the engine's decode step so that a run can count its steps."""
    steps = [0]
    step_impl = engine._decode_step_impl

    def counted(*args, **kwargs):
        steps[0] += 1
        return step_impl(*args, **kwargs)

    engine._decode_step_impl = counted
    return steps


def paged_main_path(records: dict) -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import llama
    cfg = llama.LLAMA3_8B
    log(f'[8] paged main path: Llama-3-8B bf16 ({cfg.n_layers} layers), the '
        'random weights of [4]; 32 slots over 2048 pages of 16 rows')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    params = llama.init(cfg, gen)
    ecfg = engine_lib.EngineConfig(
        model=cfg, max_slots=32, max_target_len=4096,
        prefill_buckets=(1024,), kv_page_size=16, kv_num_pages=2048)
    new_tokens = 64
    rng = np.random.default_rng(8)

    def prompt(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    # (a) 32 prompts whose budgets (1064-1088 rows, 67-68 pages each) add
    # up to more than the arena's 2048 pages.
    engine = engine_lib.InferenceEngine(ecfg, params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    steps = count_decode_steps(engine)
    prompts = [prompt(n) for n in rng.integers(1000, 1025, 32)]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('paged serving', launches, PAGED_SERVE_KERNELS,
                   cfg.n_layers)
    deferred = sum(r.deferred_wait > 0 for r in requests)
    if not deferred:
        raise AssertionError('no request was deferred: the arena held '
                             'every budget at once')
    if launches['paged_decode_attention'] != cfg.n_layers * steps[0]:
        raise AssertionError(
            f'paged_decode_attention: {launches["paged_decode_attention"]} '
            f'launches for {steps[0]} decode steps of {cfg.n_layers} layers')
    for name in PAGED_SERVE_KERNELS:
        records[name].setdefault('launches_by_path', {})['serve_paged'] = (
            launches[name])
    out_tokens = sum(len(r.output_tokens) for r in requests)
    log(f'  (a) 32 requests x {new_tokens} tokens done in {dt:.3f} s: '
        f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
        f'{mean_ms(requests):.1f} ms (admitted at once '
        f'{mean_ms([r for r in requests if not r.deferred_wait]):.1f} ms), '
        f'{deferred} deferred, {steps[0]} decode steps, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
        f'{launches} on {nvidia_smi_line()}')
    del orch, engine
    release_card()

    # (b) the prefix cache on (admission is then one prompt per call): a
    # short prompt, two long ones (three chunks each, one chunk per tick
    # between decode ticks), three more short ones that share the first
    # one's first 768 tokens.
    engine = engine_lib.InferenceEngine(
        dataclasses.replace(ecfg, prefix_cache_entries=4), params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    steps = count_decode_steps(engine)
    shared = prompt(768)
    shorts = [shared + prompt(n) for n in rng.integers(200, 250, 4)]
    longs = [prompt(3000) for _ in range(2)]
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, [shorts[0]] + longs + shorts[1:],
                                   new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('paged + prefix serving', launches, PAGED_SERVE_KERNELS,
                   cfg.n_layers)
    stats = engine.prefix_cache_stats
    if stats['hits'] < 3 or stats['tokens_reused'] < 3 * 768:
        raise AssertionError(f'prefix cache: {stats}, want 3 hits of 768 '
                             'tokens')
    if launches['paged_decode_attention'] != cfg.n_layers * steps[0]:
        raise AssertionError(
            f'paged_decode_attention: {launches["paged_decode_attention"]} '
            f'launches for {steps[0]} decode steps of {cfg.n_layers} layers')
    for name in PAGED_SERVE_KERNELS:
        records[name]['launches_by_path']['serve_paged_prefix'] = (
            launches[name])
    log(f'  (b) 6 requests x {new_tokens} tokens done in {dt:.3f} s: TTFT '
        f'first short prompt (miss) {mean_ms(requests[:1]):.1f} ms, long '
        f'prompts (3 chunks) {mean_ms(requests[1:3]):.1f} ms, prefix-hit '
        f'prompts {mean_ms(requests[3:]):.1f} ms; prefix cache {stats}, '
        f'{steps[0]} decode steps; launches {launches} on '
        f'{nvidia_smi_line()}')
    del orch, engine, params
    release_card()


# ---- phase 9: small paged model, card vs CPU ----

def small_paged_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    log('[9] small paged end to end: fp32 LLAMA_TINY widths, 250 pages of '
        '16 rows, bucket 1024, chunked prefill and the prefix cache, card '
        '(kernels) vs CPU (plain versions)')
    gen = torch.Generator()
    gen.manual_seed(9)
    cpu_params = llama.init(cfg, gen, device='cpu')
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (2100, 1024, 700, 913, 64)]
    prompts.insert(3, prompts[1][:600] + prompts[4][:50])
    outputs, stats = {}, {}
    before = {k.name: k.launches for k in kernels.REGISTRY}
    for device in ('cuda', 'cpu'):
        engine = engine_lib.InferenceEngine(
            engine_lib.EngineConfig(model=cfg, max_slots=4,
                                    max_target_len=2560,
                                    prefill_buckets=(1024,),
                                    kv_dtype=torch.float32, kv_page_size=16,
                                    kv_num_pages=250,
                                    prefix_cache_entries=4),
            to_device(cpu_params, device), device=device)
        orch = orch_lib.Orchestrator(engine, decode_steps=4)
        requests = [orch.submit(orch_lib.Request(prompt_tokens=p,
                                                 max_new_tokens=12))
                    for p in prompts]
        orch.run_until_drained()
        outputs[device] = [r.output_tokens for r in requests]
        stats[device] = (engine.prefix_cache_stats, engine.kv_page_stats,
                         sum(r.deferred_wait > 0 for r in requests))
    used = {k.name: k.launches - before[k.name] for k in kernels.REGISTRY}
    log(f'  card tokens {outputs["cuda"]}')
    log(f'  cpu tokens  {outputs["cpu"]}; (prefix cache, pages, deferred) '
        f'{stats["cuda"]}; card kernel launches {used}')
    if outputs['cuda'] != outputs['cpu'] or stats['cuda'] != stats['cpu']:
        raise AssertionError('greedy tokens or cache statistics differ '
                             'between the card and the CPU')
    if not all(len(t) == 12 for t in outputs['cuda']):
        raise AssertionError('a request did not finish')
    prefix, pages, deferred = stats['cuda']
    if not (prefix['hits'] and deferred and pages['free'] == pages['total']):
        raise AssertionError(f'the run missed a path: {stats["cuda"]}')
    if not all(used[name] for name in PAGED_SERVE_KERNELS):
        raise AssertionError(f'a kernel did not run on the card: {used}')


# ---- phases 10 and 11: DeepSeek-V2-Lite serving, dense and paged ----

def deepseek_main_paths(records: dict) -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import deepseek
    cfg = deepseek.DEEPSEEK_V2_LITE
    log(f'[10] DeepSeek main path: DeepSeek-V2-Lite bf16 ({cfg.n_layers} '
        f'layers, d_model {cfg.d_model}, {cfg.n_heads} heads, kv_lora_rank '
        f'{cfg.kv_lora_rank}, {cfg.n_experts} experts top-'
        f'{cfg.experts_per_token} + {cfg.n_shared_experts} shared, vocab '
        f'{cfg.vocab_size}; {cfg.num_params() / 1e9:.2f} B parameters), '
        'random init; dense slot cache')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = deepseek.init(cfg, gen)
    torch.cuda.synchronize()
    log(f'  init {time.perf_counter() - t0:.2f} s, '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    rng = np.random.default_rng(10)

    def prompt(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    new_tokens = 64
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=16,
                                max_target_len=2048,
                                prefill_buckets=(1024,)), params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    steps = count_decode_steps(engine)
    prompts = [prompt(n) for n in rng.integers(960, 1025, 16)]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('DeepSeek serving', launches, DEEPSEEK_KERNELS,
                   cfg.n_layers)
    if launches['mla_decode'] != cfg.n_layers * steps[0]:
        raise AssertionError(f'mla_decode: {launches["mla_decode"]} launches '
                             f'for {steps[0]} decode steps of '
                             f'{cfg.n_layers} layers')
    records['mla_decode']['launches_by_path'] = {
        'serve_deepseek': launches['mla_decode']}
    out_tokens = sum(len(r.output_tokens) for r in requests)
    log(f'  16 requests x {new_tokens} tokens done in {dt:.3f} s: '
        f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
        f'{mean_ms(requests):.1f} ms, {steps[0]} decode steps, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
        f'{launches} on {nvidia_smi_line()}')
    del orch, engine
    release_card()

    log('[11] DeepSeek paged main path: the same model and weights, 32 '
        'slots over 2048 pages of 16 rows')
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=32,
                                max_target_len=4096,
                                prefill_buckets=(1024,), kv_page_size=16,
                                kv_num_pages=2048), params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    steps = count_decode_steps(engine)
    # Budgets of 1064-1088 rows (67-68 pages each): more than 2048 pages.
    prompts = [prompt(n) for n in rng.integers(1000, 1025, 32)]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('DeepSeek paged serving', launches,
                   PAGED_DEEPSEEK_KERNELS, cfg.n_layers)
    deferred = sum(r.deferred_wait > 0 for r in requests)
    if not deferred:
        raise AssertionError('no request was deferred: the arena held '
                             'every budget at once')
    if launches['paged_mla_decode'] != cfg.n_layers * steps[0]:
        raise AssertionError(
            f'paged_mla_decode: {launches["paged_mla_decode"]} launches for '
            f'{steps[0]} decode steps of {cfg.n_layers} layers')
    records['paged_mla_decode']['launches_by_path'] = {
        'serve_deepseek_paged': launches['paged_mla_decode']}
    out_tokens = sum(len(r.output_tokens) for r in requests)
    log(f'  32 requests x {new_tokens} tokens done in {dt:.3f} s: '
        f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
        f'{mean_ms(requests):.1f} ms (admitted at once '
        f'{mean_ms([r for r in requests if not r.deferred_wait]):.1f} ms), '
        f'{deferred} deferred, {steps[0]} decode steps, all pages free '
        f'after the drain, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
        f'{launches} on {nvidia_smi_line()}')
    del orch, engine, params
    release_card()


# ---- phase 12: small DeepSeek, card vs CPU ----

def small_deepseek_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import deepseek
    cfg = dataclasses.replace(deepseek.DEEPSEEK_TINY, dtype=torch.float32)
    log('[12] small DeepSeek end to end: fp32 DEEPSEEK_TINY widths, a dense '
        'and a paged engine, a 3-prompt wave padded to 4 rows, card '
        '(kernels) vs CPU (plain versions)')
    gen = torch.Generator()
    gen.manual_seed(12)
    cpu_params = deepseek.init(cfg, gen, device='cpu')
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (120, 77, 128)]
    for paged in (False, True):
        kernel = mla_ops.PAGED_KERNEL if paged else mla_ops.KERNEL
        outputs = {}
        before = kernel.launches
        for device in ('cuda', 'cpu'):
            engine = engine_lib.InferenceEngine(
                engine_lib.EngineConfig(
                    model=cfg, max_slots=4, max_target_len=512,
                    prefill_buckets=(128,), kv_dtype=torch.float32,
                    kv_page_size=16 if paged else 0),
                to_device(cpu_params, device), device=device)
            outputs[device] = orch_lib.Orchestrator(
                engine, decode_steps=4).generate(prompts, max_new_tokens=16)
        name = 'paged' if paged else 'dense'
        log(f'  {name} card tokens {outputs["cuda"]}')
        log(f'  {name} cpu tokens  {outputs["cpu"]}; {kernel.name} launches '
            f'on the card {kernel.launches - before}')
        if outputs['cuda'] != outputs['cpu']:
            raise AssertionError(f'{name}: greedy tokens differ between the '
                                 'card and the CPU')
        if not all(len(t) == 16 for t in outputs['cuda']):
            raise AssertionError(f'{name}: a request did not finish')
        if kernel.launches == before:
            raise AssertionError(f'{kernel.name} did not run on the card')


# ---- phases 13 and 14: quantized replicas through the HTTP server ----

# bench.py serve's first two rungs: Llama-3-8B with int8, then int4
# weights and an int8 KV cache; 16 slots, max_target_len 2048, prompts of
# 512 tokens ((i * 7 + j) % vocab), 128 new tokens each, decode fused 16
# steps a tick; 32 requests. The path's kernel is K4 alone: a 512-token
# prompt takes the plain prefill attention, as the reference's dispatch
# sends every sequence below 1024 to its XLA path (ops/attention.py
# _FLASH_MIN_SEQ in both packages).
QUANT_SERVE_KERNELS = ('decode_attention',)
RUNG = dict(slots=16, max_len=2048, requests=32, prompt_len=512,
            new_tokens=128, decode_steps=16)
# (prompts sent one at a time, concurrent requests) of each replica: [13]
# sends 16 of the rung's 32 concurrent requests (32 until phase 38 took
# the time), [14] 16: one for each of the 16 slots; each sends one prompt
# alone (four took 69-109 s of [13] and 105 s of [14] in whole runs of
# 882-1000 s), with every check.
REPLICA_REQUESTS = {'int8': (1, 16), 'int4': (1, 16)}
# Llama-3-8B's widths at 4 of its 32 layers: the whole script's time
# limit took the depth when phases 37 (to 16), 38 (to 8) and 39 (to 4)
# were added.
REPLICA_LAYERS = 4


def http_json(url: str, path: str, body=None, timeout: float = 600.0):
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        text = resp.read().decode()
    return json.loads(text) if body is not None else text


def concurrent_generate(url: str, bodies, vocab: int):
    """POST /generate every body at once, each whole → (streams, s)."""
    import threading
    results = [None] * len(bodies)

    def client(i):
        try:
            results[i] = http_json(url, '/generate', bodies[i])
        except Exception as e:  # pylint: disable=broad-except
            results[i] = e

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    dt = time.perf_counter() - t0
    for i, res in enumerate(results):
        if not isinstance(res, dict) or len(res['output_tokens']) != \
                bodies[i]['max_new_tokens'] or not all(
                0 <= t < vocab for t in res['output_tokens']):
            raise AssertionError(f'request {i}: {str(res)[:300]}')
    return [res['output_tokens'] for res in results], dt


def metric(text: str, name: str) -> float:
    """The value of an unlabelled (or the one labelled) series."""
    for line in text.splitlines():
        if line.startswith(name) and not line.startswith('#'):
            return float(line.rsplit(' ', 1)[1])
    raise AssertionError(f'{name} missing from /metrics:\n{text[:2000]}')


def quantized_replica(records: dict, bits: str) -> None:
    import threading
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import quantization as qops
    phase = {'int8': 13, 'int4': 14}[bits]
    cfg = dataclasses.replace(llama.LLAMA3_8B, n_layers=REPLICA_LAYERS)
    r = RUNG
    n_singles, n_requests = REPLICA_REQUESTS[bits]
    log(f'[{phase}] {bits} replica: Llama-3-8B ({cfg.n_layers} of '
        f'{llama.LLAMA3_8B.n_layers} layers, public widths) with {bits} '
        f'weights quantized on the card as the seeded init draws them, int8 '
        f'KV; {r["slots"]} slots, max_target_len {r["max_len"]}, '
        f'decode_steps {r["decode_steps"]}; the port\'s infer/server.py on '
        '127.0.0.1')
    t0 = time.perf_counter()
    with registered_config('llama3-8b-replica', cfg) as name:
        replica = server_lib.build_replica(server_lib.parse_args([
            '--model', name, '--weight-dtype', bits, '--kv-dtype', 'int8',
            '--max-slots', str(r['slots']), '--max-target-len',
            str(r['max_len']), '--decode-steps', str(r['decode_steps']),
            '--port', '0']), host='127.0.0.1')
    torch.cuda.synchronize()
    nbytes = qops.params_nbytes(replica.engine.params)
    log(f'  init + quantize + engine + warm-up {time.perf_counter() - t0:.2f}'
        f' s; weights {nbytes / 1e9:.3f} GB (params_nbytes), '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    try:
        if json.loads(http_json(url, '/health'))['status'] != 'healthy':
            raise AssertionError('/health did not answer healthy')
        vocab = cfg.vocab_size
        prompts = [[(i * 7 + j) % vocab for j in range(r['prompt_len'])]
                   for i in range(n_requests)]
        # The server adds nothing: the first prompts, one at a time (a
        # wave of one, then decode), give the tokens of
        # Orchestrator.generate on the same engine, run with the serving
        # loop held.
        t0 = time.perf_counter()
        for i, p in enumerate(prompts[:n_singles]):
            served = http_json(url, '/generate', {
                'prompt_tokens': p, 'max_new_tokens': r['new_tokens']})
            with replica.loop._lock:
                direct = replica.loop.orch.generate(
                    [p], max_new_tokens=r['new_tokens'])[0]
            if served['output_tokens'] != direct:
                raise AssertionError(f'request {i}: the server gave other '
                                     'tokens than Orchestrator.generate')
        log(f'  {n_singles} request(s) one at a time '
            f'({time.perf_counter() - t0:.2f} s with their direct runs): '
            'the server\'s tokens equal Orchestrator.generate on the same '
            'engine')
        before = http_json(url, '/metrics')
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        _, dt = concurrent_generate(url, [
            {'prompt_tokens': p, 'max_new_tokens': r['new_tokens']}
            for p in prompts], vocab)
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        after = http_json(url, '/metrics')
        check_launches(f'{bits} replica', launches, QUANT_SERVE_KERNELS,
                       cfg.n_layers)
        for name in QUANT_SERVE_KERNELS:
            records[name].setdefault('launches_by_path', {})[
                f'serve_{bits}'] = launches[name]
        n_req = n_singles + n_requests
        want = {'xsky_serve_requests_total{endpoint="/generate",'
                'outcome="ok"}': n_req,
                'xsky_serve_prompt_tokens_total': n_req * r['prompt_len'],
                'xsky_serve_generated_tokens_total':
                    n_req * r['new_tokens']}
        got = {name: metric(after, name) for name in want}
        if got != want:
            raise AssertionError(f'/metrics counters {got}, sent {want}')
        ttft_n = (metric(after, 'xsky_serve_ttft_seconds_count')
                  - metric(before, 'xsky_serve_ttft_seconds_count'))
        ttft_s = (metric(after, 'xsky_serve_ttft_seconds_sum')
                  - metric(before, 'xsky_serve_ttft_seconds_sum'))
        if ttft_n != n_requests:
            raise AssertionError(f'{ttft_n} TTFT samples for '
                                 f'{n_requests} requests')
        out_tokens = n_requests * r['new_tokens']
        log(f'  {n_requests} concurrent POST /generate x '
            f'{r["new_tokens"]} tokens in {dt:.3f} s: '
            f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
            f'{ttft_s / ttft_n * 1e3:.1f} ms (/metrics), peak memory '
            f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, weights '
            f'{nbytes} bytes; /metrics counters equal what was sent; '
            f'launches {launches} on {nvidia_smi_line()}')
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()
    del replica
    release_card()


# ---- phase 15: small quantized models card vs CPU, full-width ops ----

# The quantized forms round to bf16 where the plain form (dequantize to
# fp32, fp32 product) does not: the int8 product and its scale (int8),
# each dequantized weight (int4), at 2^-9 relative each. Against the
# largest |output|, with the same relative bound per element.
QUANT_RTOL = 2.0 ** -7
QUANT_ATOL_OF_MAX = 2.0 ** -7
# fp32 outputs (the fp32 LM head, the fp32 expert gate): exact products
# summed in fp32 in another order.
QUANT_FP32_ATOL_OF_MAX = 1e-5


def small_quantized_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import deepseek
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import quantization as qops
    log('[15] small quantized models, card (kernels) vs CPU (plain '
        'versions); quantized ops at full width against their plain form')
    cases = [('llama', dataclasses.replace(llama.LLAMA_TINY,
                                           dtype=torch.float32), llama),
             ('deepseek', dataclasses.replace(deepseek.DEEPSEEK_TINY,
                                              dtype=torch.float32),
              deepseek)]
    rng = np.random.default_rng(15)
    for name, cfg, mod in cases:
        gen = torch.Generator()
        gen.manual_seed(15)
        cpu_params = mod.init(cfg, gen, device='cpu')
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                   for n in (120, 77, 128)]
        for bits, wd in (('int8', torch.int8), ('int4', 'int4')):
            quant = (qops.quantize_params if bits == 'int8'
                     else qops.quantize_params_int4)
            tree = quant(cpu_params)
            on_card = quant(to_device(cpu_params, 'cuda'))
            same = all(torch.equal(a.cpu(), b) for a, b in zip(
                tensors(on_card), tensors(tree)))
            if not same:
                raise AssertionError(f'{name} {bits}: quantizing on the '
                                     'card gave other bytes than the CPU')
            kv = (torch.int8 if name == 'llama' and bits == 'int8'
                  else torch.float32)
            outputs = {}
            for device in ('cuda', 'cpu'):
                engine = engine_lib.InferenceEngine(
                    engine_lib.EngineConfig(
                        model=cfg, max_slots=4, max_target_len=256,
                        prefill_buckets=(128,), kv_dtype=kv,
                        weight_dtype=wd),
                    to_device(tree, device), device=device)
                outputs[device] = orch_lib.Orchestrator(
                    engine, decode_steps=4).generate(prompts,
                                                     max_new_tokens=12)
            log(f'  {name} {bits} weights, {str(kv)[6:]} KV: card tokens '
                f'{outputs["cuda"]}; quantized on the card = on the CPU, '
                'bit for bit')
            if outputs['cuda'] != outputs['cpu']:
                raise AssertionError(f'{name} {bits}: greedy tokens differ '
                                     'between the card and the CPU '
                                     f'({outputs["cpu"]})')
    release_card()
    full_width_quantized_ops()


def tensors(tree):
    """Every tensor of a params tree (a quantized leaf's values and
    scales), in key order."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from tensors(value)
        elif hasattr(value, 'scale'):
            yield value.q_packed if hasattr(value, 'q_packed') else value.q
            yield value.scale
        else:
            yield value


def compare_quantized(name, got, want, atol_of_max, rtol) -> float:
    atol = atol_of_max * float(want.abs().max())
    err = (got.float() - want).abs()
    max_err = float(err.max())
    log(f'  {name}: max_abs_err={max_err:.3e} (tolerance atol '
        f'{atol:.3e} = {atol_of_max:g} x max|plain|, rtol {rtol:g})')
    if not torch.isfinite(got.float()).all() or bool(
            (err > atol + rtol * want.abs()).any()):
        raise AssertionError(f'{name}: the quantized form disagrees with '
                             'its plain form')
    return max_err


def full_width_quantized_ops() -> None:
    from skypilot_tpu_torch.models import deepseek
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import quantization as qops
    cfg = llama.LLAMA3_8B
    gen = torch.Generator(device='cuda')
    gen.manual_seed(150)
    x = rand(gen, (16, cfg.d_model), torch.bfloat16)
    w = (rand(gen, (cfg.d_model, cfg.d_ff), torch.float32)
         * cfg.d_model ** -0.5).to(torch.bfloat16)
    bound = bound_ms(w.numel() * w.element_size(), 0, torch.bfloat16)[0]
    bf16_ms = time_ms(lambda: torch.matmul(x, w))
    for bits, quant, deq in (('int8', qops.quantize, qops.dequantize),
                             ('int4', qops.quantize4, qops.dequantize4)):
        qw = quant(w)
        cpu = quant(w.cpu())
        for a, b in zip(tensors({'w': qw}), tensors({'w': cpu})):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f'{bits} quantization of a [4096, '
                                     '14336] bf16 weight: the card differs '
                                     'from the CPU')
        want = x.float() @ deq(qw, torch.float32)
        compare_quantized(f'{bits} matmul [16, 4096] x [4096, 14336] (bf16 '
                          'out)', qops.matmul(x, qw), want,
                          QUANT_ATOL_OF_MAX, QUANT_RTOL)
        ms = time_ms(lambda: qops.matmul(x, qw))
        log(f'    {bits} matmul {ms:.4f} ms (the bf16 weight\'s own product '
            f'{bf16_ms:.4f} ms; weight bytes over 3.35 TB/s: '
            f'{bound_ms(qw.nbytes, 0, torch.bfloat16)[0]:.4f} ms at {bits}, '
            f'{bound:.4f} ms at bf16) on the card, quantized weights '
            'bit for bit equal to the CPU\'s')
    # The fp32-output LM head, int8 (the int8 replica's) and int4.
    head = (rand(gen, (cfg.d_model, cfg.vocab_size), torch.float32)
            * cfg.d_model ** -0.5).to(torch.bfloat16)
    for bits, quant, deq in (('int8', qops.quantize, qops.dequantize),
                             ('int4', qops.quantize4, qops.dequantize4)):
        qh = quant(head)
        got = qops.matmul(x, qh, preferred_element_type=torch.float32)
        if bits == 'int8':
            want = (x.float() @ qh.q.float()) * qh.scale
            tol = QUANT_FP32_ATOL_OF_MAX
        else:
            want = x.float() @ deq(qh, torch.float32)
            tol = QUANT_ATOL_OF_MAX
        if got.dtype != torch.float32:
            raise AssertionError(f'{bits} LM head: {got.dtype} logits')
        compare_quantized(f'{bits} LM head [16, 4096] x [4096, 128256], '
                          'fp32 out', got, want, tol,
                          0.0 if bits == 'int8' else QUANT_RTOL)
        del qh, got, want
    del head
    # DeepSeek-V2-Lite's experts: 64 of [2048, 1408], a decode step's 16
    # rows each, the gate product in fp32.
    ds = deepseek.DEEPSEEK_V2_LITE
    xe = rand(gen, (ds.n_experts, 16, ds.d_model), torch.bfloat16)
    we = (rand(gen, (ds.n_experts, ds.d_model, ds.moe_d_ff), torch.float32)
          * ds.d_model ** -0.5).to(torch.bfloat16)
    qe = qops.quantize(we)
    got = qops.expert_matmul(xe, qe, torch.float32)
    want = torch.bmm(xe.float(), qe.q.float()) * qe.scale[:, None, :]
    compare_quantized('int8 expert_matmul [64, 16, 2048] x [64, 2048, 1408],'
                      ' fp32 out', got, want, QUANT_FP32_ATOL_OF_MAX, 0.0)
    # The quantized embedding: rows on the card equal the CPU's bit for bit.
    table = qops.quantize((rand(gen, (cfg.vocab_size, cfg.d_model),
                                torch.float32)).to(torch.bfloat16), -1)
    tokens = torch.randint(0, cfg.vocab_size, (16, 64), generator=gen,
                           device='cuda')
    rows = qops.embed_rows(table, tokens)
    if not torch.equal(rows.cpu(), qops.embed_rows(table.to('cpu'),
                                                   tokens.cpu())):
        raise AssertionError('quantized embed_rows: the card differs from '
                             'the CPU')
    log('  int8 embed_rows [128256, 4096] table, 16 x 64 tokens: the card\'s '
        'rows equal the CPU\'s bit for bit')
    del table, rows, xe, we, qe
    release_card()


# ---- phases 16-19: the training entry point, LoRA, the converter ----

LAUNCH_LOGGER = 'skypilot_tpu_torch.train.launch'


class LaunchLog(logging.Handler):
    """Collects the launcher's log lines (its logger at INFO) while a
    phase runs it in-process, so the kernel counters stay readable."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        logger = logging.getLogger(LAUNCH_LOGGER)
        self._level = logger.level
        logger.setLevel(logging.INFO)
        logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        logger = logging.getLogger(LAUNCH_LOGGER)
        logger.removeHandler(self)
        logger.setLevel(self._level)
        return False


class registered_config:
    """``name`` → ``cfg`` in the port's Llama configs while a phase runs
    the launcher (``--model name``), as bench.py builds its own rungs.
    ``models.get_config`` looks there first, so a registered name stands
    for another family's config of that name (a cut depth)."""

    def __init__(self, name, cfg):
        from skypilot_tpu_torch.models import llama
        self.configs, self.name, self.cfg = llama.CONFIGS, name, cfg

    def __enter__(self):
        self.configs[self.name] = self.cfg
        return self.name

    def __exit__(self, *exc):
        del self.configs[self.name]
        return False


class short_warmup:
    """The trainer's learning-rate warm-up cut from its fixed 100 steps to
    ``steps`` while a phase runs the launcher, so that a loss moves within
    a few steps: ``TrainConfig`` becomes a subclass with that default
    (the launcher, like the reference's, has no flag for it)."""

    def __init__(self, steps: int):
        from skypilot_tpu_torch.train import trainer as trainer_lib
        self.module, self.steps = trainer_lib, steps

    def __enter__(self):
        self.real = self.module.TrainConfig
        self.module.TrainConfig = dataclasses.make_dataclass(
            'TrainConfig', [('warmup_steps', int, self.steps)],
            bases=(self.real,))
        return self.steps

    def __exit__(self, *exc):
        self.module.TrainConfig = self.real
        return False


def write_token_shards(root: str, n_tokens: int, vocab: int, seed: int,
                       n_shards: int = 2) -> str:
    """uint32 token shards from a numpy seed, split over n_shards files."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, n_tokens).astype('<u4')
    os.makedirs(root, exist_ok=True)
    for i, part in enumerate(np.array_split(tokens, n_shards)):
        part.tofile(os.path.join(root, f'part-{i:02d}.bin'))
    return root


def launch_run(argv, label: str, kernels_wanted=TRAIN_KERNELS,
               n_layers: int = 16):
    """launch.run on argv with the launch counts zeroed just before and
    read just after; the flight recorder's ring starts empty."""
    from skypilot_tpu_torch.agent import flight_recorder
    from skypilot_tpu_torch.train import launch
    flight_recorder.reset_for_test()
    zero_launches()
    with LaunchLog() as captured:
        out = launch.run(launch.parse_args(argv))
    if out['trainer'].device.type == 'cuda':
        torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    if kernels_wanted:
        check_launches(label, launches, kernels_wanted, n_layers)
    out['log'] = captured.lines
    out['launches'] = launches
    out['records'] = flight_recorder.get_recorder().records()[::-1]
    return out


def phase_shares(records) -> dict:
    """Each flight-recorder phase's share of the steps' summed wall."""
    wall = sum(r['wall_s'] for r in records)
    return {name: sum(r['phases'][name] for r in records) / wall
            for name in records[0]['phases']}


# Resumed losses against the uninterrupted run's: the reference's own
# bound (tests/unit_tests/test_checkpoint_resume.py:75-78).
RESUME_RTOL = 1e-4
METRIC_KEYS = {'step', 'loss', 'tokens_per_sec', 'model_tflops_per_chip',
               'grad_norm', 'time'}


def launch_main_path(records: dict, train_result: dict) -> None:
    import tempfile
    from skypilot_tpu_torch.agent import checkpointd
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import launch
    cfg = dataclasses.replace(llama.LLAMA3_1B, remat=True,
                              remat_policy='qkvo_gup')
    gb, seq = 4, 8192
    log(f'[16] launch, checkpoint, resume: python -m '
        f'skypilot_tpu_torch.train.launch in-process, Llama-3-1B bf16 '
        f'({cfg.n_layers} layers), seq {seq}, global batch {gb}, remat '
        'qkvo_gup, adafactor, uint32 token shards through the native loader '
        '(built by g++ here; one worker, so that batches arrive in order)')
    with tempfile.TemporaryDirectory(prefix='xsky-launch-') as tmp, \
            registered_config('llama3-1b-qkvo_gup', cfg) as name:
        os.environ['XSKY_NATIVE_CACHE'] = os.path.join(tmp, 'native')
        data = write_token_shards(os.path.join(tmp, 'tokens'),
                                  7 * gb * seq + 1, cfg.vocab_size, seed=16)
        common = ['--model', name, '--global-batch-size', str(gb),
                  '--seq-len', str(seq), '--optimizer', 'adafactor',
                  '--device', 'cuda', '--log-every', '1', '--data', data,
                  '--data-loader', 'native', '--data-workers', '1']
        ckpt = os.path.join(tmp, 'ckpt')
        metrics = os.path.join(tmp, 'metrics.jsonl')
        t0 = time.perf_counter()
        solid = launch_run(common + ['--steps', '6', '--metrics-file',
                                     metrics], 'launch (6 steps)')
        t_solid = time.perf_counter() - t0
        if solid['data'] != 'NativeTokenLoader':
            raise AssertionError(f'loader {solid["data"]}, want native')
        rows = [json.loads(line) for line in open(metrics, encoding='utf-8')]
        if [set(r) for r in rows] != [METRIC_KEYS] * 6:
            raise AssertionError(f'metrics file rows {rows}')
        shares = phase_shares(solid['records'])
        launches = {k: v for k, v in solid['launches'].items()
                    if k in TRAIN_KERNELS}
        del solid['state'], solid['trainer']
        release_card()
        counted0 = checkpointd.counters().get('xsky_ckpt_bytes_total', 0.0)
        t0 = time.perf_counter()
        first = launch_run(common + ['--steps', '3', '--checkpoint-every',
                                     '3', '--checkpoint-dir', ckpt],
                           'launch (3 steps, checkpoint)')
        t_first = time.perf_counter() - t0
        copy_ms = [r['phases']['ckpt_copy'] * 1e3 for r in first['records']]
        fast_bytes = checkpointd.counters()['xsky_ckpt_bytes_total'] - counted0
        store = launch.StepCheckpoints(ckpt)
        if store.steps() != [3]:
            raise AssertionError(f'step directories {store.steps()}')
        step_bytes = os.path.getsize(os.path.join(ckpt, '3',
                                                  launch.STATE_FILE))
        del first['state'], first['trainer']
        release_card()
        t0 = time.perf_counter()
        resumed = launch_run(common + ['--steps', '6', '--resume', 'auto',
                                       '--checkpoint-every', '3',
                                       '--checkpoint-dir', ckpt],
                             'launch (resumed to 6)')
        t_resumed = time.perf_counter() - t0
        del resumed['state'], resumed['trainer']
        release_card()
        os.environ.pop('XSKY_NATIVE_CACHE')
    if 'Resumed from checkpoint step 3.' not in resumed['log']:
        raise AssertionError(f'no resume line in {resumed["log"]}')
    if sorted(resumed['losses']) != [4, 5, 6] or any(
            line.startswith(f'step {k}/6 ') for line in resumed['log']
            for k in (1, 2, 3)):
        raise AssertionError(f'resumed run logged {resumed["log"]}')
    if first['losses'] != {k: solid['losses'][k] for k in (1, 2, 3)}:
        log(f'  note: steps 1-3 of the checkpointing run '
            f'{first["losses"]} vs {solid["losses"]}')
    errs = {k: abs(resumed['losses'][k] - solid['losses'][k]) /
            abs(solid['losses'][k]) for k in (4, 5, 6)}
    identical = all(resumed['losses'][k] == solid['losses'][k]
                    for k in (4, 5, 6))
    log(f'  uninterrupted losses {solid["losses"]}')
    log(f'  resumed from step 3 ({resumed["restore"]["tier"]} tier in '
        f'{resumed["restore"]["seconds"]:.3f} s): losses '
        f'{resumed["losses"]}; relative differences {errs} (tolerance '
        f'{RESUME_RTOL:g}); bit-identical: {identical}')
    if max(errs.values()) > RESUME_RTOL:
        raise AssertionError('resumed losses differ from the uninterrupted '
                             'run')
    tps = [r['tokens_per_sec'] for r in rows[1:]]
    copies = [ms for ms in copy_ms if ms > 0]
    log(f'  launched steps 2-6: {np.mean(tps):.1f} tokens/s (metrics file; '
        f'{[round(t, 1) for t in tps]}) against measure_throughput\'s '
        f'{train_result["tokens_per_sec"]:.1f} in [6]; runs took '
        f'{t_solid:.1f} / {t_first:.1f} / {t_resumed:.1f} s with init')
    log(f'  save: the step loop paid {copies} ms of device->host copy '
        f'(ckpt_copy, per forced snapshot); checkpoint bytes: step '
        f'directory {step_bytes}, fast tier {fast_bytes:.0f} over '
        f'{len(copies)} snapshots; restore '
        f'{resumed["restore"]["seconds"]:.3f} s')
    log('  flight recorder shares of the 6-step run\'s wall: ' + ', '.join(
        f'{k} {v:.4f}' for k, v in shares.items()) +
        ' (dispatch = the host\'s launch of the step, unsynced)')
    total = {name: launches[name] + first['launches'][name] +
             resumed['launches'][name] for name in TRAIN_KERNELS}
    for name in TRAIN_KERNELS:
        records[name].setdefault('launches_by_path', {})['launch'] = (
            total[name])
    log(f'  launches per run: {launches}, '
        f'{ {k: first["launches"][k] for k in TRAIN_KERNELS} }, '
        f'{ {k: resumed["launches"][k] for k in TRAIN_KERNELS} }; decode '
        f'kernels 0; on {nvidia_smi_line()}')


def lora_main_path(records: dict) -> None:
    import tempfile
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer as trainer_lib
    cfg = llama.LLAMA3_8B
    gb, seq, steps = 4, 8192, 3
    # remat 'dots' keeps ~86 KB a token and layer (every product): one
    # 8192-token row is ~23 GB for 32 layers beside the 16 GB base, so
    # the batch of 4 runs as 4 accumulated microbatches of one row.
    accum = 4
    log(f'[17] LoRA: examples/tpu/lora_finetune_llama3.yaml on one card: '
        f'Llama-3-8B bf16 ({cfg.n_layers} layers, random base), rank 16, '
        f'alpha 32, targets wq,wk,wv,wo, adamw, lr 1e-3 (warm-up 1), seq '
        f'{seq}, global batch {gb} as --accum-steps {accum}; {steps} steps '
        'on a repeated batch (a shard of exactly one batch)')
    with tempfile.TemporaryDirectory(prefix='xsky-lora-') as tmp:
        os.environ['XSKY_NATIVE_CACHE'] = os.path.join(tmp, 'native')
        data = write_token_shards(os.path.join(tmp, 'tokens'),
                                  gb * seq + 1, cfg.vocab_size, seed=17,
                                  n_shards=1)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with short_warmup(1):
            out = launch_run([
                '--model', 'llama3-8b', '--seq-len', str(seq),
                '--global-batch-size', str(gb), '--accum-steps', str(accum),
                '--lora-rank', '16', '--lora-alpha', '32', '--lora-targets',
                'wq,wk,wv,wo', '--learning-rate', '1e-3', '--optimizer',
                'adamw', '--steps', str(steps), '--log-every', '1',
                '--data', data, '--data-loader', 'native',
                '--device', 'cuda'], 'LoRA', n_layers=cfg.n_layers)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        os.environ.pop('XSKY_NATIVE_CACHE')
    losses = [out['losses'][k] for k in sorted(out['losses'])]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f'LoRA losses {losses}: want finite, falling')
    state = out['state']
    adapters = trainer_lib.param_leaves(state['params'])
    shapes = {tuple(a.shape) for a in adapters}
    opt = []

    def walk(x):
        if torch.is_tensor(x):
            opt.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
    walk(state['opt_state'])
    if not opt or any(tuple(t.shape) not in shapes for t in opt if t.ndim):
        raise AssertionError('optimizer state holds a tensor that is not '
                             f'adapter-sized: {[tuple(t.shape) for t in opt]}')
    n_adapter = sum(a.numel() for a in adapters)
    opt_bytes = sum(t.numel() * t.element_size() for t in opt)
    # The base is frozen: equal bit for bit to the seeded init it started
    # from (the trainer draws it from a generator seeded with the seed).
    base = state['base']
    del out['state'], out['trainer'], state
    release_card()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    fresh = llama.init(cfg, gen, device='cuda')
    same = all(torch.equal(a, b) for a, b in zip(
        trainer_lib.param_leaves(base), trainer_lib.param_leaves(fresh)))
    if not same:
        raise AssertionError('the frozen base changed during LoRA steps')
    del base, fresh
    release_card()
    rows = out['log']
    tps = [float(line.split(' tok/s')[0].split()[-1].replace(',', ''))
           for line in rows if ' tok/s ' in line][1:]
    flops = dataclasses.replace(cfg, max_seq_len=seq).train_flops_per_token()
    log(f'  losses {losses} (finite, falling); base bit-identical to its '
        f'seeded init; optimizer state {len(opt)} tensors, {opt_bytes} '
        f'bytes, all adapter-sized ({n_adapter} adapter parameters)')
    log(f'  steps 2-{steps}: {np.mean(tps):.1f} tokens/s, model '
        f'{np.mean(tps) * flops / 1e12:.2f} TFLOP/s by the 6N + 12LdS '
        f'formula (a LoRA step computes no weight gradient for the frozen '
        f'base); peak memory {peak / 2**30:.2f} GiB; {dt:.1f} s with init; '
        f'launches {out["launches"]} on {nvidia_smi_line()}')
    for name in TRAIN_KERNELS:
        records[name].setdefault('launches_by_path', {})['lora'] = (
            out['launches'][name])


def write_safetensors(path: str, tensors: dict) -> None:
    """A .safetensors file from {name: torch tensor} in a few lines of
    numpy: an 8-byte header length, a JSON header, raw little-endian
    bytes (bf16 as its uint16 bits)."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw, code = t.view(torch.int16).numpy().tobytes(), 'BF16'
        else:
            raw, code = t.float().numpy().astype('<f4').tobytes(), 'F32'
        header[name] = {'dtype': code, 'shape': list(t.shape),
                        'data_offsets': [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b' ' * (-len(text) % 8)
    with open(path, 'wb') as f:
        f.write(len(text).to_bytes(8, 'little'))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def random_hf_llama(root: str, cfg, dtype, seed: int) -> dict:
    """A random checkpoint in HF's layout for cfg's widths (config.json +
    model.safetensors), drawn on the card; returns the port's tree built
    directly from the same tensors (stacked, transposed to [in, out])."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    hd = cfg.head_dim

    def draw(out_dim, in_dim):
        return (torch.randn((out_dim, in_dim), generator=gen, device='cuda')
                * in_dim ** -0.5).to(dtype)

    def norm(d):
        return (1 + 0.1 * torch.randn((d,), generator=gen,
                                      device='cuda')).to(dtype)

    hf, layers = {}, {k: [] for k in (
        'wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down', 'attn_norm',
        'mlp_norm')}
    shapes = {'q_proj': ('wq', cfg.n_heads * hd, cfg.d_model),
              'k_proj': ('wk', cfg.n_kv_heads * hd, cfg.d_model),
              'v_proj': ('wv', cfg.n_kv_heads * hd, cfg.d_model),
              'o_proj': ('wo', cfg.d_model, cfg.n_heads * hd),
              'gate_proj': ('w_gate', cfg.d_ff, cfg.d_model),
              'up_proj': ('w_up', cfg.d_ff, cfg.d_model),
              'down_proj': ('w_down', cfg.d_model, cfg.d_ff)}
    for i in range(cfg.n_layers):
        for proj, (ours, o, n) in shapes.items():
            kind = 'self_attn' if ours in ('wq', 'wk', 'wv', 'wo') else 'mlp'
            w = draw(o, n)
            hf[f'model.layers.{i}.{kind}.{proj}.weight'] = w
            layers[ours].append(w.t())
        for hf_name, ours in (('input_layernorm', 'attn_norm'),
                              ('post_attention_layernorm', 'mlp_norm')):
            w = norm(cfg.d_model)
            hf[f'model.layers.{i}.{hf_name}.weight'] = w
            layers[ours].append(w)
    hf['model.embed_tokens.weight'] = draw(cfg.vocab_size, cfg.d_model)
    hf['model.norm.weight'] = norm(cfg.d_model)
    hf['lm_head.weight'] = draw(cfg.vocab_size, cfg.d_model)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, 'config.json'), 'w',
              encoding='utf-8') as f:
        json.dump({'model_type': 'llama', 'architectures':
                   ['LlamaForCausalLM'], 'vocab_size': cfg.vocab_size,
                   'hidden_size': cfg.d_model, 'num_hidden_layers':
                   cfg.n_layers, 'num_attention_heads': cfg.n_heads,
                   'num_key_value_heads': cfg.n_kv_heads,
                   'intermediate_size': cfg.d_ff,
                   'max_position_embeddings': cfg.max_seq_len,
                   'rope_theta': cfg.rope_theta, 'rms_norm_eps':
                   cfg.norm_eps, 'tie_word_embeddings': False,
                   'torch_dtype': str(dtype).split('.')[-1]}, f)
    write_safetensors(os.path.join(root, 'model.safetensors'), hf)
    direct = {'embed': hf['model.embed_tokens.weight'],
              'layers': {k: torch.stack(v).contiguous()
                         for k, v in layers.items()},
              'final_norm': hf['model.norm.weight'],
              'lm_head': hf['lm_head.weight'].t().contiguous()}
    del hf
    return direct


HF_SERVE_KERNELS = ('flash_fwd', 'decode_attention')


# [18]'s depth: 4 of Llama-3-1B's 16 layers (the script's time limit
# took half when phase 38 was added, half again with 39; the converter's
# work is per layer).
HF_LAYERS = 4


def hf_checkpoint_path(records: dict) -> None:
    import tempfile
    import threading
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train.trainer import param_leaves
    cfg = dataclasses.replace(llama.LLAMA3_1B, n_layers=HF_LAYERS,
                              remat=False)
    new_tokens = 24
    log(f'[18] converter and --hf-checkpoint: a random Llama-3-1B '
        f'({cfg.n_layers} of its 16 layers) in HF\'s layout (config.json + '
        'bf16 safetensors written with numpy), converted, and served by '
        'infer/server.py --hf-checkpoint on 127.0.0.1; greedy tokens '
        'against Orchestrator.generate on the tree built directly')
    with tempfile.TemporaryDirectory(prefix='xsky-hf-') as tmp:
        root = os.path.join(tmp, 'llama-3-1b-random')
        t0 = time.perf_counter()
        direct = random_hf_llama(root, cfg, torch.bfloat16, seed=18)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(root, 'model.safetensors'))
        t0 = time.perf_counter()
        converted_cfg, converted = convert.from_hf(root, device='cuda')
        torch.cuda.synchronize()
        t_convert = time.perf_counter() - t0
        if dataclasses.replace(converted_cfg, remat=False) != cfg:
            raise AssertionError(f'converted config {converted_cfg}')
        same = all(torch.equal(a, b) for a, b in zip(
            param_leaves(converted), param_leaves(direct)))
        if not same:
            raise AssertionError('the converted tree differs from the tree '
                                 'built directly')
        del converted
        release_card()
        zero_launches()
        t0 = time.perf_counter()
        replica = server_lib.build_replica(server_lib.parse_args([
            '--hf-checkpoint', root, '--max-slots', '4', '--max-target-len',
            '2048', '--port', '0', '--device', 'cuda']), host='127.0.0.1')
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    rng = np.random.default_rng(18)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (16, 300, 1000)]
    try:
        model_id = json.loads(http_json(url, '/v1/models'))['data'][0]['id']
        served = [http_json(url, '/generate', {
            'prompt_tokens': p, 'max_new_tokens': new_tokens})[
                'output_tokens'] for p in prompts]
        # The served path's own launches (build, warm-up, the requests),
        # read before the comparison run below launches anything.
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        check_launches('hf-checkpoint serving', launches, HF_SERVE_KERNELS,
                       cfg.n_layers)
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()
    del replica
    release_card()
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=4, max_target_len=2048),
        direct, device='cuda')
    orch = orch_lib.Orchestrator(engine, decode_steps=4)
    built = [orch.generate([p], max_new_tokens=new_tokens)[0]
             for p in prompts]
    del orch, engine, direct
    release_card()
    if model_id != 'llama-3-1b-random':
        raise AssertionError(f'/v1/models id {model_id!r}')
    if served != built:
        raise AssertionError(f'served tokens {served} differ from the '
                             f'directly built tree\'s {built}')
    for name in HF_SERVE_KERNELS:
        records[name].setdefault('launches_by_path', {})['hf_checkpoint'] = (
            launches[name])
    log(f'  checkpoint {size} bytes written in {t_write:.2f} s; from_hf '
        f'{t_convert:.2f} s (read, stack, cast on the card), equal bit for '
        f'bit to the tree built directly; server build (conversion on the '
        f'host + engine + warm-up) {t_build:.2f} s; model id {model_id!r}')
    log(f'  prompts of {[len(p) for p in prompts]} tokens, {new_tokens} new '
        f'each, one at a time: served tokens equal Orchestrator.generate on '
        f'the directly built tree; served launches {launches} on '
        f'{nvidia_smi_line()}')


def small_launch_checks() -> None:
    import tempfile
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train.trainer import param_leaves
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    seq = 1024
    log(f'[19] small checks, card vs CPU: fp32 LLAMA_TINY widths, seq {seq} '
        '(so the flash kernels run on the card): the converter\'s trees, '
        'three launcher steps from one --init-params and --data, and three '
        'LoRA steps')
    with tempfile.TemporaryDirectory(prefix='xsky-small-') as tmp, \
            registered_config('tiny-fp32', cfg) as name:
        root = os.path.join(tmp, 'hf')
        random_hf_llama(root, cfg, torch.float32, seed=19)
        trees = {}
        for dtype in (torch.float32, torch.bfloat16):
            for device in ('cuda', 'cpu'):
                trees[dtype, device] = param_leaves(
                    convert.from_hf(root, dtype, device=device)[1])
            if not all(torch.equal(a.cpu(), b) for a, b in zip(
                    trees[dtype, 'cuda'], trees[dtype, 'cpu'])):
                raise AssertionError(f'{dtype} trees differ between the '
                                     'card and the CPU')
        init = os.path.join(tmp, 'init')
        printed = io.StringIO()   # stdout keeps only the result lines
        with contextlib.redirect_stdout(printed):
            convert.main(['--src', root, '--out', init, '--dtype', 'f32',
                          '--device', 'cpu'])
        log(f'  convert.main: {printed.getvalue().strip()}')
        data = write_token_shards(os.path.join(tmp, 'tokens'),
                                  3 * 2 * seq + 1, cfg.vocab_size, seed=19)
        common = ['--model', name, '--global-batch-size', '2', '--seq-len',
                  str(seq), '--steps', '3', '--log-every', '1',
                  '--learning-rate', '1e-3', '--init-params', init,
                  '--data', data, '--data-loader', 'python']
        for label, extra in (('full', ['--optimizer', 'adamw']),
                             ('LoRA', ['--lora-rank', '4', '--optimizer',
                                       'adamw'])):
            runs = {}
            for device in ('cuda', 'cpu'):
                with short_warmup(1):
                    out = launch_run(common + extra + ['--device', device],
                                     f'small {label} on {device}',
                                     kernels_wanted=None)
                runs[device] = (out['losses'], out['launches'])
            losses = {d: [runs[d][0][k] for k in (1, 2, 3)] for d in runs}
            used = runs['cuda'][1]
            log(f'  {label}: card losses {losses['cuda']}, CPU '
                f'{losses["cpu"]} (atol {TRAIN_LOSS_ATOL:g}); card launches '
                f'{ {k: used[k] for k in TRAIN_KERNELS} }')
            if max(abs(a - b) for a, b in zip(losses['cuda'],
                                              losses['cpu'])) > \
                    TRAIN_LOSS_ATOL:
                raise AssertionError(f'{label} losses differ between the '
                                     'card and the CPU')
            if not all(used[k] for k in TRAIN_KERNELS):
                raise AssertionError(f'a kernel did not run: {used}')
    log('  converter trees (fp32 and bf16) equal bit for bit on the card '
        'and the CPU')
    release_card()


# ---- phases 20-22: the Qwen family ----

# serve_qwen.yaml's replica without its speculative flags, which phase 23
# adds: 32 slots over a 4096-row cache, 32 concurrent prompts
# of 1000-1024 tokens (so the prefill waves take the flash kernel's 1024
# bucket), 32 new tokens each (64 until the script's time limit took
# half when phase 38 was added).
QWEN_SERVE = dict(slots=32, max_len=4096, requests=32, new_tokens=16)


def qwen_replica(records: dict) -> dict:
    import threading
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import qwen
    cfg = qwen.QWEN3_8B
    r = QWEN_SERVE
    log(f'[20] serve_qwen.yaml on one card, without --spec-ngram (phase '
        f'[23] adds it): Qwen3-8B bf16 ({cfg.n_layers} layers, d_model '
        f'{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim '
        f'{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, QK-norm, '
        f'rope theta {cfg.rope_theta:g}; {cfg.num_params() / 1e9:.2f} B '
        f'parameters), seeded random weights; infer/server.py --model '
        f'qwen3-8b --max-slots {r["slots"]} --max-target-len {r["max_len"]} '
        'on 127.0.0.1')
    t0 = time.perf_counter()
    replica = server_lib.build_replica(server_lib.parse_args([
        '--model', 'qwen3-8b', '--max-slots', str(r['slots']),
        '--max-target-len', str(r['max_len']), '--port', '0',
        '--device', 'cuda']), host='127.0.0.1')
    torch.cuda.synchronize()
    log(f'  init + engine + warm-up {time.perf_counter() - t0:.2f} s; '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    rng = np.random.default_rng(20)
    singles = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (16, 300, 1000)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(1000, 1025, r['requests'])]
    try:
        # The served requests' own launches: counted from here (after the
        # warm-up) and read before anything else runs on the engine.
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        served = [http_json(url, '/generate', {
            'prompt_tokens': p, 'max_new_tokens': r['new_tokens']})[
                'output_tokens'] for p in singles]
        before = http_json(url, '/metrics')
        _, dt = concurrent_generate(url, [
            {'prompt_tokens': p, 'max_new_tokens': r['new_tokens']}
            for p in prompts], cfg.vocab_size)
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        after = http_json(url, '/metrics')
        check_launches('qwen3-8b replica', launches, SERVE_KERNELS,
                       cfg.n_layers)
        for name in SERVE_KERNELS:
            records[name].setdefault('launches_by_path', {})[
                'qwen_serve'] = launches[name]
        ttft_n = (metric(after, 'xsky_serve_ttft_seconds_count')
                  - metric(before, 'xsky_serve_ttft_seconds_count'))
        ttft_s = (metric(after, 'xsky_serve_ttft_seconds_sum')
                  - metric(before, 'xsky_serve_ttft_seconds_sum'))
        if ttft_n != r['requests']:
            raise AssertionError(f'{ttft_n} TTFT samples for '
                                 f'{r["requests"]} requests')
        peak = torch.cuda.max_memory_allocated() / 2**30
        # The server adds nothing: the prompts sent one at a time give the
        # tokens of Orchestrator.generate on the same engine, run with the
        # serving loop held.
        with replica.loop._lock:
            direct = [replica.loop.orch.generate(
                [p], max_new_tokens=r['new_tokens'])[0] for p in singles]
        if served != direct:
            raise AssertionError('the server gave other tokens than '
                                 'Orchestrator.generate')
        out_tokens = r['requests'] * r['new_tokens']
        numbers = {'tok_s': out_tokens / dt,
                   'ttft_ms': ttft_s / ttft_n * 1e3, 'peak_gib': peak}
        log(f'  prompts of {[len(p) for p in singles]} tokens one at a time: '
            'the served tokens equal Orchestrator.generate on the same '
            'engine')
        log(f'  {r["requests"]} concurrent POST /generate (prompts of '
            f'{min(map(len, prompts))}-{max(map(len, prompts))} tokens) x '
            f'{r["new_tokens"]} tokens in {dt:.3f} s: {out_tokens / dt:.1f} '
            f'output tok/s, mean TTFT {ttft_s / ttft_n * 1e3:.1f} ms '
            f'(/metrics), peak memory {peak:.2f} GiB; served launches '
            f'{launches} on {nvidia_smi_line()}')
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()
    del replica
    release_card()
    return numbers


def qwen2_main_path(records: dict) -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import qwen
    cfg = qwen.QWEN2_7B
    log(f'[21] Qwen2-7B bf16 ({cfg.n_layers} layers, d_model {cfg.d_model}, '
        f'{cfg.n_heads}/{cfg.n_kv_heads} heads: GQA group '
        f'{cfg.n_heads // cfg.n_kv_heads}, Q/K/V biases, vocab '
        f'{cfg.vocab_size}; {cfg.num_params() / 1e9:.2f} B parameters), '
        'seeded random weights, InferenceEngine + Orchestrator: 16 slots, '
        'max_target_len 2048, bucket 1024')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(21)
    t0 = time.perf_counter()
    params = qwen.init(cfg, gen)
    torch.cuda.synchronize()
    log(f'  init {time.perf_counter() - t0:.2f} s, '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=16,
                                max_target_len=2048,
                                prefill_buckets=(1024,)), params)
    orch = orch_lib.Orchestrator(engine, decode_steps=8)
    rng = np.random.default_rng(21)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(1000, 1025, 16)]
    new_tokens = 32
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, new_tokens)
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('qwen2-7b serving', launches, SERVE_KERNELS, cfg.n_layers)
    for name in SERVE_KERNELS:
        records[name].setdefault('launches_by_path', {})['qwen2_serve'] = (
            launches[name])
    out_tokens = sum(len(r.output_tokens) for r in requests)
    log(f'  16 requests x {new_tokens} tokens done in {dt:.3f} s: '
        f'{out_tokens / dt:.1f} output tok/s, mean TTFT '
        f'{mean_ms(requests):.1f} ms, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
        f'launches {launches} on {nvidia_smi_line()}')
    del orch, engine, params
    release_card()


# Loss and gradients of the small Qwen models, card against CPU: fp32 sums
# in another order, the flash kernels' against the plain versions'; [19]'s
# tolerance.
QWEN_GRAD_ATOL = 1e-4


def small_qwen_params(cfg, seed: int):
    """The port's init for cfg on the CPU, with the Qwen leaves drawn too
    (biases 0.1 N(0, 1), norm scales 1 + 0.2 N(0, 1)): zero biases and
    unit scales would not show a misplaced one, and larger V biases swamp
    the attention output over ~1000-token prompts, so that every prompt
    gives the same greedy tokens."""
    from skypilot_tpu_torch.models import qwen
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = qwen.init(cfg, gen, device='cpu')
    for key, value in params['layers'].items():
        if key in ('bq', 'bk', 'bv'):
            value.copy_(0.1 * torch.randn(value.shape, generator=gen))
        elif key in ('q_norm', 'k_norm'):
            value.copy_(1 + 0.2 * torch.randn(value.shape, generator=gen))
    return params


def small_qwen_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import qwen
    from skypilot_tpu_torch.train.trainer import param_leaves
    log('[22] small Qwen checks, card (kernels) vs CPU (plain versions): '
        'fp32 qwen-tiny (Q/K/V biases) and qwen3-tiny (QK-norm) widths with '
        'random biases and norm scales, bucket 1024 (so the flash kernel '
        'runs): served greedy tokens; a chunked prefill with a prefix-cache '
        'hit against the whole prompt in one 2048 bucket; loss_fn and its '
        'gradients at seq 1024')
    for cfg in (qwen.QWEN_TINY_F32, qwen.QWEN3_TINY_F32):
        label = 'qwen-tiny' if cfg.qkv_bias else 'qwen3-tiny'
        cpu_params = small_qwen_params(cfg, seed=22)
        rng = np.random.default_rng(22)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                   for n in (1024, 700, 913, 1000, 64)]
        long = [int(t) for t in rng.integers(0, cfg.vocab_size, 1500)]
        hit = long[:1200] + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                          100)]
        tokens = rng.integers(0, cfg.vocab_size, (2, 1024))

        def generate(device, prompt_list, new_tokens, one_by_one=False,
                     **kw):
            """Greedy tokens of an engine of its own, and its prefix-cache
            statistics. one_by_one: each prompt after the one before has
            finished, so that a later prompt can hit an earlier one's
            cache entry."""
            engine = engine_lib.InferenceEngine(
                engine_lib.EngineConfig(model=cfg, max_slots=4,
                                        kv_dtype=torch.float32, **kw),
                to_device(cpu_params, device), device=device)
            orch = orch_lib.Orchestrator(engine, decode_steps=4)
            groups = ([[p] for p in prompt_list] if one_by_one
                      else [prompt_list])
            out = [t for group in groups
                   for t in orch.generate(group, max_new_tokens=new_tokens)]
            return out, engine.prefix_cache_stats

        runs, used = {}, {}
        for device in ('cuda', 'cpu'):
            before = {k.name: k.launches for k in kernels.REGISTRY}
            served = generate(device, prompts, 12, max_target_len=1040,
                              prefill_buckets=(1024,))[0]
            chunked, stats = generate(device, [long, hit], 8,
                                      one_by_one=True, max_target_len=2100,
                                      prefill_buckets=(1024,),
                                      prefix_cache_entries=4)
            whole = generate(device, [long, hit], 8, max_target_len=2100,
                             prefill_buckets=(2048,))[0]
            params = {k: ({kk: vv.to(device, copy=True)
                           for kk, vv in v.items()} if isinstance(v, dict)
                          else v.to(device, copy=True))
                      for k, v in cpu_params.items()}
            for leaf in param_leaves(params):
                leaf.requires_grad_(True)
            batch = torch.from_numpy(tokens).to(device)
            loss = qwen.loss_fn(cfg, params, batch, batch.roll(-1, 1))
            loss.backward()
            used[device] = {k.name: k.launches - before[k.name]
                            for k in kernels.REGISTRY}
            runs[device] = dict(served=served, chunked=chunked,
                                whole=whole, stats=stats,
                                loss=float(loss.detach()),
                                grads=[p.grad.cpu()
                                       for p in param_leaves(params)])
        card, cpu = runs['cuda'], runs['cpu']
        grad_err = max(float((a - b).abs().max()) for a, b in zip(
            card['grads'], cpu['grads']))
        log(f'  {label}: card tokens {card["served"]}; chunked + prefix '
            f'hit {card["chunked"]} ({card["stats"]}); loss card '
            f'{card["loss"]!r} CPU {cpu["loss"]!r}, largest gradient error '
            f'{grad_err:.3e} (atol {QWEN_GRAD_ATOL:g}); card launches '
            f'{used["cuda"]}')
        for key in ('served', 'chunked', 'whole', 'stats'):
            if card[key] != cpu[key]:
                raise AssertionError(f'{label}: {key} differs between the '
                                     f'card and the CPU')
        for device, run in runs.items():
            if run['chunked'] != run['whole'] or not run['stats']['hits']:
                raise AssertionError(
                    f'{label} on {device}: the chunked prefill with a '
                    f'prefix-cache hit gave {run["chunked"]}, the whole '
                    f'prompt {run["whole"]} ({run["stats"]})')
        if abs(card['loss'] - cpu['loss']) > TRAIN_LOSS_ATOL or \
                grad_err > QWEN_GRAD_ATOL:
            raise AssertionError(f'{label}: loss or gradients differ '
                                 'between the card and the CPU')
        if not all(used['cuda'][name] for name in TRAIN_KERNELS + (
                'decode_attention',)):
            raise AssertionError(f'a kernel did not run on the card: '
                                 f'{used["cuda"]}')
    release_card()


# ---- phases 23-25: speculative decoding ----

SPEC_GAMMA = 4
# The sampled request of [23] and [24]: its rounds are plain (only greedy
# rounds speculate), so that both kinds run in one served run.
SAMPLED_NEW = 16
# New tokens of the prompts [23] and [24] send one at a time (64 until
# phase 38 took the time).
SPEC_SINGLE_NEW = 32
DRAFT_SERVE = dict(slots=16, max_len=2048, requests=16, new_tokens=16)
# A self-draft with the target's own weights: bf16 near-ties between the
# decode kernel's and the verify pass's logits are the only rejections.
SELF_DRAFT_MIN_ACCEPT = 0.5


def count_plain_rounds(orch) -> list:
    """Wrap a speculator's _decode_tick, through which its plain rounds
    go, so that a run can count them; each is one decode step of every
    slot."""
    rounds = [0]
    tick = orch._decode_tick

    def counted():
        rounds[0] += 1
        tick()

    orch._decode_tick = counted
    return rounds


def flash_prefills(engine, prompts) -> int:
    """How many of these prompts a one-at-a-time admission prefills
    through the flash kernel (their bucket reaches its shortest
    sequence; one launch per layer each)."""
    from skypilot_tpu_torch.ops import attention
    return sum(engine.bucket_for(len(p)) >= attention._FLASH_MIN_SEQ
               for p in prompts)


def check_derived_launches(path: str, launches: dict, want: dict) -> None:
    """Each kernel ran exactly as often as derived from the run's rounds
    and prefills; every other kernel not at all."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f'{name}: {n} launches on the {path} path; '
                                 f'derived {want.get(name, 0)} '
                                 f'(all derived: {want})')


def path_logits(engine, prefix):
    """The fp32 logits [V] for the token after ``prefix`` through the
    two numeric paths, on a one-slot scratch cache whose rows before the
    last token one verify_hidden pass fills: decode_forward (the decode
    kernel, as plain rounds run it) and verify_forward (the verify
    pass's plain attention)."""
    c = engine.config.model
    lib = engine._model_lib
    dev = engine.device
    n = len(prefix)
    shape = (c.n_layers, 1, engine.config.max_target_len, c.n_kv_heads,
             c.head_dim)
    kv = {key: torch.zeros(shape, dtype=engine.config.kv_dtype, device=dev)
          for key in ('k', 'v')}
    tokens = torch.tensor([prefix], device=dev)
    last = torch.tensor([n - 1], device=dev)
    with torch.no_grad():
        lib.verify_hidden(c, engine.params, tokens[:, :-1],
                          torch.arange(n - 1, device=dev)[None], kv)
        dec, _ = lib.decode_forward(c, engine.params, tokens[:, -1], last,
                                    kv)
        ver, _ = lib.verify_forward(c, engine.params, tokens[:, -1:],
                                    last[None], kv)
    return dec[0], ver[0, 0]


def check_ties(label: str, engine, prompts, spec_streams,
               plain_streams) -> int:
    """Each greedy stream of the speculative run equals the plain run's,
    or parts from it at a tie: at the first token where the two differ,
    the plain path's logit margin between the two tokens is at most
    twice the largest difference, over that row, between the decode and
    verify paths' logits at that position. → the number of partings."""
    partings = []
    for prompt, got, want in zip(prompts, spec_streams, plain_streams):
        if got == want:
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        dec, ver = path_logits(engine, list(prompt) + list(want[:j]))
        margin = abs(float(dec[want[j]] - dec[got[j]]))
        diff = float((ver - dec).abs().max())
        partings.append((j, margin, diff))
        if margin > 2 * diff:
            raise AssertionError(
                f'{label}: the speculative stream parts from plain greedy '
                f'at token {j} ({got[j]} for {want[j]}) with a plain margin '
                f'of {margin:.6f} > 2 x the paths\' largest logit '
                f'difference {diff:.6f}: not a tie')
    log(f'  {label}: {len(partings)} of {len(plain_streams)} greedy streams '
        'part from plain greedy decoding on the same engine, each at a '
        'tie (token, plain margin, paths\' largest logit difference): '
        f'{[(j, round(m, 6), round(d, 6)) for j, m, d in partings]}')
    return len(partings)


def plain_streams(engine, prompts, new_tokens: int):
    """Plain greedy decoding of ``prompts`` on ``engine``, admitted one at
    a time as the speculators admit them (so that both runs prefill with
    the same numerics)."""
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    plain = orch_lib.Orchestrator(engine, decode_steps=4)
    plain._batched_admit = False
    requests, _ = serve_and_check(plain, engine.config.model, prompts,
                                  new_tokens)
    return [r.output_tokens for r in requests]


def spec_counters(text: str) -> dict:
    return {key: metric(text, f'xsky_serve_spec_{key}_total')
            for key in ('rounds', 'proposed', 'accepted')}


def serve_speculative(label: str, records: dict, path: str, url: str, orch,
                      loop, singles, bodies, want_launches):
    """The speculative replica's checks and numbers: singles one at a
    time (served tokens = the speculator's own generate, loop lock held),
    then ``bodies`` at once; launch counts from these requests alone,
    checked against ``want_launches(plain_rounds, spec_rounds)``.
    → (streams, numbers)."""
    cfg = orch.engine.config.model
    with loop._lock:
        plain_rounds = count_plain_rounds(orch)
        rounds0 = orch.accept_stats['rounds']
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
    t0 = time.perf_counter()
    served = [http_json(url, '/generate', {
        'prompt_tokens': p, 'max_new_tokens': SPEC_SINGLE_NEW})[
            'output_tokens'] for p in singles]
    singles_s = time.perf_counter() - t0
    before = http_json(url, '/metrics')
    streams, dt = concurrent_generate(url, bodies, cfg.vocab_size)
    with loop._lock:
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        n_plain = plain_rounds[0]
        n_spec = orch.accept_stats['rounds'] - rounds0
        totals = dict(orch.accept_stats)
    after = http_json(url, '/metrics')
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_derived_launches(path, launches, want_launches(n_plain, n_spec))
    if not n_plain or not n_spec:
        raise AssertionError(f'{label}: {n_plain} plain and {n_spec} '
                             'speculative rounds; both kinds must run')
    for name, n in launches.items():
        if n:
            records[name].setdefault('launches_by_path', {})[path] = n
    if spec_counters(after) != totals:
        raise AssertionError(f'/metrics spec counters {spec_counters(after)}'
                             f', accept_stats {totals}')
    spec = {key: spec_counters(after)[key] - spec_counters(before)[key]
            for key in totals}
    ttft_n = (metric(after, 'xsky_serve_ttft_seconds_count')
              - metric(before, 'xsky_serve_ttft_seconds_count'))
    ttft_s = (metric(after, 'xsky_serve_ttft_seconds_sum')
              - metric(before, 'xsky_serve_ttft_seconds_sum'))
    if ttft_n != len(bodies):
        raise AssertionError(f'{ttft_n} TTFT samples for {len(bodies)} '
                             'requests')
    t0 = time.perf_counter()
    with loop._lock:
        # Both prompts in one run: a round verifies (or drafts for) every
        # slot at the same shapes, and each slot's rows are its own, so a
        # greedy stream does not depend on the other prompt.
        direct = orch.generate(list(singles),
                               max_new_tokens=SPEC_SINGLE_NEW)
    direct_s = time.perf_counter() - t0
    if served != direct:
        raise AssertionError(f'{label}: the server gave other tokens than '
                             'the speculator\'s own generate')
    out_tokens = sum(b['max_new_tokens'] for b in bodies)
    numbers = {'tok_s': out_tokens / dt, 'ttft_ms': ttft_s / ttft_n * 1e3,
               'peak_gib': peak, 'spec': spec,
               'acceptance': spec['accepted'] / max(spec['proposed'], 1),
               'plain_rounds': n_plain, 'spec_rounds': n_spec}
    log(f'  prompts of {[len(p) for p in singles]} tokens one at a time '
        f'({singles_s:.1f} s): the served tokens equal the speculator\'s own '
        f'generate ({direct_s:.1f} s)')
    log(f'  {len(bodies)} concurrent POST /generate ({out_tokens} tokens) in '
        f'{dt:.3f} s: {numbers["tok_s"]:.1f} output tok/s, mean TTFT '
        f'{numbers["ttft_ms"]:.1f} ms (/metrics), peak memory {peak:.2f} '
        f'GiB; the concurrent run\'s /metrics '
        f'xsky_serve_spec_{{rounds,proposed,accepted}}_total grew by '
        f'{spec["rounds"]:.0f}, {spec["proposed"]:.0f}, '
        f'{spec["accepted"]:.0f} (acceptance {numbers["acceptance"]:.4f}); '
        f'with the singles, {n_spec} speculative and {n_plain} plain rounds '
        f'and launches {launches} as derived, on {nvidia_smi_line()}')
    return streams, numbers


def spec_qwen_replica(records: dict, plain: dict) -> None:
    import threading
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import qwen
    cfg = qwen.QWEN3_8B
    r = QWEN_SERVE
    log(f'[23] serve_qwen.yaml as written: infer/server.py --model qwen3-8b '
        f'--max-slots {r["slots"]} --max-target-len {r["max_len"]} '
        f'--spec-ngram --spec-gamma {SPEC_GAMMA} on 127.0.0.1 (Qwen3-8B '
        f'bf16 at its published widths, seeded random weights)')
    t0 = time.perf_counter()
    replica = server_lib.build_replica(server_lib.parse_args([
        '--model', 'qwen3-8b', '--max-slots', str(r['slots']),
        '--max-target-len', str(r['max_len']), '--spec-ngram',
        '--spec-gamma', str(SPEC_GAMMA), '--port', '0',
        '--device', 'cuda']), host='127.0.0.1')
    torch.cuda.synchronize()
    orch, engine = replica.loop.orch, replica.engine
    if not isinstance(orch, orch_lib.NgramSpeculator):
        raise AssertionError(f'--spec-ngram built a {type(orch).__name__}')
    log(f'  init + engine + warm-up {time.perf_counter() - t0:.2f} s; '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    rng = np.random.default_rng(23)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(1000, 1025, r['requests'])]
    # Copy-heavy: a 64-token block repeated 8 times.
    copies = [[int(t) for t in rng.integers(0, cfg.vocab_size, 64)] * 8
              for _ in range(4)]
    sampled = [int(t) for t in rng.integers(0, cfg.vocab_size, 1000)]
    greedy = prompts + copies
    bodies = ([{'prompt_tokens': p, 'max_new_tokens': r['new_tokens']}
               for p in greedy]
              + [{'prompt_tokens': sampled, 'max_new_tokens': SAMPLED_NEW,
                  'temperature': 1.0}])
    singles = [prompts[0], copies[0]]
    n_flash = flash_prefills(engine, singles + greedy + [sampled])

    def want(n_plain, n_spec):
        del n_spec   # verify passes take the plain attention
        return {'flash_fwd': cfg.n_layers * n_flash,
                'decode_attention': cfg.n_layers * n_plain}

    try:
        streams, numbers = serve_speculative(
            '[23]', records, 'qwen_spec_ngram', url, orch, replica.loop,
            singles, bodies, want)
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()
    orch.state = None      # the plain run below needs the room
    release_card()
    t0 = time.perf_counter()
    expected = plain_streams(engine, greedy, r['new_tokens'])
    plain_s = time.perf_counter() - t0
    partings = check_ties('[23]', engine, greedy,
                          streams[:len(greedy)], expected)
    log(f'  [23] plain greedy re-run of the {len(greedy)} greedy prompts '
        f'{plain_s:.1f} s, tie checks {time.perf_counter() - t0 - plain_s:.1f}'
        ' s')
    log(f'  [23] beside [20] (same model, slots, cache and 32 prompts; [23] '
        f'adds 4 copy-heavy and 1 sampled request): output tok/s '
        f'{numbers["tok_s"]:.1f} vs {plain["tok_s"]:.1f}, mean TTFT '
        f'{numbers["ttft_ms"]:.1f} vs {plain["ttft_ms"]:.1f} ms, peak '
        f'{numbers["peak_gib"]:.2f} vs {plain["peak_gib"]:.2f} GiB; '
        f'acceptance {numbers["acceptance"]:.4f}; {partings} tie partings')
    del replica, orch, engine
    release_card()


def draft_model_paths(records: dict) -> None:
    import threading
    from http.server import ThreadingHTTPServer
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import llama
    r = DRAFT_SERVE
    target_cfg = dataclasses.replace(llama.LLAMA3_8B, remat=False)
    small = llama.LLAMA3_1B
    log(f'[24] draft-model speculation, gamma {SPEC_GAMMA}: --model llama3-8b '
        f'--draft-model llama3-1b is refused, as the reference refuses it '
        f'(the repo\'s llama3-1b has a {small.vocab_size}-token vocabulary, '
        f'Llama-3-8B {target_cfg.vocab_size})')
    argv = ['--model', 'llama3-8b', '--draft-model', 'llama3-1b',
            '--spec-gamma', str(SPEC_GAMMA), '--max-slots', str(r['slots']),
            '--max-target-len', str(r['max_len']), '--port', '0',
            '--device', 'cuda']
    try:
        server_lib.build_replica(server_lib.parse_args(argv),
                                 host='127.0.0.1')
    except ValueError as e:
        if str(e) != 'draft/target vocab_size must match':
            raise
        log(f'  refused: ValueError({str(e)!r})')
    else:
        raise AssertionError('--draft-model llama3-1b was not refused')
    release_card()

    draft_cfg = dataclasses.replace(small, vocab_size=target_cfg.vocab_size,
                                    remat=False)
    log(f'  served instead: Llama-3-8B (bf16, {target_cfg.n_layers} layers, '
        f'seed 0) with a draft at llama3-1b\'s widths ({draft_cfg.n_layers} '
        f'layers, d_model {draft_cfg.d_model}) and Llama-3\'s '
        f'{draft_cfg.vocab_size}-token vocabulary (seed 1), as the server '
        f'wires --draft-model: SpeculativeOrchestrator, warm_up, '
        f'ServingLoop and the HTTP handler on 127.0.0.1; {r["slots"]} '
        f'slots, max_target_len {r["max_len"]}')
    t0 = time.perf_counter()
    engines = []
    for cfg, seed in ((target_cfg, 0), (draft_cfg, 1)):
        gen = torch.Generator(device='cuda')
        gen.manual_seed(seed)
        engines.append(engine_lib.InferenceEngine(
            engine_lib.EngineConfig(model=cfg, max_slots=r['slots'],
                                    max_target_len=r['max_len']),
            llama.init(cfg, gen)))
    engine, draft = engines
    orch = orch_lib.SpeculativeOrchestrator(engine, draft, gamma=SPEC_GAMMA)
    server_lib.warm_up(orch)
    loop = server_lib.ServingLoop(orch)
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), server_lib.build_handler(
        loop, engine.config, model_id='llama3-8b', max_queue=64))
    torch.cuda.synchronize()
    log(f'  init + engines + warm-up {time.perf_counter() - t0:.2f} s; '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{httpd.server_address[1]}'
    rng = np.random.default_rng(24)
    # 960-1024 tokens, so that both engines prefill in the flash kernel's
    # 1024 bucket.
    prompts = [[int(t) for t in rng.integers(0, target_cfg.vocab_size, n)]
               for n in rng.integers(960, 1025, r['requests'])]
    sampled = [int(t) for t in rng.integers(0, target_cfg.vocab_size, 1000)]
    bodies = ([{'prompt_tokens': p, 'max_new_tokens': r['new_tokens']}
               for p in prompts]
              + [{'prompt_tokens': sampled, 'max_new_tokens': SAMPLED_NEW,
                  'temperature': 1.0}])
    singles = [prompts[0]]
    n_flash = flash_prefills(engine, singles + prompts + [sampled])

    def want(n_plain, n_spec):
        return {'flash_fwd': (target_cfg.n_layers + draft_cfg.n_layers)
                * n_flash,
                'decode_attention': draft_cfg.n_layers * (SPEC_GAMMA + 1)
                * n_spec + target_cfg.n_layers * n_plain}

    try:
        streams, numbers = serve_speculative(
            '[24]', records, 'llama_spec_draft', url, orch, loop, singles,
            bodies, want)
    finally:
        httpd.shutdown()
        httpd.server_close()
        loop.close()
    orch.state = orch.draft_state = None
    release_card()
    expected = plain_streams(engine, prompts, r['new_tokens'])
    check_ties('[24]', engine, prompts, streams[:len(prompts)], expected)
    del orch, loop, httpd, engine, draft, engines
    release_card()

    cfg = dataclasses.replace(small, remat=False)
    log(f'  self-draft: Llama-3-1B (llama3-1b, bf16, {cfg.n_layers} layers, '
        f'seed 0) drafting for itself (one engine, two caches), '
        f'{r["slots"]} slots, {r["requests"]} prompts of 960-1024 tokens x '
        f'{r["new_tokens"]} new')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=r['slots'],
                                max_target_len=r['max_len']),
        llama.init(cfg, gen))
    orch = orch_lib.SpeculativeOrchestrator(engine, engine, gamma=SPEC_GAMMA)
    plain_rounds = count_plain_rounds(orch)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(960, 1025, r['requests'])]
    zero_launches()
    requests, dt = serve_and_check(orch, cfg, prompts, r['new_tokens'])
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    stats = orch.accept_stats
    check_derived_launches('llama3-1b self-draft', launches, {
        'flash_fwd': 2 * cfg.n_layers * flash_prefills(engine, prompts),
        'decode_attention': cfg.n_layers * (
            (SPEC_GAMMA + 1) * stats['rounds'] + plain_rounds[0])})
    for name, n in launches.items():
        if n:
            records[name].setdefault('launches_by_path', {})[
                'llama_spec_self_draft'] = n
    acceptance = stats['accepted'] / stats['proposed']
    out_tokens = sum(len(q.output_tokens) for q in requests)
    log(f'  self-draft: {out_tokens / dt:.1f} output tok/s, {stats} '
        f'(acceptance {acceptance:.4f}, at least {SELF_DRAFT_MIN_ACCEPT}); '
        f'launches {launches} as derived, on {nvidia_smi_line()}')
    if acceptance < SELF_DRAFT_MIN_ACCEPT:
        raise AssertionError(f'self-draft acceptance {acceptance:.4f} < '
                             f'{SELF_DRAFT_MIN_ACCEPT}')
    del orch, engine
    release_card()


def small_speculative_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import qwen
    log('[25] small speculative checks, card (kernels, TF32 off) vs CPU '
        '(plain versions): fp32 LLAMA_TINY and qwen3-tiny targets, bucket '
        '1024 (so the flash kernel runs); NgramSpeculator, '
        'SpeculativeOrchestrator with a one-layer draft and with the target '
        'drafting for itself: tokens and accept_stats')
    draft_cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32,
                                    n_layers=1, d_model=32, n_heads=2,
                                    n_kv_heads=2, d_ff=64)
    gen = torch.Generator()
    gen.manual_seed(26)
    draft_params = llama.init(draft_cfg, gen, device='cpu')
    for label, cfg in (
            ('llama-tiny', dataclasses.replace(llama.LLAMA_TINY,
                                               dtype=torch.float32)),
            ('qwen3-tiny', qwen.QWEN3_TINY_F32)):
        if label == 'qwen3-tiny':
            params = small_qwen_params(cfg, seed=25)
        else:
            gen = torch.Generator()
            gen.manual_seed(25)
            params = llama.init(cfg, gen, device='cpu')
        rng = np.random.default_rng(25)
        prompts = ([[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                    for n in (1000, 700, 20)]
                   + [[int(t) for t in rng.integers(0, cfg.vocab_size, 64)]
                      * 8])
        runs, used = {}, {}
        for device in ('cuda', 'cpu'):
            before = {k.name: k.launches for k in kernels.REGISTRY}

            def engine(c, p):
                return engine_lib.InferenceEngine(
                    engine_lib.EngineConfig(model=c, max_slots=4,
                                            max_target_len=1100,
                                            prefill_buckets=(1024,),
                                            kv_dtype=torch.float32),
                    to_device(p, device), device=device)

            target, draft = engine(cfg, params), engine(draft_cfg,
                                                        draft_params)
            run = {'plain': (orch_lib.Orchestrator(target).generate(
                prompts, max_new_tokens=12), None)}
            for kind, spec in (
                    ('ngram', orch_lib.NgramSpeculator(target,
                                                       gamma=SPEC_GAMMA)),
                    ('draft', orch_lib.SpeculativeOrchestrator(
                        target, draft, gamma=SPEC_GAMMA)),
                    ('self-draft', orch_lib.SpeculativeOrchestrator(
                        target, target, gamma=SPEC_GAMMA))):
                run[kind] = (spec.generate(prompts, max_new_tokens=12),
                             dict(spec.accept_stats))
            runs[device] = run
            used[device] = {k.name: k.launches - before[k.name]
                            for k in kernels.REGISTRY}
        card, cpu = runs['cuda'], runs['cpu']
        log(f'  {label}: card {card}; card launches {used["cuda"]}')
        if card != cpu:
            raise AssertionError(f'{label}: the card gave other tokens or '
                                 f'accept_stats than the CPU: {cpu}')
        for device, run in runs.items():
            for kind, (tokens, stats) in run.items():
                if tokens != run['plain'][0]:
                    raise AssertionError(f'{label} on {device}: {kind} gave '
                                         'other tokens than plain greedy')
                if stats is not None and not stats['rounds']:
                    raise AssertionError(f'{label}: {kind} never speculated')
            stats = run['self-draft'][1]
            if stats['accepted'] != stats['proposed']:
                raise AssertionError(f'{label} on {device}: the fp32 '
                                     f'self-draft rejected proposals: {stats}')
        if not all(used['cuda'][name] for name in SERVE_KERNELS):
            raise AssertionError(f'a kernel did not run on the card: '
                                 f'{used["cuda"]}')
    release_card()


# ---- phases 26-27: the Gemma family ----

# Phase [26]: Gemma2-9B behind infer/server.py, 8 slots over an 8192-row
# cache (the model's context); a prompt of 6000-8000 tokens alone (past
# the even layers' window of 4096: prefilled in 1024-token chunks, then
# decoded over its live window alone; two until phase 38 took the time),
# then 8 concurrent prompts of 1000-1024 tokens (one prefill bucket, the
# flash kernel's), 32 new tokens each (64 before).
GEMMA_SERVE = dict(slots=8, max_len=8192, long=(6000, 8000),
                   prompt_len=(1000, 1024), requests=8, new_tokens=16)


def count_flash_waves(engine) -> list:
    """Wrap the engine's prefill forward so that a run can count the
    waves whose bucket reaches the flash kernel's shortest sequence (one
    K1 launch per layer each); prompt chunks take the plain attention."""
    from skypilot_tpu_torch.ops import attention
    waves = [0]
    prefill = engine._prefill_batch

    def counted(tokens, *args, **kwargs):
        waves[0] += int(tokens.shape[1] >= attention._FLASH_MIN_SEQ)
        return prefill(tokens, *args, **kwargs)

    engine._prefill_batch = counted
    return waves


def gemma2_replica(records: dict) -> None:
    import threading
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import gemma
    cfg = gemma.GEMMA2_9B
    r = GEMMA_SERVE
    kv_gb = (2 * cfg.n_layers * r['slots'] * r['max_len'] * cfg.n_kv_heads
             * cfg.head_dim * 2 / 1e9)
    log(f'[26] Gemma2-9B replica on one card: bf16 ({cfg.n_layers} layers, '
        f'd_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of '
        f'{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied '
        f'head, softcaps {cfg.attn_logit_softcap:g}/'
        f'{cfg.final_logit_softcap:g}, window {cfg.sliding_window} on even '
        f'layers; {cfg.num_params() / 1e9:.2f} B parameters), seeded '
        f'random weights; infer/server.py --model gemma2-9b --max-slots '
        f'{r["slots"]} --max-target-len {r["max_len"]} on 127.0.0.1 (KV '
        f'cache {kv_gb:.1f} GB)')
    t0 = time.perf_counter()
    replica = server_lib.build_replica(server_lib.parse_args([
        '--model', 'gemma2-9b', '--max-slots', str(r['slots']),
        '--max-target-len', str(r['max_len']), '--port', '0',
        '--device', 'cuda']), host='127.0.0.1')
    torch.cuda.synchronize()
    log(f'  init + engine + warm-up {time.perf_counter() - t0:.2f} s; '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    steps = count_decode_steps(replica.engine)
    waves = count_flash_waves(replica.engine)
    rng = np.random.default_rng(26)
    singles = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(r['long'][0], r['long'][1] + 1, 1)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(r['prompt_len'][0],
                                     r['prompt_len'][1] + 1, r['requests'])]
    try:
        # The served requests' own launches: counted from here (after the
        # warm-up) and read before anything else runs on the engine.
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        steps[0] = waves[0] = 0
        t0 = time.perf_counter()
        served = [http_json(url, '/generate', {
            'prompt_tokens': p, 'max_new_tokens': r['new_tokens']})[
                'output_tokens'] for p in singles]
        singles_s = time.perf_counter() - t0
        before = http_json(url, '/metrics')
        _, dt = concurrent_generate(url, [
            {'prompt_tokens': p, 'max_new_tokens': r['new_tokens']}
            for p in prompts], cfg.vocab_size)
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        n_waves, n_steps = waves[0], steps[0]
        after = http_json(url, '/metrics')
        check_derived_launches('gemma2-9b replica', launches, {
            'flash_fwd': cfg.n_layers * n_waves,
            'decode_attention': cfg.n_layers * n_steps})
        if not n_waves or not n_steps:
            raise AssertionError(f'{n_waves} flash waves, {n_steps} '
                                 'decode steps')
        for name in SERVE_KERNELS:
            records[name].setdefault('launches_by_path', {})[
                'gemma_serve'] = launches[name]
        ttft_n = (metric(after, 'xsky_serve_ttft_seconds_count')
                  - metric(before, 'xsky_serve_ttft_seconds_count'))
        ttft_s = (metric(after, 'xsky_serve_ttft_seconds_sum')
                  - metric(before, 'xsky_serve_ttft_seconds_sum'))
        if ttft_n != r['requests']:
            raise AssertionError(f'{ttft_n} TTFT samples for '
                                 f'{r["requests"]} requests')
        peak = torch.cuda.max_memory_allocated() / 2**30
        # The server adds nothing: the long prompts sent one at a time
        # give the tokens of Orchestrator.generate on the same engine,
        # run with the serving loop held.
        with replica.loop._lock:
            direct = [replica.loop.orch.generate(
                [p], max_new_tokens=r['new_tokens'])[0] for p in singles]
        if served != direct:
            raise AssertionError('the server gave other tokens than '
                                 'Orchestrator.generate')
        out_tokens = r['requests'] * r['new_tokens']
        log(f'  prompts of {[len(p) for p in singles]} tokens one at a time '
            f'({singles_s:.2f} s): the served tokens equal '
            'Orchestrator.generate on the same engine')
        log(f'  {r["requests"]} concurrent POST /generate (prompts of '
            f'{min(map(len, prompts))}-{max(map(len, prompts))} tokens) x '
            f'{r["new_tokens"]} tokens in {dt:.3f} s: {out_tokens / dt:.1f} '
            f'output tok/s, mean TTFT {ttft_s / ttft_n * 1e3:.1f} ms '
            f'(/metrics), peak memory {peak:.2f} GiB; served launches '
            f'{launches} = {cfg.n_layers} layers x ({n_waves} flash waves, '
            f'{n_steps} decode steps) on {nvidia_smi_line()}')
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()
    del replica
    release_card()


def small_gemma_params(cfg, seed: int):
    """The port's init for cfg on the CPU, every norm drawn 0.3 N(0, 1):
    zero norms are the identity under Gemma's (1 + w) scaling and would
    not show a misplaced one."""
    from skypilot_tpu_torch.models import gemma
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = gemma.init(cfg, gen, device='cpu')
    for parent in (params['layers'], params):
        for key, value in parent.items():
            if key.endswith('_norm'):
                value.copy_(0.3 * torch.randn(value.shape, generator=gen))
    return params


def small_gemma_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import gemma
    log('[27] small Gemma checks, card (kernels, TF32 off) vs CPU (plain '
        'versions): fp32 gemma-tiny, gemma2-tiny (window 8) and gemma2-tiny '
        'at head_dim 256 (4 heads x 256 over d_model 64), random norms, '
        'bucket 1024 (so the flash kernel runs, past the window): served '
        'greedy tokens; a chunked prefill with a prefix-cache hit against '
        'the whole prompt in one 2048 bucket; NgramSpeculator against plain '
        'greedy')
    d256 = dataclasses.replace(gemma.GEMMA2_TINY_F32, head_dim=256)
    for label, cfg in (('gemma-tiny', gemma.GEMMA_TINY_F32),
                       ('gemma2-tiny', gemma.GEMMA2_TINY_F32),
                       ('gemma2-tiny D256', d256)):
        cpu_params = small_gemma_params(cfg, seed=27)
        rng = np.random.default_rng(27)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                   for n in (1024, 700, 913, 64)]
        copy = [int(t) for t in rng.integers(0, cfg.vocab_size, 64)] * 8
        long = [int(t) for t in rng.integers(0, cfg.vocab_size, 1500)]
        hit = long[:1200] + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                          100)]

        def engine(device, **kw):
            return engine_lib.InferenceEngine(
                engine_lib.EngineConfig(model=cfg, max_slots=4,
                                        kv_dtype=torch.float32, **kw),
                to_device(cpu_params, device), device=device)

        runs, used = {}, {}
        for device in ('cuda', 'cpu'):
            before = {k.name: k.launches for k in kernels.REGISTRY}
            served_engine = engine(device, max_target_len=1100,
                                   prefill_buckets=(1024,))
            served = orch_lib.Orchestrator(served_engine).generate(
                prompts + [copy], max_new_tokens=12)
            spec = orch_lib.NgramSpeculator(served_engine, gamma=SPEC_GAMMA)
            ngram = spec.generate(prompts + [copy], max_new_tokens=12)
            cached = engine(device, max_target_len=2100,
                            prefill_buckets=(1024,), prefix_cache_entries=4)
            chunked = [t for p in (long, hit) for t in orch_lib.Orchestrator(
                cached, decode_steps=4).generate([p], max_new_tokens=8)]
            whole = orch_lib.Orchestrator(
                engine(device, max_target_len=2100, prefill_buckets=(2048,)),
                decode_steps=4).generate([long, hit], max_new_tokens=8)
            used[device] = {k.name: k.launches - before[k.name]
                            for k in kernels.REGISTRY}
            runs[device] = dict(served=served, ngram=ngram,
                                stats=dict(spec.accept_stats),
                                chunked=chunked, whole=whole,
                                cache=cached.prefix_cache_stats)
        card, cpu = runs['cuda'], runs['cpu']
        log(f'  {label}: card tokens {card["served"]}; ngram '
            f'{card["stats"]}; chunked + prefix hit {card["chunked"]} '
            f'({card["cache"]}); card launches {used["cuda"]}')
        if card != cpu:
            raise AssertionError(f'{label}: the card and the CPU differ: '
                                 f'{card} vs {cpu}')
        for device, run in runs.items():
            if run['ngram'] != run['served'] or not run['stats']['rounds']:
                raise AssertionError(f'{label} on {device}: NgramSpeculator '
                                     f'gave {run["ngram"]} ({run["stats"]}), '
                                     f'plain greedy {run["served"]}')
            if run['chunked'] != run['whole'] or not run['cache']['hits']:
                raise AssertionError(
                    f'{label} on {device}: the chunked prefill with a '
                    f'prefix-cache hit gave {run["chunked"]}, the whole '
                    f'prompt {run["whole"]} ({run["cache"]})')
        for name, n in used['cuda'].items():
            if (n > 0) != (name in SERVE_KERNELS):
                raise AssertionError(f'{label}: {name} ran {n} times on the '
                                     f'card: {used["cuda"]}')
    release_card()


# ---- phases 28-29: Gemma training ----

# Phase [28]: Gemma2-2B as `train/launch.py --model gemma2-2b --seq-len 8192
# --global-batch-size 1 --optimizer adafactor` runs it: 2 warm-up and 3
# measured steps, then a run of 2 steps that checkpoints and one resumed
# from it to step 4.
# Gemma2-2B's widths at 4 of its 26 layers (an even count: Gemma-2 pairs
# windowed and global layers): the whole script's time limit took the
# depth when phases 37 (to 14), 38 (to 8) and 39 (to 4) were added.
GEMMA_TRAIN = dict(model='gemma2-2b', seq=8192, batch=1, warmup=2,
                   measured=3, saved=2, resumed=4, layers=4)


def gemma_head_ms(cfg, seq: int) -> float:
    """Device time of the tied fp32 head's forward and backward on one
    row of seq tokens, as a training step runs it: the product against
    the embedding in fp32 (_UpcastMatmul, FFMA), the final softcap, the
    cross-entropy, and the gradients of the hidden states and the
    embedding."""
    from skypilot_tpu_torch.models import gemma
    from skypilot_tpu_torch.models import llama
    gen = torch.Generator(device='cuda')
    gen.manual_seed(28)
    x = torch.randn((1, seq, cfg.d_model), generator=gen, device='cuda').to(
        cfg.dtype).requires_grad_()
    embed = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                         device='cuda') * cfg.d_model ** -0.5).to(
        cfg.dtype).requires_grad_()
    targets = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                            device='cuda')

    def head():
        nll = llama._token_nll(gemma.lm_logits(cfg, {'embed': embed}, x),
                               targets)
        torch.autograd.grad(nll.mean(), (x, embed))

    # CUDA events without time_ms's hold: the host queues a run in ~0.1 s
    # (its 8.4 GB tensors wait on the allocator), far less than the run's
    # device time, so nothing of the host's shows between the events.
    head()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        head()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 3
    del x, embed, targets
    release_card()
    return ms


def gemma_train_path(records: dict) -> None:
    import tempfile
    from skypilot_tpu_torch.models import gemma
    r = GEMMA_TRAIN
    cfg = dataclasses.replace(gemma.GEMMA2_2B, n_layers=r['layers'])
    steps = r['warmup'] + r['measured']
    # Each step runs K2 and K3 once a layer, and K1 twice: the remat
    # policy ('dots') saves the weight products only, so the backward
    # recomputes each layer's attention forward.
    k1_factor = 2 if cfg.remat else 1

    def derived(n):
        return {'flash_fwd': k1_factor * cfg.n_layers * n,
                'flash_bwd_dkv': cfg.n_layers * n,
                'flash_bwd_dq': cfg.n_layers * n}

    log(f'[28] Gemma2-2B training on one card through train/launch.py: '
        f'bf16 ({cfg.n_layers} of {gemma.GEMMA2_2B.n_layers} layers, '
        f'd_model {cfg.d_model}, '
        f'{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff '
        f'{cfg.d_ff}, vocab {cfg.vocab_size}, tied fp32 head, softcaps '
        f'{cfg.attn_logit_softcap:g}/{cfg.final_logit_softcap:g}, window '
        f'{cfg.sliding_window} on even layers, remat {cfg.remat_policy}; '
        f'{cfg.num_params() / 1e9:.2f} B parameters), seeded random '
        f'weights; --model {r["model"]} --seq-len {r["seq"]} '
        f'--global-batch-size {r["batch"]} --optimizer adafactor (the '
        f'learning-rate warm-up cut to 1 step) over uint32 token shards: '
        f'{steps} steps '
        f'({r["warmup"]} warm-up + {r["measured"]} measured); {r["saved"]} '
        f'steps with --checkpoint-every {r["saved"]}, then --steps '
        f'{r["resumed"]} --resume auto')
    with tempfile.TemporaryDirectory(prefix='xsky-gemma-train-') as tmp, \
            registered_config(r['model'], cfg):
        data = write_token_shards(os.path.join(tmp, 'tokens'),
                                  steps * r['batch'] * r['seq'] + 1,
                                  cfg.vocab_size, seed=28)
        common = ['--model', r['model'], '--global-batch-size',
                  str(r['batch']), '--seq-len', str(r['seq']),
                  '--optimizer', 'adafactor', '--device', 'cuda',
                  '--log-every', '1', '--data', data, '--data-loader',
                  'python']
        ckpt = os.path.join(tmp, 'ckpt')
        metrics = os.path.join(tmp, 'metrics.jsonl')
        runs = {}
        with short_warmup(1):
            torch.cuda.reset_peak_memory_stats()
            runs['solid'] = launch_run(
                common + ['--steps', str(steps), '--metrics-file', metrics],
                'Gemma2-2B launch', kernels_wanted=None)
            peak = torch.cuda.max_memory_allocated()
            del runs['solid']['state'], runs['solid']['trainer']
            release_card()
            runs['saved'] = launch_run(
                common + ['--steps', str(r['saved']), '--checkpoint-every',
                          str(r['saved']), '--checkpoint-dir', ckpt],
                'Gemma2-2B launch (checkpoint)', kernels_wanted=None)
            del runs['saved']['state'], runs['saved']['trainer']
            release_card()
            runs['resumed'] = launch_run(
                common + ['--steps', str(r['resumed']), '--resume', 'auto',
                          '--checkpoint-dir', ckpt],
                'Gemma2-2B launch (resumed)', kernels_wanted=None)
            del runs['resumed']['state'], runs['resumed']['trainer']
            release_card()
        rows = [json.loads(line) for line in open(metrics, encoding='utf-8')]
    solid, resumed = runs['solid'], runs['resumed']
    for label, n in (('solid', steps), ('saved', r['saved']),
                     ('resumed', r['resumed'] - r['saved'])):
        check_derived_launches(f'Gemma2-2B launch ({label})',
                               runs[label]['launches'], derived(n))
    want = f'Resumed from checkpoint step {r["saved"]}.'
    if want not in resumed['log']:
        raise AssertionError(f'no resume line in {resumed["log"]}')
    later = range(r['saved'] + 1, r['resumed'] + 1)
    if sorted(resumed['losses']) != list(later):
        raise AssertionError(f'resumed run logged {resumed["losses"]}')
    errs = {k: abs(resumed['losses'][k] - solid['losses'][k]) /
            abs(solid['losses'][k]) for k in later}
    losses = [solid['losses'][k] for k in sorted(solid['losses'])]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f'Gemma2-2B losses {losses}')
    log(f'  uninterrupted losses {losses}; resumed from step {r["saved"]} '
        f'({resumed["restore"]["tier"]} tier in '
        f'{resumed["restore"]["seconds"]:.3f} s): {resumed["losses"]}, '
        f'relative differences {errs} (tolerance {RESUME_RTOL:g}), '
        f'bit-identical: {all(e == 0 for e in errs.values())}')
    if max(errs.values()) > RESUME_RTOL:
        raise AssertionError('resumed losses differ from the uninterrupted '
                             'run')
    measured = rows[r['warmup']:]
    tps = float(np.mean([row['tokens_per_sec'] for row in measured]))
    tflops = float(np.mean([row['model_tflops_per_chip'] for row in measured]))
    step_ms = r['batch'] * r['seq'] / tps * 1e3
    head = gemma_head_ms(cfg, r['seq'])
    shares = phase_shares(solid['records'][r['warmup']:])
    totals = {name: sum(runs[label]['launches'][name] for label in runs)
              for name in TRAIN_KERNELS}
    for name in TRAIN_KERNELS:
        records[name].setdefault('launches_by_path', {})['gemma_train'] = (
            totals[name])
    log(f'  measured steps {r["warmup"] + 1}-{steps}: {tps:.1f} tokens/s, '
        f'step {step_ms:.1f} ms, model {tflops:.2f} TFLOP/s = '
        f'{tflops / (PEAK_FLOPS[torch.bfloat16] / 1e12):.4f} of the bf16 '
        f'peak (6N + 12LdS); peak memory {peak / 2**30:.2f} GiB; the fp32 '
        f'tied head (forward + backward, timed alone at one 8192-token row) '
        f'{head:.2f} ms = {head / step_ms:.4f} of a step')
    log("  flight recorder shares of the measured steps' wall: " + ', '.join(
        f'{k} {v:.4f}' for k, v in shares.items()))
    log(f'  launches per run {[runs[label]["launches"] for label in runs]} '
        f'= {cfg.n_layers} layers x steps (K1 x {k1_factor}); decode '
        f'kernels 0; on {nvidia_smi_line()}')


def small_gemma_train_checks() -> None:
    from skypilot_tpu_torch.models import gemma
    from skypilot_tpu_torch.train import trainer as trainer_lib
    log('[29] small Gemma training checks, card (kernels, TF32 off) vs CPU '
        '(plain versions): fp32 gemma-tiny, gemma2-tiny (window 8) and '
        'gemma2-tiny at head_dim 256 (4 heads x 256 over d_model 64), '
        'random norms, seq 1024 (so the flash kernels run), adafactor, '
        'accum_steps=2: 3 Trainer steps each; then 3 LoRA steps (rank 4, '
        'wq,wk,wv,wo) on the head_dim-256 config')
    d256 = dataclasses.replace(gemma.GEMMA2_TINY_F32, head_dim=256)
    rng = np.random.default_rng(29)
    tokens = rng.integers(0, 256, (2, 1024))
    batch = {'tokens': torch.from_numpy(tokens),
             'targets': torch.from_numpy(np.roll(tokens, -1, axis=1))}
    for label, cfg, rank in (('gemma-tiny', gemma.GEMMA_TINY_F32, 0),
                             ('gemma2-tiny', gemma.GEMMA2_TINY_F32, 0),
                             ('gemma2-tiny D256', d256, 0),
                             ('gemma2-tiny D256 LoRA', d256, 4)):
        tcfg = trainer_lib.TrainConfig(
            model=cfg, global_batch_size=2, seq_len=1024,
            optimizer='adafactor', accum_steps=2, learning_rate=1e-3,
            warmup_steps=2, lora_rank=rank)
        runs = {}
        for device in ('cuda', 'cpu'):
            before = {k.name: k.launches for k in kernels.REGISTRY}
            tr = trainer_lib.Trainer(tcfg, device=device)
            state = tr.init_state(to_device(small_gemma_params(cfg, 29),
                                            device))
            on_device = {k: v.to(device) for k, v in batch.items()}
            metrics = []
            for _ in range(3):
                state, m = tr.step(state, on_device)
                metrics.append((float(m['loss']), float(m['grad_norm'])))
            used = {k.name: k.launches - before[k.name]
                    for k in kernels.REGISTRY}
            runs[device] = (metrics, trainer_lib.param_leaves(
                state['params']), state.get('base'), used)
        (card, card_params, card_base, used), (cpu, cpu_params, _, _) = (
            runs['cuda'], runs['cpu'])
        err = max(float((a.detach().cpu() - b.detach()).abs().max())
                  for a, b in zip(card_params, cpu_params))
        log(f'  {label}: card (loss, grad_norm) {card}; CPU {cpu}; '
            f'parameters max_abs_err {err:.3e} (tolerances: losses atol '
            f'{TRAIN_LOSS_ATOL:g}, grad norms rtol {TRAIN_NORM_RTOL:g}, '
            f'parameters atol {TRAIN_PARAM_ATOL:g}); card launches {used}')
        for (lc, nc), (lp, npl) in zip(card, cpu):
            if abs(lc - lp) > TRAIN_LOSS_ATOL or abs(nc - npl) > (
                    TRAIN_NORM_RTOL * abs(npl)):
                raise AssertionError(f'{label}: loss or grad norm differs '
                                     'between the card and the CPU')
        if err > TRAIN_PARAM_ATOL:
            raise AssertionError(f'{label}: parameters differ between the '
                                 'card and the CPU after three steps')
        for name, n in used.items():
            if (n > 0) != (name in TRAIN_KERNELS):
                raise AssertionError(f'{label}: {name} ran {n} times on the '
                                     f'card: {used}')
        if card_base is not None:
            init = small_gemma_params(cfg, 29)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(
                    trainer_lib.param_leaves(card_base),
                    trainer_lib.param_leaves(init))):
                raise AssertionError(f'{label}: the frozen base changed')
            log('    LoRA: the base on the card is bit-identical to its '
                'init')
    release_card()


# ---- phases 30-31: Mixtral serving ----

# Phase [30]: Mixtral-8x7B as examples/tpu/serve_mixtral.yaml sizes its
# replica (16 slots over a 4096-row cache) on one card, with int8 weights
# (its bf16 tree, 93.4 GB, is larger than the card; the recipe's --mesh
# expert=8 needs queue 1 item 8f): a prompt of the recipe's length (3500
# tokens, chunked) alone, then 16 concurrent prompts of 256-1536 tokens;
# the largest wave (16 rows of 1024) is then prefilled once on its own.
MIXTRAL_SERVE = dict(slots=16, max_len=4096, singles=(3500,),
                     prompt_len=(256, 1536), requests=16, new_tokens=16,
                     single_new=32, wave=1024)
# What [30] served, for [39] (a) to hold the same replica under --mesh
# expert=2 against: its prompts, the singles' streams with each step's
# top-5 logprobs, and its weight and KV-cache bytes.
MIXTRAL_REFERENCE: dict = {}


def mixtral_replica(records: dict) -> None:
    import threading
    from skypilot_tpu_torch.infer import sampling
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.ops import quantization as qops
    cfg = moe.MIXTRAL_8X7B
    r = MIXTRAL_SERVE
    kv_gb = (2 * cfg.n_layers * r['slots'] * r['max_len'] * cfg.n_kv_heads
             * cfg.head_dim * 2 / 1e9)
    # One layer of one expert stack in bf16, and the whole stack.
    layer_bytes = cfg.n_experts * cfg.d_model * cfg.d_ff * 2
    stack_bytes = cfg.n_layers * layer_bytes
    log(f'[30] Mixtral-8x7B replica on one card: int8 weights ('
        f'{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/'
        f'{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.n_experts} experts '
        f'of d_ff {cfg.d_ff}, top-{cfg.experts_per_token}, vocab '
        f'{cfg.vocab_size}; {cfg.num_params() / 1e9:.2f} B parameters, '
        f'{cfg.num_params() * 2 / 1e9:.1f} GB in bf16), quantized on the '
        'card as the seeded init draws them; infer/server.py --model '
        f'mixtral-8x7b --weight-dtype int8 --max-slots {r["slots"]} '
        f'--max-target-len {r["max_len"]} on 127.0.0.1 (bf16 KV cache '
        f'{kv_gb:.2f} GB)')
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    built = {}
    init = moe.init

    def measured_init(*args, **kwargs):
        t0 = time.perf_counter()
        params = init(*args, **kwargs)
        torch.cuda.synchronize()
        built.update(s=time.perf_counter() - t0,
                     peak=torch.cuda.max_memory_allocated() - base,
                     tree=torch.cuda.memory_allocated() - base)
        return params

    moe.init = measured_init
    t0 = time.perf_counter()
    try:
        replica = server_lib.build_replica(server_lib.parse_args([
            '--model', 'mixtral-8x7b', '--weight-dtype', 'int8',
            '--max-slots', str(r['slots']),
            '--max-target-len', str(r['max_len']), '--port', '0',
            '--device', 'cuda']), host='127.0.0.1')
    finally:
        moe.init = init
    torch.cuda.synchronize()
    nbytes = qops.params_nbytes(replica.engine.params)
    scratch = built['peak'] - built['tree']
    log(f'  init {built["s"]:.2f} s: weights {nbytes} bytes '
        f'({nbytes / 1e9:.3f} GB, params_nbytes); the build\'s peak '
        f'{built["peak"] / 2**30:.2f} GiB, {scratch / 2**30:.2f} GiB above '
        f'the finished tree (one bf16 expert layer {layer_bytes / 2**30:.2f}'
        f' GiB, a whole bf16 stack {stack_bytes / 2**30:.2f} GiB); init + '
        f'engine + warm-up {time.perf_counter() - t0:.2f} s, '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    # A stack quantized whole would hold its bf16 copy (and fp32 ones):
    # at least stack_bytes above the tree. Layer by layer the scratch is a
    # few copies of one layer (bf16, its fp32 draw, the quantizer's fp32
    # quotient and rounding).
    if abs(built['tree'] - nbytes) > 2**26 or scratch >= stack_bytes / 2:
        raise AssertionError(
            f'the build held {scratch} bytes above its tree of '
            f'{built["tree"]} ({nbytes} in params): half a full-precision '
            'stack or more')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{replica.httpd.server_address[1]}'
    engine = replica.engine
    steps = count_decode_steps(engine)
    waves = count_flash_waves(engine)
    rng = np.random.default_rng(30)
    singles = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in r['singles']]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(r['prompt_len'][0],
                                     r['prompt_len'][1] + 1, r['requests'])]
    try:
        if json.loads(http_json(url, '/health'))['status'] != 'healthy':
            raise AssertionError('/health did not answer healthy')
        # The served requests' own launches: counted from here (after the
        # warm-up) and read before anything else runs on the engine.
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        steps[0] = waves[0] = 0
        t0 = time.perf_counter()
        served = [http_json(url, '/generate', {
            'prompt_tokens': p, 'max_new_tokens': r['single_new']})[
                'output_tokens'] for p in singles]
        singles_s = time.perf_counter() - t0
        before = http_json(url, '/metrics')
        _, dt = concurrent_generate(url, [
            {'prompt_tokens': p, 'max_new_tokens': r['new_tokens']}
            for p in prompts], cfg.vocab_size)
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        n_waves, n_steps = waves[0], steps[0]
        after = http_json(url, '/metrics')
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_derived_launches('mixtral-8x7b replica', launches, {
            'flash_fwd': cfg.n_layers * n_waves,
            'decode_attention': cfg.n_layers * n_steps})
        if not n_waves or not n_steps:
            raise AssertionError(f'{n_waves} flash waves, {n_steps} '
                                 'decode steps')
        for name in SERVE_KERNELS:
            records[name].setdefault('launches_by_path', {})[
                'mixtral_serve'] = launches[name]
        sent = singles + prompts
        want = {'xsky_serve_requests_total{endpoint="/generate",'
                'outcome="ok"}': len(sent),
                'xsky_serve_prompt_tokens_total': sum(map(len, sent)),
                'xsky_serve_generated_tokens_total':
                    len(singles) * r['single_new']
                    + len(prompts) * r['new_tokens']}
        got = {name: metric(after, name) for name in want}
        if got != want:
            raise AssertionError(f'/metrics counters {got}, sent {want}')
        ttft_n = (metric(after, 'xsky_serve_ttft_seconds_count')
                  - metric(before, 'xsky_serve_ttft_seconds_count'))
        ttft_s = (metric(after, 'xsky_serve_ttft_seconds_sum')
                  - metric(before, 'xsky_serve_ttft_seconds_sum'))
        if ttft_n != r['requests']:
            raise AssertionError(f'{ttft_n} TTFT samples for '
                                 f'{r["requests"]} requests')
        # The server adds nothing: the prompts sent one at a time give
        # the tokens of Orchestrator.generate on the same engine, run
        # with the serving loop held. (A concurrent request's tokens also
        # depend on the others in its prefill wave: they share the
        # experts' capacity.)
        # (With each step's top-5 logprobs, which [39] (a) reads.)
        from skypilot_tpu_torch.infer import orchestrator as orch_lib
        with replica.loop._lock:
            direct = []
            for p in singles:
                direct.append(replica.loop.orch.submit(orch_lib.Request(
                    prompt_tokens=p, max_new_tokens=r['single_new'],
                    logprobs=5)))
                replica.loop.orch.run_until_drained(max_steps=256)
        if served != [q.output_tokens for q in direct]:
            raise AssertionError('the server gave other tokens than '
                                 'Orchestrator.generate')
        MIXTRAL_REFERENCE.update(
            singles=singles, prompts=prompts, streams=served,
            logprobs=[q.token_logprobs for q in direct],
            top=[[sorted(d.values(), reverse=True) for d in q.top_logprobs]
                 for q in direct],
            param_bytes=nbytes, kv_bytes=engine_kv_bytes(engine))
        out_tokens = r['requests'] * r['new_tokens']
        log(f'  prompts of {[len(p) for p in singles]} tokens one at a time '
            f'({singles_s:.2f} s): the served tokens equal '
            'Orchestrator.generate on the same engine')
        log(f'  {r["requests"]} concurrent POST /generate (prompts of '
            f'{min(map(len, prompts))}-{max(map(len, prompts))} tokens) x '
            f'{r["new_tokens"]} tokens in {dt:.3f} s: {out_tokens / dt:.1f} '
            f'output tok/s, mean TTFT {ttft_s / ttft_n * 1e3:.1f} ms '
            f'(/metrics), peak memory {peak:.2f} GiB; /metrics counters '
            f'equal what was sent; served launches {launches} = '
            f'{cfg.n_layers} layers x ({n_waves} flash waves, {n_steps} '
            'decode steps)')
        # The largest wave the replica admits (max_slots rows of the
        # largest bucket), prefilled on its own into the idle slots,
        # then one decode step of all 16 slots, timed on the device.
        with replica.loop._lock:
            torch.cuda.reset_peak_memory_stats()
            wave = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                                   r['wave'])]
                    for _ in range(r['slots'])]
            t0 = time.perf_counter()
            state, _ = engine.prefill_insert_batch(
                replica.loop.orch.state,
                [(p, sampling.SamplingParams()) for p in wave],
                list(range(r['slots'])))
            torch.cuda.synchronize()
            wave_ms = (time.perf_counter() - t0) * 1e3
            wave_peak = torch.cuda.max_memory_allocated() / 2**30
            step_ms, step_wall = busy_ms(lambda: engine.decode_step(state))
        log(f'  the largest wave, {r["slots"]} x {r["wave"]} tokens: '
            f'{wave_ms:.1f} ms, peak memory {wave_peak:.2f} GiB of '
            f'{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}'
            f'; one decode step of {r["slots"]} slots at length '
            f'{r["wave"]}: {step_ms:.2f} ms of device time (the profiler\'s '
            f'kernel sum) in {step_wall:.2f} ms of wall; on '
            f'{nvidia_smi_line()}')
    finally:
        replica.httpd.shutdown()
        replica.httpd.server_close()
        replica.loop.close()
    del replica, engine
    release_card()


def small_mixtral_end_to_end() -> None:
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.ops import quantization as qops
    log('[31] small Mixtral checks, card (kernels, TF32 off) vs CPU (plain '
        'versions): fp32 moe-tiny (4 experts, top-2), random norms, bucket '
        '1024: a 3-prompt wave padded to 4 rows at capacity factor 0.25, '
        'where experts drop real tokens; a chunked prefill with a '
        'prefix-cache hit against the whole prompt in one 2048 bucket (at '
        'a capacity factor that drops nothing); int8 weights')
    gen = torch.Generator()
    gen.manual_seed(31)
    cpu_params = moe.init(moe.MOE_TINY_F32, gen, device='cpu')
    for key in ('attn_norm', 'mlp_norm'):
        norm = cpu_params['layers'][key]
        norm.copy_(1 + 0.2 * torch.randn(norm.shape, generator=gen))
    rng = np.random.default_rng(31)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (1024, 700, 913)]
    long = [int(t) for t in rng.integers(0, 256, 1500)]
    hit = long[:1200] + [int(t) for t in rng.integers(0, 256, 100)]
    drop_cfg = dataclasses.replace(moe.MOE_TINY_F32, capacity_factor=0.25)
    keep_cfg = dataclasses.replace(
        moe.MOE_TINY_F32, capacity_factor=float(moe.MOE_TINY_F32.n_experts))
    route = moe.route

    def engine(cfg, device, **kw):
        return engine_lib.InferenceEngine(
            engine_lib.EngineConfig(model=cfg, max_slots=4,
                                    kv_dtype=torch.float32, **kw),
            to_device(cpu_params, device), device=device)

    runs, used = {}, {}
    for device in ('cuda', 'cpu'):
        dropped = []

        def spy(config, router_w, x, token_mask=None, capacity=None, **kw):
            out = route(config, router_w, x, token_mask, capacity, **kw)
            if capacity is None:       # a prefill wave, not a decode step
                real = (token_mask != 0)[:, None]
                dropped.append(int((real & ~out.keep).sum()))
            return out

        before = {k.name: k.launches for k in kernels.REGISTRY}
        moe.route = spy
        try:
            wave = orch_lib.Orchestrator(engine(
                drop_cfg, device, max_target_len=1100,
                prefill_buckets=(1024,))).generate(prompts,
                                                   max_new_tokens=12)
        finally:
            moe.route = route
        cached = engine(keep_cfg, device, max_target_len=2100,
                        prefill_buckets=(1024,), prefix_cache_entries=4)
        chunked = [t for p in (long, hit) for t in orch_lib.Orchestrator(
            cached, decode_steps=4).generate([p], max_new_tokens=8)]
        whole = orch_lib.Orchestrator(
            engine(keep_cfg, device, max_target_len=2100,
                   prefill_buckets=(2048,)),
            decode_steps=4).generate([long, hit], max_new_tokens=8)
        int8_engine = engine(keep_cfg, device, max_target_len=1100,
                             prefill_buckets=(1024,),
                             weight_dtype=torch.int8)
        int8 = orch_lib.Orchestrator(int8_engine).generate(
            prompts, max_new_tokens=12)
        used[device] = {k.name: k.launches - before[k.name]
                        for k in kernels.REGISTRY}
        runs[device] = dict(wave=wave, dropped=dropped, chunked=chunked,
                            whole=whole, cache=cached.prefix_cache_stats,
                            int8=int8, int8_tree=[
                                t.cpu() for t in tensors(int8_engine.params)])
    card, cpu = runs['cuda'], runs['cpu']
    log(f'  wave tokens {card["wave"]} (real (token, choice) pairs '
        f'dropped, per layer of each wave: {card["dropped"]}); chunked + '
        f'prefix hit {card["chunked"]} ({card["cache"]}); int8 '
        f'{card["int8"]}; card launches '
        f'{used["cuda"]}')
    same_bytes = all(torch.equal(a, b) for a, b in zip(
        card.pop('int8_tree'), cpu.pop('int8_tree'), strict=True))
    if card != cpu or not same_bytes:
        raise AssertionError(f'the card and the CPU differ: {card} vs {cpu} '
                             f'(int8 bytes equal: {same_bytes})')
    if not any(card['dropped']):
        raise AssertionError('no real token was dropped in the waves: '
                             f'{card["dropped"]}')
    if card['chunked'] != card['whole'] or not card['cache']['hits']:
        raise AssertionError(
            f'the chunked prefill with a prefix-cache hit gave '
            f'{card["chunked"]}, the whole prompt {card["whole"]} '
            f'({card["cache"]})')
    if not qops.is_quantized(int8_engine.params['layers']['w_gate']):
        raise AssertionError('the int8 engine did not quantize the experts')
    for name, n in used['cuda'].items():
        if (n > 0) != (name in SERVE_KERNELS):
            raise AssertionError(f'{name} ran {n} times on the card: '
                                 f'{used["cuda"]}')
    release_card()


# ---- phases 32-34: Mixtral and DeepSeek training ----

# Phase [32]: Mixtral-8x7B at its public widths, cut to 2 layers by the
# card's memory (AdamW keeps 8 bytes a parameter: 25.3 GB of state at 2
# layers, 374 GB at 32), trained by Trainer at seq 4096, global batch 2.
MIXTRAL_TRAIN = dict(layers=2, seq=4096, batch=2, warmup=1, measured=3)
# Phase [33]: DeepSeek-V2-Lite full-parameter at 4 layers (1 dense + 3
# routed; 18.0 GB of state), seq 4096, batch 1; then all 27 layers with
# LoRA on the MLA weights through train/launch.py.
DEEPSEEK_TRAIN = dict(layers=4, seq=4096, batch=1, warmup=1, measured=3)
DEEPSEEK_LORA = dict(rank=16, targets='wq,w_ukv,wo', seq=4096, batch=1,
                     steps=4)
# Phase [34]: card (kernels, TF32 off) vs CPU (plain versions) at fp32:
# losses and load-balance terms, every gradient (as [22]'s 1e-4).
ROUTED_GRAD_ATOL = 1e-4
ROUTED_AUX_ATOL = 1e-5


class capture_aux:
    """Keep the load-balance term of every loss a routed family computes,
    read from what its loss_fn calls (``moe.forward`` returns (logits,
    aux); ``deepseek._trunk`` (x, kv, aux)), so that a step's term is
    logged beside its loss without another forward."""

    def __init__(self, module, fn_name: str):
        self.module, self.fn_name, self.values = module, fn_name, []

    def __enter__(self):
        self.real = getattr(self.module, self.fn_name)

        def wrapped(*args, **kwargs):
            out = self.real(*args, **kwargs)
            if isinstance(out, tuple) and torch.is_tensor(out[-1]):
                self.values.append(out[-1].detach())
            return out

        setattr(self.module, self.fn_name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.fn_name, self.real)
        return False


def train_routed(label: str, cfg, r: dict, module, fn_name: str,
                 seed: int) -> dict:
    """Trainer steps on the card (adamw as make_optimizer builds it, the
    learning-rate warm-up cut to 1 step) over seeded token batches, the
    launch counts zeroed just before the steps and read just after; each
    step's loss and load-balance term logged apart → the run's numbers."""
    from skypilot_tpu_torch.train import trainer as trainer_lib
    release_card()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    tr = trainer_lib.Trainer(trainer_lib.TrainConfig(
        model=cfg, global_batch_size=r['batch'], seq_len=r['seq'],
        optimizer='adamw', warmup_steps=1), device='cuda')
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer_lib.param_leaves(
        state['params']))
    state_gb = (torch.cuda.memory_allocated() - before) / 1e9
    rng = np.random.default_rng(seed)
    steps = r['warmup'] + r['measured']
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (steps, r['batch'], r['seq'] + 1))).cuda()
    coef = cfg.router_aux_coef
    rows = []
    zero_launches()
    with capture_aux(module, fn_name) as aux:
        for i in range(steps):
            batch = {'tokens': tokens[i, :, :-1].contiguous(),
                     'targets': tokens[i, :, 1:].contiguous()}
            t0 = time.perf_counter()
            state, metrics = tr.step(state, batch)
            loss = float(metrics['loss'])          # waits for the step
            dt = time.perf_counter() - t0
            term = float(aux.values[-1])
            rows.append((loss, term, dt))
            log(f'  step {i + 1}: loss {loss:.6f} = cross-entropy '
                f'{loss - coef * term:.6f} + {coef:g} x load-balance term '
                f'{term:.6f}; grad norm {float(metrics["grad_norm"]):.4f}; '
                f'{dt * 1e3:.1f} ms')
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(aux.values) != steps:
        raise AssertionError(f'{label}: {len(aux.values)} load-balance '
                             f'terms for {steps} steps')
    losses, terms = [row[0] for row in rows], [row[1] for row in rows]
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(terms))
            and min(terms) > 0):
        raise AssertionError(f'{label}: losses {losses}, load-balance '
                             f'terms {terms}: want finite, terms > 0')
    step_s = float(np.mean([row[2] for row in rows[r['warmup']:]]))
    tps = r['batch'] * r['seq'] / step_s
    flops = dataclasses.replace(
        cfg, max_seq_len=r['seq']).train_flops_per_token()
    tflops = tps * flops / 1e12
    log(f'  {label}: {n_params / 1e9:.4f} B parameters ({state_gb:.2f} GB '
        f'of parameters and optimizer state), init {init_s:.2f} s; '
        f'measured steps {r["warmup"] + 1}-{steps}: step {step_s * 1e3:.1f}'
        f' ms, {tps:.1f} tokens/s, model {tflops:.2f} TFLOP/s = '
        f'{tflops / (PEAK_FLOPS[torch.bfloat16] / 1e12):.4f} of the bf16 '
        f'peak; peak memory {peak:.2f} GiB; launches {launches} on '
        f'{nvidia_smi_line()}')
    del state, tr, tokens
    release_card()
    return {'launches': launches, 'losses': losses, 'terms': terms,
            'step_ms': step_s * 1e3, 'tokens_s': tps, 'tflops': tflops,
            'peak_gib': peak}


def mixtral_train_path(records: dict) -> None:
    from skypilot_tpu_torch.models import moe
    r = MIXTRAL_TRAIN
    cfg = dataclasses.replace(moe.MIXTRAL_8X7B, n_layers=r['layers'])
    steps = r['warmup'] + r['measured']
    log(f'[32] Mixtral-8x7B training on one card: public widths (d_model '
        f'{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of '
        f'{cfg.head_dim}, {cfg.n_experts} experts of d_ff {cfg.d_ff}, top-'
        f'{cfg.experts_per_token}, vocab {cfg.vocab_size}) cut to '
        f'{cfg.n_layers} of 32 layers by the card\'s memory, bf16, remat '
        f'(the 2-D weights\' products kept), seeded random weights; '
        f'Trainer with adamw, seq {r["seq"]}, global batch {r["batch"]} '
        f'(capacity {moe.expert_capacity(cfg, r["batch"] * r["seq"])} a '
        f'expert), {steps} steps ({r["warmup"]} warm-up + {r["measured"]} '
        'measured) on seeded token batches')
    out = train_routed('Mixtral-8x7B, 2 layers', cfg, r, moe, 'forward',
                       seed=32)
    # Each step runs K2 and K3 once a layer and K1 twice: the backward
    # recomputes each layer's forward (remat).
    k1_factor = 2 if cfg.remat else 1
    derived = {'flash_fwd': k1_factor * cfg.n_layers * steps,
               'flash_bwd_dkv': cfg.n_layers * steps,
               'flash_bwd_dq': cfg.n_layers * steps}
    check_derived_launches('mixtral_train', out['launches'], derived)
    for name in records:
        records[name].setdefault('launches_by_path', {})['mixtral_train'] = (
            out['launches'][name])
    log(f'  launches {out["launches"]} = {cfg.n_layers} layers x {steps} '
        f'steps (K1 x {k1_factor}), every other kernel 0')


def deepseek_train_path(records: dict) -> None:
    import tempfile
    from skypilot_tpu_torch.models import deepseek
    from skypilot_tpu_torch.train import trainer as trainer_lib
    r = DEEPSEEK_TRAIN
    cfg = dataclasses.replace(deepseek.DEEPSEEK_V2_LITE, n_layers=r['layers'])
    steps = r['warmup'] + r['measured']
    log(f'[33] DeepSeek-V2-Lite training on one card: (a) public widths '
        f'cut to {cfg.n_layers} of 27 layers ({cfg.first_k_dense} dense + '
        f'{cfg.n_moe_layers} routed: {cfg.n_experts} experts top-'
        f'{cfg.experts_per_token} + {cfg.n_shared_experts} shared), '
        f'full-parameter, bf16, remat {cfg.remat_policy}, plain attention '
        f'(qk head dim {cfg.qk_head_dim}, v {cfg.v_head_dim}), seeded '
        f'random weights; Trainer with adamw, seq {r["seq"]}, batch '
        f'{r["batch"]}, {steps} steps; (b) all 27 layers with LoRA through '
        'train/launch.py')
    out = train_routed('DeepSeek-V2-Lite, 4 layers', cfg, r, deepseek,
                       '_trunk', seed=33)
    check_derived_launches('deepseek_train (4 layers)', out['launches'], {})
    totals = dict(out['launches'])
    lo = DEEPSEEK_LORA
    full = deepseek.DEEPSEEK_V2_LITE
    argv = ['--model', 'deepseek-v2-lite', '--lora-rank', str(lo['rank']),
            '--lora-targets', lo['targets'], '--seq-len', str(lo['seq']),
            '--global-batch-size', str(lo['batch']), '--steps',
            str(lo['steps']), '--log-every', '1']
    log(f'  (b) python -m skypilot_tpu_torch.train.launch {" ".join(argv)}'
        ' (in-process; the learning-rate warm-up cut to 1 step) over uint32 '
        f'token shards: {full.n_layers} layers, {full.num_params() / 1e9:.2f}'
        ' B parameters frozen')
    with tempfile.TemporaryDirectory(prefix='xsky-deepseek-lora-') as tmp:
        data = write_token_shards(os.path.join(tmp, 'tokens'),
                                  lo['steps'] * lo['batch'] * lo['seq'] + 1,
                                  full.vocab_size, seed=33)
        release_card()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with short_warmup(1):
            run = launch_run(argv + ['--data', data, '--data-loader',
                                     'python', '--device', 'cuda'],
                             'DeepSeek-V2-Lite LoRA', kernels_wanted=None)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
    check_derived_launches('deepseek_train (LoRA launch)', run['launches'],
                           {})
    state = run['state']
    base = trainer_lib.param_leaves(state['base'])
    base_bytes = sum(t.numel() * t.element_size() for t in base)
    n_adapter = sum(a.numel() for a in trainer_lib.param_leaves(
        state['params']))
    losses = [run['losses'][k] for k in sorted(run['losses'])]
    if len(losses) != lo['steps'] or not np.all(np.isfinite(losses)):
        raise AssertionError(f'DeepSeek LoRA losses {losses}')
    tps = [float(line.split(' tok/s')[0].split()[-1].replace(',', ''))
           for line in run['log'] if ' tok/s ' in line][1:]
    del run['state'], run['trainer'], state, base
    release_card()
    for name in records:
        totals[name] += run['launches'][name]
        records[name].setdefault('launches_by_path', {})['deepseek_train'] = (
            totals[name])
    log(f'  (b) losses {losses} (finite); base {base_bytes} bytes (frozen, '
        f'bf16), {n_adapter} adapter parameters; steps 2-{lo["steps"]}: '
        f'{np.mean(tps):.1f} tokens/s; peak memory {peak:.2f} GiB; {dt:.1f}'
        f' s with init; launches {run["launches"]}')
    log(f'  deepseek_train launches no kernel (plain attention, no decode): '
        f'K1-K7 {totals}, as derived; on {nvidia_smi_line()}')


def small_routed_params(cfg, seed: int):
    """The family's seeded fp32 init on the CPU, every norm scale redrawn
    (1 + 0.2 N(0, 1)), so a misplaced norm shows."""
    from skypilot_tpu_torch import models
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = models.module_for(cfg).init(cfg, gen, device='cpu')
    groups = [params[k] for k in ('layers', 'dense_layers', 'moe_layers')
              if k in params]
    for group in groups:
        for key, value in group.items():
            if key.endswith('norm'):
                value.copy_(1 + 0.2 * torch.randn(value.shape,
                                                  generator=gen))
    return params


def copy_to(tree, device):
    """A copy of a parameter tree on ``device`` whose leaves are new
    leaves (no autograd history, the CPU originals untouched)."""
    if isinstance(tree, dict):
        return {k: copy_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device, copy=True)


def flat_tree(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(flat_tree(value, f'{prefix}/{key}'))
        return out
    return {prefix: tree}


def small_routed_train_checks() -> None:
    import tempfile
    from skypilot_tpu_torch import models
    from skypilot_tpu_torch.models import deepseek
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.train import trainer as trainer_lib
    log('[34] small Mixtral and DeepSeek training checks, card (kernels, '
        'TF32 off) vs CPU (plain versions): fp32 moe-tiny at capacity '
        'factor 0.5 (real tokens dropped), deepseek-tiny and '
        'deepseek-tiny-moe-only, random norms, seq 1024 (so K1-K3 run for '
        'moe-tiny), a token mask and a loss mask: the loss, its load-balance'
        ' term and every gradient (two card runs bit-identical), then 2 '
        'Trainer steps; then train/launch.py --model moe-tiny resumed from '
        'a checkpoint')
    cases = (
        ('moe-tiny', dataclasses.replace(moe.MOE_TINY_F32,
                                         capacity_factor=0.5),
         moe, 'forward', TRAIN_KERNELS),
        ('deepseek-tiny', dataclasses.replace(deepseek.DEEPSEEK_TINY,
                                              dtype=torch.float32),
         deepseek, '_trunk', ()),
        ('deepseek-tiny-moe-only', dataclasses.replace(
            deepseek.DEEPSEEK_TINY_MOE_ONLY, dtype=torch.float32),
         deepseek, '_trunk', ()))
    rng = np.random.default_rng(34)
    b, s = 2, 1024
    seqs = rng.integers(0, 256, (b, s + 1))
    token_mask = np.ones((b, s), np.float32)
    token_mask[0, s - 37:] = 0.0
    token_mask[1, s - 300:] = 0.0
    cpu_batch = {
        'tokens': torch.from_numpy(seqs[:, :-1].copy()),
        'targets': torch.from_numpy(seqs[:, 1:].copy()),
        'mask': torch.from_numpy((rng.random((b, s)) < 0.7).astype(
            np.float32)),
        'token_mask': torch.from_numpy(token_mask)}
    for label, cfg, module, fn_name, wanted in cases:
        lib = models.module_for(cfg)
        cpu_params = small_routed_params(cfg, 34)
        runs, used = {}, {}
        for device in ('cuda', 'cpu'):
            batch = {k: v.to(device) for k, v in cpu_batch.items()}
            before = {k.name: k.launches for k in kernels.REGISTRY}
            outs = []
            for _ in range(2 if device == 'cuda' else 1):
                params = copy_to(cpu_params, device)
                leaves = flat_tree(params)
                for p in leaves.values():
                    p.requires_grad_(True)
                with capture_aux(module, fn_name) as aux:
                    loss = lib.loss_fn(cfg, params, batch['tokens'],
                                       batch['targets'],
                                       loss_mask=batch['mask'],
                                       token_mask=batch['token_mask'])
                grads = torch.autograd.grad(loss, list(leaves.values()))
                outs.append((float(loss), float(aux.values[-1]),
                             dict(zip(leaves, (g.detach().cpu()
                                               for g in grads)))))
            if device == 'cuda':
                torch.cuda.synchronize()
                same = outs[0][0] == outs[1][0] and all(
                    torch.equal(outs[0][2][k], outs[1][2][k])
                    for k in outs[0][2])
                if not same:
                    raise AssertionError(f'{label}: two card runs of the '
                                         'loss and its gradients differ')
            used[device] = {k.name: k.launches - before[k.name]
                            for k in kernels.REGISTRY}
            runs[device] = outs[0]
        (lc, ac, gc_), (lp, ap, gp) = runs['cuda'], runs['cpu']
        errs = {k: float((gc_[k] - gp[k]).abs().max()) for k in gp}
        worst = max(errs, key=errs.get)
        log(f'  {label}: loss card {lc:.7f} / CPU {lp:.7f}; load-balance '
            f'term {ac:.7f} / {ap:.7f}; {len(errs)} gradient leaves, largest'
            f' max_abs_err {errs[worst]:.3e} ({worst}; router '
            f'{max(e for k, e in errs.items() if "router" in k):.3e}); two '
            f'card runs bit-identical (tolerances: loss '
            f'{TRAIN_LOSS_ATOL:g}, term {ROUTED_AUX_ATOL:g}, gradients '
            f'{ROUTED_GRAD_ATOL:g}); card launches {used["cuda"]}')
        if (abs(lc - lp) > TRAIN_LOSS_ATOL or abs(ac - ap) > ROUTED_AUX_ATOL
                or errs[worst] > ROUTED_GRAD_ATOL or not ac > 0):
            raise AssertionError(f'{label}: the card and the CPU differ')
        for name, n in used['cuda'].items():
            if (n > 0) != (name in wanted):
                raise AssertionError(f'{label}: {name} ran {n} times on '
                                     f'the card: {used["cuda"]}')
        tcfg = trainer_lib.TrainConfig(
            model=cfg, global_batch_size=b, seq_len=s, learning_rate=1e-3,
            warmup_steps=1)
        steps = {}
        for device in ('cuda', 'cpu'):
            tr = trainer_lib.Trainer(tcfg, device=device)
            state = tr.init_state(copy_to(cpu_params, device))
            batch = {k: v.to(device) for k, v in cpu_batch.items()}
            metrics = []
            for _ in range(2):
                state, m = tr.step(state, batch)
                metrics.append((float(m['loss']), float(m['grad_norm'])))
            steps[device] = (metrics, {k: v.detach().cpu() for k, v in
                                       flat_tree(state['params']).items()})
        (card, card_p), (cpu, cpu_p) = steps['cuda'], steps['cpu']
        err = max(float((card_p[k] - cpu_p[k]).abs().max()) for k in cpu_p)
        log(f'    2 Trainer steps (adamw): card (loss, grad_norm) {card}; '
            f'CPU {cpu}; parameters max_abs_err {err:.3e}')
        for (l1, n1), (l2, n2) in zip(card, cpu):
            if abs(l1 - l2) > TRAIN_LOSS_ATOL or abs(n1 - n2) > (
                    TRAIN_NORM_RTOL * abs(n2)):
                raise AssertionError(f'{label}: Trainer steps differ')
        if err > TRAIN_PARAM_ATOL:
            raise AssertionError(f'{label}: parameters differ after two '
                                 'Trainer steps')
        release_card()
    with tempfile.TemporaryDirectory(prefix='xsky-moe-launch-') as tmp:
        ckpt = os.path.join(tmp, 'ckpt')
        common = ['--model', 'moe-tiny', '--global-batch-size', '2',
                  '--seq-len', '1024', '--log-every', '1', '--device',
                  'cuda']
        with short_warmup(1):
            solid = launch_run(common + ['--steps', '4'], 'moe-tiny launch',
                               n_layers=moe.MOE_TINY.n_layers)
            launch_run(common + ['--steps', '2', '--checkpoint-every', '2',
                                 '--checkpoint-dir', ckpt],
                       'moe-tiny launch (checkpoint)',
                       n_layers=moe.MOE_TINY.n_layers)
            resumed = launch_run(common + ['--steps', '4', '--resume', 'auto',
                                           '--checkpoint-dir', ckpt],
                                 'moe-tiny launch (resumed)',
                                 n_layers=moe.MOE_TINY.n_layers)
    if 'Resumed from checkpoint step 2.' not in resumed['log']:
        raise AssertionError(f'no resume line in {resumed["log"]}')
    if sorted(resumed['losses']) != [3, 4]:
        raise AssertionError(f'resumed run logged {resumed["losses"]}')
    errs = {k: abs(resumed['losses'][k] - solid['losses'][k]) /
            abs(solid['losses'][k]) for k in (3, 4)}
    log(f'  moe-tiny through train/launch.py (bf16, seq 1024): losses '
        f'{solid["losses"]}; resumed from step 2: {resumed["losses"]}, '
        f'relative differences {errs} (tolerance {RESUME_RTOL:g}), '
        f'bit-identical: {all(e == 0 for e in errs.values())}')
    if max(errs.values()) > RESUME_RTOL:
        raise AssertionError('resumed moe-tiny losses differ from the '
                             'uninterrupted run')
    del solid, resumed
    release_card()


# ---- phases 35 and 36: the classifier, and the workload hooks ----

# finetune_classifier.yaml's flags, with 60 steps in place of its 500.
CLASSIFY = dict(model='1b', batch=32, seq=256, lr='1e-4', steps=60,
                head_only_steps=5)
CLASSIFY_ARGS = ['--model', CLASSIFY['model'], '--batch-size',
                 str(CLASSIFY['batch']), '--seq-len', str(CLASSIFY['seq']),
                 '--lr', CLASSIFY['lr']]
# train()'s default held-out batches: one K1 launch per layer each.
CLASSIFY_EVAL_BATCHES = 4
# The reference test's settings (tests/unit_tests/test_classify.py).
CLASSIFY_SMALL = dict(seq=32, batch=8, lr=1e-3, steps=60, min_accuracy=0.8)


class classify_steps:
    """Wraps ``classify.make_train_step`` while a phase runs
    ``classify.main`` in-process for ``steps`` steps: the ends of the
    first and the last step after a wait for the card (the loop's
    tokens/s; no other step waits), a copy of the trunk as the first step
    found it, and the parameters after the last step."""

    def __init__(self, steps: int):
        from skypilot_tpu_torch.train import classify
        self.module, self.steps, self.calls = classify, steps, 0
        self.ends, self.before, self.params = [], None, None

    def __enter__(self):
        self.real = self.module.make_train_step

        def make(config, tx):
            step = self.real(config, tx)

            def timed(params, opt_state, batch):
                if self.before is None:
                    self.before = {k: v.detach().clone() for k, v in
                                   flat_tree(params['trunk']).items()}
                out = step(params, opt_state, batch)
                self.calls += 1
                if self.calls in (1, self.steps):
                    torch.cuda.synchronize()
                    self.ends.append(time.perf_counter())
                self.params = out[0]
                return out
            return timed

        self.module.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.module.make_train_step = self.real
        return False


def run_classify(steps: int, extra, label: str, want: dict) -> tuple:
    """classify.main in-process with the yaml's flags, ``--steps steps``
    and ``extra``; launch counts zeroed just before and read just after;
    every kernel held to ``want`` (absent: 0) → (the JSON line, the step
    capture, launches)."""
    from skypilot_tpu_torch.train import classify
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with classify_steps(steps) as cap, contextlib.redirect_stdout(out):
        classify.main(CLASSIFY_ARGS + ['--steps', str(steps)] + extra)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    lines = out.getvalue().strip().splitlines()
    for line in lines[:-1]:
        log(f'    {line}')
    line = json.loads(lines[-1])
    log(f'  {label}: {lines[-1]}; launches {launches}')
    if set(line) != {'metric', 'value', 'loss', 'model', 'steps'} or not (
            np.isfinite(line['loss']) and 0.0 <= line['value'] <= 1.0):
        raise AssertionError(f'{label}: last line {line}')
    check_derived_launches(label, launches, want)
    return line, cap, launches


def classifier_path(records: dict) -> None:
    from skypilot_tpu_torch.models import llama
    cfg, c = llama.LLAMA3_1B, CLASSIFY
    log(f'[35] the classifier: python -m skypilot_tpu_torch.train.classify '
        f'{" ".join(CLASSIFY_ARGS)} --steps {c["steps"]} (the '
        f'finetune_classifier.yaml flags, {c["steps"]} steps in place of '
        f'its 500) in-process: Llama-3-1B bf16 ({cfg.n_layers} layers), '
        f'random weights, the synthetic set, the flash kernels at seq '
        f'{c["seq"]}; then --head-only for {c["head_only_steps"]} steps; '
        'then the reference test\'s small check, card vs CPU')
    layers, steps = cfg.n_layers, c['steps']
    want = {'flash_fwd': layers * (steps + CLASSIFY_EVAL_BATCHES),
            'flash_bwd_dkv': layers * steps, 'flash_bwd_dq': layers * steps}
    line, cap, launches = run_classify(steps, [], 'full', want)
    loop_s = cap.ends[-1] - cap.ends[0]
    tok_s = (steps - 1) * c['batch'] * c['seq'] / loop_s
    log(f'  full: steps 2-{steps} in {loop_s:.3f} s: {tok_s:.1f} tokens/s, '
        f'{loop_s / (steps - 1) * 1e3:.2f} ms a step; eval accuracy '
        f'{line["value"]}, loss {line["loss"]}; peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on '
        f'{nvidia_smi_line()}')
    for name in TRAIN_KERNELS:
        records[name].setdefault('launches_by_path', {})['classify'] = (
            launches[name])
    del cap
    release_card()
    steps = c['head_only_steps']
    want = {'flash_fwd': layers * (steps + CLASSIFY_EVAL_BATCHES)}
    line, cap, launches = run_classify(steps, ['--head-only'], 'head-only',
                                       want)
    after = flat_tree(cap.params['trunk'])
    changed = [k for k, v in cap.before.items() if not torch.equal(
        v, after[k])]
    head_moved = float(cap.params['head']['w'].detach().abs().sum())
    log(f'  head-only: trunk leaves bit-identical after {steps} steps: '
        f'{not changed} ({len(after)} leaves); |head w| {head_moved:.4f}')
    if changed:
        raise AssertionError(f'head-only changed the trunk: {changed}')
    records['flash_fwd'].setdefault('launches_by_path', {})[
        'classify_head_only'] = launches['flash_fwd']
    del cap
    release_card()
    small_classifier_check()


def small_classifier_check() -> None:
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import classify
    from skypilot_tpu_torch.train import optim
    c = CLASSIFY_SMALL
    model = dataclasses.replace(llama.LLAMA_TINY, max_seq_len=c['seq'],
                                dtype=torch.float32, attention_impl='flash')
    cfg = classify.ClassifyConfig(model=model, num_classes=2,
                                  seq_len=c['seq'], batch_size=c['batch'],
                                  learning_rate=c['lr'])
    gen = torch.Generator()
    gen.manual_seed(35)
    cpu_params = classify.init(cfg, gen, 'cpu')
    gen.manual_seed(36)
    stream = classify.synthetic_batches(cfg, gen)
    cpu_batches = [next(stream) for _ in range(c['steps'] + 4)]
    runs, used = {}, {}
    for device in ('cuda', 'cpu'):
        params = to_device(cpu_params, device)
        batches = [{k: v.to(device) for k, v in bt.items()}
                   for bt in cpu_batches]
        tx = optim.adamw(lambda count: c['lr'], weight_decay=0.01)
        opt_state = classify.init_opt_state(cfg, tx, params)
        step = classify.make_train_step(cfg, tx)
        before = {k.name: k.launches for k in kernels.REGISTRY}
        losses = []
        for bt in batches[:c['steps']]:
            params, opt_state, loss = step(params, opt_state, bt)
            losses.append(loss)
        acc = np.mean([float(classify.eval_accuracy(cfg, params, bt))
                       for bt in batches[c['steps']:]])
        runs[device] = (np.array([float(x) for x in losses]), acc)
        used[device] = {k.name: k.launches - before[k.name]
                        for k in kernels.REGISTRY}
    (card, card_acc), (cpu, cpu_acc) = runs['cuda'], runs['cpu']
    err = float(np.abs(card - cpu).max())
    log(f'  small check (fp32 LLAMA_TINY, seq {c["seq"]}, B{c["batch"]}, lr '
        f'{c["lr"]}, {c["steps"]} steps, TF32 off, flash at D16): eval '
        f'accuracy card {card_acc:.4f} / CPU {cpu_acc:.4f} (want >= '
        f'{c["min_accuracy"]}); losses {card[0]:.6f} -> {card[-1]:.6f}, '
        f'card vs CPU max_abs_err {err:.3e} (tolerance {TRAIN_LOSS_ATOL:g}); '
        f'card launches {used["cuda"]}')
    if card_acc < c['min_accuracy'] or cpu_acc < c['min_accuracy']:
        raise AssertionError('the small classifier did not learn')
    if err > TRAIN_LOSS_ATOL:
        raise AssertionError('classifier losses differ between the card '
                             'and the CPU')
    for name, n in used['cuda'].items():
        if (n > 0) != (name in TRAIN_KERNELS):
            raise AssertionError(f'small classifier: {name} ran {n} times '
                                 f'on the card: {used["cuda"]}')


# The reference's capture keys (skypilot_tpu/agent/profiler.py run_capture).
CAPTURE_KEYS = {'ts', 'duration_s', 'out_dir', 'fake', 'device_kind',
                'num_devices', 'probe_compile_s', 'dispatch_probes',
                'dispatch_rtt_ms', 'device_matmul_ms', 'bytes_in_use',
                'bytes_limit', 'trace_files'}
HOOKS_SERVE = dict(slots=8, max_len=2048, prompts=8, prompt_len=(960, 1024),
                   new_tokens=32, sample_every=2)
HOOKS_CHAOS = dict(stall_s=0.2, stalled_ticks=2, gap_s=0.5)
HOOKS_TRAIN = dict(seq=2048, batch=1, steps=4, sample_every=2)


def spool_profile(spool: str) -> dict:
    with open(os.path.join(spool, 'rank-0.json')) as f:
        return json.load(f)['profile']


def check_profile(label: str, prof: dict) -> None:
    """What a sampled run's profile must show on the card: a probe that
    measured nothing fails here."""
    limit = torch.cuda.mem_get_info()[1]
    ok = (prof['steps_sampled'] >= 1 and prof['device_ema_s'] > 0
          and 0 < prof['dispatch_gap_ratio'] < 1
          and 0 < prof['hbm_bytes_in_use'] < prof['hbm_bytes_limit']
          and prof['hbm_bytes_limit'] == limit
          and prof['compiles_after_warmup'] == 0)
    log(f'    {label} profile: {json.dumps(prof)}')
    if not ok:
        raise AssertionError(f'{label}: the profile measured nothing or '
                             f'too little (card total {limit} bytes)')


def hooked_serving(records: dict, spool: str) -> None:
    from skypilot_tpu_torch.agent import profiler
    from skypilot_tpu_torch.agent import telemetry
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.utils import chaos
    cfg, c = llama.LLAMA3_1B, HOOKS_SERVE
    gen = torch.Generator(device='cuda')
    gen.manual_seed(36)
    engine = engine_lib.InferenceEngine(
        engine_lib.EngineConfig(model=cfg, max_slots=c['slots'],
                                max_target_len=c['max_len'],
                                prefill_buckets=(1024,)),
        llama.init(cfg, gen))
    steps = count_decode_steps(engine)
    waves = count_flash_waves(engine)
    rng = np.random.default_rng(36)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(*c['prompt_len'], c['prompts'])]

    def timed(fn, walls):
        def call():
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return call

    def serve(label, fast, decode_steps, path):
        profiler.reset_for_test()
        telemetry.reset_for_test()
        with mock.patch.dict(os.environ, {
                'XSKY_DECODE_FAST_TICK': '1' if fast else '0'}):
            orch = orch_lib.Orchestrator(engine, decode_steps=decode_steps)
        # Each tick's wall, and the wall of its decode work alone (the
        # tick less its chaos point): their difference is the stall.
        ticks, work = [], []
        for name, walls in (('_decode_tick', ticks),
                            ('_decode_tick_fast' if fast
                             else '_decode_tick_legacy', work)):
            setattr(orch, name, timed(getattr(orch, name), walls))
        steps[0] = waves[0] = 0
        zero_launches()
        t0 = time.perf_counter()
        out = orch.generate(prompts, max_new_tokens=c['new_tokens'])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.REGISTRY}
        check_derived_launches(label, launches, {
            'flash_fwd': cfg.n_layers * waves[0],
            'decode_attention': cfg.n_layers * steps[0]})
        for name in ('flash_fwd', 'decode_attention'):
            records[name].setdefault('launches_by_path', {})[path] = (
                launches[name])
        log(f'  {label}: {len(out)} x {c["new_tokens"]} tokens in {dt:.3f} '
            f's, {len(ticks)} ticks, {steps[0]} decode steps, {waves[0]} '
            f'flash waves; wasted rows {orch.wasted_decode_steps}; launches '
            f'{launches}')
        return out, [t - w for t, w in zip(ticks, work)], spool_profile(
            spool)

    streams = {}
    for label, fast, n, path in (('fast tick (decode_steps 4)', True, 4,
                                  'hooks_fast'),
                                 ('legacy tick, decode_steps 1', False, 1,
                                  'hooks_legacy_1'),
                                 ('legacy tick, decode_steps 4', False, 4,
                                  'hooks_legacy_4')):
        streams[label], _, prof = serve(label, fast, n, path)
        check_profile(label, prof)
    first = next(iter(streams.values()))
    same = all(s == first for s in streams.values())
    log(f'  greedy streams of the three ticks equal: {same}')
    if not same:
        raise AssertionError('the legacy and fast ticks give different '
                             'greedy streams')
    h = HOOKS_CHAOS
    chaos.load_plan({'points': {
        'infer.decode_stall': {'first_n': h['stalled_ticks'],
                               'latency_s': h['stall_s']},
        'profiler.dispatch_stall': {'gap_s': h['gap_s']}}})
    try:
        out, stalls, prof = serve('fast tick under a chaos plan', True, 4,
                                  'hooks_chaos')
        fired = chaos.fired()
    finally:
        chaos.clear()
    n = h['stalled_ticks']
    log(f'  chaos: fired {fired}; each tick longer than its decode work by '
        f'{[round(x, 4) for x in stalls]} s (want >= {h["stall_s"]} on the '
        f'first {n}, ~0 after); sampled gap EMA '
        f'{prof["dispatch_gap_ema_s"]:.4f} s (want >= {h["gap_s"]})')
    if (len(stalls) <= n
            or fired.get('infer.decode_stall') != n
            or fired.get('profiler.dispatch_stall') != prof['steps_sampled']
            or min(stalls[:n]) < h['stall_s']
            or max(stalls[n:]) >= h['stall_s']
            or prof['dispatch_gap_ema_s'] < h['gap_s']):
        raise AssertionError('the chaos points did not act as planned')
    if out != first:
        raise AssertionError('the stalled run changed the greedy streams')
    del engine
    release_card()


def hooked_training(records: dict) -> None:
    from skypilot_tpu_torch.agent import flight_recorder
    from skypilot_tpu_torch.agent import profiler
    from skypilot_tpu_torch.agent import telemetry
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer as trainer_lib
    t = HOOKS_TRAIN
    cfg = dataclasses.replace(llama.LLAMA3_1B, remat=True,
                              remat_policy='qkvo_gup')
    tcfg = trainer_lib.TrainConfig(model=cfg, global_batch_size=t['batch'],
                                   seq_len=t['seq'], optimizer='adafactor',
                                   warmup_steps=1)
    profiler.reset_for_test()
    telemetry.reset_for_test()
    flight_recorder.reset_for_test()
    trainer = trainer_lib.Trainer(tcfg)
    state = trainer.init_state()
    rng = np.random.default_rng(36)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (t['batch'], t['seq'] + 1)))
    batch = {'tokens': seq[:, :-1].cuda(), 'targets': seq[:, 1:].cuda()}
    torch.cuda.synchronize()
    zero_launches()
    with mock.patch.dict(os.environ, {
            'XSKY_PROFILE_SAMPLE_EVERY': str(t['sample_every'])}):
        for step in range(t['steps']):
            flight_recorder.begin_step(step)
            state, metrics = trainer.step(state, batch)
            flight_recorder.record_step(step)
    loss = float(metrics['loss'])
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_launches('hooked training', launches, TRAIN_KERNELS, cfg.n_layers)
    for name in TRAIN_KERNELS:
        records[name].setdefault('launches_by_path', {})['hooks_train'] = (
            launches[name])
    synced = [r['synced'] for r in
              flight_recorder.get_recorder().records()[::-1]]
    want = [(i + 1) % t['sample_every'] == 0 for i in range(t['steps'])]
    prof = profiler.snapshot()
    device = [r['phases']['device_compute'] for r in
              flight_recorder.get_recorder().records()[::-1]]
    log(f'  Trainer: Llama-3-1B, seq {t["seq"]}, B{t["batch"]}, '
        f'{t["steps"]} steps sampled every {t["sample_every"]}: loss '
        f'{loss:.4f}; records synced {synced}, device_compute {device}; '
        f'profile device EMA {prof["device_ema_s"]}, gap EMA '
        f'{prof["dispatch_gap_ema_s"]}; launches {launches}')
    if synced != want or not prof['device_ema_s'] or not all(
            device[i] > 0 for i, s in enumerate(want) if s):
        raise AssertionError('the sampled training steps were not synced '
                             'or measured no device time')
    del trainer, state
    release_card()


def profiler_capture() -> None:
    import tempfile
    with tempfile.TemporaryDirectory(prefix='xsky-capture-') as out:
        proc = subprocess.run(
            [sys.executable, '-m', 'skypilot_tpu_torch.agent.profiler',
             'capture', '--out', out, '--duration', '0.5'],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=180)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            raise AssertionError(f'capture failed ({proc.returncode}): '
                                 f'{proc.stderr[-2000:]}')
        summary = json.loads(lines[-1])
        with open(os.path.join(out, 'trace.json')) as f:
            events = json.load(f)['traceEvents']
    kernels_seen = sum(1 for e in events if e.get('cat') == 'kernel')
    log(f'  capture: {lines[-1]}; trace.json {len(events)} events, '
        f'{kernels_seen} of them device kernels')
    if (set(summary) != CAPTURE_KEYS or 'error' in summary
            or summary['device_kind'] != torch.cuda.get_device_name(0)
            or not summary['dispatch_rtt_ms'] > 0
            or not summary['device_matmul_ms'] > 0
            or not summary['probe_compile_s'] > 0):
        raise AssertionError(f'capture summary {summary}')


def hooks_path(records: dict) -> None:
    import shutil
    import tempfile
    from skypilot_tpu_torch.agent import telemetry
    c = HOOKS_SERVE
    log(f'[36] the workload hooks: Llama-3-1B bf16 served '
        f'({c["slots"]} slots x {c["max_len"]}, {c["prompts"]} prompts of '
        f'{c["prompt_len"][0]}-{c["prompt_len"][1]} tokens, '
        f'{c["new_tokens"]} new) by the fast tick and by the legacy tick '
        f'(XSKY_DECODE_FAST_TICK=0) at decode_steps 1 and 4, sampled every '
        f'{c["sample_every"]} ticks onto a telemetry spool; a chaos plan '
        '(infer.decode_stall, profiler.dispatch_stall); Trainer steps '
        'sampled every 2; the profiler\'s capture as a subprocess')
    spool = tempfile.mkdtemp(prefix='xsky-spool-')
    t0 = time.perf_counter()
    try:
        with mock.patch.dict(os.environ, {
                'XSKY_TELEMETRY_DIR': spool, 'XSKY_TELEMETRY_INTERVAL_S': '0',
                'XSKY_PROFILE_SAMPLE_EVERY': str(c['sample_every'])}):
            hooked_serving(records, spool)
        t1 = time.perf_counter()
        hooked_training(records)
    finally:
        telemetry.reset_for_test()
        shutil.rmtree(spool, ignore_errors=True)
    t2 = time.perf_counter()
    profiler_capture()
    log(f'  [36] seconds: serving {t1 - t0:.1f}, Trainer {t2 - t1:.1f}, '
        f'capture {time.perf_counter() - t2:.1f}')


# ---- phase 37: data-parallel, FSDP and tensor-parallel training over ranks

MESH_TRAIN = dict(model='llama3-1b-qkvo_gup', batch=4, seq=4096, steps=3,
                  fsdp_steps=1, data_steps=1)
MESH_SMALL = dict(model='mesh-fp32-d128', batch=4, seq=1024, steps=2)
# (g) Llama-3-8B's widths at 1 of its 32 layers (2 before phase 39), tensor=2
# (the train_llama3_8b.yaml recipe's tensor axis): 2 steps and their
# checkpoint, which one rank's Trainer loads for step 3 (the warm-up's
# step 1 has a learning rate of 0: step 2 is the first update). (h)
# Gemma2-2B's widths at 2 of its 26 layers (an even count: Gemma-2 pairs
# windowed and global layers; head_dim 256, softcaps, the window on layer
# 0) at tensor=2.
MESH_TENSOR = dict(model='llama3-8b-1l-qkvo_gup', layers=1, batch=2,
                   seq=4096, steps=3, saved=2)
MESH_GEMMA = dict(model='gemma2-2b-2l', layers=2, batch=1, seq=8192,
                  steps=1)
# Each tensor rank of (g) holds half of every split leaf and the whole
# wk, wv and norms: 638,595,072 parameters against one rank's
# 1,268,789,248 (at 2 layers 751,849,472 of 1,486,901,248; one layer is
# 218,112,000 whole, 113,254,400 a tensor rank).
MESH_TENSOR_PARAMS = 638_595_072
MESH_ONE_RANK_PARAMS = 1_268_789_248
# Two tensor ranks against one, bf16: the row-split products (wo,
# w_down, the embedding) are summed over the ranks in fp32 and rounded
# to bf16 once, where one rank's product rounds its own fp32 sum; the
# vocabulary-parallel cross-entropy adds its exponentials in another
# order. Steps 1 and 2 and the resumed step 3 within this, predicted ~1e-4.
MESH_TENSOR_RTOL = 1e-3
# Two ranks against one, bf16: step 1 differs only by the order of sums
# over ranks (the gradient's, the loss's); later steps also by the
# updates those differences make. fp32 (f): the order of sums alone.
MESH_FIRST_RTOL = 1e-3
MESH_LATER_RTOL = 1e-2
MESH_SMALL_ATOL = 1e-5
# The line a rank process runs: chip_smoke.mesh_rank on its arguments
# (the repository root, which holds this file, first on its path).
MESH_RANK_CODE = ('import sys; sys.path.insert(0, {root!r}); '
                  'import chip_smoke; '
                  'sys.exit(chip_smoke.mesh_rank(sys.argv[1:]))')


def mesh_models() -> dict:
    from skypilot_tpu_torch.models import deepseek
    from skypilot_tpu_torch.models import gemma
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import moe
    return {
        EP_MIXTRAL['model']: dataclasses.replace(
            moe.MIXTRAL_8X7B, n_layers=EP_MIXTRAL['layers']),
        EP_DEEPSEEK['model']: dataclasses.replace(
            deepseek.DEEPSEEK_V2_LITE, n_layers=EP_DEEPSEEK['layers']),
        MESH_SERVE_C['model']: dataclasses.replace(
            deepseek.DEEPSEEK_V2_LITE, n_layers=MESH_SERVE_C['layers']),
        MESH_TRAIN['model']: dataclasses.replace(
            llama.LLAMA3_1B, remat=True, remat_policy='qkvo_gup'),
        MESH_TENSOR['model']: dataclasses.replace(
            llama.LLAMA3_8B, n_layers=MESH_TENSOR['layers'], remat=True,
            remat_policy='qkvo_gup'),
        MESH_GEMMA['model']: dataclasses.replace(
            gemma.GEMMA2_2B, n_layers=MESH_GEMMA['layers']),
        MESH_SERVE_B['model']: dataclasses.replace(
            llama.LLAMA3_8B, n_layers=MESH_SERVE_B['layers']),
        # d_model 128, so adafactor factors statistics over the dim fsdp
        # splits; head_dim 32, which the flash kernels take.
        MESH_SMALL['model']: llama.LlamaConfig(
            vocab_size=256, d_model=128, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=256, max_seq_len=1024, dtype=torch.float32,
            remat=True, remat_policy='qkvo_gup'),
    }


def tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def mesh_numbers(out: dict, launches: dict) -> dict:
    """What a [37] run reports: its losses and grad norms by step, where
    it started, its kernel launches, this rank's parameter and
    optimizer-state bytes and the peak memory its process allocated."""
    from skypilot_tpu_torch.parallel import distributed
    return {'losses': {int(k): v for k, v in out['losses'].items()},
            'grad_norms': {int(k): v for k, v in out['grad_norms'].items()},
            'start_step': out['start_step'], 'launches': launches,
            'param_bytes': tensor_bytes(out['state']['params']),
            'params': sum(t.numel() for t in tensors(out['state']['params'])),
            'opt_bytes': tensor_bytes(out['state']['opt_state']),
            'peak_gib': torch.cuda.max_memory_allocated() / 2**30,
            'rank': distributed.rank(), 'world': distributed.world_size(),
            'backend': (torch.distributed.get_backend()
                        if torch.distributed.is_initialized() else None)}


def mesh_rank(argv) -> int:
    """One rank process of a gang that one launcher started
    (train/launch.py's ``main`` with ``--procs-per-host``, which sets
    XSKY_LOCAL_RANK): each run of the JSON list at ``argv[0]`` ({'argv':
    launcher flags, 'dump': a path or None}) through train/launch.py in
    turn (the process group comes up in the first run and serves the
    rest), the kernels counted from 0 before each; writes each run's
    mesh_numbers to ``rank<i>.json`` in the directory ``argv[1]`` and,
    where a run has a 'dump', its whole parameters there (rank 0). Its
    output goes to ``rank<i>.log`` there. The launcher's own arguments,
    after ``argv[1]``, are the first run's."""
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.train import launch
    local = os.environ[distributed.ENV_LOCAL_RANK]
    out = os.path.join(argv[1], f'rank{local}')
    fd = os.open(out + '.log', os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    with open(argv[0], encoding='utf-8') as f:
        runs = json.load(f)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s: %(message)s')
    rows = []
    try:
        with contextlib.ExitStack() as stack:
            for name, cfg in mesh_models().items():
                stack.enter_context(registered_config(name, cfg))
            stack.enter_context(short_warmup(1))
            for run in runs:
                zero_launches()
                torch.cuda.reset_peak_memory_stats()
                out_run = launch.run(launch.parse_args(run['argv']))
                torch.cuda.synchronize()
                rows.append(mesh_numbers(out_run, {
                    k.name: k.launches for k in kernels.REGISTRY}))
                if run['dump']:
                    host = out_run['trainer'].host_state(out_run['state'])
                    if rows[-1]['rank'] == 0:
                        torch.save(host['params'], run['dump'])
                    del host
                del out_run
                release_card()
    finally:
        distributed.shutdown()
    with open(out + '.json', 'w', encoding='utf-8') as f:
        json.dump(rows, f)
    return 0


def mesh_gang(runs, tmp: str, procs: int = 2) -> list:
    """``runs`` (see mesh_rank) in turn on one gang of ``procs`` rank
    processes sharing the card, started by one launcher: train/launch.py's
    ``main`` with the first run's flags and ``--procs-per-host procs``,
    each rank running mesh_rank. Per run, each rank's mesh_numbers in rank
    order. A failing rank fails the host (and the phase), the end of every
    rank's log printed; a rank that cannot reach its peers fails after
    ``distributed.TIMEOUT``."""
    from skypilot_tpu_torch.train import launch
    root = os.path.dirname(os.path.abspath(__file__))
    spec = os.path.join(tmp, 'gang-runs.json')
    with open(spec, 'w', encoding='utf-8') as f:
        json.dump(runs, f)
    argv = runs[0]['argv'] + ['--procs-per-host', str(procs)]
    log(f'  python -m skypilot_tpu_torch.train.launch {" ".join(argv)} '
        f'(launch.main, its {procs} rank processes running '
        'chip_smoke.mesh_rank, which registers the cut configs)')
    # The launcher's ranks run ``python`` + RANK_COMMAND + its arguments.
    with mock.patch.object(launch, 'RANK_COMMAND', (
            '-c', MESH_RANK_CODE.format(root=root), spec, tmp)):
        code = launch.main(argv)
    if code:
        for r in range(procs):
            path = os.path.join(tmp, f'rank{r}.log')
            if os.path.exists(path):
                with open(path, encoding='utf-8') as f:
                    log(f'  rank {r} log (end):\n' + f.read()[-3000:])
        raise AssertionError(f'gang of {procs}: the launcher exited with '
                             f'{code}')
    ranks = []
    for r in range(procs):
        with open(os.path.join(tmp, f'rank{r}.json'), encoding='utf-8') as f:
            rows = json.load(f)
        for row in rows:
            for key in ('losses', 'grad_norms'):
                row[key] = {int(k): v for k, v in row[key].items()}
        ranks.append(rows)
    return [list(per_run) for per_run in zip(*ranks)]


def mesh_derived(steps: int, model: str = MESH_TRAIN['model']) -> dict:
    """K1 twice a layer a step (the per-layer remat recomputes the flash
    forward), K2 and K3 once."""
    n = mesh_models()[model].n_layers
    return {'flash_fwd': 2 * n * steps, 'flash_bwd_dkv': n * steps,
            'flash_bwd_dq': n * steps}


def check_mesh_losses(label: str, got: dict, want: dict, steps) -> dict:
    """Relative differences of ``got`` against ``want`` at ``steps``:
    the first step within MESH_FIRST_RTOL, the rest MESH_LATER_RTOL."""
    diffs = {}
    for i, step in enumerate(steps):
        diffs[step] = abs(got[step] - want[step]) / abs(want[step])
        limit = MESH_FIRST_RTOL if i == 0 and step == 1 else MESH_LATER_RTOL
        if diffs[step] > limit:
            raise AssertionError(f'{label}: step {step} {got[step]} against '
                                 f'{want[step]} (rel {diffs[step]:.3e}, '
                                 f'limit {limit:g})')
    return diffs


def mesh_train_path(records: dict) -> None:
    import shutil
    import tempfile
    from skypilot_tpu_torch.train import launch
    r, small = MESH_TRAIN, MESH_SMALL
    cfg = mesh_models()[r['model']]
    tp, gm = MESH_TENSOR, MESH_GEMMA
    tcfg, gcfg = mesh_models()[tp['model']], mesh_models()[gm['model']]
    log(f'[37] data-parallel, FSDP and tensor-parallel training over '
        f'torch.distributed ranks: Llama-3-1B bf16 ({cfg.n_layers} layers, '
        f'd_model {cfg.d_model}, vocab {cfg.vocab_size}), remat qkvo_gup, '
        f'adafactor, global batch {r["batch"]}, seq {r["seq"]}, synthetic '
        'batches, warm-up cut to 1 step, through python -m '
        'skypilot_tpu_torch.train.launch: (a) one rank; (b) fsdp=2, (c) '
        'data=2 and (f) fp32 at d_model 128 on one gang of two rank '
        'processes sharing the card (gloo); (d) the fsdp checkpoint resumed '
        f'at data=1. On the same gang at --mesh data=1,fsdp=1,tensor=2: (g) '
        f'Llama-3-8B\'s widths at {tcfg.n_layers} of 32 layers (d_model '
        f'{tcfg.d_model}, {tcfg.n_heads}/{tcfg.n_kv_heads} heads, d_ff '
        f'{tcfg.d_ff}, vocab {tcfg.vocab_size}; remat qkvo_gup, adafactor, '
        f'seq {tp["seq"]}, global batch {tp["batch"]}), {tp["saved"]} steps '
        f'and their checkpoint, which one rank\'s Trainer loads for step '
        f'{tp["steps"]}, beside one rank\'s {tp["steps"]} steps; (h) '
        f'Gemma2-2B\'s widths at {gcfg.n_layers} of 26 layers (head_dim '
        f'{gcfg.head_dim}, softcaps, window {gcfg.sliding_window}), seq '
        f'{gm["seq"]}, {gm["steps"]} step beside one rank\'s')
    release_card()

    def flags(batch):
        return ['--model', r['model'], '--global-batch-size', str(batch),
                '--seq-len', str(r['seq']), '--optimizer', 'adafactor',
                '--device', 'cuda', '--log-every', '1']

    def tensor_flags(run, steps):
        return ['--model', run['model'], '--global-batch-size',
                str(run['batch']), '--seq-len', str(run['seq']),
                '--optimizer', 'adafactor', '--device', 'cuda',
                '--log-every', '1', '--steps', str(steps)]

    small_flags = ['--model', small['model'], '--global-batch-size',
                   str(small['batch']), '--seq-len', str(small['seq']),
                   '--optimizer', 'adafactor', '--device', 'cuda',
                   '--log-every', '1', '--learning-rate', '1e-3',
                   '--steps', str(small['steps'])]
    common = flags(r['batch'])
    seconds = {}
    with tempfile.TemporaryDirectory(prefix='xsky-mesh-') as tmp, \
            contextlib.ExitStack() as stack:
        for name, model in mesh_models().items():
            stack.enter_context(registered_config(name, model))
        stack.enter_context(short_warmup(1))

        def one_rank(argv, label, steps, model=r['model']):
            torch.cuda.reset_peak_memory_stats()
            out = launch_run(argv, label,
                             n_layers=mesh_models()[model].n_layers)
            check_derived_launches(label, out['launches'], mesh_derived(
                steps - out['start_step'], model))
            row = mesh_numbers(out, out['launches'])
            del out
            release_card()
            return row

        t0 = time.perf_counter()
        one = one_rank(common + ['--steps', str(r['steps']), '--mesh',
                                 'data=1'], '[37a] one rank', r['steps'])
        per_rank_batch = one_rank(
            flags(r['batch'] // 2) + ['--steps', '1', '--mesh', 'data=1'],
            '[37e] one rank at the per-rank batch', 1)
        out = launch.run(launch.parse_args(small_flags + ['--mesh',
                                                          'data=1']))
        want_small = out['trainer'].host_state(out['state'])['params']
        del out
        release_card()
        seconds['one rank'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        one_8b = one_rank(tensor_flags(tp, tp['steps']) + ['--mesh',
                                                           'data=1'],
                          '[37g] one rank', tp['steps'], tp['model'])
        one_gemma = one_rank(tensor_flags(gm, gm['steps']) + ['--mesh',
                                                              'data=1'],
                             '[37h] one rank', gm['steps'], gm['model'])
        seconds['one rank (g, h)'] = time.perf_counter() - t0
        ckpt = os.path.join(tmp, 'ckpt')
        ckpt_t = os.path.join(tmp, 'ckpt-tensor')
        metrics = os.path.join(tmp, 'metrics.jsonl')
        dump = os.path.join(tmp, 'small-params.pt')
        t0 = time.perf_counter()
        fsdp, data, small_ranks, tensor, tensor_gemma = mesh_gang([
            {'argv': common + ['--steps', str(r['fsdp_steps']), '--mesh',
                               'data=1,fsdp=2', '--checkpoint-dir', ckpt,
                               '--checkpoint-every', str(r['fsdp_steps']),
                               '--metrics-file', metrics], 'dump': None},
            {'argv': common + ['--steps', str(r['data_steps']), '--mesh',
                               'data=2'], 'dump': None},
            {'argv': small_flags + ['--mesh', 'data=1,fsdp=2'],
             'dump': dump},
            {'argv': tensor_flags(tp, tp['saved']) + [
                '--mesh', 'data=1,fsdp=1,tensor=2', '--checkpoint-dir',
                ckpt_t, '--checkpoint-every', str(tp['saved'])],
             'dump': None},
            {'argv': tensor_flags(gm, gm['steps']) + [
                '--mesh', 'data=1,fsdp=1,tensor=2'], 'dump': None}], tmp)
        seconds['gang'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = one_rank(common + ['--steps', str(r['steps']), '--mesh',
                                     'data=1', '--checkpoint-dir', ckpt,
                                     '--resume', 'auto'],
                           '[37d] resumed at data=1', r['steps'])
        seconds['resume'] = time.perf_counter() - t0
        # (g): the tensor run's step-2 checkpoint resumed at one rank for
        # step 3.
        t0 = time.perf_counter()
        resumed_8b = resume_at_one_rank('(g)', ckpt_t, tcfg, tp,
                                        'adafactor')
        seconds['tensor resume'] = time.perf_counter() - t0
        with open(metrics, encoding='utf-8') as f:
            rows = [json.loads(line) for line in f]
        got_small = torch.load(dump, weights_only=True)
    # (b), (c): every rank the same global losses, as one rank's.
    for label, ranks, n in (('fsdp=2', fsdp, r['fsdp_steps']),
                            ('data=2', data, r['data_steps'])):
        for row in ranks:
            if row['backend'] != 'gloo' or row['world'] != 2:
                raise AssertionError(f'{label}: rank {row["rank"]} on '
                                     f'{row["backend"]} of {row["world"]}')
            if row['losses'] != ranks[0]['losses'] or \
                    row['grad_norms'] != ranks[0]['grad_norms']:
                raise AssertionError(f'{label}: the ranks logged other '
                                     f'losses: {[x["losses"] for x in ranks]}')
            check_derived_launches(f'[37] {label} rank {row["rank"]}',
                                   row['launches'], mesh_derived(n))
        diffs = check_mesh_losses(label, ranks[0]['losses'], one['losses'],
                                  range(1, n + 1))
        norm_diff = abs(ranks[0]['grad_norms'][1] - one['grad_norms'][1]) / (
            one['grad_norms'][1])
        if norm_diff > MESH_LATER_RTOL:
            raise AssertionError(f'{label}: step 1 grad norm '
                                 f'{ranks[0]["grad_norms"][1]} against '
                                 f'{one["grad_norms"][1]}')
        log(f'  {label}: losses {ranks[0]["losses"]} against one rank\'s '
            f'{one["losses"]}: relative differences {diffs}; step 1 grad '
            f'norm {ranks[0]["grad_norms"][1]:.6f} against '
            f'{one["grad_norms"][1]:.6f} (rel {norm_diff:.3e}); both ranks '
            f'equal; backend gloo (the ranks share the card)')
    if [set(row) for row in rows] != [METRIC_KEYS] * r['fsdp_steps']:
        raise AssertionError(f'fsdp=2 metrics file: {len(rows)} rows {rows} '
                             '(want one per step, from rank 0 alone)')
    # (d): the fsdp run's last step, its checkpoint, resumed at data=1.
    if resumed['start_step'] != r['fsdp_steps']:
        raise AssertionError(f'the resume started at {resumed["start_step"]}')
    later = range(r['fsdp_steps'] + 1, r['steps'] + 1)
    diffs = check_mesh_losses('resumed at data=1', resumed['losses'],
                              one['losses'], later)
    log(f'  (d) the fsdp=2 step-{r["fsdp_steps"]} checkpoint resumed at '
        f'data=1: losses {resumed["losses"]} against the uninterrupted one '
        f'rank\'s: relative differences {diffs}')
    # (e) memory and launches.
    for row in fsdp:
        if 2 * row['param_bytes'] != one['param_bytes']:
            raise AssertionError(f'fsdp rank {row["rank"]} holds '
                                 f'{row["param_bytes"]} parameter bytes, '
                                 f'one rank {one["param_bytes"]}')
    log(f'  (e) parameter bytes: one rank {one["param_bytes"]}, each fsdp '
        f'rank {[x["param_bytes"] for x in fsdp]} (exactly half), each data '
        f'rank {[x["param_bytes"] for x in data]}; optimizer-state bytes: '
        f'one rank {one["opt_bytes"]}, fsdp ranks '
        f'{[x["opt_bytes"] for x in fsdp]}, data ranks '
        f'{[x["opt_bytes"] for x in data]}')
    log(f'  (e) peak memory (GiB, each process its own): one rank at batch '
        f'{r["batch"]} {one["peak_gib"]:.2f}, one rank at the per-rank batch '
        f'{r["batch"] // 2} {per_rank_batch["peak_gib"]:.2f}; fsdp ranks '
        f'{[round(x["peak_gib"], 2) for x in fsdp]}, data ranks '
        f'{[round(x["peak_gib"], 2) for x in data]}')
    paths = {'mesh_one_rank': one['launches'],
             'mesh_resumed': resumed['launches']}
    for label, ranks in (('mesh_fsdp', fsdp), ('mesh_data', data)):
        paths[label] = {name: sum(row['launches'][name] for row in ranks)
                        for name in fsdp[0]['launches']}
    for path, launches in paths.items():
        for name in TRAIN_KERNELS:
            records[name].setdefault('launches_by_path', {})[path] = (
                launches[name])
    log(f'  (e) launches per rank: fsdp {[x["launches"] for x in fsdp]}, '
        f'data {[x["launches"] for x in data]}: K1 = 2 x 16 x steps, K2 = '
        f'K3 = 16 x steps on each rank, nothing else')
    # (f): fp32, two ranks against one, both on the card.
    for row in small_ranks:
        if not all(row['launches'][name] for name in TRAIN_KERNELS):
            raise AssertionError(f'(f) rank {row["rank"]} launches '
                                 f'{row["launches"]}')
    err = max(float((a - b).abs().max()) for a, b in zip(
        tensors(got_small), tensors(want_small)))
    log(f'  (f) fp32 d_model 128, 2 ranks vs 1 on the card after '
        f'{small["steps"]} steps: max_abs_err {err:.3e} (tolerance '
        f'{MESH_SMALL_ATOL:g}); launches per rank '
        f'{[x["launches"] for x in small_ranks]}')
    if err > MESH_SMALL_ATOL:
        raise AssertionError(f'(f) parameters differ by {err:.3e}')
    mesh_tensor_checks(records, one_8b, tensor, resumed_8b, one_gemma,
                       tensor_gemma)
    seconds = json.dumps({k: round(v, 1) for k, v in seconds.items()})
    log(f'  [37] seconds: {seconds} on {nvidia_smi_line()}')


def mesh_tensor_checks(records, one, ranks, resumed, one_gemma,
                       gemma_ranks) -> None:
    """[37] (g) and (h): the tensor ranks against one rank."""
    tp, gm = MESH_TENSOR, MESH_GEMMA
    for label, rows, steps, model in (
            ('(g) tensor=2', ranks, tp['saved'], tp['model']),
            ('(h) tensor=2', gemma_ranks, gm['steps'], gm['model'])):
        for row in rows:
            if row['backend'] != 'gloo' or row['world'] != 2:
                raise AssertionError(f'{label}: rank {row["rank"]} on '
                                     f'{row["backend"]} of {row["world"]}')
            if row['losses'] != rows[0]['losses'] or \
                    row['grad_norms'] != rows[0]['grad_norms']:
                raise AssertionError(f'{label}: the ranks logged other '
                                     f'losses: {[x["losses"] for x in rows]}')
            # K1-K3 at the rank's local heads, counted in its process.
            check_derived_launches(f'[37] {label} rank {row["rank"]}',
                                   row['launches'],
                                   mesh_derived(steps, model))
    if one['params'] != MESH_ONE_RANK_PARAMS or any(
            row['params'] != MESH_TENSOR_PARAMS for row in ranks):
        raise AssertionError(
            f'(g) parameters: one rank {one["params"]}, tensor ranks '
            f'{[x["params"] for x in ranks]} (want {MESH_ONE_RANK_PARAMS} '
            f'and {MESH_TENSOR_PARAMS} each)')
    diffs = {}
    for label, got, want, step in (
            ('(g) step 1', ranks[0], one, 1),
            ('(h) step 1', gemma_ranks[0], one_gemma, 1),
            ('(g) step 2', ranks[0], one, 2),
            (f'(g) the tensor checkpoint resumed at one rank, step '
             f'{tp["steps"]}',
             resumed, one, tp['steps'])):
        diffs[label] = abs(got['losses'][step] - want['losses'][step]) / (
            abs(want['losses'][step]))
        if diffs[label] > MESH_TENSOR_RTOL:
            raise AssertionError(
                f'{label}: loss {got["losses"][step]} against '
                f'{want["losses"][step]} (rel {diffs[label]:.3e}, limit '
                f'{MESH_TENSOR_RTOL:g})')
    if resumed['start_step'] != tp['saved']:
        raise AssertionError(f'(g) the resume started at '
                             f'{resumed["start_step"]}')
    log(f'  (g) Llama-3-8B widths, 2 layers, tensor=2: parameters per rank '
        f'{[x["params"] for x in ranks]} ({[x["param_bytes"] for x in ranks]}'
        f' bytes) against one rank\'s {one["params"]} '
        f'({one["param_bytes"]} bytes; ratio '
        f'{ranks[0]["params"] / one["params"]:.4f}); optimizer-state bytes '
        f'{[x["opt_bytes"] for x in ranks]} against {one["opt_bytes"]}; peak '
        f'memory (GiB) {[round(x["peak_gib"], 2) for x in ranks]} against '
        f'{one["peak_gib"]:.2f}')
    log(f'  (g) losses: tensor ranks {ranks[0]["losses"]}, one rank '
        f'{one["losses"]}, the step-{tp["saved"]} checkpoint resumed at one '
        f'rank {resumed["losses"]}; grad norms {ranks[0]["grad_norms"]} '
        f'against {one["grad_norms"]}; relative differences '
        f'{json.dumps({k: float(f"{v:.3e}") for k, v in diffs.items()})} '
        f'(limit {MESH_TENSOR_RTOL:g}); both ranks equal')
    log(f'  (h) Gemma2-2B widths, 2 layers, tensor=2 (D 256 at '
        f'{mesh_models()[gm["model"]].n_heads // 2}/'
        f'{mesh_models()[gm["model"]].n_kv_heads // 2} local heads): loss '
        f'{gemma_ranks[0]["losses"]} against one rank\'s '
        f'{one_gemma["losses"]}; parameters per rank '
        f'{[x["params"] for x in gemma_ranks]} against '
        f'{one_gemma["params"]}; peak memory (GiB) '
        f'{[round(x["peak_gib"], 2) for x in gemma_ranks]} against '
        f'{one_gemma["peak_gib"]:.2f}')
    log(f'  (g)/(h) launches per rank: {[x["launches"] for x in ranks]}, '
        f'{[x["launches"] for x in gemma_ranks]}: K1 = 2 x 2 x steps, K2 = '
        'K3 = 2 x steps on each rank, nothing else')
    paths = {'mesh_tensor_one_rank': one['launches'],
             'mesh_tensor_resumed': resumed['launches'],
             'mesh_tensor_gemma_one_rank': one_gemma['launches']}
    for label, rows in (('mesh_tensor', ranks),
                        ('mesh_tensor_gemma', gemma_ranks)):
        paths[label] = {name: sum(row['launches'][name] for row in rows)
                        for name in rows[0]['launches']}
    for path, launches in paths.items():
        for name in TRAIN_KERNELS:
            records[name].setdefault('launches_by_path', {})[path] = (
                launches[name])


# Phase [38]: expert parallelism, each gang started by one launcher with
# --procs-per-host, its ranks sharing the card over gloo. (a) Mixtral-
# 8x7B's widths at 1 of 32 layers (2 before phase 39), AdamW, seq 4096, B2 at
# --mesh data=1,fsdp=1,expert=2: 2 steps and their checkpoint, resumed at
# one rank for step 3 (the warm-up's step 1 has a learning rate of 0, so
# step 2 is the first update the checkpoint holds); (b) DeepSeek-V2-Lite's
# at 2 of 27 layers (4 before phase 39; one dense, one routed layer),
# full-parameter AdamW, seq 4096, B2 at data=1,fsdp=2,expert=2
# (four ranks; the expert stacks cut on their expert and embed dims): 1
# step. Each beside one rank's run of the same flags.
EP_MIXTRAL = dict(model='mixtral-8x7b-1l', layers=1, batch=2, seq=4096,
                  steps=3, saved=2, mesh='data=1,fsdp=1,expert=2', procs=2)
EP_DEEPSEEK = dict(model='deepseek-v2-lite-2l', layers=2, batch=2, seq=4096,
                   steps=1, mesh='data=1,fsdp=2,expert=2', procs=4)
# Expert ranks against one rank, bf16, step 1 (loss and grad norm): the
# forward is one rank's but for the routed output's partials summed over
# the ranks in fp32 before the one rounding; the backward sums a token's
# dispatch gradient and the gate's over the ranks; (b) also sums its
# fsdp halves of every gradient. Predicted below 1e-5 ([37]'s tensor
# ranks read 3.688e-06). (a)'s step 2 (the same parameters on both sides,
# the next batch) and the resumed step 3 (after the gang's update, the
# first at a nonzero learning rate) are held to the same limit.
EP_RTOL = 1e-5


def split_params(cfg, plan: dict) -> int:
    """The parameters one rank holds at mesh ``plan`` (axis -> size):
    each leaf's elements over the sizes of the mesh axes its spec splits
    it over (every block equal), counted on the meta device."""
    from skypilot_tpu_torch import models
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    lib = models.module_for(cfg)
    shapes = flat_tree(lib.init(cfg, device='meta'))
    axes = flat_tree(lib.logical_axes(cfg))
    total = 0
    for path, leaf in shapes.items():
        parts = 1
        for entry in mesh_lib.logical_to_spec(axes[path]):
            for axis in (entry if isinstance(entry, tuple) else
                         (entry,) if entry else ()):
                parts *= plan.get(axis, 1)
        total += leaf.numel() // parts
    return total


class count_drops:
    """Counts the (token, choice) pairs ``moe.route`` keeps and routes
    while a run is made (the capacity drop's share)."""

    def __enter__(self):
        from skypilot_tpu_torch.models import moe
        self.module, self.real = moe, moe.route
        self.kept = self.routed = 0

        def counted(*args, **kwargs):
            r = self.real(*args, **kwargs)
            self.kept += int(r.keep.sum())
            self.routed += r.keep.numel()
            return r
        moe.route = counted
        return self

    def __exit__(self, *exc):
        self.module.route = self.real
        return False


def expert_flags(run: dict, steps: int) -> list:
    return ['--model', run['model'], '--global-batch-size', str(run['batch']),
            '--seq-len', str(run['seq']), '--optimizer', 'adamw',
            '--device', 'cuda', '--log-every', '1', '--steps', str(steps)]


def expert_train_path(records: dict) -> None:
    import shutil
    import tempfile
    from skypilot_tpu_torch.models import moe
    a, b = EP_MIXTRAL, EP_DEEPSEEK
    acfg, bcfg = mesh_models()[a['model']], mesh_models()[b['model']]
    log(f'[38] expert parallelism, each gang of rank processes started by '
        f'one python -m skypilot_tpu_torch.train.launch ... --procs-per-host'
        f' N (the ranks share the card over gloo), beside one rank\'s run of '
        f'the same flags: (a) Mixtral-8x7B\'s widths at {acfg.n_layers} of 32 '
        f'layers ({acfg.n_experts} experts of d_ff {acfg.d_ff}, top-'
        f'{acfg.experts_per_token}), bf16, remat, adamw, seq {a["seq"]}, '
        f'global batch {a["batch"]}, --mesh {a["mesh"]} ({a["procs"]} ranks):'
        f' {a["saved"]} steps and their checkpoint, resumed at one rank for '
        f'step {a["steps"]}; (b) '
        f'DeepSeek-V2-Lite\'s at {bcfg.n_layers} of 27 layers '
        f'({bcfg.n_experts} experts top-{bcfg.experts_per_token} + '
        f'{bcfg.n_shared_experts} shared, {bcfg.first_k_dense} dense layer),'
        f' full-parameter adamw, seq {b["seq"]}, global batch {b["batch"]}, '
        f'--mesh {b["mesh"]} ({b["procs"]} ranks): step 1')
    release_card()
    seconds = {}
    with tempfile.TemporaryDirectory(prefix='xsky-expert-') as tmp, \
            contextlib.ExitStack() as stack:
        for name, model in mesh_models().items():
            stack.enter_context(registered_config(name, model))
        stack.enter_context(short_warmup(1))

        def one_rank(argv, label, derived, drops=None):
            release_card()
            torch.cuda.reset_peak_memory_stats()
            with drops or contextlib.nullcontext():
                out = launch_run(argv, label, kernels_wanted=None)
            check_derived_launches(label, out['launches'], derived)
            row = mesh_numbers(out, out['launches'])
            del out
            release_card()
            return row

        t0 = time.perf_counter()
        a_derived = mesh_derived(a['saved'], a['model'])
        one_a = one_rank(expert_flags(a, a['steps']) + ['--mesh', 'data=1'],
                         '[38a] one rank', mesh_derived(a['steps'],
                                                        a['model']))
        drops = count_drops()
        one_b = one_rank(expert_flags(b, b['steps']) + ['--mesh', 'data=1'],
                         '[38b] one rank', {}, drops)
        seconds['one rank (a, b)'] = time.perf_counter() - t0
        ckpt = os.path.join(tmp, 'ckpt')
        t0 = time.perf_counter()
        gang_dir = os.path.join(tmp, 'gang-a')
        os.makedirs(gang_dir)
        # A fixed cadence: the launcher's automatic one would also save
        # the 25 GB state after step 1.
        (ranks_a,) = mesh_gang([{'argv': expert_flags(a, a['saved']) + [
            '--mesh', a['mesh'], '--checkpoint-dir', ckpt,
            '--checkpoint-every', str(a['saved'])], 'dump': None}],
            gang_dir, procs=a['procs'])
        seconds['gang (a)'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = resume_at_one_rank('(a)', ckpt, acfg, a, 'adamw')
        shutil.rmtree(ckpt)
        seconds['resume (a)'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gang_dir = os.path.join(tmp, 'gang-b')
        os.makedirs(gang_dir)
        (ranks_b,) = mesh_gang([{'argv': expert_flags(b, b['steps']) + [
            '--mesh', b['mesh']], 'dump': None}], gang_dir,
            procs=b['procs'])
        seconds['gang (b)'] = time.perf_counter() - t0
    diffs = {}
    for label, rows, one, run, derived in (
            ('(a)', ranks_a, one_a, a, a_derived),
            ('(b)', ranks_b, one_b, b, {})):
        cfg = mesh_models()[run['model']]
        plan = dict(kv.split('=') for kv in run['mesh'].split(','))
        want = split_params(cfg, {k: int(v) for k, v in plan.items()})
        for row in rows:
            if row['backend'] != 'gloo' or row['world'] != run['procs']:
                raise AssertionError(f'{label}: rank {row["rank"]} on '
                                     f'{row["backend"]} of {row["world"]}')
            if row['losses'] != rows[0]['losses'] or \
                    row['grad_norms'] != rows[0]['grad_norms']:
                raise AssertionError(f'{label}: the ranks logged other '
                                     f'losses: {[x["losses"] for x in rows]}')
            check_derived_launches(f'[38] {label} rank {row["rank"]}',
                                   row['launches'], derived)
            if row['params'] != want:
                raise AssertionError(f'{label}: rank {row["rank"]} holds '
                                     f'{row["params"]} parameters, want '
                                     f'{want}')
        if one['params'] != split_params(cfg, {}):
            raise AssertionError(f'{label}: one rank holds {one["params"]}')
        for key in ('losses', 'grad_norms'):
            for step in rows[0][key]:
                got, ref = rows[0][key][step], one[key][step]
                diffs[f'{label} step {step} {key}'] = abs(got - ref) / abs(ref)
        log(f'  {label} --mesh {run["mesh"]}: losses {rows[0]["losses"]} '
            f'against one rank\'s {one["losses"]}, grad norms '
            f'{rows[0]["grad_norms"]} against {one["grad_norms"]}; all '
            f'{run["procs"]} ranks '
            f'equal; parameters per rank {[x["params"] for x in rows]} '
            f'against one rank\'s {one["params"]} (ratio '
            f'{rows[0]["params"] / one["params"]:.4f}; bytes '
            f'{[x["param_bytes"] for x in rows]} against '
            f'{one["param_bytes"]}); optimizer-state bytes '
            f'{[x["opt_bytes"] for x in rows]} against {one["opt_bytes"]}; '
            f'peak memory (GiB, each process its own) '
            f'{[round(x["peak_gib"], 2) for x in rows]} against one rank\'s '
            f'{one["peak_gib"]:.2f}; launches per rank '
            f'{[x["launches"] for x in rows]}')
    if resumed['start_step'] != a['saved']:
        raise AssertionError(f'(a) the resume started at '
                             f'{resumed["start_step"]}')
    step = a['steps']
    diffs[f'(a) resumed step {step} loss'] = abs(
        resumed['losses'][step] - one_a['losses'][step]) / abs(
            one_a['losses'][step])
    log(f'  (a) the gang\'s step-{a["saved"]} checkpoint resumed at one rank:'
        f' step {step} loss {resumed["losses"][step]!r} against the '
        f'uninterrupted one rank\'s {one_a["losses"][step]!r} (the '
        f'parameters that the gang\'s step {a["saved"]} moved at the full '
        'learning rate)')
    log(f'  (b) capacity: {moe.expert_capacity(bcfg, b["batch"] * b["seq"])}'
        ' places an expert; the one '
        f'rank\'s routing kept {drops.kept} of {drops.routed} (token, choice)'
        f' pairs: dropped share {1 - drops.kept / drops.routed:.4f} (the '
        'routing is the same on every expert rank)')
    log(f'  [38] relative differences '
        f'{json.dumps({k: float(f"{v:.3e}") for k, v in diffs.items()})} '
        f'(limit {EP_RTOL:g})')
    for label, diff in diffs.items():
        if diff > EP_RTOL:
            raise AssertionError(f'[38] {label}: rel {diff:.3e} > {EP_RTOL:g}')
    if drops.kept >= drops.routed:
        raise AssertionError('(b) no (token, choice) pair was dropped')
    paths = {'expert_one_rank': one_a['launches'],
             'expert_resumed': resumed['launches'],
             'expert_ranks': {name: sum(row['launches'][name]
                                        for row in ranks_a)
                              for name in ranks_a[0]['launches']}}
    for path, launches in paths.items():
        for name in TRAIN_KERNELS:
            records[name].setdefault('launches_by_path', {})[path] = (
                launches[name])
    seconds = json.dumps({k: round(v, 1) for k, v in seconds.items()})
    log(f'  [38] seconds: {seconds} on {nvidia_smi_line()}')


def resume_at_one_rank(label: str, ckpt: str, cfg, run: dict,
                       optimizer: str) -> dict:
    """A gang's checkpoint (its last step) loaded by one rank's Trainer,
    built as train/launch.py builds it for the run's flags, which runs
    the next step on the launcher's synthetic batch of that step (no
    checkpoint written after it, as a relaunch with --resume auto would
    write one). The launch counts cover that step."""
    from skypilot_tpu_torch.train import launch
    from skypilot_tpu_torch.train import trainer as trainer_lib
    release_card()
    manager = launch.StepCheckpoints(ckpt)
    step = manager.latest_step()
    t0 = time.perf_counter()
    host = manager.restore(step)
    with short_warmup(1):
        tr = trainer_lib.Trainer(trainer_lib.TrainConfig(
            model=dataclasses.replace(cfg, max_seq_len=max(
                cfg.max_seq_len, run['seq'])),
            global_batch_size=run['batch'], seq_len=run['seq'],
            optimizer=optimizer), device='cuda')
    state = tr.load_state(host)
    del host
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    zero_launches()
    state, metrics = tr.step(state, tr.synthetic_batch(step))
    loss = float(metrics['loss'])
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    check_derived_launches(f'{label} the gang\'s checkpoint resumed at one '
                           'rank', launches, mesh_derived(1, run['model']))
    log(f'  {label} the gang\'s step-{step} checkpoint loaded by one rank\'s '
        f'Trainer in {restore_s:.1f} s')
    del state, tr
    release_card()
    return {'start_step': int(step), 'losses': {int(step) + 1: loss},
            'launches': launches}


# ---- phase 39: serving under a mesh ----

# Phase [39]: a replica as a gang of rank processes sharing the card over
# gloo (one `python -m skypilot_tpu_torch.infer.server --procs-per-host N`
# launcher each, its ranks running chip_smoke.serve_rank, which registers
# the cut configs and reports each rank's numbers through files), each
# beside one rank: (a) serve_mixtral.yaml's replica at --mesh expert=2
# against [30]'s own outputs; (b) Llama-3-8B's widths at 4 of 32 layers
# at --mesh data=2,tensor=2; (c) DeepSeek-V2-Lite's at 4 of 27 layers at
# --mesh data=2,expert=2. No speed is claimed for ranks sharing a card.
# (a)'s concurrent prompts are [30]'s, every fourth cut to 1024 tokens
# and the others to 512: none is prefilled in chunks, so the 16 requests
# come in two waves (4 rows of the 1024 bucket, which runs K1, and 12
# padded to 16 of the 512 bucket) and ~16 decode steps, where [30]'s
# whole prompts (nine longer than the largest bucket, 1024) take ~84
# (each chunk a tick of 4 decode steps); the 3500-token single still
# runs the chunked prefill under the mesh. All 16 at 1024 make one
# 16 x 1024 wave, more than two ranks sharing the card hold beside
# their weights and caches.
MESH_SERVE_A = dict(model='mixtral-8x7b', mesh='expert=2', procs=2,
                    weight='int8', slots=16, max_len=4096, new_tokens=16,
                    concurrent_new=16, concurrent_lens=(1024, 512, 512, 512))
MESH_SERVE_B = dict(model='llama3-8b-4l', layers=4, mesh='data=2,tensor=2',
                    procs=4, slots=16, max_len=2048, requests=16,
                    prompt_len=(960, 1024), new_tokens=32,
                    singles=(1000, 600, 300), kill_new=512, kill_after_s=2.0)
MESH_SERVE_C = dict(model='deepseek-v2-lite-4l', layers=4,
                    mesh='data=2,expert=2',
                    procs=4, slots=8, max_len=2048, requests=8,
                    prompt_len=(960, 1024), new_tokens=16, singles=(1000,))
# First-token logprobs of a gang against one rank's (bf16 or int8 weights;
# the tensor split adds bf16 partial products in fp32, the expert split
# two fp32 terms, in another order than one rank's product).
MESH_LP_ATOL = 0.05
# A greedy stream may part from one rank's only where one rank's top-2
# logprob gap is at most this (a near-tie under the same tolerance).
MESH_TIE = MESH_LP_ATOL
# How long a gang with a killed follower may take to fail as one.
MESH_KILL_S = 60
SERVE_RANK_CODE = ('import sys; sys.path.insert(0, {root!r}); '
                   'import chip_smoke; '
                   'sys.exit(chip_smoke.serve_rank(sys.argv[1:]))')
SERVE_LAUNCHER_CODE = ('import sys; sys.path.insert(0, {root!r}); '
                       'import chip_smoke; '
                       'sys.exit(chip_smoke.serve_launcher(sys.argv[1:]))')


def engine_kv_bytes(engine) -> int:
    """Bytes of an engine's slot cache (K and V, values and scales)."""
    import math
    size = (1 if engine.config.kv_dtype == torch.int8
            else torch.tensor([], dtype=engine.config.kv_dtype).element_size())
    return (math.prod(engine._k_shape) + math.prod(engine._v_shape)) * size


class RankWatch:
    """One serving rank's numbers for [39], through files in ``ctl``:
    after the engine is built, ``rank<i>-build.json`` (its place in the
    mesh, weight and cache bytes, the build's seconds and peak); then a
    thread answers each ``cmd-<n>`` the phase writes: 'zero' sets the
    kernel counts, the decode steps, flash waves, decoded tokens and the
    peak to 0, 'read' writes them to ``rank<i>-<n>.json``. The phase
    writes a command only while the gang is idle."""

    def __init__(self, ctl: str, local: str) -> None:
        self.ctl, self.local = ctl, local
        self.tokens = []
        self.first = None

    def attach(self, engine, build_s: float) -> None:
        from skypilot_tpu_torch.ops import quantization as qops
        from skypilot_tpu_torch.parallel import distributed
        self.steps = count_decode_steps(engine)
        self.waves = count_flash_waves(engine)
        step = engine._decode_step_impl

        def logged(state, *args, **kwargs):
            # Per step: every slot's token, and before it the active
            # flags, last tokens and lengths (the streams of requests
            # served one at a time follow from them: slot_streams).
            before = [state[k].tolist() for k in ('active', 'tokens',
                                                   'lengths')]
            out = step(state, *args, **kwargs)
            self.tokens.append([out[1][0].tolist()] + before)
            return out

        engine._decode_step_impl = logged
        whole = engine._whole_logits

        def first_logits(logits):
            # The first logits after 'zero': the first single's first
            # token (a one-row prefill, or a chunked prompt's last chunk).
            out = whole(logits)
            if self.first is None:
                lp = torch.log_softmax(out[0].float(), dim=-1)
                self.first = (float(lp.max()), torch.topk(lp, 5).values
                              .tolist())
            return out

        engine._whole_logits = first_logits
        lay = engine.layout
        c = engine.config.model
        wq = engine.params.get('layers', engine.params.get('moe_layers'))
        self._write('build', {
            'rank': distributed.rank(), 'world': distributed.world_size(),
            'pid': os.getpid(),
            'backend': torch.distributed.get_backend(),
            'mesh': engine.mesh.shape, 'slot_block': lay.slot_block,
            'q_heads': (wq['wq'].shape[-1] // c.head_dim
                        if 'wq' in wq and hasattr(c, 'head_dim') else None),
            'kv_heads': engine._n_kv,
            'param_bytes': qops.params_nbytes(engine.params),
            'kv_bytes': engine_kv_bytes(engine), 'build_s': build_s,
            'build_peak_gib': torch.cuda.max_memory_allocated() / 2**30})
        import threading
        threading.Thread(target=self._serve, daemon=True).start()

    def _write(self, name: str, row: dict) -> None:
        path = os.path.join(self.ctl, f'rank{self.local}-{name}.json')
        with open(path + '.tmp', 'w', encoding='utf-8') as f:
            json.dump(row, f)
        os.replace(path + '.tmp', path)

    def _serve(self) -> None:
        n = 0
        while True:
            path = os.path.join(self.ctl, f'cmd-{n}')
            if not os.path.exists(path):
                time.sleep(0.05)
                continue
            with open(path, encoding='utf-8') as f:
                cmd = f.read().strip()
            if cmd == 'zero':
                zero_launches()
                self.steps[0] = self.waves[0] = 0
                self.tokens.clear()
                self.first = None
                torch.cuda.reset_peak_memory_stats()
                self._write(str(n), {'allocated_gib':
                                     torch.cuda.memory_allocated() / 2**30})
            else:
                torch.cuda.synchronize()
                self._write(str(n), {
                    'launches': {k.name: k.launches
                                 for k in kernels.REGISTRY},
                    'steps': self.steps[0], 'waves': self.waves[0],
                    'tokens': list(self.tokens),
                    'first': self.first,
                    'peak_gib': torch.cuda.max_memory_allocated() / 2**30})
            n += 1


def serve_rank(argv) -> int:
    """One rank process of a serving gang (``server.main`` with
    ``--procs-per-host``, XSKY_LOCAL_RANK set): the cut configs
    registered, the engine's numbers reported (RankWatch, in the
    directory ``argv[0]``, where its output goes to ``rank<i>.log``),
    then the server's ``main`` on ``argv[1:]``."""
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.parallel import distributed
    ctl = argv[0]
    local = os.environ[distributed.ENV_LOCAL_RANK]
    fd = os.open(os.path.join(ctl, f'rank{local}.log'),
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    watch = RankWatch(ctl, local)
    build = server_lib.build_engine

    def built(args):
        t0 = time.perf_counter()
        engine = build(args)
        torch.cuda.synchronize()
        watch.attach(engine, time.perf_counter() - t0)
        return engine

    with contextlib.ExitStack() as stack:
        for name, cfg in mesh_models().items():
            stack.enter_context(registered_config(name, cfg))
        stack.enter_context(mock.patch.object(server_lib, 'build_engine',
                                              built))
        return server_lib.main(argv[1:])


def serve_launcher(argv) -> int:
    """The launcher of a serving gang: ``server.main`` on ``argv[1:]``,
    its ranks running serve_rank with the directory ``argv[0]``."""
    from skypilot_tpu_torch.infer import server as server_lib
    root = os.path.dirname(os.path.abspath(__file__))
    server_lib.RANK_COMMAND = ('-c', SERVE_RANK_CODE.format(root=root),
                               argv[0])
    with contextlib.ExitStack() as stack:
        for name, cfg in mesh_models().items():    # its flags name them
            stack.enter_context(registered_config(name, cfg))
        return server_lib.main(argv[1:])


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _alive(pid: int) -> bool:
    try:
        with open(f'/proc/{pid}/stat', encoding='utf-8') as f:
            return f.read().rsplit(')', 1)[1].split()[0] != 'Z'
    except OSError:
        return False


class MeshServer:
    """A serving gang on the card: one launcher subprocess
    (serve_launcher) and its rank processes."""

    def __init__(self, label: str, flags, procs: int, tmp: str) -> None:
        root = os.path.dirname(os.path.abspath(__file__))
        self.label, self.procs = label, procs
        self.ctl = os.path.join(tmp, label.strip('()'))
        os.makedirs(self.ctl, exist_ok=True)
        self.url = None
        port = _free_port()
        argv = flags + ['--procs-per-host', str(procs), '--port', str(port)]
        log(f'  {label} python -m skypilot_tpu_torch.infer.server '
            f'{" ".join(argv)} (its ranks run chip_smoke.serve_rank)')
        self.log_file = open(os.path.join(self.ctl, 'launcher.log'), 'w')
        # The ranks share the card: their allocators return what they
        # free (no reserved-but-unused segments held apart).
        self.proc = subprocess.Popen(
            [sys.executable, '-c', SERVE_LAUNCHER_CODE.format(root=root),
             self.ctl, *argv], stdout=self.log_file,
            stderr=subprocess.STDOUT, env=dict(
                os.environ,
                PYTORCH_CUDA_ALLOC_CONF='expandable_segments:True'))
        self.url = f'http://127.0.0.1:{port}'
        self.pids = []
        self.n = 0

    def logs(self) -> str:
        out = []
        for name in ['launcher'] + [f'rank{r}' for r in range(self.procs)]:
            path = os.path.join(self.ctl, f'{name}.log')
            if os.path.exists(path):
                with open(path, encoding='utf-8', errors='replace') as f:
                    out.append(f'  {name} log (end):\n' + f.read()[-2500:])
        return '\n'.join(out)

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f'[39] {self.label} {what}\n{self.logs()}')

    def wait_healthy(self, timeout: float) -> float:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            self.check(self.proc.poll() is None,
                       f'the launcher exited with {self.proc.poll()}')
            try:
                if json.loads(http_json(self.url, '/health', timeout=5))[
                        'status'] == 'healthy':
                    return time.perf_counter() - t0
            except OSError:
                pass
            time.sleep(0.5)
        self.check(False, f'no /health within {timeout} s')
        return 0.0

    def read(self, name: str) -> list:
        rows = []
        for r in range(self.procs):
            path = os.path.join(self.ctl, f'rank{r}-{name}.json')
            deadline = time.perf_counter() + 60
            while not os.path.exists(path):
                self.check(time.perf_counter() < deadline,
                           f'rank {r} wrote no {name}')
                time.sleep(0.05)
            with open(path, encoding='utf-8') as f:
                rows.append(json.load(f))
        return rows

    def command(self, cmd: str) -> list:
        """Every rank's answer to ``cmd`` (sent while the gang is idle:
        the last engine call's cleanup on a follower may trail rank 0's
        answer, so the gang settles first)."""
        time.sleep(1.0)
        path = os.path.join(self.ctl, f'cmd-{self.n}')
        with open(path + '.tmp', 'w', encoding='utf-8') as f:
            f.write(cmd)
        os.replace(path + '.tmp', path)
        rows = self.read(str(self.n))
        self.n += 1
        return rows

    def gone(self, timeout: float = 30.0) -> bool:
        deadline = time.perf_counter() + timeout
        while (any(_alive(p) for p in self.pids + [self.proc.pid])
               and time.perf_counter() < deadline):
            time.sleep(0.1)
        return not any(_alive(p) for p in self.pids + [self.proc.pid])

    def stop(self) -> None:
        """SIGTERM to the launcher: every rank ends (143), none is left."""
        import signal
        self.proc.send_signal(signal.SIGTERM)
        code = self.proc.wait(60)
        self.check(code == 128 + signal.SIGTERM,
                   f'SIGTERM: the launcher exited with {code}')
        self.check(self.gone(), 'left a rank process after SIGTERM')

    def kill(self) -> None:
        import signal
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for pid in self.pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self.log_file.close()


def http_body(spec: dict) -> tuple:
    """(route, body) of a single request: /generate, or for a penalized
    one /v1/completions (greedy, the prompt as ids)."""
    if 'presence_penalty' not in spec:
        return '/generate', spec
    return '/v1/completions', {
        'prompt': spec['prompt_tokens'], 'max_tokens':
            spec['max_new_tokens'], 'temperature': 0.0,
        'presence_penalty': spec['presence_penalty'],
        'frequency_penalty': spec['frequency_penalty']}


def slot_streams(log) -> list:
    """The streams of requests served one at a time, from a rank's decode
    log (per step: next tokens, then the active flags, last tokens and
    lengths before it): each run of steps with one active slot whose
    length grows by one a step is a request, its stream the slot's last
    token at its first step (its prefill's token) and then its token of
    each step."""
    streams, slot, length = [], None, None
    for toks, active, last, lengths in log:
        on = [i for i, a in enumerate(active) if a]
        if len(on) != 1:
            slot = None
            continue
        s = on[0]
        if s != slot or lengths[s] != length + 1:
            streams.append([last[s]])
        streams[-1].append(toks[s])
        slot, length = s, lengths[s]
    return streams


def held_stream(label: str, got, want, top, tie: float = MESH_TIE) -> str:
    """``got`` equals ``want`` (one rank's stream, whose steps' sorted
    top logprobs are ``top``; for a sampled stream, its Gumbel-perturbed
    scores' two best), or parts from it at a near-tie: a step where one
    rank's top-2 gap is at most ``tie``. → what was seen."""
    if got == want:
        return 'equal'
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    gap = top[j][0] - top[j][1] if j < len(top) else float('inf')
    if gap > tie:
        raise AssertionError(
            f'[39] {label}: parts from one rank at step {j} ({got[j:j+3]} '
            f'for {want[j:j+3]}) with one rank\'s top-2 gap {gap:.5f} > '
            f'{MESH_TIE}: not a near-tie')
    return f'parts at step {j}, top-2 gap {gap:.5f}'


def held_logprobs(label: str, got: tuple, want: tuple) -> float:
    err = max([abs(got[0] - want[0])] + [
        abs(a - b) for a, b in zip(got[1], want[1])])
    if err > MESH_LP_ATOL:
        raise AssertionError(f'[39] {label}: first-token logprobs {got} '
                             f'against one rank\'s {want}: {err:.5f} > '
                             f'{MESH_LP_ATOL}')
    return err


def expected_rank_bytes(cfg, mesh_spec: str, world: int, rank: int,
                        weight_dtype) -> int:
    """The weight bytes a rank holds at ``mesh_spec``: the whole tree's
    meta init (quantized as drawn) cut to the rank's serving blocks."""
    from skypilot_tpu_torch import models
    from skypilot_tpu_torch.ops import quantization as qops
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import launch
    lib = models.module_for(cfg)
    mesh = mesh_lib.build_mesh(launch.parse_mesh(mesh_spec), world=world,
                               rank=rank)
    with mock.patch.object(mesh_lib.Mesh, 'group', lambda self, axes: None):
        splits = mesh_lib.serving_splits(mesh, lib.logical_axes(cfg),
                                         lib.init(cfg, device='meta'))
    return qops.params_nbytes(mesh_lib.block_tree(
        lib.init(cfg, device='meta', weight_dtype=weight_dtype), splits))


def check_mesh_ranks(label: str, gang: MeshServer, built: list, read: list,
                     derived, whole_kv: int, kv_parts: int, cfg,
                     weight_dtype, mesh_spec: str) -> dict:
    """Per rank: the weight bytes its blocks come to, its cache
    ``whole_kv / kv_parts`` bytes, its kernels as ``derived(row)`` gives
    them from its own steps and waves (each kernel of the path at least
    once), and every rank decoding the same tokens, bit for bit."""
    for r, (b, row) in enumerate(zip(built, read)):
        want = expected_rank_bytes(cfg, mesh_spec, len(built), r,
                                   weight_dtype)
        gang.check(b['param_bytes'] == want,
                   f'rank {r}: {b["param_bytes"]} weight bytes, its blocks '
                   f'come to {want}')
        gang.check(b['kv_bytes'] * kv_parts == whole_kv,
                   f'rank {r}: {b["kv_bytes"]} cache bytes, one rank\'s '
                   f'{whole_kv} / {kv_parts}')
        want_launches = derived(row)
        check_derived_launches(f'{label} rank {r}', row['launches'],
                               want_launches)
        gang.check(all(row['launches'][k] > 0 for k in want_launches),
                   f'rank {r}: a kernel of the path never ran: '
                   f'{row["launches"]}')
    gang.check(all(row['tokens'] == read[0]['tokens'] for row in read),
               'the ranks decoded different tokens')
    return {k: sum(row['launches'][k] for row in read)
            for k in read[0]['launches']}


def one_rank_singles(flags, singles):
    """One rank's replica (build_replica, in this process) for ``flags``:
    the singles served one at a time through its orchestrator with
    top-5 logprobs, as [39]'s gangs get them over HTTP → (streams, each
    step's sorted top logprobs, first-token (chosen, top-5), weight
    bytes, cache bytes)."""
    from skypilot_tpu_torch.infer import orchestrator as orch_lib
    from skypilot_tpu_torch.infer import sampling
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.ops import quantization as qops
    replica = server_lib.build_replica(server_lib.parse_args(
        flags + ['--port', '0']), host='127.0.0.1')
    sample = sampling.sample_batched
    margins = []

    def sample_noted(logits, generator, temperature, top_k=None,
                     top_p=None, rows=None):
        # A sampled row's margin between its two best Gumbel-perturbed
        # scores (the noise drawn again from the generator's state).
        state = None if generator is None else generator.get_state()
        out = sample(logits, generator, temperature, top_k, top_p, rows)
        if state is not None:
            again = torch.Generator(device=generator.device)
            again.set_state(state)
            scaled = sampling.filter_logits(logits, temperature, top_k,
                                            top_p)
            u = torch.rand(scaled.shape, generator=again,
                           device=scaled.device).clamp_(min=1e-20)
            best = torch.topk(scaled - torch.log(-torch.log(u)), 2).values
            hot = temperature > 0
            if hot.any():
                margins.append(float((best[:, 0] - best[:, 1])[hot].max()))
        return out

    try:
        orch = replica.loop.orch
        streams, tops, first = [], [], []
        with replica.loop._lock, mock.patch.object(
                sampling, 'sample_batched', sample_noted):
            for body in singles:
                margins.clear()
                q = orch.submit(orch_lib.Request(
                    prompt_tokens=body['prompt_tokens'],
                    max_new_tokens=body['max_new_tokens'], logprobs=5,
                    eos_token_id=body.get('eos_token_id'),
                    temperature=body.get('temperature', 0.0),
                    top_p=body.get('top_p', 1.0),
                    presence_penalty=body.get('presence_penalty', 0.0),
                    frequency_penalty=body.get('frequency_penalty', 0.0)))
                orch.run_until_drained(max_steps=256)
                streams.append(q.output_tokens)
                tops.append([sorted(d.values(), reverse=True)
                             for d in q.top_logprobs])
                first.append((q.token_logprobs[0], tops[-1][0]))
                if body.get('temperature', 0.0) > 0:
                    # Its steps' perturbed margins, as [v, v - margin]
                    # pairs held_stream reads as a gap.
                    tops[-1] = [[0.0, -m] for m in margins[:len(
                        q.output_tokens)]]
        return (streams, tops, first, qops.params_nbytes(
            replica.engine.params), engine_kv_bytes(replica.engine))
    finally:
        replica.httpd.server_close()
        replica.loop.close()
        del replica
        release_card()


def mesh_gang_serve(label: str, flags, procs: int, tmp: str, singles,
                    bodies, health_s: float):
    """Start a gang, wait for /health, count from 0, serve ``singles``
    one at a time (the first also for its first-token logprobs) and
    ``bodies`` at once → (gang, build rows, read rows, singles' streams,
    first-token logprobs, seconds)."""
    gang = MeshServer(label, flags, procs, tmp)
    seconds = {}
    try:
        seconds['health'] = gang.wait_healthy(health_s)
        built = gang.read('build')
        gang.pids = [row['pid'] for row in built]
        warm = gang.command('zero')
        log(f'  {label} ranks up in {seconds["health"]:.1f} s: weights '
            f'{[x["param_bytes"] for x in built]} bytes, cache '
            f'{[x["kv_bytes"] for x in built]}, build peaks '
            f'{[round(x["build_peak_gib"], 2) for x in built]} GiB, '
            f'allocated once warm {[round(x["allocated_gib"], 2) for x in warm]}'
            ' GiB')
        t0 = time.perf_counter()
        served = [http_json(gang.url, *http_body(body)) for body in singles]
        seconds['singles'] = time.perf_counter() - t0
        # The streams as rank 0 decoded them (/generate takes no
        # penalties: the penalized single goes through /v1/completions,
        # whose text drops ids past the byte range).
        streams = slot_streams(gang.command('read')[0]['tokens'])
        gang.check(len(streams) == len(singles) and all(
            s == x['output_tokens'] for s, x in zip(streams, served)
            if 'output_tokens' in x), f'rank 0\'s streams {streams} '
            f'against the served {served}')
        if bodies:
            _, seconds['concurrent'] = concurrent_generate(
                gang.url, bodies, 10**9)
        read = gang.command('read')
        first = read[0]['first']
        gang.check(all(row['first'] == first for row in read),
                   'the ranks\' first-token logprobs differ')
    except BaseException:
        log(gang.logs())
        gang.kill()
        raise
    return gang, built, read, streams, first, seconds


def serve_mesh_path(records: dict) -> None:
    import tempfile
    release_card()   # the ranks share the card with this process
    tmp = tempfile.mkdtemp(prefix='xsky-mesh-serve-')
    log('[39] serving under a mesh: gangs of rank processes sharing the '
        'card over gloo, each started by one server launcher, beside one '
        f'rank; this process holds {torch.cuda.memory_reserved() / 2**30:.2f}'
        ' GiB of the card')
    paths = {'mesh_serve_a': mesh_serve_mixtral(tmp),
             'mesh_serve_b': mesh_serve_llama(tmp),
             'mesh_serve_c': mesh_serve_deepseek(tmp)}
    for path, launches in paths.items():
        for name, n in launches.items():
            if n:
                records[name].setdefault('launches_by_path', {})[path] = n
    log(f'  [39] on {nvidia_smi_line()}')


def mesh_serve_mixtral(tmp: str) -> dict:
    """(a) serve_mixtral.yaml at --mesh expert=2 against [30] → the
    ranks' summed launches."""
    from skypilot_tpu_torch import models
    a, ref = MESH_SERVE_A, MIXTRAL_REFERENCE
    cfg = models.get_config(a['model'])
    log(f'  (a) {a["model"]} int8 at --mesh {a["mesh"]} ({a["procs"]} '
        f'ranks: {cfg.n_experts // 2} experts each, the attention, router, '
        'embedding and head whole) against [30]\'s own outputs; [30]\'s '
        f'concurrent prompts cut in turn to {a["concurrent_lens"]} tokens')
    flags = ['--model', a['model'], '--weight-dtype', a['weight'],
             '--max-slots', str(a['slots']), '--max-target-len',
             str(a['max_len']), '--mesh', a['mesh']]
    singles = [{'prompt_tokens': p, 'max_new_tokens': a['new_tokens']}
               for p in ref['singles']]
    cut = a['concurrent_lens']
    bodies = [{'prompt_tokens': p[:cut[i % len(cut)]],
               'max_new_tokens': a['concurrent_new']}
              for i, p in enumerate(ref['prompts'])]
    gang, built, read, streams, first, seconds = mesh_gang_serve(
        '(a)', flags, a['procs'], tmp, singles, bodies, 900)
    try:
        derived = (lambda row: {'flash_fwd': cfg.n_layers * row['waves'],
                                'decode_attention': cfg.n_layers
                                * row['steps']})
        launches = check_mesh_ranks('(a)', gang, built, read, derived,
                                    ref['kv_bytes'], 1, cfg, torch.int8,
                                    a['mesh'])
        shares = [b['param_bytes'] / ref['param_bytes'] for b in built]
        err = held_logprobs('(a)', first, (ref['logprobs'][0][0],
                                          ref['top'][0][0]))
        n = a['new_tokens']    # [30]'s first n of its 32
        held = held_stream('(a) the 3500-token single', streams[0],
                           ref['streams'][0][:n], ref['top'][0][:n])
        log(f'  (a) each rank {[b["param_bytes"] for b in built]} weight '
            f'bytes ({[round(x, 4) for x in shares]} of [30]\'s '
            f'{ref["param_bytes"]}), cache {built[0]["kv_bytes"]} bytes (the '
            'slots are whole over expert), build '
            f'{[round(b["build_s"], 1) for b in built]} s, build peaks '
            f'{[round(b["build_peak_gib"], 2) for b in built]} GiB, serving '
            f'peaks {[round(x["peak_gib"], 2) for x in read]} GiB; kernels '
            f'per rank {[nonzero(x["launches"]) for x in read]} = '
            f'{cfg.n_layers} layers x (waves, steps) '
            f'{[(x["waves"], x["steps"]) for x in read]}; the single: '
            f'{held}; first-token logprobs within {err:.6f} of [30]\'s '
            f'(limit {MESH_LP_ATOL}); both ranks decoded the same tokens; '
            f'seconds {rounded(seconds)}')
        gang.stop()
    finally:
        gang.kill()
    release_card()
    return launches


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def rounded(seconds: dict) -> str:
    return json.dumps({k: round(v, 1) for k, v in seconds.items()})


def mesh_prompts(rng, vocab: int, lengths) -> list:
    return [[int(t) for t in rng.integers(0, vocab, int(n))]
            for n in lengths]


def mesh_serve_llama(tmp: str) -> dict:
    """(b) Llama-3-8B's widths at 4 layers, data=2 x tensor=2, beside one
    rank; a follower killed mid-decode → the ranks' summed launches."""
    import signal
    import threading
    from skypilot_tpu_torch.infer import tokenizer as tokenizer_lib
    b = MESH_SERVE_B
    cfg = mesh_models()[b['model']]
    rng = np.random.default_rng(39)
    g, sampled, penalized = mesh_prompts(rng, cfg.vocab_size, b['singles'])
    n = b['new_tokens']
    singles = [{'prompt_tokens': g, 'max_new_tokens': n},
               {'prompt_tokens': sampled, 'max_new_tokens': n,
                'temperature': 0.8, 'top_p': 0.9},
               {'prompt_tokens': penalized, 'max_new_tokens': n,
                'presence_penalty': 0.5, 'frequency_penalty': 0.5,
                'eos_token_id': tokenizer_lib.ByteTokenizer(
                    cfg.vocab_size).eos_token_id}]
    bodies = [{'prompt_tokens': p, 'max_new_tokens': n}
              for p in mesh_prompts(rng, cfg.vocab_size, rng.integers(
                  b['prompt_len'][0], b['prompt_len'][1] + 1,
                  b['requests']))]
    base = ['--model', b['model'], '--max-slots', str(b['slots']),
            '--max-target-len', str(b['max_len'])]
    log(f'  (b) {b["model"]} (Llama-3-8B\'s widths, {b["layers"]} of 32 '
        f'layers, bf16) at --mesh {b["mesh"]} ({b["procs"]} ranks), beside '
        'one rank of the same depth and seed')
    with registered_config(b['model'], cfg):
        one = one_rank_singles(base, singles)
    gang, built, read, streams, first, seconds = mesh_gang_serve(
        '(b)', base + ['--mesh', b['mesh']], b['procs'], tmp, singles,
        bodies, 300)
    try:
        derived = (lambda row: {'flash_fwd': cfg.n_layers * row['waves'],
                                'decode_attention': cfg.n_layers
                                * row['steps']})
        launches = check_mesh_ranks('(b)', gang, built, read, derived,
                                    one[4], 4, cfg, None, b['mesh'])
        heads = (cfg.n_heads // 2, cfg.n_kv_heads // 2)
        gang.check(all((x['q_heads'], x['kv_heads']) == heads
                       for x in built), 'local heads '
                   f'{[(x["q_heads"], x["kv_heads"]) for x in built]}')
        err = held_logprobs('(b)', first, one[2][0])
        # The sampled single's scores are logits / T with the same noise:
        # its tie is MESH_TIE / T.
        helds = [held_stream(f'(b) single {i}', s, w, t, MESH_TIE / max(
            body.get('temperature', 1.0), 1e-6)) for i, (s, w, t, body)
                 in enumerate(zip(streams, one[0], one[1], singles))]
        log(f'  (b) each rank {[x["param_bytes"] for x in built]} weight '
            f'bytes (one rank {one[3]}), cache {built[0]["kv_bytes"]} bytes '
            f'= one rank\'s {one[4]} / 4, {heads[0]} query and {heads[1]} KV '
            f'heads a rank; peaks {[round(x["peak_gib"], 2) for x in read]} '
            f'GiB; kernels per rank {[nonzero(x["launches"]) for x in read]}'
            f' = {cfg.n_layers} layers x (waves, steps) '
            f'{[(x["waves"], x["steps"]) for x in read]}; greedy, sampled '
            f'(0.8, top-p 0.9) and penalized singles against one rank: '
            f'{helds}; first-token logprobs within {err:.6f} (limit '
            f'{MESH_LP_ATOL}); all {b["procs"]} ranks decoded the same '
            f'tokens; seconds {rounded(seconds)}')
        # A follower killed while a request decodes: the request and the
        # gang fail within MESH_KILL_S, no process left.
        outcome = []

        def request():
            try:
                outcome.append(http_json(gang.url, '/generate', {
                    'prompt_tokens': g, 'max_new_tokens': b['kill_new']},
                    timeout=MESH_KILL_S))
            except Exception as e:  # pylint: disable=broad-except
                outcome.append(e)
        thread = threading.Thread(target=request, daemon=True)
        thread.start()
        time.sleep(b['kill_after_s'])
        t0 = time.perf_counter()
        os.kill(gang.pids[-1], signal.SIGKILL)
        code = gang.proc.wait(MESH_KILL_S)
        thread.join(MESH_KILL_S)
        gang.check(code == 128 + signal.SIGKILL,
                   f'the launcher exited with {code} after a follower\'s '
                   'SIGKILL')
        gang.check(bool(outcome) and not isinstance(outcome[0], dict),
                   f'the request in flight did not fail: {outcome}')
        gang.check(gang.gone(), 'left a rank process after the kill')
        log(f'  (b) a follower SIGKILLed mid-decode: the gang ended with '
            f'{code} and the request failed ({type(outcome[0]).__name__}) '
            f'in {time.perf_counter() - t0:.1f} s (limit {MESH_KILL_S}); no '
            'process left')
    finally:
        gang.kill()
    release_card()
    return launches


def mesh_serve_deepseek(tmp: str) -> dict:
    """(c) DeepSeek-V2-Lite's widths at 4 layers, data=2 x expert=2,
    beside one rank → the ranks' summed launches."""
    c = MESH_SERVE_C
    cfg = mesh_models()[c['model']]
    rng = np.random.default_rng(391)
    singles = [{'prompt_tokens': p, 'max_new_tokens': c['new_tokens']}
               for p in mesh_prompts(rng, cfg.vocab_size, c['singles'])]
    bodies = [{'prompt_tokens': p, 'max_new_tokens': c['new_tokens']}
              for p in mesh_prompts(rng, cfg.vocab_size, rng.integers(
                  c['prompt_len'][0], c['prompt_len'][1] + 1,
                  c['requests']))]
    base = ['--model', c['model'], '--max-slots', str(c['slots']),
            '--max-target-len', str(c['max_len'])]
    log(f'  (c) {c["model"]} (DeepSeek-V2-Lite\'s widths, 4 of 27 layers, '
        f'bf16, dense MLA cache) at --mesh {c["mesh"]} ({c["procs"]} '
        'ranks), beside one rank')
    with registered_config(c['model'], cfg):
        one = one_rank_singles(base, singles)
    gang, built, read, streams, first, seconds = mesh_gang_serve(
        '(c)', base + ['--mesh', c['mesh']], c['procs'], tmp, singles,
        bodies, 300)
    try:
        derived = (lambda row: {'mla_decode': cfg.n_layers * row['steps']})
        launches = check_mesh_ranks('(c)', gang, built, read, derived,
                                    one[4], 2, cfg, None, c['mesh'])
        local = c['slots'] // 2
        gang.check(all(x['slot_block'][1] - x['slot_block'][0] == local
                       for x in built), 'local slots')
        err = held_logprobs('(c)', first, one[2][0])
        held = held_stream('(c) the single', streams[0], one[0][0],
                           one[1][0])
        log(f'  (c) each rank {[x["param_bytes"] for x in built]} weight '
            f'bytes (one rank {one[3]}), cache {built[0]["kv_bytes"]} bytes '
            f'= one rank\'s {one[4]} / 2 (slots '
            f'{[tuple(x["slot_block"]) for x in built]}); peaks '
            f'{[round(x["peak_gib"], 2) for x in read]} GiB; kernels per '
            f'rank {[nonzero(x["launches"]) for x in read]} = '
            f'{cfg.n_layers} layers x steps {[x["steps"] for x in read]} '
            f'over {local} local slots; the single: {held}; first-token '
            f'logprobs within {err:.6f} (limit {MESH_LP_ATOL}); all ranks '
            f'decoded the same tokens; seconds {rounded(seconds)}')
        gang.stop()
    finally:
        gang.kill()
    release_card()
    return launches


def hopper_kernels(build_log: str):
    """(name, registers, spill-store bytes) of each wgmma kernel and
    pre-pass, of the fp32 flash backward at D 256, of the decode split
    walks and combine at the main paths' types (bf16 queries and cache,
    D 128 and 256), and of the MLA tensor-core walks (bf16 cache), in an
    nvcc -Xptxas -v log."""
    for chunk in build_log.split('Compiling entry function')[1:]:
        mangled = chunk.split("'")[1]
        found = re.search(r'(flash_[a-z_]+_(?:wgmma|rowstats)_kernel)ILi(\d+)',
                          mangled) or re.search(
            r'(flash_bwd_[a-z]+_fma_kernel)ILi(256)E', mangled) or re.search(
            r'((?:paged_)?decode_kernel)I13__nv_bfloat16S\w*?_Li'
            r'((?:128|256)ELi\d)E',
            mangled) or re.search(
            r'(decode_combine_kernel)I13(__nv_bfloat16)E',
            mangled) or re.search(
            r'((?:paged_)?mla_decode_tc_kernel)E', mangled)
        regs = re.search(r'Used (\d+) registers', chunk)
        spill = re.search(r'(\d+) bytes spill stores', chunk)
        if found and regs:
            args = (f'<{found.group(2)}>'.replace('ELi', ', groups <= ')
                    if found.lastindex > 1 else '')
            yield (f'{found.group(1)}{args}', int(regs.group(1)),
                   int(spill.group(1)) if spill else 0)


def main() -> int:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py needs a CUDA device; none found.')
    log(f'[1] device: {torch.cuda.get_device_name(0)} x '
        f'{torch.cuda.device_count()}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}')
    smi = nvidia_smi_line()
    log(f'  nvidia-smi: {smi}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('  TF32 off for fp32 matmuls and cuDNN')
    t0 = time.perf_counter()
    seconds = kernels.build_all()
    log(f'[2] built {len(kernels.REGISTRY)} kernels from {len(seconds)} '
        f'sources in {time.perf_counter() - t0:.2f} s wall: {seconds}')
    logs = {kern.source: kern.build_log for kern in kernels.REGISTRY}
    for source, build_log in sorted(logs.items()):
        regs = re.findall(r'Used (\d+) registers', build_log)
        spills = re.findall(r'(\d+) bytes spill stores', build_log)
        if regs:
            log(f'  {source}: {len(regs)} kernel instantiations, at most '
                f'{max(map(int, regs))} registers, '
                f'{sum(map(int, spills))} bytes spilled')
        for chunk in build_log.split('Compiling entry function')[1:]:
            spilled = re.search(r'(\d+) bytes spill stores', chunk)
            if spilled and int(spilled.group(1)):
                log(f'    spills {spilled.group(1)} bytes: '
                    f'{chunk.split(chr(39))[1]}')
        for name, regs, spill in hopper_kernels(build_log):
            note = (' at entry (setmaxnreg then splits them)'
                    if 'wgmma' in name or 'rowstats' in name else '')
            log(f'    {name}: {regs} registers{note}, {spill} bytes spilled')
            if name.startswith('flash_bwd') and '<256>' in name and spill:
                raise AssertionError(f'{name} spills {spill} bytes')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    records = {'flash_fwd': check_flash(gen), **check_flash_bwd(gen),
               'decode_attention': check_decode(gen),
               'paged_decode_attention': check_paged_decode(gen),
               'mla_decode': check_mla_decode(gen),
               'paged_mla_decode': check_paged_mla_decode(gen)}
    main_path(records)
    small_end_to_end()
    train_result = train_main_path(records)
    small_train_check()
    paged_main_path(records)
    small_paged_end_to_end()
    deepseek_main_paths(records)
    small_deepseek_end_to_end()
    quantized_replica(records, 'int8')
    quantized_replica(records, 'int4')
    small_quantized_end_to_end()
    launch_main_path(records, train_result)
    lora_main_path(records)
    hf_checkpoint_path(records)
    small_launch_checks()
    plain_qwen = qwen_replica(records)
    qwen2_main_path(records)
    small_qwen_end_to_end()
    spec_qwen_replica(records, plain_qwen)
    draft_model_paths(records)
    small_speculative_end_to_end()
    gemma2_replica(records)
    small_gemma_end_to_end()
    gemma_train_path(records)
    small_gemma_train_checks()
    mixtral_replica(records)
    small_mixtral_end_to_end()
    mixtral_train_path(records)
    deepseek_train_path(records)
    small_routed_train_checks()
    classifier_path(records)
    hooks_path(records)
    mesh_train_path(records)
    expert_train_path(records)
    serve_mesh_path(records)
    for rec in records.values():
        rec['launches'] = sum(rec['launches_by_path'].values())
    log(f'[total] chip_smoke wall time {time.perf_counter() - start:.1f} s '
        '(limit 1200 s)')
    print(json.dumps({'kernels': list(records.values())}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
