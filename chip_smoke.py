#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports nothing of JAX or of the JAX package ``src/repro``. Phases, each of
which raises on failure:

1. setup: the card's name and power limit, TF32 off, the kernels built
   from ``src/repro_torch/csrc`` (build seconds printed), and the
   attention kernels' registers, spills and tensor-core/FFMA counts from
   the ptxas log and the SASS (``flash_build``: bf16 must run on HGMMA;
   ``decode_build``: bf16 must run on HMMA); ``loss_build``: the vocab
   pass's registers and spills and the clusters of 1-8 blocks the card
   holds at once;
2. each attention kernel against its plain PyTorch version at the serving
   path's shapes (Qwen2.5-7B's heads, StableLM-2-12B's 32/8 heads at hd
   160, and the 48/8 heads at hd 128 of Grok-1 and InternVL2-26B), in
   bf16 and fp32, with its time through the wrapper beside
   its C entry alone, the plain version's,
   ``F.scaled_dot_product_attention``'s (timed as a yardstick only; the
   port never calls it: with the band as its mask, and for flash without
   a window also with ``is_causal``) and the card's bound; decode rows
   also carry the kernel's device time from ``torch.profiler`` and count
   in their bound only the bytes of the valid keys; the decode kernel's
   paged mode (the continuous engine's rounds) reads page pools through
   shuffled page tables at phase 3's slots and at the rollout benchmark
   cell's 256 x 2304 keys, with idle slots on page 0, held to the plain
   version on the gathered views and bit for bit to the dense mode, and
   timed beside the gather and the dense mode; the output's
   ``decode_attention`` entry is the paged row (``dense_ms`` beside it);
3. the continuous-batching engine serving full-width Qwen2.5-7B (all 28
   layers, vocab 152,064, random weights from a seed): 16 requests,
   4 slots, 32 new tokens each; the launch counts of both kernels over
   this run;
4. the fixed engine (``rl.sampling.generate``) at the same width;
5. teacher-forced consistency: a full forward (flash kernel) over finished
   sequences reproduces the logprobs their decode steps (decode kernel)
   recorded, in bf16 and in an fp32 run;
6. a ``torch.profiler`` trace of a short serving run: device time by
   kernel and the device's idle share;
6b. ``launch.serve``'s supervised fleet over the same weights and the 16
    prompts, 16 new tokens each: 2 continuous-engine replicas, a seeded
    injector crashing a quarter of the requests; every request answered
    exactly once, a restart counted, ids within the vocab, both attention
    kernels launched; then the serving weights are freed;
7. the training path's kernels (``grpo_logprob``, ``fused_rl_loss``
   forward and backward) against their plain versions at vocabs 152,064
   and 65,024 (4096 rows, and the trainer's micro-batch of 4 x 79 rows),
   at 256,000 (the trainer's rows), at the byte vocab 259 (rows off the
   16-byte grid), at 131,072 (16 x 79 rows), at the odd 92,553 (8 x 79
   rows), at 73,448 (4 x 79), at 102,400 (16 x 79) and at the odd 51,865
   (16 x 79), bf16 and fp32, timed beside the plain versions, a
   one-call ``torch.log_softmax``/``torch.softmax`` yardstick and the
   card's bound; the two forward kernels also through their C entries
   alone, with their device time from ``torch.profiler`` and the blocks a
   row their entry chose (``nsplit``, held to the wrapper's mirror);
8. one GRPO micro-batch of full-width Qwen2.5-7B cut to 2 layers, through
   the kernels and through the plain loss, in bf16 and fp32 compute: loss,
   stats and every parameter's gradient agree, and the attention weights
   get a gradient;
9. ``Trainer.fit`` at that width, async, KL on, continuous rollout: 3
   steps of 16 samples, the launch counts of all five kernels over the
   run, wall, samples/s, weight-sync quantiles, peak memory, stage busy
   shares;
10. a ``torch.profiler`` trace of one actor update (forward, loss,
    backward, AdamW): device time by kernel and the device's idle share;
10a. the planner (``core/planner``): the reduced Qwen profiled on the
    card (``decode_attention`` and both loss kernels at the reduced
    shape), the cost model's seconds on the card's figures (``HW()``)
    beside phase 9's measured ones, a stage by stage and a decode-step
    ratio, the measured reduced decode over its bound beside the
    reference's 1.15, plans for a 128-card cluster; then ``Trainer.fit``
    as in phase 9 with ``auto_size_workers`` and a live rebalance every
    0.5 s, its worker cap reckoned from the card's memory: every sized
    and resized count within the cap, ``actor_update`` at 1, the
    controller stepped, the rows' ids below the vocab and logprobs finite
    and at most 0, staleness at most 2, all five kernels launched; the
    sized counts, every resize decision, samples/s and the peak;
10b. one PPO micro-batch at that width: the actor's loss, stats and
    gradients through the loss kernels (per-token advantages) against the
    plain loss, the critic's gradients finite with its lm_head's exactly
    zero, and its values through ``compute_values`` (flash) against the
    plain forward, in bf16 and fp32 compute;
10c. ``Trainer.fit`` with PPO at that width cut to 1 layer (async,
    continuous rollout, no KL, 3 steps of 16 samples): actor and critic metrics finite,
    staleness in bound, the launch counts of the attention and loss
    kernels, wall, samples/s, peak memory, stage busy shares and the
    ``values`` and ``critic_update`` stages' seconds;
10d. durable snapshots at full width cut to 1 layer (GRPO, KL on,
    baseline mode): an uninterrupted 4-step run, run twice, a 2-step run
    writing snapshots, and a fresh trainer resuming from them to step 4;
    the second uninterrupted run's metrics and the stitched run's equal
    the first run's bit for bit (each comparison printed with its largest
    relative difference), each snapshot's, restore's and final dump's
    seconds and bytes;
11. ``mamba_scan`` against its plain version in fp32 at the trainer's
    reference-inference rows (4 x 80, D=8192, N=16), one teacher-forced
    forward (1 x 80), the long prefill (B=1, S=2048) and two ragged
    shapes: each row gives the path its entry took (short or long, held
    to the wrapper's mirror), its time through the wrapper and through
    its C entry alone, its kernel's device time (``torch.profiler``) and
    its calls' device time queued behind a spin kernel (``queued_ms``,
    the profiler's fallback), the plain version's and the card's bound
    (no single PyTorch call computes a selective scan);
12. full-width Falcon-Mamba-7B (all 64 layers, vocab 65,024, random
    weights from a seed) served through the fixed engine: 4 requests,
    16 new tokens each;
13. teacher-forced consistency for the ssm family: a full forward
    (``mamba_scan``) over the finished sequences reproduces the logprobs
    the decode recurrence recorded, in bf16 and in an fp32 run;
14. a ``torch.profiler`` trace of a short ssm serving run; then the
    weights are freed;
15. one GRPO micro-batch of Falcon-Mamba-7B cut to 4 layers, through the
    loss kernels and through the plain loss, bf16 and fp32: loss, stats
    and gradients agree, and every mamba parameter gets a gradient;
16. ``Trainer.fit`` on that model, async, KL on, fixed rollout backend (the
    only one the ssm family has): the launch counts of ``mamba_scan``,
    ``grpo_logprob`` and both ``fused_rl_loss`` kernels over the run; then
    one of its actor updates timed (wall, peak memory) and traced (idle
    share), as for every trainer;
17. ``rglru_scan`` against its plain version in fp32 at the trainer's
    reference-inference rows (4 x 80 x 4096), one teacher-forced forward
    (1 x 80), a long prefill (B=1, S=2048) and two ragged shapes, each row
    as in phase 11 with the byte bound (no single PyTorch call computes
    the recurrence); ``flash_attention`` (B=1, S=4096, window 2048, and the
    trainer's 4 x 80 tokens at windows 2048 and 32) and
    ``decode_attention`` (rings of 2048, 80 and 32 keys, full and partly
    filled) at RecurrentGemma-9B's 16 query heads, 1 KV head and hd 256,
    bf16 and fp32, beside SDPA (and decode's C entry alone); then both at
    StableLM-2-12B's 32/8 heads and hd 160 at the trainer's sizes;
18. full-width RecurrentGemma-9B (all 38 layers, vocab 256,000, random
    weights from a seed) served through the fixed engine, as in phase 12;
19. the teacher-forced rules for it (full forwards through ``rglru_scan``
    and ``flash_attention``, decode through ``decode_attention``; the
    fp32 run's decode loop keeps an fp32 KV cache);
20. a trace of a short hybrid serving run; then the weights are freed;
21. the same rules at full width cut to 4 layers with a 32-key window,
    over 80-token sequences: the decode ring wraps and the forwards cross
    the flash window's band;
22. one GRPO micro-batch of RecurrentGemma-9B cut to 4 layers, as phase
    15; every RG-LRU parameter and attention weight gets a gradient;
23. ``Trainer.fit`` on that model, as phase 16, counting ``rglru_scan``,
    both attention kernels, ``grpo_logprob`` and both ``fused_rl_loss``
    kernels; then a trace of one of its actor updates;
24. full-width StableLM-2-12B (all 40 layers, d 5120, 32/8 heads, hd 160,
    vocab 100,352, random weights from a seed) served through the
    continuous engine as in phase 3: both attention kernels at hd 160;
25. the teacher-forced rules for it, as in phase 5;
26. a trace of a short StableLM serving run; then the weights are freed;
27. full-width Grok-1 (moe: 8 GELU experts of 32,768, top 2, 48/8 heads
    at hd 128, vocab 131,072) cut to 4 layers, random weights from a
    seed, served through the continuous engine as in phase 3; the share
    of expert picks past capacity at decode and at prefill; the top-2
    decode's distance from a forward over its tokens (printed: capacity
    drops other picks in a 4-token decode call than in a forward); the
    teacher-forced rules on the same weights with every token routed to
    all 8 experts, where nothing drops;
28. one GRPO micro-batch of Grok-1 cut to 1 layer (16 rows of 80
    tokens), its reference logprobs through the flash kernel and
    ``grpo_logprob`` at V = 131,072, through the loss kernels and through
    the plain loss, bf16 and fp32: loss, stats and gradients agree, the
    router, experts, head and embedding get gradients, and two bf16
    gradient calls give the same bits;
29. full-width InternVL2-26B (vlm: 48/8 heads at hd 128, vocab 92,553)
    cut to 32 layers: 4 requests of 1024 seeded patch embeddings and a
    prompt, one prefill through the flash kernel, 16 decode steps through
    the decode kernel at the offset positions; the teacher-forced rules
    over vision, prompt and decoded tokens;
30. one GRPO micro-batch of InternVL2-26B cut to 2 layers with its vision
    prefix (8 rows of 1024 + 80 positions), as phase 28 at the odd
    vocabulary 92,553;
31. full-width MiniCPM3-4B (dense with Multi-head Latent Attention: 40
    heads, kv_lora 256, q_lora 768, tied vocab 73,448), all 62 layers,
    served through the fixed engine as in phase 12, then its
    teacher-forced rules (the absorbed decode against the naive forward)
    and a trace; MLA has no kernel in the reference, so both attention
    kernels must launch 0 times;
32. one GRPO micro-batch of MiniCPM3-4B cut to 4 layers, as phase 15
    (every MLA weight gets a gradient), then ``Trainer.fit`` on it as in
    phase 16 (fixed rollout backend: the continuous engine refuses MLA,
    as the reference's does), counting ``grpo_logprob`` and both
    ``fused_rl_loss`` kernels, each of which must run, and the attention
    kernels, which must not; then one actor update timed and traced;
33. full-width DeepSeek-V2 (moe with MLA: 128 heads, kv_lora 512, q_lora
    1536, 160 SwiGLU experts of 1536, top 6, 2 shared, vocab 102,400) cut
    to 4 of its 60 layers (the dense layer and three moe layers), served
    through the fixed engine as in phase 31; the routing of a short run
    and the top-6 decode's distance from a forward over its tokens,
    printed only (a decode call of 4 tokens keeps C = 1 pick an expert);
    the teacher-forced rules on the same weights with every token routed
    to all 160 experts, where nothing drops; 0 attention-kernel launches;
34. one GRPO micro-batch of DeepSeek-V2 cut to 2 layers (one dense, one
    moe), 16 rows of 80, as phase 28: ``grpo_logprob`` at V = 102,400 in
    its reference stage, bf16 gradients twice bit for bit;
35. full-width Whisper-tiny (audio encoder-decoder: 4 + 4 layers, 6/6
    heads at hd 64, a GQA group of 1, vocab 51,865), random weights from a
    seed, bf16: first ``flash_attention`` (64 decoder tokens) and
    ``decode_attention`` (a ragged 128-key self cache, the 1500-key cross
    cache) against their plain versions at its group-1 shapes, bf16 and
    fp32; then 4 requests of seeded (1500, 384) frames served through the
    model facade: encode, the cross cache, 64 tokens decoded
    teacher-forced from position 0 and 64 greedy ones (tokens/s, step
    p50, peak memory; ``decode_attention`` 2 a layer a step), and the
    teacher-forced rules against a forward over the same tokens on the
    kernel route;
36. one GRPO micro-batch of Whisper-tiny at full width (16 rows of 80
    tokens, 1500 frames each), as phase 28 at V = 51,865 (its reference
    logprobs through flash and ``grpo_logprob``, bf16 gradients twice bit
    for bit), then one ``grpo_train_step`` applying AdamW;
37. on the card's 1 x 1 mesh (a one-rank NCCL group over a
    ``HashStore``): ``sharded_decode_attention`` at the Qwen decode shape
    of phase 2's timed row against ``decode_attention``'s plain version,
    bf16 and fp32, timed beside the kernel; then full-width Qwen2.5-7B
    (28 layers) through the continuous engine with ``mesh=``: 4 of the
    phase-3 prompts, 32 new tokens, every request answered once, no page
    leaked, 0 ``decode_attention`` launches, the teacher-forced rules,
    tokens/s and step p50 beside phase 3's;
38. ``ep_moe_ffn`` on that mesh at one DeepSeek-V2 moe layer at full
    width (d 5120, 160 SwiGLU experts of 1536, top 6, 2 shared), 4 x 80
    fp32 tokens at capacity factor 8.0, against ``moe_ffn`` at a
    capacity that drops nothing (output scale over 0.5, as the
    reference's check asks);
39. on that mesh, the launch steps of ``launch/steps.py`` on full-width
    Qwen2.5-7B: prefill (28 layers, 1 x 2048), one serve step (28
    layers, 4 rows over 2080 keys) and the GRPO train step (2 layers, 16
    x 80, AdamW); each equal bit for bit to the model-facade call it
    wraps, and again on DTensors placed by the sharding rules on the 1 x 1
    mesh (the DTensor route to the same kernels); 28 flash, 28 decode,
    one of each loss kernel a run; the dry run's account of the same
    dims from meta structs (argument bytes equal to the card tensors',
    peak beside ``max_memory_allocated``), and the dry-run launcher at
    full size in a subprocess (256 fake ranks, no card); then the group
    is torn down;
40. a JSON line per kernel and, last, the device line.

Phases 3, 4, 6b, 9, 10a (its profile and its trainer each), 10c, 10d, 12,
16, 18, 23, 24, 27, 29, 31, 32's trainer, 33, 35 and 37 set the launch
counts of the kernels they check to 0 just before they start and read
them just after (phases 12, 18, 31, 33 and 35 read after their
teacher-forced forwards); phases 28, 30, 32's, 34's and 36's
micro-batches count their reference stage's and kernel route's launches.
The kernel line's launches are the main paths' sums: the attention
kernels over phases 3, 6b, 10a, 10c, 27, 29 and 35 (flash also over 28,
30, 36 and 37), the loss kernels over 9, 10a, 10c, 28, 30, 32
(micro-batch and trainer), 34 and 36 (``grpo_logprob`` also over 10d),
the scans over 16 and 23; phase 39's steps (plain and on DTensors, not
the facade's runs they are compared with) add to flash, decode and the
two ``fused_rl_loss`` kernels.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# fused_rl_loss backward: relative to each element of dx, plus 1e-5 of its
# terms where they cancel (fused_rl_loss_bwd_tolerance)
DX_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}
# Teacher-forced logprob agreement. fp32: the decode and prefill paths
# differ only in summation order, so they agree within 1e-3 nats. bf16: the
# paths round at different places (8-bit mantissa, residual stream in bf16
# over 28 layers), so the decode path is held to the accuracy of the bf16
# prefill path itself: its distance from an fp32 forward over the same
# tokens may be at most BF16_TF_FACTOR times the bf16 forward's distance.
FP32_TF_TOL = 1e-3
BF16_TF_FACTOR = 2.0
L2_BYTES = 50 * 2 ** 20
SEQ_LEN_MAX = 2048         # longest byte prompt
TRAIN_LAYERS = 2           # depth of the training phases (width is full)
SSM_TRAIN_LAYERS = 4       # the same for Falcon-Mamba-7B (28 GB at 64)
TRAIN_ROWS = 4 * 79        # a trainer micro-batch: 4 rows of seq_len 80
FIXED_PROMPT_MAX = 64      # fixed-engine serving (Falcon-Mamba,
FIXED_NEW = 16             # RecurrentGemma): prompt tokens at most, and
                           # new tokens per request
SSM_VOCAB = 65_024         # Falcon-Mamba-7B's vocab
HYB_VOCAB = 256_000        # RecurrentGemma-9B's vocab
SSM_REF_ROWS = (4, 80, 8192, 16)   # mamba_scan in the trainer's reference
                                   # inference: 4 rows x 80 x d_inner, N
HYB_TRAIN_LAYERS = 4       # RecurrentGemma-9B's training depth: one
                           # (rec, rec, attention) tile and one rec layer
STABLELM_LAYERS = 40       # StableLM-2-12B's depth: all of it (48.5 GB
                           # of fp32 params once the others are freed)
HYB_REF_ROWS = (4, 80, 4096)   # rglru_scan in the trainer's reference
                               # inference: 4 rows x 80 x rnn_width
# the scans in one teacher-forced forward of phases 13, 19 and 21: one
# sequence of at most FIXED_PROMPT_MAX + FIXED_NEW tokens
SSM_TF_ROWS = (1, 80, 8192, 16)
HYB_TF_ROWS = (1, 80, 4096)
PATH_NAMES = {1: "short", 2: "long"}   # the scans' entries' paths
RING_WINDOW = 32           # local window of the ring-wrap check
QWEN_HEADS = (28, 4, 128)       # query heads, KV heads, head dim
STABLELM_HEADS = (32, 8, 160)
WIDE_HEADS = (48, 8, 128)       # Grok-1 and InternVL2-26B: a group of 6
GROK_LAYERS = 4            # Grok-1 served at full width: 59.4 GB of fp32
                           # params at 4 layers (3.31 B a layer and 1.61 B
                           # of embedding and head)
GROK_TRAIN_LAYERS = 1      # its GRPO micro-batch (19.7 GB of params)
GROK_TRAIN_ROWS = 16       # rows of seq_len 80 in that micro-batch
GROK_VOCAB = 131_072
VLM_LAYERS = 32            # InternVL2-26B served at full width: 54.5 GB
                           # of fp32 params at 32 of its 48 layers
VLM_TRAIN_LAYERS = 2       # its GRPO micro-batch
VLM_TRAIN_ROWS = 8         # rows of 1024 vision and 80 text positions
VLM_VOCAB = 92_553         # odd: bf16 rows start off the 16-byte grid
VLM_REQUESTS = 4           # vision-prefixed requests, and their new tokens
VLM_NEW = 16
MLA_TRAIN_LAYERS = 4       # MiniCPM3-4B's training depth (0.44 B params;
                           # served at all 62 layers, 4.07 B, 16.3 GB)
MINICPM3_VOCAB = 73_448
DEEPSEEK_LAYERS = 4        # DeepSeek-V2 served at full width: the dense
                           # layer and three moe layers, 13.30 B params
                           # (53.2 GB fp32) and up to 7.6 GB of one moe
                           # layer's bf16 expert casts
DEEPSEEK_TRAIN_LAYERS = 2  # its GRPO micro-batch: one dense, one moe layer
DEEPSEEK_TRAIN_ROWS = 16   # rows of seq_len 80 in that micro-batch
DEEPSEEK_VOCAB = 102_400
WHISPER_REQUESTS = 4       # Whisper-tiny served at full width: requests
WHISPER_TF = 64            # of seeded frames, tokens decoded teacher-forced
WHISPER_NEW = 64           # from position 0, then greedy new tokens
WHISPER_HEADS = (6, 6, 64)  # query heads, KV heads, hd: a GQA group of 1
WHISPER_TRAIN_ROWS = 16    # its GRPO micro-batch: rows of 80 tokens
WHISPER_VOCAB = 51_865     # odd: bf16 rows start off the 16-byte grid
MESH_REQUESTS = 4          # phase-3 prompts served with ``mesh=``
EP_TOKENS = (4, 80)        # tokens through one DeepSeek-V2 moe layer with
EP_CAPACITY = 8.0          # ``ep_moe_ffn`` (its capacity factor)
STEP_PREFILL = (1, 2048)   # the launch steps (phase 39) on Qwen2.5-7B:
STEP_SERVE = (4, 2080)     # prefill rows x tokens and serve rows x cache
STEP_TRAIN = (16, 80)      # keys at all 28 layers; train rows x tokens at
                           # TRAIN_LAYERS, one AdamW step
DRYRUN_TIMEOUT = 300       # seconds of the dry-run launcher's subprocess
ATTENTION_KERNELS = ("flash_attention", "decode_attention")
LOSS_KERNELS = ("grpo_logprob", "fused_rl_loss_fwd", "fused_rl_loss_bwd")
SFU_PER_SM_CLOCK = 16      # H100 special-function-unit ops per SM and clock
SMS = 132
MAX_NEW = 32
NUM_SLOTS = 4
ROLLOUT_DECODE = (256, 2304, 8, 8)  # a decode round of the benchmark's
                           # rollout cell: slots, keys, page size, and
                           # idle slots in the ragged row
TEMPERATURE = 0.8
SEED = 0                   # weights, prompts and sampling keys
FLEET_REPLICAS = 2         # the serving fleet: replicas, the injector's
FLEET_CRASH_P = 0.25       # crash probability a request, and its seed
FLEET_FAULT_SEED = 1
FLEET_NEW = 16             # new tokens a fleet request: a replica serves
                           # one request at a time, so its decode runs at
                           # B=1 and the fleet's wall is the host's
PPO_TRAIN_LAYERS = 1       # the PPO trainer's depth (width is full). At
                           # 2 layers its peak read 72.1-77.8 GB of the
                           # card's 85.0: actor and critic each hold 5 x
                           # 6.2 GB (params, moments, summed and new
                           # gradients), and in async mode their AdamW
                           # steps' temporaries and the rollout's weight
                           # swap coincide, about 81 GB at worst
DURABLE_LAYERS = 1         # the durability phase's depth, steps and new
DURABLE_STEPS = 4          # tokens a sample (full width: one actor state
DURABLE_NEW = 32           # of params and two moments is 15.8 GB)
PLANNER_ELASTIC_S = 0.5    # the planner phase's rebalance interval
PLANNER_MARGIN = 0.10      # of the card's memory the planner phase keeps
                           # for activations, KV caches and the allocator
ACTOR_COPIES = 6           # model-sized fp32 tensors the actor holds at
                           # its peak: params, two moments, summed and new
                           # gradients, AdamW's temporaries (about 37 GB
                           # at full width and 2 layers)
PLANNER_CLUSTER = 128      # cards of the cluster the planner plans for


def _import_port():
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch is missing; run "
                         "this script from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    return torch


def _time_ms(torch, fn, arg_sets, iters):
    """Mean ms per call by CUDA events, cycling through ``arg_sets`` (sized
    to exceed L2, so each call finds its inputs cold as on the main path),
    after as many untimed calls to bring the clocks up."""
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _release(torch):
    """Free what the last phase left: a trainer's threads and engines hold
    reference cycles, so its weights outlive ``del`` until a collection."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _copies(torch, tensors):
    """Enough copies of ``tensors`` to exceed twice the L2 cache."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, math.ceil(2 * L2_BYTES / nbytes))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(min(n, 16) - 1)]


def _bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name, dtype, shape, out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype]
    ok = bool(((out.float() - ref.float()).abs()
               <= tol + tol * ref.float().abs()).all().item())
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{name} {dtype} {shape}: kernel disagrees with "
                             f"its plain version (max abs err {err})")
    return err


def _device_ms(torch, fn, arg_sets, calls, name):
    """Device time per launch of the kernel whose name holds ``name`` (one
    a call): the median duration of its kernel events in ``torch.profiler``
    traces of ``calls`` calls cycling through ``arg_sets`` (the calls' host
    time is not in it). A trace may miss some of a window's launches, or
    all of them, or misreport a few, so windows are taken until they hold
    ``calls`` events (at most four) and the median is read. Where the four
    windows hold none of its events (the profiler loses a whole trace's
    kernel records now and then), the time is ``_queued_ms``'s, and a
    ``device_ms_queued`` line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        times += [e.self_device_time_total for e in prof.events()
                  if e.device_type == DeviceType.CUDA and name in e.name]
        if len(times) >= calls:
            return sorted(times)[len(times) // 2] / 1e3
    if times:
        return sorted(times)[len(times) // 2] / 1e3
    ms = _queued_ms(torch, fn, arg_sets, calls)
    print("device_ms_queued", json.dumps({"kernel": name, "ms": ms}))
    return ms


def _queued_ms(torch, fn, arg_sets, calls):
    """Device time per call of ``fn`` with the host's issue time hidden and
    no profiler: a spin kernel (``torch.cuda._sleep``) holds the stream
    while the host queues ``calls`` calls, so the events around them time
    the calls' kernels run back to back (all of the wrapper's kernels, not
    only the named one). The spin is doubled until the host has queued
    every call before the device reaches the first."""
    cycles = 1 << 22                      # about 2 ms at the H100's clock
    for _ in range(6):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        queued_first = not start.query()
        torch.cuda.synchronize()
        if queued_first:
            return start.elapsed_time(end) / calls
        cycles *= 2
    raise AssertionError("the host did not queue the calls within the spin: "
                         "the function waits for the device")


def _decode_row(torch, gen, dtype, B, S, H, KVH, hd, fill):
    """``decode_attention`` against its plain version on random q, K, V
    with ``fill`` (B,) valid keys a row, timed through the wrapper, its C
    entry alone, its kernel's device time (profiler), the plain version
    and SDPA; the bound counts the bytes of the valid keys' K and V rows,
    q, out and the mask, the only bytes the function needs. Returns the
    row."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.decode_attention.ops import _num_sms, _splits
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
               for shape in ((B, 1, H, hd), (B, S, KVH, hd),
                             (B, S, KVH, hd)))
    valid = torch.arange(S, device=dev)[None, :] < fill[:, None]
    err = _check("decode_attention", dtype, (B, S, H, KVH, hd),
                 decode_attention(q, k, v, valid),
                 decode_attention_ref(q, k, v, valid))
    sets = _copies(torch, (q, k, v, valid))
    keys = int(valid.sum().item())
    e = q.element_size()
    nbytes = 2 * q.numel() * e + 2 * keys * KVH * hd * e + valid.numel()
    bound, by = _bound(nbytes, 4 * keys * H * hd, dtype)
    nsplit, chunk = _splits(_num_sms(dev.index), B, S, H, KVH)
    out = torch.empty_like(q)
    entry = _build.kernel("decode_attention")
    stream = torch.cuda.current_stream().cuda_stream
    return dict(
        kernel="decode_attention", dtype=dtype, B=B, S=S, H=H, KVH=KVH,
        hd=hd, filled=fill.tolist(), max_abs_err=err,
        ms=_time_ms(torch, decode_attention, sets, 50),
        entry_ms=_time_ms(torch, lambda q, k, v, m: entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
            out.data_ptr(), B, S, H, KVH, hd, nsplit, chunk,
            _build.DTYPE_CODES[dt], stream), sets, 50),
        device_ms=_device_ms(torch, decode_attention, sets, 50,
                             "decode_kernel"),
        plain_ms=_time_ms(torch, decode_attention_ref, sets, 10),
        library_ms=_time_ms(
            torch, lambda q, k, v, m: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=m[:, None, None, :], enable_gqa=True), sets, 50),
        bound_ms=bound, bound_by=by)


def _paged_row(torch, gen, dtype, B, S, H, KVH, hd, ps, fill, n_idle):
    """``paged_decode_attention`` on one layer's page pools read through a
    shuffled page table, as a decode round of the continuous engine reads
    them: row b owns ceil(fill[b] / ps) pages drawn in random order from
    1.., the rest of its table page 0; the first ``n_idle`` rows are idle
    slots (one key, the whole table on page 0). Checked against the plain
    version on the gathered (B, S) views, and it must equal
    ``decode_attention`` there bit for bit. Timed through the wrapper
    beside its kernel's device time (profiler), the gather of the views
    (what a round did per layer before the paged mode), the dense mode on
    them, the plain version and SDPA (each of these two after the gather);
    the bound counts the valid keys' K and V rows, q, out, the mask and
    the table. Returns the row."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_ref, paged_decode_attention)
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    fill = fill.clone()
    fill[:n_idle] = 1
    need = -(-fill // ps)
    need[:n_idle] = 0
    pages = 1 + int(need.sum().item())
    ids = torch.randperm(pages - 1, generator=gen, device=dev) + 1
    table = torch.zeros((B, S // ps), dtype=torch.int64, device=dev)
    at = 0
    for b, n in enumerate(need.tolist()):
        table[b, :n] = ids[at:at + n]
        at += n
    q, k_pool, v_pool = (torch.randn(shape, generator=gen, device=dev).to(dt)
                         for shape in ((B, 1, H, hd), (pages, ps, KVH, hd),
                                       (pages, ps, KVH, hd)))
    valid = torch.arange(S, device=dev)[None, :] < fill[:, None]

    def gather(q, k_pool, v_pool, table, valid):
        return (q, k_pool[table].reshape(B, S, KVH, hd),
                v_pool[table].reshape(B, S, KVH, hd), valid)

    def sdpa(q, k, v, m):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m[:, None, None, :], enable_gqa=True)

    dense = gather(q, k_pool, v_pool, table, valid)
    out = paged_decode_attention(q, k_pool, v_pool, table, valid)
    shape = (B, S, H, KVH, hd, ps)
    err = _check("paged_decode_attention", dtype, shape, out,
                 decode_attention_ref(*dense))
    if not torch.equal(out, decode_attention(*dense)):
        raise AssertionError(f"paged_decode_attention {dtype} {shape}: not "
                             "bit for bit decode_attention on the gathered "
                             "views")
    sets = _copies(torch, (q, k_pool, v_pool, table, valid))
    dense_sets = _copies(torch, dense)
    keys = int(valid.sum().item())
    e = q.element_size()
    nbytes = (2 * q.numel() * e + 2 * keys * KVH * hd * e + valid.numel()
              + table.numel() * table.element_size())
    bound, by = _bound(nbytes, 4 * keys * H * hd, dtype)
    return dict(
        kernel="decode_attention", mode="paged", dtype=dtype, B=B, S=S, H=H,
        KVH=KVH, hd=hd, page_size=ps, idle=n_idle, valid_keys=keys,
        filled=fill.tolist(),
        max_abs_err=err, ms=_time_ms(torch, paged_decode_attention, sets, 50),
        device_ms=_device_ms(torch, paged_decode_attention, sets, 50,
                             "decode_kernel"),
        gather_ms=_time_ms(torch, gather, sets, 20),
        dense_device_ms=_device_ms(torch, decode_attention, dense_sets, 50,
                                   "decode_kernel"),
        plain_ms=_time_ms(torch, lambda *a: decode_attention_ref(
            *gather(*a)), sets, 10),
        library_ms=_time_ms(torch, lambda *a: sdpa(*gather(*a)), sets, 20),
        bound_ms=bound, bound_by=by)


def _flash_row(torch, gen, dtype, B, S, H, KVH, hd, window):
    """``flash_attention`` against its plain version on random q, K, V,
    timed beside its C entry alone, the plain version, SDPA with the band
    as its mask and, without a window, SDPA with ``is_causal`` (the
    stronger yardstick; both timed only, the port never calls SDPA), and
    the bound (operations over the (query, visible key) pairs); returns
    the row."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
               for shape in ((B, S, H, hd), (B, S, KVH, hd),
                             (B, S, KVH, hd)))
    err = _check("flash_attention", dtype, (B, S, H, KVH, hd, window),
                 flash_attention(q, k, v, window=window),
                 flash_attention_ref(q, k, v, window=window))
    sets = _copies(torch, (q, k, v))
    qpos = torch.arange(S, device=dev)[:, None]
    kpos = torch.arange(S, device=dev)[None, :]
    band = kpos <= qpos
    if window > 0:
        band &= kpos > qpos - window
    pairs = int(band.sum().item())
    nbytes = 2 * q.numel() * q.element_size() \
        + 2 * k.numel() * k.element_size()
    bound, by = _bound(nbytes, 4 * B * H * hd * pairs, dtype)

    def sdpa(**kw):
        return lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True, **kw)
    entry = _build.kernel("flash_attention")
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(q)
    return dict(
        kernel="flash_attention", dtype=dtype, B=B, S=S, H=H, KVH=KVH,
        hd=hd, window=window, max_abs_err=err,
        ms=_time_ms(torch, lambda q, k, v: flash_attention(
            q, k, v, window=window), sets, 10),
        entry_ms=_time_ms(torch, lambda q, k, v: entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            S, H, KVH, hd, window, _build.DTYPE_CODES[dt], stream), sets, 10),
        plain_ms=_time_ms(torch, lambda q, k, v: flash_attention_ref(
            q, k, v, window=window), sets, 3),
        library_ms=_time_ms(torch, sdpa(attn_mask=band), sets, 10),
        library_causal_ms=None if window > 0 else _time_ms(
            torch, sdpa(is_causal=True), sets, 10),
        bound_ms=bound, bound_by=by)


def _ptxas_report(source, instance):
    """Registers, spills and serialization notes per instantiation of the
    kernels of ``source``, from the ptxas log of this run's build;
    ``instance(mangled)`` names an instantiation or is None for a kernel
    the report skips."""
    import re

    from repro_torch.kernels import _build
    log = (_build.BUILD_DIR / f"{source}.log").read_text().splitlines()
    report = {}
    for i, line in enumerate(log):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if not m or not instance(m.group(1)):
            continue
        mangled = m.group(1)
        nums = {}
        for follow in log[i + 1:i + 4]:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                hit = re.search(pat, follow)
                if hit:
                    nums[key] = int(hit.group(1))
        nums["serialized"] = any("serialized" in x and mangled in x
                                 for x in log)
        report[instance(mangled)] = nums
    return report


def _build_report(source, instance, tensor_op):
    """``_ptxas_report`` and each instantiation's tensor-core
    (``tensor_op``) and FP32-core (FFMA) instructions from the SASS."""
    import re
    import shutil

    from repro_torch.kernels import _build
    report = _ptxas_report(source, instance)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build._lib_path(source))],
                          capture_output=True, text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        name = instance(part.split()[0])
        if name:
            report.setdefault(name, {}).update({
                tensor_op.lower(): len(re.findall(rf"\b{tensor_op}\b",
                                                  part)),
                "ffma": len(re.findall(r"\bFFMA\b", part))})
    missing = [n for n, r in report.items()
               if n.startswith("bf16") and not r.get(tensor_op.lower())]
    if missing or not any(n.startswith("bf16") for n in report):
        raise AssertionError(f"bf16 {source} without {tensor_op}: {report}")
    return report


def _hd(mangled):
    import re
    return re.search(r"Li(\d+)E", mangled).group(1)


def flash_build_report():
    """The flash kernels per instantiation (``bf16_wgmma_hd192`` runs hd
    160); raises unless every bf16 instantiation runs on HGMMA."""
    return _build_report(
        "flash_attention",
        lambda m: ("bf16_wgmma" if "flash_wgmma" in m else "fp32") + "_hd"
        + _hd(m), "HGMMA")


def decode_build_report():
    """The decode kernels per instantiation (``_paged``: the mode that
    reads a page pool through a page table); raises unless every bf16
    instantiation runs on the tensor cores (HMMA, from mma.sync)."""
    return _build_report(
        "decode_attention",
        lambda m: ("bf16" if "bfloat16" in m else "fp32") + "_hd" + _hd(m)
        + ("_paged" if "Lb1E" in m else "")
        if "decode_kernel" in m else None, "HMMA")


def loss_build_report():
    """The vocab-pass kernels (``grpo_logprob``, ``fused_rl_loss_fwd``) per
    instantiation: registers and spills from the ptxas log, and the
    clusters of 1, 2, 4 and 8 blocks the card holds at once
    (``cudaOccupancyMaxActiveClusters``); raises if a split size does not
    fit or the pass spills."""
    from repro_torch.kernels import _build
    report = {}
    for source, name, entry in (
            ("grpo_logprob", "grpo_logprob_kernel", "grpo_logprob_clusters"),
            ("fused_rl_loss", "fwd_kernel", "fused_rl_loss_fwd_clusters")):
        rows = _ptxas_report(source, lambda m, name=name: (
            name + ("_bf16" if "bfloat16" in m else "_fp32"))
            if name in m else None)
        for inst, row in rows.items():
            row["max_clusters"] = {
                n: _build.kernel(entry)(n, int(inst.endswith("bf16")))
                for n in (1, 2, 4, 8)}
        report.update(rows)
    bad = [n for n, r in report.items() if r.get("spill_stores")
           or min(r["max_clusters"].values()) <= 0]
    if bad or len(report) != 4:
        raise AssertionError(f"vocab pass build: {report}")
    return report


def phase_kernels(torch, max_len, page_size, vlm_len, timed):
    """Kernel vs plain version at Qwen2.5-7B's attention shapes (28 heads,
    4 KV heads, hd 128), the decode rows partly filled (the timed one),
    full, and ragged with an empty row; then at StableLM-2-12B's (32 heads,
    8 KV heads, hd 160); then at Grok-1's and InternVL2-26B's 48/8 heads
    (hd 128): Grok's decode over ``max_len`` keys and its 4 x 2048 prefill
    bucket, InternVL2's decode over ``vlm_len`` keys and its prefill of
    the vision prefix and prompt. Then the decode kernel's paged mode, the
    continuous engine's decode rounds, at Qwen's heads on pages of
    ``page_size``: the slots and keys of phase 3, partly filled (the
    dense rows' lengths), full, and ragged with an idle slot, in bf16 and
    fp32, and a round of the benchmark's rollout cell (``ROLLOUT_DECODE``)
    partly filled and ragged in bf16. Returns {name: row} for the timed
    shapes; the decode one is the paged row (the serving paths' mode) with
    the dense mode's time at the same shape and lengths as ``dense_ms``."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    rows, out, lengths = [], {}, {}
    for dtype in ("bfloat16", "float32"):
        for (H, KVH, hd), B, S, fill in (
                (QWEN_HEADS, 4, max_len, "part"),
                (QWEN_HEADS, 4, max_len, "full"),
                (QWEN_HEADS, 4, 4099, "ragged"),
                (STABLELM_HEADS, 4, max_len, "part"),
                (WIDE_HEADS, 4, max_len, "part"),
                (WIDE_HEADS, VLM_REQUESTS, vlm_len, "full")):
            lo = 0 if fill == "ragged" else 1   # ragged: a row with no key
            lens = torch.randint(lo, S + 1, (B,), generator=gen, device=dev)
            lens[0] = lo
            if fill == "full":
                lens[:] = S
            row = _decode_row(torch, gen, dtype, B, S, H, KVH, hd, lens)
            rows.append(row)
            lengths[dtype, B, S, H, fill] = lens, row["ms"]
        for (H, KVH, hd), B, S, window in (
                (QWEN_HEADS, 4, 8, 0), (QWEN_HEADS, 4, 8, 256),
                (QWEN_HEADS, 4, 1000, 0), (QWEN_HEADS, 4, 1000, 256),
                (QWEN_HEADS, 4, 2048, 0), (QWEN_HEADS, 4, 2048, 256),
                (QWEN_HEADS, 1, SEQ_LEN_MAX, 0), (STABLELM_HEADS, 4, 8, 0),
                (STABLELM_HEADS, 1, SEQ_LEN_MAX, 0),
                (WIDE_HEADS, 4, 2048, 0),
                (WIDE_HEADS, VLM_REQUESTS, vlm_len - VLM_NEW, 0)):
            row = _flash_row(torch, gen, dtype, B, S, H, KVH, hd, window)
            rows.append(row)
            if (dtype, B, S, H, window) == timed["flash_attention"]:
                out["flash_attention"] = row
    H, KVH, hd = QWEN_HEADS
    slots, keys, rollout_ps, idle = ROLLOUT_DECODE
    for dtype, B, S, ps, fill, n_idle in (
            *((dt, NUM_SLOTS, max_len, page_size, fill, n_idle)
              for dt in ("bfloat16", "float32")
              for fill, n_idle in (("part", 0), ("full", 0),
                                   ("ragged", 1))),
            ("bfloat16", slots, keys, rollout_ps, "part", 0),
            ("bfloat16", slots, keys, rollout_ps, "ragged", idle)):
        lens, dense_ms = lengths.get((dtype, B, S, H, fill), (None, None))
        if lens is None:
            lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        row = _paged_row(torch, gen, dtype, B, S, H, KVH, hd, ps, lens,
                         n_idle)
        rows.append(row)
        if (dtype, B, S, H, fill) == timed["decode_attention"]:
            out["decode_attention"] = dict(row, dense_ms=dense_ms)
    for row in rows:
        print("kernel_vs_plain", json.dumps(row))
    print("kernel_vs_plain_launches", json.dumps({
        "decode_attention": decode_attention.launches,
        "flash_attention": flash_attention.launches}))
    return out


def make_prompts(seed):
    """8 PromptDataset prompts, then 8 byte prompts of 256-2048 tokens;
    only the last reaches 2048, so it is prefilled alone (B=1, S=2048)."""
    import numpy as np

    from repro_torch.data import PromptDataset
    from repro_torch.data.tokenizer import BOS, N_SPECIALS
    prompts = [p["tokens"] for p in PromptDataset(seed=seed)
               .prompts_for_step(0, 8)]
    rng = np.random.default_rng(seed)
    lens = list(rng.integers(256, SEQ_LEN_MAX - 8, size=7)) + [SEQ_LEN_MAX]
    for n in lens:
        body = rng.integers(N_SPECIALS, 256 + N_SPECIALS, size=int(n) - 1)
        prompts.append(np.concatenate([[BOS], body]).astype(np.int32))
    return prompts


def _forward_logprobs(torch, params, cfg, seqs, vision=None, frames=None):
    """For each (tokens, recorded logprobs, prompt length) in ``seqs``: the
    logprobs of its response tokens under one full forward; with
    ``vision`` (one (T, d) prefix a sequence) behind its vision prefix,
    with ``frames`` (one (F, d) an audio sequence) over its frames."""
    from repro_torch.models import forward
    dev = params["embed"]["table"].device
    out = []
    for i, (tokens, _, plen) in enumerate(seqs):
        toks = torch.tensor(tokens, device=dev)[None]
        batch = {"tokens": toks}
        if vision is not None:
            batch["vision_embeds"] = vision[i][None]
        if frames is not None:
            batch["frames"] = frames[i][None]
        with torch.no_grad():
            logits, _ = forward(params, cfg, batch)
        logits = logits[:, -toks.shape[1]:]
        logp = torch.log_softmax(logits[0].float() / TEMPERATURE, dim=-1)
        t = torch.arange(plen, len(tokens), device=dev)
        out.append(logp[t - 1, toks[0, t]])
    return out


def _max_diff(a, b):
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def _recorded(torch, seqs):
    return [torch.tensor(lp[plen:], device="cuda") for _, lp, plen in seqs]


def _cb_seqs(seqs):
    """(tokens, logprobs, prompt length) of continuous-engine sequences."""
    return [(q.tokens, q.logprobs, q.prompt_len) for q in seqs]


def _rows_seqs(rows):
    """(tokens, logprobs, prompt length) of fixed-engine rows."""
    return [(r["tokens"], r["logprobs"], r["prompt_len"]) for r in rows]


def _teacher_forced(torch, params, cfg, seqs16, run32, vision=None,
                    extra=None, frames=None):
    """The teacher-forced rules: an fp32 decode within FP32_TF_TOL of an
    fp32 forward over its tokens; a bf16 decode no further from an fp32
    forward than BF16_TF_FACTOR times the bf16 forward is. ``run32(cfg32)``
    decodes in fp32 and returns its sequences; ``vision`` holds the
    sequences' vision prefixes and ``frames`` their audio frames, in their
    order (both runs' sequences come from the first prompts); ``extra``
    joins the printed line."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    fwd16 = _forward_logprobs(torch, params, cfg, seqs16, vision, frames)
    fwd32 = _forward_logprobs(torch, params, cfg32, seqs16, vision, frames)
    rec16 = _recorded(torch, seqs16)
    tf = {"bf16_decode_vs_bf16_forward": _max_diff(rec16, fwd16),
          "bf16_decode_vs_fp32_forward": _max_diff(rec16, fwd32),
          "bf16_forward_vs_fp32_forward": _max_diff(fwd16, fwd32)}
    seqs32 = run32(cfg32)
    tf["fp32_decode_vs_fp32_forward"] = _max_diff(
        _recorded(torch, seqs32),
        _forward_logprobs(torch, params, cfg32, seqs32, vision, frames))
    bf16_tol = BF16_TF_FACTOR * tf["bf16_forward_vs_fp32_forward"]
    print(json.dumps({"phase": "teacher_forced", "model": cfg.name,
                      **(extra or {}),
                      "max_abs_logprob_diff": tf,
                      "tolerance": {"fp32_decode_vs_fp32_forward":
                                    FP32_TF_TOL,
                                    "bf16_decode_vs_fp32_forward":
                                    bf16_tol}}))
    if not tf["fp32_decode_vs_fp32_forward"] <= FP32_TF_TOL:
        raise AssertionError(f"teacher-forced fp32 logprobs differ: {tf}")
    if not tf["bf16_decode_vs_fp32_forward"] <= bf16_tol:
        raise AssertionError(f"bf16 decode logprobs are further from fp32 "
                             f"than the bf16 prefill path allows: {tf}")


def _traced(torch, fn, phase):
    """Run ``fn()`` under ``torch.profiler`` and print device time by kernel
    name, the device's busy share of the wall time and the ops' self CPU
    time. Returns what ``fn`` returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    # device-side kernel events only: an aten op's device time repeats its
    # kernels' time. The averages are taken once: over a deep model's run
    # they take many seconds
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in events)
    print(json.dumps({"phase": phase, "wall_us": wall_us,
                      "kernel_names": len(events),
                      "device_busy_us": busy_us,
                      "device_idle_share": 1 - busy_us / wall_us}))
    # the 15 longest, and every kernel of the port's own
    for e in [e for i, e in enumerate(events)
              if i < 15 or "repro_torch" in e.key]:
        print("profile_kernel", json.dumps({
            "name": e.key[:90], "calls": e.count,
            "device_us": e.self_device_time_total,
            "share": e.self_device_time_total / busy_us}))
    # self CPU time of the ops and runtime calls the profiler sees (it
    # adds its own cost to each); the rest of the wall is Python
    ops = [e for e in averages
           if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    ops.sort(key=lambda e: -e.self_cpu_time_total)
    print(json.dumps({"phase": f"{phase}_host", "wall_us": wall_us,
                      "ops_self_cpu_us": sum(e.self_cpu_time_total
                                             for e in ops)}))
    for e in ops[:10]:
        print("profile_host_op", json.dumps({
            "name": e.key[:60], "calls": e.count,
            "self_cpu_us": e.self_cpu_time_total}))
    return out


def serve_continuous(torch, cfg, eng, params, prompts, reg, smi, idle=(),
                     phase="continuous_engine", report=None):
    """Serve ``prompts`` through the continuous-batching engine ``eng``,
    counting both attention kernels' launches from 0: every request
    finishes once, ids within the vocab, logprobs finite and <= 0, no page
    leaked, both kernels launched but those of ``idle``, which must not
    be. Prints the ``phase`` line (``report``, a dict, receives its
    fields); returns (the finished sequences, the launches)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    seqs = [eng.make_sequence(p) for p in prompts]
    decode_attention.launches = flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    done, paused = eng.generate(params, seqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    n_new = sum(q.gen_len for q in done)
    if len(done) != len(seqs) or paused or \
            sorted(q.uid for q in done) != sorted(q.uid for q in seqs):
        raise AssertionError(f"{len(done)}/{len(seqs)} requests finished")
    for q in done:
        if max(q.tokens) >= cfg.vocab_size or min(q.tokens) < 0:
            raise AssertionError(f"uid {q.uid}: token id out of range")
        lps = q.logprobs[q.prompt_len:]
        if not all(math.isfinite(x) and x <= 0.0 for x in lps):
            raise AssertionError(f"uid {q.uid}: bad logprobs {lps[:4]}")
    if eng.pool.pages_in_use:
        raise AssertionError(f"{eng.pool.pages_in_use} KV pages leaked")
    _expect_launches(phase, launches,
                     [n for n in launches if n not in idle], idle)
    snap = reg.snapshot()
    pre = snap["rollout_prefill_seconds"]["values"][0]
    dec = snap["rollout_decode_step_seconds"]["values"][0]
    line = {
        "phase": phase, "model": cfg.name,
        "layers": cfg.num_layers, "requests": len(done),
        "new_tokens": n_new, "wall_s": wall, "tokens_per_s": n_new / wall,
        "card": smi, "launches": launches,
        "prefill_dispatches": pre["count"], "prefill_s_sum": pre["sum"],
        "decode_steps": dec["count"], "decode_step_s_p50": dec["p50"],
        "decode_s_sum": dec["sum"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(line))
    if report is not None:
        report.update(line)
    return done, launches


def continuous_teacher_forced(torch, params, cfg, done, prompts, max_len):
    """The teacher-forced rules over a short and the longest served
    sequence; the fp32 run decodes two prompts through an fp32 engine."""
    from repro_torch.core.obs import MetricsRegistry
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    by_uid = sorted(done, key=lambda q: q.uid)

    def run32(cfg32):
        eng32 = ContinuousBatchingEngine(
            cfg32, num_slots=2, max_len=max_len,
            max_new_tokens=8, temperature=TEMPERATURE, seed=SEED,
            dtype=torch.float32, metrics=MetricsRegistry())
        done32, _ = eng32.generate(params, [eng32.make_sequence(prompts[0]),
                                            eng32.make_sequence(prompts[9])])
        return _cb_seqs(done32)
    _teacher_forced(torch, params, cfg, _cb_seqs([by_uid[0], by_uid[-1]]),
                    run32)


def profile_serving(torch, params, cfg, prompts, max_len):
    """Trace 4 long prompts (prefill + 8 decode rounds) through the
    continuous engine."""
    from repro_torch.core.obs import MetricsRegistry
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(
        cfg, num_slots=NUM_SLOTS, max_len=max_len, max_new_tokens=9,
        temperature=TEMPERATURE, seed=SEED, metrics=MetricsRegistry())
    seqs = [eng.make_sequence(p) for p in prompts[8:12]]
    _traced(torch, lambda: eng.generate(params, seqs),
            "profile" if cfg.name == "qwen2.5-7b" else
            f"profile_serving {cfg.name}")


def _loss_inputs(torch, gen, N, V, dt):
    """Logits and the (N,) vectors of one loss call; old and ref logprobs
    sit near the logits' own logprobs, as on the training path, so the
    ratios and the KL are of order one."""
    from repro_torch.kernels.grpo_logprob import grpo_logprob_ref
    dev = torch.device("cuda")
    x = (4 * torch.randn((N, V), generator=gen, device=dev)).to(dt)
    t = torch.randint(0, V, (N,), generator=gen, device=dev)
    lp = grpo_logprob_ref(x, t)[0]
    old = lp + 0.3 * torch.randn(N, generator=gen, device=dev)
    ref = lp + 0.1 * torch.randn(N, generator=gen, device=dev)
    adv = torch.randn(N, generator=gen, device=dev)
    dlp = torch.randn(N, generator=gen, device=dev)
    g_ent = torch.randn(N, generator=gen, device=dev)
    return x, t, old, ref, adv, dlp, g_ent


def _check_dx(dtype, shape, x, t, stats, dx):
    """dx of the backward kernel against its plain version, each element
    within its own limit; returns (max abs err, max err/limit)."""
    from repro_torch.kernels.fused_rl_loss import (fused_rl_loss_bwd_ref,
                                                   fused_rl_loss_bwd_tolerance)
    want = fused_rl_loss_bwd_ref(x, t, *stats)
    limit = fused_rl_loss_bwd_tolerance(x, t, *stats, want, DX_RTOL[dtype])
    err = (dx.float() - want.float()).abs()
    worst = (err / limit).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"fused_rl_loss_bwd {dtype} {shape}: dx "
                             f"disagrees with its plain version ({worst} "
                             f"times the limit)")
    return err.max().item(), worst


def phase_loss_kernels(torch, timed):
    """The three vocab-streaming kernels against their plain versions, at
    the Qwen2.5, Falcon-Mamba and RecurrentGemma vocabs, and at Grok-1's
    (131,072), InternVL2-26B's (92,553, odd), MiniCPM3-4B's (73,448),
    DeepSeek-V2's (102,400) and Whisper-tiny's (51,865, odd) at their
    micro-batches' rows; returns {name: row} at the ``timed`` (dtype, N,
    V)."""
    from repro_torch.kernels.fused_rl_loss import (fused_rl_loss_bwd,
                                                   fused_rl_loss_bwd_ref,
                                                   fused_rl_loss_fwd,
                                                   fused_rl_loss_fwd_ref)
    from repro_torch.kernels import _build
    from repro_torch.kernels.grpo_logprob import (grpo_logprob,
                                                  grpo_logprob_ref)
    from repro_torch.kernels.grpo_logprob.ops import nsplit_for
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    g_entry = _build.kernel("grpo_logprob")
    f_entry = _build.kernel("fused_rl_loss_fwd")
    V = 152_064
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows, out, lengths = [], {}, {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for N, VV in ((4096, V), (TRAIN_ROWS, V), (4096, SSM_VOCAB),
                      (TRAIN_ROWS, SSM_VOCAB), (TRAIN_ROWS, HYB_VOCAB),
                      (7, 259), (GROK_TRAIN_ROWS * 79, GROK_VOCAB),
                      (VLM_TRAIN_ROWS * 79, VLM_VOCAB),
                      (TRAIN_ROWS, MINICPM3_VOCAB),
                      (DEEPSEEK_TRAIN_ROWS * 79, DEEPSEEK_VOCAB),
                      (WHISPER_TRAIN_ROWS * 79, WHISPER_VOCAB)):
            x, t, old, ref, adv, dlp, g_ent = _loss_inputs(torch, gen, N, VV,
                                                           dt)
            e = x.element_size()
            lp, ent = grpo_logprob(x, t)
            err_lp = max(_check("grpo_logprob", "float32", (N, VV), o, r)
                         for o, r in zip((lp, ent), grpo_logprob_ref(x, t)))
            fo = fused_rl_loss_fwd(x, t, old, ref, adv)
            err_f = max(_check("fused_rl_loss_fwd", "float32", (N, VV), o, r)
                        for o, r in zip(fo, fused_rl_loss_fwd_ref(
                            x, t, old, ref, adv)))
            lse, xbar = fo[5], fo[5] - fo[1]
            err_b, dx_share = _check_dx(
                dtype, (N, VV), x, t, (lse, xbar, dlp, g_ent),
                fused_rl_loss_bwd(x, t, lse, xbar, dlp, g_ent))
            sets = _copies(torch, (x, t, old, ref, adv, lse, xbar, dlp,
                                   g_ent))
            nv = N * VV
            code = _build.DTYPE_CODES[dt]
            # the split the C entries choose, held to the Python mirror
            nsplit = _build.kernel("vocab_nsplit")(N, VV, code)
            if nsplit != nsplit_for(n_sm, N, VV, e):
                raise AssertionError(f"vocab_nsplit {N}x{VV}: {nsplit}, "
                                     f"nsplit_for: "
                                     f"{nsplit_for(n_sm, N, VV, e)}")
            buf = torch.empty((6, N), dtype=torch.float32, device="cuda")
            # the C entries alone (the main path's choice of split) and
            # their kernels' names in the profiler
            entries = {
                "grpo_logprob": (lambda x, t, *r: g_entry(
                    x.data_ptr(), t.data_ptr(), buf.data_ptr(), N, VV, 0,
                    code, stream), "grpo_logprob_kernel"),
                "fused_rl_loss_fwd": (lambda x, t, o, r, a, *_: f_entry(
                    x.data_ptr(), t.data_ptr(), o.data_ptr(), r.data_ptr(),
                    a.data_ptr(), buf.data_ptr(), N, VV, 0, 0.2, code,
                    stream), "fwd_kernel")}
            cases = {
                "grpo_logprob": (
                    err_lp, lambda x, t, *r: grpo_logprob(x, t),
                    lambda x, t, *r: grpo_logprob_ref(x, t),
                    lambda x, *r: torch.log_softmax(x, dim=-1),
                    nv * e + 8 * N + 8 * N, 4 * nv),
                "fused_rl_loss_fwd": (
                    err_f, lambda x, t, o, r, a, *_: fused_rl_loss_fwd(
                        x, t, o, r, a),
                    lambda x, t, o, r, a, *_: fused_rl_loss_fwd_ref(
                        x, t, o, r, a),
                    lambda x, *r: torch.log_softmax(x, dim=-1),
                    nv * e + 8 * N + 12 * N + 24 * N, 4 * nv),
                "fused_rl_loss_bwd": (
                    err_b, lambda x, t, o, r, a, l, xb, d, g:
                    fused_rl_loss_bwd(x, t, l, xb, d, g),
                    lambda x, t, o, r, a, l, xb, d, g:
                    fused_rl_loss_bwd_ref(x, t, l, xb, d, g),
                    lambda x, *r: torch.softmax(x, dim=-1),
                    2 * nv * e + 8 * N + 16 * N, 6 * nv)}
            for name, (err, fn, plain, lib, nbytes, ops) in cases.items():
                # fp32 arithmetic on the CUDA cores whatever the input type
                bound, by = _bound(nbytes, ops, "float32")
                # host time varies from call to call: many calls where a
                # call is short, and the wrapper and the entry timed before
                # the profiler's window, as scripts/vocab_pass_variants.py
                # times them
                iters = 20 if N >= 4096 else 200
                row = dict(kernel=name, dtype=dtype, N=N, V=VV,
                           max_abs_err=err, ms=_time_ms(torch, fn, sets,
                                                        iters))
                if name in entries:
                    entry, kname = entries[name]
                    row.update(
                        nsplit=nsplit,
                        entry_ms=_time_ms(torch, entry, sets, iters),
                        device_ms=_device_ms(torch, fn, sets, 20, kname))
                else:
                    row["max_err_over_limit"] = dx_share
                row.update(plain_ms=_time_ms(torch, plain, sets, 5),
                           library_ms=_time_ms(torch, lib, sets, 20),
                           bound_ms=bound, bound_by=by)
                rows.append(row)
                if (dtype, N, VV) == timed:
                    out[name] = row
            del x, t, old, ref, adv, dlp, g_ent, sets, fo, lp, ent, buf
            torch.cuda.empty_cache()
    for row in rows:
        print("kernel_vs_plain", json.dumps(row))
    return out


def _train_rows(cfg, n, seed, seq_len=80, prompt_len=16):
    """``n`` synthetic experience rows of ``seq_len`` tokens, as the
    TransferQueue hands them to the train stage."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mask = np.r_[np.zeros(prompt_len), np.ones(seq_len - prompt_len)]
    return {
        "response": [rng.integers(3, cfg.vocab_size, seq_len)
                     for _ in range(n)],
        "logprob": [(-12.0 + 0.3 * rng.standard_normal(seq_len))
                    .astype(np.float32) for _ in range(n)],
        "ref_logprob": [(-12.0 + 0.3 * rng.standard_normal(seq_len))
                        .astype(np.float32) for _ in range(n)],
        "response_mask": [mask.astype(np.float32)] * n,
        "advantage": [float(a) for a in rng.standard_normal(n)],
    }


def _plain_fused_rl_loss(logits, targets, old, ref, adv, *, clip_eps=0.2):
    """``fused_rl_loss`` through the unfused plain oracle (autograd)."""
    from repro_torch.kernels.fused_rl_loss import fused_rl_loss_oracle
    shape, V = targets.shape, logits.shape[-1]
    outs = fused_rl_loss_oracle(
        logits.reshape(-1, V), targets.reshape(-1), old.reshape(-1),
        ref.reshape(-1), adv.reshape(-1), clip_eps=clip_eps)
    return tuple(o.reshape(shape) for o in outs)


def _flat(prefix, tree):
    """{"prefix/key/...": leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k: v for key, sub in tree.items()
            for k, v in _flat(f"{prefix}/{key}", sub).items()}


def _watched_grads(cfg, g):
    """The gradients a route without a backward would lose: the attention
    weights (flash), every mamba parameter (the selective scan), or every
    RG-LRU parameter (its scan) and every attention weight of the hybrid's
    first tile and remainder; for the moe family the router, the experts'
    ``up``, the head and the embedding; under MLA every latent projection
    of every stack (``dense_blocks`` too), beside the moe family's; for
    the audio family the q/k/v weights of the encoder's attention and of
    the decoder's self- and cross-attention, both position tables and the
    embedding."""
    if cfg.arch_type == "ssm":
        return _flat("mamba", g["blocks"]["mamba"])
    if cfg.arch_type == "audio":
        out = {f"{stack}/{mix}/{w}": g[stack][mix][w]["w"]
               for stack, mixes in (("enc_blocks", ("attn",)),
                                    ("dec_blocks", ("attn", "cross")))
               for mix in mixes for w in ("wq", "wk", "wv")}
        return {**out, "enc_pos": g["enc_pos"], "dec_pos": g["dec_pos"],
                "embed": g["embed"]["table"]}
    if cfg.arch_type == "hybrid":
        out = {}
        for name, blk in g["tiles"].items():      # tile 0 of each stack
            mix = "rec" if "rec" in blk else "attn"
            out.update({k: t[0] for k, t in _flat(f"{name}/{mix}",
                                                  blk[mix]).items()})
        for i, blk in enumerate(g.get("rem", [])):
            mix = "rec" if "rec" in blk else "attn"
            out.update(_flat(f"rem{i}/{mix}", blk[mix]))
        return out
    out = {}
    if cfg.attention == "mla":
        for stack in ("dense_blocks", "blocks"):
            if stack in g:
                out.update(_flat(f"{stack}/attn", g[stack]["attn"]))
    elif cfg.arch_type != "moe":
        out = {w: g["blocks"]["attn"][w]["w"] for w in ("wq", "wk", "wv")}
    if cfg.arch_type == "moe":
        ffn = g["blocks"]["ffn"]
        out.update({"router": ffn["router"]["w"],
                    "experts/up": ffn["experts"]["up"],
                    "lm_head": g["lm_head"]["w"],
                    "embed": g["embed"]["table"]})
    return out


def _vision(torch, cfg, n):
    """``n`` rows of seeded stub patch embeddings, (n, T, d) fp32."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    return torch.randn((n, cfg.vision_tokens, cfg.d_model), generator=gen,
                       device="cuda")


def _frames(torch, cfg, n):
    """``n`` rows of seeded stub audio frames, (n, F, d) fp32."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    return torch.randn((n, cfg.encoder_frames, cfg.d_model), generator=gen,
                       device="cuda")


def _microbatch(torch, cfg2, params, n_rows, vision, ref_stage,
                frames=False):
    """``n_rows`` synthetic rows of 80 tokens, packed; with ``vision`` the
    batch carries stub patch embeddings, with ``frames`` stub audio
    frames. With ``ref_stage`` the reference
    logprobs come from the reference stage's own path (one forward through
    the flash kernel, ``token_logprobs`` through ``grpo_logprob``) and the
    behaviour's sit near them, so the ratios and the KL are of order
    one."""
    from repro_torch.engines import pack_rows
    from repro_torch.models import forward
    from repro_torch.rl.loss import token_logprobs
    batch = pack_rows(_train_rows(cfg2, n_rows, SEED), 80)
    if vision:
        batch["vision_embeds"] = _vision(torch, cfg2, n_rows)
    if frames:
        batch["frames"] = _frames(torch, cfg2, n_rows)
    if ref_stage:
        toks = batch["tokens"]
        inputs = {k: v for k, v in batch.items()
                  if k in ("tokens", "vision_embeds", "frames")}
        with torch.no_grad():
            logits, _ = forward(params, cfg2, inputs)
            lp, _ = token_logprobs(logits[:, -toks.shape[1]:-1], toks[:, 1:])
        del logits
        ref = torch.zeros_like(batch["ref_logprob"])
        ref[:, 1:] = lp
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        batch["ref_logprob"] = ref
        batch["old_logprob"] = ref + 0.1 * torch.randn(
            ref.shape, generator=gen, device="cuda")
    return batch


def phase_microbatch(torch, cfg2, n_rows=4, vision=False, ref_stage=False,
                     smi=None, frames=False, adamw=False):
    """One GRPO micro-batch (``n_rows`` x 80 tokens) at full width, cut
    depth: the kernels' loss against the plain loss on the same params and
    batch, in bf16 and fp32 compute. With ``vision`` the rows carry stub
    patch embeddings, with ``frames`` stub audio frames; with
    ``ref_stage`` their reference logprobs come through the flash and
    ``grpo_logprob`` kernels, the kernel route's gradients are taken twice
    in bf16 and must be the same bits, and each gradient tree waits in
    host memory while the next is taken (a moe model's trees are too large
    to hold two on the card). With ``adamw`` one ``grpo_train_step`` in
    bf16 then applies AdamW: the step counted, every parameter finite and
    some moved. Returns the launches of the main path: the reference
    stage's and the kernel route's."""
    from repro_torch.kernels.fused_rl_loss import (fused_rl_loss_bwd,
                                                   fused_rl_loss_fwd)
    from repro_torch.models import init_params
    from repro_torch.rl import loss as loss_mod
    from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step
    from repro_torch.tree import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    params = init_params(SEED, cfg2)
    counters = _counters("flash_attention", "grpo_logprob")
    before = {n: c.launches for n, c in counters.items()}
    batch = _microbatch(torch, cfg2, params, n_rows, vision, ref_stage,
                        frames)
    launches = {n: c.launches - before[n] for n, c in counters.items()}
    launches.update(fused_rl_loss_fwd=0, fused_rl_loss_bwd=0)
    rl = GRPOConfig(kl_coef=0.05)
    tol = {"bfloat16": 2e-2, "float32": 1e-4}
    report = {"phase": "microbatch", "model": cfg2.name,
              "layers": cfg2.num_layers, "rows": n_rows,
              "vision_tokens": cfg2.vision_tokens if vision else 0,
              "frames": cfg2.encoder_frames if frames else 0,
              "vocab": cfg2.vocab_size}
    if smi is not None:
        report["card"] = smi

    def kernel_grads(c):
        n = fused_rl_loss_fwd.launches, fused_rl_loss_bwd.launches
        torch.cuda.synchronize()
        t0 = time.monotonic()
        g, m = grpo_grad_step(params, c, rl, batch)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        if (fused_rl_loss_fwd.launches, fused_rl_loss_bwd.launches) != \
                (n[0] + 1, n[1] + 1):
            raise AssertionError("the micro-batch missed the loss kernels")
        launches["fused_rl_loss_fwd"] += 1
        launches["fused_rl_loss_bwd"] += 1
        return g, m, dt

    def leaves(g):
        out = tree_leaves(g)
        return [t.cpu() for t in out] if ref_stage else out

    for compute, gtol in tol.items():
        c = dataclasses.replace(cfg2, compute_dtype=compute)
        g_k, m_k, t_k = kernel_grads(c)
        watched = {k: float(t.abs().max())
                   for k, t in _watched_grads(cfg2, g_k).items()}
        g_k = leaves(g_k)
        inner = loss_mod.fused_rl_loss
        loss_mod.fused_rl_loss = _plain_fused_rl_loss
        try:
            t0 = time.monotonic()
            g_p, m_p = grpo_grad_step(params, c, rl, batch)
            torch.cuda.synchronize()
            t_p = time.monotonic() - t0
        finally:
            loss_mod.fused_rl_loss = inner
        stats = {k: (float(m_k[k]), float(m_p[k])) for k in m_k}
        for k, (a, b) in stats.items():
            if not (math.isfinite(a) and abs(a - b) <= 1e-4 * (1 + abs(b))):
                raise AssertionError(f"micro-batch {compute} {k}: kernel "
                                     f"{a} vs plain {b}")
        rel = max(float((a.to(b.device) - b).norm()
                        / b.norm().clamp_min(1e-30))
                  for a, b in zip(g_k, tree_leaves(g_p)))
        del g_p
        if not rel <= gtol:
            raise AssertionError(f"micro-batch {compute}: gradients differ "
                                 f"by {rel} relative (limit {gtol})")
        if not min(watched.values()) > 0.0:
            raise AssertionError(f"parameters got no gradient: {watched}")
        report[compute] = {"stats_kernel_plain": stats,
                           "max_grad_rel_frobenius": rel, "limit": gtol,
                           "grad_abs_max": watched, "grad_step_s": t_k,
                           "plain_grad_step_s": t_p}
        if ref_stage and compute == "bfloat16":
            g2, m2, _ = kernel_grads(c)
            same = all(torch.equal(a.to(b.device), b)
                       for a, b in zip(g_k, tree_leaves(g2))) and \
                all(torch.equal(m_k[k], m2[k]) for k in m_k)
            del g2
            if not same:
                raise AssertionError("micro-batch: two gradient calls "
                                     "gave different bits")
            report[compute]["bit_identical_over_two_calls"] = same
        del g_k
    if adamw:
        report["adamw"], ran = _adamw_step(torch, params, cfg2, rl, batch)
        for name, n in ran.items():
            launches[name] += n
    report["launches"] = launches
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps(report))
    del params, batch
    _release(torch)
    return launches


def _adamw_step(torch, params, cfg, rl, batch):
    """One ``grpo_train_step`` (gradients through the loss kernels, then
    AdamW): the step counted, every new parameter finite, some moved, each
    loss kernel launched exactly once. Returns the report's fields and the
    launches the step made, read from the counters."""
    from repro_torch.rl import grpo_train_step
    from repro_torch.training import OptimizerConfig, TrainState
    from repro_torch.tree import tree_leaves
    counters = _counters("flash_attention", "grpo_logprob",
                         "fused_rl_loss_fwd", "fused_rl_loss_bwd")
    before = {n: c.launches for n, c in counters.items()}
    new, m = grpo_train_step(TrainState.create(params), cfg, rl,
                             OptimizerConfig(), batch)
    ran = {n: c.launches - before[n] for n, c in counters.items()}
    moved = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(new.params), tree_leaves(params)))
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves(new.params))
    if new.step != 1 or not finite or not moved > 0.0 or \
            ran["fused_rl_loss_fwd"] != 1 or ran["fused_rl_loss_bwd"] != 1:
        raise AssertionError(f"AdamW step: step {new.step}, finite "
                             f"{finite}, largest change {moved}, "
                             f"launches {ran}")
    return {"step": new.step, "grad_norm": float(m["grad_norm"]),
            "loss": float(m["loss"]), "max_param_change": moved,
            "launches": ran}, ran


def _expect_launches(what, launches, ran, idle=()):
    """Every kernel of ``ran`` launched and none of ``idle``."""
    if any(launches[n] == 0 for n in ran) or any(launches[n] for n in idle):
        raise AssertionError(f"{what}: expected {list(ran)} to launch and "
                             f"{list(idle)} not to: {launches}")


def _counters(*names):
    """The kernel wrappers by name (their ``launches`` counts)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_rl_loss import (fused_rl_loss_bwd,
                                                   fused_rl_loss_fwd)
    from repro_torch.kernels.grpo_logprob import grpo_logprob
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.rglru_scan import rglru_scan
    every = {"flash_attention": flash_attention,
             "decode_attention": decode_attention,
             "grpo_logprob": grpo_logprob,
             "fused_rl_loss_fwd": fused_rl_loss_fwd,
             "fused_rl_loss_bwd": fused_rl_loss_bwd,
             "mamba_scan": mamba_scan,
             "rglru_scan": rglru_scan}
    return {n: every[n] for n in names}


def phase_trainer(torch, cfg2, smi, backend, kernels, report=None, idle=(),
                  **overrides):
    """``Trainer.fit`` on the card; returns (trainer, launches of
    ``kernels``, each of which must have run, and of ``idle``, none of
    which may have run). ``overrides`` replace
    ``TrainerConfig`` fields (PPO: ``algorithm="ppo"``, ``kl_coef=0``);
    ``report``, a dict, receives the printed line's fields.

    lr 1e-6, a GRPO post-training rate for 7B models: at the CPU-scale
    default 3e-4, AdamW's first, sign-like steps on the KL term's
    near-zero gradients move every logit by about a nat per step, and the
    KL of random weights runs away within three steps."""
    from repro_torch.api import Trainer, TrainerConfig
    from repro_torch.core.obs import get_registry
    # the run's telemetry reads the process-global registry: start it empty
    # so an earlier run's weight syncs do not count here
    get_registry().clear()
    tcfg = TrainerConfig(**{**dict(
        mode="async", num_steps=3, prompts_per_step=4, group_size=4,
        rollout_workers=2, rollout_batch=2, train_micro_batch=4,
        max_new_tokens=64, seq_len=80, kl_coef=0.05, lr=1e-6,
        rollout_backend=backend, staleness=1, seed=SEED), **overrides})
    before = torch.cuda.memory_allocated()
    trainer = Trainer(tcfg, model_cfg=cfg2)
    counters = _counters(*kernels, *idle)
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    res = trainer.fit()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {n: c.launches for n, c in counters.items()}
    n = tcfg.num_steps * tcfg.prompts_per_step * tcfg.group_size
    steps = [m for m in res.metrics if "grad_norm" in m]
    if res.samples_trained != n or len(steps) != tcfg.num_steps:
        raise AssertionError(f"trainer: {res.samples_trained} samples, "
                             f"{len(steps)} steps")
    for m in steps:
        for k in ("loss", "grad_norm", "policy_loss", "entropy",
                  "ratio_mean"):
            if not math.isfinite(m[k]):
                raise AssertionError(f"trainer: {k} not finite: {m}")
    critic = res.aux_metrics.get("critic_update", [])
    if tcfg.algorithm == "ppo":
        if len(critic) != tcfg.num_steps:
            raise AssertionError(f"critic: {len(critic)} steps: {critic}")
        for m in critic:
            if not all(math.isfinite(m[k]) for k in ("value_loss",
                                                     "grad_norm")):
                raise AssertionError(f"critic: not finite: {m}")
    if max(res.staleness_seen) > tcfg.staleness + 1:
        raise AssertionError(f"staleness {max(res.staleness_seen)}")
    _expect_launches(f"{cfg2.name} training", launches, kernels, idle)
    tel = res.telemetry
    sync = [v for v in tel["metrics"].get("weight_sync_seconds",
                                          {}).get("values", [])]
    stage_s = {r["stage"]: r["busy_s"] for r in tel["stages"]}
    line = {
        "phase": "trainer", "card": smi, "model": cfg2.name,
        "algorithm": tcfg.algorithm, "kl_coef": tcfg.kl_coef,
        "layers": cfg2.num_layers, "rollout_backend": backend,
        "steps": len(steps), "samples": res.samples_trained,
        "wall_s": wall, "samples_per_s": res.samples_trained / wall,
        "max_staleness": max(res.staleness_seen), "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "resident_gb": {"before_trainer": before / 1e9,
                        "before_fit": resident / 1e9},
        "weight_sync_seconds": sync, "stages": tel["stages"],
        "instances": tel["instances"], "metrics": steps,
        **({"values_s": stage_s.get("values"),
            "critic_update_s": stage_s.get("critic_update"),
            "critic_metrics": critic} if tcfg.algorithm == "ppo" else {})}
    print(json.dumps(line))
    if report is not None:
        report.update(line)
    return trainer, launches


def phase_fleet(torch, cfg, params, prompts, smi):
    """``launch.serve``'s supervised fleet over the full-width serving
    weights: FLEET_REPLICAS continuous-engine replicas drain the prompts
    under ``ReplicaSupervisor`` while a seeded injector crashes some; every
    request is answered exactly once, a restart is counted, ids are within
    the vocab and both attention kernels launched. Returns the launches."""
    from types import SimpleNamespace

    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import _serve_fleet
    args = SimpleNamespace(replicas=FLEET_REPLICAS, crash_p=FLEET_CRASH_P,
                           fault_seed=FLEET_FAULT_SEED, slots=NUM_SLOTS,
                           max_new_tokens=FLEET_NEW, temperature=TEMPERATURE,
                           seed=SEED)
    requests = [{"tokens": p, "text": f"request {i}"}
                for i, p in enumerate(prompts)]
    decode_attention.launches = flash_attention.launches = 0
    t0 = time.monotonic()
    outputs, restarts = _serve_fleet(args, cfg, params, requests,
                                     ByteTokenizer(), "cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    if [o["prompt"] for o in outputs] != [r["text"] for r in requests]:
        raise AssertionError("fleet: requests not answered once each")
    ids = [t for o in outputs for t in o["response_ids"]]
    if not all(o["response_ids"] for o in outputs) or \
            not all(0 <= t < cfg.vocab_size for t in ids):
        raise AssertionError("fleet: empty answer or id out of range")
    if restarts < 1:
        raise AssertionError("fleet: no replica restart was counted")
    if min(launches.values()) == 0:
        raise AssertionError(f"fleet: a kernel never ran: {launches}")
    print(json.dumps({
        "phase": "fleet", "model": cfg.name, "layers": cfg.num_layers,
        "card": smi, "replicas": FLEET_REPLICAS, "crash_p": FLEET_CRASH_P,
        "fault_seed": FLEET_FAULT_SEED, "requests": len(outputs),
        "replica_restarts": restarts, "new_tokens": len(ids),
        "wall_s": wall, "tokens_per_s": len(ids) / wall,
        "launches": launches}))
    return launches


def _ppo_rows(cfg, n, seed):
    """PPO experience rows: ``_train_rows`` with per-token advantages,
    returns and old values, as the GAE stage writes them."""
    import numpy as np
    rows = _train_rows(cfg, n, seed)
    rng = np.random.default_rng(seed + 1)
    mask = rows["response_mask"][0]
    per_tok = [(rng.standard_normal(len(mask)) * mask).astype(np.float32)
               for _ in range(3 * n)]
    rows["advantage"] = per_tok[:n]
    rows["returns"] = per_tok[n:2 * n]
    rows["values"] = [0.1 * v for v in per_tok[2 * n:]]
    return rows


def _plain_values(torch, critic, cfg, tokens):
    """The critic's values through ``forward_hidden(use_kernels=False)``
    and the value head, on the host."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import dense
    with torch.no_grad():
        hidden = transformer.forward_hidden(critic["backbone"], cfg, tokens,
                                            use_kernels=False)
        return dense(critic["value_head"], hidden,
                     hidden.dtype)[..., 0].float().cpu()


def phase_ppo_microbatch(torch, cfg2):
    """One PPO micro-batch (4 x 80 tokens) at full width, cut depth. The
    actor's loss, stats and every gradient through the loss kernels against
    the plain loss; the critic's value loss (it has no kernel) with every
    gradient finite and the backbone's lm_head gradient exactly zero; the
    critic's values through ``CriticEngine.compute_values`` (the kernels'
    forward) against ``forward_hidden(use_kernels=False)`` under the value
    head: within 1e-4 + 1e-4·|ref| in fp32, and in bf16 by the
    teacher-forced phases' rule (the kernel route at most BF16_TF_FACTOR
    times as far from an fp32 forward as the plain bf16 route). bf16 and
    fp32 compute."""
    import numpy as np

    from repro_torch.autodiff import grad_and_metrics
    from repro_torch.engines import CriticEngine, pack_rows
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_rl_loss import (fused_rl_loss_bwd,
                                                   fused_rl_loss_fwd)
    from repro_torch.models import init_params
    from repro_torch.rl import loss as loss_mod
    from repro_torch.rl import ppo
    from repro_torch.tree import tree_leaves
    params = init_params(SEED, cfg2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    critic = ppo.init_critic_params(gen, cfg2)
    rows = _ppo_rows(cfg2, 4, SEED)
    batch = pack_rows(rows, 80)
    rl = ppo.PPOConfig()
    tol = {"bfloat16": 2e-2, "float32": 1e-4}
    cfg32 = dataclasses.replace(cfg2, compute_dtype="float32")
    report = {"phase": "ppo_microbatch", "model": cfg2.name,
              "layers": cfg2.num_layers}
    for compute, gtol in tol.items():
        c = dataclasses.replace(cfg2, compute_dtype=compute)
        n = fused_rl_loss_fwd.launches, fused_rl_loss_bwd.launches
        torch.cuda.synchronize()
        t0 = time.monotonic()
        g_k, m_k = grad_and_metrics(ppo.ppo_actor_loss_fn, params, c, batch,
                                    rl)
        torch.cuda.synchronize()
        t_k = time.monotonic() - t0
        if (fused_rl_loss_fwd.launches, fused_rl_loss_bwd.launches) != \
                (n[0] + 1, n[1] + 1):
            raise AssertionError("the PPO micro-batch missed the loss "
                                 "kernels")
        inner = loss_mod.fused_rl_loss
        loss_mod.fused_rl_loss = _plain_fused_rl_loss
        try:
            g_p, m_p = grad_and_metrics(ppo.ppo_actor_loss_fn, params, c,
                                        batch, rl)
        finally:
            loss_mod.fused_rl_loss = inner
        stats = {k: (float(m_k[k]), float(m_p[k])) for k in m_k}
        for k, (a, b) in stats.items():
            if not (math.isfinite(a) and abs(a - b) <= 1e-4 * (1 + abs(b))):
                raise AssertionError(f"PPO micro-batch {compute} {k}: "
                                     f"kernel {a} vs plain {b}")
        rel = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                  for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)))
        if not rel <= gtol:
            raise AssertionError(f"PPO micro-batch {compute}: gradients "
                                 f"differ by {rel} relative (limit {gtol})")
        watched = {k: float(t.abs().max())
                   for k, t in _watched_grads(cfg2, g_k).items()}
        if not min(watched.values()) > 0.0:
            raise AssertionError(f"parameters got no gradient: {watched}")
        del g_k, g_p
        g_c, m_c = grad_and_metrics(ppo.ppo_critic_loss_fn, critic, c,
                                    batch, rl, zero_unused=True)
        lm_head = float(g_c["backbone"]["lm_head"]["w"].abs().max())
        finite = all(bool(torch.isfinite(t).all()) for t in
                     tree_leaves(g_c))
        c_watched = {k: float(t.abs().max()) for k, t in _watched_grads(
            cfg2, g_c["backbone"]).items()}
        c_watched["value_head"] = float(g_c["value_head"]["w"].abs().max())
        if lm_head != 0.0 or not finite or not min(c_watched.values()) > 0:
            raise AssertionError(f"critic grads {compute}: lm_head max "
                                 f"{lm_head}, finite {finite}, {c_watched}")
        del g_c
        eng = CriticEngine(c, critic)
        n_flash = flash_attention.launches
        got = eng.compute_values(rows)["updates"]["values"]
        launched = flash_attention.launches - n_flash
        if launched != cfg2.num_layers:
            raise AssertionError(f"compute_values launched flash "
                                 f"{launched} times")
        del eng
        got = torch.tensor(np.stack(got))
        plain = {k: _plain_values(torch, critic, cc, batch["tokens"])
                 for k, cc in ((compute, c), ("float32", cfg32))}
        v_err = float((got - plain[compute]).abs().max())
        if compute == "float32":
            ok = bool(((got - plain[compute]).abs()
                       <= gtol + gtol * plain[compute].abs()).all())
            values = {"max_abs_err": v_err}
        else:
            # the bf16 rule of the teacher-forced phases: the kernel
            # route's distance from an fp32 forward is at most
            # BF16_TF_FACTOR times the plain bf16 route's
            values = {
                "kernel_vs_plain": v_err,
                "kernel_vs_fp32": float((got - plain["float32"])
                                        .abs().max()),
                "plain_vs_fp32": float((plain[compute] - plain["float32"])
                                       .abs().max())}
            ok = values["kernel_vs_fp32"] <= \
                BF16_TF_FACTOR * values["plain_vs_fp32"]
        if not ok:
            raise AssertionError(f"compute_values {compute}: {values}")
        report[compute] = {"actor_stats_kernel_plain": stats,
                           "actor_max_grad_rel_frobenius": rel,
                           "limit": gtol, "actor_grad_abs_max": watched,
                           "actor_grad_step_s": t_k,
                           "value_loss": float(m_c["value_loss"]),
                           "critic_lm_head_grad_abs_max": lm_head,
                           "critic_grad_abs_max": c_watched,
                           "values": values}
    print(json.dumps(report))
    del params, critic
    _release(torch)


def _snapshot_records(torch):
    """Wrap ``RunCheckpointer.save``/``load_engine`` and the trainer's
    ``save_checkpoint`` (its ``<dir>/final`` dump) to record each one's
    seconds and bytes; returns (records, undo)."""
    import repro_torch.training as training
    from repro_torch.core.recovery import snapshot as snap
    records = []
    save, load, final = (snap.RunCheckpointer.save,
                         snap.RunCheckpointer.load_engine,
                         training.save_checkpoint)

    def timed(kind, fn, path_of):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            records.append({"kind": kind, "s": time.monotonic() - t0,
                            "bytes": snap._dir_bytes(path_of(a, out))})
            return out
        return wrapper

    snap.RunCheckpointer.save = timed("snapshot", save, lambda a, o: o)
    snap.RunCheckpointer.load_engine = staticmethod(timed(
        "restore", load, lambda a, o: os.path.join(a[0], a[1])))
    training.save_checkpoint = timed("final_dump", final, lambda a, o: a[0])

    def undo():
        snap.RunCheckpointer.save = save
        snap.RunCheckpointer.load_engine = staticmethod(load)
        training.save_checkpoint = final
    return records, undo


def phase_durability(torch, cfg1, smi):
    """GRPO with KL at full width, cut to DURABLE_LAYERS layers, baseline
    mode: an uninterrupted DURABLE_STEPS-step run, twice; a run of half
    the steps with snapshots (``checkpoint_interval_steps=0``: the run's
    start and end); a fresh trainer that resumes from them
    (``fit(resume="auto")``) to the last step. The second uninterrupted
    run's step metrics equal the first's, and the stitched run's equal
    the first's, bit for bit. Where the disk under the snapshot directory
    cannot hold the run's snapshots and dumps, the reduced trunk runs
    instead. Returns the launches of ``grpo_logprob``."""
    import shutil

    from repro_torch.api import Trainer, TrainerConfig
    from repro_torch.configs import get_config
    from repro_torch.core.obs import get_registry
    from repro_torch.kernels.grpo_logprob import grpo_logprob
    from repro_torch.models import count_params, init_params
    directory = ROOT / "build" / "smoke_snapshots"
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    kw = dict(mode="baseline", prompts_per_step=4, group_size=4,
              rollout_workers=1, rollout_batch=4, train_micro_batch=16,
              max_new_tokens=DURABLE_NEW, seq_len=16 + DURABLE_NEW,
              kl_coef=0.05, lr=1e-6, rollout_backend="continuous",
              seed=SEED, checkpoint_keep_last=1)

    def fit(cfg, steps, resume=None, **more):
        get_registry().clear()
        tr = Trainer(TrainerConfig(num_steps=steps, **kw, **more),
                     model_cfg=cfg)
        res = tr.fit(resume=resume)
        del tr
        _release(torch)
        return res

    # one actor state: params and two moments in fp32. keep_last 1 holds
    # at most two snapshots at once (the new one before the old is
    # pruned), and two final dumps (the new before the old goes)
    state_bytes = 3 * 4 * count_params(init_params(SEED, cfg1))
    _release(torch)
    free = shutil.disk_usage(directory).free
    need = 4 * state_bytes
    width, why = "full", None
    if free < need:
        width = "reduced"
        why = (f"{free / 1e9:.1f} GB free under the snapshot directory, "
               f"{need / 1e9:.1f} GB needed at full width")
        cfg1 = dataclasses.replace(get_config("qwen2_5_7b").reduced(),
                                   vocab_size=cfg1.vocab_size)
    grpo_logprob.launches = 0
    records, undo = _snapshot_records(torch)
    t0 = time.monotonic()
    try:
        full = fit(cfg1, DURABLE_STEPS)
        again = fit(cfg1, DURABLE_STEPS)
        half = fit(cfg1, DURABLE_STEPS // 2, checkpoint_dir=str(directory),
                   checkpoint_interval_steps=0)
        resumed = fit(cfg1, DURABLE_STEPS, resume="auto",
                      checkpoint_dir=str(directory),
                      checkpoint_interval_steps=0)
    finally:
        undo()
        shutil.rmtree(directory, ignore_errors=True)
    wall = time.monotonic() - t0
    keys = ("loss", "policy_loss", "grad_norm", "mean_reward", "entropy")
    a, b = full.metrics, resumed.metrics
    if [m["step"] for m in a] != list(range(DURABLE_STEPS)) or \
            [m["step"] for m in b] != [m["step"] for m in a] or \
            [m["step"] for m in again.metrics] != [m["step"] for m in a] or \
            b[:len(half.metrics)] != half.metrics:
        raise AssertionError(f"durability: steps {a} vs {b}")

    def compare(other):
        return {"bit_identical": all(x[k] == y[k] for x, y in zip(a, other)
                                     for k in keys),
                "max_rel_diff": max(abs(x[k] - y[k]) / max(abs(x[k]), 1e-30)
                                    for x, y in zip(a, other) for k in keys)}
    rerun, resume = compare(again.metrics), compare(b)
    if not rerun["bit_identical"]:
        raise AssertionError(f"durability: a second uninterrupted run "
                             f"differs: {rerun}: {a} vs {again.metrics}")
    if not resume["bit_identical"] or \
            resumed.samples_trained != full.samples_trained:
        raise AssertionError(f"durability: the resumed run differs: "
                             f"{resume}: {a} vs {b}")
    if grpo_logprob.launches == 0:
        raise AssertionError("durability: grpo_logprob never ran")
    print(json.dumps({
        "phase": "durability", "model": cfg1.name,
        "layers": cfg1.num_layers, "width": width,
        **({"why": why} if why else {}), "card": smi,
        "disk_free_gb": free / 1e9, "state_gb": state_bytes / 1e9,
        "steps": DURABLE_STEPS, "rerun_vs_first": rerun,
        "resumed_vs_first": resume, "wall_s": wall,
        "grpo_logprob_launches": grpo_logprob.launches,
        "records": records, "metrics": b}))
    return grpo_logprob.launches


def planner_inputs(torch, trainer):
    """What the planner phase reads of phase 9's run, taken while its
    trainer lives: the measured seconds a row of each stage (the live
    registry), the cost model's for the same graph and engines, the
    continuous engine's decode-step and prefill seconds, the run's peak
    memory (``phase_trainer`` reset it) and the model's parameter
    count."""
    from repro_torch.core.obs import get_registry
    from repro_torch.core.planner import (estimate_stage_costs,
                                          stage_latencies_from_registry)
    from repro_torch.core.workflow import build_dataflow
    from repro_torch.models import count_params
    reg, t = get_registry(), trainer.tcfg
    graph = build_dataflow(t.algorithm, kl_coef=t.kl_coef)
    return {
        "tcfg": t, "params": count_params(trainer.train_engine.params),
        "peak": torch.cuda.max_memory_allocated(),
        "analytic": estimate_stage_costs(graph, trainer.engines,
                                         seq_len=t.seq_len,
                                         group_size=t.group_size),
        "measured": stage_latencies_from_registry(reg),
        "decode": reg.get("rollout_decode_step_seconds").summary(engine="cb"),
        "prefill": reg.get("rollout_prefill_seconds").summary(engine="cb")}


def _planner_spies():
    """Wrap ``StageRunner`` and ``ElasticController`` to record the sized
    worker counts, every resize decision, the controller's steps and the
    rows the generate stage writes; returns (records, undo)."""
    import numpy as np

    from repro_torch.core.planner import ElasticController
    from repro_torch.core.workflow import StageRunner
    rec = {"sized": None, "costs": None, "resizes": [], "steps": 0,
           "actions": [], "rows": 0, "bad_rows": [], "t0": time.monotonic()}
    init, resize = StageRunner.__init__, StageRunner._resize_stage
    step, put = ElasticController.step, StageRunner._put_rows

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        rec["sized"] = dict(self._desired)
        rec["costs"] = {n: c.seconds_per_row
                        for n, c in (self.stage_costs or {}).items()}
        rec["vocab"] = self.engines["rollout"].cfg.vocab_size

    def spy_resize(self, name, delta):
        ok = resize(self, name, delta)
        rec["resizes"].append({"s": time.monotonic() - rec["t0"],
                               "stage": name, "delta": delta,
                               "applied": ok, "workers": self._desired[name]})
        return ok

    def spy_step(self):
        out = step(self)
        rec["steps"] += 1
        rec["actions"] += [{"s": time.monotonic() - rec["t0"], **a}
                           for a in out]
        return out

    def spy_put(self, spec, out_cols, rows, *a, **k):
        for r in rows:
            ids = np.asarray(r["response_ids"])
            lp = np.asarray(r["logprob"])[np.asarray(r["response_mask"]) > 0]
            rec["rows"] += 1
            if not ((ids >= 0).all() and (ids < rec["vocab"]).all()
                    and np.isfinite(lp).all() and (lp <= 0).all()):
                rec["bad_rows"].append({"ids": ids.tolist(),
                                        "logprob": lp.tolist()})
        return put(self, spec, out_cols, rows, *a, **k)

    StageRunner.__init__ = spy_init
    StageRunner._resize_stage = spy_resize
    ElasticController.step = spy_step
    StageRunner._put_rows = spy_put

    def undo():
        StageRunner.__init__, StageRunner._resize_stage = init, resize
        ElasticController.step, StageRunner._put_rows = step, put
    return rec, undo


def phase_planner(torch, cfg, cfg2, smi, seen):
    """The planner on the card (phase 10a). (a) The cost model beside the
    card: ``make_profile_fn`` profiles the reduced Qwen (its
    ``profile_reduced_blocks`` drives ``decode_attention`` and both loss
    kernels); ``CostOracle(cfg2, HW())`` at phase 9's shapes beside phase
    9's measured seconds; ``estimate_stage_costs``' seconds a row beside
    the measured ones, with their ratio; the measured reduced decode step
    over its bound beside the reference's ``eff``; a plan for a cluster of
    PLANNER_CLUSTER cards, analytic and hybrid. No bar on the ratios. (b)
    ``Trainer.fit`` at phase 9's settings with ``auto_size_workers`` and
    live rebalance every PLANNER_ELASTIC_S, its worker cap the count of
    rollout workers whose weight copies fit on the card, reckoned by
    count and by phase 9's peak. Returns the launches of (b); the
    profiler's, at its reduced shape, are printed but not returned."""
    from repro_torch.core.planner import (HW, CostOracle, Workload,
                                          make_profile_fn, plan_resources)
    hw = HW()
    props = torch.cuda.get_device_properties(0)
    t = seen["tcfg"]
    prof_counters = _counters("decode_attention", "fused_rl_loss_fwd",
                              "fused_rl_loss_bwd")
    for c in prof_counters.values():
        c.launches = 0
    w = Workload(prompts_per_step=64, group_size=4, num_steps=2)
    pf = make_profile_fn(cfg, w, hw)
    torch.cuda.synchronize()
    prof_launches = {n: c.launches for n, c in prof_counters.items()}
    if min(prof_launches.values()) == 0:
        raise AssertionError(f"planner profile: a kernel never ran: "
                             f"{prof_launches}")
    oracle = CostOracle(cfg2, hw)
    prompt_len = t.seq_len - t.max_new_tokens
    predicted = {
        "decode_token_s": oracle.decode_token_s(t.cb_slots, t.seq_len, 1),
        "prefill_s": oracle.prefill_s(t.group_size, prompt_len, 1),
        "train_microbatch_s": oracle.train_microbatch_s(
            t.train_micro_batch, t.seq_len, 1)}
    measured = {
        "decode_step_p50_s": seen["decode"]["p50"],
        "prefill_mean_s": seen["prefill"]["mean"],
        "train_microbatch_s": seen["measured"].get("actor_update", math.nan)
        * t.train_micro_batch}
    rows = {n: {"analytic_s": c.seconds_per_row, "source": c.source,
                "measured_s": seen["measured"].get(n),
                "measured_over_analytic":
                    seen["measured"][n] / c.seconds_per_row
                    if n in seen["measured"] else None}
            for n, c in seen["analytic"].items()}
    plans = {}
    for name, kw in (("analytic", {}),
                     ("hybrid", {"profile_fn": pf, "profile_top_k": 3})):
        pr = plan_resources(cfg, PLANNER_CLUSTER, w, hw=hw, **kw)
        plans[name] = {"plan": dataclasses.asdict(pr.plan),
                       "samples_per_s": pr.throughput,
                       "candidates": pr.candidates_scored}
    raw = {k: v for k, v in pf.raw.items() if k != "reduced_cfg"}
    print(json.dumps({
        "phase": "planner_model", "card": smi, "device": props.name,
        "device_memory_bytes": props.total_memory,
        "hw": dataclasses.asdict(hw), "reduced_profile": raw,
        "profile_launches": prof_launches,
        "reduced_decode_over_bound": pf.decode_over_bound,
        "reference_eff": 1.15, "model": cfg2.name,
        "layers": cfg2.num_layers, "predicted": predicted,
        "measured": measured,
        "measured_over_predicted": {
            "decode": measured["decode_step_p50_s"]
            / predicted["decode_token_s"],
            "prefill": measured["prefill_mean_s"] / predicted["prefill_s"],
            "train_microbatch": measured["train_microbatch_s"]
            / predicted["train_microbatch_s"]},
        "stage_seconds_per_row": rows, "plans": plans}))

    # each rollout worker holds its own device copy of the weights. By
    # count: the actor's copies, the KL reference's and a swap's new one
    # beside the workers'; by phase 9's peak: one more copy a worker than
    # its rollout_workers. The cap is the smaller, within the card's
    # memory less PLANNER_MARGIN.
    copy = 4 * seen["params"]                 # one fp32 copy of the model
    usable = props.total_memory * (1 - PLANNER_MARGIN)
    by_count = int((usable - (ACTOR_COPIES + 2) * copy) // copy)
    by_peak = t.rollout_workers + int((usable - seen["peak"]) // copy)
    cap = max(1, min(by_count, by_peak))
    kernels = ("flash_attention", "decode_attention", "grpo_logprob",
               "fused_rl_loss_fwd", "fused_rl_loss_bwd")
    rec, undo = _planner_spies()
    run = {}
    try:
        trainer, launches = phase_trainer(
            torch, cfg2, smi, "continuous", kernels, report=run,
            auto_size_workers=True, elastic_interval_s=PLANNER_ELASTIC_S,
            max_stage_workers=cap)
    finally:
        undo()
    sized = rec["sized"] or {}
    counts = list(sized.values()) + [r["workers"] for r in rec["resizes"]]
    if not sized or sized.get("actor_update") != 1 or \
            not all(1 <= n <= cap for n in counts):
        raise AssertionError(f"planner: counts out of [1, {cap}]: {sized} "
                             f"{rec['resizes']}")
    if rec["steps"] == 0:
        raise AssertionError("planner: the elastic controller never stepped")
    if rec["bad_rows"] or rec["rows"] == 0:
        raise AssertionError(f"planner: {rec['rows']} rows, bad: "
                             f"{rec['bad_rows'][:2]}")
    print(json.dumps({
        "phase": "planner_trainer", "card": smi, "model": cfg2.name,
        "layers": cfg2.num_layers,
        "memory_reckoning": {"params": seen["params"],
                             "copy_gb": copy / 1e9,
                             "device_gb": props.total_memory / 1e9,
                             "margin": PLANNER_MARGIN,
                             "actor_copies": ACTOR_COPIES,
                             "phase9_peak_gb": seen["peak"] / 1e9,
                             "phase9_rollout_workers": t.rollout_workers,
                             "by_count": by_count, "by_peak": by_peak,
                             "max_stage_workers": cap},
        "stage_costs_s_per_row": rec["costs"], "sized": sized,
        "resizes": rec["resizes"], "controller_steps": rec["steps"],
        "actions": rec["actions"], "rows_checked": rec["rows"],
        "samples": run["samples"], "samples_per_s": run["samples_per_s"],
        "max_staleness": run["max_staleness"],
        "peak_mem_gb": run["peak_mem_gb"], "launches": launches}))
    del trainer
    _release(torch)
    return launches


def profile_actor_update(torch, trainer):
    """Trace one actor update (a micro-batch of 4 x 80 tokens through
    forward, loss and backward, then AdamW) on the trainer's engine; the
    phase is named after the model."""
    eng = trainer.train_engine
    eng.global_batch = 4
    rows = _train_rows(trainer.cfg, 4, SEED + 1)
    eng.update_actor(rows)                      # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    eng.update_actor(rows)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "actor_update", "model": trainer.cfg.name,
                      "layers": trainer.cfg.num_layers,
                      "wall_ms": (time.monotonic() - t0) * 1e3,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "peak_over_resident_gb":
                          (torch.cuda.max_memory_allocated() - base) / 1e9}))
    out = _traced(torch, lambda: eng.update_actor(rows),
                  f"profile_actor_update {trainer.cfg.name}")
    if not out or not math.isfinite(out["loss"]):
        raise AssertionError(f"actor update: {out}")


def _mamba_inputs(torch, gen, B, S, D, N):
    """x, dt, A, and B and C as strided views of one projection output (a
    row of 256 + 2N, as the model hands them over), in the model's ranges:
    A = -exp(a_log) = -(1..N), dt near softplus(-4.6) = 0.01."""
    dev = torch.device("cuda")
    x = torch.randn((B, S, D), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn((B, S, D), generator=gen, device=dev) - 4.6)
    a = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(
        D, N).contiguous()
    dbc = torch.randn((B, S, 256 + 2 * N), generator=gen, device=dev)
    return x, dt, a, dbc[..., 256:256 + N], dbc[..., 256 + N:]


def _mamba_bound(B, S, D, N, sfu_per_s):
    """The larger of the bytes (x, dt, y, B, C, A once) over the memory
    rate and the B*S*D*N exponentials over the special-function units'
    rate."""
    t_bytes = 4 * (3 * B * S * D + 2 * B * S * N + D * N) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = B * S * D * N / sfu_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, sfu_ms=t_ops)


def _rglru_inputs(torch, gen, B, S, W):
    """a = u^r with u in [0.9, 0.999] (lambda's init) and r a sigmoid
    gate, b = sqrt(1 - a^2) i x, as the model hands them over."""
    dev = torch.device("cuda")

    def randn():
        return torch.randn((B, S, W), generator=gen, device=dev)
    u = torch.empty(W, device=dev).uniform_(0.9, 0.999, generator=gen)
    a = u ** torch.sigmoid(randn())
    return a, torch.sqrt(1 - a * a) * torch.sigmoid(randn()) * randn()


def _rglru_bound(B, S, W):
    """Bytes: a and b read and h written once, 12 bytes an element (2
    FLOPs an element are far below)."""
    t_bytes = 3 * B * S * W * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * B * S * W / PEAK_FLOPS["float32"] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _scan_iters(B, S):
    """Calls a timing window: host time varies from call to call, so many
    where a call is short."""
    return 200 if B * S <= 1024 else 20


def _scan_times(torch, wrapper, entry, sets, kname, iters):
    """A scan's time through its wrapper and through its C entry alone, as
    the main path calls them (under no_grad): CUDA events over back-to-back
    calls, inputs cycled past L2. At the trainers' rows that is mostly the
    host's issue rate, which varies from window to window, so each is the
    median of three windows taken in turns. Beside them, its kernel's
    device time (``torch.profiler``, the host's time not in it) and the
    calls' device time by ``_queued_ms``, the profiler's fallback, which
    counts the gaps between queued kernels too."""
    ms, entry_ms = [], []
    with torch.no_grad():
        for _ in range(3):
            ms.append(_time_ms(torch, wrapper, sets, iters))
            entry_ms.append(_time_ms(torch, entry, sets, iters))
        return dict(ms=sorted(ms)[1], entry_ms=sorted(entry_ms)[1],
                    device_ms=_device_ms(torch, wrapper, sets, 20, kname),
                    queued_ms=_queued_ms(torch, wrapper, sets, 20))


def _mamba_entry(torch, B, S, D, N, path=0):
    """The C entry of ``mamba_scan`` alone as a call of the wrapper's
    inputs, into one output; ``path`` 0 is the entry's choice."""
    from repro_torch.kernels import _build
    fn = _build.kernel("mamba_scan")
    y = torch.empty((B, S, D), device="cuda")
    stream = _build.raw_stream(torch.cuda.current_device())
    return lambda x, dt, a, b, c: fn(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), B, S, D, N, b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), path, stream)


def _rglru_entry(torch, B, S, W, path=0):
    """The C entry of ``rglru_scan`` alone, as ``_mamba_entry``."""
    from repro_torch.kernels import _build
    fn = _build.kernel("rglru_scan")
    h = torch.empty((B, S, W), device="cuda")
    stream = _build.raw_stream(torch.cuda.current_device())
    return lambda a, b: fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S,
                           W, path, stream)


def _scan_path(name, mirror, *shape):
    """The path (short or long) the C entry ``<name>_path`` takes at
    ``shape``, held to the wrapper's mirror of its rule."""
    from repro_torch.kernels import _build
    took = _build.kernel(f"{name}_path")(*shape)
    if took != mirror:
        raise AssertionError(f"{name} {shape}: the entry takes path {took}, "
                             f"the wrapper's mirror says {mirror}")
    return PATH_NAMES[took]


def phase_mamba_scan(torch, sm_clock_hz, timed):
    """``mamba_scan`` against its plain version in fp32, |err| <= 1e-4 +
    1e-4 |ref| (the sums run in another order); B and C are strided views
    of one projection output, as the model hands them over. Each row gives
    the path the entry took, the wrapper's, the C entry's and the kernel's
    device time, the plain version's, and the bound: the larger of the
    bytes over the memory rate and the B*S*D*N exponentials over the
    special-function units' rate at the card's maximum SM clock. Returns
    the row at the ``timed`` (B, S, D, N)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import (mamba_scan, mamba_scan_ref,
                                                path_for)
    gen = torch.Generator(device="cuda").manual_seed(2024)
    sfu_per_s = SFU_PER_SM_CLOCK * SMS * sm_clock_hz
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, out = [], None
    for B, S, D, N in (SSM_REF_ROWS, SSM_TF_ROWS, (1, SEQ_LEN_MAX, 8192, 16),
                       (2, 79, 8192, 16), (3, 130, 96, 8)):
        ins = _mamba_inputs(torch, gen, B, S, D, N)
        entry = _mamba_entry(torch, B, S, D, N)
        _build.check("mamba_scan", entry(*ins))
        row = dict(kernel="mamba_scan", dtype="float32", B=B, S=S, D=D, N=N,
                   path=_scan_path("mamba_scan", path_for(B, S, D, n_sm),
                                   B, S, D, n_sm),
                   max_abs_err=_check("mamba_scan", "float32", (B, S, D, N),
                                      mamba_scan(*ins),
                                      mamba_scan_ref(*ins)))
        sets = _copies(torch, ins)
        row.update(_scan_times(torch, mamba_scan, entry, sets, "mamba_scan",
                               _scan_iters(B, S)))
        row.update(plain_ms=_time_ms(torch, mamba_scan_ref, sets, 2),
                   library_ms=None,
                   **_mamba_bound(B, S, D, N, sfu_per_s))
        rows.append(row)
        if (B, S, D, N) == timed:
            out = row
        del ins, sets, entry
    for row in rows:
        print("kernel_vs_plain", json.dumps(row))
    torch.cuda.empty_cache()
    return out


def _check_rows(cfg, rows):
    for r in rows:
        lp = r["logprobs"][r["prompt_len"]:]
        if not (r["tokens"] < cfg.vocab_size).all() or \
                not all(math.isfinite(x) and x <= 0.0 for x in lp):
            raise AssertionError(f"{cfg.name}: bad tokens or logprobs")


def _fixed_run32(torch, params, prompts, max_new):
    """``run32`` for ``_teacher_forced``: the fixed engine's decode loop in
    fp32 over an fp32 cache (the hybrid's attention layers keep one; the
    engine keeps bf16, as the reference's). The prompts, cut to one
    length, are fed step by step, then ``max_new`` tokens are sampled as
    the engine samples them."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.rl.sampling import categorical, fold_seed
    plen = min(len(p) for p in prompts)
    toks = torch.tensor([list(p[:plen]) for p in prompts], device="cuda",
                        dtype=torch.long)
    B, total = len(prompts), plen + max_new

    def run32(cfg32):
        cache = init_cache(cfg32, B, total, torch.float32)
        out, lps = [toks[:, 0]], [torch.zeros(B, device="cuda")]
        with torch.no_grad():
            for t in range(total - 1):
                logits, cache = decode_step(
                    params, cfg32, cache, out[-1],
                    torch.full((B,), t, device="cuda"))
                logits = logits.float() / TEMPERATURE
                nxt = toks[:, t + 1] if t + 1 < plen else categorical(
                    logits, [fold_seed(SEED, i, t + 1) for i in range(B)])
                out.append(nxt)
                lps.append(torch.log_softmax(logits, dim=-1).gather(
                    1, nxt[:, None])[:, 0])
        tokens = torch.stack(out, 1).cpu().numpy()
        logprobs = torch.stack(lps, 1).cpu().numpy()
        return [(tokens[i], logprobs[i], plen) for i in range(B)]
    return run32


def phase_fixed_serving(torch, cfg, smi, kernels, idle=()):
    """A full-width model served through the fixed engine (4 requests of at
    most FIXED_PROMPT_MAX prompt tokens, FIXED_NEW new tokens each), then
    the teacher-forced check (its full forwards run the scan kernels and,
    for the hybrid, ``flash_attention``) and a trace of a short serving
    run. A moe model's check runs on the same weights with every token
    routed to every expert, where no pick can drop; before it, the routing
    of a short run and the served decode's distance from a forward over
    its tokens are printed. Returns the launches of ``kernels`` over
    serving and the check, each of which must have run, and of ``idle``
    (MLA: the attention kernels), none of which may have run."""
    import numpy as np

    from repro_torch.models import (count_params, decode_step, init_cache,
                                    init_params)
    from repro_torch.rl import generate
    t0 = time.monotonic()
    params = init_params(SEED, cfg)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
          f"attention={cfg.attention} vocab={cfg.vocab_size} "
          f"params={count_params(params)} ({cfg.param_dtype}, compute "
          f"{cfg.compute_dtype}) init {time.monotonic() - t0:.3f}s")
    # two short task prompts and two byte prompts cut to FIXED_PROMPT_MAX
    prompts = [p[:FIXED_PROMPT_MAX] for p in make_prompts(SEED)[6:10]]
    counters = _counters(*kernels, *idle)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    rows = generate(params, cfg, prompts, SEED, max_new_tokens=FIXED_NEW,
                    temperature=TEMPERATURE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_new = sum(len(r["response_ids"]) for r in rows)
    _check_rows(cfg, rows)
    # one decode step over the 4 requests, timed alone
    cache = init_cache(cfg, len(prompts), FIXED_PROMPT_MAX + FIXED_NEW)
    tok = torch.full((len(prompts),), 3, device="cuda")
    steps = []
    with torch.no_grad():
        for i in range(13):
            torch.cuda.synchronize()
            t1 = time.monotonic()
            decode_step(params, cfg, cache, tok, torch.full_like(tok, i))
            torch.cuda.synchronize()
            steps.append(time.monotonic() - t1)
    print(json.dumps({
        "phase": "fixed_engine_serving", "model": cfg.name, "card": smi,
        "layers": cfg.num_layers, "requests": len(rows),
        "prompt_tokens": [r["prompt_len"] for r in rows],
        "decode_steps": len(rows[0]["tokens"]) - 1, "new_tokens": n_new,
        "wall_s": wall, "tokens_per_s": n_new / wall,
        "decode_step_s_p50": float(np.median(steps[3:])),
        "decode_step_s": steps[3:], "peak_mem_gb": peak}))
    del cache

    tf_cfg, extra = cfg, None
    if cfg.arch_type == "moe":
        tf_cfg = dataclasses.replace(cfg, top_k=cfg.num_experts)
        extra = {"top_k": tf_cfg.top_k}
        _fixed_moe_routing(torch, params, cfg, rows, prompts, smi)
        rows = generate(params, tf_cfg, prompts, SEED,
                        max_new_tokens=FIXED_NEW, temperature=TEMPERATURE)
    _teacher_forced(torch, params, tf_cfg, _rows_seqs(rows),
                    _fixed_run32(torch, params, prompts[:2], 8), extra=extra)
    launches = {n: c.launches for n, c in counters.items()}
    print(json.dumps({"phase": "fixed_serving_launches", "model": cfg.name,
                      **launches}))
    _expect_launches(f"{cfg.name} serving and the teacher-forced check",
                     launches, kernels, idle)
    _traced(torch, lambda: generate(
        params, cfg, [p[:16] for p in prompts], SEED, max_new_tokens=4,
        temperature=TEMPERATURE), f"profile_fixed_serving {cfg.name}")
    del params
    torch.cuda.empty_cache()
    return launches


def _fixed_moe_routing(torch, params, cfg, rows, prompts, smi):
    """The moe routing of fixed-engine serving: the dropped share of the
    picks over a short run (every call a decode call of one token a row)
    and over forwards of two served sequences, and the served decode's
    distance from those forwards, printed only (a 4-token decode call and
    a forward keep other picks)."""
    from repro_torch.rl import generate
    seqs = _rows_seqs(rows[:2])
    dist = {}

    def run():
        generate(params, cfg, [p[:16] for p in prompts], SEED,
                 max_new_tokens=4, temperature=TEMPERATURE)
        dist["d"] = _max_diff(_recorded(torch, seqs),
                              _forward_logprobs(torch, params, cfg, seqs))
    drops = _moe_drops(torch, run)
    if not (drops["decode"]["calls"] and drops["prefill"]["calls"]):
        raise AssertionError(f"the moe layers never ran: {drops}")
    print(json.dumps({
        "phase": "moe_serving", "model": cfg.name, "layers": cfg.num_layers,
        "card": smi, "engine": "fixed", "routing": drops,
        f"top{cfg.top_k}_decode_vs_bf16_forward_max_abs_logprob_diff":
            dist["d"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))


def phase_rglru_scan(torch, timed):
    """``rglru_scan`` against its plain version in fp32, |err| <= 1e-4 +
    1e-4 |ref|, on inputs in the model's ranges (``_rglru_inputs``). Each
    row gives the path the entry took, the wrapper's, the C entry's and
    the kernel's device time, the plain version's and the byte bound.
    Returns the row at the ``timed`` (B, S, W)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import (path_for, rglru_scan,
                                                rglru_scan_ref)
    gen = torch.Generator(device="cuda").manual_seed(2025)
    rows, out = [], None
    for B, S, W in (HYB_REF_ROWS, HYB_TF_ROWS, (1, SEQ_LEN_MAX, 4096),
                    (3, 77, 1000), (2, 33, 4099)):
        ins = _rglru_inputs(torch, gen, B, S, W)
        entry = _rglru_entry(torch, B, S, W)
        _build.check("rglru_scan", entry(*ins))
        row = dict(kernel="rglru_scan", dtype="float32", B=B, S=S, W=W,
                   path=_scan_path("rglru_scan", path_for(S), S),
                   max_abs_err=_check("rglru_scan", "float32", (B, S, W),
                                      rglru_scan(*ins),
                                      rglru_scan_ref(*ins)))
        sets = _copies(torch, ins)
        row.update(_scan_times(torch, rglru_scan, entry, sets, "rglru_scan",
                               _scan_iters(B, S)))
        row.update(plain_ms=_time_ms(torch, rglru_scan_ref, sets, 2),
                   library_ms=None, **_rglru_bound(B, S, W))
        rows.append(row)
        if (B, S, W) == timed:
            out = row
        del ins, sets, entry
    for row in rows:
        print("kernel_vs_plain", json.dumps(row))
    torch.cuda.empty_cache()
    return out


def phase_hybrid_attention(torch, cfg):
    """The attention kernels at RecurrentGemma-9B's shapes (16 query heads,
    1 KV head, hd 256), bf16 and fp32. ``flash_attention`` over 4096
    tokens with its 2048-key window, and at the 4 x 80 tokens of the
    trainer's reference inference, with that window and with the ring
    check's RING_WINDOW. ``decode_attention`` over a 2048-key ring, over
    the FIXED_PROMPT_MAX + FIXED_NEW keys the 38-layer serving decodes
    over, and over the ring check's RING_WINDOW keys; each full and
    partly filled."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4242)
    H, KVH, hd, win = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.local_window
    B, S = HYB_REF_ROWS[:2]
    for dtype in ("bfloat16", "float32"):
        for fb, fs, fw in ((1, 2 * win, win), (B, S, win),
                           (B, S, RING_WINDOW)):
            print("kernel_vs_plain", json.dumps(_flash_row(
                torch, gen, dtype, fb, fs, H, KVH, hd, fw)))
        for ring in (win, FIXED_PROMPT_MAX + FIXED_NEW, RING_WINDOW):
            for fill in (torch.full((NUM_SLOTS,), ring, device=dev),
                         torch.randint(1, ring + 1, (NUM_SLOTS,),
                                       generator=gen, device=dev)):
                print("kernel_vs_plain", json.dumps(_decode_row(
                    torch, gen, dtype, NUM_SLOTS, ring, H, KVH, hd, fill)))
    torch.cuda.empty_cache()


def phase_stablelm_attention(torch):
    """Both attention kernels at StableLM-2-12B's 32 query heads, 8 KV
    heads and hd 160 (bf16 flash runs it at 192), bf16 and fp32, at the
    trainer-sized shapes: flash over 4 x 80 tokens, decode over the
    FIXED_PROMPT_MAX + FIXED_NEW keys of a short request, full and partly
    filled."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(160)
    H, KVH, hd = STABLELM_HEADS
    ring = FIXED_PROMPT_MAX + FIXED_NEW
    for dtype in ("bfloat16", "float32"):
        print("kernel_vs_plain", json.dumps(_flash_row(
            torch, gen, dtype, NUM_SLOTS, 80, H, KVH, hd, 0)))
        for fill in (torch.full((NUM_SLOTS,), ring, device=dev),
                     torch.randint(1, ring + 1, (NUM_SLOTS,), generator=gen,
                                   device=dev)):
            print("kernel_vs_plain", json.dumps(_decode_row(
                torch, gen, dtype, NUM_SLOTS, ring, H, KVH, hd, fill)))
    torch.cuda.empty_cache()


def phase_stablelm_serving(torch, smi):
    """Full-width StableLM-2-12B (hd 160; STABLELM_LAYERS layers, random
    weights from a seed) served through the continuous engine as Qwen2.5
    is in phase 3, then the teacher-forced rules as in phase 5 and a
    trace as in phase 6; the weights are freed."""
    from repro_torch.configs import get_config
    from repro_torch.core.obs import MetricsRegistry
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.models import count_params, init_params
    _release(torch)
    print(f"resident before StableLM-2-12B: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    cfg = dataclasses.replace(get_config("stablelm_12b"),
                              num_layers=STABLELM_LAYERS)
    prompts = make_prompts(SEED)
    reg = MetricsRegistry()
    eng = ContinuousBatchingEngine(
        cfg, num_slots=NUM_SLOTS, max_len=max(len(p) for p in prompts)
        + MAX_NEW, max_new_tokens=MAX_NEW, temperature=TEMPERATURE,
        seed=SEED, metrics=reg)
    t0 = time.monotonic()
    params = init_params(SEED, cfg)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers d={cfg.d_model} heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"vocab={cfg.vocab_size} params={count_params(params)} "
          f"({cfg.param_dtype}, compute {cfg.compute_dtype}) "
          f"init {time.monotonic() - t0:.3f}s")
    done, _ = serve_continuous(torch, cfg, eng, params, prompts, reg, smi)
    continuous_teacher_forced(torch, params, cfg, done, prompts,
                              eng.max_len)
    profile_serving(torch, params, cfg, prompts, eng.max_len)
    del params, eng, done
    _release(torch)


def phase_ring_check(torch, cfg):
    """The hybrid at full width cut to HYB_TRAIN_LAYERS layers with a
    RING_WINDOW-key window: 4 requests of FIXED_PROMPT_MAX prompt tokens
    and FIXED_NEW new ones through the fixed engine, so the decode ring
    wraps, then the teacher-forced rules, whose full forwards cross the
    flash kernel's window band."""
    from repro_torch.models import init_params
    from repro_torch.rl import generate
    params = init_params(SEED, cfg)
    prompts = [p[:FIXED_PROMPT_MAX] for p in make_prompts(SEED)[8:12]]
    rows = generate(params, cfg, prompts, SEED, max_new_tokens=FIXED_NEW,
                    temperature=TEMPERATURE)
    _check_rows(cfg, rows)
    lens = [len(r["tokens"]) for r in rows]
    if min(lens) <= cfg.local_window:
        raise AssertionError(f"the ring did not wrap: {lens} tokens")
    print(json.dumps({"phase": "ring_check", "model": cfg.name,
                      "layers": cfg.num_layers,
                      "local_window": cfg.local_window, "tokens": lens}))
    _teacher_forced(torch, params, cfg, _rows_seqs(rows),
                    _fixed_run32(torch, params, prompts[:2], FIXED_NEW))
    del params
    torch.cuda.empty_cache()


def _moe_drops(torch, fn):
    """Run ``fn()`` with each ``moe_ffn`` call's router statistics
    (``moe_router_stats`` on the call's own input) recorded: the share of
    picks past capacity in the decode calls (one token a slot) and in the
    prefill calls, and the last decode call's per-expert picks."""
    from repro_torch.models import moe
    inner = moe.moe_ffn
    seen = {"decode": [], "prefill": []}

    def spy(p, x, cfg, **kw):
        st = moe.moe_router_stats(p, x, cfg)
        seen["decode" if x.shape[1] == 1 else "prefill"].append(st)
        return inner(p, x, cfg, **kw)
    moe.moe_ffn = spy
    try:
        fn()
    finally:
        moe.moe_ffn = inner
    out = {}
    for kind, stats in seen.items():
        fr = [float(st.dropped_fraction) for st in stats]
        out[kind] = {"calls": len(fr),
                     "dropped_fraction_mean": sum(fr) / max(len(fr), 1),
                     "dropped_fraction_max": max(fr, default=0.0)}
    if seen["decode"]:
        out["decode"]["last_call_picks_per_expert"] = \
            seen["decode"][-1].tokens_per_expert.tolist()
    return out


def phase_grok_serving(torch, smi):
    """Full-width Grok-1 (GROK_LAYERS layers, 8 GELU experts of 32,768,
    top 2, random weights from a seed) served through the continuous
    engine as Qwen2.5 is in phase 3. Then the routing of a short run (the
    dropped share of the picks at decode, where C = 1 with 4 slots, and at
    prefill); the top-2 decode's distance from a forward over its own
    tokens, printed only (a decode call routes 4 tokens and a forward a
    whole sequence, so capacity drops other picks); and the teacher-forced
    rules as in phase 5 on the same weights routed to all 8 experts,
    where no pick can drop. Returns the serving run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.obs import MetricsRegistry
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.models import count_params, init_params
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("grok_1_314b"),
                              num_layers=GROK_LAYERS)
    prompts = make_prompts(SEED)
    max_len = max(len(p) for p in prompts) + MAX_NEW

    def engine(c, slots, new, dtype=None, reg=None):
        return ContinuousBatchingEngine(
            c, num_slots=slots, max_len=max_len, max_new_tokens=new,
            temperature=TEMPERATURE, seed=SEED, dtype=dtype,
            metrics=reg or MetricsRegistry())
    reg = MetricsRegistry()
    eng = engine(cfg, NUM_SLOTS, MAX_NEW, reg=reg)
    t0 = time.monotonic()
    params = init_params(SEED, cfg)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers d={cfg.d_model} heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} experts "
          f"{cfg.num_experts} top {cfg.top_k} d_ff {cfg.moe_d_ff} "
          f"vocab={cfg.vocab_size} params={count_params(params)} "
          f"({cfg.param_dtype}, compute {cfg.compute_dtype}) "
          f"init {time.monotonic() - t0:.3f}s")
    done, launches = serve_continuous(torch, cfg, eng, params, prompts, reg,
                                      smi)
    short = engine(cfg, NUM_SLOTS, 9)
    drops = _moe_drops(torch, lambda: short.generate(
        params, [short.make_sequence(p) for p in prompts[8:12]]))
    by_uid = sorted(done, key=lambda q: q.uid)
    seqs = _cb_seqs([by_uid[0], by_uid[-1]])
    top2 = _max_diff(_recorded(torch, seqs),
                     _forward_logprobs(torch, params, cfg, seqs))
    every = dataclasses.replace(cfg, top_k=cfg.num_experts)

    def run(c, dtype=None):
        e = engine(c, 2, 16, dtype)
        fin, _ = e.generate(params, [e.make_sequence(prompts[0]),
                                     e.make_sequence(prompts[9])])
        return _cb_seqs(fin)
    _teacher_forced(torch, params, every, run(every),
                    lambda c32: run(c32, torch.float32),
                    extra={"top_k": every.top_k})
    if not (drops["decode"]["calls"] and drops["prefill"]["calls"]):
        raise AssertionError(f"the moe layers never ran: {drops}")
    print(json.dumps({
        "phase": "moe_serving", "model": cfg.name, "layers": cfg.num_layers,
        "card": smi, "routing": drops,
        "top2_decode_vs_bf16_forward_max_abs_logprob_diff": top2,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    del params, eng, done, short
    _release(torch)
    return launches


def _vlm_decode(torch, params, cfg, prompts, vis, new, cache_dtype):
    """The vlm's serving path: one prefill over each request's vision
    prefix and prompt (right-padded; flash kernel), then ``new`` decode
    steps (decode kernel) at positions T + len(prompt) + t over a cache of
    T + the longest prompt + ``new`` rows, sampled as the engines sample.
    Returns [(text tokens, their logprobs, prompt length)]."""
    import numpy as np

    from repro_torch.models import decode_step, forward, init_cache
    from repro_torch.rl.sampling import categorical, fold_seed
    B, T = len(prompts), cfg.vision_tokens
    lens = [len(p) for p in prompts]
    P = max(lens)
    toks = torch.zeros((B, P), dtype=torch.long, device="cuda")
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.as_tensor(np.asarray(p), device="cuda")
    rows = torch.arange(B, device="cuda")
    out = [list(map(int, p)) for p in prompts]
    lps = [[0.0] * n for n in lens]
    with torch.no_grad():
        logits, _, pre = forward(params, cfg, {"tokens": toks,
                                               "vision_embeds": vis},
                                 return_cache=True)
        last = logits[rows, torch.as_tensor(lens, device="cuda") + T - 1]
        del logits
        cache = init_cache(cfg, B, T + P + new, cache_dtype)
        for kv in ("k", "v"):
            cache[kv][:, :, :T + P] = pre["kv"][kv]
        del pre
        for t in range(new):
            lt = last.float() / TEMPERATURE
            nxt = categorical(lt, [fold_seed(SEED, i, lens[i] + t)
                                   for i in range(B)])
            lp = torch.log_softmax(lt, dim=-1).gather(1, nxt[:, None])[:, 0]
            for i, (a, b) in enumerate(zip(nxt.tolist(), lp.tolist())):
                out[i].append(a)
                lps[i].append(b)
            if t + 1 < new:
                pos = torch.as_tensor([T + n + t for n in lens],
                                      device="cuda")
                last, cache = decode_step(params, cfg, cache, nxt, pos)
    return [(np.asarray(o), np.asarray(lp, np.float32), n)
            for o, lp, n in zip(out, lps, lens)]


def phase_vlm_serving(torch, smi):
    """Full-width InternVL2-26B (VLM_LAYERS layers, random weights from a
    seed): VLM_REQUESTS requests, each 1024 seeded patch embeddings and
    one of the first prompts, prefilled together through the flash kernel
    (GQA group 6, hd 128) and decoded VLM_NEW steps through the decode
    kernel at the offset positions; then the teacher-forced rules, whose
    forwards run over vision, prompt and the decoded tokens. Returns the
    serving run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import count_params, init_params
    _release(torch)
    cfg = dataclasses.replace(get_config("internvl2_26b"),
                              num_layers=VLM_LAYERS)
    prompts = make_prompts(SEED)[:VLM_REQUESTS]
    t0 = time.monotonic()
    params = init_params(SEED, cfg)
    vis = _vision(torch, cfg, VLM_REQUESTS)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers d={cfg.d_model} heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"vision tokens {cfg.vision_tokens} vocab={cfg.vocab_size} "
          f"params={count_params(params)} ({cfg.param_dtype}, compute "
          f"{cfg.compute_dtype}) init {time.monotonic() - t0:.3f}s")
    decode_attention.launches = flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    seqs = _vlm_decode(torch, params, cfg, prompts, vis, VLM_NEW,
                       torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    for toks, lps, plen in seqs:
        if max(toks) >= cfg.vocab_size or min(toks) < 0 or not all(
                math.isfinite(x) and x <= 0.0 for x in lps[plen:]):
            raise AssertionError(f"{cfg.name}: bad tokens or logprobs")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    n_new = VLM_REQUESTS * VLM_NEW
    print(json.dumps({
        "phase": "vlm_serving", "model": cfg.name, "layers": cfg.num_layers,
        "requests": VLM_REQUESTS, "vision_tokens": cfg.vision_tokens,
        "prompt_tokens": [len(p) for p in prompts], "new_tokens": n_new,
        "wall_s": wall, "tokens_per_s": n_new / wall, "card": smi,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    _teacher_forced(
        torch, params, cfg, seqs,
        lambda c32: _vlm_decode(torch, params, c32, prompts[:2], vis[:2],
                                VLM_NEW, torch.float32), vision=vis)
    del params, vis
    _release(torch)
    return launches


def _whisper_decode(torch, params, cfg, frames, tokens, new, cache_dtype):
    """The audio family's serving path through the model facade: encode
    ``frames``, fill the cross cache, decode ``tokens`` (B, T)
    teacher-forced from position 0, then ``new`` greedy tokens. Returns
    (the sequences as (tokens, logprobs at TEMPERATURE, prompt length 1),
    the greedy steps' seconds)."""
    from repro_torch.models import decode_step, encdec, init_cache
    B, T = tokens.shape
    toks, lps, steps = [tokens[:, 0]], [torch.zeros(B, device="cuda")], []
    with torch.no_grad():
        cache = init_cache(cfg, B, T + new, dtype=cache_dtype)
        encdec.precompute_cross_kv(params, cfg,
                                   encdec.encode(params, cfg, frames), cache)
        for t in range(T + new - 1):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            logits, cache = decode_step(params, cfg, cache, toks[-1],
                                        torch.full((B,), t, device="cuda"))
            nxt = tokens[:, t + 1] if t + 1 < T else logits.argmax(-1)
            logp = torch.log_softmax(logits.float() / TEMPERATURE, dim=-1)
            lps.append(logp.gather(1, nxt[:, None])[:, 0])
            toks.append(nxt)
            torch.cuda.synchronize()
            if t + 1 >= T:
                steps.append(time.monotonic() - t0)
    toks = torch.stack(toks, 1).tolist()
    lps = torch.stack(lps, 1).tolist()
    return [(toks[i], lps[i], 1) for i in range(B)], steps


def phase_whisper_serving(torch, smi):
    """Whisper-tiny at full width (4 + 4 layers, 6/6 heads at hd 64, vocab
    51,865), random weights from a seed, bf16 compute: first
    ``flash_attention`` and ``decode_attention`` against their plain
    versions at its group-1 shapes (flash over the decoder's 64 tokens,
    decode over a ragged self cache and the 1500-key cross cache); then,
    counting both kernels from 0, WHISPER_REQUESTS requests of seeded
    frames served through the model facade (encode, cross cache,
    WHISPER_TF tokens teacher-forced from position 0, WHISPER_NEW greedy
    ones), the greedy steps timed, and the teacher-forced rules against a
    forward over the same tokens on the kernel route (flash). Returns the
    launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_params
    cfg = get_config("whisper_tiny")
    H, KVH, hd = WHISPER_HEADS
    if (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) != WHISPER_HEADS:
        raise AssertionError(f"whisper_tiny heads changed: {cfg}")
    B, T, S = WHISPER_REQUESTS, WHISPER_TF, WHISPER_TF + WHISPER_NEW
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 35)
    rows = []
    for dtype in ("bfloat16", "float32"):
        rows.append(_flash_row(torch, gen, dtype, B, T, H, KVH, hd, 0))
        for keys, fill in ((S, [1, 40, 90, S]),
                           (cfg.encoder_frames, [cfg.encoder_frames] * B)):
            rows.append(_decode_row(torch, gen, dtype, B, keys, H, KVH, hd,
                                    torch.tensor(fill, device=dev)))
    for row in rows:
        print("kernel_vs_plain", json.dumps(row))

    t0 = time.monotonic()
    params = init_params(SEED, cfg)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.encoder_layers}+{cfg.num_layers} layers "
          f"d={cfg.d_model} vocab={cfg.vocab_size} "
          f"params={count_params(params)} ({cfg.param_dtype}, compute "
          f"{cfg.compute_dtype}) init {time.monotonic() - t0:.3f}s")
    frames = _frames(torch, cfg, B)
    tokens = torch.randint(3, cfg.vocab_size, (B, T), device=dev,
                           generator=gen)
    counters = _counters(*ATTENTION_KERNELS)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    seqs, steps = _whisper_decode(torch, params, cfg, frames, tokens,
                                  WHISPER_NEW, torch.bfloat16)
    wall = time.monotonic() - t0
    decode_launches = counters["decode_attention"].launches
    if decode_launches != 2 * cfg.num_layers * (S - 1):
        raise AssertionError(f"whisper decode: {decode_launches} "
                             "decode_attention launches, not 2 a layer a "
                             "step")
    print(json.dumps({
        "phase": "whisper_serving", "model": cfg.name, "card": smi,
        "requests": B, "frames": cfg.encoder_frames,
        "teacher_forced_tokens": T, "new_tokens": B * WHISPER_NEW,
        "wall_s": wall, "greedy_tokens_per_s": B * WHISPER_NEW / sum(steps),
        "decode_step_s_p50": float(np.median(steps)),
        "decode_attention_launches": decode_launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))

    def run32(cfg32):
        return _whisper_decode(torch, params, cfg32, frames, tokens,
                               WHISPER_NEW, torch.float32)[0]
    _teacher_forced(torch, params, cfg, seqs, run32, frames=frames)
    launches = {n: c.launches for n, c in counters.items()}
    print(json.dumps({"phase": "whisper_serving_launches", **launches}))
    _expect_launches("whisper serving and the teacher-forced check",
                     launches, ATTENTION_KERNELS)
    del params
    _release(torch)
    return launches


def phase_mesh_serving(torch, smi, mesh, prompts, max_len, fill, qwen):
    """The mesh route on the card's 1 x 1 mesh (a one-rank NCCL group):
    ``sharded_decode_attention`` at the Qwen decode shape (B=4, S=max_len,
    28/4 heads, hd 128, ``fill`` valid keys a row) against
    ``decode_attention``'s plain version in bf16 and fp32, timed beside
    the kernel; then full-width Qwen2.5-7B (all 28 layers) served through
    the continuous engine with ``mesh=`` (MESH_REQUESTS of the phase-3
    prompts, MAX_NEW new tokens): every request answered once, no page
    leaked, no ``decode_attention`` launch, and the teacher-forced rules
    (the fp32 run on the mesh route too). ``qwen`` is phase 3's line,
    printed beside. Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.obs import MetricsRegistry
    from repro_torch.distributed import sharded_decode_attention
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.models import init_params
    H, KVH, hd = QWEN_HEADS
    B, S, dev = len(fill), max_len, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 37)
    valid = torch.arange(S, device=dev)[None, :] < torch.tensor(
        fill, device=dev)[:, None]
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((B, 1, H, hd), (B, S, KVH, hd),
                                 (B, S, KVH, hd)))
        n = decode_attention.launches
        out = sharded_decode_attention(q, k, v, valid, mesh=mesh)
        if decode_attention.launches != n:
            raise AssertionError("the mesh route launched decode_attention")
        err = _check("sharded_decode_attention", dtype, (B, S, H, KVH, hd),
                     out, decode_attention_ref(q, k, v, valid))
        sets = _copies(torch, (q, k, v, valid))
        print("sharded_decode_vs_plain", json.dumps({
            "dtype": dtype, "B": B, "S": S, "H": H, "KVH": KVH, "hd": hd,
            "valid_keys": int(valid.sum()), "keys": B * S,
            "max_abs_err": err, "card": smi,
            "ms": _time_ms(torch, lambda q, k, v, m: sharded_decode_attention(
                q, k, v, m, mesh=mesh), sets, 20),
            "decode_attention_ms": _time_ms(torch, decode_attention, sets,
                                            50),
            "plain_ms": _time_ms(torch, decode_attention_ref, sets, 10)}))
        del q, k, v, sets

    cfg = get_config("qwen2_5_7b")
    params = init_params(SEED, cfg)
    reg = MetricsRegistry()
    eng = ContinuousBatchingEngine(
        cfg, num_slots=NUM_SLOTS, max_len=max_len, max_new_tokens=MAX_NEW,
        temperature=TEMPERATURE, seed=SEED, metrics=reg, mesh=mesh)
    line = {}
    done, launches = serve_continuous(
        torch, cfg, eng, params, prompts[:MESH_REQUESTS], reg, smi,
        idle=("decode_attention",), phase="continuous_engine_mesh",
        report=line)

    def run32(cfg32):
        eng32 = ContinuousBatchingEngine(
            cfg32, num_slots=2, max_len=max_len, max_new_tokens=8,
            temperature=TEMPERATURE, seed=SEED, dtype=torch.float32,
            metrics=MetricsRegistry(), mesh=mesh)
        done32, _ = eng32.generate(params, [eng32.make_sequence(p)
                                            for p in prompts[:2]])
        return _cb_seqs(done32)
    _teacher_forced(torch, params, cfg, _cb_seqs(done), run32,
                    extra={"mesh": list(mesh.shape)})
    if decode_attention.launches:
        raise AssertionError("the mesh route's teacher-forced runs launched "
                             "decode_attention")
    print(json.dumps({
        "phase": "mesh_serving", "card": smi, "mesh": list(mesh.shape),
        "requests": line["requests"], "tokens_per_s": line["tokens_per_s"],
        "decode_step_s_p50": line["decode_step_s_p50"],
        "phase3": {k: qwen[k] for k in ("requests", "tokens_per_s",
                                        "decode_step_s_p50")}}))
    del params, eng, done
    _release(torch)
    return launches


def phase_ep_moe(torch, smi, mesh):
    """``ep_moe_ffn`` on the 1 x 1 mesh at one DeepSeek-V2 moe layer at
    full width (d 5120, 160 SwiGLU experts of 1536, top 6, 2 shared;
    random weights from a seed, fp32 activations, as the reference's
    check runs it): EP_TOKENS tokens at capacity factor EP_CAPACITY
    against ``moe_ffn`` at a capacity that drops nothing (C = N), within
    the fp32 bar of the output's scale, which must exceed 0.5."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import ep_moe_ffn
    from repro_torch.models.moe import init_moe, moe_ffn, moe_router_stats
    cfg = dataclasses.replace(get_config("deepseek_v2_236b"),
                              compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 38)
    torch.cuda.reset_peak_memory_stats()
    p = init_moe(gen, cfg)
    x = torch.randn((*EP_TOKENS, cfg.d_model), generator=gen,
                    device="cuda")
    drop_free = cfg.num_experts / cfg.top_k       # C = N
    with torch.no_grad():
        dropped = float(moe_router_stats(p, x, cfg,
                                         drop_free).dropped_fraction)
        times = {}
        for name, fn in (
                ("ep_ms", lambda: ep_moe_ffn(p, x, cfg, mesh=mesh,
                                             capacity_factor=EP_CAPACITY)),
                ("moe_ffn_ms", lambda: moe_ffn(p, x, cfg,
                                               capacity_factor=drop_free)[0])):
            fn()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            y = fn()
            torch.cuda.synchronize()
            times[name] = (time.monotonic() - t0) * 1e3
            if name == "ep_ms":
                y_ep = y
    scale = float(y.abs().max())
    err = float((y_ep - y).abs().max())
    print(json.dumps({
        "phase": "ep_moe", "card": smi, "mesh": list(mesh.shape),
        "tokens": EP_TOKENS[0] * EP_TOKENS[1], "experts": cfg.num_experts,
        "top_k": cfg.top_k, "shared": cfg.num_shared_experts,
        "capacity_factor": EP_CAPACITY, "reference_dropped": dropped,
        "max_abs_err": err, "scale": scale, **times,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    if dropped != 0.0 or not scale > 0.5 or not err <= TOL["float32"] * scale:
        raise AssertionError(f"ep_moe_ffn vs moe_ffn: err {err}, scale "
                             f"{scale}, dropped {dropped}")
    del p, x, y, y_ep
    _release(torch)


def _tree_equal(torch, a, b):
    """Two trees' tensors (DTensors read as their local shards, a 1 x 1
    mesh's whole tensors) equal bit for bit, leaf by leaf in key order."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x = x.to_local() if isinstance(x, DTensor) else x
        y = y.to_local() if isinstance(y, DTensor) else y
        if x.dtype != y.dtype or not torch.equal(x, y):
            return False
    return True


def phase_launch_steps(torch, smi, mesh):
    """The launch steps (``launch/steps.py``) on the card (phase 39), on
    full-width Qwen2.5-7B: prefill (28 layers, STEP_PREFILL), serve (28
    layers, one decode step over a cache of STEP_SERVE keys) and the
    GRPO train step (TRAIN_LAYERS layers, STEP_TRAIN rows, AdamW). For
    each: (b) its outputs equal the model-facade call it wraps, bit for
    bit; (c) the same step on DTensors placed by the sharding rules on the
    card's 1 x 1 mesh gives the same bits; (d) each run launches 28
    ``flash_attention`` (prefill), 28 ``decode_attention`` (serve) or one
    of each loss kernel (train) and nothing else; (e) the dry run's
    account of the same dims on the 1 x 1 mesh, from meta structs: its
    argument bytes equal the card tensors' exactly, and its peak is
    printed beside ``max_memory_allocated`` of the plain step. (f) The
    dry-run launcher at full size (``qwen2_5_7b decode_32k single``, 256
    fake ranks) runs in a subprocess meanwhile, its wall printed. Returns
    the launches of the steps' runs (plain and DTensor), the main path's;
    the facade's runs are the comparison."""
    t_phase = time.monotonic()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "qwen2_5_7b", "--shape", "decode_32k", "--mesh", "single"]
    t_sub = time.monotonic()
    sub = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True,
                           env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                                "CUDA_VISIBLE_DEVICES": ""})
    try:
        return _launch_steps(torch, smi, mesh, sub, cmd, t_phase, t_sub)
    finally:
        if sub.poll() is None:
            sub.kill()
            sub.wait()


def _launch_steps(torch, smi, mesh, sub, cmd, t_phase, t_sub):
    """Phase 39's body (``phase_launch_steps``), the launcher's
    subprocess ``sub`` running beside it."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import decode_step, forward, init_cache, \
        init_params
    from repro_torch.rl.grpo import GRPOConfig, grpo_train_step
    from repro_torch.training import OptimizerConfig, TrainState
    names = ("flash_attention", "decode_attention", "grpo_logprob",
             "fused_rl_loss_fwd", "fused_rl_loss_bwd", "mamba_scan",
             "rglru_scan")
    counters = _counters(*names)
    total = {n: 0 for n in names}
    cfg = get_config("qwen2_5_7b")
    rng = np.random.default_rng(SEED + 39)
    dev = torch.device(mesh.device_type)

    def counted(fn, want):
        """Run ``fn`` with the counts at 0; its launches must be ``want``."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        ran = {n: c.launches for n, c in counters.items()}
        if ran != {n: want.get(n, 0) for n in names}:
            raise AssertionError(f"launches {ran}, expected {want}")
        return out, wall, ran

    def account(kind, step, args_meta, card_args):
        """The dry run's account of ``step`` on meta structs placed by the
        rules on ``mesh``; its argument bytes against the card's."""
        _, acc = dryrun.trace(step, args_meta, mesh)
        card = dryrun.local_bytes(card_args)
        if acc["argument_bytes_per_rank"] != card:
            raise AssertionError(f"{kind}: dry-run argument bytes "
                                 f"{acc['argument_bytes_per_rank']} against "
                                 f"the card's {card}")
        return acc, card

    def place(tree, specs):
        return dryrun.place_tree(tree, specs, mesh)

    lines = {}
    # -- prefill and serve at 28 layers --------------------------------------
    params = init_params(SEED, cfg, device=dev)
    p_meta = init_params(SEED, cfg, device="meta")
    p_meta = place(p_meta, sharding.tree_pspecs(p_meta, cfg, mesh))
    B, S = STEP_PREFILL
    batch = {"tokens": torch.from_numpy(
        rng.integers(3, cfg.vocab_size, (B, S))).to(dev)}
    prefill = steps.make_prefill_step(cfg)
    flash = {"flash_attention": cfg.num_layers}
    with torch.no_grad():
        (logits, aux, cache), _, _ = counted(
            lambda: forward(params, cfg, batch, return_cache=True), flash)
    torch.cuda.reset_peak_memory_stats()
    (lp, cp), wall, ran = counted(lambda: prefill(params, batch), flash)
    peak = torch.cuda.max_memory_allocated()
    same = _tree_equal(torch, {"l": lp, "c": cp},
                       {"l": logits[:, -1, :], "c": cache})
    del logits, cache
    pd = place(params, sharding.tree_pspecs(params, cfg, mesh))
    bd = place(batch, sharding.batch_pspecs(batch, cfg, mesh))
    with dryrun.sharded(pd, mesh):
        (ld, cd), wall_d, ran_d = counted(lambda: prefill(pd, bd), flash)
    same_d = _tree_equal(torch, {"l": ld, "c": cd}, {"l": lp, "c": cp})
    del lp, cp, ld, cd
    b_meta = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
    acc, card = account("prefill", prefill, (p_meta, place(
        b_meta, sharding.batch_pspecs(b_meta, cfg, mesh))), (params, batch))
    lines["prefill"] = (wall, wall_d, ran, peak, acc, card, same, same_d)
    for n in names:
        total[n] += ran[n] + ran_d[n]

    B, S = STEP_SERVE
    cache = init_cache(cfg, B, S, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 39)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    token = torch.from_numpy(rng.integers(3, cfg.vocab_size, B)).to(dev)
    pos = torch.tensor([S - 1, S // 2, 7, S // 3], device=dev)
    serve = steps.make_serve_step(cfg)
    dec = {"decode_attention": cfg.num_layers}
    c0 = {k: v.clone() for k, v in cache.items()}
    with torch.no_grad():
        (logits, c0), _, _ = counted(
            lambda: decode_step(params, cfg, c0, token, pos), dec)
    c1 = {k: v.clone() for k, v in cache.items()}
    torch.cuda.reset_peak_memory_stats()
    (l1, c1), wall, ran = counted(lambda: serve(params, c1, token, pos), dec)
    peak = torch.cuda.max_memory_allocated()
    same = _tree_equal(torch, {"l": l1, "c": c1}, {"l": logits, "c": c0})
    c2 = {k: v.clone() for k, v in cache.items()}
    tok_spec = sharding.P(sharding.dp_axes(mesh))
    cd = place(c2, sharding.cache_pspecs(c2, cfg, mesh, batch=B))
    td, posd = (dryrun.place(t, sharding.placements(tok_spec, mesh), mesh)
                for t in (token, pos))
    with dryrun.sharded(pd, mesh):
        (ld, cd), wall_d, ran_d = counted(lambda: serve(pd, cd, td, posd),
                                          dec)
    same_d = _tree_equal(torch, {"l": ld, "c": cd}, {"l": l1, "c": c1})
    del logits, c0, l1, c1, c2, ld, cd
    c_meta = init_cache(cfg, B, S, device="meta")
    tp = sharding.placements(tok_spec, mesh)
    acc, card = account("serve", serve, (
        p_meta, place(c_meta, sharding.cache_pspecs(c_meta, cfg, mesh,
                                                    batch=B)),
        dryrun.place(torch.empty_like(token, device="meta"), tp, mesh),
        dryrun.place(torch.empty_like(pos, device="meta"), tp, mesh)),
        (params, cache, token, pos))
    lines["serve"] = (wall, wall_d, ran, peak, acc, card, same, same_d)
    for n in names:
        total[n] += ran[n] + ran_d[n]
    del params, pd, cache, p_meta
    _release(torch)

    # -- the GRPO train step at TRAIN_LAYERS layers -----------------------------
    cfg2 = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)
    params = init_params(SEED, cfg2, device=dev)
    B, S = STEP_TRAIN
    mask = np.zeros((B, S), np.float32)
    mask[:, 16:] = 1.0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {
        "tokens": rng.integers(3, cfg.vocab_size, (B, S)),
        "response_mask": mask,
        "old_logprob": (-12.0 + 0.3 * rng.standard_normal((B, S)))
        .astype(np.float32),
        "advantage": rng.standard_normal(B).astype(np.float32)}.items()}
    loss = {"fused_rl_loss_fwd": 1, "fused_rl_loss_bwd": 1}
    (ref, m_ref), _, _ = counted(lambda: grpo_train_step(
        TrainState.create(params), cfg2, GRPOConfig(), OptimizerConfig(),
        batch), loss)
    ref = ref.params
    train = steps.make_train_step(cfg2)
    state = TrainState.create(params)
    torch.cuda.reset_peak_memory_stats()
    (new, m), wall, ran = counted(lambda: train(state, batch), loss)
    peak = torch.cuda.max_memory_allocated()
    same = _tree_equal(torch, {"p": new.params, "m": m},
                       {"p": ref, "m": m_ref})
    del new, m, state
    _release(torch)
    state = TrainState.create(params)
    sd = place(state, sharding.state_pspecs(state, cfg2, mesh))
    bd = place(batch, sharding.batch_pspecs(batch, cfg2, mesh))
    with dryrun.sharded(sd.params, mesh):
        (new, m), wall_d, ran_d = counted(lambda: train(sd, bd), loss)
    same_d = _tree_equal(torch, {"p": new.params, "m": m},
                         {"p": ref, "m": m_ref})
    del new, m, sd, ref
    _release(torch)
    st_meta = TrainState.create(init_params(SEED, cfg2, device="meta"))
    b_meta = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
    acc, card = account("train", train, (
        place(st_meta, sharding.state_pspecs(st_meta, cfg2, mesh)),
        place(b_meta, sharding.batch_pspecs(b_meta, cfg2, mesh))),
        (state, batch))
    lines["train"] = (wall, wall_d, ran, peak, acc, card, same, same_d)
    for n in names:
        total[n] += ran[n] + ran_d[n]
    del params, state, batch
    _release(torch)

    out, err = sub.communicate(timeout=DRYRUN_TIMEOUT)
    sub_wall = time.monotonic() - t_sub
    rec = json.loads(out) if sub.returncode == 0 else {}
    for kind, (wall, wall_d, ran, peak, acc, card, same, same_d) in \
            lines.items():
        print(json.dumps({
            "phase": "launch_steps", "step": kind, "card": smi,
            "layers": cfg2.num_layers if kind == "train" else cfg.num_layers,
            "rows_tokens": {"prefill": STEP_PREFILL, "serve": STEP_SERVE,
                            "train": STEP_TRAIN}[kind],
            "wall_s": wall, "dtensor_wall_s": wall_d,
            "launches": {n: k for n, k in ran.items() if k},
            "facade_bits": same, "dtensor_bits": same_d,
            "argument_bytes_per_rank": acc["argument_bytes_per_rank"],
            "card_argument_bytes": card,
            "peak_bytes_per_rank": acc["peak_bytes_per_rank"],
            "max_memory_allocated": peak,
            "peak_ratio": acc["peak_bytes_per_rank"] / peak,
            "dryrun_trace_s": acc["trace_s"],
            "collective_ops": acc["collective_ops"]}))
    print(json.dumps({
        "phase": "dryrun_launcher", "card": smi, "command": cmd[1:],
        "returncode": sub.returncode, "wall_s": sub_wall,
        "status": rec.get("status"), "trace_s": rec.get("trace_s"),
        "collective_bytes_total": rec.get("collective_bytes", {})
        .get("total"),
        "argument_bytes_per_rank": rec.get("argument_bytes_per_rank"),
        "peak_bytes_per_rank": rec.get("peak_bytes_per_rank"),
        "phase_s": time.monotonic() - t_phase}))
    bad = [k for k, v in lines.items() if not (v[6] and v[7])]
    if bad:
        raise AssertionError(f"launch steps {bad}: not bit-identical "
                             "(facade, DTensor): "
                             f"{[(lines[k][6], lines[k][7]) for k in bad]}")
    if sub.returncode != 0 or rec.get("status") != "ok":
        raise AssertionError(f"dry-run launcher: rc {sub.returncode}, "
                             f"{err[-2000:]}")
    return total


def main():
    torch = _import_port()

    from repro_torch.configs import get_config
    from repro_torch.core.obs import MetricsRegistry
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import count_params, init_params
    from repro_torch.rl import generate

    # -- 1. setup ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    _build.build_all()
    print(f"kernel build seconds {_build.build_seconds:.3f}")
    print("flash_build", json.dumps(flash_build_report()))
    print("decode_build", json.dumps(decode_build_report()))
    print("loss_build", json.dumps(loss_build_report()))

    cfg = get_config("qwen2_5_7b")
    prompts = make_prompts(SEED)
    reg = MetricsRegistry()
    eng = ContinuousBatchingEngine(
        cfg, num_slots=NUM_SLOTS, max_len=max(len(p) for p in prompts)
        + MAX_NEW, max_new_tokens=MAX_NEW, temperature=TEMPERATURE,
        seed=SEED, metrics=reg)
    max_len = eng.max_len                 # the decode window, page-rounded

    # -- 2. kernels vs plain versions --------------------------------------
    timed = {"decode_attention": ("bfloat16", NUM_SLOTS, max_len,
                                  QWEN_HEADS[0], "part"),
             "flash_attention": ("bfloat16", 1, SEQ_LEN_MAX, QWEN_HEADS[0],
                                 0)}
    vlm_len = get_config("internvl2_26b").vision_tokens + max(
        len(p) for p in prompts[:VLM_REQUESTS]) + VLM_NEW
    krows = phase_kernels(torch, max_len, eng.page_size, vlm_len, timed)
    torch.cuda.empty_cache()

    # -- 3. continuous engine, full-width Qwen2.5-7B -----------------------
    t0 = time.monotonic()
    params = init_params(SEED, cfg)
    torch.cuda.synchronize()
    print(f"qwen2_5_7b: {cfg.num_layers} layers d={cfg.d_model} "
          f"vocab={cfg.vocab_size} params={count_params(params)} "
          f"({cfg.param_dtype}, compute {cfg.compute_dtype}) "
          f"init {time.monotonic() - t0:.3f}s")
    qwen_line = {}
    done, launches = serve_continuous(torch, cfg, eng, params, prompts, reg,
                                      smi, report=qwen_line)

    # -- 4. fixed engine ---------------------------------------------------
    decode_attention.launches = 0
    t0 = time.monotonic()
    rows = generate(params, cfg, prompts[:4], SEED,
                    max_new_tokens=16, temperature=TEMPERATURE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_fixed = sum(len(r["response_ids"]) for r in rows)
    for r in rows:
        lp = r["logprobs"][r["prompt_len"]:]
        if not (r["tokens"] < cfg.vocab_size).all() or \
                not all(math.isfinite(x) and x <= 0.0 for x in lp):
            raise AssertionError("fixed engine: bad tokens or logprobs")
    if decode_attention.launches == 0:
        raise AssertionError("fixed engine never launched decode_attention")
    print(json.dumps({"phase": "fixed_engine", "requests": len(rows),
                      "new_tokens": n_fixed, "wall_s": wall,
                      "tokens_per_s": n_fixed / wall, "card": smi,
                      "decode_attention_launches":
                          decode_attention.launches}))

    # -- 5. teacher-forced consistency -------------------------------------
    continuous_teacher_forced(torch, params, cfg, done, prompts, max_len)

    # -- 6. where the device time goes ---------------------------------------
    profile_serving(torch, params, cfg, prompts, max_len)

    # -- 6b. the supervised serving fleet over the same weights --------------
    for name, n in phase_fleet(torch, cfg, params, prompts, smi).items():
        launches[name] += n
    del params, eng, done
    torch.cuda.empty_cache()

    # -- 7. the training path's kernels vs plain versions ---------------------
    krows.update(phase_loss_kernels(torch, ("bfloat16", TRAIN_ROWS,
                                            cfg.vocab_size)))

    # -- 8. one GRPO micro-batch at full width --------------------------------
    cfg2 = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)
    phase_microbatch(torch, cfg2)

    # -- 9. the trainer -----------------------------------------------------
    trainer, train_launches = phase_trainer(
        torch, cfg2, smi, "continuous",
        ("flash_attention", "decode_attention", "grpo_logprob",
         "fused_rl_loss_fwd", "fused_rl_loss_bwd"))
    for name in ("grpo_logprob", "fused_rl_loss_fwd", "fused_rl_loss_bwd"):
        launches[name] = train_launches[name]

    seen = planner_inputs(torch, trainer)

    # -- 10. where an actor update's device time goes ------------------------
    profile_actor_update(torch, trainer)
    del trainer
    _release(torch)

    # -- 10a. the planner: its cost model beside the card, then sizing ------
    planner_launches = phase_planner(torch, cfg, cfg2, smi, seen)
    for name, n in planner_launches.items():
        launches[name] += n

    # -- 10b. one PPO micro-batch at full width -------------------------------
    phase_ppo_microbatch(torch, cfg2)

    # -- 10c. the PPO trainer -------------------------------------------------
    trainer, ppo_launches = phase_trainer(
        torch, dataclasses.replace(cfg, num_layers=PPO_TRAIN_LAYERS), smi,
        "continuous",
        ("flash_attention", "decode_attention", "fused_rl_loss_fwd",
         "fused_rl_loss_bwd"), algorithm="ppo", kl_coef=0.0)
    for name, n in ppo_launches.items():
        launches[name] += n
    del trainer
    _release(torch)

    # -- 10d. durable snapshots and a cold resume -----------------------------
    launches["grpo_logprob"] += phase_durability(
        torch, dataclasses.replace(cfg, num_layers=DURABLE_LAYERS), smi)

    # -- 11. the selective scan vs its plain version --------------------------
    ssm = get_config("falcon_mamba_7b")
    sm_clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    print(f"max SM clock {sm_clock_hz / 1e6:.0f} MHz")
    krows["mamba_scan"] = phase_mamba_scan(torch, sm_clock_hz, SSM_REF_ROWS)

    # -- 12-14. Falcon-Mamba-7B served at full width --------------------------
    phase_fixed_serving(torch, ssm, smi, ("mamba_scan",))

    # -- 15. one GRPO micro-batch of Falcon-Mamba-7B --------------------------
    ssm4 = dataclasses.replace(ssm, num_layers=SSM_TRAIN_LAYERS)
    phase_microbatch(torch, ssm4)

    # -- 16. the trainer on Falcon-Mamba-7B -----------------------------------
    trainer, ssm_launches = phase_trainer(
        torch, ssm4, smi, "fixed",
        ("mamba_scan", "grpo_logprob", "fused_rl_loss_fwd",
         "fused_rl_loss_bwd"))
    launches["mamba_scan"] = ssm_launches["mamba_scan"]
    profile_actor_update(torch, trainer)
    del trainer
    _release(torch)

    # -- 17. the RG-LRU scan, attention at hd 256 and 160, vs plain versions --
    hyb = get_config("recurrentgemma_9b")
    krows["rglru_scan"] = phase_rglru_scan(torch, HYB_REF_ROWS)
    phase_hybrid_attention(torch, hyb)
    phase_stablelm_attention(torch)

    # -- 18-20. RecurrentGemma-9B served at full width ------------------------
    phase_fixed_serving(torch, hyb, smi,
                        ("rglru_scan", "flash_attention", "decode_attention"))

    # -- 21. the decode ring wraps and the flash band is crossed --------------
    hyb4 = dataclasses.replace(hyb, num_layers=HYB_TRAIN_LAYERS)
    phase_ring_check(torch, dataclasses.replace(hyb4,
                                                local_window=RING_WINDOW))

    # -- 22. one GRPO micro-batch of RecurrentGemma-9B ------------------------
    phase_microbatch(torch, hyb4)

    # -- 23. the trainer on RecurrentGemma-9B ---------------------------------
    trainer, hyb_launches = phase_trainer(
        torch, hyb4, smi, "fixed",
        ("rglru_scan", "flash_attention", "decode_attention", "grpo_logprob",
         "fused_rl_loss_fwd", "fused_rl_loss_bwd"))
    launches["rglru_scan"] = hyb_launches["rglru_scan"]
    profile_actor_update(torch, trainer)
    del trainer
    _release(torch)

    # -- 24-26. StableLM-2-12B (hd 160) served at full width ------------------
    phase_stablelm_serving(torch, smi)

    # -- 27. Grok-1 (moe) served at full width --------------------------------
    for name, n in phase_grok_serving(torch, smi).items():
        launches[name] += n

    # -- 28. one GRPO micro-batch of Grok-1 -----------------------------------
    grok1 = dataclasses.replace(get_config("grok_1_314b"),
                                num_layers=GROK_TRAIN_LAYERS)
    for name, n in phase_microbatch(torch, grok1, GROK_TRAIN_ROWS,
                                    ref_stage=True, smi=smi).items():
        launches[name] += n

    # -- 29. InternVL2-26B (vlm) served at full width -------------------------
    for name, n in phase_vlm_serving(torch, smi).items():
        launches[name] += n

    # -- 30. one GRPO micro-batch of InternVL2-26B with its vision prefix -----
    vlm2 = dataclasses.replace(get_config("internvl2_26b"),
                               num_layers=VLM_TRAIN_LAYERS)
    for name, n in phase_microbatch(torch, vlm2, VLM_TRAIN_ROWS, vision=True,
                                    ref_stage=True, smi=smi).items():
        launches[name] += n

    # -- 31. MiniCPM3-4B (mla) served at full width ----------------------------
    mini = get_config("minicpm3_4b")
    phase_fixed_serving(torch, mini, smi, (), idle=ATTENTION_KERNELS)

    # -- 32. a GRPO micro-batch and the trainer on MiniCPM3-4B -----------------
    mini4 = dataclasses.replace(mini, num_layers=MLA_TRAIN_LAYERS)
    mb_launches = phase_microbatch(torch, mini4, smi=smi)
    _expect_launches("minicpm3-4b micro-batch", mb_launches,
                     LOSS_KERNELS[1:], ("flash_attention",))
    trainer, mla_launches = phase_trainer(torch, mini4, smi, "fixed",
                                          LOSS_KERNELS,
                                          idle=ATTENTION_KERNELS)
    profile_actor_update(torch, trainer)
    del trainer
    _release(torch)
    for name in LOSS_KERNELS:
        launches[name] += mb_launches[name] + mla_launches[name]

    # -- 33. DeepSeek-V2 (moe with mla) served at full width -------------------
    deepseek = get_config("deepseek_v2_236b")
    phase_fixed_serving(
        torch, dataclasses.replace(deepseek, num_layers=DEEPSEEK_LAYERS),
        smi, (), idle=ATTENTION_KERNELS)

    # -- 34. one GRPO micro-batch of DeepSeek-V2 -------------------------------
    mb_launches = phase_microbatch(
        torch, dataclasses.replace(deepseek,
                                   num_layers=DEEPSEEK_TRAIN_LAYERS),
        DEEPSEEK_TRAIN_ROWS, ref_stage=True, smi=smi)
    _expect_launches("deepseek-v2 micro-batch", mb_launches, LOSS_KERNELS,
                     ("flash_attention",))
    for name in LOSS_KERNELS:
        launches[name] += mb_launches[name]

    # -- 35. Whisper-tiny (audio) served at full width -------------------------
    for name, n in phase_whisper_serving(torch, smi).items():
        launches[name] += n

    # -- 36. one GRPO micro-batch of Whisper-tiny with its frames --------------
    mb_launches = phase_microbatch(
        torch, get_config("whisper_tiny"), WHISPER_TRAIN_ROWS, frames=True,
        ref_stage=True, smi=smi, adamw=True)
    _expect_launches("whisper-tiny micro-batch", mb_launches,
                     ("flash_attention", *LOSS_KERNELS))
    for name, n in mb_launches.items():
        launches[name] += n

    # -- 37-38. the mesh route on a one-rank NCCL group ------------------------
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        # -- 37. sharded flash-decode, and Qwen2.5-7B served with mesh= ------
        launches["flash_attention"] += phase_mesh_serving(
            torch, smi, mesh, prompts, max_len,
            krows["decode_attention"]["filled"],
            qwen_line)["flash_attention"]
        # -- 38. expert parallelism at one DeepSeek-V2 moe layer -------------
        phase_ep_moe(torch, smi, mesh)
        # -- 39. the launch steps, plain and on DTensors, and the dry run ----
        for name, n in phase_launch_steps(torch, smi, mesh).items():
            launches[name] += n
    finally:
        dist.destroy_process_group()

    # -- 40. output -----------------------------------------------------------
    sources = {
        "decode_attention":
            "src/repro/kernels/decode_attention/decode_attention.py:72",
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:94",
        "grpo_logprob": "src/repro/kernels/grpo_logprob/grpo_logprob.py:84",
        "fused_rl_loss_fwd":
            "src/repro/kernels/fused_rl_loss/fused_rl_loss.py:145",
        "fused_rl_loss_bwd":
            "src/repro/kernels/fused_rl_loss/fused_rl_loss.py:178",
        "mamba_scan": "src/repro/kernels/mamba_scan/mamba_scan.py:61",
        "rglru_scan": "src/repro/kernels/rglru_scan/rglru_scan.py:54"}
    files = {"fused_rl_loss_fwd": "fused_rl_loss",
             "fused_rl_loss_bwd": "fused_rl_loss"}
    kernels = []
    for name, row in krows.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{files.get(name, name)}.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{k: row[k] for k in ("mode", "dense_ms") if k in row}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
