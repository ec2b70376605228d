#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py kda   # phases 1-3 and 12d alone

Phases, in order; any failure exits non-zero before a result is printed:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, all started together);
3. TF32 off for the plain references (a float32 matmul or convolution on
   the card must stay float32 to be held against a float32 kernel);
4. each kernel against its plain PyTorch version on the card: conv2d at the
   five RoShamBo layer shapes for B = 1 and B = 32, ReLU on and off, f32 and
   bf16, one launch a call, two calls bitwise equal and within ``CONV_TOL``
   of the split-order plain version of its plan as well (a
   ``conv2d_split_order_bitwise`` line counts the cases where it is equal
   bit for bit); the launch the frame path runs at the same shapes (the
   2x2 max pool for conv1-4 and the zero count in its epilogue): one
   launch, bitwise ``maxpool2`` of the unpooled launch, within
   ``CONV_TOL`` of ``maxpool2`` of the split-order plain version, its
   count ``count_nonzero`` of what it wrote, two calls equal in bytes and
   counts (a ``conv2d_pooled`` line); the streamed
   matmul under UNIQUE and BLOCKS, f32 and bf16 (UNIQUE's two calls bitwise
   equal, and its single block within ``MATMUL_TOL`` of its order); flash
   attention at qwen2.5-3b's heads (16/2, D 128, causal, S 128 and 2048,
   B 2), h2o-danube's (32/8, D 80, S 4096, window 0 / 1024 / 4096), one
   non-causal case with Sq != Skv and ragged causal S = 1000 (D 160 and a
   D 64 window), granite-moe's (16/8, D 64, S 2048, B 2), deepseek-moe's
   (MHA 16/16, D 128, S 2048) and pixtral's (32/8, D 128, S 2304 = 256
   patches + 2048 text), f32 through the CUDA-core kernel and bf16 through the
   tensor-core kernel, one launch of that route's symbol per case (the bf16
   limit scales with each output row's RMS; a ``flash_cases`` line gives
   each case's error); BLOCKS split-K at the classifier head's shape, two
   calls bitwise equal and within ``MATMUL_TOL`` of the split-order plain
   version;
5. the NullHop path: ``NullHopExecutor.run_frame`` on the card for a few
   frames under each policy of the Table I scenario plus the interrupt-
   driven ring, logits held against the port's ``RoShamBoCNN.apply`` (plain
   conv on the card); a Table-I row per policy, with the median per-chunk
   copy time and, from one more frame under ``torch.profiler`` (after a
   warm-up step of small kernels), the device time a frame holds; the conv
   kernel's launch count must rise by 5 per frame (one a layer: the
   pool and the zero count are in its epilogue), and each frame's
   sparsity must equal, float for float, that of the unpooled launches'
   fmaps pooled by ``maxpool2``;
5b. the ``channels`` line: ``calibrate_transfer()`` on the card (t0 and
   GB/s from the host-felt time of pinned H2D copies, the CUDA-event time
   of the same copies beside it), ``plan_channels`` for 48 MiB and for the
   largest RoShamBo layer, and a 48 MiB f32 payload TX (from the group's
   pinned pool staging) then RX through one engine, groups of 2 and 4
   under the same ring policy and the planned group, in interleaved
   rounds: bitwise round trips, best / median ms, GB/s, bytes a channel;
5c. the ``channels_stream`` line: 8 gated-MLP layers (d 1024, f 4096,
   f32, 48 MiB a layer), batch 4, through ``HostStreamingExecutor`` over
   one engine, a two-channel group and an adaptive group, each layer's two
   products through ``streamed_matmul`` under the transport's policy (the
   ``matmul_blocks`` kernel): within the f32 limits of plain products,
   bitwise equal across the transports, per-layer TX / compute / RX ms;
5d. the ``channels_frame`` line: the same RoShamBo frames over a
   two-channel group and an adaptive group, 5 conv launches a frame,
   logits bitwise the single engine's and within ``LOGIT_TOL`` of the
   plain forward, each channel's descriptors;
5e. the ``faults`` line: a seeded ``FaultInjector`` over three card
   channels with crc32 on: a dropped TX stripe and a corrupted RX stripe
   retried on a sibling, channel 1 stalled until the drift check
   quarantines it and back after the stall lifts and a probe passes, the
   48 MiB payload exact throughout, the fault ledger;
5f. the ``stress`` line: ``python -m repro_torch.analysis`` over ``src``
   in this process (no jax; exit 0, no new finding; its counts), then,
   under validated locks, the reference's five stress hammers on card
   engines (four classes on one runtime, coalescing, seeded faults on
   channel groups, tenants, a mid-run plan swap) and the consumer-stream
   hammer (8 threads TX, compute on a side stream of their own, drop the
   TX result, RX the product, bitwise the host's; over an engine and a
   striped two-channel group): transfers and bytes a hammer, 0
   mismatches, 0 lock-order violations, the order graph's edges;
6. the streamed-matmul path: the RoShamBo classifier head of the same
   frames through ``streamed_matmul`` under each policy's partitioning;
7. the LM scoring path: qwen2.5-3b at full width (36 layers, weights from a
   CUDA generator seeded with 0), ``Model.forward`` / ``Model.loss`` over
   B 2 x S 2048 tokens with ``use_pallas_attention`` on: exactly 36 flash
   launches a forward, of the CUDA-core symbol in f32 and of the
   tensor-core symbol in bf16; f32 logits held against the plain-attention
   forward, bf16 losses and forward wall times of both, the flash
   kernel's device ms in a profiled bf16 forward, and the logits head's
   (its bf16-in, f32-out product's kernels in that forward, and the
   product alone beside the up-cast f32 product it replaced, on the same
   hidden states; an ``lm_score`` line);
8. the serving path: ``ServingEngine.generate`` on the same model in bf16,
   4 prompts x 128 tokens, 32 new tokens, greedy, under the kernel-level
   (interrupt) and the user-level polling policies, twice each: identical
   tokens across all four (an ``lm_serve`` line);
9. the SSD kernel against its plain version on the card at mamba2-780m's
   shape (B 2, S 2048, H 48, P 64, N 128, G 1, Q 256), zamba2-1.2b's (H 64,
   N 64) and a G 2, Q 32 case, f32 (CUDA cores) and bf16 (tensor cores;
   y_diag, states, decay; the bf16 limit scales with each output row's
   RMS); the state pass bitwise against its loop on the bf16 kernel's
   outputs at mamba2's shape, from zeros and from a random state, one
   launch a call; and ``ssd_full`` through both kernels against the plain
   ``ssd_chunked`` in f32 (an ``ssd_cases`` line);
10. the SSM scoring path: mamba2-780m at full width (48 layers, weights
   from a CUDA generator seeded with 0). In f32, prefill of 2 x 272 tokens
   (one chunk and a padded tail, through the kernel) against 272 decode
   steps from zero state (the recurrence, no kernel): last logits, SSM
   states and conv tails. In bf16 (the mixer's f32 params kept f32),
   ``Model.loss`` / ``Model.forward`` over B 2 x S 2048 tokens: exactly 48
   launches of each SSD kernel (intra-chunk, state pass) a forward,
   losses, forward wall time and a profiled forward with the SSD kernels'
   device ms (an ``ssm_score`` line);
11. the SSM serving path: mamba2-780m in bf16, 4 prompts x 600 tokens, 32
   new tokens, greedy, under the kernel-level and the user-level polling
   policies, twice each: identical tokens (an ``ssm_serve`` line);
11b. the same serving over ``ServeConfig(n_channels=2)``,
   ``(adaptive_transfer=True)`` and ``(online_adaptation=True,
   transfer_state_path=...)``, then a second online engine that must
   warm-start from the first one's state: 48 launches of each SSD kernel a
   prefill, greedy tokens identical to the ``ssm_serve`` line's (an
   ``ssm_serve_channels`` line);
12. the hybrid path: zamba2-1.2b at full width (38 mamba layers, the shared
   attention block every 6): the same f32 prefill-vs-recurrence check at
   272 tokens (with the shared block's KV caches), the bf16 forward over
   B 2 x S 2048 tokens (38 launches of each SSD kernel), its wall time and
   a profiled forward, and one serving run, twice, identical tokens (a
   ``hybrid`` line);
12b. the moe path (a ``moe`` line): granite-moe-1b-a400m at full width
   (24 layers, 32 experts top-8; weights from a CUDA generator seeded
   with 0), ``Model.forward`` over B 2 x S 2048 with
   ``use_pallas_attention``: in f32 (TF32 off) exactly 24 launches of the
   CUDA-core flash symbol, logits within ``LM_LOGIT_ATOL`` of the
   plain-attention forward (the tokens each run routes elsewhere, with
   their router margins, on the line); layer 0's MoE on its input in that
   forward, on the card against the CPU (the same dropped fraction,
   within ``MOE_LAYER_ATOL``); in bf16 (router and norms f32) the loss,
   aux loss, each layer's dropped fraction, the forward's wall time and a
   profiled forward (flash's device ms; the device ms and share of the
   MoE's dispatch, expert products and combine); then deepseek-moe-16b
   in bf16 (28 layers, 64 experts top-6 + 2 shared; ~34 GB), one scoring
   forward over B 1 x S 2048 (28 tensor-core flash launches), its loss
   and a profiled forward;
12c. continuous batching (a ``continuous`` line): ``ContinuousBatchingEngine``
   serving granite-moe in bf16, 4 slots, max_seq 256, 10 requests
   (prompts 32-160 tokens, 8-48 new, from ``default_rng(0)``), under the
   kernel-level and the user-level polling policies twice each: every
   request done, identical tokens; per run the steps, tokens/s, each
   request's time to first token, TX / RX counts and a profiled decode
   step; then 2 slots at max_seq 64 where an idle slot passes max_seq
   (its writes dropped, tokens identical across the four runs); then
   qwen2.5-3b in f32, 3 requests over 2 slots, each request's greedy
   tokens against ``ServingEngine`` serving it alone (a differing token
   fails the phase unless the top-2 logit margin there is under
   ``LM_LOGIT_ATOL``; the line says where and by how much); then decode
   attention (a ``decode_attention`` line): the kernel against its plain
   version at granite.chat's and granite4h.rag's decode shapes and length
   mix (flash's bf16 rule), one launch a call, two calls bitwise equal, its
   ms and device ms beside its bound, the plain version's, the model's
   route before it and SDPA's over a mask of the live rows; and the
   decode graph (a ``decode_graph`` line): the engine's replayed decode
   steps bitwise eager ones of the same inputs (smoke granite-moe and
   granite-4.0-h with 64-wide heads, 5 requests on 3 slots; granite-moe
   at full size on 64 slots), with the host ms of each; and latent
   decode attention (an ``mla_decode`` line): the kernel against its
   plain version at dsv2lite.longdoc's decode shape and length mix (the
   same rule), one launch a call, two calls bitwise equal, its ms and
   device ms beside its bound, the plain version's and SDPA's over a mask
   of the live rows; one eager DeepSeek-V2-Lite decode step at every
   published width on 32 slots of 18,432 launching it 27 times and no
   other kernel of the port's; and MLA's prefill attention (a
   ``flash_dkv`` line): the flash kernel's two-width entry (q and K of
   192, V of 128) at dsv2lite.longdoc's second prefill chunk (4,096
   queries after 4,096 keys) against its plain version (the same rule),
   one launch a call, two calls bitwise equal, its ms and device ms beside
   its bound, the plain version's and SDPA's with the same causal mask;
12d. the encoder-decoder path (an ``encdec`` line): seamless-m4t-medium at
   full width (12 + 12 layers), f32 prefill of 31 tokens + one decode
   step against the teacher-forced forward over frames [2, 128, 1024]
   (``LM_LOGIT_ATOL``), then bf16 serving with the frames as side inputs
   (4 x 128 frames, 16-token prompts, 32 new tokens), two policies twice
   each: identical tokens;
12e. the vlm path (a ``vlm`` line): pixtral-12b, f32 flash against plain
   attention on its first 4 layers over 256 patch + 2048 text positions
   (``LM_LOGIT_ATOL``), the bf16 model at full depth (40 layers): exactly
   40 tensor-core flash launches a forward, its loss over the text, wall
   time and a profiled forward; serving 4 x 128 + 32 tokens with the
   patch embeddings (f32 [4, 256, 5120]) riding the prompt's
   scatter-gather TX under the kernel-level policy, two policies twice
   each: identical tokens, TX bytes on the line;
12f. the training path (a ``train`` line): qwen2.5-3b at full width in
   bf16 with remat, ``Trainer.run`` for 4 AdamW steps of B 2 x S 1024
   staged by ``StagedPipeline`` under INTERRUPT through a TransferEngine:
   every loss finite, every step_ok 1, step 0's loss within
   ``TRAIN_LOSS_ATOL`` of the no-grad forward's on the same batch, every
   param leaf moved, no flash launch (training runs plain attention, as
   the reference's must); each step's loss, gradient norm and wall time,
   the median step ms and tokens/s, peak device memory, one more step
   profiled (device ms, busy share, costliest entries, AdamW's
   ``optim.adamw`` range and its share) beside the step's bound and
   AdamW's;
12g. the same for mamba2-780m (a ``train_ssm`` line), 96 launches of each
   SSD kernel a step (48 forward + 48 remat recompute), after F8's gate:
   at full width in f32, ``F8_LAYERS`` deep, one B 1 x S 512 batch's
   gradients through the SSD kernels against the plain route, each leaf
   within ``F8_REL`` relative L2 (the worst on the line; the same reading
   at the full 48 layers beside it, not gated: see ``F8_LAYERS``);
12h. the example's lm-100m in f32 (a ``train_lm`` line): 40 steps, 2
   microbatches, async checkpoints every 20; a second Trainer on the same
   directory (step 40's checkpoint removed, as if the job had died)
   resumes at step 20 and reaches the first run's losses within
   ``LM100M_LOSS_ATOL``; the checkpoint's bytes, the snapshot and write
   ms, and the TX us a batch under each of the three managements;
12i. the distributed layer (a ``dist`` line) on a world of one NCCL rank
   on the card (NCCL takes one rank a card; the multi-rank rings and the
   sharded loss are held on the CPU by the tests): the local (1, 1) mesh,
   the four rings at n = 1 bitwise ``x`` and ``x @ w``,
   ``param_sharding`` of qwen2.5-3b's full-width params (every placement
   ``Replicate()``, the leaf count) beside the bytes a device of the same
   shapes under the (16, 16) production mesh's specs, B 2 x S 1024 qwen
   batches staged as DTensors under the three managements (bitwise the
   host batch, TX us a batch), and ``device_streamed_scan`` over
   qwen2.5-3b's 36 layers in bf16 at B 2 x S 2048, the stacked layers in
   pinned host memory (~5.55 GB) copied to the card a layer ahead: the
   hidden states bitwise the resident ``stack_apply``'s, exactly 36
   tensor-core flash launches, the resident, streamed and copy ms and the
   overlap share (copy + compute - streamed) / min(copy, compute);
12j. ``repro_torch.examples.elastic_restart`` on the card (an ``elastic``
   line): 10 steps with checkpoints at 5 and 10, a fresh Trainer resumed
   at step 10 (``restarts == 1``), the plan of 384 of 512 devices and its
   ``reshard_plan``;
12k. ``repro_torch.examples.transfer_modes`` on the card (a
   ``transfer_modes`` line): the paper's four Table-I policies, 5 conv
   launches a frame, their logits bitwise equal; the unified runtime's
   TOKEN class at 51 completions / 1632 bytes; the fault demo's channel 0
   quarantined after two drops and back after the probe; the Table-I rows,
   the coalescing ratio and the token RX p50;
12l. the dry run (a ``dryrun`` line): qwen2.5-3b's bf16 prefill of B 2 x
   S 2048 through plain attention on a world of one NCCL rank, predicted
   under fake tensors and run on the card under the same counters
   (predicted FLOPs equal to counted; peak bytes over the rise of
   ``max_memory_allocated`` and the ms beside the roofline terms,
   printed), then qwen2.5-3b decode_32k on the (16, 16) mesh under the
   ``fake`` backend, ``ok``;
12d. Kimi-Linear's kernels at kimilinear.agent's shapes (a ``kda`` line):
   the chunked KDA prefill over a 4,096-token chunk, the KDA decode step
   over 64 slots, the KDA prologue and gated norm over the chunk, and the
   32-head latent decode kernel over 64 slots of 40,960 rows (~14k live),
   each against its plain version at the card tests' tolerances with the
   launch counts zeroed first, timed beside its bound, its plain version
   and SDPA for the latent kernel; one eager full-width decode step counted
   from zero (20 of each KDA decode entry, 7 latent launches); then the
   ``kimi_depth`` line (not gated): the served bf16 logits against the
   cell's float32 reference at 5, 13 and 27 layers, at 27 without the
   router's bias and beside the reference's fp8 and bf16-state controls;
13. each kernel timed at its path's shapes beside its bound, its plain
   version and one library call where one exists (the yardstick; the port
   never calls it); conv2d per RoShamBo layer at batch 1 as the frame
   path launches it, pooled (conv1-4) and counted (events and device ms
   of the kernel and of ``F.conv2d`` with ``F.max_pool2d`` where the
   layer pools, the layer's plan, and the bound with the pooled write)
   and the five-layer sum in alternating rounds with the library pair; the
   classifier head's BLOCKS and UNIQUE matmuls in alternating rounds with
   ``torch.matmul`` (all host-bound there), with the device time of each
   and BLOCKS's one-split schedule beside them; the SSD kernel in bf16
   and f32 and the state pass at mamba2's shape, with the device ms of a
   launch of each in mamba2's profiled forward;
14. a ``kernels`` JSON line (flash's launches summed over the qwen, moe
   and vlm scoring paths and the streamed scan; the SSD rows' training
   launches beside theirs; 12d's rows), the card line, and the ``ok`` line
   last.

Every time printed comes from this run on the card named by the ``card``
line printed after the build (``nvidia-smi`` name and power limit).
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM published peaks (data sheet, 700 W part)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # CUDA-core float32 (the conv and matmul work is f32)
BF16_FLOPS = 989e12  # dense bf16 tensor cores (the flash path's bf16 work)

CONV_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
MATMUL_TOL = {"float32": (2e-4, 2e-3), "bfloat16": (2e-2, 2e-1)}
LOGIT_TOL = (1e-4, 1e-4)
# flash, f32: tests/test_kernels.py's rtol = atol = 2e-4. bf16: a fixed
# 5e-2 would be as large as the outputs of the long-sequence cases (a late
# row averages thousands of randn values: RMS ~ 0.02), and one RMS for the
# whole case is too small for the early rows (row 0 is v itself, RMS ~ 1,
# where p's bf16 rounding moves the sum most). So the bf16 limit scales
# with each output row: |d| <= 2e-2 |ref| + 0.05 RMS(ref row over D). The
# ``flash_cases`` line gives each case's max |d| / RMS(row) and its max
# (|d| - 2e-2 |ref|) / RMS(row), the reading held to 0.05.
FLASH_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, None)}
FLASH_BF16_ATOL_ROW_RMS = 0.05
# (B, Sq, Skv, H, Hkv, D, causal, window)
FLASH_CASES = [(2, 128, 128, 16, 2, 128, True, 0),
               (2, 2048, 2048, 16, 2, 128, True, 0),
               (1, 4096, 4096, 32, 8, 80, True, 0),
               (1, 4096, 4096, 32, 8, 80, True, 1024),
               (1, 4096, 4096, 32, 8, 80, True, 4096),
               (2, 200, 333, 8, 2, 64, False, 0),
               (2, 1000, 1000, 8, 4, 160, True, 0),
               (1, 1000, 1000, 4, 4, 64, True, 96),
               # the moe and vlm scoring shapes: granite-moe (D 64, GQA
               # 2), deepseek-moe (MHA at D 128), pixtral (256 prefix +
               # 2048 text, GQA 4)
               (2, 2048, 2048, 16, 8, 64, True, 0),
               (1, 2048, 2048, 16, 16, 128, True, 0),
               (1, 2304, 2304, 32, 8, 128, True, 0)]
# full-width LM logits, flash kernel vs plain attention_unique, both f32 on
# the card (tests/test_pallas_wiring.py holds the smoke model at atol 1e-3)
LM_LOGIT_ATOL = 1e-3
LM_BATCH, LM_SEQ = 2, 2048
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 128, 32
# SSD, kernel vs plain: f32 at the reference's own 1e-3 (ssd_full against
# ssd_chunked, tests/test_kernels.py); bf16 |d| <= 2e-2 |ref| + 0.05 RMS of
# the output row (y_diag over P, states over N, decay over H), as flash:
# att and the state decay are rounded to bf16, and a rounding that lands
# the other way moves a sum by one bf16 step of one term
SSD_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (2e-2, None)}
SSD_BF16_ATOL_ROW_RMS = 0.05
# (B, S, H, P, G, N, Q): mamba2-780m, zamba2-1.2b, two groups at Q 32
SSD_CASES = [(2, 2048, 48, 64, 1, 128, 256),
             (2, 2048, 64, 64, 1, 64, 256),
             (2, 512, 8, 64, 2, 64, 32)]
# SSM prefill (kernel) against the token-by-token recurrence, f32, full
# width: last logits within SSM_LOGIT_ATOL; SSM states, conv tails and the
# hybrid's K/V within SSM_STATE_REL x max |ref| (a CPU run of the plain
# SSD at full width, 6-7 layers, gave 1.3e-5 / 6.7e-5 on logits up to 4
# and 3e-6 / 2e-5 of max |state|)
SSM_PREFILL = 272  # one 256-token chunk and a padded tail
SSM_LOGIT_ATOL = 5e-3
SSM_STATE_REL = 5e-3
SSM_SERVE_PROMPT = 600
SSD_SYMS = ("ssd_intra_chunk", "ssd_state_pass")
# their kernels' names in a profiler trace (bf16 intra-chunk, state pass)
SSD_KERNEL_NAMES = ("ssd_chunk_tc_kernel", "ssd_state_pass_kernel")
# params the reference keeps f32 in every dtype (a bf16 router would
# change the top-k)
F32_PARAMS = ("ln1", "ln2", "final_norm", "a_log", "d_skip", "dt_bias",
              "norm_scale", "router", "ln_x", "enc_norm")
FRAMES_PER_POLICY = 4  # one warm-up frame + 3 timed (+1 profiled)
# the transfer stack's lines: the reference's 48 MiB per-layer payload
# (benchmarks/multichannel_sweep.py) and its weight-streaming scenario
# (benchmarks/streaming_layers.py): 8 gated-MLP layers, d 1024, f 4096, f32
CH_PAYLOAD = 48 << 20
CH_ROUNDS = 5  # interleaved rounds over the four transports
STREAM_LAYERS, STREAM_D, STREAM_F, STREAM_BATCH = 8, 1024, 4096, 4
STREAM_LAYER_BYTES = (STREAM_D * 2 * STREAM_F + STREAM_F * STREAM_D) * 4
STREAM_RUNS = 3  # a transport's first run checks every product
# a streamed product's or output's RMS must be this far above atol (2e-3)
# for its check to fail a kernel that is wrong
STREAM_MIN_RMS = 100 * MATMUL_TOL["float32"][1]
# per descriptor on the stalled channel: FAULT_STALL_X times the slowest
# of 8 healthy 64 KiB probes, and at least FAULT_STALL_MIN_S
FAULT_STALL_X = 20
FAULT_STALL_MIN_S = 0.1
ROUNDS = 7  # alternating timing rounds of a kernel and its library call
# the moe, continuous-batching, encoder-decoder and vlm lines
MOE_BATCH, MOE_SEQ, DEEPSEEK_BATCH = 2, 2048, 1
# one granite MoE layer on the card against the CPU, f32
MOE_LAYER_ATOL = 1e-4
# the f32 flash-vs-plain gate runs at a capacity where no token is
# dropped: with drops, a near-tie between two experts' router
# probabilities that the two forwards break differently changes the seat
# order and so which token is dropped (the reference's
# tests/test_models.py holds its moe configs at 64 for the same reason)
MOE_CHECK_CAPACITY = 64.0
# Even without drops, a token whose k-th and (k+1)-th router
# probabilities are this close may be routed to another expert by the
# two forwards (f32 attention through the kernel and the plain path
# differ by ~1e-6): that token's logits move by O(0.1). The gate lets such
# a token exceed LM_LOGIT_ATOL, and only such a token: rerouted, with the
# gap under MOE_TIE_GAP in both forwards' router probabilities, and at most
# MOE_TIE_MAX_TOKENS of them (of 4,096). The line lists each with its layer
# and both gaps.
MOE_TIE_GAP = 1e-6
MOE_TIE_MAX_TOKENS = 4
MOE_SPANS = ("moe.dispatch", "moe.experts", "moe.combine", "moe.shared")
CB_SLOTS, CB_MAX_SEQ, CB_REQUESTS = 4, 256, 10
CB_PROMPT, CB_NEW = (32, 160), (8, 48)  # inclusive ranges
CB_SUBMIT_TRIES = 8  # a shed request's backoffs before the phase fails
# F6's path: slot 0 retires at length 57 and idles while slot 1 decodes 32
# more steps, past max_seq 64 (the 10 requests above never reach it: the
# longest device length they give is 190 of 256)
CB_F6_SLOTS, CB_F6_MAX_SEQ, CB_F6_REQUESTS = 2, 64, ((50, 8), (16, 40))
CB_QWEN_SLOTS, CB_QWEN_REQUESTS, CB_QWEN_NEW, CB_QWEN_MAX_SEQ = 2, 3, 16, 128
ENC_FRAMES, ENC_CHECK_BATCH, ENC_CHECK_SEQ = 128, 2, 32
ENC_SERVE_BATCH, ENC_SERVE_PROMPT = 4, 16
VLM_TEXT, VLM_F32_LAYERS = 2048, 4
# the training lines: full-width steps at B 2 x S 1024, bf16, remat on
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 4
# step 0's bf16 loss against the no-grad bf16 forward's on the same batch
# (the same ops; only atomics' order in the embedding backward differs)
TRAIN_LOSS_ATOL = 2e-2
# F8: mamba2-780m's gradients through the SSD kernels against the plain
# route (``ssd_full(use_kernel=False)`` everywhere), f32, each leaf's
# relative L2 error, at full width and F8_LAYERS deep. The two routes'
# f32 forwards drift apart with depth (the kernel sums in another order;
# ROADMAP F4), and the gradients follow the forward: on an H100 this
# line read logits 3.3e-4 / 1.6e-2 apart and gradients 1.4e-4 / 2.8e-2
# apart at 4 / 48 layers. A gradient that misses the SSD path (F8) is off
# by O(1) at any depth. The full depth's reading is on the line beside
# the gate, not gated.
F8_BATCH, F8_SEQ, F8_REL, F8_LAYERS = 1, 512, 1e-3, 4
# the example's lm-100m: 40 steps, async checkpoints every 20, a second
# Trainer resumed from step 20 on its first run's losses within 1e-5
LM100M_STEPS, LM100M_EVERY, LM100M_LOSS_ATOL = 40, 20, 1e-5
STAGE_BATCHES = 10  # batches staged under each management for TX us
# AdamW fused would move 28 B a param: grad (bf16) 2 + m, v, master 12
# read; m, v, master 12 + param (bf16) 2 written
ADAMW_BYTES_PER_PARAM = 28
# the distributed lines: qwen batches of B 2 x S 1024 staged as DTensors,
# qwen2.5-3b's 36 layers streamed from pinned host memory over B 2 x S 2048
DIST_STAGE_BATCH, DIST_STAGE_SEQ = 2, 1024
DIST_PRODUCTION = {"data": 16, "model": 16}  # sizes of the (16, 16) mesh


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls,
    by CUDA events, after a warm-up call (L2 warm, as in the streamed
    path where each layer's inputs were just written)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int, flops: int,
             peak_flops: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, ref, tol) -> float:
    """Max |got - ref|; fails unless |got - ref| <= atol + rtol*|ref|."""
    g, r = got.float(), ref.float()
    if not bool(torch.isfinite(g).all()):
        fail("kernel output is not finite")
    diff = (g - r).abs()
    rtol, atol = tol
    if bool((diff > atol + rtol * r.abs()).any()):
        fail(f"kernel disagrees with its plain version: max err "
             f"{float(diff.max())} (rtol {rtol}, atol {atol})")
    return float(diff.max())


def _zero(libs) -> None:
    """Sets every launch count of ``libs`` to 0."""
    for lib in libs:
        lib.launches = dict.fromkeys(lib.launches, 0)


def launched(torch, lib, sym, expect: int, fn, what: str):
    """``fn()``, synchronised; fails unless it launched ``lib``'s ``sym``
    (one C symbol, or each of a tuple of them) exactly ``expect`` times and
    no other entry of ``lib``."""
    syms = (sym,) if isinstance(sym, str) else tuple(sym)
    before = dict(lib.launches)
    out = fn()
    torch.cuda.synchronize()
    got = {s: lib.launches[s] - before[s] for s in before}
    if got != {s: expect if s in syms else 0 for s in before}:
        fail(f"{what}: {lib.name} launched {got}, expected {expect} x "
             f"each of {syms} and nothing else")
    return out


def device_events(torch, prof) -> list[tuple[str, float, int]]:
    """(name, ms, count) of the device-side entries of a ``torch.profiler``
    trace: kernels, copies and fills. A CPU op's own
    ``self_device_time_total`` repeats the time of the kernels it launched,
    so summing every entry would count that time twice."""
    cuda = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    # a schedule's step marker and a ``record_function`` range are listed
    # as device entries too, holding the wall time they span on the
    # device; they are no device work (a range also has its host entry)
    host = {e.key for e in avgs if e.device_type != cuda}
    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in avgs
            if e.device_type == cuda and e.key not in host
            and not e.key.startswith("ProfilerStep")]


def device_profile(torch, fn, top: int = 6, match=None, names=(),
                   spans=()) -> dict:
    """One ``fn()`` under ``torch.profiler``: its wall time, the device
    time the trace holds and the costliest device entries; with ``match``
    (a string, or a tuple of them), the device ms and launches of the
    entries whose name holds it; with ``names``, {name: (device ms,
    launches)} of the entries named so (``matched``); with ``spans``, the
    device ms of the kernels launched inside each ``record_function``
    range so named, summed over its calls."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = device_events(torch, prof)
    device = sum(t for _, t, _ in ev)
    out = {"wall_ms": wall, "device_ms": device,
           "device_busy_share": device / wall,
           "device_launches": sum(n for _, _, n in ev),
           "top_ms": [[k[:72], t, n] for k, t, n in
                      sorted(ev, key=lambda e: -e[1])[:top]]}
    def entry(m):
        return {"name": m,
                "device_ms": sum(t for k, t, _ in ev if m in k),
                "launches": sum(n for k, _, n in ev if m in k)}

    if isinstance(match, str):
        out["match"] = entry(match)
    elif match:
        out["match"] = [entry(m) for m in match]
    if names:
        out["matched"] = {k: (t, n) for k, t, n in ev if k in names}
    if spans:  # the host entry's: its kernels' device time
        cuda = torch.autograd.DeviceType.CUDA
        avg = {e.key: e.device_time_total / 1e3
               for e in prof.key_averages()
               if e.key in spans and e.device_type != cuda}
        out["spans"] = {k: avg.get(k, 0.0) for k in spans}
    return out


def device_ms_per_call(torch, fn, n: int = 20) -> float:
    """Device time of one ``fn()`` from a ``torch.profiler`` trace of ``n``
    calls: for each kernel (device entry) its mean time, times the launches
    a call makes of it (its entries over ``n``, rounded). Unlike
    ``time_ms`` it leaves out the host's cost of each launch, which is most
    of a call at the classifier head's size.

    A trace can lose entries (on an H100, late in a run: traces of 20 conv
    launches held 15 or 19 entries, three times in a row; some traces held
    none, once three scheduled traces in a row), so the time comes from
    each kernel's mean, not from the sum; the trace is the second step of
    a profiler schedule, after a warm-up step of the same calls, or, every
    other attempt, one plain profiling session of the calls; and a trace
    in which some kernel holds fewer than n / 2 entries is taken again, a
    sixth failing the run rather than print a time it never measured."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(6):
        scheduled = attempt % 2 == 0
        sched = (torch.profiler.schedule(wait=0, warmup=1, active=1,
                                         repeat=1) if scheduled else None)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _ in range(2 if scheduled else 1):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                if scheduled:
                    prof.step()
        ev = device_events(torch, prof)
        if ev and all(c >= n / 2 for _, _, c in ev):
            return sum(t / c * round(c / n) for _, t, c in ev)
    fail(f"six profiler traces of {n} calls lost entries: "
         f"{[(k[:40], c) for k, _, c in ev]}")


def _cast_weights(tree, dtype):
    """The same weights in ``dtype``; the norm params and the Mamba2
    mixer's ``a_log``, ``d_skip``, ``dt_bias`` and ``norm_scale`` stay f32,
    as the reference keeps them in every dtype."""
    if isinstance(tree, list):
        return [_cast_weights(v, dtype) for v in tree]
    return {k: v if k in F32_PARAMS
            else _cast_weights(v, dtype) if isinstance(v, (dict, list))
            else v.to(dtype) for k, v in tree.items()}


def wall_ms(torch, fn, reps: int = 3) -> float:
    """Best host-clock time of ``fn()`` ended by a synchronise."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def rms_close(torch, got, ref, tol, row_rms: float | None, dim: int = -1):
    """(ok, max |d|, max (|d| - rtol |ref|) / RMS(ref row)): ``got`` within
    atol + rtol |ref|, where a None atol is ``row_rms`` x the RMS of each
    ``ref`` row over ``dim``."""
    g, r = got.float(), ref.float()
    if not bool(torch.isfinite(g).all()):
        return False, float("inf"), float("inf")
    rtol, atol = tol
    rms = r.pow(2).mean(dim, keepdim=True).sqrt().clamp_min(1e-30)
    if atol is None:
        atol = row_rms * rms
    diff = (g - r).abs()
    ok = bool((diff <= atol + rtol * r.abs()).all())
    return ok, float(diff.max()), float(((diff - rtol * r.abs()) / rms).max())


SERVE_POLICIES = ("kernel-level", "user-level polling")


def serve_runs(np, model, params, scfg, prompts, new_tokens: int,
               policies, vocab: int, reps: int = 2, extra=None):
    """``ServingEngine.generate`` under each named policy, ``reps`` times
    each, greedy, with ``extra`` as side inputs: fails unless every run
    gives the first run's tokens. Returns (per-run rows, the tokens)."""
    from repro_torch.core.transfer import TransferPolicy
    from repro_torch.serve.engine import ServingEngine

    make = {"kernel-level": TransferPolicy.kernel_level,
            "user-level polling": TransferPolicy.user_level_polling}
    b = prompts.shape[0]
    rows, first = [], None
    for name in policies:
        policy = make[name]()
        eng = ServingEngine(model, params, scfg, policy=policy)
        if eng.engine.device.type != "cuda":
            fail(f"serving engine for {policy.tag} is on {eng.engine.device}")
        try:
            for rep in range(reps):
                res = eng.generate(prompts, max_new_tokens=new_tokens,
                                   extra_inputs=extra)
                toks = np.stack([r.tokens for r in res])
                if toks.shape != (b, new_tokens) or not (
                        (toks >= 0) & (toks < vocab)).all():
                    fail(f"{policy.tag}: bad tokens {toks}")
                if first is None:
                    first = toks
                elif not np.array_equal(toks, first):
                    fail(f"{model.cfg.name} {policy.tag} run {rep}: greedy "
                         f"tokens differ from the first run's")
                r0 = res[0]
                rows.append({"policy": policy.tag, "run": rep,
                             "prefill_ms": r0.prefill_s * 1e3,
                             "decode_ms": r0.decode_s * 1e3,
                             "tokens_per_s": b * new_tokens / r0.decode_s,
                             "tokens_per_s_per_request": r0.tokens_per_s,
                             "tx_bytes": eng.engine.tx_bytes_total,
                             "rx_bytes": eng.engine.rx_bytes_total})
        finally:
            eng.close()
    return rows, first


SERVE_CHANNEL_SETTINGS = (
    ("n_channels=2", {"n_channels": 2}),
    ("adaptive_transfer", {"adaptive_transfer": True}),
    ("online_adaptation", {"online_adaptation": True}),
    ("online_adaptation (warm start)", {"online_adaptation": True}))


def serve_channel_runs(np, model, params, prompts, want, vocab):
    """One ``ServingEngine.generate`` under each ``SERVE_CHANNEL_SETTINGS``
    entry (the online ones sharing a state file under ``build/``, which
    the first writes on close and the second must warm-start from): greedy
    tokens identical to ``want``. Returns a row per engine: its plan,
    prefill and decode ms, tokens/s and fault ledger."""
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    state = ROOT / "build" / "ssm_transfer_state.json"
    state.parent.mkdir(parents=True, exist_ok=True)
    state.unlink(missing_ok=True)
    b = prompts.shape[0]
    rows = []
    for name, kw in SERVE_CHANNEL_SETTINGS:
        if kw.get("online_adaptation"):
            kw = dict(kw, transfer_state_path=str(state))
        scfg = ServeConfig(max_batch=b,
                           max_seq=prompts.shape[1] + SERVE_NEW + 8, **kw)
        eng = ServingEngine(model, params, scfg)
        try:
            if eng.engine.device.type != "cuda":
                fail(f"serving over {name} is on {eng.engine.device}")
            res = eng.generate(prompts, max_new_tokens=SERVE_NEW)
            toks = np.stack([r.tokens for r in res])
            if not ((toks >= 0) & (toks < vocab)).all() or not np.array_equal(
                    toks, want):
                fail(f"serving over {name}: greedy tokens differ from the "
                     f"single engine's")
            plan = getattr(eng.engine, "plan", None)
            r0 = res[0]
            rows.append({
                "setting": name, "engine": type(eng.engine).__name__,
                "tag": eng.engine.policy.tag,
                "n_channels": len(eng.engine.engines),
                "plan": plan.row() if plan is not None else None,
                "warm_started": getattr(eng.engine, "warm_started", None),
                "prefill_ms": r0.prefill_s * 1e3,
                "decode_ms": r0.decode_s * 1e3,
                "tokens_per_s": b * SERVE_NEW / r0.decode_s,
                "faults": eng.fault_summary()})
        finally:
            eng.close()
    if not rows[-1]["warm_started"]:
        fail("the second online engine did not warm-start from the first "
             "one's state file")
    return rows


def trace_names(torch, fn) -> dict:
    """{device entry name: launches} of one ``fn()`` under the profiler,
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return {k: n for k, _, n in device_events(torch, prof)}


def head_kernels(torch, cfg, model, params, batch):
    """The logits head of a bf16 scoring forward: its hidden states caught
    on the way into ``lm.logits_from_hidden``, and {name: launches} of the
    kernels the head alone launches that its norm does not (its product,
    and any memset it shares with other ops). Returns (the normed hidden
    states, the head, those kernels)."""
    from repro_torch.models import lm
    from repro_torch.models.layers.norm import apply_norm

    seen = []
    real = lm.logits_from_hidden

    def catch(c, p, x):
        seen.append(x)
        return real(c, p, x)

    lm.logits_from_hidden = catch
    try:
        model.forward(params, batch)
    finally:
        lm.logits_from_hidden = real
    x = seen[-1]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    xn = apply_norm(cfg.norm, params["final_norm"], x)
    if xn.dtype != torch.bfloat16 or head.dtype != torch.bfloat16:
        fail(f"{cfg.name} bf16 head: hidden {xn.dtype}, head {head.dtype}")
    alone = trace_names(torch, lambda: real(cfg, params, x))
    norm = trace_names(torch, lambda: apply_norm(
        cfg.norm, params["final_norm"], x))
    return xn, head, {k: n for k, n in alone.items() if k not in norm}


def head_entry(torch, xn, head, kernels: dict, matched: dict) -> dict:
    """The head's device ms and launches in a profiled forward (``matched``:
    that trace's entries named in ``kernels``, by name), counting only the
    kernels no other op of the forward launches; beside them, on the same
    inputs, the device ms of the head's product alone and of the up-cast
    f32 product it replaced (an f32 copy of both operands, then an f32
    GEMM)."""
    own = [k for k, n in kernels.items()
           if k in matched and matched[k][1] == n]
    return {"device_ms_in_forward": (sum(matched[k][0] for k in own)
                                     if own else None),
            "launches_in_forward": sum(matched[k][1] for k in own),
            "kernels": sorted(own),
            "device_ms_alone": device_ms_per_call(
                torch, lambda: torch.mm(xn.reshape(-1, xn.shape[-1]), head,
                                        out_dtype=torch.float32), n=5),
            "device_ms_up_cast": device_ms_per_call(
                torch, lambda: torch.matmul(xn.float(), head.float()), n=5)}


def _channel_bytes(eng) -> list[dict]:
    """Per member engine of a transport: the bytes it carried each way and
    the descriptors it ran (one engine is a one-channel transport)."""
    return [{"tx_bytes": e.tx_bytes_total, "rx_bytes": e.rx_bytes_total,
             "descriptors": e.chunk_seq}
            for e in getattr(eng, "engines", [eng])]


def largest_layer_bytes(cnn) -> int:
    """The largest RoShamBo layer's f32 params (3x3 w and b): the biggest
    TX payload of a frame."""
    return max((9 * spec.c_in + 1) * spec.c_out * 4
               for spec in cnn.cfg.layers)


def channels_phase(np, torch, cnn):
    """5b. the ``channels`` line: the calibration fit on the card beside
    the CUDA-event DMA time of the same copies, the plans it gives, and a
    48 MiB f32 payload TX then RX through one engine, groups of 2 and 4
    under the same policy and the planned group, in interleaved rounds:
    bitwise round trips, pinned pool staging, best / median ms, GB/s and
    the bytes each channel carried. Returns the calibrated model."""
    from repro_torch.core.channels import (
        ChannelGroup, calibrate_transfer, calibration_samples,
        plan_channels)
    from repro_torch.core.transfer import (
        TransferEngine, TransferPolicy, carve_flat_out)

    model = calibrate_transfer()
    cal = [{"bytes": n, "host_us": t * 1e6, "event_us": ev * 1e6,
            "host_gbps": n / t / 1e9, "event_gbps": n / ev / 1e9}
           for n, t, ev in calibration_samples()]
    plans = {"payload_48MiB": plan_channels(CH_PAYLOAD, model=model).row(),
             "roshambo_largest_layer": plan_channels(
                 largest_layer_bytes(cnn), model=model).row()}
    x = np.random.default_rng(0).standard_normal(CH_PAYLOAD // 4).astype(
        np.float32)
    policy = TransferPolicy.kernel_level_ring(4, block_bytes=1 << 20)
    transports = [("engine", TransferEngine(policy)),
                  ("group2", ChannelGroup(policy, n_channels=2)),
                  ("group4", ChannelGroup(policy, n_channels=4)),
                  ("planned", ChannelGroup.auto(CH_PAYLOAD, model=model))]
    out = torch.empty(CH_PAYLOAD, dtype=torch.uint8, pin_memory=True).numpy()
    times = {name: {"tx": [], "rx": []} for name, _ in transports}
    rows = []
    try:
        layouts = {name: eng.layouts.get("x", [x]) for name, eng in transports}
        pinned = {name: bool(torch.from_numpy(lay.staging).is_pinned())
                  for name, lay in layouts.items()}
        if not all(pinned.values()):
            fail(f"channels: staging not page-locked: {pinned}")
        for _ in range(CH_ROUNDS):
            for name, eng in transports:
                lay = layouts[name]
                t0 = time.perf_counter()
                chunks = eng.tx_async(lay.pack([x]), layout=lay).wait(60.0)
                t1 = time.perf_counter()
                out[:] = 0
                t2 = time.perf_counter()
                eng.rx(chunks, out=carve_flat_out(out, chunks))
                t3 = time.perf_counter()
                if not np.array_equal(out.view(np.float32), x):
                    fail(f"channels {name}: the 48 MiB round trip is not "
                         f"bitwise the payload")
                times[name]["tx"].append(t1 - t0)
                times[name]["rx"].append(t3 - t2)
        for name, eng in transports:
            row = {"transport": name, "tag": eng.policy.tag,
                   "n_channels": len(getattr(eng, "engines", [eng])),
                   "staging_pinned": pinned[name],
                   "channels": _channel_bytes(eng)}
            for d in ("tx", "rx"):
                ts = sorted(times[name][d])
                row[d] = {"best_ms": ts[0] * 1e3,
                          "median_ms": ts[len(ts) // 2] * 1e3,
                          "gbps_best": CH_PAYLOAD / ts[0] / 1e9,
                          "gbps_median": CH_PAYLOAD / ts[len(ts) // 2] / 1e9}
            rows.append(row)
    finally:
        for _, eng in transports:
            eng.close()
    print("channels " + json.dumps({
        "payload_bytes": CH_PAYLOAD, "rounds": CH_ROUNDS,
        "fit": {"t0_us": model.t0_s * 1e6, "gbps": model.bw_Bps / 1e9},
        "calibration": cal, "plans": plans, "transports": rows}))
    return model


def _mlp_block(torch, product, h, wi, wo):
    """One layer of the streamed MLP: a pre-norm gated MLP with a residual,
    its two products through ``product``."""
    import torch.nn.functional as F

    z = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True))
    gate, up = product(z, wi).chunk(2, dim=-1)
    return h + product((F.silu(gate) * up).contiguous(), wo)


def channels_stream_phase(np, torch, dev, libs, matmul_lib, model) -> int:
    """5c. the ``channels_stream`` line: the reference's weight-streaming
    scenario at its own size, 8 gated-MLP layers (d 1024, f 4096, f32: 48
    MiB of params a layer), a batch of 4 through ``HostStreamingExecutor``
    over one engine, a two-channel group and an adaptive group; each
    layer's two products through ``streamed_matmul``. In each transport's
    first run every product is held against the plain product of the same
    inputs; the output against the plain chain, bitwise equal across the
    transports. ``model``: the calibrated fit (plans the products' policy,
    seeds the adaptive group). Returns the matmul_blocks launches."""
    from repro_torch.core.adaptive import AdaptiveChannelGroup
    from repro_torch.core.channels import ChannelGroup, plan_channels
    from repro_torch.core.streaming import HostStreamingExecutor
    from repro_torch.core.transfer import TransferEngine, TransferPolicy
    from repro_torch.kernels.streamed_matmul.ops import streamed_matmul
    from repro_torch.kernels.streamed_matmul.ref import matmul_ref

    tol = MATMUL_TOL["float32"]
    rng = np.random.default_rng(0)
    d, f = STREAM_D, STREAM_F
    # N(0, 1/fan_in) weights behind an RMS norm, with a residual: every
    # product stays at unit scale (the reference benchmark's N(0, 0.02)
    # without either squares the scale each layer and reaches 0 in f32 by
    # layer 7), so a product that drops a K slice fails its check
    params = [[rng.standard_normal((d, 2 * f), dtype=np.float32)
               / np.float32(np.sqrt(d)),
               rng.standard_normal((f, d), dtype=np.float32)
               / np.float32(np.sqrt(f))]
              for _ in range(STREAM_LAYERS)]
    x = rng.standard_normal((STREAM_BATCH, d), dtype=np.float32)
    with torch.no_grad():
        y = torch.from_numpy(x).to(dev)
        for wi, wo in params:
            y = _mlp_block(torch, matmul_ref, y, torch.from_numpy(wi).to(dev),
                           torch.from_numpy(wo).to(dev))
        want = y.cpu()
        del y
    torch.cuda.empty_cache()

    # the products run under the policy the fit plans for a layer's 48
    # MiB (BLOCKS), on every transport alike: the transport moves bytes and
    # must not change a result, and an adaptive group may replan its own
    # policy mid-run
    mm_policy = plan_channels(STREAM_LAYER_BYTES, model=model).policy
    check = {"on": False, "products": 0, "max_abs_err": 0.0,
             "min_rms": float("inf")}

    def product(h, w):
        out = streamed_matmul(h, w, policy=mm_policy)
        if check["on"]:
            ref = matmul_ref(h, w)
            check["max_abs_err"] = max(check["max_abs_err"],
                                       max_err(torch, out, ref, tol))
            check["min_rms"] = min(check["min_rms"],
                                   float(ref.pow(2).mean().sqrt()))
            check["products"] += 1
        return out

    def apply_fn(dev_params, h):
        return _mlp_block(torch, product, h, *dev_params)

    layers = [(f"mlp{i}", p, apply_fn) for i, p in enumerate(params)]
    policy = TransferPolicy.kernel_level_ring(4, block_bytes=1 << 20)
    _zero(libs)
    rows, outs = [], {}
    for name, make in (
            ("engine", lambda: TransferEngine(policy)),
            ("group2", lambda: ChannelGroup(policy, n_channels=2)),
            ("adaptive", lambda: AdaptiveChannelGroup(STREAM_LAYER_BYTES,
                                                      model=model))):
        eng = make()
        try:
            ex = HostStreamingExecutor(eng)
            best = None
            for run in range(STREAM_RUNS):
                # the first run checks every product; the others are timed
                check["on"] = run == 0
                with torch.no_grad():
                    out, timing = ex.run(layers, x)
                if name in outs and not np.array_equal(out, outs[name]):
                    fail(f"channels_stream {name}: two runs differ")
                outs[name] = out
                if run and (best is None or timing.frame_s < best.frame_s):
                    best = timing
            check["on"] = False
            rows.append({
                "transport": name, "tag": eng.policy.tag,
                "plan": (eng.plan.row() if getattr(eng, "plan", None)
                         else None),
                "adapt": (eng.adapt_summary()
                          if hasattr(eng, "adapt_summary") else None),
                "frame_ms": best.frame_s * 1e3,
                "tx_ms": sum(l.tx_s for l in best.layers) * 1e3,
                "compute_ms": sum(l.compute_s for l in best.layers) * 1e3,
                "rx_ms": sum(l.rx_s for l in best.layers) * 1e3,
                "tx_gbps": (sum(l.tx_bytes for l in best.layers)
                            / sum(l.tx_s for l in best.layers) / 1e9),
                "layers_ms": [[l.name, l.tx_s * 1e3, l.compute_s * 1e3,
                               l.rx_s * 1e3] for l in best.layers],
                "channels": _channel_bytes(eng)})
        finally:
            eng.close()
    torch.cuda.synchronize()
    launches = dict(matmul_lib.launches)
    expect = 2 * STREAM_LAYERS * STREAM_RUNS * len(rows)
    if launches != {"matmul_blocks": expect, "matmul_unique": 0}:
        fail(f"channels_stream: matmul launches {launches}, expected "
             f"{expect} of matmul_blocks (compute policy {mm_policy.tag})")
    if check["products"] != 2 * STREAM_LAYERS * len(rows):
        fail(f"channels_stream: {check['products']} products checked")
    # a product at the scale of atol would pass any kernel
    if check["min_rms"] < STREAM_MIN_RMS:
        fail(f"channels_stream: a product's RMS {check['min_rms']} < "
             f"{STREAM_MIN_RMS}: the check cannot fail a wrong kernel")
    got = torch.from_numpy(outs["engine"])
    err = max_err(torch, got, want, tol)
    out_rms = float(got.pow(2).mean().sqrt())
    if out_rms < STREAM_MIN_RMS:
        fail(f"channels_stream: output RMS {out_rms} < {STREAM_MIN_RMS}")
    for name, out in outs.items():
        if not np.array_equal(out, outs["engine"]):
            fail(f"channels_stream: the {name} transport changed the "
                 f"output (not bitwise the single engine's)")
    print("channels_stream " + json.dumps({
        "layers": STREAM_LAYERS, "d": d, "f": f, "batch": STREAM_BATCH,
        "layer_bytes": STREAM_LAYER_BYTES, "runs": STREAM_RUNS,
        "compute_policy": mm_policy.tag,
        "compute_block_bytes": mm_policy.block_bytes,
        "products_checked": check["products"],
        "max_abs_err_products": check["max_abs_err"],
        "min_product_rms": check["min_rms"],
        "max_abs_err_vs_plain": err, "output_rms": out_rms, "tol": tol,
        "bitwise_across_transports": True, "transports": rows,
        "launches": {lib.name: dict(lib.launches) for lib in libs}}))
    return launches["matmul_blocks"]


def channels_frame_phase(np, torch, libs, conv_lib, cnn, params, frames,
                         oracle) -> int:
    """5d. the ``channels_frame`` line: RoShamBo frames through
    ``HostStreamingExecutor`` over a two-channel group and an adaptive
    group, built as ``NullHopExecutor.run_frame`` builds them: 5 conv
    launches a frame, logits bitwise the single engine's frame and within
    ``LOGIT_TOL`` of ``RoShamBoCNN.apply``; the payloads are sub-stripe,
    so each channel's descriptor count shows both carried traffic.
    Returns the conv launches."""
    from repro_torch.accel.nullhop import NullHopExecutor, _run_frame
    from repro_torch.core.adaptive import AdaptiveChannelGroup
    from repro_torch.core.channels import ChannelGroup
    from repro_torch.core.streaming import HostStreamingExecutor
    from repro_torch.core.transfer import TransferPolicy

    sym = "conv2d_bias_act"
    largest = largest_layer_bytes(cnn)
    _zero(libs)
    single = NullHopExecutor(cnn, TransferPolicy.kernel_level_ring())
    try:
        ref = [single.run_frame(params, f).logits for f in frames]
    finally:
        single.close()
    rows = []
    for name, make in (
            ("group2", lambda: ChannelGroup(TransferPolicy.kernel_level_ring(),
                                            n_channels=2)),
            ("adaptive", lambda: AdaptiveChannelGroup(largest))):
        eng = make()
        host = {}

        def host_array(key, t):
            if key not in host:
                host[key] = t.detach().cpu().numpy()
            return host[key]

        try:
            streamer = HostStreamingExecutor(eng)
            best = None
            for i, frame in enumerate(frames):
                before = conv_lib.launches[sym]
                res = _run_frame(cnn, streamer, params, frame, host_array,
                                 eng.policy.tag)
                step = conv_lib.launches[sym] - before
                if step != 5:
                    fail(f"channels_frame {name}: {step} conv launches in "
                         f"a frame, expected 5")
                if not np.array_equal(res.logits, ref[i]):
                    fail(f"channels_frame {name}: logits not bitwise the "
                         f"single engine's frame")
                np.testing.assert_allclose(res.logits, oracle[i],
                                           rtol=LOGIT_TOL[0],
                                           atol=LOGIT_TOL[1])
                if i and (best is None or res.timing.frame_s < best.frame_s):
                    best = res.timing
            chans = _channel_bytes(eng)
            if name == "group2" and min(c["descriptors"] for c in chans) == 0:
                fail(f"channels_frame: a channel carried nothing: {chans}")
            rows.append({"transport": name, "tag": eng.policy.tag,
                         "plan": (eng.plan.row()
                                  if getattr(eng, "plan", None) else None),
                         "frame_ms": best.frame_s * 1e3,
                         "tx_us_per_B": best.tx_us_per_byte,
                         "rx_us_per_B": best.rx_us_per_byte,
                         "channels": chans})
        finally:
            eng.close()
    torch.cuda.synchronize()
    launches = dict(conv_lib.launches)
    if launches[sym] != 5 * len(frames) * 3:
        fail(f"channels_frame: conv launches {launches}")
    print("channels_frame " + json.dumps({
        "frames": len(frames), "largest_layer_bytes": largest,
        "transports": rows,
        "launches": {lib.name: dict(lib.launches) for lib in libs}}))
    return launches[sym]


def faults_phase(np) -> None:
    """5e. the ``faults`` line: a seeded ``FaultInjector`` over card
    engines, three channels, crc32 on every RX; the 48 MiB payload TX and
    RX under a dropped TX stripe, a corrupted RX stripe and a manual stall
    of channel 1: exact bytes throughout, each fault retried on a sibling,
    the stalled channel quarantined by the drift check and back after the
    stall lifts and a probe runs at a healthy rate."""
    import dataclasses

    from repro_torch.core.channels import ChannelGroup
    from repro_torch.core.faults import (
        FaultInjector, FaultPlan, FaultSpec, RecoveryConfig)
    from repro_torch.core.transfer import TransferPolicy

    inj = FaultInjector(FaultPlan(seed=0, specs=(
        FaultSpec(kind="drop", p=1.0, channel=0, direction="tx",
                  hold_s=0.0, max_injections=1),
        FaultSpec(kind="corrupt", p=1.0, channel=0, max_injections=1))))
    policy = dataclasses.replace(
        TransferPolicy.kernel_level_ring(4, block_bytes=1 << 20),
        checksum=True)
    recovery = RecoveryConfig(stripe_timeout_s=30.0, probe_interval_s=0.0)
    g = ChannelGroup(policy, n_channels=3, engine_factory=inj.engine_factory(),
                     recovery=recovery)
    x = np.random.default_rng(1).integers(0, 256, CH_PAYLOAD, dtype=np.uint8)
    steps = []

    def round_trip(what):
        t0 = time.perf_counter()
        chunks = g.tx(x)
        t1 = time.perf_counter()
        back = np.concatenate([np.asarray(h).reshape(-1)
                               for h in g.rx(chunks)])
        t2 = time.perf_counter()
        if not np.array_equal(back, x):
            fail(f"faults: {what}: the round trip is not bitwise the payload")
        steps.append({"step": what, "tx_ms": (t1 - t0) * 1e3,
                      "rx_ms": (t2 - t1) * 1e3,
                      "quarantined": sorted(g.quarantined)})

    try:
        round_trip("drop (tx) + corrupt (rx) on channel 0")
        # the pass that quarantines a channel also probes it: one 64 KiB
        # descriptor on the stalled channel raced against the same one on
        # a sibling, kept out only at drift_quarantine_ratio (4) times the
        # sibling's. Both read host clocks, and a sibling's descriptor takes
        # ~1 ms on a quiet host but a scheduler quantum or more on a loaded
        # one, so a fixed 20 ms stall let the channel rejoin at once. The
        # stall is set from the healthy time measured here.
        probe = np.zeros(recovery.probe_bytes, np.uint8)
        healthy = []
        for _ in range(8):
            t0 = time.perf_counter()
            g.engines[0].tx_async(probe).wait(30.0)
            healthy.append(time.perf_counter() - t0)
        stall_s = max(FAULT_STALL_MIN_S, FAULT_STALL_X * max(healthy))
        inj.stall(1, on=True, stall_s=stall_s)
        stalled_tx = 0
        while (not g.fault_state.summary()["quarantines"]
               and stalled_tx < 10):
            g.tx(x)
            stalled_tx += 1
            g.check_channel_health()
        if g.quarantined != {1}:
            fail(f"faults: the stalled channel 1 was not quarantined after "
                 f"{stalled_tx} transfers: {sorted(g.quarantined)} "
                 f"({g.fault_state.summary()['quarantines']} quarantines; "
                 f"healthy probes {healthy} s, stall {stall_s} s)")
        steps.append({"step": "stall channel 1", "stalled_tx": stalled_tx,
                      "quarantined": sorted(g.quarantined)})
        round_trip("channel 1 quarantined")
        inj.stall(1, on=False)
        probes = 0
        while g.quarantined and probes < 10:
            g.check_channel_health()
            probes += 1
        if g.quarantined:
            fail(f"faults: channel 1 stayed quarantined after {probes} "
                 f"probes with the stall lifted")
        steps.append({"step": "stall lifted", "probes": probes,
                      "quarantined": sorted(g.quarantined)})
        round_trip("all channels back")
        summary = g.fault_summary()
    finally:
        g.close()
    s = summary["faults"]
    if not (s["retries"] > 0 and s["retry_successes"] == s["retries"]
            and s["checksum_failures"] >= 1 and s["quarantines"] == 1
            and s["unquarantines"] == 1):
        fail(f"faults: counters {s}")
    print("faults " + json.dumps({
        "payload_bytes": CH_PAYLOAD, "n_channels": 3, "tag": policy.tag,
        "healthy_probe_s": healthy, "stall_s": stall_s,
        "steps": steps, "summary": summary,
        "events": [list(e) for e in inj.events]}))


def stress_phase(dev) -> None:
    """5f. the ``stress`` line: the port's concurrency analyzer over
    ``src`` against the checked-in baseline (in this process, which has no
    jax: exit 0, no new finding), then the reference's five stress hammers
    on card engines and the card's consumer-stream hammer (a bare engine,
    and a striped two-channel group) under validated locks: no mismatch,
    no lock-order violation. A hammer's failed check raises."""
    from repro_torch.analysis import (
        extract_package, load_baseline, run_rules, split_new)
    from repro_torch.analysis import stress
    from repro_torch.analysis.cli import main as analyze

    t0 = time.perf_counter()
    baseline = ROOT / "analysis_baseline.json"
    rc = analyze([str(ROOT / "src"), "--baseline", str(baseline),
                  "--fail-on-new", "-q"])
    if rc != 0:
        fail(f"stress: python -m repro_torch.analysis exited {rc}")
    loaded = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith(("jax.", "repro.")) or m == "repro")
    if loaded:
        fail(f"stress: the port loaded {loaded}")
    pkg = extract_package(ROOT / "src")
    findings = run_rules(pkg)
    new, old = split_new(findings, load_baseline(baseline))
    analysis = {
        "modules": len(pkg.modules),
        "skipped": sum(m.skipped for m in pkg.modules.values()),
        "lock_classes": sum(len(c.locks) for c in pkg.all_classes())
        + sum(len(m.module_locks) for m in pkg.modules.values()),
        "new": len(new), "baselined": len(old),
        "waived": sum(f.waived for f in findings)}
    if new:
        fail(f"stress: {len(new)} new analyzer findings")

    hammers = {}
    with stress.validated_locks() as graph:
        for hammer in stress.HAMMERS:
            hammers[hammer.__name__] = hammer(stress.port_stack(dev)).row()
        for case in stress.CONSUMER_CASES:
            got = stress.consumer_streams(stress.port_stack(dev), *case)
            hammers[got.name] = got.row()
        violations = list(graph.violations)
        edges = sum(len(v) for v in graph.edges().values())
    mismatches = sum(r.get("mismatches", 0) for r in hammers.values())
    if mismatches or violations:
        fail(f"stress: {mismatches} mismatches, lock-order violations "
             f"{violations}")
    print(json.dumps({"stress": {
        "analysis": analysis, "hammers": hammers, "mismatches": mismatches,
        "lock_order_violations": len(violations), "order_graph_edges": edges,
        "seconds": time.perf_counter() - t0, "card": card_line()}}))


def lm_paths(np, torch, dev, libs, flash_lib):
    """7. the LM scoring path and 8. the serving path, qwen2.5-3b at full
    width; each driven with every launch count set to 0 just before it and
    read just after. Returns the scoring path's flash launches, by C
    symbol (f32: CUDA cores, bf16: tensor cores)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeConfig

    from repro_torch.kernels.flash_attention.kernel import SYMBOL

    cfg = get_config("qwen2.5-3b", dtype="float32")
    t0 = time.perf_counter()
    # drawn on the card by a CUDA generator (Philox) seeded with 0: 3.4e9
    # normal draws on the host's CPU would take minutes
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    seq = rng.integers(0, cfg.vocab, (LM_BATCH, LM_SEQ + 1), dtype=np.int64)
    batch = {"tokens": torch.from_numpy(seq[:, :-1]).to(dev),
             "labels": torch.from_numpy(seq[:, 1:]).to(dev)}
    flash_m = {dt: build_model(cfg.replace(dtype=dt, use_pallas_attention=True))
               for dt in ("float32", "bfloat16")}
    plain_m = {dt: build_model(cfg.replace(dtype=dt))
               for dt in ("float32", "bfloat16")}

    def flash_run(fn, dtype):
        """One forward through the flash kernel of ``dtype``'s route (f32:
        CUDA cores, bf16: tensor cores): one launch a layer."""
        return launched(torch, flash_lib, SYMBOL[getattr(torch, dtype)],
                        cfg.n_layers, fn, f"one {cfg.name} {dtype} forward")

    score = {"model": cfg.name, "params": cfg.param_count(),
             "batch": LM_BATCH, "seq": LM_SEQ, "init_s": init_s}
    _zero(libs)
    with torch.no_grad():
        lf, _ = flash_run(lambda: flash_m["float32"].forward(params, batch),
                          "float32")
        lp, _ = plain_m["float32"].forward(params, batch)
        torch.cuda.synchronize()
        want = (LM_BATCH, LM_SEQ, cfg.vocab_padded)
        if tuple(lf.shape) != want or not bool(torch.isfinite(lf).all()):
            fail(f"LM logits {tuple(lf.shape)} (want {want}) or not finite")
        err = float((lf - lp).abs().max())
        score["f32"] = {"max_abs_err": err, "atol": LM_LOGIT_ATOL,
                        "logit_absmax": float(lp.abs().max())}
        if err > LM_LOGIT_ATOL:
            fail(f"f32 logits, flash vs plain attention: max abs err {err} "
                 f"> atol {LM_LOGIT_ATOL}")
        del lf, lp
        score["f32"]["loss_flash"] = float(flash_run(
            lambda: flash_m["float32"].loss(params, batch), "float32")[0])
        score["f32"]["loss_plain"] = float(
            plain_m["float32"].loss(params, batch)[0])
        params16 = _cast_weights(params, torch.bfloat16)
        del params
        torch.cuda.empty_cache()
        lfl = float(flash_run(lambda: flash_m["bfloat16"].loss(
            params16, batch), "bfloat16")[0])
        hx, hw, hk = head_kernels(torch, cfg, flash_m["bfloat16"], params16,
                                  batch)
        lpl = float(plain_m["bfloat16"].loss(params16, batch)[0])
        if not (np.isfinite(lfl) and np.isfinite(lpl)):
            fail(f"bf16 losses not finite: {lfl}, {lpl}")
        score["bf16"] = {
            "loss_flash": lfl, "loss_plain": lpl,
            "forward_ms_flash": wall_ms(torch, lambda: flash_run(
                lambda: flash_m["bfloat16"].forward(params16, batch),
                "bfloat16")),
            "forward_ms_plain": wall_ms(
                torch, lambda: plain_m["bfloat16"].forward(params16, batch)),
            "profile_flash_forward": device_profile(torch, lambda: flash_run(
                lambda: flash_m["bfloat16"].forward(params16, batch),
                "bfloat16"), match="flash_fwd_tc", names=set(hk))}
        prof = score["bf16"]["profile_flash_forward"]["match"]
        score["bf16"]["flash_device_ms"] = prof["device_ms"]
        if prof["launches"] != cfg.n_layers:
            fail(f"profiled bf16 forward: {prof['launches']} tensor-core "
                 f"flash kernels in the trace, expected {cfg.n_layers}")
        score["bf16"]["head"] = head_entry(
            torch, hx, hw, hk,
            score["bf16"]["profile_flash_forward"].pop("matched", {}))
        del hx
    torch.cuda.synchronize()
    lm_launches = dict(flash_lib.launches)
    score["launches"] = {lib.name: dict(lib.launches) for lib in libs}
    score["forwards_through_flash"] = {
        s: n // cfg.n_layers for s, n in lm_launches.items()}
    if min(lm_launches.values()) == 0:
        fail(f"the LM scoring path skipped a flash kernel: {lm_launches}")
    print("lm_score " + json.dumps(score))

    # 8. serving, bf16, the reference's default config (its decode steps
    # read the KV cache, so they never reach the flash kernel)
    model = plain_m["bfloat16"]
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           dtype=np.int32)
    scfg = ServeConfig(max_batch=SERVE_BATCH,
                       max_seq=SERVE_PROMPT + SERVE_NEW + 8)
    _zero(libs)
    rows, first = serve_runs(np, model, params16, scfg, prompts, SERVE_NEW,
                             SERVE_POLICIES, cfg.vocab)
    # where a decode step's time goes: one step after a prefill of the
    # same prompts, under the profiler
    with torch.no_grad():
        tok = torch.from_numpy(prompts).to(dev)
        _, cache = model.prefill(params16, {"tokens": tok}, scfg.max_seq)
        step = device_profile(torch, lambda: model.decode(
            params16, tok[:, -1:], cache))
    print("lm_serve " + json.dumps({
        "model": cfg.name, "dtype": "bfloat16", "batch": SERVE_BATCH,
        "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW, "runs": rows,
        "tokens_head": first[:, :8].tolist(), "profile_decode_step": step,
        "launches": {lib.name: dict(lib.launches) for lib in libs}}))
    del params16
    torch.cuda.empty_cache()
    return lm_launches


def ssd_inputs(torch, dev, dtype, b, s, h, p, g, n, gen):
    """The model's distributions: x, B, C cut out of one projection-like
    [B, S, H*P + 2*G*N] tensor (strided views, as the model passes them),
    B and C scaled so that C.B is ~unit; dt = softplus(randn + dt_bias); A
    from -1 to -16 over the heads, as ``a_log`` gives it."""
    xbc = torch.randn((b, s, h * p + 2 * g * n), generator=gen)
    xbc[..., h * p:] *= n ** -0.25
    xbc = xbc.to(dev, dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen) + math.log(math.e - 1)).to(dev)
    a = -torch.linspace(1.0, 16.0, h).to(dev)
    return (xbc[..., :h * p].reshape(b, s, h, p), dt, a,
            xbc[..., h * p:h * p + g * n].reshape(b, s, g, n),
            xbc[..., h * p + g * n:].reshape(b, s, g, n))


def ssd_cases(np, torch, dev, gen) -> dict:
    """9. the SSD kernels against their plain versions; returns max |d|
    per dtype (y_diag, states, decay together) and of the state pass."""
    from repro_torch.kernels.ssd_scan.kernel import SSD
    from repro_torch.kernels.ssd_scan.ops import (
        ssd_full, ssd_intra_chunk, ssd_state_pass)
    from repro_torch.models.layers.ssm import ssd_chunked

    rows, bad, errs = [], [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dt_name = str(dtype).split(".")[1]
        tol = SSD_TOL[dt_name]
        for case in SSD_CASES:
            b, s, h, p, g, n, q = case
            args = ssd_inputs(torch, dev, dtype, b, s, h, p, g, n, gen)
            got = ssd_intra_chunk(*args, chunk=q)
            ref = ssd_intra_chunk(*args, chunk=q, use_kernel=False)
            torch.cuda.synchronize()
            row = {"dtype": dt_name, "case": list(case)}
            for name, gt, rt in zip(("y_diag", "states", "decay"), got, ref):
                if gt.dtype != torch.float32 or gt.shape != rt.shape:
                    fail(f"ssd {case} {name}: {gt.dtype} {tuple(gt.shape)}")
                ok, err, excess = rms_close(torch, gt, rt, tol,
                                            SSD_BF16_ATOL_ROW_RMS)
                if not ok:
                    bad.append((dt_name, case, name))
                row[name] = {"max_abs_err": err,
                             "max_excess_over_row_rms": excess}
                errs[dt_name] = max(errs.get(dt_name, 0.0), err)
            rows.append(row)
            del got, ref, args
    # the state pass against its loop, bitwise, on the bf16 kernel's own
    # outputs at mamba2-780m's shape, from zeros and from a random state
    b, s, h, p, g, n, q = SSD_CASES[0]
    args = ssd_inputs(torch, dev, torch.bfloat16, b, s, h, p, g, n, gen)
    _, st, dec = ssd_intra_chunk(*args, chunk=q)
    init = torch.randn((b, h, p, n), generator=gen).to(dev)
    passes = {}
    for name, i0 in (("zeros", None), ("initial_state", init)):
        got = launched(torch, SSD, "ssd_state_pass", 1,
                       lambda: ssd_state_pass(st, dec, i0),
                       f"state pass from {name}")
        ref = ssd_state_pass(st, dec, i0, use_kernel=False)
        same = all(torch.equal(gt, rt) for gt, rt in zip(got, ref))
        err = max(float((gt - rt).abs().max()) for gt, rt in zip(got, ref))
        passes[name] = {"bitwise_equal": same, "max_abs_err": err}
        errs["state_pass"] = max(errs.get("state_pass", 0.0), err)
        if not same:
            bad.append(("float32", SSD_CASES[0], f"state pass from {name}"))
    del args, st, dec, init, got, ref
    # the full SSD through the kernel against the plain ssd_chunked, f32,
    # at mamba2-780m's shape and from a nonzero state
    args = ssd_inputs(torch, dev, torch.float32, b, s, h, p, g, n, gen)
    init = torch.randn((b, h, p, n), generator=gen).to(dev)
    y1, f1 = ssd_full(*args, chunk=q, initial_state=init)
    y2, f2 = ssd_chunked(*args, chunk=q, initial_state=init,
                         return_final_state=True)
    full = {}
    for name, gt, rt in (("y", y1, y2), ("final_state", f1, f2)):
        ok, err, _ = rms_close(torch, gt, rt, SSD_TOL["float32"], None)
        full[name] = err
        if not ok:
            bad.append(("float32", SSD_CASES[0], f"ssd_full {name}"))
    print("ssd_cases " + json.dumps({"cases": rows,
                                     "state_pass_vs_loop": passes,
                                     "ssd_full_vs_ssd_chunked": full}))
    if bad:
        fail(f"ssd kernel disagrees with its plain version in {bad} (tol "
             f"{SSD_TOL}, bf16 atol {SSD_BF16_ATOL_ROW_RMS} x the row's RMS)")
    return errs


def prefill_vs_recurrence(np, torch, model, params, dev, ssd_lib) -> dict:
    """f32: prefill of 2 x SSM_PREFILL tokens (through the SSD kernel)
    against as many decode steps from the zero state (the recurrence; no
    kernel launch): last logits, SSM states, conv tails and, for the
    hybrid, the shared block's K/V."""
    sym = SSD_SYMS
    cfg = model.cfg
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, SSM_PREFILL))).to(dev)
    s_max = SSM_PREFILL + 8
    with torch.no_grad():
        last, cache = launched(
            torch, ssd_lib, sym, cfg.n_layers,
            lambda: model.prefill(params, {"tokens": tok}, s_max),
            f"{cfg.name} prefill")
        rec = model.init_cache(2, s_max, device=dev)

        def recurrence():
            nonlocal rec
            for t in range(SSM_PREFILL):
                step, rec = model.decode(params, tok[:, t:t + 1], rec)
            return step

        t0 = time.perf_counter()
        step = launched(torch, ssd_lib, sym, 0, recurrence,
                        f"{cfg.name} decode recurrence")
        decode_s = time.perf_counter() - t0
    pairs = [("logits", last, step)]
    if isinstance(cache, list):  # the hybrid: per group
        for gi, (c, r) in enumerate(zip(cache, rec)):
            pairs += [(f"ssm{gi}", c["ssm"].ssm, r["ssm"].ssm),
                      (f"conv{gi}", c["ssm"].conv, r["ssm"].conv),
                      (f"k{gi}", c["kv"].k, r["kv"].k),
                      (f"v{gi}", c["kv"].v, r["kv"].v)]
    else:
        pairs += [("ssm", cache.ssm, rec.ssm), ("conv", cache.conv, rec.conv)]
    out = {"tokens": SSM_PREFILL, "decode_steps_s": decode_s,
           "logit_atol": SSM_LOGIT_ATOL, "state_rel": SSM_STATE_REL}
    worst = {"ssm": 0.0, "conv": 0.0, "k": 0.0, "v": 0.0}
    for name, got, ref in pairs:
        if not bool(torch.isfinite(got).all()):
            fail(f"{cfg.name} prefill {name} not finite")
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if name == "logits":
            out["logits"] = {"max_abs_err": err, "absmax": scale}
            limit = SSM_LOGIT_ATOL
        else:
            key = name.rstrip("0123456789")
            worst[key] = max(worst[key], err / max(scale, 1e-30))
            limit = SSM_STATE_REL * scale
        if err > limit:
            fail(f"{cfg.name}: prefill vs recurrence, {name}: max abs err "
                 f"{err} > {limit}")
    out["max_err_over_absmax"] = {k: v for k, v in worst.items() if v}
    return out


def ssm_paths(np, torch, dev, libs, ssd_lib):
    """10.-12. mamba2-780m scoring and serving (11b: over channel groups),
    zamba2-1.2b, at full width; each path driven with every launch count
    set to 0 just before it and read just after. Returns the mamba2
    scoring path's launches of each SSD symbol, each SSD kernel's mean
    device ms a launch in its profiled bf16 forward (None where the trace
    held none), and the launches of the channel-group serving path."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeConfig

    sym = SSD_SYMS  # each launched once a mamba layer a forward

    def launches():
        return {lib.name: dict(lib.launches) for lib in libs}

    def one_forward(cfg, fn):
        """One forward through the SSD kernels: one launch of each a mamba
        layer."""
        return launched(torch, ssd_lib, sym, cfg.n_layers, fn,
                        f"one {cfg.name} forward")

    rng = np.random.default_rng(0)

    def tokens(vocab):
        seq = rng.integers(0, vocab, (LM_BATCH, LM_SEQ + 1), dtype=np.int64)
        return {"tokens": torch.from_numpy(seq[:, :-1]).to(dev),
                "labels": torch.from_numpy(seq[:, 1:]).to(dev)}

    # 10. mamba2-780m scoring
    cfg = get_config("mamba2-780m", dtype="float32")
    batch = tokens(cfg.vocab)
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    score = {"model": cfg.name, "params": cfg.param_count(),
             "batch": LM_BATCH, "seq": LM_SEQ,
             "init_s": time.perf_counter() - t0}
    _zero(libs)
    m32 = build_model(cfg)
    score["f32_prefill_vs_recurrence"] = prefill_vs_recurrence(
        np, torch, m32, params, dev, ssd_lib)
    m16 = build_model(cfg.replace(dtype="bfloat16"))
    with torch.no_grad():
        lf = one_forward(cfg, lambda: m32.loss(params, batch))
        score["f32_loss"] = float(lf[0])
        params16 = _cast_weights(params, torch.bfloat16)
        del params
        torch.cuda.empty_cache()
        l16 = float(one_forward(cfg, lambda: m16.loss(params16, batch))[0])
        logits = one_forward(cfg, lambda: m16.forward(params16, batch))[0]
        want = (LM_BATCH, LM_SEQ, cfg.vocab_padded)
        if (tuple(logits.shape) != want or logits.dtype != torch.float32
                or not bool(torch.isfinite(logits).all())
                or not np.isfinite(l16)):
            fail(f"{cfg.name} bf16 logits {tuple(logits.shape)} (want "
                 f"{want}) or loss {l16} not finite")
        del logits
        score["bf16"] = {
            "loss": l16,
            "forward_ms": wall_ms(torch, lambda: one_forward(
                cfg, lambda: m16.forward(params16, batch))),
            "profile_forward": device_profile(torch, lambda: one_forward(
                cfg, lambda: m16.forward(params16, batch)),
                match=SSD_KERNEL_NAMES)}
    torch.cuda.synchronize()
    ssd_launches = dict(ssd_lib.launches)
    score["launches"] = launches()
    score["forwards_through_ssd"] = {
        s: n // cfg.n_layers for s, n in ssd_launches.items()}
    if min(ssd_launches.values()) == 0:
        fail("the SSM scoring path never launched the SSD kernel")
    ssd_dev = {m["name"]: m["device_ms"] / m["launches"] if m["launches"]
               else None
               for m in score["bf16"]["profile_forward"]["match"]}
    print("ssm_score " + json.dumps(score))

    # 11. mamba2-780m serving, bf16: prefill runs the SSD kernel, decode
    # steps the recurrence
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SSM_SERVE_PROMPT),
                           dtype=np.int32)
    scfg = ServeConfig(max_batch=SERVE_BATCH,
                       max_seq=SSM_SERVE_PROMPT + SERVE_NEW + 8)
    _zero(libs)
    rows, first = launched(
        torch, ssd_lib, sym, cfg.n_layers * 2 * len(SERVE_POLICIES),
        lambda: serve_runs(np, m16, params16, scfg, prompts, SERVE_NEW,
                           SERVE_POLICIES, cfg.vocab),
        f"{cfg.name} serving (one launch a layer a prefill)")
    serve_launches = launches()
    with torch.no_grad():
        tok = torch.from_numpy(prompts).to(dev)
        _, cache = m16.prefill(params16, {"tokens": tok}, scfg.max_seq)
        step = device_profile(torch, lambda: m16.decode(
            params16, tok[:, -1:], cache))
    print("ssm_serve " + json.dumps({
        "model": cfg.name, "dtype": "bfloat16", "batch": SERVE_BATCH,
        "prompt": SSM_SERVE_PROMPT, "new_tokens": SERVE_NEW, "runs": rows,
        "tokens_head": first[:, :8].tolist(), "profile_decode_step": step,
        "launches": serve_launches}))
    del cache

    # 11b. the same serving over channel groups: striped, calibrated and
    # online-adapted token transfer, then a second online engine that
    # warm-starts from the first one's state file
    _zero(libs)
    rows = launched(
        torch, ssd_lib, sym, cfg.n_layers * len(SERVE_CHANNEL_SETTINGS),
        lambda: serve_channel_runs(np, m16, params16, prompts, first,
                                   cfg.vocab),
        f"{cfg.name} serving over channel groups")
    print("ssm_serve_channels " + json.dumps({
        "model": cfg.name, "dtype": "bfloat16", "batch": SERVE_BATCH,
        "prompt": SSM_SERVE_PROMPT, "new_tokens": SERVE_NEW,
        "tokens_identical_to_ssm_serve": True, "engines": rows,
        "launches": launches()}))
    serve_channel_launches = dict(ssd_lib.launches)
    del params16
    torch.cuda.empty_cache()

    # 12. zamba2-1.2b
    cfg = get_config("zamba2-1.2b", dtype="float32")
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0), dev)
    hyb = {"model": cfg.name, "params": cfg.param_count()}
    _zero(libs)
    m32 = build_model(cfg)
    hyb["f32_prefill_vs_recurrence"] = prefill_vs_recurrence(
        np, torch, m32, params, dev, ssd_lib)
    params16 = _cast_weights(params, torch.bfloat16)
    del params
    torch.cuda.empty_cache()
    m16 = build_model(cfg.replace(dtype="bfloat16"))
    hbatch = tokens(cfg.vocab)
    with torch.no_grad():
        l16 = float(one_forward(cfg, lambda: m16.loss(params16, hbatch))[0])
        if not np.isfinite(l16):
            fail(f"{cfg.name} bf16 loss {l16}")
        hyb["bf16"] = {"loss": l16, "batch": LM_BATCH, "seq": LM_SEQ,
                       "forward_ms": wall_ms(torch, lambda: one_forward(
                           cfg, lambda: m16.forward(params16, hbatch))),
                       "profile_forward": device_profile(
                           torch, lambda: one_forward(
                               cfg, lambda: m16.forward(params16, hbatch)),
                           match=SSD_KERNEL_NAMES)}
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SSM_SERVE_PROMPT),
                           dtype=np.int32)
    rows, first = serve_runs(np, m16, params16, scfg, prompts, SERVE_NEW,
                             SERVE_POLICIES[:1], cfg.vocab)
    hyb["serve"] = {"dtype": "bfloat16", "batch": SERVE_BATCH,
                    "prompt": SSM_SERVE_PROMPT, "new_tokens": SERVE_NEW,
                    "runs": rows, "tokens_head": first[:, :8].tolist()}
    hyb["launches"] = launches()
    print("hybrid " + json.dumps(hyb))
    del params16
    torch.cuda.empty_cache()
    return ssd_launches, ssd_dev, serve_channel_launches


class MoERecorder:
    """Wraps the moe layer that ``models/lm.py`` calls, while entered, and
    keeps each call's dropped fraction (a device tensor, read after the
    run); with ``routing``, each token's top-(k+1) router probabilities
    and experts in rank order (an extra router product a layer, outside
    the layer); with ``keep_input``, the first call's input."""

    def __init__(self, torch, routing: bool = False,
                 keep_input: bool = False):
        self.torch, self.routing, self.keep_input = torch, routing, keep_input
        self.dropped, self.ranked, self.probs = [], [], []
        self.first_input = None

    def __enter__(self):
        from repro_torch.models import lm

        torch, orig = self.torch, lm.moe_apply
        self._lm, self._orig = lm, orig

        def recording(p, x, *, top_k, **kw):
            if self.keep_input and self.first_input is None:
                self.first_input = x.detach().clone()
            out, metrics = orig(p, x, top_k=top_k, **kw)
            self.dropped.append(metrics.dropped_frac)
            if self.routing:
                probs = torch.softmax(
                    x.reshape(-1, x.shape[-1]).float() @ p["router"], -1)
                top = torch.topk(probs, top_k + 1, dim=-1)
                self.ranked.append(top.indices)
                self.probs.append(top.values)
            return out, metrics

        lm.moe_apply = recording
        return self

    def __exit__(self, *exc):
        self._lm.moe_apply = self._orig

    def dropped_fracs(self) -> list[float]:
        return [float(d) for d in self.dropped]

    def routing_against(self, other) -> dict:
        """Layer by layer, the tokens whose top-k expert set differs from
        ``other``'s, those whose experts are ranked in another order (the
        seat order, which decides who is dropped at capacity), and the
        layers whose dropped fraction differs; for the first layer where a
        token moved, the least gap, in this recording, between two
        adjacent router probabilities of the tokens that moved (the
        near-tie the other run broke the other way)."""
        k = self.ranked[0].shape[-1] - 1
        sets = [int((a[:, :k].sort(-1).values != b[:, :k].sort(-1).values)
                    .any(-1).sum()) for a, b in zip(self.ranked, other.ranked)]
        order = [int((a[:, :k] != b[:, :k]).any(-1).sum())
                 for a, b in zip(self.ranked, other.ranked)]
        mine, theirs = self.dropped_fracs(), other.dropped_fracs()
        out = {"set_changed_by_layer": sets, "order_changed_by_layer": order,
               "dropped_frac_differs_in_layers": [
                   i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b]}
        first = next((i for i, n in enumerate(order) if n), None)
        if first is not None:
            a, b = self.ranked[first], other.ranked[first]
            moved = (a[:, :k] != b[:, :k]).any(-1)
            gaps = self.probs[first][moved, :-1] - self.probs[first][moved, 1:]
            out["first_layer_moved"] = first
            out["least_adjacent_gap_of_moved"] = float(gaps.min())
        # each token whose expert set changed: the first layer where it
        # did, and there the gap between its k-th and (k+1)-th router
        # probability in this recording and in ``other``'s
        rerouted = {}
        for i, (a, b) in enumerate(zip(self.ranked, other.ranked)):
            changed = (a[:, :k].sort(-1).values
                       != b[:, :k].sort(-1).values).any(-1)
            for t in changed.nonzero().flatten().tolist():
                if t not in rerouted:
                    p, q = self.probs[i][t], other.probs[i][t]
                    rerouted[t] = [i, float(p[k - 1] - p[k]),
                                   float(q[k - 1] - q[k])]
        out["rerouted_tokens"] = rerouted
        return out


def moe_paths(np, torch, dev, libs, flash_lib):
    """12b. the moe scoring path: granite-moe-1b-a400m at full width (f32
    flash against plain attention, one layer on the card against the CPU,
    bf16 loss / aux / dropped fraction / wall time / a profiled forward),
    then deepseek-moe-16b in bf16; driven with every launch count set to 0
    just before and read just after (a ``moe`` line). Returns the path's
    flash launches by symbol."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention.kernel import SYMBOL
    from repro_torch.models.api import build_model
    from repro_torch.models.layers.moe import moe_apply

    t_phase = time.perf_counter()
    cfg = get_config("granite-moe-1b-a400m", dtype="float32")
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)

    def tokens(vocab, b):
        seq = rng.integers(0, vocab, (b, MOE_SEQ + 1), dtype=np.int64)
        return {"tokens": torch.from_numpy(seq[:, :-1]).to(dev),
                "labels": torch.from_numpy(seq[:, 1:]).to(dev)}

    def through_flash(c, fn, dtype):
        return launched(torch, flash_lib, SYMBOL[getattr(torch, dtype)],
                        c.n_layers, fn, f"one {c.name} {dtype} forward")

    batch = tokens(cfg.vocab, MOE_BATCH)
    m16 = build_model(cfg.replace(dtype="bfloat16",
                                  use_pallas_attention=True))
    line = {"model": cfg.name, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(), "batch": MOE_BATCH,
            "seq": MOE_SEQ, "init_s": time.perf_counter() - t0}
    _zero(libs)
    with torch.no_grad():
        # the gate: flash against plain attention at capacity factor 64,
        # where nothing is dropped (as the reference's decode-vs-forward
        # test holds its moe configs); at the model's own capacity the two
        # forwards are compared too and their routing set side by side
        for cf in (MOE_CHECK_CAPACITY, cfg.capacity_factor):
            c = cfg.replace(capacity_factor=cf)
            with MoERecorder(torch, routing=True,
                             keep_input=cf == cfg.capacity_factor) as rec_f:
                lf, _ = through_flash(c, lambda: build_model(c.replace(
                    use_pallas_attention=True)).forward(params, batch),
                    "float32")
            with MoERecorder(torch, routing=True) as rec_p:
                lp, _ = build_model(c).forward(params, batch)
            torch.cuda.synchronize()
            want = (MOE_BATCH, MOE_SEQ, cfg.vocab_padded)
            if tuple(lf.shape) != want or not bool(torch.isfinite(lf).all()):
                fail(f"{cfg.name} logits {tuple(lf.shape)} (want {want}) "
                     f"or not finite")
            d = (lf - lp).abs().amax(-1).flatten()  # a token's max |d|
            over = (d > LM_LOGIT_ATOL).nonzero().flatten().tolist()
            routing = rec_f.routing_against(rec_p)
            rerouted = routing["rerouted_tokens"]
            row = {"capacity_factor": cf, "max_abs_err": float(d.max()),
                   "logit_absmax": float(lp.abs().max()),
                   "tokens_over_atol": {t: float(d[t]) for t in over},
                   "max_abs_err_elsewhere": float(d.index_fill(
                       0, torch.tensor(list(rerouted), dtype=torch.long,
                                       device=d.device), 0).max()),
                   "dropped_frac_layers": rec_f.dropped_fracs(),
                   "routing_flash_vs_plain": routing}
            del lf, lp
            if cf == MOE_CHECK_CAPACITY:
                line["f32"] = dict(row, atol=LM_LOGIT_ATOL,
                                   tie_gap=MOE_TIE_GAP,
                                   tie_max_tokens=MOE_TIE_MAX_TOKENS)
                # a token over the limit passes only where the two
                # forwards routed it to different experts at a near-tie
                # that both recordings show, and only a few such tokens
                tied = [t for t in over if t in rerouted
                        and max(rerouted[t][1:]) < MOE_TIE_GAP]
                bad = [t for t in over if t not in tied]
                if bad or len(tied) > MOE_TIE_MAX_TOKENS:
                    fail(f"{cfg.name} f32 logits, flash vs plain attention "
                         f"at capacity factor {cf}: tokens {bad} over atol "
                         f"{LM_LOGIT_ATOL} not explained by a routing tie "
                         f"(gap < {MOE_TIE_GAP} in both forwards), or "
                         f"{len(tied)} tied tokens over it (at most "
                         f"{MOE_TIE_MAX_TOKENS}): {row}")
            else:
                line["f32_model_capacity"] = row
        # layer 0's MoE on its input in the flash forward, card against CPU
        x0 = rec_f.first_input
        p0 = {k: v[0] for k, v in params["blocks"]["moe"].items()}
        kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        got, gm = moe_apply(p0, x0, **kw)
        want_y, wm = moe_apply({k: v.cpu() for k, v in p0.items()},
                               x0.cpu(), **kw)
        layer_err = float((got.cpu() - want_y).abs().max())
        # the experts in rank order on each side (the seat order)
        ranks = [torch.topk(torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                          @ r, -1), cfg.top_k, dim=-1)
                 for x, r in ((x0, p0["router"]),
                              (x0.cpu(), p0["router"].cpu()))]
        moved = (ranks[0].indices.cpu() != ranks[1].indices).any(-1)
        seats = x0.shape[0] * x0.shape[1] * cfg.top_k
        line["layer0_card_vs_cpu"] = {
            "tokens": x0.shape[0] * x0.shape[1],
            "dropped_frac_card": float(gm.dropped_frac),
            "dropped_frac_cpu": float(wm.dropped_frac),
            # the dropped seats (the f32 mean giving the fraction may
            # round apart by an ulp between the two devices)
            "dropped_seats_card": round(float(gm.dropped_frac) * seats),
            "dropped_seats_cpu": round(float(wm.dropped_frac) * seats),
            "max_abs_err": layer_err, "atol": MOE_LAYER_ATOL,
            "aux_card": float(gm.aux_loss), "aux_cpu": float(wm.aux_loss),
            "tokens_ranked_differently": int(moved.sum()),
            "max_router_prob_diff": float(
                (ranks[0].values.cpu() - ranks[1].values).abs().max())}
        row = line["layer0_card_vs_cpu"]
        if (row["dropped_seats_card"] != row["dropped_seats_cpu"]
                or layer_err > MOE_LAYER_ATOL):
            fail(f"{cfg.name} layer 0 MoE, card against CPU: "
                 f"{line['layer0_card_vs_cpu']}")
        del x0, rec_f, rec_p, got, want_y
        params16 = _cast_weights(params, torch.bfloat16)
        del params
        torch.cuda.empty_cache()
        with MoERecorder(torch) as rec16:
            total, met = through_flash(
                cfg, lambda: m16.loss(params16, batch), "bfloat16")
        drops = rec16.dropped_fracs()
        if not (np.isfinite(float(total)) and np.isfinite(float(met["aux"]))):
            fail(f"{cfg.name} bf16 loss {float(total)} / aux "
                 f"{float(met['aux'])} not finite")
        line["bf16"] = {
            "loss": float(met["loss"]), "aux": float(met["aux"]),
            "total_loss": float(total), "dropped_frac_layers": drops,
            "dropped_frac_mean": sum(drops) / len(drops),
            "router_dtype": str(params16["blocks"]["moe"]["router"].dtype),
            "forward_ms": wall_ms(torch, lambda: through_flash(
                cfg, lambda: m16.forward(params16, batch), "bfloat16")),
            "profile_forward": moe_profile(torch, lambda: through_flash(
                cfg, lambda: m16.forward(params16, batch), "bfloat16"))}
    del params16
    torch.cuda.empty_cache()

    # deepseek-moe-16b, bf16 only (its router and norms f32 as drawn)
    dcfg = get_config("deepseek-moe-16b")
    t0 = time.perf_counter()
    dparams = build_model(dcfg).init(torch.Generator(dev).manual_seed(0),
                                     dev)
    torch.cuda.synchronize()
    dm = build_model(dcfg.replace(use_pallas_attention=True))
    dbatch = tokens(dcfg.vocab, DEEPSEEK_BATCH)
    with torch.no_grad():
        with MoERecorder(torch) as rec_d:
            total, met = through_flash(
                dcfg, lambda: dm.loss(dparams, dbatch), "bfloat16")
        if not np.isfinite(float(total)):
            fail(f"{dcfg.name} loss {float(total)} not finite")
        drops = rec_d.dropped_fracs()
        line["deepseek"] = {
            "model": dcfg.name, "params": dcfg.param_count(),
            "active_params": dcfg.active_param_count(),
            "batch": DEEPSEEK_BATCH, "seq": MOE_SEQ,
            "init_s": time.perf_counter() - t0,
            "memory_gb": torch.cuda.memory_allocated(dev) / 1e9,
            "loss": float(met["loss"]), "aux": float(met["aux"]),
            "dropped_frac_mean": sum(drops) / len(drops),
            "forward_ms": wall_ms(torch, lambda: through_flash(
                dcfg, lambda: dm.forward(dparams, dbatch), "bfloat16")),
            "profile_forward": moe_profile(torch, lambda: through_flash(
                dcfg, lambda: dm.forward(dparams, dbatch), "bfloat16"))}
    del dparams
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = dict(flash_lib.launches)
    line["launches"] = {lib.name: dict(lib.launches) for lib in libs}
    line["phase_s"] = time.perf_counter() - t_phase
    print("moe " + json.dumps(line))
    return launches


def moe_profile(torch, fn) -> dict:
    """A profiled forward: flash's device ms, and the device ms and share
    of the forward's device time of each MoE range (dispatch, expert
    products, combine, shared experts), summed over the layers."""
    prof = device_profile(torch, fn, match="flash_fwd_tc", spans=MOE_SPANS)
    dev_ms = prof["device_ms"]
    prof["moe_share"] = {k: v / dev_ms if dev_ms else None
                         for k, v in prof["spans"].items()}
    return prof


class _TimedTokens(list):
    """A request's token list that notes when its first token landed."""

    first_at = None

    def append(self, tok):
        if not self:
            self.first_at = time.perf_counter()
        super().append(tok)


def continuous_runs(np, torch, dev, model, params, reqs, n_slots: int,
                    max_seq: int, reps: int = 2):
    """``ContinuousBatchingEngine.run_to_completion`` over ``reqs`` ((prompt,
    max_new_tokens) pairs) under each serving policy, ``reps`` times each:
    fails unless every request is done and every run gives the first
    run's tokens. Returns (per-run rows, {rid: tokens})."""
    from repro_torch.core.runtime import PriorityClass
    from repro_torch.core.transfer import TransferEngine, TransferPolicy
    from repro_torch.serve.continuous import ContinuousBatchingEngine, Request

    make = {"kernel-level": TransferPolicy.kernel_level,
            "user-level polling": TransferPolicy.user_level_polling}
    rows, first = [], None
    for name in SERVE_POLICIES:
        for rep in range(reps):
            transfer = TransferEngine(make[name](), device=dev)
            eng = ContinuousBatchingEngine(model, params, n_slots=n_slots,
                                           max_seq=max_seq,
                                           transfer=transfer)
            try:
                if eng.transfer.device.type != dev.type:
                    fail(f"continuous engine on {eng.transfer.device}")
                # the client's side of admission: a shed request backs off
                # its retry_after_s and is submitted again (it is shed when
                # the runtime's TOKEN class missed half its deadlines in
                # the last 5 s, as a slow host's earlier runs can leave it)
                sheds = []
                for i, (p, n) in enumerate(reqs):
                    req = Request(rid=i, prompt=p, max_new_tokens=n,
                                  tokens=_TimedTokens())
                    for _ in range(CB_SUBMIT_TRIES):
                        d = eng.submit(req)
                        if d.admitted:
                            break
                        sheds.append([i, d.reason])
                        time.sleep(d.retry_after_s)
                    else:
                        fail(f"request {i} shed {CB_SUBMIT_TRIES} times: "
                             f"{sheds}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                done = eng.run_to_completion()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                toks = {r.rid: list(r.tokens) for r in done}
                if (sorted(toks) != list(range(len(reqs)))
                        or not all(r.done for r in done)
                        or any(not 0 < len(toks[i]) <= n
                               for i, (_, n) in enumerate(reqs))):
                    fail(f"{model.cfg.name} {name} run {rep}: requests "
                         f"not all done: {sorted(toks)}")
                if first is None:
                    first = toks
                elif toks != first:
                    fail(f"{model.cfg.name} continuous {name} run {rep}: "
                         f"tokens differ from the first run's")
                lengths = eng.cache.length.cpu().tolist()
                n_tok = sum(len(t) for t in toks.values())
                with torch.no_grad():
                    step = device_profile(torch, lambda: model.decode(
                        params, eng.tokens, eng.cache), spans=MOE_SPANS)
                rows.append({
                    "policy": transfer.policy.tag, "run": rep,
                    "steps": eng.steps, "wall_ms": wall * 1e3,
                    "tokens": n_tok, "tokens_per_s": n_tok / wall,
                    "ttft_ms": [(r.tokens.first_at - t0) * 1e3
                                for r in sorted(done, key=lambda r: r.rid)],
                    "completion_order": [r.rid for r in done],
                    "sheds": sheds,
                    # what the admission valve reads: the TOKEN class's
                    # share of dispatches past their 1 ms deadline in the
                    # last 5 s (no runtime under polling)
                    "token_deadline_miss_rate":
                        transfer.runtime.deadline_miss_rate(
                            PriorityClass.TOKEN) if transfer.runtime
                        else None,
                    "tx_count": transfer.tx_count,
                    "rx_count": transfer.rx_count,
                    "tx_bytes": transfer.tx_bytes_total,
                    "rx_bytes": transfer.rx_bytes_total,
                    "final_lengths": lengths,
                    # an idle slot's writes at or past max_seq, dropped
                    "writes_dropped": [max(0, n - max_seq) for n in lengths],
                    "profile_decode_step": step})
            finally:
                eng.close()
                transfer.close()
    return rows, first


def continuous_paths(np, torch, dev, libs):
    """12c. continuous batching: granite-moe in bf16 over 4 slots (10
    requests), the same engine driven past max_seq by an idle slot (F6's
    path), and qwen2.5-3b in f32 against ``ServingEngine`` serving each
    request alone (a ``continuous`` line)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    t_phase = time.perf_counter()
    cfg = get_config("granite-moe-1b-a400m", dtype="float32")
    params16 = _cast_weights(build_model(cfg).init(
        torch.Generator(dev).manual_seed(0), dev), torch.bfloat16)
    model = build_model(cfg.replace(dtype="bfloat16"))
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(CB_REQUESTS):
        n = rng.integers(CB_PROMPT[0], CB_PROMPT[1] + 1)
        reqs.append((rng.integers(0, cfg.vocab, n).astype(np.int32),
                     int(rng.integers(CB_NEW[0], CB_NEW[1] + 1))))
    _zero(libs)
    rows, toks = continuous_runs(np, torch, dev, model, params16, reqs,
                                 CB_SLOTS, CB_MAX_SEQ)
    line = {"model": cfg.name, "dtype": "bfloat16", "slots": CB_SLOTS,
            "max_seq": CB_MAX_SEQ,
            "requests": [[len(p), n] for p, n in reqs], "runs": rows,
            "tokens_identical": True,
            "tokens_head": {r: t[:6] for r, t in toks.items()}}
    # F6's path on the card: slot 0 retires while slot 1 decodes on, and
    # its length passes max_seq
    f6_reqs = [(rng.integers(0, cfg.vocab, n).astype(np.int32), new)
               for n, new in CB_F6_REQUESTS]
    f6_rows, f6_toks = continuous_runs(np, torch, dev, model, params16,
                                       f6_reqs, CB_F6_SLOTS, CB_F6_MAX_SEQ)
    dropped = f6_rows[0]["writes_dropped"]
    if not any(dropped):
        fail(f"no idle slot passed max_seq {CB_F6_MAX_SEQ}: final lengths "
             f"{f6_rows[0]['final_lengths']}")
    line["idle_past_max_seq"] = {
        "slots": CB_F6_SLOTS, "max_seq": CB_F6_MAX_SEQ,
        "requests": [list(r) for r in CB_F6_REQUESTS],
        "writes_dropped": dropped, "tokens_identical": True,
        "runs": [{k: r[k] for k in ("policy", "run", "steps", "wall_ms",
                                    "final_lengths")} for r in f6_rows]}
    del params16
    torch.cuda.empty_cache()

    # qwen2.5-3b, f32: each request's tokens against ServingEngine alone
    qcfg = get_config("qwen2.5-3b", dtype="float32")
    qparams = build_model(qcfg).init(torch.Generator(dev).manual_seed(0),
                                     dev)
    qmodel = build_model(qcfg)
    qreqs = [(rng.integers(0, qcfg.vocab, rng.integers(32, 97)).astype(
        np.int32), CB_QWEN_NEW) for _ in range(CB_QWEN_REQUESTS)]
    qrows, qtoks = continuous_runs(np, torch, dev, qmodel, qparams, qreqs,
                                   CB_QWEN_SLOTS, CB_QWEN_MAX_SEQ, reps=1)
    near_ties = []
    for rid, (p, n) in enumerate(qreqs):
        solo = ServingEngine(qmodel, qparams,
                             ServeConfig(max_batch=1, max_seq=CB_QWEN_MAX_SEQ))
        try:
            want = solo.generate(p[None], max_new_tokens=n)[0].tokens.tolist()
        finally:
            solo.close()
        got = qtoks[rid]
        at = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                  None)
        if at is None:
            continue
        # the solo run's top-2 logit margin at the first differing step
        with torch.no_grad():
            seq = torch.from_numpy(np.concatenate([p, want[:at]])).to(dev)
            last = qmodel.forward(qparams, {"tokens": seq[None]})[0][
                0, -1, :qcfg.vocab]
        top2 = torch.topk(last, 2).values
        margin = float(top2[0] - top2[1])
        near_ties.append({"rid": rid, "step": at, "continuous": got[at],
                          "alone": want[at], "top2_margin": margin})
        if margin >= LM_LOGIT_ATOL:
            fail(f"{qcfg.name} request {rid}: continuous batching differs "
                 f"from serving it alone at step {at} with a top-2 logit "
                 f"margin {margin} >= {LM_LOGIT_ATOL}")
    line["qwen_f32_vs_alone"] = {
        "model": qcfg.name, "slots": CB_QWEN_SLOTS,
        "requests": [[len(p), n] for p, n in qreqs], "runs": qrows,
        "differing_steps": near_ties}
    del qparams
    torch.cuda.empty_cache()
    line["launches"] = {lib.name: dict(lib.launches) for lib in libs}
    line["phase_s"] = time.perf_counter() - t_phase
    print("continuous " + json.dumps(line))


def _decode_lengths(np, b: int, s_max: int, median: float, seed: int):
    """[B] int64 lengths like a served batch's (lognormal around
    ``median``), with an empty slot, a full one and an idle slot past
    S_max."""
    rng = np.random.default_rng(seed)
    n = np.clip(np.rint(median * np.exp(0.6 * rng.standard_normal(b))), 0,
                s_max - 1).astype(np.int64)
    n[:3] = (0, s_max - 1, s_max + 50)
    return n


def _snapshot(cache):
    return cache._replace(**{f: getattr(cache, f).clone()
                             for f in cache._fields})


def decode_graph_check(np, torch, dev, model, params, prompts, n_slots: int,
                       max_seq: int, attn_launches: int,
                       steps: int | None = None) -> dict:
    """The engine's decode steps, the first eager and every later one
    replayed from its decode graph, each against an eager decode of the
    same token and cache (snapshots taken before the step): fails unless
    every step's logits, cache tensors and length are bitwise equal.
    ``prompts`` ((prompt, max_new_tokens) pairs) are admitted as slots
    free up, so later admissions splice into the graph's cache. Each
    replay after the capture runs under a CPU profiler session: fails
    unless it adds exactly ``attn_launches`` (the model's attention
    layers) to ``attn.decode`` and launches nothing through the decode
    library's Python entry. Returns the steps compared, the replays so
    counted and the host ms of the replayed (profiled) and the eager
    twin's decode calls (each synchronised)."""
    from repro_torch.core.runtime import TransferRuntime
    from repro_torch.core.transfer import TransferEngine, TransferPolicy
    from repro_torch.kernels.decode_attention.kernel import DECODE
    from repro_torch.models import lm
    from repro_torch.serve.continuous import ContinuousBatchingEngine, Request
    from repro_torch.utils import trace

    seen, graph_ms, eager_ms, counted = [], [], [], []

    def decode(ps, token, cache):
        graphed = isinstance(cache, lm.DecodeGraph)
        replay = graphed and cache._graph is not None
        tok0 = token.clone()
        cache0 = _snapshot(cache.cache if graphed else cache)
        torch.cuda.synchronize()
        before = DECODE.launches["decode_attention"]
        with contextlib.ExitStack() as prof:
            if replay:
                prof.enter_context(torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]))
                trace.count("test.session")  # the session's first record
            t0 = time.perf_counter()
            logits, new = model.decode(ps, token, cache)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        if replay:
            got = (trace.counters().get("attn.decode", 0),
                   DECODE.launches["decode_attention"] - before)
            captured = cache.counts.get("attn.decode", 0)
            if got != (attn_launches, 0) or captured != attn_launches:
                fail(f"{model.cfg.name} replay {len(seen)}: attn.decode "
                     f"{got[0]}, Python launches {got[1]}, captured "
                     f"{captured}; expected {attn_launches}, 0, "
                     f"{attn_launches}")
            counted.append(got[0])
        t1 = time.perf_counter()
        want, want_cache = model.decode(ps, tok0, cache0)
        torch.cuda.synchronize()
        if graphed:
            graph_ms.append(step_ms)
        eager_ms.append((time.perf_counter() - t1) * 1e3)
        same = [f for f in new._fields
                if not torch.equal(getattr(new, f), getattr(want_cache, f))]
        if not torch.equal(logits, want) or same:
            fail(f"{model.cfg.name} decode step {len(seen)} (graphed "
                 f"{graphed}): logits equal {torch.equal(logits, want)}, "
                 f"cache fields that differ {same}")
        seen.append(graphed)
        return logits, new

    import dataclasses

    # a private runtime: admission reads no TOKEN deadline misses that
    # earlier phases left on the shared one
    rt = TransferRuntime(workers=2)
    transfer = TransferEngine(TransferPolicy.kernel_level(), device=dev,
                              runtime=rt)
    eng = ContinuousBatchingEngine(dataclasses.replace(model, decode=decode),
                                   params, n_slots=n_slots, max_seq=max_seq,
                                   transfer=transfer)
    try:
        for i, (p, n) in enumerate(prompts):
            if not eng.submit(Request(rid=i, prompt=p,
                                      max_new_tokens=n)).admitted:
                fail(f"decode graph check: request {i} shed")
        eng.run_to_completion(max_steps=steps or 10_000)
    finally:
        eng.close()
        transfer.close()
        rt.close()
    if seen[:1] != [False] or not all(seen[1:]) or len(seen) < 4:
        fail(f"decode graph check: steps graphed {seen}")
    if not counted:
        fail("decode graph check: no replay after the capture was counted")
    return {"steps": len(seen), "attn_decode_a_replay": attn_launches,
            "replays_counted": len(counted), "replay_ms": sorted(graph_ms),
            "eager_ms": sorted(eager_ms)}


def decode_phase(np, torch, dev, libs) -> dict:
    """12c, continued. Decode attention and the decode graph (a
    ``decode_attention`` line and a ``decode_graph`` line): the kernel against its plain
    version at granite.chat's and granite4h.rag's decode shapes and
    length mix (flash's bf16 rule), one launch a call, two calls bitwise
    equal; its time by CUDA events and by the profiler beside its bound
    (the live rows' K and V read once), the plain version's, the model's
    route before it (K / V repeated, K cast to f32, over every row) and
    SDPA's over a mask of the live rows (the yardstick; the port never
    calls it); a smoke LM's decode launching it once a layer; then the
    engine's graph-replayed decode steps bitwise eager ones, each replay
    adding the model's attention layers to ``attn.decode``, for smoke
    granite-moe and granite-4.0-h with 64-wide heads and for
    granite-moe-1b-a400m at full size on 64 slots; and one eager decode
    step at each serving cell's size, its launches counted from zero (24
    for granite.chat's, 2 for granite4h.rag's). Returns the kernel table's
    row, whose ``launches`` is that chat step's."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.kernels.decode_attention.kernel import DECODE
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, live_rows)
    from repro_torch.models.api import build_model
    from repro_torch.models.layers.attention import attention

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(33)
    cases = {}
    for name, b, s_max, h, hkv, dh, median, scale in (
            ("chat", 64, 2560, 16, 8, 64, 755, None),
            ("rag", 64, 4608, 32, 8, 128, 2000, 0.0078125)):
        q = torch.randn((b, 1, h, dh), generator=gen).to(dev, torch.bfloat16)
        k = torch.randn((b, s_max, hkv, dh), generator=gen).to(
            dev, torch.bfloat16)
        v = torch.randn((b, s_max, hkv, dh), generator=gen).to(
            dev, torch.bfloat16)
        length = torch.from_numpy(_decode_lengths(np, b, s_max, median,
                                                  s_max)).to(dev)
        got = launched(torch, DECODE, "decode_attention", 1,
                       lambda: decode_attention(q, k, v, length, scale=scale),
                       f"decode attention {name}")
        ref = decode_attention_ref(q, k, v, length, scale=scale)
        ok, err, err_rms = rms_close(torch, got, ref, (2e-2, None), 0.05)
        if not ok:
            fail(f"decode attention {name}: kernel vs plain max |d| {err}, "
                 f"(|d| - 2e-2 |ref|) / RMS {err_rms}")
        if not torch.equal(got, decode_attention(q, k, v, length,
                                                 scale=scale)):
            fail(f"decode attention {name}: two calls differ")
        sc = scale if scale is not None else dh ** -0.5
        live = live_rows(length, b, s_max, dev)
        nbytes = int(live.sum()) * hkv * dh * 2 * 2 + 2 * q.numel() * 2
        flops = 4 * int(live.sum()) * h * dh
        b_ms, by = bound_ms(nbytes, flops, FP32_FLOPS)
        mask = (torch.arange(s_max, device=dev)[None] < live[:, None])[
            :, None, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def kern():
            return decode_attention(q, k, v, length, scale=sc)

        def route():
            return attention(q, k, v, causal=True, q_offset=length,
                             kv_valid=length + 1, scale=sc)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=sc, enable_gqa=True)

        lib_err = rms_close(torch, sdpa().transpose(1, 2), ref, (2e-2, None),
                            0.05)
        cases[name] = {
            "b": b, "s_max": s_max, "heads": [h, hkv], "dh": dh,
            "live_rows_mean": float(live.float().mean()),
            "max_abs_err": err, "err_over_row_rms": err_rms,
            "ms": time_ms(torch, kern, iters=50),
            "device_ms": device_ms_per_call(torch, kern),
            "bound_ms": b_ms, "bound_by": by,
            "plain_ms": time_ms(torch, lambda: decode_attention_ref(
                q, k, v, length, scale=sc), iters=5),
            "route_before_ms": time_ms(torch, route, iters=5),
            "library_ms": time_ms(torch, sdpa, iters=20),
            "library_device_ms": device_ms_per_call(torch, sdpa),
            "library_within_rule": lib_err[0]}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    print("decode_attention " + json.dumps(cases))

    # a smoke LM's decode steps: one launch an attention layer a step
    graph = {}
    rng = np.random.default_rng(34)
    for arch in ("granite-moe-1b-a400m", "granite-4.0-h-small"):
        cfg = smoke_config(arch).replace(dtype="bfloat16", head_dim=64)
        model = build_model(cfg)
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        n_attn = len(cfg.attn_layers) if cfg.layer_types else cfg.n_layers
        cache = model.init_cache(3, 40, device=dev)._replace(
            length=torch.tensor([0, 17, 39], device=dev))
        tok = torch.zeros((3, 1), dtype=torch.int32, device=dev)
        with torch.no_grad():
            launched(torch, DECODE, "decode_attention", n_attn,
                     lambda: model.decode(params, tok, cache),
                     f"{arch} smoke decode step")
            prompts = [(rng.integers(0, cfg.vocab, n).astype(np.int32), new)
                       for n, new in ((9, 5), (4, 7), (13, 4), (6, 6),
                                      (11, 3))]
            graph[cfg.name] = decode_graph_check(np, torch, dev, model,
                                                 params, prompts, 3, 48,
                                                 n_attn)
        del params
    # the serving decode step's own launches, counted from zero: one eager
    # step of granite-moe-1b-a400m at full size as granite.chat serves it
    # (64 slots of 2,560 rows, 24 attention layers), and one of
    # granite-4.0-h-small's widths as granite4h.rag serves them (64 slots
    # of 4,608 rows, past the blocks threshold) with the cell's 2
    # attention layers, each after one Mamba2 layer
    steps = {}
    for arch, s_max, median, types in (
            ("granite-moe-1b-a400m", 2560, 755, None),
            ("granite-4.0-h-small", 4608, 2000, ("mamba", "attention") * 2)):
        cfg = get_config(arch, dtype="float32")
        if types is not None:
            cfg = cfg.replace(n_layers=len(types), layer_types=types)
        n_attn = len(cfg.attn_layers) if cfg.layer_types else cfg.n_layers
        params = _cast_weights(build_model(cfg).init(
            torch.Generator(dev).manual_seed(0), dev), torch.bfloat16)
        model = build_model(cfg.replace(dtype="bfloat16"))
        cache = model.init_cache(64, s_max, device=dev)._replace(
            length=torch.from_numpy(_decode_lengths(np, 64, s_max, median,
                                                    s_max + 1)).to(dev))
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (64, 1)).astype(
            np.int32)).to(dev)
        _zero(libs)
        with torch.no_grad():
            launched(torch, DECODE, "decode_attention", n_attn,
                     lambda: model.decode(params, tok, cache),
                     f"{arch} decode step, 64 slots of {s_max}")
        steps[arch] = {"slots": 64, "s_max": s_max, "layers": cfg.n_layers,
                       "launches": DECODE.launches["decode_attention"]}
        if arch == "granite-moe-1b-a400m":
            # the engine's graph-replayed steps on 64 slots of 2,560,
            # prompts of 64-1,024 tokens
            prompts = [(rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                        6) for n in rng.integers(64, 1025, 64)]
            with torch.no_grad():
                graph[cfg.name] = decode_graph_check(
                    np, torch, dev, model, params, prompts, 64, s_max,
                    n_attn, steps=6)
        del params, cache
        torch.cuda.empty_cache()
    graph["full_size_step_launches"] = steps
    print("decode_graph " + json.dumps(graph))
    chat = cases["chat"]
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": None,
        "replaces_note": "no pallas_call: the reference's decode attention "
                         "is XLA's; the port's plain decode repeated K / V "
                         "and cast K to f32 over every cache row",
        "launches": steps["granite-moe-1b-a400m"]["launches"],
        "max_abs_err_bf16": max(c["max_abs_err"] for c in cases.values()),
        "ms": chat["ms"], "device_ms": chat["device_ms"],
        "plain_ms": chat["plain_ms"], "bound_ms": chat["bound_ms"],
        "bound_by": chat["bound_by"], "library_ms": chat["library_ms"],
        "library_device_ms": chat["library_device_ms"],
        "library_note": "SDPA over a boolean mask of the live rows "
                        "(enable_gqa), the yardstick only",
        "shape": "granite.chat decode: 64 slots, 16 / 8 heads of 64, "
                 "S_max 2560", "phase_s": time.perf_counter() - t_phase}


MLA_SLOTS, MLA_S_MAX, MLA_LIVE = 32, 18432, 9500  # dsv2lite.longdoc's decode


def mla_phase(np, torch, dev, libs) -> dict:
    """12c, continued. Latent decode attention (an ``mla_decode`` line):
    the kernel against its plain version at dsv2lite.longdoc's decode
    shape and length mix (32 slots of 18,432 rows, ~9,500 live, with an
    empty, a full and an idle slot past S_max; flash's bf16 rule), one
    launch a call, two calls bitwise equal; its time by CUDA events and by
    the profiler beside its bound (``perfbench/counts/mla_lm.py``: the
    live rows read once, the products at the tensor cores' peak), the
    plain version's, and SDPA's over a mask of the live rows (the
    yardstick; the port never calls it): the 16 heads as 16 queries of
    one head against the rows, values their first 512, the same function;
    then one eager decode step of DeepSeek-V2-Lite at every published
    width on those 32 slots, every library's launches counted from zero
    (27 of ``mla_decode``, one a layer, and nothing else). Returns the
    kernel table's row, whose ``launches`` is that step's."""
    import torch.nn.functional as F

    from perfbench.counts.mla_lm import latent_decode
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attention.kernel import (
        MLA, mla_decode_bsd)
    from repro_torch.kernels.decode_attention.ref import (
        live_rows, mla_decode_ref)
    from repro_torch.models.api import build_model
    from repro_torch.models.layers.mla import mla_scale

    t_phase = time.perf_counter()
    cfg = get_config("deepseek-v2-lite")
    b, s_max, h = MLA_SLOTS, MLA_S_MAX, cfg.n_heads
    r = cfg.kv_lora_rank
    width = r + cfg.qk_rope_head_dim
    sc = mla_scale(cfg)
    gen = torch.Generator(dev).manual_seed(34)
    q = torch.randn((b, h, width), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    rows = torch.randn((b, s_max, width), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    length = torch.from_numpy(_decode_lengths(np, b, s_max, MLA_LIVE,
                                              s_max)).to(dev)

    def kern():
        return mla_decode_bsd(q, rows, length, scale=sc)

    got = launched(torch, MLA, "mla_decode", 1, kern,
                   "latent decode attention")
    ref = mla_decode_ref(q, rows, length, scale=sc, value_dim=r)
    ok, err, err_rms = rms_close(torch, got, ref, (2e-2, None), 0.05)
    if not ok:
        fail(f"latent decode attention: kernel vs plain max |d| {err}, "
             f"(|d| - 2e-2 |ref|) / RMS {err_rms}")
    if not torch.equal(got, kern()):
        fail("latent decode attention: two calls differ")
    live = live_rows(length, b, s_max, dev)
    counted = json.loads((ROOT / "perfbench" / "configs"
                          / "deepseek-v2-lite.json").read_text())
    flops, nbytes = latent_decode(counted, int(live.sum()), 1, b)
    b_ms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    mask = (torch.arange(s_max, device=dev)[None] < live[:, None])[
        :, None, None]
    qs, ks, vs = q[:, None], rows[:, None], rows[:, None, :, :r]

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              scale=sc)

    lib_ok = rms_close(torch, sdpa()[:, 0], ref, (2e-2, None), 0.05)[0]
    kernel = {
        "b": b, "s_max": s_max, "heads": h, "row": width, "value": r,
        "live_rows_mean": float(live.float().mean()),
        "max_abs_err": err, "err_over_row_rms": err_rms,
        "ms": time_ms(torch, kern, iters=50),
        "device_ms": device_ms_per_call(torch, kern),
        "bound_ms": b_ms, "bound_by": by,
        "plain_ms": time_ms(torch, lambda: mla_decode_ref(
            q, rows, length, scale=sc, value_dim=r), iters=5),
        "library_ms": time_ms(torch, sdpa, iters=20),
        "library_device_ms": device_ms_per_call(torch, sdpa),
        "library_within_rule": lib_ok}
    del q, rows, got, ref, qs, ks, vs
    torch.cuda.empty_cache()

    # the serving decode step's own launches, counted from zero
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    cache = model.init_cache(b, s_max, device=dev)._replace(length=length)
    tok = torch.from_numpy(np.random.default_rng(35).integers(
        0, cfg.vocab, (b, 1)).astype(np.int32)).to(dev)
    _zero(libs)
    with torch.no_grad():
        t0 = time.perf_counter()
        launched(torch, MLA, "mla_decode", cfg.n_layers,
                 lambda: model.decode(params, tok, cache),
                 f"{cfg.name} decode step, {b} slots of {s_max}")
        step_ms = (time.perf_counter() - t0) * 1e3
    step = {lib.name: dict(lib.launches) for lib in libs}
    if any(n for lib in libs if lib is not MLA
           for n in lib.launches.values()):
        fail(f"{cfg.name} decode step launched {step}; expected "
             f"{cfg.n_layers} x mla_decode and nothing else")
    kernel["full_size_step"] = {"layers": cfg.n_layers, "launches": step,
                                "eager_ms": step_ms}
    del params, cache
    torch.cuda.empty_cache()
    print("mla_decode " + json.dumps(kernel))
    return {
        "name": "mla_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "mla_decode.cu",
        "replaces": None,
        "replaces_note": "no pallas_call: the reference has no latent "
                         "attention",
        "launches": MLA.launches["mla_decode"],
        "max_abs_err_bf16": err,
        "ms": kernel["ms"], "device_ms": kernel["device_ms"],
        "plain_ms": kernel["plain_ms"], "bound_ms": b_ms, "bound_by": by,
        "library_ms": kernel["library_ms"],
        "library_device_ms": kernel["library_device_ms"],
        "library_note": "SDPA over a boolean mask of the live rows, the 16 "
                        "heads as queries of one head, the yardstick only",
        "shape": "dsv2lite.longdoc decode: 32 slots, 16 heads of 576, "
                 "values 512, S_max 18432",
        "phase_s": time.perf_counter() - t_phase}


DKV_Q, DKV_KV = 4096, 8192  # dsv2lite.longdoc's second prefill chunk


def flash_dkv_phase(np, torch, dev, libs) -> dict:
    """12c, continued. MLA's decompressed prefill attention (a
    ``flash_dkv`` line): the flash kernel's two-width entry
    (``flash_attention_fwd_tc_dkv``) at a DeepSeek-V2-Lite prefill chunk
    of dsv2lite.longdoc (4,096 queries after 4,096 cached keys, 16 heads,
    q and K of 192, V of 128 read from a view into [k_nope | v]) against
    its plain version (f32 scores; flash's bf16 rule), one launch a call,
    two calls bitwise equal; its time by CUDA events and by the profiler
    beside its bound (the visible (q, k) pairs' products at the tensor
    cores' peak, q, K, V and o read or written once), the plain
    version's, and SDPA's with the same lower-right causal mask (the
    yardstick; the port never calls it). Returns the kernel table's
    row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import FLASH
    from repro_torch.kernels.flash_attention.ops import flash_attention_dkv
    from repro_torch.kernels.flash_attention.ref import attention_ref

    t_phase = time.perf_counter()
    h, dk, dv, sq, skv = 16, 192, 128, DKV_Q, DKV_KV
    off = skv - sq
    gen = torch.Generator(dev).manual_seed(35)
    q = torch.randn((1, sq, h, dk), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((1, skv, h, dk), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((1, skv, h, 2 * dv), generator=gen, device=dev,
                    dtype=torch.bfloat16)[..., dv:]

    def kern():
        return flash_attention_dkv(q, k, v, q_offset=off)

    def plain():
        return attention_ref(q[0].transpose(0, 1), k[0].transpose(0, 1),
                             v[0].transpose(0, 1), q_offset=off)

    got = launched(torch, FLASH, "flash_attention_fwd_tc_dkv", 1, kern,
                   "two-width flash attention")
    ref = plain().transpose(0, 1)[None]
    ok, err, err_rms = rms_close(torch, got, ref, (2e-2, None), 0.05)
    if not ok:
        fail(f"two-width flash attention: kernel vs plain max |d| {err}, "
             f"(|d| - 2e-2 |ref|) / RMS {err_rms}")
    if not torch.equal(got, kern()):
        fail("two-width flash attention: two calls differ")
    pairs = sq * off + sq * (sq + 1) // 2  # (query, key) pairs it sees
    flops = 2 * h * pairs * (dk + dv)
    nbytes = 2 * h * (sq * dk + skv * dk + skv * dv + sq * dv)
    b_ms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    mask = (torch.arange(skv, device=dev)[None]
            <= torch.arange(sq, device=dev)[:, None] + off)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

    lib_ok = rms_close(torch, sdpa().transpose(1, 2), ref, (2e-2, None),
                       0.05)[0]
    row = {
        "sq": sq, "skv": skv, "heads": h, "dk": dk, "dv": dv,
        "max_abs_err": err, "err_over_row_rms": err_rms,
        "ms": time_ms(torch, kern, iters=20),
        "device_ms": device_ms_per_call(torch, kern, n=10),
        "bound_ms": b_ms, "bound_by": by,
        "plain_ms": time_ms(torch, plain, iters=2),
        "library_ms": time_ms(torch, sdpa, iters=10),
        "library_within_rule": lib_ok}
    del q, k, v, got, ref, qs, ks, vs
    torch.cuda.empty_cache()
    print("flash_dkv " + json.dumps(row))
    return {
        "name": "flash_dkv", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": None,
        "replaces_note": "no pallas_call: the reference has no latent "
                         "attention; the tensor-core flash kernel at two "
                         "head widths",
        "launches": FLASH.launches["flash_attention_fwd_tc_dkv"],
        "max_abs_err_bf16": err,
        "ms": row["ms"], "device_ms": row["device_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": b_ms, "bound_by": by,
        "library_ms": row["library_ms"],
        "library_note": "SDPA with the same lower-right causal mask, the "
                        "yardstick only",
        "shape": "dsv2lite.longdoc prefill chunk: 4096 queries after 4096 "
                 "keys, 16 heads, q/K 192, V 128",
        "phase_s": time.perf_counter() - t_phase}


KDA_TOKENS, KDA_SLOTS = 4096, 64  # kimilinear.agent's prefill chunk, slots
KIMI_S_MAX, KIMI_LIVE = 40960, 14000  # its max_seq; ~ live rows a slot


def _kda_inputs(torch, dev, b, s, h=32, d=128, seed=0):
    """KDA's kernel inputs at Kimi-Linear's widths as the card tests make
    them: q, k L2-normalised (q times d^-1/2), v a view of a wider row, a
    log decay per channel in [-6, 0], beta in (0, 1), a nonzero state."""
    F = torch.nn.functional
    g = torch.Generator(dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    q = F.normalize(rn(b, s, h, d), dim=-1) * d ** -0.5
    k = F.normalize(rn(b, s, h, d), dim=-1)
    v = rn(b, s, 3, h, d)
    dec = -torch.rand((b, s, h, d), generator=g, device=dev) ** 4 * 6.0
    beta = torch.rand((b, s, h), generator=g, device=dev)
    st = rn(b, h, d, d) * 0.3
    bf = torch.bfloat16
    return q.to(bf), k.to(bf), v.to(bf)[:, :, 2], dec, beta, st


def _rms_rule(torch, got, want, rms_frac, rel, what):
    """Fails unless |got - want| <= rms_frac RMS(want) + rel |want| (the
    card tests' rule); returns the widest |d| / RMS(want)."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: not finite")
    rms = float(want.pow(2).mean().sqrt())
    diff = (got - want).abs()
    if bool((diff > rms_frac * rms + rel * want.abs()).any()):
        fail(f"{what}: kernel vs plain max |d| {float(diff.max())} over "
             f"RMS {rms} ({rms_frac} RMS + {rel} |ref|)")
    return float(diff.max()) / rms


def kda_phase(np, torch, dev, libs) -> list[dict]:
    """12d. Kimi-Linear's kernels at kimilinear.agent's shapes (a ``kda``
    line): each KDA entry against its plain version (``kernels/kda/ref.py``)
    at the card tests' tolerances, with every library's launch counts
    zeroed first and each call's one launch checked: ``kda_chunk`` over a
    4,096-token prefill chunk of 32 heads of 128 from a nonzero state (o
    within 1% of its RMS plus 0.8% of the value, the state within 1e-3),
    two calls bitwise; ``kda_step`` over 64 slots (o within 0.1% of its
    RMS plus 0.8%, the state within 1e-5); ``kda_prep`` (the convs, norms
    and gates) and ``kda_out`` (the gated norm) over the same chunk;
    ``mla_decode`` at 32 heads over 64 slots of 40,960 rows, ~14k live
    (flash's bf16 rule), with SDPA over a mask of the live rows beside it;
    then one eager decode step of Kimi-Linear at every published width on
    those 64 slots, counted from zero: 20 launches of each of
    ``kda_step``, ``kda_prep`` and ``kda_out`` and 7 of ``mla_decode``,
    nothing else. Each kernel's time by CUDA events and by the profiler,
    its least time (``perfbench/counts/kda_lm.py`` and ``mla_lm.py``, or
    the bytes it must move where those count nothing), its plain
    version's at the same shape, and the library's where one call
    computes the function. Returns the kernel table's rows."""
    import torch.nn.functional as F

    from perfbench.counts.kda_lm import chunk_prefill, decode_step
    from perfbench.counts.mla_lm import latent_decode
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attention.kernel import MLA, mla_decode_bsd
    from repro_torch.kernels.decode_attention.ref import (
        live_rows, mla_decode_ref)
    from repro_torch.kernels.kda.kernel import (
        KDA, kda_chunk_call, kda_out_call, kda_prep_call, kda_step_call)
    from repro_torch.kernels.kda.ref import (
        kda_chunk_ref, kda_out_ref, kda_prep_ref, kda_step_ref)
    from repro_torch.models.api import build_model
    from repro_torch.models.layers.mla import mla_scale

    t_phase = time.perf_counter()
    counted = json.loads((ROOT / "perfbench" / "configs"
                          / "kimi-linear-48b-a3b-instruct.json").read_text())
    src = "src/repro_torch/kernels/kda/csrc/kda.cu"
    line, rows = {}, []

    def row(name, shape, ms_fn, plain_fn, b_ms, by, err, extra=None,
            iters=20):
        r = {"name": name, "route": "cuda", "source": src, "replaces": None,
             "replaces_note": "no pallas_call: the reference has no linear "
                              "attention",
             "launches": KDA.launches.get(name, 0), "max_abs_err_bf16": err,
             "ms": time_ms(torch, ms_fn, iters=iters),
             "device_ms": device_ms_per_call(torch, ms_fn, n=10),
             "plain_ms": time_ms(torch, plain_fn, iters=3),
             "bound_ms": b_ms, "bound_by": by, "library_ms": None,
             "library_note": "no single PyTorch call computes it",
             "shape": shape}
        r.update(extra or {})
        line[name] = {k: r[k] for k in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "max_abs_err_bf16")}
        rows.append(r)

    # the chunked prefill, one 4,096-token chunk from a nonzero state
    q, k, v, g, beta, st = _kda_inputs(torch, dev, 1, KDA_TOKENS, seed=36)
    want_st = st.clone()
    want = kda_chunk_ref(q, k, v, g, beta, want_st)
    got_st = st.clone()
    _zero(libs)
    got = launched(torch, KDA, "kda_chunk", 1,
                   lambda: kda_chunk_call(q, k, v, g, beta, got_st),
                   "KDA chunked prefill")
    err = _rms_rule(torch, got, want, 0.01, 8e-3, "KDA chunked prefill")
    _rms_rule(torch, got_st, want_st, 1e-3, 1e-3, "KDA prefill's state")
    again = st.clone()
    if not (torch.equal(got, kda_chunk_call(q, k, v, g, beta, again))
            and torch.equal(again, got_st)):
        fail("KDA chunked prefill: two calls differ")
    work = st.clone()
    flops, nbytes = chunk_prefill(counted, KDA_TOKENS, 1)
    row("kda_chunk", "kimilinear.agent prefill chunk: 4096 tokens, 32 heads "
        "of 128, from a nonzero state",
        lambda: kda_chunk_call(q, k, v, g, beta, work),
        lambda: kda_chunk_ref(q, k, v, g, beta, work),
        *bound_ms(nbytes, int(flops)), err, iters=10)
    del q, k, v, g, beta, st, want, got, want_st, got_st, again, work

    # the decode step over 64 slots, a layer of a stacked state in place
    q, k, v, g, beta, _ = _kda_inputs(torch, dev, KDA_SLOTS, 1, seed=37)
    q, k, v, g, beta = (t[:, 0] for t in (q, k, v, g, beta))
    states = torch.randn((2, KDA_SLOTS, 32, 128, 128), device=dev,
                         generator=torch.Generator(dev).manual_seed(38)) * 0.3
    want_st = states[1].clone()
    want = kda_step_ref(q, k, v, g, beta, want_st)
    _zero(libs)
    got = launched(torch, KDA, "kda_step", 1,
                   lambda: kda_step_call(q, k, v, g, beta, states[1]),
                   "KDA decode step")
    err = _rms_rule(torch, got, want, 1e-3, 8e-3, "KDA decode step")
    _rms_rule(torch, states[1], want_st, 1e-5, 1e-5, "KDA step's state")
    flops, nbytes = decode_step(counted, 1, KDA_SLOTS)
    row("kda_step", "kimilinear.agent decode: 64 slots, 32 heads of 128",
        lambda: kda_step_call(q, k, v, g, beta, states[0]),
        lambda: kda_step_ref(q, k, v, g, beta, states[0]),
        *bound_ms(nbytes, flops), err, iters=50)
    del q, k, v, g, beta, states, want, want_st, got

    # the prologue and the gated norm over the same chunk (its conv tail)
    h, d, b, s = 32, 128, 1, KDA_TOKENS
    gen = torch.Generator(dev).manual_seed(39)
    bf = torch.bfloat16

    def rnd(*shape, sd=1.0, dt=bf):
        return (torch.randn(shape, generator=gen, device=dev) * sd).to(dt)

    qkv, conv_w = rnd(b, s, 3 * h * d), rnd(4, 3 * h * d, sd=0.5)
    tail, f, b_raw = rnd(b, 3, 3 * h * d), rnd(b, s, h * d), rnd(b, s, h)
    dt_bias = rnd(h * d, sd=2.0, dt=torch.float32) - 4.0
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    args = (qkv, conv_w, tail, f, dt_bias, a_log, b_raw, d)
    want = kda_prep_ref(*args)
    _zero(libs)
    got = launched(torch, KDA, "kda_prep", 1, lambda: kda_prep_call(*args),
                   "KDA prologue")
    err = max(_rms_rule(torch, x, y, 1e-5 if n in "gb" else 0.01,
                        1e-5 if n in "gb" else 8e-3, f"KDA prologue's {n}")
              for n, x, y in zip("qkvgb", got, want))
    # qkv, f, b_raw and the tail read, q, k, v (bf16), g and beta (f32)
    # written, once each; no product worth counting
    nbytes = (b * s * (3 * h * d + h * d + h) * 2 + 4 * 3 * h * d * 2
              + b * s * (3 * h * d * 2 + h * d * 4 + h * 4))
    row("kda_prep", "kimilinear.agent prefill chunk: 4096 tokens, 3 x 4096 "
        "channels through convs of 4, 32 heads of 128",
        lambda: kda_prep_call(*args), lambda: kda_prep_ref(*args),
        *bound_ms(nbytes, 0), err)
    o = rnd(b, s, h, d, sd=0.1)
    g_raw, g_bias = rnd(b, s, h * d), rnd(h * d, dt=torch.float32)
    o_norm = 1.0 + rnd(d, sd=0.1, dt=torch.float32)
    oargs = (o, g_raw, g_bias, o_norm, 1e-5)
    want = kda_out_ref(*oargs)
    _zero(libs)
    got = launched(torch, KDA, "kda_out", 1, lambda: kda_out_call(*oargs),
                   "KDA gated norm")
    err = _rms_rule(torch, got, want, 1e-3, 8e-3, "KDA gated norm")
    nbytes = b * s * h * d * 2 * 3  # o and the gate read, the output written
    row("kda_out", "kimilinear.agent prefill chunk: 4096 tokens, 32 heads "
        "of 128", lambda: kda_out_call(*oargs), lambda: kda_out_ref(*oargs),
        *bound_ms(nbytes, 0), err)
    del qkv, conv_w, tail, f, b_raw, args, o, g_raw, oargs, want, got
    torch.cuda.empty_cache()

    # the latent kernel at 32 heads, kimilinear.agent's decode
    cfg = get_config("kimi-linear-48b-a3b-instruct")
    b, s_max, h = KDA_SLOTS, KIMI_S_MAX, cfg.n_heads
    r = cfg.kv_lora_rank
    width = r + cfg.qk_rope_head_dim
    sc = mla_scale(cfg)
    gen = torch.Generator(dev).manual_seed(40)
    q = torch.randn((b, h, width), generator=gen, device=dev, dtype=bf)
    lat = torch.randn((b, s_max, width), generator=gen, device=dev, dtype=bf)
    length = torch.from_numpy(_decode_lengths(np, b, s_max, KIMI_LIVE,
                                              s_max)).to(dev)

    def kern():
        return mla_decode_bsd(q, lat, length, scale=sc)

    def plain():
        return mla_decode_ref(q, lat, length, scale=sc, value_dim=r)

    _zero(libs)
    got = launched(torch, MLA, "mla_decode", 1, kern,
                   "latent decode attention, 32 heads")
    ref = plain()
    ok, err, err_rms = rms_close(torch, got, ref, (2e-2, None), 0.05)
    if not ok:
        fail(f"latent decode attention, 32 heads: kernel vs plain max |d| "
             f"{err}, (|d| - 2e-2 |ref|) / RMS {err_rms}")
    if not torch.equal(got, kern()):
        fail("latent decode attention, 32 heads: two calls differ")
    live = live_rows(length, b, s_max, dev)
    flops, nbytes = latent_decode(counted, int(live.sum()), 1, b)
    b_ms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    mask = (torch.arange(s_max, device=dev)[None] < live[:, None])[
        :, None, None]
    qs, ks, vs = q[:, None], lat[:, None], lat[:, None, :, :r]

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              scale=sc)

    lib_ok = rms_close(torch, sdpa()[:, 0], ref, (2e-2, None), 0.05)[0]
    mla = {"name": "mla_decode_32", "route": "cuda",
           "source": "src/repro_torch/kernels/decode_attention/csrc/"
                     "mla_decode.cu",
           "replaces": None,
           "replaces_note": "no pallas_call: the reference has no latent "
                            "attention; the 32-head instance",
           "launches": MLA.launches["mla_decode"], "max_abs_err_bf16": err,
           "live_rows_mean": float(live.float().mean()),
           "ms": time_ms(torch, kern, iters=50),
           "device_ms": device_ms_per_call(torch, kern),
           "plain_ms": time_ms(torch, plain, iters=3),
           "bound_ms": b_ms, "bound_by": by,
           "library_ms": time_ms(torch, sdpa, iters=10),
           "library_device_ms": device_ms_per_call(torch, sdpa, n=10),
           "library_within_rule": lib_ok,
           "library_note": "SDPA over a boolean mask of the live rows, the "
                           "32 heads as queries of one head, the yardstick "
                           "only",
           "shape": "kimilinear.agent decode: 64 slots, 32 heads of 576, "
                    "values 512, S_max 40960"}
    line["mla_decode_32"] = {k: mla[k] for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
        "library_device_ms", "live_rows_mean", "max_abs_err_bf16")}
    rows.append(mla)
    del q, lat, got, ref, qs, ks, vs
    torch.cuda.empty_cache()

    # the serving decode step's own launches, counted from zero
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    cache = model.init_cache(b, s_max, device=dev)._replace(length=length)
    tok = torch.from_numpy(np.random.default_rng(41).integers(
        0, cfg.vocab, (b, 1)).astype(np.int32)).to(dev)
    n_kda, n_lat = len(cfg.kda_layers), len(cfg.latent_layers)
    _zero(libs)
    with torch.no_grad():
        t0 = time.perf_counter()
        model.decode(params, tok, cache)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    step = {lib.name: {k: n for k, n in lib.launches.items() if n}
            for lib in libs}
    want = {"kda": {"kda_step": n_kda, "kda_prep": n_kda, "kda_out": n_kda},
            "mla_decode": {"mla_decode": n_lat}}
    if {k: v for k, v in step.items() if v} != want:
        fail(f"{cfg.name} decode step launched {step}; expected {want}")
    line["full_size_step"] = {"slots": b, "s_max": s_max,
                              "launches": step, "eager_ms": step_ms}
    del params, cache
    torch.cuda.empty_cache()
    line["phase_s"] = time.perf_counter() - t_phase
    print("kda " + json.dumps(line))
    return rows


KIMI_WITNESS_PROMPT, KIMI_WITNESS_STEPS = 960, 64


def kimi_depth_phase(np, torch, dev) -> None:
    """12d, continued. How far the served model's bf16 logits lie from the
    plain float32 reference's with depth (a ``kimi_depth`` line, not
    gated): kimilinear.agent's builder and reference (``perfbench/``) cut
    to 5, 13 and 27 layers (the dense one and the 3 : 1 pattern kept),
    weights from seed 5; the program prefills 960 tokens and decodes 64
    more, teacher-forced, on one slot; each of its 65 rows of logits
    against the reference's over the same sequence: the median and widest
    row error (RMS of the difference over the reference's RMS, as the
    cell's ``logits_rms_err_median``) and the share of rows whose argmax
    differs. At 27 layers also with the router's correction bias zeroed
    (does the bias amplify the rounding?), and the reference's own
    controls against it: fp8, and KDA's state, decay and beta in bf16."""
    from perfbench.lib import spec

    t_phase = time.perf_counter()
    cb = spec.load_module("configs", "kda_lm")
    ref = spec.load_module("reference", "kda_lm")
    full = json.loads((ROOT / "perfbench" / "configs"
                       / "kimi-linear-48b-a3b-instruct.json").read_text())
    n_tok = KIMI_WITNESS_PROMPT + KIMI_WITNESS_STEPS
    seq = torch.from_numpy(np.random.default_rng(42).integers(
        0, full["vocab_size"], n_tok).astype(np.int64)).to(dev)
    rows = torch.arange(KIMI_WITNESS_PROMPT - 1, n_tok, device=dev)
    v = full["vocab_size"]

    def reading(got, want):
        err = (got - want).pow(2).mean(-1).sqrt() / want.pow(2).mean(
            -1).sqrt()
        return {"median": float(err.median()), "max": float(err.max()),
                "flip_share": float((got.argmax(-1) != want.argmax(-1))
                                    .float().mean())}

    def served(model, params):
        with torch.no_grad():
            lg, cache = model.prefill(params, {"tokens": seq[
                None, :KIMI_WITNESS_PROMPT].int()}, n_tok)
            out = [lg[0, -1, :v].float()]
            for t in range(KIMI_WITNESS_PROMPT, n_tok):
                lg, cache = model.decode(params, seq[None, t:t + 1].int(),
                                         cache)
                out.append(lg[0, -1, :v].float())
        return torch.stack(out)

    line = {"prompt": KIMI_WITNESS_PROMPT, "steps": KIMI_WITNESS_STEPS}
    for layers in (5, 13, 27):
        lac = full["linear_attn_config"]
        cfg = {**full, "num_hidden_layers": layers, "linear_attn_config": {
            **lac, "full_attn_layers": [i for i in lac["full_attn_layers"]
                                        if i <= layers],
            "kda_layers": [i for i in lac["kda_layers"] if i <= layers]}}
        params = cb.make_params(cfg, 5, dev)
        model = cb.program(cfg)
        want = ref.logits(cfg, params, seq, rows)
        line[f"layers_{layers}"] = reading(served(model, params), want)
        if layers == 27:
            line["layers_27_fp8"] = reading(
                ref.logits(cfg, params, seq, rows, fp8=True), want)
            ref.CONTROL = "bf16_state"
            try:
                line["layers_27_bf16_state"] = reading(
                    ref.logits(cfg, params, seq, rows, fp8=True), want)
            finally:
                ref.CONTROL = "fp8"
            params["moe"]["router_bias"].zero_()
            want = ref.logits(cfg, params, seq, rows)
            line["layers_27_no_router_bias"] = reading(
                served(model, params), want)
        del params, model, want
        torch.cuda.empty_cache()
    line["phase_s"] = time.perf_counter() - t_phase
    print("kimi_depth " + json.dumps(line))

def encdec_paths(np, torch, dev, libs):
    """12d. seamless-m4t-medium at full width: f32 prefill(S-1) + one
    decode step against the teacher-forced forward, then bf16 serving with
    the frames as side inputs (an ``encdec`` line)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeConfig

    t_phase = time.perf_counter()
    cfg = get_config("seamless-m4t-medium", dtype="float32")
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0), dev)
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    b, s = ENC_CHECK_BATCH, ENC_CHECK_SEQ
    frames = torch.from_numpy(rng.standard_normal(
        (b, ENC_FRAMES, cfg.d_model)).astype(np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    _zero(libs)
    with torch.no_grad():
        full, _ = model.forward(params, {"frames": frames, "tokens": toks})
        pl, cache = model.prefill(
            params, {"frames": frames, "tokens": toks[:, :s - 1]}, s + 8)
        dl, _ = model.decode(params, toks[:, s - 1:], cache)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(full).all()):
        fail(f"{cfg.name} forward logits not finite")
    errs = {"prefill": float((pl[:, -1] - full[:, s - 2]).abs().max()),
            "decode": float((dl[:, -1] - full[:, s - 1]).abs().max())}
    line = {"model": cfg.name, "params": cfg.param_count(),
            "f32": {"batch": b, "frames": ENC_FRAMES, "seq": s,
                    "max_abs_err": errs, "atol": LM_LOGIT_ATOL,
                    "logit_absmax": float(full.abs().max())}}
    if max(errs.values()) > LM_LOGIT_ATOL:
        fail(f"{cfg.name} f32 prefill / decode against the forward: {errs}")
    del full, pl, dl, cache
    params16 = _cast_weights(params, torch.bfloat16)
    del params
    torch.cuda.empty_cache()
    m16 = build_model(cfg.replace(dtype="bfloat16"))
    prompts = rng.integers(0, cfg.vocab, (ENC_SERVE_BATCH, ENC_SERVE_PROMPT),
                           dtype=np.int32)
    extra = {"frames": rng.standard_normal(
        (ENC_SERVE_BATCH, ENC_FRAMES, cfg.d_model)).astype(np.float32)}
    scfg = ServeConfig(max_batch=ENC_SERVE_BATCH,
                       max_seq=ENC_SERVE_PROMPT + SERVE_NEW + 8)
    rows, first = serve_runs(np, m16, params16, scfg, prompts, SERVE_NEW,
                             SERVE_POLICIES, cfg.vocab, extra=extra)
    with torch.no_grad():
        batch = {"tokens": torch.from_numpy(prompts).to(dev),
                 "frames": torch.from_numpy(extra["frames"]).to(dev)}
        _, cache = m16.prefill(params16, batch, scfg.max_seq)
        step = device_profile(torch, lambda: m16.decode(
            params16, batch["tokens"][:, -1:], cache))
    line["bf16_serve"] = {
        "batch": ENC_SERVE_BATCH, "frames": ENC_FRAMES,
        "prompt": ENC_SERVE_PROMPT, "new_tokens": SERVE_NEW, "runs": rows,
        "tokens_head": first[:, :8].tolist(), "profile_decode_step": step}
    del params16, cache
    torch.cuda.empty_cache()
    line["launches"] = {lib.name: dict(lib.launches) for lib in libs}
    line["phase_s"] = time.perf_counter() - t_phase
    print("encdec " + json.dumps(line))


def vlm_paths(np, torch, dev, libs, flash_lib):
    """12e. pixtral-12b at full width: f32 flash against plain attention on
    its first 4 layers, the bf16 scoring forward over 256 patch + 2048 text
    positions (40 flash launches) with its loss over the text, and serving
    with the patch embeddings riding the prompt's transfer (a ``vlm``
    line). Returns the path's flash launches by symbol."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention.kernel import SYMBOL
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeConfig

    t_phase = time.perf_counter()
    cfg = get_config("pixtral-12b")
    rng = np.random.default_rng(0)
    seq = rng.integers(0, cfg.vocab, (1, VLM_TEXT + 1), dtype=np.int64)
    batch = {"tokens": torch.from_numpy(seq[:, :-1]).to(dev),
             "labels": torch.from_numpy(seq[:, 1:]).to(dev),
             "patch_embeds": torch.from_numpy(rng.standard_normal(
                 (1, cfg.n_prefix_tokens, cfg.d_model)).astype(
                     np.float32)).to(dev)}
    s_all = cfg.n_prefix_tokens + VLM_TEXT

    def through_flash(c, fn):
        return launched(torch, flash_lib, SYMBOL[getattr(torch, c.dtype)],
                        c.n_layers, fn, f"one {c.name} {c.dtype} forward "
                        f"({c.n_layers} layers)")

    _zero(libs)
    # f32, the first 4 layers (the same draws as the full model's)
    c4 = cfg.replace(n_layers=VLM_F32_LAYERS, dtype="float32")
    p4 = build_model(c4).init(torch.Generator(dev).manual_seed(0), dev)
    with torch.no_grad():
        lf, _ = through_flash(c4, lambda: build_model(c4.replace(
            use_pallas_attention=True)).forward(p4, batch))
        lp, _ = build_model(c4).forward(p4, batch)
        torch.cuda.synchronize()
    err = float((lf - lp).abs().max())
    line = {"model": cfg.name, "params": cfg.param_count(),
            "f32_first_layers": {"layers": VLM_F32_LAYERS, "seq": s_all,
                                 "max_abs_err": err, "atol": LM_LOGIT_ATOL,
                                 "logit_absmax": float(lp.abs().max())}}
    if err > LM_LOGIT_ATOL:
        fail(f"{cfg.name} f32 ({VLM_F32_LAYERS} layers) flash vs plain "
             f"attention: max abs err {err} > atol {LM_LOGIT_ATOL}")
    del lf, lp, p4
    torch.cuda.empty_cache()
    # bf16 at full depth, its norms f32 as drawn
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    fm = build_model(cfg.replace(use_pallas_attention=True))
    with torch.no_grad():
        logits, _ = through_flash(cfg, lambda: fm.forward(params, batch))
        want = (1, s_all, cfg.vocab_padded)
        if tuple(logits.shape) != want or not bool(
                torch.isfinite(logits).all()):
            fail(f"{cfg.name} logits {tuple(logits.shape)} (want {want}) "
                 f"or not finite")
        del logits
        total, met = through_flash(cfg, lambda: fm.loss(params, batch))
        line["bf16"] = {
            "batch": 1, "prefix": cfg.n_prefix_tokens, "text": VLM_TEXT,
            "init_s": time.perf_counter() - t0,
            "memory_gb": torch.cuda.memory_allocated(dev) / 1e9,
            "loss_text": float(met["loss"]),
            "forward_ms": wall_ms(torch, lambda: through_flash(
                cfg, lambda: fm.forward(params, batch))),
            "profile_forward": device_profile(torch, lambda: through_flash(
                cfg, lambda: fm.forward(params, batch)),
                match="flash_fwd_tc")}
        if not np.isfinite(float(total)):
            fail(f"{cfg.name} loss {float(total)} not finite")
    launches = dict(flash_lib.launches)
    # serving: the patch embeddings ride the prompt's scatter-gather TX
    # under the kernel-level policy
    model = build_model(cfg)
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           dtype=np.int32)
    extra = {"patch_embeds": rng.standard_normal(
        (SERVE_BATCH, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)}
    scfg = ServeConfig(max_batch=SERVE_BATCH,
                       max_seq=SERVE_PROMPT + SERVE_NEW + 8
                       + cfg.n_prefix_tokens)
    rows, first = serve_runs(np, model, params, scfg, prompts, SERVE_NEW,
                             SERVE_POLICIES, cfg.vocab, extra=extra)
    line["serve"] = {"batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
                     "new_tokens": SERVE_NEW, "max_seq": scfg.max_seq,
                     "patch_embeds_bytes": extra["patch_embeds"].nbytes,
                     "runs": rows, "tokens_head": first[:, :8].tolist()}
    del params
    torch.cuda.empty_cache()
    line["launches"] = {lib.name: dict(lib.launches) for lib in libs}
    line["phase_s"] = time.perf_counter() - t_phase
    print("vlm " + json.dumps(line))
    return launches


def _to_dev(torch, hb, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}


def _samples(torch, params):
    """The first 4,096 elements of every param leaf, copied (a full copy
    of qwen2.5-3b's params would take 6.8 GB of the step's memory)."""
    from repro_torch.utils.pytree import tree_leaves
    return [p.reshape(-1)[:4096].clone() for p in tree_leaves(params)]


class _PlainSSD:
    """Within: the models' mixers call ``ssd_full(use_kernel=False)``, the
    plain route, everywhere."""

    def __enter__(self):
        import functools

        from repro_torch.models.layers import ssm
        self._real = ssm.ssd_full
        ssm.ssd_full = functools.partial(self._real, use_kernel=False)

    def __exit__(self, *exc):
        from repro_torch.models.layers import ssm
        ssm.ssd_full = self._real


def f8_reading(np, torch, dev, ssd_lib, cfg) -> dict:
    """One f32 batch's gradients with the SSD through the kernels (the
    autograd.Function) against the plain route: each leaf's relative L2
    error, the worst, and the forward logits' gap."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMSource
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import value_and_grad
    from repro_torch.utils.pytree import tree_leaves, tree_paths

    cfg32 = cfg.replace(dtype="float32")
    model = build_model(cfg32)
    params = model.init(torch.Generator(dev).manual_seed(1), dev)
    batch = _to_dev(torch, SyntheticLMSource(
        DataConfig(F8_BATCH, F8_SEQ, seed=1), cfg32).next_host_batch(0), dev)
    per_pass = cfg.n_layers * (2 if cfg.remat else 1)  # + the recompute
    lk, _, gk = launched(torch, ssd_lib, SSD_SYMS, per_pass,
                         lambda: value_and_grad(model, params, batch),
                         "one f32 value_and_grad through the SSD kernels")
    with _PlainSSD():
        lp, _, gp = launched(torch, ssd_lib, SSD_SYMS, 0,
                             lambda: value_and_grad(model, params, batch),
                             "one f32 value_and_grad, plain SSD")
    rel = {}
    for (path, a), b in zip(tree_paths(gk), tree_leaves(gp)):
        a, b = a.float(), b.float()
        if not bool(torch.isfinite(a).all()):
            fail(f"F8: gradient {path} through the kernels not finite")
        rel["/".join(map(str, path))] = float(
            (a - b).norm() / b.norm().clamp_min(1e-30))
    worst = max(rel, key=rel.get)
    with torch.no_grad():
        lk_logits = model.forward(params, batch)[0]
        with _PlainSSD():
            lp_logits = model.forward(params, batch)[0]
        logit_gap = float((lk_logits - lp_logits).abs().max())
        del lk_logits, lp_logits
    out = {"layers": cfg.n_layers, "dtype": "float32", "batch": F8_BATCH,
           "seq": F8_SEQ, "logits_max_abs_diff": logit_gap,
           "loss_kernel": float(lk), "loss_plain": float(lp),
           "ssd_launches_a_pass": per_pass, "worst_leaf": worst,
           "worst_rel_l2": rel[worst], "rel_l2": rel}
    del params, gk, gp
    torch.cuda.empty_cache()
    return out


def f8_gate(np, torch, dev, ssd_lib, cfg) -> dict:
    """F8 at full width: the gradients through the kernels against the
    plain route F8_LAYERS deep, each leaf within F8_REL relative L2; the
    same reading at full depth beside it, not gated (see F8_LAYERS)."""
    gate = f8_reading(np, torch, dev, ssd_lib,
                      cfg.replace(n_layers=F8_LAYERS))
    gate["rel_l2_limit"] = F8_REL
    full = f8_reading(np, torch, dev, ssd_lib, cfg)
    full.pop("rel_l2")
    gate["full_depth"] = full
    worst = gate["worst_leaf"]
    if gate["worst_rel_l2"] > F8_REL:
        fail(f"F8: gradient {worst} through the SSD kernels is "
             f"{gate['worst_rel_l2']} (relative L2) from the plain route's "
             f"> {F8_REL}; every leaf: {json.dumps(gate['rel_l2'])}; "
             f"forward logits {gate['logits_max_abs_diff']} apart")
    return gate


def train_cell(np, torch, dev, libs, arch: str, name: str) -> dict:
    """``TRAIN_STEPS`` bf16 AdamW steps of ``arch`` at full width (remat
    on) through ``StagedPipeline`` under INTERRUPT with a TransferEngine,
    every launch count set to 0 just before and read just after; then one
    more step under the profiler. Fails unless every loss is finite,
    every step_ok 1, step 0's loss within TRAIN_LOSS_ATOL of the no-grad
    forward's, every param leaf moved, flash never launched and, for the
    ssm family, each SSD symbol launched once a layer in the forward and
    once more in the remat recompute (never in the backward: F8's
    Function differentiates the plain version), after F8's gate."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.transfer import TransferEngine, TransferPolicy
    from repro_torch.data.pipeline import (
        DataConfig, StagedPipeline, SyntheticLMSource)
    from repro_torch.kernels.flash_attention.kernel import FLASH
    from repro_torch.kernels.ssd_scan.kernel import SSD
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import TrainConfig, Trainer, make_train_step
    from repro_torch.utils.pytree import tree_leaves

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if cfg.dtype != "bfloat16" or not cfg.remat:
        fail(f"{arch}: expected a bf16 config with remat, got {cfg.dtype}, "
             f"remat={cfg.remat}")
    model = build_model(cfg)
    line = {"model": cfg.name, "params": cfg.param_count(),
            "dtype": cfg.dtype, "remat": cfg.remat_policy,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS}
    ssd_expect = 2 * cfg.n_layers if cfg.family == "ssm" else 0
    if ssd_expect:
        line["f8"] = f8_gate(np, torch, dev, SSD, cfg)
    gc.collect()  # earlier phases' engines may hold tensors in cycles
    torch.cuda.empty_cache()
    torch.cuda.init()  # the allocator knows no device before it
    line["memory_before_gb"] = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    src = SyntheticLMSource(DataConfig(TRAIN_BATCH, TRAIN_SEQ, seed=0), cfg)
    with torch.no_grad():
        _, m0 = model.loss(params, _to_dev(torch, src.next_host_batch(0),
                                           dev))
    line["forward_loss_step0"] = float(m0["loss"])
    before = _samples(torch, params)
    opt = adamw_init(params)
    tcfg = TrainConfig(steps=TRAIN_STEPS, warmup=1, log_every=1)
    engine = TransferEngine(TransferPolicy.kernel_level(), device=dev)
    pipe = StagedPipeline(src, TransferPolicy.kernel_level(), engine=engine)
    trainer = Trainer(model, tcfg)
    try:
        _zero(libs)
        trainer.run(pipe, initial_state=(params, opt))
        torch.cuda.synchronize()
        launches = {lib.name: dict(lib.launches) for lib in libs}
        hist = trainer.history
        line["steps_log"] = [{k: r[k] for k in ("step", "loss", "step_ok",
                                                "grad_norm", "dt_s")}
                             for r in hist]
        line["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        for r in hist:
            if not (np.isfinite(r["loss"]) and r["step_ok"] == 1.0):
                fail(f"{name}: step {r['step']} loss {r['loss']}, step_ok "
                     f"{r['step_ok']}")
        d0 = abs(hist[0]["loss"] - line["forward_loss_step0"])
        line["step0_loss_vs_forward"] = d0
        if d0 > TRAIN_LOSS_ATOL:
            fail(f"{name}: step 0 loss {hist[0]['loss']} vs the no-grad "
                 f"forward's {line['forward_loss_step0']} (> "
                 f"{TRAIN_LOSS_ATOL})")
        after = _samples(torch, params)
        moved = [float((a != b).float().mean()) for a, b in
                 zip(after, before)]
        line["leaves_moved"] = sum(m > 0 for m in moved)
        line["leaves"] = len(moved)
        line["moved_fraction_min"] = min(moved)
        if min(moved) == 0:
            fail(f"{name}: {moved.count(0.0)} param leaves did not move")
        if any(launches[FLASH.name].values()):
            fail(f"{name}: the flash kernel ran during training: "
                 f"{launches[FLASH.name]}")
        want = {s: ssd_expect * TRAIN_STEPS for s in SSD_SYMS}
        if launches[SSD.name] != want:
            fail(f"{name}: SSD launches {launches[SSD.name]}, expected "
                 f"{want}")
        line["launches"] = launches
        line["ssd_launches_a_step"] = ssd_expect
        dts = sorted(r["dt_s"] for r in hist)
        med = (dts[(len(dts) - 1) // 2] + dts[len(dts) // 2]) / 2
        line["step_ms_median"] = med * 1e3
        line["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / med
        # one more step under the profiler (the schedule's last scale)
        step_fn = make_train_step(model, tcfg)
        batch = next(pipe)
        prof = device_profile(torch, lambda: step_fn(params, opt, batch),
                              top=8, spans=("optim.adamw",))
        adamw = prof["spans"]["optim.adamw"]
        prof["adamw_device_ms"] = adamw
        prof["adamw_share"] = adamw / prof["device_ms"]
        line["profile_step"] = prof
        n = sum(p.numel() for p in tree_leaves(params))
        # the params and the optimizer state read and written once
        # (ADAMW_BYTES_PER_PARAM), against 8 FLOPs a param a token:
        # forward 2, backward 4, the remat recompute 2
        line["bound_ms"], line["bound_by"] = bound_ms(
            ADAMW_BYTES_PER_PARAM * n, 8 * n * TRAIN_BATCH * TRAIN_SEQ,
            BF16_FLOPS)
        line["adamw_bound_ms"] = (ADAMW_BYTES_PER_PARAM * n
                                  / HBM_BYTES_PER_S * 1e3)
    finally:
        pipe.close()
        engine.close()
    del params, opt, trainer, before
    torch.cuda.empty_cache()
    line["phase_s"] = time.perf_counter() - t_phase
    print(f"{name} " + json.dumps(line))
    return line


def train_lm_phase(np, torch, dev, libs) -> dict:
    """The example's lm-100m (f32): LM100M_STEPS steps with async
    checkpoints every LM100M_EVERY through an INTERRUPT pipeline over an
    engine; a second Trainer on the same directory, as if the job had died
    after step 20's write, resumes there and must reach the first run's
    losses within LM100M_LOSS_ATOL; the checkpoint's bytes and write ms;
    the TX us a batch under each of the three managements."""
    import os
    import shutil

    from repro_torch.checkpoint.checkpoint import _snapshot, save_checkpoint
    from repro_torch.core.transfer import TransferEngine, TransferPolicy
    from repro_torch.data.pipeline import (
        DataConfig, StagedPipeline, SyntheticLMSource)
    from repro_torch.examples.train_lm import lm_100m
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.utils.pytree import tree_bytes, tree_map

    t_phase = time.perf_counter()
    cfg = lm_100m()
    model = build_model(cfg)
    ckdir = ROOT / "build" / "chip_smoke_lm100m"
    shutil.rmtree(ckdir, ignore_errors=True)
    tcfg = TrainConfig(steps=LM100M_STEPS, n_microbatches=2, warmup=20,
                       log_every=1, opt=AdamWConfig(lr=6e-4),
                       checkpoint_dir=str(ckdir),
                       checkpoint_every=LM100M_EVERY)
    src = SyntheticLMSource(DataConfig(8, 256), cfg)
    policy = TransferPolicy.kernel_level()
    engine = TransferEngine(policy, device=dev)
    line = {"model": cfg.name, "params": cfg.param_count(),
            "dtype": cfg.dtype, "steps": LM100M_STEPS,
            "checkpoint_every": LM100M_EVERY}
    runs = []
    try:
        for start in (0, LM100M_EVERY):
            pipe = StagedPipeline(src, policy, start_step=start,
                                  engine=engine)
            trainer = Trainer(model, tcfg)
            _zero(libs)
            try:
                out = trainer.run(pipe, device=dev)
            finally:
                pipe.close()
            runs.append((trainer, out))
            if start:
                break
            # the job dies after step 20's checkpoint: step 40's never
            # happened
            man = ckdir / "manifest.json"
            entries = json.loads(man.read_text())["checkpoints"]
            for e in entries:
                if e["step"] > LM100M_EVERY:
                    os.remove(ckdir / e["file"])
            man.write_text(json.dumps({"checkpoints": [
                e for e in entries if e["step"] <= LM100M_EVERY]}))
            line["checkpoint_bytes"] = os.path.getsize(
                ckdir / f"step-{LM100M_EVERY:08d}.npz")
    finally:
        engine.close()
    (t1, out1), (t2, out2) = runs
    l1 = [r["loss"] for r in t1.history]
    l2 = [r["loss"] for r in t2.history]
    line["losses"] = l1
    line["resumed_losses"] = l2
    line["restarts"] = out2["fault"].restarts
    if not l1[-1] < l1[0]:
        fail(f"train_lm: loss {l1[0]} -> {l1[-1]} did not decrease")
    if (out2["fault"].restarts != 1 or [r["step"] for r in t2.history]
            != list(range(LM100M_EVERY, LM100M_STEPS))):
        fail(f"train_lm: the second Trainer did not resume at step "
             f"{LM100M_EVERY}: restarts {out2['fault'].restarts}, steps "
             f"{[r['step'] for r in t2.history]}")
    gap = max(abs(a - b) for a, b in zip(l2, l1[LM100M_EVERY:]))
    line["resumed_max_loss_gap"] = gap
    if gap > LM100M_LOSS_ATOL:
        fail(f"train_lm: the resumed run's losses are {gap} from the first "
             f"run's (> {LM100M_LOSS_ATOL})")
    line["step_ms_median"] = sorted(r["dt_s"] for r in t1.history)[
        LM100M_STEPS // 2] * 1e3
    state = {"params": out2["params"], "opt": out2["opt_state"]}
    line["state_bytes"] = tree_bytes(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = tree_map(_snapshot, state)
    line["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    save_checkpoint(str(ckdir / "timed"), LM100M_STEPS, snap)
    line["write_ms"] = (time.perf_counter() - t0) * 1e3
    del snap, state, out1, out2, runs
    shutil.rmtree(ckdir, ignore_errors=True)
    # staging alone: STAGE_BATCHES batches under each management, each
    # through an engine of the same policy
    stage = {}
    for pol in (TransferPolicy.user_level_polling(),
                TransferPolicy.user_level_scheduled(),
                TransferPolicy.kernel_level()):
        eng = TransferEngine(pol, device=dev)
        pipe = StagedPipeline(src, pol, engine=eng)
        nexts = []
        try:
            for _ in range(STAGE_BATCHES):
                t0 = time.perf_counter()
                next(pipe)
                torch.cuda.synchronize()
                nexts.append((time.perf_counter() - t0) * 1e6)
        finally:
            pipe.close()
        tx = sorted(st.wall_s * 1e6 for st in list(eng.stats)
                    if st.direction == "tx")
        eng.close()
        stage[pol.tag] = {"tx_us_median": tx[len(tx) // 2],
                          "tx_us_min": tx[0], "tx_count": len(tx),
                          "next_us_median": sorted(nexts)[len(nexts) // 2],
                          "batch_bytes": sum(
                              v.nbytes for v in src.next_host_batch(0)
                              .values())}
    line["staging"] = stage
    torch.cuda.empty_cache()
    line["phase_s"] = time.perf_counter() - t_phase
    print("train_lm " + json.dumps(line))
    return line


def dist_phase(np, torch, dev, libs, flash_lib) -> dict:
    """12i. the distributed layer on a world of one NCCL rank on the card
    (a ``dist`` line): the local mesh, the four rings at n = 1 (bitwise
    ``x`` and ``x @ w``), ``param_sharding`` of qwen2.5-3b's full-width
    params (every placement ``Replicate()``) beside the plan of the same
    shapes on the (16, 16) production mesh from the rules' specs alone,
    qwen batches staged as DTensors under the three managements (bitwise
    the host batch, TX us a batch), and ``device_streamed_scan`` over the
    36 layers in bf16 from pinned host memory, bitwise the resident
    ``stack_apply``, 36 tensor-core flash launches, with the resident,
    streamed and copy ms and the overlap share. Returns the streamed
    run's flash launches, by C symbol."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.registry import get_config
    from repro_torch.core import pipeline_collectives as pc
    from repro_torch.core.streaming import device_streamed_scan
    from repro_torch.core.transfer import TransferEngine, TransferPolicy
    from repro_torch.data.pipeline import (
        DataConfig, StagedPipeline, SyntheticLMSource)
    from repro_torch.dist.sharding import batch_sharding_tree, param_sharding
    from repro_torch.kernels.flash_attention.kernel import SYMBOL
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.models.api import build_model
    from repro_torch.utils.pytree import (
        tree_bytes, tree_leaves, tree_map, tree_paths)

    t_phase = time.perf_counter()
    store = ROOT / "build" / "chip_smoke_dist_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1, device_id=dev)
    line = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    try:
        # (a) the local mesh
        mesh = make_local_mesh()
        line["mesh"] = {"device_type": mesh.device_type,
                        "shape": list(mesh.shape),
                        "names": list(mesh.mesh_dim_names)}
        if mesh.device_type != "cuda" or tuple(mesh.shape) != (1, 1):
            fail(f"dist: local mesh {line['mesh']}")
        # (b) the rings at n = 1
        group = mesh.get_group("model")
        g = torch.Generator().manual_seed(3)
        x = torch.randn((512, 256), generator=g).to(dev)
        w = torch.randn((256, 384), generator=g).to(dev)
        rings = {
            "ring_all_gather": torch.equal(pc.ring_all_gather(x, group), x),
            "ring_reduce_scatter": torch.equal(
                pc.ring_reduce_scatter(x, group), x),
            "overlapped_matmul_ag": torch.equal(
                pc.overlapped_matmul_ag(x, w, group), x @ w),
            "overlapped_matmul_rs": torch.equal(
                pc.overlapped_matmul_rs(x, w, group), x @ w)}
        line["rings_bitwise"] = rings
        if not all(rings.values()):
            fail(f"dist: rings at n = 1 {rings}")

        # (c) the sharding rules over qwen2.5-3b's full-width params
        cfg = get_config("qwen2.5-3b", dtype="bfloat16").replace(
            use_pallas_attention=True)
        model = build_model(cfg)
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        shardings = tree_leaves(param_sharding(params, mesh))
        if any(not p.is_replicate() for sh in shardings
               for p in sh.placements):
            fail("dist: a placement on the (1, 1) mesh is not Replicate()")
        plan = tree_leaves(param_sharding(params, DIST_PRODUCTION))
        leaves = tree_leaves(params)
        per_dev = sum(
            t.numel() * t.element_size() // math.prod(
                DIST_PRODUCTION[n] for s in sh.spec if s is not None
                for n in ((s,) if isinstance(s, str) else s))
            for t, sh in zip(leaves, plan))
        line["sharding"] = {
            "leaves": len(shardings), "all_replicate": True,
            "param_bytes": tree_bytes(params),
            "production_16x16": {
                "bytes_per_device": per_dev,
                "leaves_sharded": sum(any(s is not None for s in sh.spec)
                                      for sh in plan),
                "specs": {"/".join(map(str, k)): list(sh.spec) for (k, _), sh
                          in zip(tree_paths(params), plan)}}}

        # (d) sharded staging of qwen batches under each management
        src = SyntheticLMSource(DataConfig(DIST_STAGE_BATCH, DIST_STAGE_SEQ),
                                cfg)
        stage = {}
        for pol in (TransferPolicy.user_level_polling(),
                    TransferPolicy.user_level_scheduled(),
                    TransferPolicy.kernel_level()):
            eng = TransferEngine(pol, device=dev)
            pipe = StagedPipeline(src, pol, engine=eng, shardings=(
                batch_sharding_tree(src.next_host_batch(0), mesh)))
            try:
                for i in range(STAGE_BATCHES):
                    b = next(pipe)
                    for k, v in src.next_host_batch(i).items():
                        t = b[k]
                        if not (isinstance(t, DTensor)
                                and t.to_local().is_cuda
                                and np.array_equal(t.to_local().cpu().numpy(),
                                                   v)):
                            fail(f"dist: staged {k} of batch {i} under "
                                 f"{pol.tag} is not the host batch on the "
                                 f"card as a DTensor")
            finally:
                pipe.close()
            tx = sorted(st.wall_s * 1e6 for st in list(eng.stats)
                        if st.direction == "tx")
            eng.close()
            stage[pol.tag] = {"tx_us_median": tx[len(tx) // 2],
                              "tx_us_min": tx[0], "tx_count": len(tx)}
        line["staging"] = stage

        # (e) the 36 layers streamed from pinned host memory
        host = tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True).copy_(t),
            params["blocks"])
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab, (LM_BATCH, LM_SEQ), dtype=np.int64)).to(dev)
        positions = torch.arange(LM_SEQ, device=dev)
        sym = SYMBOL[torch.bfloat16]

        def layer(p, h):
            return lm.layer_apply(cfg, "attention", p, p["attn"], h,
                                  positions=positions)[0]

        def h2d(p):
            return tree_map(lambda t: t.to(dev, non_blocking=True), p)

        def resident():
            return lm.stack_apply(cfg, params, x0, None, positions)[0]

        def streamed():
            return device_streamed_scan(layer, host, x0, gather_fn=h2d)

        def copies():
            return [h2d(p) for p in lm.unstack(host)]

        with torch.no_grad():
            x0 = lm.embed_tokens(cfg, params, toks)
            want = launched(torch, flash_lib, sym, cfg.n_layers, resident,
                            "the resident scan")
            _zero(libs)
            got = streamed()
            torch.cuda.synchronize()
            launches = dict(flash_lib.launches)
            if launches != {s: cfg.n_layers * (s == sym) for s in launches}:
                fail(f"dist: the streamed scan launched {launches}")
            if not bool(torch.isfinite(got).all()) or not torch.equal(
                    got, want):
                fail("dist: the streamed hidden states are not bitwise the "
                     "resident ones")
            del got, want
            res_ms = wall_ms(torch, resident)
            str_ms = wall_ms(torch, streamed)
            copy_ms = wall_ms(torch, copies)
        copy_bytes = tree_bytes(host)
        line["streamed"] = {
            "model": cfg.name, "layers": cfg.n_layers, "batch": LM_BATCH,
            "seq": LM_SEQ, "dtype": "bfloat16",
            "layer_params": sum(t.numel() for t in tree_leaves(host)),
            "host_bytes": copy_bytes, "pinned": all(
                t.is_pinned() for t in tree_leaves(host)),
            "bitwise_resident": True, "launches": launches,
            "resident_ms": res_ms, "streamed_ms": str_ms, "copy_ms": copy_ms,
            "copy_gb_per_s": copy_bytes / copy_ms / 1e6,
            "overlap_share": (copy_ms + res_ms - str_ms) / min(copy_ms,
                                                               res_ms)}
        del params, host, x0
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    line["phase_s"] = time.perf_counter() - t_phase
    print("dist " + json.dumps(line))
    return launches


def elastic_phase() -> dict:
    """12j. ``repro_torch.examples.elastic_restart``'s three phases on the
    card (an ``elastic`` line): 10 steps of the h2o-danube-1.8b smoke config
    with checkpoints at 5 and 10, a fresh Trainer resumed at 10
    (``restarts == 1``), and the shrunken plan with its ``reshard_plan``;
    its checkpoints go to ``build/chip_smoke_elastic``, removed after."""
    import shutil

    from repro_torch.examples.elastic_restart import main as elastic_main

    t_phase = time.perf_counter()
    ckdir = ROOT / "build" / "chip_smoke_elastic"
    try:
        out = elastic_main(["--checkpoint-dir", str(ckdir)])
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    if out["restarts"] != 1 or out["first_resumed_step"] != 10:
        fail(f"elastic: restarts {out['restarts']}, first resumed step "
             f"{out['first_resumed_step']}")
    if not all(math.isfinite(v) for v in out["losses"]):
        fail(f"elastic: losses {out['losses']}")
    plan = out["plan"]
    print("elastic " + json.dumps({
        "restarts": out["restarts"],
        "first_resumed_step": out["first_resumed_step"],
        "losses": out["losses"],
        "plan": {"shape": list(plan.shape),
                 "axis_names": list(plan.axis_names),
                 "n_devices": plan.n_devices},
        "reshard": out["reshard"],
        "phase_s": time.perf_counter() - t_phase}))
    return out


def transfer_modes_phase(np, torch, dev, libs, conv_lib) -> dict:
    """12k. ``repro_torch.examples.transfer_modes`` on the card (a
    ``transfer_modes`` line): the four Table-I policies' logits bitwise
    equal to each other and within ``LOGIT_TOL`` of the plain forward, 5
    conv launches a frame (4 policies x 4 frames),
    the fault demo quarantining channel 0 after its two drops and
    rejoining it after the probe with faults == retries ==
    retry_successes == 2, and the TOKEN class at 51 completions and 1632
    bytes; the Table-I rows, the coalescing ratio and the token RX p50
    printed beside them. Returns the path's conv launches."""
    from repro_torch.examples.transfer_modes import main as tm_main

    t_phase = time.perf_counter()
    _zero(libs)
    out = tm_main([])
    torch.cuda.synchronize()
    launches = {lib.name: dict(lib.launches) for lib in libs}
    rows = out["table_i"]["rows"]
    frames = 4 * len(rows)  # a warm-up frame and 3 timed a policy
    if conv_lib.launches["conv2d_bias_act"] != 5 * frames:
        fail(f"transfer_modes: {conv_lib.launches} over {frames} frames")
    first = rows[0]["logits"]
    if not np.isfinite(first).all() or not all(
            np.array_equal(r["logits"], first) for r in rows):
        fail("transfer_modes: the policies' logits are not bitwise equal")
    # against the plain forward (plain conv) of the example's params and
    # frame: a generator seeded 0, default_rng(0)
    from repro_torch.accel.roshambo import RoShamBoCNN
    from repro_torch.kernels.conv2d.ref import conv2d_relu_ref

    cnn = RoShamBoCNN()
    params = cnn.init(torch.Generator().manual_seed(0), device=dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 64, 64, 1)).astype(np.float32)).to(dev)
    for spec in cnn.cfg.layers:
        x = cnn.layer_apply(spec, params[spec.name], x, conv=conv2d_relu_ref)
    plain = (x.reshape(1, -1) @ params["fc"]["w"]
             + params["fc"]["b"]).cpu().numpy()
    np.testing.assert_allclose(first, plain, rtol=LOGIT_TOL[0],
                               atol=LOGIT_TOL[1])
    faults = out["faults"]
    ledger = faults["ledger"]
    if (faults["quarantined_after_tx"] != [0]
            or faults["quarantined_after_probe"] != []
            or not ledger["faults"] == ledger["retries"]
            == ledger["retry_successes"] == 2):
        fail(f"transfer_modes: fault demo {faults}")
    token = out["unified"]["classes"]["token"]
    if token != {"completed": 51, "bytes_total": 1632}:
        fail(f"transfer_modes: token class {token}")
    if not out["coalescing"]["rx_bitwise"]:
        fail("transfer_modes: the batched RX is not the TX'd arrays")
    print("transfer_modes " + json.dumps({
        "table_i": [{k: r[k] for k in ("mode", "policy", "tx_us_per_B",
                                       "rx_us_per_B", "frame_ms")}
                    for r in rows],
        "logits_bitwise": True,
        "logits_vs_plain_max_abs_err": float(np.abs(first - plain).max()),
        "sparsity": out["table_i"]["sparsity"],
        "submit_ms": out["unified"]["submit_ms"],
        "token_rx_p50_ms": out["unified"]["token_rx_p50_ms"],
        "token_rx_max_ms": out["unified"]["token_rx_max_ms"],
        "token_class": token, "tenant_demo": out["unified"]["tenant_demo"],
        "coalescing_ratio": out["coalescing"]["ratio"],
        "coalescing": out["coalescing"], "faults": faults,
        "launches": launches, "phase_s": time.perf_counter() - t_phase}))
    return launches[conv_lib.name]


def _vs_plain(torch, got, want, what: str) -> dict:
    """``got`` held against the plain run's ``want``: bitwise, else within
    the bf16 limit of the MoE's tests (rtol 2e-2, atol 2e-2); fails
    otherwise or where ``got`` is not finite."""
    got, want = got.float(), want.float()
    bitwise = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    within = bool(((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all())
    if not (bitwise or within) or not torch.isfinite(got).all():
        fail(f"dryrun: {what} are {err} from the plain run's")
    return {"bitwise": bitwise, "max_abs_err": err,
            "held": "bitwise" if bitwise else "rtol 2e-2, atol 2e-2 (bf16)",
            "shape": list(got.shape)}


def _tie_line(tie: dict, cfg, cell, route) -> dict:
    """The ``dryrun`` line's record of one card tie (``on_device``)."""
    pred, meas = tie["predicted"], tie["measured"]
    return {"cell": {"arch": cfg.name, "kind": cell.kind,
                     "batch": cell.global_batch, "seq": cell.seq_len,
                     "dtype": cfg.dtype, "route": route, "mesh": [1, 1]},
            "flops": {"predicted": pred["flops_per_device"],
                      "counted": meas["flops"]},
            "bytes": {"predicted": pred["bytes_per_device"],
                      "counted": meas["bytes"]},
            "peak_bytes": {"predicted": pred["peak_bytes"],
                           "counted": meas["peak_bytes"],
                           "max_memory_allocated_rise":
                           meas["max_memory_allocated_rise"],
                           "ratio": pred["peak_bytes"]
                           / max(meas["max_memory_allocated_rise"], 1)},
            "ms": meas["ms"],
            "roofline_ms": {k.replace("_term_s", ""): pred[k] * 1e3
                            for k in ("compute_term_s", "memory_term_s",
                                      "collective_term_s")},
            "bottleneck": pred["bottleneck"]}


# production cells the dry run must place on one card's memory: the MoE's
# expert parallelism, the SSM's heads on "model", the hybrid's decode
# against its sequence-sharded cache, qwen2.5-3b's decode; the B = 1
# decodes of long_500k, their products split over the idle data axes (at
# most DRYRUN_FLOPS_RATIO x the reference's FLOPs a device; h2o-danube's
# holds a 32.5 GB cache, as the reference's does); mamba2's decode_32k
# with its state head-sharded on "model" (not collective-bound)
DRYRUN_CELLS = (("qwen2.5-3b", "decode_32k"),
                ("granite-moe-1b-a400m", "prefill_32k"),
                ("mamba2-780m", "prefill_32k"), ("zamba2-1.2b", "decode_32k"),
                ("h2o-danube-1.8b", "long_500k"), ("mamba2-780m", "long_500k"),
                ("mamba2-780m", "decode_32k"))
# XLA's FLOPs a device of the reference's partitioned long_500k programs
# on the (16, 16) mesh (its HLO count from `python -m repro.launch.dryrun`
# on a CPU; a count, not a measurement of any chip)
REF_LONG_FLOPS = {"h2o-danube-1.8b": 92_308_480, "mamba2-780m": 17_525_760}
DRYRUN_FLOPS_RATIO = 1.10


def dryrun_phase(np, torch, dev, libs) -> None:
    """12l. the dry run tied to the card (a ``dryrun`` line), on a world of
    one NCCL rank: qwen2.5-3b's prefill of B 2 x S 2048 in bf16 through
    plain attention, and granite-moe-1b-a400m's through the MoE's
    expert-parallel branch, each predicted under fake tensors and then run
    on the card with params drawn there under the same counters: the
    predicted FLOPs equal to the counted ones; the predicted peak bytes
    over the rise of ``torch.cuda.max_memory_allocated``, and the run's ms
    beside the prediction's roofline terms, printed, not gated; granite's
    last logits against the plain forward's on the same params (bitwise
    where the op order is the same, else within the MoE's bf16 limit, and
    the line says which). Then mamba2-780m's bf16 decode step at full
    width the same way (B 2, one token after a prefill of 2048 into the
    cache under the port's placements, ``decode_cache_sharding``): FLOPs
    predicted = counted, the peak over the rise printed, its logits and
    new SSM state against the plain decode's from the plain prefill
    (bitwise, else within the bf16 limit, rtol / atol 2e-2; the line says
    which). No kernel launches in the phase (plain routes: plain
    attention and ``plain_ssd``; the decode step runs the recurrence).
    Then the production cells of ``DRYRUN_CELLS`` on the (16, 16) mesh
    under the ``fake`` backend must be ``ok``, each with its peak under
    the card's memory, the long_500k cells at most
    ``DRYRUN_FLOPS_RATIO`` x ``REF_LONG_FLOPS``, mamba2's decode_32k not
    ``collective``-bound."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.models.config import SHAPE_CELLS, ShapeCell

    t_phase = time.perf_counter()
    cfg = get_config("qwen2.5-3b", dtype="bfloat16")
    gcfg = get_config("granite-moe-1b-a400m", dtype="bfloat16")
    mcfg = get_config("mamba2-780m", dtype="bfloat16")
    cell = ShapeCell("prefill_2k", LM_SEQ, LM_BATCH, "prefill")
    dcell = ShapeCell("decode_2k", LM_SEQ, LM_BATCH, "decode")
    store = ROOT / "build" / "chip_smoke_dryrun_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1, device_id=dev)
    _zero(libs)
    try:
        tie = dryrun.on_device(cfg, cell, make_local_mesh(), dev)
        torch.cuda.empty_cache()
        gtie = dryrun.on_device(gcfg, cell, make_local_mesh(), dev,
                                plain=True)
        torch.cuda.empty_cache()
        mtie = dryrun.on_device(mcfg, dcell, make_local_mesh(), dev,
                                plain=True)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    torch.cuda.synchronize()
    launches = {lib.name: dict(lib.launches) for lib in libs}
    if any(n for d in launches.values() for n in d.values()):
        fail(f"dryrun: the plain route launched kernels {launches}")
    torch.cuda.empty_cache()
    for name, t in (("qwen2.5-3b", tie), ("granite-moe-1b-a400m", gtie),
                    ("mamba2-780m", mtie)):
        pred, meas = t["predicted"], t["measured"]
        if pred["flops_per_device"] != meas["flops"] or not meas["flops"] > 0:
            fail(f"dryrun: {name} predicted {pred['flops_per_device']} "
                 f"FLOPs, counted {meas['flops']} on the card")
    line = _tie_line(tie, cfg, cell, dryrun.route(cfg))
    line["launches"] = launches
    line["granite"] = dict(
        _tie_line(gtie, gcfg, cell, dryrun.route(gcfg) + [
            "expert-parallel MoE"]),
        logits_vs_plain=_vs_plain(torch, gtie["logits"], gtie["plain_logits"],
                                  "granite's expert-parallel prefill logits"))
    line["mamba2_decode"] = dict(
        _tie_line(mtie, mcfg, dcell, dryrun.route(mcfg) + [
            "recurrent decode", "state heads on model"]),
        logits_vs_plain=_vs_plain(torch, mtie["logits"], mtie["plain_logits"],
                                  "mamba2's decode logits"),
        state_vs_plain=_vs_plain(torch, mtie["cache"][0],
                                 mtie["plain_cache"][0],
                                 "mamba2's new SSM state"))
    del tie, gtie, mtie

    # the production cells under the fake backend, on this machine's torch
    cells = {c.name: c for c in SHAPE_CELLS}
    total = torch.cuda.get_device_properties(dev).total_memory
    line["production_cells"] = []
    dryrun.start_fake_world(256)
    try:
        mesh = make_production_mesh(device_type="cpu")
        for arch, shape in DRYRUN_CELLS:
            rec = dryrun.run_cell(get_config(arch), cells[shape], mesh)
            if rec["status"] != "ok":
                fail(f"dryrun: {arch} {shape} on the (16, 16) mesh: "
                     f"{rec.get('error')}")
            if not rec["peak_bytes"] < total:
                fail(f"dryrun: {arch} {shape} peaks at {rec['peak_bytes']} "
                     f"B a device, over the card's {total}")
            ref = REF_LONG_FLOPS.get(arch) if shape == "long_500k" else None
            if ref and not rec["flops_per_device"] <= (DRYRUN_FLOPS_RATIO
                                                       * ref):
                fail(f"dryrun: {arch} {shape} does {rec['flops_per_device']}"
                     f" FLOPs a device, over {DRYRUN_FLOPS_RATIO} x the "
                     f"reference's {ref}")
            if (arch, shape) == ("mamba2-780m", "decode_32k") and (
                    rec["bottleneck"] == "collective"):
                fail(f"dryrun: {arch} {shape} is collective-bound: "
                     f"{rec['collective_bytes_per_device']} B a device")
            line["production_cells"].append({k: rec[k] for k in (
                "arch", "shape", "world", "flops_per_device",
                "bytes_per_device", "collective_bytes_per_device",
                "argument_bytes", "peak_bytes", "bottleneck", "run_s")})
            if ref:
                line["production_cells"][-1]["flops_vs_reference"] = (
                    rec["flops_per_device"] / ref)
    finally:
        dist.destroy_process_group()
    line["production"] = line["production_cells"][0]  # the first cell
    line["card_total_memory"] = total
    line["phase_s"] = time.perf_counter() - t_phase
    print("dryrun " + json.dumps(line))


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's path needs a card")

    # 1. the card
    card = card_line()

    # 2. build
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.conv2d.kernel import (
        CONV2D, conv_plan, conv_ranges)
    from repro_torch.kernels.conv2d.ops import conv2d_relu
    from repro_torch.kernels.conv2d.ref import (
        conv2d_relu_ref, conv2d_split_ref, maxpool2)
    from repro_torch.kernels.streamed_matmul.kernel import (
        MATMUL, blocks_plan, matmul_blocks, matmul_unique, sm_count,
        split_k_ranges, TILES, unique_fits, unique_one_block, unique_plan)
    from repro_torch.kernels.streamed_matmul.ops import (
        block_dims_for, streamed_matmul)
    from repro_torch.kernels.streamed_matmul.ref import (
        matmul_blocks_split_ref, matmul_ref, matmul_unique_order_ref)

    from repro_torch.kernels.flash_attention.kernel import FLASH, SYMBOL
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.ssd_scan.kernel import SSD, ssd_slice
    from repro_torch.kernels.ssd_scan.ops import (
        ssd_intra_chunk, ssd_state_pass)

    from repro_torch.kernels.decode_attention.kernel import DECODE, MLA
    from repro_torch.kernels.kda.kernel import KDA

    libs = (CONV2D, MATMUL, FLASH, SSD, DECODE, MLA, KDA)
    t0 = time.perf_counter()
    build_all(list(libs))
    print(f"card: {card}")
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        for line in lib.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib.name}: {line.strip()}")

    # 3. TF32 off for every plain reference and library call below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    if sys.argv[1:] == ["kda"]:  # Kimi-Linear's kernels and witness alone
        kda_rows = kda_phase(np, torch, dev, libs)
        kimi_depth_phase(np, torch, dev)
        print(json.dumps({"kernels": kda_rows}))
        print(card)
        print(json.dumps({"ok": True}))
        return

    from repro_torch.accel.nullhop import NullHopExecutor
    from repro_torch.accel.roshambo import RoShamBoCNN
    from repro_torch.core.transfer import (
        Buffering, Management, Partitioning, TransferPolicy)

    cnn = RoShamBoCNN()
    layer_shapes = []  # (H, W, Cin, Cout) of each RoShamBo conv
    layer_pools = []  # whether the layer pools (conv1-4)
    hw = cnn.cfg.input_hw
    for spec in cnn.cfg.layers:
        layer_shapes.append((hw, hw, spec.c_in, spec.c_out))
        layer_pools.append(spec.pool)
        hw = hw // 2 if spec.pool else hw

    # 4. kernels against their plain versions
    # max |kernel - plain| per kernel and dtype
    errs = {(kern, dt): 0.0 for kern in ("conv2d", "conv2d_split_order",
                                         "conv2d_pooled_split_order",
                                         "matmul_blocks", "matmul_unique",
                                         "matmul_unique_order",
                                         "flash_attention")
            for dt in ("float32", "bfloat16")}
    sms = sm_count(0)
    split_bitwise = [0, 0]  # unpooled launches equal to split order; cases
    pooled_cases = []
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    count_again = torch.zeros_like(count)
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        tol = CONV_TOL[dt]
        for bsz in (1, 32):
            for (h, w, cin, cout), pool in zip(layer_shapes, layer_pools):
                x = torch.randn((bsz, h, w, cin), generator=gen).to(dev, dtype)
                wt = (torch.randn((3, 3, cin, cout), generator=gen)
                      * (2.0 / (9 * cin)) ** 0.5).to(dev, dtype)
                b = (torch.randn((cout,), generator=gen) * 0.1).to(dev, dtype)
                _, splits, per = conv_plan(bsz, h, w, cin, cout, 3, 3, sms)
                ranges = conv_ranges(3, 3, cin, splits, per)
                for relu in (True, False):
                    got = launched(torch, CONV2D, "conv2d_bias_act", 1,
                                   lambda: conv2d_relu(x, wt, b, relu=relu),
                                   f"conv2d {dt} B {bsz} {(h, w, cin, cout)}")
                    ref = conv2d_relu_ref(x, wt, b, relu=relu)
                    errs["conv2d", dt] = max(errs["conv2d", dt],
                                             max_err(torch, got, ref, tol))
                    # split K is summed in slice order: a second call is
                    # bitwise the first, and the split-order plain version
                    # agrees within the same limit
                    if not torch.equal(got, conv2d_relu(x, wt, b, relu=relu)):
                        fail(f"conv2d {dt} B {bsz} {(h, w, cin, cout)} "
                             f"relu {relu}: two calls differ")
                    split = conv2d_split_ref(x, wt, b, ranges, relu=relu)
                    errs["conv2d_split_order", dt] = max(
                        errs["conv2d_split_order", dt],
                        max_err(torch, got, split, tol))
                    split_bitwise[0] += int(torch.equal(got, split))
                    split_bitwise[1] += 1
                    # the launch the frame path runs: the pool (conv1-4)
                    # and the count in the epilogue, over the same plan
                    what = (f"conv2d pooled {dt} B {bsz} "
                            f"{(h, w, cin, cout)} pool {pool} relu {relu}")
                    count.zero_()
                    pooled = launched(
                        torch, CONV2D, "conv2d_bias_act", 1,
                        lambda: conv2d_relu(x, wt, b, relu=relu, pool=pool,
                                            counts=count), what)
                    want = maxpool2(got) if pool else got
                    if (pooled.shape != want.shape
                            or not torch.equal(pooled, want)):
                        fail(f"{what}: not bitwise maxpool2 of the unpooled "
                             f"launch")
                    errs["conv2d_pooled_split_order", dt] = max(
                        errs["conv2d_pooled_split_order", dt],
                        max_err(torch, pooled,
                                maxpool2(split) if pool else split, tol))
                    nz = int(torch.count_nonzero(pooled))
                    if int(count) != nz:
                        fail(f"{what}: counted {int(count)} nonzeros, "
                             f"count_nonzero {nz}")
                    count_again.zero_()
                    again = conv2d_relu(x, wt, b, relu=relu, pool=pool,
                                        counts=count_again)
                    if not (torch.equal(again, pooled)
                            and int(count_again) == nz):
                        fail(f"{what}: two calls differ")
                    pooled_cases.append(nz)
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        tol = MATMUL_TOL[dt]
        for m, k, n in ((128, 128, 128), (256, 384, 512), (100, 70, 33),
                        (1, 2048, 4)):
            x = torch.randn((m, k), generator=gen).to(dev, dtype)
            w = torch.randn((k, n), generator=gen).to(dev, dtype)
            ref = matmul_ref(x, w)
            for bm, bn, bk in TILES:
                got = matmul_blocks(x, w, block_m=bm, block_n=bn, block_k=bk)
                errs["matmul_blocks", dt] = max(errs["matmul_blocks", dt],
                                                max_err(torch, got, ref, tol))
                # split K: summed in slice order, so a second call is
                # bitwise the first, and the split-order plain version
                # agrees within the same limit
                again = matmul_blocks(x, w, block_m=bm, block_n=bn,
                                      block_k=bk)
                if not torch.equal(got, again):
                    fail(f"matmul_blocks {dt} {(m, k, n)} tile {(bm, bn, bk)}"
                         f": two calls differ")
                splits, per, _ = blocks_plan(m, n, k, (bm, bn, bk),
                                             sm_count(0))
                max_err(torch, got, matmul_blocks_split_ref(
                    x, w, split_k_ranges(k, bk, splits, per)), tol)
            if unique_fits(m, k, n, x.element_size()):
                got = matmul_unique(x, w)
                errs["matmul_unique", dt] = max(errs["matmul_unique", dt],
                                                max_err(torch, got, ref, tol))
                # a fixed reduction order: two calls bitwise equal
                if not torch.equal(got, matmul_unique(x, w)):
                    fail(f"matmul_unique {dt} {(m, k, n)}: two calls differ")
                if unique_one_block(m, k, n, x.element_size()):
                    order = matmul_unique_order_ref(
                        x, w, unique_plan(m, n, k)[1])
                    errs["matmul_unique_order", dt] = max(
                        errs["matmul_unique_order", dt],
                        max_err(torch, got, order, tol))
    flash_cases, flash_bad = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        for case in FLASH_CASES:
            b, sq, skv, h, hkv, d, causal, window = case
            q = torch.randn((b, sq, h, d), generator=gen).to(dev, dtype)
            k = torch.randn((b, skv, hkv, d), generator=gen).to(dev, dtype)
            v = torch.randn((b, skv, hkv, d), generator=gen).to(dev, dtype)
            got = launched(torch, FLASH, SYMBOL[dtype], 1,
                           lambda: flash_attention(q, k, v, causal=causal,
                                                   window=window),
                           f"flash {dt} {case}").float()
            ref = flash_attention_plain(q, k, v, causal=causal,
                                        window=window).float()
            if not bool(torch.isfinite(got).all()):
                fail(f"flash {dt} {case}: output is not finite")
            diff = (got - ref).abs()
            row_rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
            rtol, atol = FLASH_TOL[dt]
            if atol is None:
                atol = FLASH_BF16_ATOL_ROW_RMS * row_rms
            if bool((diff > atol + rtol * ref.abs()).any()):
                flash_bad.append((dt, case))
            err = float(diff.max())
            errs["flash_attention", dt] = max(errs["flash_attention", dt],
                                              err)
            flash_cases.append({
                "dtype": dt, "case": list(case), "max_abs_err": err,
                "max_err_over_row_rms": float((diff / row_rms).max()),
                "max_excess_over_row_rms": float(
                    ((diff - rtol * ref.abs()) / row_rms).max())})
    torch.cuda.synchronize()
    print("flash_cases " + json.dumps(flash_cases))
    if flash_bad:
        fail(f"flash kernel disagrees with its plain version in {flash_bad} "
             f"(tol {FLASH_TOL}, bf16 atol {FLASH_BF16_ATOL_ROW_RMS} x the "
             f"row's RMS)")
    print(f"conv2d_split_order_bitwise {split_bitwise[0]} of "
          f"{split_bitwise[1]} unpooled launches equal the split-order "
          f"plain version bit for bit")
    print(f"conv2d_pooled {len(pooled_cases)} launches (conv1-4 pooled, "
          f"conv5 counted only; B 1 and 32, f32 and bf16, relu on and off): "
          f"bitwise maxpool2 of the unpooled launch, counts equal "
          f"count_nonzero, max abs err against maxpool2 of the split order "
          f"{ {d: errs['conv2d_pooled_split_order', d] for d in ('float32', 'bfloat16')} }")
    print(f"kernels vs plain: max abs err "
          f"{ {f'{k}/{d}': e for (k, d), e in errs.items()} } "
          f"(conv tol {CONV_TOL}, matmul tol {MATMUL_TOL}, "
          f"flash tol {FLASH_TOL})")

    # 5. the NullHop path
    policies = [
        ("user-level polling", TransferPolicy.user_level_polling()),
        ("user-level drv scheduled", TransferPolicy.user_level_scheduled()),
        ("kernel-level drv", TransferPolicy.kernel_level()),
        ("kernel drv + double/blocks", TransferPolicy(
            Management.INTERRUPT, Buffering.DOUBLE, Partitioning.BLOCKS,
            block_bytes=1 << 16)),
        ("kernel drv ring (d4)", TransferPolicy.kernel_level_ring()),
    ]
    params = cnn.init(torch.Generator().manual_seed(1), device=dev)
    rng = np.random.default_rng(0)
    frames = [rng.standard_normal((1, 64, 64, 1)).astype(np.float32)
              for _ in range(FRAMES_PER_POLICY)]
    oracle = [cnn.apply(params, torch.from_numpy(f).to(dev)).cpu().numpy()
              for f in frames]
    # each frame's sparsity from the unpooled launches' fmaps pooled by
    # maxpool2: what the fused epilogue must count, float for float
    sparsity_want = []
    for f in frames:
        x = torch.from_numpy(f).to(dev)
        want = []
        for spec in cnn.cfg.layers:
            x = cnn.layer_apply(spec, params[spec.name], x, conv=conv2d_relu)
            want.append(1.0 - int(torch.count_nonzero(x)) / x.numel())
        sparsity_want.append(want)
    rows, logits_seen = [], []
    n_frames = 0
    warm = torch.zeros(1, device=dev)  # the profiler's warm-up kernels
    _zero(libs)
    for name, policy in policies:
        ex = NullHopExecutor(cnn, policy)
        if ex.engine.device.type != "cuda":
            fail(f"engine for {policy.tag} is on {ex.engine.device}")
        best = None

        def run_checked(i: int):
            nonlocal n_frames
            before = CONV2D.launches["conv2d_bias_act"]
            res = ex.run_frame(params, frames[i])
            n_frames += 1
            step = CONV2D.launches["conv2d_bias_act"] - before
            if step != 5:
                fail(f"{policy.tag}: conv kernel launched {step} times "
                     f"in one frame, expected 5")
            if not np.isfinite(res.logits).all() or res.logits.shape != (1, 4):
                fail(f"{policy.tag}: bad logits {res.logits}")
            np.testing.assert_allclose(res.logits, oracle[i],
                                       rtol=LOGIT_TOL[0], atol=LOGIT_TOL[1])
            if len(res.timing.layers) != 5:
                fail(f"{policy.tag}: {len(res.timing.layers)} layer timings")
            if res.sparsity != sparsity_want[i]:
                fail(f"{policy.tag}: sparsity {res.sparsity}, the unpooled "
                     f"launches' fmaps pooled give {sparsity_want[i]}")
            logits_seen.append((policy, frames[i], res.logits))
            return res

        try:
            for i in range(len(frames)):
                res = run_checked(i)
                if i and (best is None or res.timing.frame_s < best.timing.frame_s):
                    best = res
            # per-chunk copy times (the engine's own samples, _one only):
            # what the copy costs apart from queueing and completion
            samples = list(ex.engine.chunk_samples)
            # one more frame under the profiler, for the device time a frame
            # holds (kernels + copies); its wall time is not used. As in
            # device_ms_per_call, the traced frame is a schedule's second
            # step (the first a few small kernels), and a trace without the
            # frame's 5 conv kernels is taken again
            for _ in range(3):
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU,
                                    torch.profiler.ProfilerActivity.CUDA],
                        schedule=torch.profiler.schedule(
                            wait=0, warmup=1, active=1, repeat=1)) as prof:
                    for _ in range(8):
                        warm.add_(1.0)
                    torch.cuda.synchronize()
                    prof.step()
                    run_checked(1)
                    torch.cuda.synchronize()
                    prof.step()
                ev = device_events(torch, prof)
                if sum(c for k, _, c in ev if "conv2d_igemm" in k) == 5:
                    break
            else:
                fail(f"{policy.tag}: three traces of a frame lost conv "
                     f"kernels")
            device_ms = sum(t for _, t, _ in ev)
        finally:
            ex.close()
        chunk_us = {d: sorted(dt * 1e6 for dd, _m, _n, dt in samples
                              if dd == d) for d in ("tx", "rx")}
        t = best.timing
        rows.append({"mode": name, "policy": policy.tag,
                     "tx_us_per_B": t.tx_us_per_byte,
                     "rx_us_per_B": t.rx_us_per_byte,
                     "frame_ms": t.frame_s * 1e3,
                     "layers_ms": [[l.name, l.tx_s * 1e3, l.compute_s * 1e3,
                                    l.rx_s * 1e3] for l in t.layers],
                     "sparsity": best.sparsity,
                     "chunks_per_frame": {d: len(v) // len(frames)
                                          for d, v in chunk_us.items()},
                     "chunk_us_median": {d: v[len(v) // 2]
                                         for d, v in chunk_us.items()},
                     # device time of one (profiled) frame over the best
                     # frame's wall time; null when the trace held none
                     "device_ms": device_ms or None,
                     "device_busy_share": (device_ms / (t.frame_s * 1e3)
                                           if device_ms else None)})
    main_launches = dict(CONV2D.launches)
    if main_launches["conv2d_bias_act"] != 5 * n_frames:
        fail(f"conv launches {main_launches} over {n_frames} frames")
    print(f"main path: {n_frames} frames, launches {main_launches}")
    print(f"{'mode':28s} {'TX us/B':>10s} {'RX us/B':>10s} {'frame ms':>10s} "
          f"{'device ms':>10s}")
    for r in rows:
        print(f"{r['mode']:28s} {r['tx_us_per_B']:10.6f} "
              f"{r['rx_us_per_B']:10.6f} {r['frame_ms']:10.4f} "
              f"{r['device_ms'] or float('nan'):10.4f}")
    print("table_i " + json.dumps(rows))

    # 5b.-5e. the transfer stack: channels, weight streaming and frames over
    # channel groups, injected faults and their recovery
    model = channels_phase(np, torch, cnn)
    stream_launches = channels_stream_phase(np, torch, dev, libs, MATMUL,
                                            model)
    frame_launches = channels_frame_phase(np, torch, libs, CONV2D, cnn,
                                          params, frames, oracle)
    faults_phase(np)
    stress_phase(dev)

    # 6. the streamed-matmul path: the classifier head on the card
    feats = []
    for policy, f, _ in logits_seen:
        x = torch.from_numpy(f).to(dev)
        for spec in cnn.cfg.layers:
            x = cnn.layer_apply(spec, params[spec.name], x,
                                conv=conv2d_relu_ref)
        feats.append(x.reshape(1, -1).contiguous())
    _zero(libs)
    for (policy, _f, logits), feat in zip(logits_seen, feats):
        head = streamed_matmul(feat, params["fc"]["w"], policy) + params["fc"]["b"]
        np.testing.assert_allclose(head.cpu().numpy(), logits,
                                   rtol=LOGIT_TOL[0], atol=LOGIT_TOL[1])
    mm_launches = dict(MATMUL.launches)
    if min(mm_launches.values()) == 0:
        fail(f"streamed-matmul path skipped a kernel: {mm_launches}")
    print(f"streamed-matmul path: {len(feats)} heads, launches {mm_launches}")

    # 7. the LM scoring path, 8. the serving path
    lm_launches = lm_paths(np, torch, dev, libs, FLASH)

    # 9. the SSD kernel against its plain version; 10.-12. the SSM paths
    ssd_errs = ssd_cases(np, torch, dev, gen)
    ssm_launches, ssd_dev, ssm_channel_launches = ssm_paths(
        np, torch, dev, libs, SSD)

    # 12b.-12e. the moe, continuous-batching, encoder-decoder and vlm paths
    moe_launches = moe_paths(np, torch, dev, libs, FLASH)
    continuous_paths(np, torch, dev, libs)
    decode_row = decode_phase(np, torch, dev, libs)
    mla_row = mla_phase(np, torch, dev, libs)
    dkv_row = flash_dkv_phase(np, torch, dev, libs)
    kda_rows = kda_phase(np, torch, dev, libs)
    kimi_depth_phase(np, torch, dev)
    encdec_paths(np, torch, dev, libs)
    vlm_launches = vlm_paths(np, torch, dev, libs, FLASH)

    # 12f.-12h. training: qwen2.5-3b and mamba2-780m at full width (F8's
    # gate first), the example's lm-100m with a checkpoint and a restart
    train_cell(np, torch, dev, libs, "qwen2.5-3b", "train")
    train_ssm = train_cell(np, torch, dev, libs, "mamba2-780m", "train_ssm")
    train_lm_phase(np, torch, dev, libs)

    # 12i.-12j. the distributed layer on a world of one NCCL rank (the
    # streamed qwen2.5-3b forward), the elastic restart example
    dist_launches = dist_phase(np, torch, dev, libs, FLASH)
    elastic_phase()

    # 12k.-12l. the paper's experiment as the port's example; the dry run
    # tied to the card, and a production cell under the fake backend
    tm_launches = transfer_modes_phase(np, torch, dev, libs, CONV2D)
    dryrun_phase(np, torch, dev, libs)

    # 13. timing at the paths' shapes (B = 1 frame for conv and matmul)
    conv_in = []
    for h, w, cin, cout in layer_shapes:
        conv_in.append((
            torch.randn((1, h, w, cin), generator=gen).to(dev),
            (torch.randn((3, 3, cin, cout), generator=gen) * 0.1).to(dev),
            torch.zeros(cout).to(dev)))
    conv_plain_ms = conv_bound = conv_dev = conv_lib_dev = 0.0
    per_layer, conv_calls, lib_calls = [], [], []
    # the frame path's launch: conv1-4 pool in the epilogue, every layer
    # counts its zeros; the library pair pools where the layer does
    counts = torch.zeros(len(layer_shapes), dtype=torch.int32, device=dev)
    for i, ((x, w, b), (h, wd, cin, cout), pool) in enumerate(
            zip(conv_in, layer_shapes, layer_pools)):
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()

        def kern(x=x, w=w, b=b, pool=pool, cnt=counts[i]):
            return conv2d_relu(x, w, b, pool=pool, counts=cnt)

        def lib_conv(xn=xn, wn=wn, b=b, pool=pool):  # NCHW view of x
            y = F.conv2d(xn, wn, b, padding=1)
            return F.max_pool2d(y, 2) if pool else y

        k_ms = time_ms(torch, kern)
        p_ms = time_ms(torch, lambda: conv2d_relu_ref(x, w, b, pool=pool))
        l_ms = time_ms(torch, lib_conv)
        k_dev = device_ms_per_call(torch, kern)
        l_dev = device_ms_per_call(torch, lib_conv)
        out_px = (h // 2) * (wd // 2) if pool else h * wd
        nbytes = (x.numel() + w.numel() + b.numel() + out_px * cout) * 4
        b_ms, _ = bound_ms(nbytes, 2 * h * wd * cout * 9 * cin)
        tile, splits, per = conv_plan(1, h, wd, cin, cout, 3, 3, sms)
        per_layer.append([h, wd, cin, cout, pool, k_ms, p_ms, l_ms, k_dev,
                          l_dev, b_ms, list(tile), splits, per])
        conv_calls.append(kern)
        lib_calls.append(lib_conv)
        conv_plain_ms += p_ms
        conv_bound += b_ms
        conv_dev += k_dev
        conv_lib_dev += l_dev
    print("conv2d per layer [H, W, Cin, Cout, pool, kernel_ms, plain_ms, "
          "library_ms, kernel_device_ms, library_device_ms, bound_ms, "
          "tile, splits, chunks_per_split]: " + json.dumps(per_layer))

    def five(calls):
        def run():
            for c in calls:
                c()
        return run

    # The five layers at batch 1 are ~20 us calls bound by the host, whose
    # time moves by tens of percent from one timing to the next: so the
    # five-layer sum is timed in alternating rounds against F.conv2d (bias,
    # no ReLU; TF32 off; F.max_pool2d after it where the layer pools) and
    # compared by the median and the rounds won.
    conv_rounds = [(time_ms(torch, five(conv_calls)),
                    time_ms(torch, five(lib_calls))) for _ in range(ROUNDS)]
    conv_k_rounds, conv_l_rounds = (sorted(r) for r in zip(*conv_rounds))
    print(f"conv2d five layers, {ROUNDS} alternating rounds (kernel ms, "
          f"library ms): {json.dumps(conv_rounds)}")
    conv_bytes = sum((h * wd * cin + 9 * cin * cout + cout
                      + ((h // 2) * (wd // 2) if pool else h * wd) * cout) * 4
                     for (h, wd, cin, cout), pool in zip(layer_shapes,
                                                         layer_pools))
    conv_flops = sum(2 * h * wd * cout * 9 * cin
                     for h, wd, cin, cout in layer_shapes)
    conv_by = bound_ms(conv_bytes, conv_flops)[1]

    fx = feats[0]
    fw = params["fc"]["w"]
    m, k = fx.shape
    n = fw.shape[1]
    bm, bn, bk = block_dims_for(policies[3][1], m, k, n, 4)
    mm_splits, mm_per, mm_skinny = blocks_plan(m, n, k, (bm, bn, bk),
                                               sm_count(0))
    mm_bound, mm_by = bound_ms((m * k + k * n + m * n) * 4, 2 * m * k * n)

    def blocks():
        return matmul_blocks(fx, fw, block_m=bm, block_n=bn, block_k=bk)

    def lib():
        return torch.matmul(fx, fw)

    def unique():
        return matmul_unique(fx, fw)

    # At the head every call is bound by the host's time, which moves by
    # tens of percent from one timing to the next: so they are timed in
    # alternating rounds (BLOCKS, torch.matmul, UNIQUE) and each kernel is
    # compared with torch.matmul by the median and by the rounds won.
    rounds = [(time_ms(torch, blocks, iters=200),
               time_ms(torch, lib, iters=200),
               time_ms(torch, unique, iters=200)) for _ in range(ROUNDS)]
    mm_rounds = {"matmul_blocks": sorted(r[0] for r in rounds),
                 "matmul_unique": sorted(r[2] for r in rounds)}
    mm_won = {"matmul_blocks": sum(r[0] <= r[1] for r in rounds),
              "matmul_unique": sum(r[2] <= r[1] for r in rounds)}
    mm_lib_rounds = sorted(r[1] for r in rounds)
    mm = {sym: v[ROUNDS // 2] for sym, v in mm_rounds.items()}
    mm_lib = mm_lib_rounds[ROUNDS // 2]
    mm_plain = time_ms(torch, lambda: matmul_ref(fx, fw))
    # the same calls' device time alone (the host's launch cost left out)
    mm_dev = {"matmul_blocks": device_ms_per_call(torch, blocks),
              "matmul_unique": device_ms_per_call(torch, unique)}
    mm_lib_dev = device_ms_per_call(torch, lib)
    # BLOCKS's schedule before split-K, in this run: the same kernel as one
    # split through the general (not skinny) kernel, one block walking K
    y1 = torch.empty((m, n), device=dev)

    def one_split():
        MATMUL.launch("matmul_blocks", fx.data_ptr(), fw.data_ptr(),
                      y1.data_ptr(), None, None, m, n, k, bm, 1,
                      -(-k // bk), 0, 0, device=dev)
        return y1

    max_err(torch, one_split(), matmul_ref(fx, fw), MATMUL_TOL["float32"])
    mm_one_split = time_ms(torch, one_split, iters=200)
    mm_one_split_dev = device_ms_per_call(torch, one_split)

    kernels = [{
        "name": "conv2d", "route": "cuda",
        "source": "src/repro_torch/kernels/conv2d/csrc/conv2d.cu",
        "replaces": "src/repro/kernels/conv2d/kernel.py:63",
        "launches": main_launches["conv2d_bias_act"],
        "launches_channels_frame": frame_launches,
        "launches_transfer_modes": tm_launches["conv2d_bias_act"],
        "max_abs_err": errs["conv2d", "float32"],
        "max_abs_err_bf16": errs["conv2d", "bfloat16"],
        "max_abs_err_split_order": errs["conv2d_split_order", "float32"],
        "max_abs_err_pooled_split_order": errs["conv2d_pooled_split_order",
                                               "float32"],
        # the five RoShamBo layers at batch 1 as the frame path launches
        # them (pooled, counted): medians of the alternating rounds; device
        # ms summed over the layers
        "ms": conv_k_rounds[ROUNDS // 2], "plain_ms": conv_plain_ms,
        "bound_ms": conv_bound, "bound_by": conv_by,
        "library_ms": conv_l_rounds[ROUNDS // 2],
        "ms_rounds": conv_k_rounds, "library_ms_rounds": conv_l_rounds,
        "rounds_won": sum(a <= b for a, b in conv_rounds),
        "device_ms": conv_dev, "library_device_ms": conv_lib_dev,
        "plans": [[list(t), sp, pe] for *_, t, sp, pe in per_layer],
    }]
    for sym, line in (("matmul_blocks", 61), ("matmul_unique", 92)):
        kernels.append({
            "name": sym, "route": "cuda",
            "source": "src/repro_torch/kernels/streamed_matmul/csrc/matmul.cu",
            "replaces": f"src/repro/kernels/streamed_matmul/kernel.py:{line}",
            "launches": mm_launches[sym],
            "max_abs_err": errs[sym, "float32"],
            "max_abs_err_bf16": errs[sym, "bfloat16"],
            "ms": mm[sym], "plain_ms": mm_plain, "bound_ms": mm_bound,
            "bound_by": mm_by, "library_ms": mm_lib,
            "device_ms": mm_dev[sym], "library_device_ms": mm_lib_dev,
            "ms_rounds": mm_rounds[sym], "library_ms_rounds": mm_lib_rounds,
            "rounds_won": mm_won[sym],
        })
    kernels[-2].update({
        "launches_channels_stream": stream_launches,
        "tile": [bm, bn, bk], "splits": mm_splits, "steps_per_split": mm_per,
        "skinny": mm_skinny, "ms_one_split": mm_one_split,
        "device_ms_one_split": mm_one_split_dev})
    kernels[-1].update({"plan": list(unique_plan(m, n, k))})
    # flash at the LM path's shape: qwen2.5-3b heads, B 2, S 2048, causal,
    # bf16 on the tensor-core kernel (the f32 route's CUDA-core kernel at
    # the same shape beside it)
    b, s_, h, hkv, d = LM_BATCH, LM_SEQ, 16, 2, 128
    fq = torch.randn((b, s_, h, d), generator=gen).to(dev, torch.bfloat16)
    fk = torch.randn((b, s_, hkv, d), generator=gen).to(dev, torch.bfloat16)
    fv = torch.randn((b, s_, hkv, d), generator=gen).to(dev, torch.bfloat16)
    fl_ms = time_ms(torch, lambda: flash_attention(fq, fk, fv), iters=20)
    fl_plain = time_ms(torch, lambda: flash_attention_plain(fq, fk, fv),
                       iters=20)
    qt, kt, vt = (t.transpose(1, 2) for t in (fq, fk, fv))
    fl_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
    fq32, fk32, fv32 = fq.float(), fk.float(), fv.float()
    fl_ms32 = time_ms(torch, lambda: flash_attention(fq32, fk32, fv32),
                      iters=20)
    # causal: the (q, k) pairs this run visits, S (S + 1) / 2 per head, two
    # products of 2 D FLOPs each; q, k, v read and o written once
    fl_flops = 4 * b * h * d * s_ * (s_ + 1) // 2
    fl_bytes = (2 * b * s_ * h * d + 2 * b * s_ * hkv * d) * 2
    fl_bound, fl_by = bound_ms(fl_bytes, fl_flops, BF16_FLOPS)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:115",
        "launches": sum(sum(d.values()) for d in (
            lm_launches, moe_launches, vlm_launches, dist_launches)),
        "launches_by_symbol": {s: lm_launches[s] + moe_launches[s]
                               + vlm_launches[s] + dist_launches[s]
                               for s in lm_launches},
        "launches_by_path": {"lm_score": lm_launches, "moe": moe_launches,
                             "vlm": vlm_launches, "dist": dist_launches},
        "max_abs_err": errs["flash_attention", "float32"],
        "max_abs_err_bf16": errs["flash_attention", "bfloat16"],
        "ms": fl_ms, "ms_f32": fl_ms32, "plain_ms": fl_plain,
        "bound_ms": fl_bound, "bound_by": fl_by, "library_ms": fl_lib,
        "symbol": SYMBOL[torch.bfloat16], "symbol_f32": SYMBOL[torch.float32],
    })
    # the SSD kernel at the SSM scoring path's shape: mamba2-780m, B 2,
    # S 2048, bf16 x/B/C (f32 beside it). No single PyTorch call computes
    # this function, so there is no library time.
    b, s_, h, p, g, n, q = SSD_CASES[0]
    sargs = ssd_inputs(torch, dev, torch.bfloat16, b, s_, h, p, g, n, gen)
    sd_ms = time_ms(torch, lambda: ssd_intra_chunk(*sargs, chunk=q),
                    iters=20)
    sd_plain = time_ms(torch, lambda: ssd_intra_chunk(
        *sargs, chunk=q, use_kernel=False), iters=5)
    sargs32 = ssd_inputs(torch, dev, torch.float32, b, s_, h, p, g, n, gen)
    sd_ms32 = time_ms(torch, lambda: ssd_intra_chunk(*sargs32, chunk=q),
                      iters=20)
    # x, B, C (bf16), dt, a read once; y_diag, states, decay (f32) written
    # once. Operations the function needs: C.B over the visible (q, k)
    # pairs once per group (the heads of a group share it), the PV product
    # over them and the state product per head
    nc = s_ // q
    tri = q * (q + 1) // 2
    sd_bytes = (b * s_ * h * p * 2 + b * s_ * h * 4 + h * 4
                + 2 * b * s_ * g * n * 2 + b * s_ * h * p * 4
                + b * nc * h * p * n * 4 + b * nc * h * 4)
    sd_flops = (2 * b * nc * g * tri * n + 2 * b * nc * h * tri * p
                + 2 * b * nc * h * q * p * n)
    sd_bound, sd_by = bound_ms(sd_bytes, sd_flops, BF16_FLOPS)
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:92",
        "launches": ssm_launches["ssd_intra_chunk"],
        "launches_ssm_serve_channels": ssm_channel_launches["ssd_intra_chunk"],
        "launches_train_ssm": train_ssm["launches"]["ssd_scan"][
            "ssd_intra_chunk"],
        "max_abs_err": ssd_errs["float32"],
        "max_abs_err_bf16": ssd_errs["bfloat16"],
        "ms": sd_ms, "ms_f32": sd_ms32, "plain_ms": sd_plain,
        # the kernel's mean device time at this shape in mamba2's profiled
        # bf16 forward, times its one launch a call
        "device_ms": ssd_dev["ssd_chunk_tc_kernel"],
        "bound_ms": sd_bound, "bound_by": sd_by, "library_ms": None,
        "library_note": "no single PyTorch call computes the SSD "
                        "intra-chunk function",
        "heads_a_block": ssd_slice(b, s_ // q, h, g, q, sms),
    })
    # the state pass at the same shape, on the bf16 kernel's outputs,
    # against its plain version (the loop of nc chunks it replaced)
    _, sst, sdec = ssd_intra_chunk(*sargs, chunk=q)
    sp_ms = time_ms(torch, lambda: ssd_state_pass(sst, sdec), iters=50)
    sp_plain = time_ms(torch, lambda: ssd_state_pass(
        sst, sdec, use_kernel=False), iters=20)
    # states and decays read once, prev states and the final state written
    # once; a multiply and an add an element a chunk (f32, CUDA cores)
    sp_bytes = (2 * sst.numel() + sdec.numel() + sst.numel() // nc) * 4
    sp_bound, sp_by = bound_ms(sp_bytes, 2 * sst.numel())
    kernels.append({
        "name": "ssd_state_pass", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ops.py:43",
        "replaces_note": "the lax.scan of the reference's ssd_full (no "
                         "pallas_call): a loop of 3 launches a chunk",
        "launches": ssm_launches["ssd_state_pass"],
        "launches_ssm_serve_channels": ssm_channel_launches["ssd_state_pass"],
        "launches_train_ssm": train_ssm["launches"]["ssd_scan"][
            "ssd_state_pass"],
        "max_abs_err": ssd_errs["state_pass"],
        "ms": sp_ms, "plain_ms": sp_plain,
        "device_ms": ssd_dev["ssd_state_pass_kernel"],
        "bound_ms": sp_bound, "bound_by": sp_by, "library_ms": None,
        "library_note": "no single PyTorch call computes the recurrence",
    })
    kernels.append(decode_row)
    kernels.append(mla_row)
    kernels.append(dkv_row)
    kernels.extend(kda_rows)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
