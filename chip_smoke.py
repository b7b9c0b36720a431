#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
     sm_90a (at first use, into ``build/``);
  3. dndm_update kernel vs its plain version: tokens bitwise equal, at
     the K of the paths (28, 32000), GPT-2's odd 50257 (no row 16-byte
     aligned), K on both sides of the regime threshold (row_select.cuh's
     kBlockMinK) and the small shapes of tests/test_torch_kernels.py;
  4. flash_attention kernel vs its plain version: f32 within atol/rtol
     1e-4 (the sums run in another order, the products as 3xTF32 on the
     tensor cores), bf16 within 2e-2 (one bf16 rounding of the output, as
     tests/test_kernels.py allows); the ranked path's prefixed lengths
     (S = 179, 184) and the mixtral path's (4, 256, 32 heads, 8 kv heads,
     hd 128, window 4096) included;
  4b. flash_decode kernel (the decode form: one query row per head over
     a ring-buffer KV cache, the bias built in the kernel from (pos, L,
     window)) vs its plain version (ref.decode_attention), f32 within
     1e-4, bf16 within 2e-2 scaled by min(1, max |plain|) (a long
     ring's outputs are about 0.03), at hd 64, 80 and 128, rings of
     4096 slots and of 16 (wrapped: pos >= L, with and without a window), GQA, and
     the decode paths' shapes (zamba2's shared block, mixtral's);
  5. decode_scores kernel vs its plain version, K in {28, 32, 33, 100,
     257, 1000}, the shapes of the paths that decode through it (the
     ranked path's (8, 128, 28), continuous text8's (8, 256, 28), the
     continuous sweep's (4, 64, 28)) and the wide shapes of 3 ((4, 256,
     32000), (2, 16, 50257), the threshold - 1, at it, + 1), f32 and
     bf16, with and without Gumbel noise (at the continuous paths'
     shapes also a rolling batch's slab: every other row drawn from its
     own generator, the free rows zeros in), temperature 1 and 0.7, mask
     -1e9 at the last id: tokens bitwise equal, scores within atol/rtol
     1e-5 (the kernel's online logsumexp sums in another order);
  5b. ssd_scan kernel vs its plain version (ref.ssd_chunked): the four
     shapes of tests/test_kernels.py::test_ssd_scan_sweep (ragged S = 33
     included) in f32 and bf16 at that test's bars (3e-5 f32, 5e-2
     bf16), then the zamba2 path's shape (B, S, H, P, N, L) = (4, 256,
     80, 64, 64, 128) and a ragged S = 200 in f32, where y is also held
     against the exact recurrence ref.ssd_sequential (bar SSD_FULL_TOL);
  5c. by torch.profiler, the CUDA kernels of one ssd_scan call (its
     passes), of PyTorch's f32 scaled_dot_product_attention (the
     yardstick's backend) and of one Gumbel slab at the zamba2 path's
     (4, 256, 32000), with their device time;
  6. the main path: dndm-text8 at full width (12 layers, d_model 768,
     12 heads, d_ff 3072, vocab 28), random weights from seed 0,
     attn_impl="pallas", f32; a GenerationEngine (method "dndm",
     T = 1000 steps, absorbing noise, x0_mode "sample") behind a
     BatchScheduler (max_batch 8, bucket_len 256) drains 16 requests.
     Checks: 256 tokens per request, no [MASK] left, NFE per batch =
     unique tau values, dndm_update launches = total NFE and
     flash_attention launches = 12 x total NFE, where the total NFE
     counts every sampler run the engine executed, the untimed warm-up
     replay of the first batch (its engine key is cold) included; then
     the full-width denoiser's
     logits through the kernel vs through plain einsum attention;
  7. the ranked path: dndm-mt at full width (6 layers, d_model 512, 8
     heads, d_ff 2048, vocab 28), random weights from seed 0, f32,
     attn_impl="pallas", absorbing noise, x0_mode "sample", T = 1000; one
     BatchScheduler (max_batch 8, bucket_len 128) drains 8 requests of
     dndm_topk (Algorithm 4) and 8 of dndm_c_topk (Algorithm 2, top-k),
     each 128 target tokens after a source prefix of 48-64 tokens.
     Checks: 128 in-vocab tokens per request and no [MASK] left; the
     dndm_topk NFE = unique tau values, the dndm_c_topk NFE = 128;
     decode_scores launches = total NFE, flash_attention launches = 6 x
     total NFE, dndm_update launches = 0 (warm-up replays included);
     then the prefixed denoiser's logits through the kernel vs plain
     einsum attention;
  8. the registry sweep: every one of the 12 methods once through a
     GenerationEngine on the dndm-mt model, B = 4, N = 64, T = 50 (ddim
     with stride 2 and multinomial noise, the rest absorbing): each
     method's NFE follows its registry rule, decode_scores serves the 8
     methods that decode through decode_tokens, dndm_update the three
     DNDM methods, and d3pm launches neither;
  8b. the zamba2 path: zamba2-2.7b at full width (54 layers: 9 x (5
     bidirectional Mamba-2 blocks + the shared attention block), d_model
     2560, 32 heads of 80, d_ff 10240, vocab 32000, ssm_state 64, 80 SSM
     heads of 64, chunk 128), the weights phase 15's zamba2 leg trained
     from seed 0, f32, attn_impl="pallas"; a GenerationEngine (method
     "dndm", T = 50, absorbing noise, x0_mode "sample") behind a
     BatchScheduler (max_batch 4, bucket_len 256) drains 4 requests of
     256 tokens.
     Checks as in 6, with ssd_scan launches = 90 x total NFE,
     flash_attention = 9 x total NFE, dndm_update = total NFE and
     decode_scores = 0; then the full-width logits of one call through
     the kernels vs the plain route (ref.ssd_chunked and einsum
     attention); then one profiled sampler run;
  8c. the mixtral path (the zamba2 model freed first): mixtral-8x7b at
     every published width (d_model 4096, 32 heads with 8 kv heads of
     128, 8 experts of d_ff 14336, top-2, sliding window 4096, vocab
     32000) with 4 of its 32 layers (the f32 weights of 32 take 186.8 GB;
     4 take 24.4), random weights from seed 0, f32, attn_impl="pallas";
     a GenerationEngine (method "dndm", T = 50, absorbing noise,
     x0_mode "sample") behind a BatchScheduler (max_batch 4, bucket_len
     256) drains 4 requests of 256 tokens.  Checks as in 6, with
     flash_attention = 4 x total NFE, dndm_update = total NFE and
     decode_scores = ssd_scan = 0.  Then the denoiser block by block
     from the same input through the kernels and through einsum
     attention: per block the tokens whose top-2 experts differ (under
     1%; near-ties of the router flip on rounding), every token whose
     routing agrees within the logits bar, and the logits of the last
     block's two outputs; one MoE layer alone under torch.profiler must
     make no synchronising CUDA call; the MoE layer's time in router +
     dispatch, expert GEMMs and combine; one profiled sampler run (T =
     10); flash_attention at the path's shape beside
     scaled_dot_product_attention; peak memory under 80 GB;
  8d. the reduced zoo sweep: every registered config at
     .reduced(attn_impl="pallas") through one GenerationEngine dndm batch
     (B 2, N 64, T 20; musicgen and chameleon with the frontend stub's
     embeddings) on the card, each checked as in 6: in-vocabulary
     tokens, no [MASK], NFE = unique tau, each kernel's launches;
  8e. the xlstm path: xlstm-350m at every published width and depth (24
     layers = 4 x (5 mLSTM + 1 sLSTM), d_model 1024, 4 lstm heads,
     vocab 50304; 508,171,264 parameters, the JAX package's eval_shape
     count), random weights from seed 0, f32; a GenerationEngine (method
     "dndm", T = 50, absorbing noise, x0_mode "sample") behind a
     BatchScheduler (max_batch 4, bucket_len 256) drains 4 requests of
     256 tokens.  Checks as in 6, with dndm_update = total NFE at (4,
     256, 50304) and no other kernel; then the denoiser's logits with the
     mLSTM's parallel form against its chunked form (chunk 64) on the
     same weights (atol 3e-4, rtol 3e-3); one network call, one mLSTM
     block and one sLSTM block under torch.profiler: device ms, launches,
     GEMM ms, the busy share and the split into GEMMs, the mLSTM
     elementwise work and the sLSTM layers;
  8f. decode on the card (attn_impl "pallas": flash_decode), B = 2, 32
     positions one token at a time through Model.init_cache /
     decode_step, against forward(causal=True) on the same tokens (max
     |decode - forward| <= 1e-3 max |forward| + 2e-4) for xlstm-350m and
     zamba2-2.7b at full width (the shared block at hd 80; its causal
     forward runs ssd_scan), mixtral-8x7b with phase 8c's 4 layers (hd
     128, GQA 4:1; its forward at a capacity that drops nothing), and a
     ring-wrap case (dndm-text8 .reduced() with two "swa" blocks of
     window 16, 48 positions through rings of 16 slots); launches
     counted over the decoding alone: flash_decode once per attention
     block and position, nothing else; ms per decode step.  zamba2 and
     mixtral decode inside phases 8b and 8c, while their models are
     loaded.  Phase 8e, with the xlstm and ring decodes, runs right after
     phase 5c: a profiler that has traced the later paths drops kernel
     events, so 8e's profiles are also held to each other (the blocks'
     device time adds up to the call's within 15%) and retaken once;
  9. kernel times at the paths' shapes beside their bounds (bytes or f32
     flops on the CUDA cores; for flash_attention and ssd_scan also the
     tensor-core bound, their flops at a third of the TF32 rate), the
     plain versions and, for attention, scaled_dot_product_attention (a
     yardstick only; the port never calls it), flash_attention also at
     the ranked path's shape (8, 184, 8, 64), decode_scores also at
     (4, 256, 32000), dndm_update also at (4, 256, 32000) and (4, 256,
     50304), flash_decode at the mixtral decode shape (2, 32, 32, 8, 128)
     and over a ring of 4096 slots, beside scaled_dot_product_attention
     with a query of length 1 and the ring's bias as its mask.  Two
     readings: ``ms`` launch-paced, the host
     enqueueing while the device runs (what a path pays per call), and
     ``device_ms`` with each timed run queued behind a busy-wait kernel
     (the kernels' own time), with ``host_ms`` the host's time per call
     and, for the decode kernels at K = 28, ``launch_floor_host_ms``: a
     bare allocation and a direct ctypes call of the C entry point;
 10. one more sampler run of each path's batch shape (dndm on
     dndm-text8; dndm_topk and dndm_c_topk on dndm-mt with a 56-token
     prefix) under torch.profiler: device kernel time and kernel launches
     per network call, the top kernels, and the device busy share (kernel
     time over the path's timed ms per network call);
 11. continuous serving of the text8 path: the model of 6, T = 1000,
     independent tau sets (shared_tau=False), 16 dndm requests of 256
     tokens through a ContinuousScheduler (max_batch 8), then the same
     tape through a BatchScheduler.  Checks: each request's NFE = its
     plan's unique tau values (replayed from its seed), steps_skipped =
     1000 - NFE, decode_scores launches = the scheduler's total_calls,
     flash_attention = 12 x total_calls, dndm_update none; the drain's
     NFE per batch = the union of its rows' tau sets, its launches as in
     6.  Reports both modes' aggregate NFE, req/s and ms per network
     call; then serves the tape once more in each mode, seeded alike (so
     the same calls), under torch.profiler (CUDA activity): per call the
     device's kernel time and launches, the busy share (kernel time over
     the timed ms per call), and the host's own time (the wall outside
     CUDA API calls) beside its time inside them;
 12. continuous serving of the ranked path: the model of 7, 8 dndm_topk
     + 8 dndm_c_topk requests of 128 tokens with prefixes of 48 or 64
     tokens, so four (method, prefix length) groups of 4, max_batch 8,
     T = 1000, then the same tape drained; checks and readings as in 11,
     flash_attention = 6 x total_calls;
 13. the continuous registry sweep: all 12 methods through
     ContinuousScheduler (11 on absorbing noise, ddim on multinomial with
     stride 2), an integer-valued denoiser at dndm-mt's vocabulary on the
     card, max_batch 4, N 64, T 50, each method's second request admitted
     mid-flight; every request bitwise equal to its solo
     engine.generate(seed, 1, 64) (so decode_scores + a per-row where
     choose dndm_update's tokens), NFE and steps by the method's rule,
     decode_scores launched once per call of the 11 methods that decode
     through it;
 14. telemetry (``repro_torch.obs``) off and on, in one process, on the
     ranked tape of 12 drained and the text8 tape of 11 served
     continuously, seeded alike: fresh engines serve both with telemetry
     on into one trace file, which must pass the port's ``obs.schema``
     (lines and content), with every request's ``obs.timeline`` complete
     (one submit, admit and complete; one ``engine.stepwise`` span per
     call of a continuous request; one ``sampler.step`` per call of a
     drained host-sampler batch); then three same-process pairs per path
     alternate off and on (ms per network call); tokens and NFE of every
     serving bitwise equal; then one profiled serving per path off and
     one on: telemetry must add no synchronising CUDA runtime call (a
     copy to pageable host memory ends in one), and each gives its busy
     share;
 15. training: full-width dndm-text8 (114.5 M parameters) from seed 0,
     100 steps of the port's make_train_step (AdamW, warmup_cosine(3e-4,
     20, 100), linear schedule, T = 1000, absorbing noise, the RDM loss)
     on DataPipeline batches of 32 x 256 tokens, f32, einsum attention
     (the JAX package's training route), TF32 off.  Checks: the steps
     launch no kernel, every loss and parameter is finite, the mean loss
     of the last 5 steps is below that of the first 5.  Reports ms per
     step (median after TRAIN_WARMUP steps), tokens/s, model TFLOP/s (6 x
     parameters x tokens plus the attention products) and its share of
     the 67 TFLOP/s f32 peak, and max_memory_allocated, beside the card.
     The trained weights are saved by the port's checkpoint writer,
     loaded through the weight bridge into a fresh attn_impl="pallas"
     model (bitwise equal to the trained ones) and served as in 6 (16 x
     256 tokens, dndm, T = 1000) with 6's checks; the served text's mean
     log-likelihood under the training language is reported beside that
     of 6's untrained model.  Then MT_TRAIN_STEPS steps of full-width
     dndm-mt on translation pairs (source prefix and target of 128
     tokens each), the prefix branch of the train step, with the same
     readings and checks but the loss's fall.  Then the zamba2 leg:
     ZAMBA_TRAIN_STEPS steps (the last TRAIN_PROFILED profiled) of
     full-width zamba2-2.7b (all 54 layers) on the same recipe, its
     Mamba-2 blocks scanning through the plain chunked scan
     (ref.ssd_chunked, the reference's _ssd_scan_ref) as autograd
     records, at batch ZAMBA_TRAIN_BATCH x 256 (phase 15's batch of 32
     cut for memory; depth and width whole) on data of TRAIN_DATA_VOCAB
     token ids (the host's cost of the language), with the same readings
     and checks but the loss's fall, and the step's peak memory taken
     apart: parameters and moments, the tensors one forward saves for
     the backward by block kind (the first Mamba-2 block's by shape),
     and the rest; phase 8b serves its weights on the kernels;
 16. the multi-device code on the one card: a world-size-1 NCCL group
     (a file rendezvous under build/) and a (1, 1) ("data", "model")
     DeviceMesh.  Phase 8c's 4-layer mixtral forward with
     moe_dispatch="shard_map" under launch.mesh.use_mesh (m = 1: the
     expert-parallel branch, its all_to_all_single and all_gather
     counted on NCCL) bitwise equal to the global dispatch, logits and
     each MoE layer's output; then MESH_TRAIN_STEPS train steps of a
     reduced mixtral ("shard_map", capacity factor 16) with DTensor
     parameters (launch.sharding.shard_module) against the single-device
     step on the same draws at the f32 bar of tests/test_torch_training;
     the group is destroyed before the last line.

The last lines are JSON: the paths, the continuous phases, the kernels, and
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.

    python3 chip_smoke.py --measure-decode [--parent DIR]

measures the decode kernels only: the host time of each piece of a
wrapper call at K = 28, the device time of both regimes of both kernels
over K (the sweep that sets kBlockMinK), the block regime's aligned-noise
instantiation beside its shifted one on aligned noise and, with
``--parent DIR`` (an unpacked ``git archive`` of an earlier commit), that
commit's kernel wrappers, loaded into the same process, beside these in
alternating pairs.

    python3 chip_smoke.py --measure-telemetry

runs phase 14 alone on the full-width dndm-text8 and dndm-mt models with
TELEMETRY_MEASURE_PAIRS (10) off/on pairs per path.

    python3 chip_smoke.py --measure-xlstm [--parent DIR]

times xlstm-350m's network call at phase 8e's shape (seed 0 weights),
XLSTM_AB_CALLS calls after a warm one in a fresh process per tree: this
checkout's and, with ``--parent DIR``, that commit's, in the order parent,
change, change, parent.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.configs as configs_lib  # noqa: E402
from repro_torch.core import noise as noise_lib  # noqa: E402
from repro_torch.core import schedules as sched_lib  # noqa: E402
from repro_torch.core.decode import (gumbel_noise,  # noqa: E402
                                     row_gumbel_noise)
from repro_torch.core.samplers import loop, registry  # noqa: E402
from repro_torch.device import full, is_sharded  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_scores import ops as k3_ops  # noqa: E402
from repro_torch.kernels.decode_scores import ref as k3_ref  # noqa: E402
from repro_torch.kernels.dndm_update import ops as k1_ops  # noqa: E402
from repro_torch.kernels.dndm_update import ref as k1_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k2_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as k2_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as k4_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as k4_ref  # noqa: E402
from repro_torch.data import (DataConfig, DataPipeline,  # noqa: E402
                              MarkovLanguage)
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import frontend as frontend_lib  # noqa: E402
from repro_torch.models import mamba2 as mamba2_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.config import moe_pattern  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import schema as obs_schema  # noqa: E402
from repro_torch.serving import (BatchScheduler,  # noqa: E402
                                 ContinuousScheduler, EngineConfig,
                                 GenerationEngine)
from repro_torch.training import (AdamW, init_state,  # noqa: E402
                                  make_train_step, warmup_cosine)

# H100 SXM data sheet (dense): HBM rate, f32 rate outside the tensor
# cores and TF32 rate of the tensor cores, at the full 700 W power limit.
# The tensor-core kernels (flash_attention, ssd_scan) split each f32
# product in three TF32 products (3xTF32), so their f32-accurate rate is a
# third of the TF32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12

# K from which the decode kernels give a row a block (row_select.cuh)
ROW_SELECT = ROOT / "src" / "repro_torch" / "csrc" / "row_select.cuh"
BLOCK_MIN_K_RE = r"constexpr int kBlockMinK = (\d+);"
BLOCK_MIN_K = int(re.search(BLOCK_MIN_K_RE, ROW_SELECT.read_text()).group(1))
# the zamba2 path's vocabulary, GPT-2's odd one (no row 16-byte aligned)
# and K on both sides of the regime threshold
DECODE_WIDE = [(4, 256, 32000), (2, 16, 50257), (2, 64, BLOCK_MIN_K - 1),
               (2, 64, BLOCK_MIN_K), (2, 64, BLOCK_MIN_K + 1)]
K1_SHAPES = [(1, 16, 32), (3, 40, 100), (2, 64, 257), (1, 7, 1000),
             (8, 256, 28)] + DECODE_WIDE
# (B, S, H, KV, hd, causal, window)
K2_CASES = ([(B, S, H, H, hd, c, 0)
             for (B, S, H, hd) in [(1, 32, 2, 16), (2, 64, 4, 32),
                                   (1, 128, 2, 64), (2, 48, 3, 32),
                                   (8, 256, 12, 64)]
             for c in (True, False)]
            + [(8, 256, 12, 4, 64, False, 0),     # GQA
               (2, 100, 4, 2, 64, True, 16),      # causal window
               (2, 100, 4, 2, 128, False, 16),    # bidirectional window
               (2, 37, 2, 2, 16, False, 0),       # ragged S
               (4, 256, 32, 32, 80, False, 0),    # zamba2's shared block
               (2, 77, 4, 4, 80, False, 0),       # hd 80, ragged S
               (8, 184, 8, 8, 64, False, 0),      # the ranked path's
               (8, 179, 8, 8, 64, False, 0),      # prefixed lengths
               (4, 256, 32, 8, 128, False, 4096)])  # the mixtral path's
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

MAIN_REQUESTS, MAIN_LEN, MAIN_BATCH, MAIN_T = 16, 256, 8, 1000

# the shapes that the serving paths give decode_scores: the ranked path's,
# continuous text8's and the continuous sweep's; there a rolling batch's
# per-row slab is also held against the plain version
K3_PATH_SHAPES = [(8, 128, 28), (8, 256, 28), (4, 64, 28)]
K3_SHAPES = ([(3, 40, K) for K in (28, 32, 33, 100, 257, 1000)]
             + K3_PATH_SHAPES + DECODE_WIDE)
K3_TOL = 1e-5

# the ranked path: (method, requests) in submission order
MT_METHODS = (("dndm_topk", 8), ("dndm_c_topk", 8))
MT_LEN, MT_BATCH, MT_T, MT_PREFIX = 128, 8, 1000, (48, 64)

# ssd_scan: (B, S, H, P, N, chunk); the sweep of tests/test_kernels.py
K4_SWEEP = [(1, 16, 1, 4, 8, 4), (2, 48, 3, 8, 16, 16), (1, 64, 2, 16, 8, 32),
            (2, 33, 2, 8, 8, 16)]
K4_TOL = {torch.float32: 3e-5, torch.bfloat16: 5e-2}
# the zamba2 path's shape and a ragged one, f32; the bar for kernel vs
# ssd_chunked and vs the exact recurrence ssd_sequential
K4_FULL = [(4, 256, 80, 64, 64, 128), (4, 200, 80, 64, 64, 128)]
SSD_FULL_TOL = 1e-4

ZAMBA_REQUESTS, ZAMBA_LEN, ZAMBA_BATCH, ZAMBA_T = 4, 256, 4, 50
# the profiled zamba2 run uses T = 10 (about 10 network calls of the same
# shape): the profiler's bookkeeping of ~3,800 launches per call is slow
ZAMBA_PROFILE_T = 10

# the mixtral path (phase 8c): mixtral-8x7b at every published width, its
# 32 layers cut to MIXTRAL_LAYERS (the f32 weights of all 32 take more
# than twice the card's memory); one profiled sampler run at T = 10
MIXTRAL_LAYERS = 4
MIXTRAL_REQUESTS, MIXTRAL_LEN, MIXTRAL_BATCH, MIXTRAL_T = 4, 256, 4, 50
MIXTRAL_PROFILE_T = 10
# the share of a block's tokens whose top-k experts may differ between the
# kernel route and the plain one (attention outputs differ by about 1e-5,
# which flips near-ties among the router's probabilities)
ROUTE_FLIP_SHARE = 0.01
CARD_MEMORY_BYTES = 80e9

# the reduced zoo sweep (phase 8d): one dndm batch per config
ZOO_B, ZOO_N, ZOO_T = 2, 64, 20

# the xlstm path (phase 8e): xlstm-350m at every published width and
# depth; its parameter count by the JAX package's eval_shape; the chunk
# of the chunked mLSTM form the parallel form is held against
XLSTM_PARAMS = 508_171_264
XLSTM_REQUESTS, XLSTM_LEN, XLSTM_BATCH, XLSTM_T = 4, 256, 4, 50
XLSTM_CHUNK = 64
# the profiled xlstm blocks' device time must match the profiled call's
# within this share
PROFILE_SUM_TOL = 0.15
# --measure-xlstm: timed network calls per process
XLSTM_AB_CALLS = 10

# decode on the card (phase 8f): DECODE_POS positions of DECODE_B rows
# through the caches, one token at a time, against forward(causal=True):
# max |decode - forward| <= DECODE_REL * max |forward| + DECODE_ABS.  The
# ring-wrap case: RING_POS positions through a ring of RING_WINDOW slots
DECODE_B, DECODE_POS = 2, 32
DECODE_REL, DECODE_ABS = 1e-3, 2e-4
RING_WINDOW, RING_POS = 16, 48
# flash_decode vs plain (phase 4b): (B, L, H, KV, hd, pos, window); rings
# of 4096 and of 16 slots (wrapped: pos >= L), and the decode paths'
# shapes (zamba2's shared block, mixtral's window)
K2D_CASES = [(2, 4096, 12, 12, 64, 4095, 0), (2, 4096, 32, 32, 80, 6000, 0),
             (2, 4096, 32, 8, 128, 4095, 4096), (2, 16, 12, 12, 64, 40, 0),
             (2, 16, 32, 32, 80, 47, 16), (2, 16, 32, 8, 128, 31, 16),
             (2, 32, 32, 32, 80, 31, 0), (2, 32, 32, 8, 128, 31, 4096),
             (2, 16, 4, 2, 64, 47, 16)]

SWEEP_B, SWEEP_N, SWEEP_T, SWEEP_STRIDE = 4, 64, 50, 2
DECODE_TOKENS_METHODS = frozenset({
    "dndm_topk", "dndm_topk_static", "dndm_c", "dndm_c_topk", "rdm",
    "rdm_k", "mask_predict", "ddim"})
FUSED_METHODS = frozenset({"dndm", "dndm2", "dndm_static"})

# the CUDA runtime (cuda*) and low-level (cu*) API calls that make the host
# wait for the card
SYNC_CALLS = frozenset({
    "cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cuCtxSynchronize", "cuStreamSynchronize",
    "cuEventSynchronize", "cuMemcpyDtoH_v2"})
# the telemetry phase: same-process pairs per path, disabled / enabled
TELEMETRY_PAIRS = 3
# ... and in --measure-telemetry, which runs that phase alone
TELEMETRY_MEASURE_PAIRS = 10
# profiled servings of a tape per reading: one more where the profiler
# dropped kernel events (``profile_serving``)
PROFILE_ATTEMPTS = 2
TRACE_DIR = ROOT / "build" / "telemetry"

# continuous serving: the registry sweep on an integer-valued denoiser
# (first wave, then a second that lands mid-flight)
CSWEEP_BATCH, CSWEEP_N, CSWEEP_T, CSWEEP_STRIDE = 4, 64, 50, 2

# training (phase 15): full-width dndm-text8 on the launcher's recipe
# (AdamW, warmup_cosine(3e-4, 20, steps), linear schedule, absorbing
# noise) at batch 32, 256 tokens and T = 1000; the first TRAIN_WARMUP
# steps are left out of the median.  Then a few steps of full-width
# dndm-mt on translation pairs (source prefix and target of MT_TRAIN_SEQ)
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_BATCH, TRAIN_SEQ = 100, 3, 32, 256
TRAIN_T = 1000
TRAIN_LR, TRAIN_LR_WARMUP = 3e-4, 20
# the last steps of each run go under torch.profiler (kernel time by
# name), outside the median
TRAIN_PROFILED = 2
MT_TRAIN_STEPS, MT_TRAIN_SEQ = 8, 128
TRAIN_CKPT = ROOT / "build" / "train" / "dndm_text8"
# the zamba2 leg of phase 15: full-width zamba2-2.7b on the same recipe,
# through the plain chunked scan.  Phase 15's batch of 32 would need
# several times the card's memory (2.07 B f32 parameters, gradients and
# moments take 33 GB; each Mamba-2 block direction keeps about four
# (B, 2, 128, 128, 80) f32 tensors for the backward), so the batch is cut
# to 4; the sequence (256), depth and width stay whole
# (a median of 3 steps between the warm-up and the profiled ones)
ZAMBA_TRAIN_STEPS, ZAMBA_TRAIN_BATCH = 8, 4
# the training data's vocabulary is the model's but [MASK], at most this
# many ids: the synthetic language keeps a dense (V, V) table and its
# cumulative sum per batch, 8 GB and a minute of host time at zamba2's
# 32,000 ids, while a step's cost does not depend on which ids it sees
TRAIN_DATA_VOCAB = 4096

# the multi-device phase (16): a world-size-1 NCCL group met through a
# file, a (1, 1) mesh; train steps of a reduced mixtral (batch x tokens)
MESH_RENDEZVOUS = ROOT / "build" / "mesh" / "rendezvous"
MESH_TRAIN_STEPS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 4, 64
# the f32 bar of tests/test_torch_training.py (params: all but
# MESH_ILL_CONDITIONED of the elements, each within 2 x the sum of lr)
MESH_RTOL, MESH_ATOL, MESH_ILL_CONDITIONED = 1e-5, 1e-6, 1e-4


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel instance from nvcc's -Xptxas -v
    output: registers, shared memory and spills."""
    out, name, spill = [], "", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"(dndm_update_(?:warp|block)_kernel"
                             r"|decode_scores_(?:warp|block)_kernel"
                             r"|flash_attention_kernel|flash_decode_kernel"
                             r"|ssd_state_kernel"
                             r"|ssd_carry_kernel|ssd_output_kernel)",
                             mangled)
            dtype = ("bf16" if "bfloat16" in mangled else
                     "f32" if re.search(r"I(f|fL[ib]\d+E)E", mangled)
                     else "")
            # the block decode kernels' bool template argument (1: Gumbel
            # noise given), else flash's int one, the head dim
            arg = re.search(r"L[ib](\d+)EE", mangled)
            what = "noise" if base and "block" in base.group(1) else "hd"
            args = ", ".join(a for a in (dtype, f"{what}={arg.group(1)}"
                                         if arg else "") if a)
            name = (f"{base.group(1) if base else mangled}"
                    f"{f'<{args}>' if args else ''}")
        elif "spill stores" in line:
            spill = line.strip()
        elif "ptxas info    : Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = ""
    return out


def time_ms(fn, iters: int, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` launches,
    by CUDA events, after a warm-up.  The host enqueues while the device
    runs, so a call whose host work (a wrapper's checks and launch) takes
    longer than its kernels is paced by the host: this is the time a path
    pays per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def device_time_ms(fn, iters: int,
                   repeats: int = 5) -> tuple[float, float]:
    """As ``time_ms``, but each timed run is queued behind a busy-wait
    kernel that lasts longer than the host takes to enqueue the run, so
    the events time the device's work back to back: the kernels' own
    time, without the host's pace.  Returns (device ms, host ms) per
    call, the second the host's wall time to make one call (a wrapper's
    checks, allocation and launch) while the device is busy."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # cycles at up to 2 GHz for twice the enqueue time, and 1 ms at least
    wait_cycles = int(2e9 * max(2 * enqueue_s, 1e-3))
    samples, host = [], []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(wait_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / iters)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples), statistics.median(host)


def device_fields(*readings: tuple[float, float]) -> dict:
    """``device_ms`` and ``host_ms``, medians of ``device_time_ms``
    readings of one kernel."""
    return {"device_ms": statistics.median(r[0] for r in readings),
            "host_ms": statistics.median(r[1] for r in readings)}


def check_dndm_update(g) -> tuple[int, int]:
    """Kernel vs plain on the card, bitwise; returns (cases run, max
    |token difference|), the latter 0 when every case passed."""
    cases, max_err = 0, 0
    for B, N, K in K1_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            logits = torch.randn(B, N, K, generator=g, device="cuda").to(dt)
            x = torch.randint(0, K, (B, N), generator=g, device="cuda",
                              dtype=torch.int32)
            tau = torch.randint(1, 20, (B, N), generator=g, device="cuda",
                                dtype=torch.int32)
            mask = torch.zeros(K, device="cuda")
            mask[K - 1] = -1e9
            noise = gumbel_noise(g, (B, N, K), "cuda")
            for version in (1, 2):
                for gum in (None, noise):
                    for temp in (1.0, 0.7):
                        for t in (1, 5, 19):
                            kw = dict(mask=mask, gumbel=gum, version=version,
                                      temperature=temp)
                            a = k1_ops.dndm_update(logits, x, tau, t, **kw)
                            b = k1_ref.dndm_update(logits, x, tau, t, **kw)
                            max_err = max(max_err,
                                          int((a - b).abs().max()))
                            if not torch.equal(a, b):
                                raise AssertionError(
                                    f"dndm_update != plain at {(B, N, K)} "
                                    f"{dt} v{version} gumbel="
                                    f"{gum is not None} temp={temp} t={t}: "
                                    f"{int((a != b).sum())} tokens differ")
                            cases += 1
    return cases, max_err


def check_flash_attention(g) -> tuple[int, float]:
    """Kernel vs plain on the card; returns (cases, max f32 error at the
    main path's shape)."""
    main_err = 0.0
    for B, S, H, KV, hd, causal, window in K2_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt)
            k = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(dt)
            v = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(dt)
            a = k2_ops.flash_attention(q, k, v, causal=causal, window=window)
            b = k2_ref.attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = float((a.float() - b.float()).abs().max())
            tol = K2_TOL[dt]
            if not torch.allclose(a.float(), b.float(), atol=tol, rtol=tol):
                raise AssertionError(
                    f"flash_attention != plain at {(B, S, H, KV, hd)} {dt} "
                    f"causal={causal} window={window}: max err {err}")
            if ((B, S, H, KV, hd, causal, window) == (8, 256, 12, 12, 64,
                                                      False, 0)
                    and dt == torch.float32):
                main_err = err
    return 2 * len(K2_CASES), main_err


def check_flash_decode(g) -> tuple[int, float]:
    """Kernel vs plain (ref.decode_attention) on the card at flash's bars
    (f32 1e-4; bf16 rtol 2e-2 and atol 2e-2 * min(1, max |plain|), as a
    long ring's softmax spreads over ~1,500 keys and its outputs are about
    0.03); returns (cases, max f32 error)."""
    max_err = 0.0
    for B, L, H, KV, hd, pos, window in K2D_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, 1, H, hd, generator=g, device="cuda").to(dt)
            k = torch.randn(B, L, KV, hd, generator=g, device="cuda").to(dt)
            v = torch.randn(B, L, KV, hd, generator=g, device="cuda").to(dt)
            a = k2_ops.flash_decode(q, k, v, pos=pos, window=window)
            b = k2_ref.decode_attention(q, k, v, pos, window)
            torch.cuda.synchronize()
            err = float((a.float() - b.float()).abs().max())
            tol = K2_TOL[dt]
            atol = (tol if dt == torch.float32
                    else tol * min(1.0, float(b.float().abs().max())))
            if not torch.allclose(a.float(), b.float(), atol=atol, rtol=tol):
                raise AssertionError(
                    f"flash_decode != plain at {(B, L, H, KV, hd)} {dt} "
                    f"pos={pos} window={window}: max err {err}")
            if dt == torch.float32:
                max_err = max(max_err, err)
    return 2 * len(K2D_CASES), max_err


def check_decode_scores(g) -> tuple[int, float]:
    """Kernel vs plain on the card: tokens bitwise, scores within
    K3_TOL; returns (cases, max |score difference|)."""
    cases, max_err = 0, 0.0
    for B, N, K in K3_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            logits = torch.randn(B, N, K, generator=g, device="cuda").to(dt)
            mask = torch.zeros(K, device="cuda")
            mask[K - 1] = -1e9
            noises = {"none": None,
                      "slab": gumbel_noise(g, (B, N, K), "cuda")}
            if (B, N, K) in K3_PATH_SHAPES:
                noises["rows"] = row_gumbel_noise(
                    [torch.Generator(device="cuda").manual_seed(100 + i)
                     if i % 2 == 0 else None for i in range(B)],
                    (N, K), "cuda")
            for noise, gum in noises.items():
                for temp in (1.0, 0.7):
                    kw = dict(mask=mask, gumbel=gum, temperature=temp)
                    tok, score = k3_ops.decode_scores(logits, **kw)
                    ptok, pscore = k3_ref.decode_scores(logits, **kw)
                    torch.cuda.synchronize()
                    err = float((score - pscore).abs().max())
                    max_err = max(max_err, err)
                    where = f"at {(B, N, K)} {dt} noise={noise} temp={temp}"
                    if not torch.equal(tok, ptok):
                        raise AssertionError(
                            f"decode_scores tokens != plain {where}: "
                            f"{int((tok != ptok).sum())} differ")
                    if not torch.allclose(score, pscore, atol=K3_TOL,
                                          rtol=K3_TOL):
                        raise AssertionError(f"decode_scores scores != plain "
                                             f"{where}: max err {err}")
                    cases += 1
    return cases, max_err


def ssd_inputs(g, B, S, H, P, N, dtype):
    """(x, dtv, A, Bm, Cm) on the card in the laws of the JAX sweep."""
    x = (torch.randn(B, S, H, P, generator=g, device="cuda") * 0.5).to(dtype)
    dtv = F.softplus(torch.randn(B, S, H, generator=g, device="cuda")).to(
        dtype)
    A = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.3)
    Bm = (torch.randn(B, S, N, generator=g, device="cuda") * 0.3).to(dtype)
    Cm = (torch.randn(B, S, N, generator=g, device="cuda") * 0.3).to(dtype)
    return x, dtv, A, Bm, Cm


def check_ssd_scan(g) -> dict:
    """Kernel vs plain on the card: the sweep in f32 and bf16 at K4_TOL,
    the full-width shapes in f32 against ssd_chunked and ssd_sequential at
    SSD_FULL_TOL; returns the cases and the max errors."""
    sweep_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    full_err = {"vs_chunked": 0.0, "vs_sequential": 0.0,
                "chunked_vs_sequential": 0.0}
    cases = 0
    for B, S, H, P, N, chunk in K4_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            ins = ssd_inputs(g, B, S, H, P, N, dt)
            y, _ = k4_ops.ssd_scan(*ins, chunk=chunk)
            want, _ = k4_ref.ssd_chunked(*ins, chunk)
            torch.cuda.synchronize()
            err = float((y.float() - want.float()).abs().max())
            sweep_err[dt] = max(sweep_err[dt], err)
            if y.dtype != dt or not torch.allclose(
                    y.float(), want.float(), atol=K4_TOL[dt], rtol=K4_TOL[dt]):
                raise AssertionError(f"ssd_scan != plain at "
                                     f"{(B, S, H, P, N, chunk)} {dt}: max "
                                     f"err {err}")
            cases += 1
    for B, S, H, P, N, chunk in K4_FULL:
        ins = ssd_inputs(g, B, S, H, P, N, torch.float32)
        y, _ = k4_ops.ssd_scan(*ins, chunk=chunk)
        chunked, _ = k4_ref.ssd_chunked(*ins, chunk)
        seq, _ = k4_ref.ssd_sequential(*ins)
        torch.cuda.synchronize()
        for name, a, b in (("vs_chunked", y, chunked),
                           ("vs_sequential", y, seq),
                           ("chunked_vs_sequential", chunked, seq)):
            err = float((a - b).abs().max())
            full_err[name] = max(full_err[name], err)
            if not torch.isfinite(a).all() or not torch.allclose(
                    a, b, atol=SSD_FULL_TOL, rtol=SSD_FULL_TOL):
                raise AssertionError(f"ssd_scan {name} at "
                                     f"{(B, S, H, P, N, chunk)}: max err "
                                     f"{err}")
        cases += 1
    return {"cases": cases, "max_err_f32": sweep_err[torch.float32],
            "max_err_bf16": sweep_err[torch.bfloat16], "full": full_err}


KERNELS = {"dndm_update": k1_ops.dndm_update,
           "flash_attention": k2_ops.flash_attention,
           "flash_decode": k2_ops.flash_decode,
           "decode_scores": k3_ops.decode_scores,
           "ssd_scan": k4_ops.ssd_scan}


# a part of each kernel's CUDA name, by wrapper (one kernel per launch)
PROFILED_KERNELS = {"dndm_update": "dndm_update_",
                    "flash_attention": "flash_attention_kernel",
                    "decode_scores": "decode_scores_"}


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts(engine) -> dict:
    return {**{k: fn.launches for k, fn in KERNELS.items()},
            "network_calls": engine.network_calls}


def main_path(arch: str = "dndm-text8", n_req: int = MAIN_REQUESTS,
              n_len: int = MAIN_LEN, batch: int = MAIN_BATCH,
              steps: int = MAIN_T, model: Model | None = None):
    """Serve ``n_req`` requests of ``arch`` (or of ``model``) with dndm
    through the port's entry points; returns the model, the scheduler, the
    finished requests, the drain time and the launch counts."""
    if model is None:
        cfg = configs_lib.get(arch).replace(attn_impl="pallas")
        model = Model(cfg, device="cuda", seed=0)
    engine = GenerationEngine(model, EngineConfig(
        method="dndm", steps=steps, noise_kind="absorbing",
        x0_mode="sample"), device="cuda")
    sched = BatchScheduler(engine, max_batch=batch, bucket_len=n_len,
                           seed=0, device="cuda")
    for _ in range(n_req):
        sched.submit(n_len)

    reset_counts()
    engine.network_calls = 0
    t0 = time.perf_counter()
    done = sched.run()
    drain_s = time.perf_counter() - t0
    counts = read_counts(engine)
    return model, sched, done, drain_s, counts


def per_call_launches(cfg, decode: str) -> dict:
    """Each kernel's launches per network call of a model: one decode,
    one attention per attention-family block, two scans (forward and
    flipped) per bidirectional Mamba-2 block."""
    pattern = cfg.block_pattern
    want = {k: 0 for k in KERNELS}
    want[decode] = 1
    want["flash_attention"] = sum(k in ("attn", "swa", "shared_attn", "moe")
                                  for k in pattern)
    want["ssd_scan"] = 2 * pattern.count("mamba2")
    return want


def check_tokens(done, n_req: int, n_len: int, noise, vocab: int) -> None:
    """Every request done, with ``n_len`` in-vocabulary tokens and no
    [MASK] left."""
    if len(done) != n_req:
        raise AssertionError(f"{len(done)} of {n_req} requests done")
    for r in done.values():
        if r.result.shape != (n_len,):
            raise AssertionError(f"request {r.rid}: {r.result.shape} tokens")
        if (r.result == noise.mask_id).any():
            raise AssertionError(f"request {r.rid}: [MASK] left")
        if not ((r.result >= 0) & (r.result < vocab)).all():
            raise AssertionError(f"request {r.rid}: token out of vocab")


def check_main_path(model, sched, done, counts, n_req: int = MAIN_REQUESTS,
                    n_len: int = MAIN_LEN) -> dict:
    engine = sched.engine
    cfg = model.cfg
    check_tokens(done, n_req, n_len, engine.noise, cfg.vocab_size)
    batches: dict[int, list] = {}
    for r in done.values():
        batches.setdefault(r.seed, []).append(r)
    dist = engine.runtime().dist
    timed_nfe, warmup_nfe, timed_wall = 0, 0, 0.0
    cold: set[int] = set()
    for seed, reqs in batches.items():
        B = sched.batch_bucket(len(reqs))
        # replay the batch's tau draw: the first draw of its generator
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tau, *_ = loop.setup(gen, engine.noise, B, n_len, dist=dist,
                             shared=True, device=engine.device)
        n_unique = len(loop.unique_times(tau.cpu().numpy()))
        nfe = reqs[0].nfe
        if nfe != n_unique:
            raise AssertionError(f"batch {seed}: NFE {nfe} != {n_unique} "
                                 "unique tau values")
        timed_nfe += nfe
        timed_wall += reqs[0].batch_wall
        # the first batch of each bucket size meets a cold engine key: the
        # engine ran it once more, untimed, before the timed run
        if B not in cold:
            cold.add(B)
            warmup_nfe += nfe
    total_nfe = timed_nfe + warmup_nfe
    if counts["network_calls"] != total_nfe:
        raise AssertionError(f"engine made {counts['network_calls']} calls, "
                             f"expected {total_nfe}")
    for k, per in per_call_launches(cfg, "dndm_update").items():
        if counts[k] != per * total_nfe:
            raise AssertionError(f"{k} launched {counts[k]} times, expected "
                                 f"{per} x {total_nfe} network calls")
    return {"batches": len(batches), "timed_nfe": timed_nfe,
            "warmup_nfe": warmup_nfe, "total_nfe": total_nfe,
            "timed_wall_s": timed_wall}


def plain_ssd_scan(x, dtv, A, Bm, Cm, *, chunk: int = 128):
    """The Mamba-2 blocks' scan by the plain version, for the plain
    route of check_denoiser only (the port has no such route)."""
    return k4_ref.ssd_chunked(x, dtv, A, Bm, Cm, chunk)[0], None


def check_denoiser(model, n_tok: int, prefix_len: int = 0,
                   batch: int = 2) -> float:
    """Full-width logits (through the samplers' denoiser, with a source
    prefix if ``prefix_len``) through the kernels vs the plain route
    (einsum attention, and ref.ssd_chunked for Mamba-2 blocks), the same
    weights copied into a second model, at the repo's logits bar (atol
    3e-4, rtol 3e-3, tests/test_models.py)."""
    plain = Model(model.cfg.replace(attn_impl="einsum"), device="cuda",
                  seed=0)
    # the model's own weights (phase 8b's are trained, not seed 0's)
    plain.load_state_dict(model.state_dict())
    g = torch.Generator(device="cuda").manual_seed(1)
    tok = torch.randint(0, model.cfg.vocab_size, (batch, n_tok), generator=g,
                        device="cuda", dtype=torch.int32)
    t = torch.rand(batch, generator=g, device="cuda")
    cond = None
    if prefix_len:
        cond = {"prefix_tokens": torch.randint(
            0, model.cfg.vocab_size - 1, (batch, prefix_len), generator=g,
            device="cuda", dtype=torch.int32)}
    with torch.inference_mode():
        a = model.denoise_fn()(tok, t, cond)
        kernel_scan = mamba2_lib.ssd_ops.ssd_scan
        mamba2_lib.ssd_ops.ssd_scan = plain_ssd_scan
        try:
            b = plain.denoise_fn()(tok, t, cond)
        finally:
            mamba2_lib.ssd_ops.ssd_scan = kernel_scan
    torch.cuda.synchronize()
    del plain
    err = float((a - b).abs().max())
    if not torch.isfinite(a).all() or not torch.allclose(a, b, atol=3e-4,
                                                         rtol=3e-3):
        raise AssertionError(f"full-width logits: kernels vs plain max err "
                             f"{err}")
    return err


def mt_path():
    """The ranked path: 8 dndm_topk and 8 dndm_c_topk requests with
    source prefixes through one scheduler on full-width dndm-mt; returns
    the model, the scheduler, the finished requests, the drain time and
    the launch counts."""
    cfg = configs_lib.get("dndm-mt").replace(attn_impl="pallas")
    model = Model(cfg, device="cuda", seed=0)
    engine = GenerationEngine(model, EngineConfig(
        method="dndm_topk", steps=MT_T, noise_kind="absorbing",
        x0_mode="sample"), device="cuda")
    sched = BatchScheduler(engine, max_batch=MT_BATCH, bucket_len=MT_LEN,
                           seed=0, device="cuda")
    g = torch.Generator().manual_seed(0)
    lo, hi = MT_PREFIX
    for method, n in MT_METHODS:
        for _ in range(n):
            P = int(torch.randint(lo, hi + 1, (1,), generator=g))
            # source tokens: any id but [MASK]
            src = torch.randint(0, cfg.vocab_size - 1, (P,), generator=g,
                                dtype=torch.int32).numpy()
            sched.submit(MT_LEN, prefix=src, method=method)

    reset_counts()
    engine.network_calls = 0
    t0 = time.perf_counter()
    done = sched.run()
    drain_s = time.perf_counter() - t0
    counts = read_counts(engine)
    return model, sched, done, drain_s, counts


def ranked_tape() -> list:
    """The continuous ranked phase's requests: per method of MT_METHODS,
    source prefixes of 48 and 64 tokens in turn (any id but [MASK]), so
    that the scheduler forms four (method, prefix length) groups."""
    g = torch.Generator().manual_seed(0)
    vocab = configs_lib.get("dndm-mt").vocab_size
    return [(method, torch.randint(0, vocab - 1, (MT_PREFIX[i % 2],),
                                   generator=g, dtype=torch.int32).numpy())
            for method, n in MT_METHODS for i in range(n)]


def check_mt_path(model, sched, done, counts) -> dict:
    engine = sched.engine
    cfg = model.cfg
    check_tokens(done, sum(n for _, n in MT_METHODS), MT_LEN, engine.noise,
                 cfg.vocab_size)
    batches: dict[int, list] = {}
    for r in done.values():
        batches.setdefault(r.seed, []).append(r)
    dist = engine.runtime().dist
    nfe, timed_wall, total_nfe = {}, {}, 0
    for seed, reqs in batches.items():
        method = reqs[0].method
        B = sched.batch_bucket(len(reqs))
        if method == "dndm_topk":
            gen = torch.Generator(device="cuda").manual_seed(seed)
            tau, *_ = loop.setup(gen, engine.noise, B, MT_LEN, dist=dist,
                                 shared=True, device=engine.device)
            want = len(loop.unique_times(tau.cpu().numpy()))
        else:
            want = MT_LEN
        if reqs[0].nfe != want:
            raise AssertionError(f"{method} batch: NFE {reqs[0].nfe} != "
                                 f"{want}")
        nfe[method] = nfe.get(method, 0) + reqs[0].nfe
        timed_wall[method] = timed_wall.get(method, 0.0) + reqs[0].batch_wall
        # each method's one batch meets a cold engine key: an untimed
        # warm-up replay of the same NFE ran before it
        total_nfe += 2 * reqs[0].nfe
    if counts["network_calls"] != total_nfe:
        raise AssertionError(f"engine made {counts['network_calls']} calls, "
                             f"expected {total_nfe}")
    if counts["decode_scores"] != total_nfe:
        raise AssertionError(f"decode_scores launched "
                             f"{counts['decode_scores']} times for "
                             f"{total_nfe} network calls")
    if counts["flash_attention"] != cfg.n_layers * total_nfe:
        raise AssertionError(
            f"flash_attention launched {counts['flash_attention']} times, "
            f"expected {cfg.n_layers} x {total_nfe}")
    if counts["dndm_update"] != 0 or counts["ssd_scan"] != 0:
        raise AssertionError("the ranked path launched dndm_update or "
                             "ssd_scan")
    prefix_lens = sorted(len(r.prefix) for r in done.values())
    return {"nfe": nfe, "total_nfe": total_nfe, "timed_wall_s": timed_wall,
            "prefix_len_min": prefix_lens[0],
            "prefix_len_max": prefix_lens[-1]}


def registry_sweep(model) -> dict:
    """Every registered method once through a GenerationEngine; returns
    {method: {"nfe", "network_calls", and each kernel's launches}}."""
    out = {}
    engines = {kind: GenerationEngine(model, EngineConfig(
        steps=SWEEP_T, noise_kind=kind, ddim_stride=SWEEP_STRIDE,
        x0_mode="sample"), device="cuda")
        for kind in ("absorbing", "multinomial")}
    for i, name in enumerate(registry.names()):
        kind = "multinomial" if name == "ddim" else "absorbing"
        engine = engines[kind]
        spec = engine.check_method(name)
        reset_counts()
        engine.network_calls = 0
        res, _ = engine.generate(100 + i, SWEEP_B, SWEEP_N, method=name)
        counts = read_counts(engine)
        toks = res.tokens
        if toks.shape != (SWEEP_B, SWEEP_N) or toks.dtype != torch.int32:
            raise AssertionError(f"{name}: tokens {tuple(toks.shape)} "
                                 f"{toks.dtype}")
        if not ((toks >= 0) & (toks < model.cfg.vocab_size)).all():
            raise AssertionError(f"{name}: token out of vocab")
        if kind == "absorbing" and (toks == engine.noise.mask_id).any():
            raise AssertionError(f"{name}: [MASK] left")
        rt = engine.runtime()
        if spec.kind == "scan":
            want = spec.static_nfe(rt, SWEEP_N)
        else:
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            tau, *_ = loop.setup(gen, engine.noise, SWEEP_B, SWEEP_N,
                                 dist=rt.dist, shared=True,
                                 device=engine.device)
            want = len(loop.unique_times(tau.cpu().numpy()))
        if res.nfe != want:
            raise AssertionError(f"{name}: NFE {res.nfe}, its rule says "
                                 f"{want}")
        calls = counts["network_calls"]            # warm-up replay included
        if calls != 2 * res.nfe:
            raise AssertionError(f"{name}: {calls} network calls for NFE "
                                 f"{res.nfe} and its warm-up")
        want_k = {"decode_scores": calls if name in DECODE_TOKENS_METHODS
                  else 0,
                  "dndm_update": calls if name in FUSED_METHODS else 0,
                  "flash_attention": model.cfg.n_layers * calls,
                  "ssd_scan": 0}
        for k, v in want_k.items():
            if counts[k] != v:
                raise AssertionError(f"{name}: {k} launched {counts[k]} "
                                     f"times, expected {v}")
        out[name] = {"nfe": res.nfe, **counts}
    return out


class OracleModel:
    """An integer-valued denoiser of dndm-mt's vocabulary on the card:
    logits in [0, 15) from each row's own tokens, positions, step
    round(t T) and prefix.  Exact arithmetic, one row independent of the
    others, so a row served in a rolling batch must equal its solo run bit
    for bit."""

    def __init__(self, T: int):
        self.cfg = configs_lib.get("dndm-mt")
        self.device = torch.device("cuda", torch.cuda.current_device())
        self.T = T

    def denoise_fn(self):
        K, T, dev = self.cfg.vocab_size, self.T, self.device

        def fn(x_t, t, cond):
            k = torch.arange(K, dtype=torch.int32, device=dev)
            n = torch.arange(x_t.shape[1], dtype=torch.int32, device=dev)
            tt = torch.round(t * T).to(torch.int32)
            v = (x_t[..., None] * 3 + k * 7 + n[None, :, None] * 5
                 + tt[:, None, None]) % 11
            if cond is not None:
                v = v + (cond["prefix_tokens"].sum(-1) % 5)[:, None, None]
            return v.to(torch.float32)
        return fn


def check_steps(r, want_nfe: int, T: int, N: int) -> None:
    """A continuously served request's NFE and step accounting."""
    if r.nfe != want_nfe or r.nfe != len(r.plan.times):
        raise AssertionError(f"request {r.rid} ({r.method}): NFE {r.nfe}, "
                             f"plan {len(r.plan.times)}, want {want_nfe}")
    want = (N, 0) if r.plan.T == 0 else (r.nfe, T - r.nfe)
    if (r.steps_executed, r.steps_skipped) != want:
        raise AssertionError(f"request {r.rid} ({r.method}): executed / "
                             f"skipped {r.steps_executed} / "
                             f"{r.steps_skipped}, want {want}")


def continuous_sweep() -> dict:
    """All 12 methods through ContinuousScheduler on the card, on the
    integer-valued denoiser at dndm-mt's vocabulary: N 64, T 50, 4 rows;
    ddim on multinomial noise with stride 2 (its own scheduler), the rest
    absorbing.  Each method's first request is pumped alone, its second
    lands mid-flight.  Every request must equal its solo
    ``engine.generate(seed, 1, N)`` bit for bit: for the DNDM methods the
    solo path decodes through dndm_update and the rows through
    decode_scores and a per-row where."""
    model = OracleModel(CSWEEP_T)
    out = {"requests": 0, "total_calls": 0, "launches": {}, "nfe": {}}
    reset_counts()
    scheds = []
    for kind, methods in (("absorbing", registry.names("absorbing")),
                          ("multinomial", ("ddim",))):
        engine = GenerationEngine(model, EngineConfig(
            steps=CSWEEP_T, noise_kind=kind, ddim_stride=CSWEEP_STRIDE,
            x0_mode="sample", shared_tau=False), device="cuda")
        sched = ContinuousScheduler(engine, max_batch=CSWEEP_BATCH,
                                    bucket_len=CSWEEP_N, seed=5,
                                    device="cuda")
        rids = []
        for wave, n_tok in enumerate((CSWEEP_N, CSWEEP_N - 8)):
            for m in methods:
                rids.append(sched.submit(n_tok, method=m))
                sched.pump()
        sched.run()
        scheds.append((engine, sched, rids))
    counts = read_counts(scheds[0][0])
    total = sum(s.total_calls for _, s, _ in scheds)
    d3pm_calls = scheds[0][1]._runners[("d3pm", 0)].calls
    want = {"decode_scores": total - d3pm_calls, "dndm_update": 0,
            "flash_attention": 0, "ssd_scan": 0}
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"continuous sweep: {k} launched "
                                 f"{counts[k]} times, expected {v}")
    for engine, sched, rids in scheds:
        rt = engine.runtime()
        for rid in rids:
            r = sched.done[rid]
            spec = registry.get(r.method)
            if spec.kind == "scan":
                want_nfe = spec.static_nfe(rt, CSWEEP_N)
            else:
                gen = torch.Generator(device="cuda").manual_seed(r.seed)
                tau, *_ = loop.setup(gen, engine.noise, 1, CSWEEP_N,
                                     dist=rt.dist, device=engine.device)
                want_nfe = len(loop.unique_times(tau.cpu().numpy()))
            check_steps(r, want_nfe, CSWEEP_T, CSWEEP_N)
            solo, _ = engine.generate(r.seed, 1, CSWEEP_N, method=r.method)
            if not (solo.tokens[0, : r.length].cpu().numpy()
                    == r.result).all():
                raise AssertionError(f"continuous {r.method} request {rid} "
                                     "!= its solo run")
            out["nfe"].setdefault(r.method, []).append(r.nfe)
        out["requests"] += len(rids)
        out["total_calls"] += sched.total_calls
    out["launches"] = counts
    return out


def serve_tape(sched, tape, n_len: int):
    """Submit ``tape`` ((method, prefix) pairs) and run ``sched``; returns
    (finished requests, submit seconds, total seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for method, prefix in tape:
        sched.submit(n_len, prefix=prefix, method=method)
    submit_s = time.perf_counter() - t0
    done = sched.run()
    torch.cuda.synchronize()
    return done, submit_s, time.perf_counter() - t0


def tape_engine(model, tape, steps: int) -> GenerationEngine:
    """The engine the continuous phases serve a tape on: independent tau
    sets (``shared_tau=False``), absorbing noise, Gumbel decoding."""
    return GenerationEngine(model, EngineConfig(
        method=tape[0][0], steps=steps, noise_kind="absorbing",
        x0_mode="sample", shared_tau=False), device="cuda")


def continuous_vs_drain(model, tape, n_len: int, batch: int,
                        steps: int) -> dict:
    """One tape of requests ((method, prefix) pairs) served by
    ContinuousScheduler, then by BatchScheduler, on one engine with
    independent tau sets (``shared_tau=False``, the setting of the JAX
    package's continuous-vs-drain claim), absorbing noise, Gumbel
    decoding, T = ``steps``.  Checks each request's NFE and steps, and
    each kernel's launches against the network calls; returns both
    modes' aggregate NFE, req/s and ms per network call, and each mode's
    ``profile_serving`` of the same tape with its device busy share."""
    cfg = model.cfg
    engine = tape_engine(model, tape, steps)
    rt = engine.runtime()
    # the rows decode through decode_scores; a drain batch of the DNDM
    # methods through dndm_update
    per_call = per_call_launches(cfg, "decode_scores")
    fused, = {m in FUSED_METHODS for m, _ in tape}
    per_call_drain = per_call_launches(
        cfg, "dndm_update" if fused else "decode_scores")
    res = {}

    def continuous():
        return ContinuousScheduler(engine, max_batch=batch,
                                   bucket_len=n_len, seed=0, device="cuda")

    def drain_sched():
        return BatchScheduler(engine, max_batch=batch, bucket_len=n_len,
                              seed=0, device="cuda")

    sched = continuous()
    reset_counts()
    engine.network_calls = 0
    done, submit_s, wall = serve_tape(sched, tape, n_len)
    counts = read_counts(engine)
    check_tokens(done, len(tape), n_len, engine.noise, cfg.vocab_size)
    for r in done.values():
        if registry.get(r.method).continuous_time:
            want_nfe = n_len
        else:
            gen = torch.Generator(device="cuda").manual_seed(r.seed)
            tau, *_ = loop.setup(gen, engine.noise, 1, n_len, dist=rt.dist,
                                 device=engine.device)
            want_nfe = len(loop.unique_times(tau.cpu().numpy()))
        check_steps(r, want_nfe, steps, n_len)
    calls = sched.total_calls
    if counts["network_calls"] != calls:
        raise AssertionError(f"engine made {counts['network_calls']} calls, "
                             f"the scheduler {calls}")
    for k, per in per_call.items():
        if counts[k] != per * calls:
            raise AssertionError(f"continuous: {k} launched {counts[k]} "
                                 f"times, expected {per} x {calls} calls")
    res["continuous"] = {
        "total_calls": calls, "requests": len(done),
        "groups": len(sched._runners),
        "sum_request_nfe": sum(r.nfe for r in done.values()),
        "steps_skipped": sum(r.steps_skipped for r in done.values()),
        "submit_s": submit_s, "wall_s": wall,
        "req_per_s": len(done) / wall, "ms_per_network_call":
        1e3 * (wall - submit_s) / calls, "launches": counts}

    drain = drain_sched()
    reset_counts()
    engine.network_calls = 0
    ddone, _, dwall = serve_tape(drain, tape, n_len)
    dcounts = read_counts(engine)
    check_tokens(ddone, len(tape), n_len, engine.noise, cfg.vocab_size)
    batches: dict[int, list] = {}
    for r in ddone.values():
        batches.setdefault(r.seed, []).append(r)
    timed_nfe, timed_wall = 0, 0.0
    for seed, reqs in batches.items():
        B = drain.batch_bucket(len(reqs))
        if registry.get(reqs[0].method).continuous_time:
            want = n_len
        else:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            tau, *_ = loop.setup(gen, engine.noise, B, n_len, dist=rt.dist,
                                 device=engine.device)
            want = len(loop.unique_times(tau.cpu().numpy()))
        if reqs[0].nfe != want:
            raise AssertionError(f"drain batch {seed}: NFE {reqs[0].nfe}, "
                                 f"union of its tau sets {want}")
        timed_nfe += reqs[0].nfe
        timed_wall += reqs[0].batch_wall
    for k, per in per_call_drain.items():
        if dcounts[k] != per * dcounts["network_calls"]:
            raise AssertionError(f"drain: {k} launched {dcounts[k]} times, "
                                 f"expected {per} x "
                                 f"{dcounts['network_calls']} calls")
    res["drain"] = {
        "total_calls": timed_nfe, "batches": len(batches),
        "network_calls_with_warmup": dcounts["network_calls"],
        "wall_s": dwall, "timed_wall_s": timed_wall,
        "req_per_s": len(ddone) / dwall,
        "req_per_s_timed": len(ddone) / timed_wall,
        "ms_per_network_call": 1e3 * timed_wall / timed_nfe,
        "launches": dcounts}
    res["calls_drain_over_continuous"] = timed_nfe / calls
    for mode, make, want, ref in (
            ("continuous", continuous, calls, outputs(done)),
            ("drain", drain_sched, timed_nfe, outputs(ddone))):
        prof = profile_serving(make, tape, n_len, ref)
        if prof["calls"] != want:
            raise AssertionError(f"profiled {mode} serving made "
                                 f"{prof['calls']} calls, the timed {want}")
        prof["device_busy_share"] = (prof["device_ms"]
                                     / res[mode]["ms_per_network_call"])
        res[mode]["profile"] = prof
    return res


def profile_serving(make, tape, n_len: int, ref: list) -> dict:
    """Serve ``tape`` once more on ``make()``, a fresh scheduler seeded as
    the timed one (so it makes the same network calls), under
    torch.profiler with CUDA activity: the device's kernels, copies and
    fills, and the host's CUDA API calls (``cuda*``, ``cu*``).  Per network
    call: ``device_ms`` and ``launches`` (the device's events);
    ``host_ms``, the wall time outside CUDA API calls (the
    host's own work: Python, dispatch, the schedulers' and samplers' host
    arithmetic); ``runtime_ms``, the wall time inside them (launching
    and copying, and waiting for the card: synchronisations, copies to
    the host, launches into a full queue); ``ms``, the profiled wall,
    above the timed run's by the profiler's own cost; ``syncs``, the
    runtime calls that make the host wait for the card (stream, device
    and event synchronisations, blocking copies), and ``dtoh``, the
    device-to-host copies, per call, and their totals.  The served tokens
    and NFE must be bitwise ``ref`` (the timed serving's ``outputs``), and
    the profile must hold one kernel for each launch that the port's
    kernel wrappers counted.  The profiler now and then loses an event
    (on an H100, once one ``dndm_update`` of a text8 drain's 1,749, the
    tokens right), so a trace that lacks kernels is taken once more on a fresh
    scheduler, and a second such trace fails; ``dropped`` lists the
    kernels each incomplete trace lacked."""
    from torch.profiler import ProfilerActivity, profile
    dropped = []
    for _ in range(PROFILE_ATTEMPTS):
        sched = make()
        engine = sched.engine
        calls0 = engine.network_calls
        reset_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            done, _, wall = serve_tape(sched, tape, n_len)
        calls = engine.network_calls - calls0
        counted = read_counts(engine)
        if not same_outputs(outputs(done), ref):
            raise AssertionError("profiled serving: tokens or NFE differ "
                                 "from the timed serving's")
        device_ns, launches, spans, syncs, dtoh = 0, 0, [], 0, 0
        traced = dict.fromkeys(PROFILED_KERNELS, 0)
        for e in prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                device_ns += e.duration_ns()
                launches += 1
                dtoh += e.name().startswith("Memcpy DtoH")
                for k, stem in PROFILED_KERNELS.items():
                    traced[k] += stem in e.name()
            elif e.name().startswith("cu"):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
                syncs += e.name() in SYNC_CALLS
        lacks = {k: counted[k] - traced[k] for k in traced
                 if traced[k] != counted[k]}
        if spans and not lacks:
            break
        dropped.append(lacks)
    else:
        raise AssertionError(
            f"profile of {calls} calls: {len(spans)} runtime calls, "
            f"kernels {traced} against the launches counted "
            f"{ {k: counted[k] for k in traced} }; earlier traces lacked "
            f"{dropped[:-1]}")
    runtime_ns, reach = 0, 0          # the union of the (nested) calls
    for start, end in sorted(spans):
        runtime_ns += max(0, end - max(start, reach))
        reach = max(reach, end)
    return {"calls": calls, "ms": 1e3 * wall / calls,
            "device_ms": device_ns / 1e6 / calls,
            "launches": launches / calls,
            "host_ms": (1e3 * wall - runtime_ns / 1e6) / calls,
            "runtime_ms": runtime_ns / 1e6 / calls,
            "syncs": syncs / calls, "dtoh": dtoh / calls,
            "sync_calls": syncs, "dtoh_copies": dtoh, "dropped": dropped}


def outputs(done) -> list:
    """(NFE, tokens) of each finished request, in request order."""
    return [(done[rid].nfe, done[rid].result) for rid in sorted(done)]


def same_outputs(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        na == nb and (ta == tb).all() for (na, ta), (nb, tb) in zip(a, b))


@contextlib.contextmanager
def telemetry_on(path: Path):
    """Telemetry on and empty, every record sunk to ``path``, the final
    metrics record last; off again after."""
    obs.reset()
    obs.tracing.clear()
    obs.enable()
    obs.set_sink(str(path))
    try:
        yield
        obs.tracing.close_sink(final_metrics=True)
    finally:
        obs.tracing.close_sink()
        obs.disable()


def traced_serving(sched, tape, n_len: int, path: Path | None):
    """Serve ``tape`` on ``sched`` with telemetry off (``path`` None) or on,
    sunk to ``path``; returns (finished requests, ms per network call,
    calls)."""
    engine = sched.engine
    calls0 = engine.network_calls
    with (contextlib.nullcontext() if path is None else telemetry_on(path)):
        done, submit_s, wall = serve_tape(sched, tape, n_len)
    calls = engine.network_calls - calls0
    return done, 1e3 * (wall - submit_s) / calls, calls


def check_timelines(path: Path, done, mode: str) -> int:
    """Every request's timeline in the trace at ``path``: one submit, one
    admit and one complete of its own; continuous, one ``engine.stepwise``
    span per call of its own; drain, its batch's ``engine.generate`` span
    with one ``sampler.step`` per call for the host samplers.  Returns the
    records the timelines held."""
    n = 0
    for r in done.values():
        tl = obs.timeline(r.request_id, path=str(path))
        own = [x["name"] for x in tl
               if x["attrs"].get("request_id") == r.request_id]
        if own != ["scheduler.submit", "scheduler.admit",
                   "scheduler.complete"]:
            raise AssertionError(f"{mode} {r.request_id}: lifecycle {own}")
        names = [x["name"] for x in tl]
        if mode == "continuous":
            want = {"engine.stepwise": r.nfe}
        else:
            host = registry.get(r.method).kind == "host"
            want = {"engine.generate": 1,
                    "sampler.step": r.nfe if host else 0}
        for name, k in want.items():
            if names.count(name) != k:
                raise AssertionError(f"{mode} {r.request_id}: "
                                     f"{names.count(name)} {name}, want {k}")
        n += len(tl)
    return n


def telemetry_paths(text8_model, mt_model) -> dict:
    """The telemetry phase's paths: name -> (model, tape, n_len, batch,
    steps, mode): the ranked tape drained and the text8 tape served
    continuously, as phases 12 and 11 serve them."""
    return {"ranked_drain": (mt_model, ranked_tape(), MT_LEN, MT_BATCH, MT_T,
                             "drain"),
            "text8_continuous": (text8_model, [("dndm", None)] * MAIN_REQUESTS,
                                 MAIN_LEN, MAIN_BATCH, MAIN_T, "continuous")}


def telemetry_phase(paths: dict, pairs: int = TELEMETRY_PAIRS) -> dict:
    """Telemetry off and on, in one process, per path of ``paths``
    (``telemetry_paths``); every serving of a path is seeded alike, so it
    makes the same calls.

    1. Fresh engines serve every path once with telemetry on into one
       trace file (their cold keys in it): the file must pass the port's
       ``obs.schema`` (``validate_trace_lines``,
       ``validate_trace_content``) and every request's timeline must be
       complete.
    2. On those (now warm) engines, ``pairs`` same-process pairs per path
       alternate off and on (off-on, on-off, ...), every enabled serving
       writing a trace: ms per network call of each; tokens and NFE of
       every serving, off and on, bitwise those of 1.
    3. Two profiled servings per path, off then on (the on one with a
       sink): the on one's synchronising runtime calls must not outnumber
       the off one's (no new sync; device-to-host copies reported beside
       them); device time over the pairs' mean ms per call gives each busy
       share."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "serving.jsonl"
    path.unlink(missing_ok=True)
    engines, out, ref = {}, {}, {}

    def scheduler(name):
        model, tape, n_len, batch, steps, mode = paths[name]
        cls = ContinuousScheduler if mode == "continuous" else BatchScheduler
        return cls(engines[name], max_batch=batch, bucket_len=n_len,
                   seed=0, device="cuda")

    done = {}
    with telemetry_on(path):
        for name, (model, tape, n_len, batch, steps, mode) in paths.items():
            engines[name] = tape_engine(model, tape, steps)
            done[name], _, _ = serve_tape(scheduler(name), tape, n_len)
            ref[name] = outputs(done[name])
    with open(path) as f:
        records = obs_schema.validate_trace_lines(f)
    obs_schema.validate_trace_content(records)
    for name in paths:
        out[name] = {"requests": len(done[name]),
                     "timeline_records": check_timelines(
                         path, done[name], paths[name][5])}
    trace = {"records": len(records),
             "spans": sum(r["kind"] == "span" for r in records),
             "events": sum(r["kind"] == "event" for r in records),
             "bytes": path.stat().st_size}

    for name, (model, tape, n_len, batch, steps, mode) in paths.items():
        ms = {"off": [], "on": []}
        for pair in range(pairs):
            order = ("off", "on") if pair % 2 == 0 else ("on", "off")
            for state in order:
                p = TRACE_DIR / f"{name}-{pair}.jsonl" if state == "on" \
                    else None
                done, ms_call, calls = traced_serving(scheduler(name), tape,
                                                      n_len, p)
                if not same_outputs(outputs(done), ref[name]):
                    raise AssertionError(f"{name} pair {pair} ({state}): "
                                         "tokens or NFE changed")
                if p is not None:
                    with open(p) as f:
                        obs_schema.validate_trace_lines(f)
                    p.unlink()
                ms[state].append(ms_call)
        make = functools.partial(scheduler, name)
        prof = {"off": profile_serving(make, tape, n_len, ref[name])}
        p = TRACE_DIR / f"{name}-profile.jsonl"
        with telemetry_on(p):
            prof["on"] = profile_serving(make, tape, n_len, ref[name])
        p.unlink()
        if prof["on"]["calls"] != prof["off"]["calls"]:
            raise AssertionError(f"{name}: profiled {prof['on']['calls']} "
                                 f"calls on, {prof['off']['calls']} off")
        # a copy to pageable host memory ends in a stream sync, so the
        # runtime calls count it; the copies' device events are reported
        # only, as a profile can miss a few of them
        if prof["on"]["sync_calls"] > prof["off"]["sync_calls"]:
            raise AssertionError(f"{name}: telemetry adds synchronising "
                                 f"runtime calls: {prof['on']['sync_calls']} "
                                 f"against {prof['off']['sync_calls']}")
        mean = {k: statistics.fmean(v) for k, v in ms.items()}
        out[name].update({
            "calls": calls, "ms_per_network_call": ms, "mean_ms": mean,
            "on_over_off": mean["on"] / mean["off"],
            "on_faster_pairs": sum(a < b for a, b in zip(ms["on"],
                                                         ms["off"])),
            "device_busy_share": {k: prof[k]["device_ms"] / mean[k]
                                  for k in prof},
            **{f"{field}_per_call": {k: prof[k][field] for k in prof}
               for field in ("syncs", "dtoh", "host_ms", "runtime_ms",
                             "device_ms", "launches", "ms")},
            "sync_calls": {k: prof[k]["sync_calls"] for k in prof},
            "dtoh_copies": {k: prof[k]["dtoh_copies"] for k in prof},
            "dropped": {k: prof[k]["dropped"] for k in prof}})
    return {"pairs": pairs, "trace": trace, **out}


def train_flops(cfg, n_params: int, B: int, S: int) -> float:
    """Model FLOPs of one train step: 6 x parameters x tokens, plus the
    attention products of every attention block (q kᵀ and p v, 4 B H S²
    hd forward, three times that with the backward)."""
    n_attn = sum(k in ("attn", "swa", "shared_attn")
                 for k in cfg.block_pattern)
    return (6.0 * n_params * B * S
            + 12.0 * n_attn * B * cfg.n_heads * S * S * cfg.hd)


def train_run(arch: str, task: str, steps: int, seq: int,
              batch: int = TRAIN_BATCH, card: str = "") -> tuple:
    """Train full-width ``arch`` from seed 0 for ``steps`` steps of the
    port's ``make_train_step`` (f32, einsum attention, TF32 off) on
    ``task`` batches of the port's DataPipeline; each step timed to its
    loss on the host, the last TRAIN_PROFILED steps under torch.profiler
    recording the card's activity (device time, its GEMM part, launches
    and top kernels per step).  Checks: no kernel launched (the train
    step runs none, as in the JAX package), every loss and parameter
    finite.  Returns the model and the phase's record."""
    from torch.profiler import ProfilerActivity, profile
    t_run = time.perf_counter()
    cfg = configs_lib.get(arch)
    if cfg.attn_impl != "einsum":
        raise AssertionError(f"{arch} trains through attn_impl "
                             f"{cfg.attn_impl!r}, not einsum")
    model = Model(cfg, device="cuda", seed=0)
    opt = AdamW(warmup_cosine(TRAIN_LR, TRAIN_LR_WARMUP, steps))
    state = init_state(model, opt)
    step = make_train_step(model, sched_lib.linear(TRAIN_T),
                           noise_lib.absorbing(cfg.vocab_size), opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pipe = iter(DataPipeline(DataConfig(
        task=task, vocab=min(cfg.vocab_size - 1, TRAIN_DATA_VOCAB),
        seq_len=seq, batch=batch)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, ms = [], []
    prof = profile(activities=[ProfilerActivity.CUDA])
    for i in range(steps):
        if i == steps - TRAIN_PROFILED:
            prof.start()
        b = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(pipe).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b, gen)
        # the copy of the loss waits for the whole step, update included
        losses.append(float(metrics["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    prof.stop()
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    if any(launches.values()):
        raise AssertionError(f"{arch} train steps launched {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{arch}: a loss is not finite: {losses}")
    for name, p in model.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"{arch}: parameter {name} not finite")
    n_params = sum(p.numel() for p in model.parameters())
    S = 2 * seq if task == "translation" else seq   # [source | target]
    flops = train_flops(cfg, n_params, batch, S)
    med = statistics.median(ms[TRAIN_WARMUP:steps - TRAIN_PROFILED])
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if "gemm" in e.key.lower()) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    n5 = min(5, steps // 2)
    rec = {"arch": arch, "task": task, "steps": steps, "batch": batch,
           "tokens_per_row": S, "T": TRAIN_T, "params": n_params,
           "ms_per_step": med, "ms_per_step_all": ms,
           "tokens_per_s": batch * S / (med / 1e3),
           "model_tflop_per_step": flops / 1e12,
           "tflop_per_s": flops / (med / 1e3) / 1e12,
           "f32_peak_share": flops / (med / 1e3) / F32_FLOPS,
           "max_memory_allocated_gb":
           torch.cuda.max_memory_allocated() / 1e9,
           "loss_first5_mean": statistics.fmean(losses[:n5]),
           "loss_last5_mean": statistics.fmean(losses[-n5:]),
           "profile": {
               "steps": TRAIN_PROFILED,
               "device_ms_per_step": dev_ms / TRAIN_PROFILED,
               "gemm_ms_per_step": gemm_ms / TRAIN_PROFILED,
               "launches_per_step":
               sum(e.count for e in kernels) / TRAIN_PROFILED,
               "device_busy_share": dev_ms / TRAIN_PROFILED / med,
               "top_kernels": [{
                   "kernel": e.key[:72],
                   "ms_per_step": e.self_device_time_total / 1e3
                   / TRAIN_PROFILED,
                   "launches_per_step": e.count / TRAIN_PROFILED}
                   for e in top]},
           "launches": launches, "losses": losses, "card": card,
           "seconds": time.perf_counter() - t_run}
    return model, rec


def saved_for_backward(model, batch: int, seq: int) -> dict:
    """What one forward of ``model`` under autograd (its training route:
    einsum attention, the plain chunked scan) keeps for the backward at
    ``batch`` x ``seq`` random tokens: every storage that autograd saves,
    parameters left out, counted once, under the block that saved it
    first; GB by block kind, and the first Mamba-2 block's tensors
    (both directions) grouped by shape and dtype."""
    cfg = model.cfg
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    site = ["embed"]
    saved: dict[int, tuple] = {}          # storage -> (site, bytes, shape)

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in params and st.data_ptr() not in saved:
            saved[st.data_ptr()] = (site[0], st.nbytes(),
                                    (tuple(t.shape), str(t.dtype)))
        # a detached view of the same storage: an op's output kept as
        # itself would hold its own grad_fn, a cycle that outlives the
        # forward with every saved tensor in it
        return t.detach()

    calls = {"mamba2": 0, "shared_attn": 0}

    def enter(kind):
        def hook(module, args):
            site[0] = f"{kind} {calls[kind]}"
            calls[kind] += 1
        return hook

    mods = [(model.shared, "shared_attn")] + [
        (b, k) for k, b in zip(cfg.block_pattern, model.blocks)
        if k == "mamba2"]
    hooks = [m.register_forward_pre_hook(enter(k)) for m, k in mods]
    hooks.append(model.ln_f.register_forward_pre_hook(
        lambda module, args: site.__setitem__(0, "head")))
    g = torch.Generator(device=model.device).manual_seed(2)
    tok = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                        device=model.device)
    t = torch.rand(batch, generator=g, device=model.device)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            logits = model(tok, t, causal=False)   # as the train step
    finally:
        for h in hooks:
            h.remove()
    del logits
    by_kind: dict[str, float] = {}
    first: dict[tuple, list] = {}
    for where, nbytes, key in saved.values():
        kind = where.split()[0]
        by_kind[kind] = by_kind.get(kind, 0.0) + nbytes / 1e9
        if where == "mamba2 0":
            first.setdefault(key, []).append(nbytes)
    return {"tokens": [batch, seq], "gb_by_kind": by_kind,
            "blocks": calls, "gb": sum(by_kind.values()),
            "gb_per_mamba2_direction":
            by_kind.get("mamba2", 0.0) / max(1, 2 * calls["mamba2"]),
            "first_mamba2_block": sorted(
                ({"shape": list(shape), "dtype": dt, "count": len(b),
                  "mb": sum(b) / 1e6} for (shape, dt), b in first.items()),
                key=lambda r: -r["mb"])}


def mean_log_likelihood(done, vocab: int) -> float:
    """The mean per-token log-likelihood of served tokens under the
    language that ``train_run`` draws a model's data from (the JAX
    package's quality oracle); ``vocab`` is the model's without [MASK]."""
    toks = np.stack([done[r].result for r in sorted(done)])
    return MarkovLanguage(vocab, seed=DataConfig().seed).log_likelihood(toks)


def training_phase(untrained_ll: float, card: str) -> tuple[dict, Model]:
    """Phase 15: train full-width dndm-text8; the loss must fall.  Save
    it with the port's checkpoint writer, load it through the weight
    bridge into a fresh attn_impl="pallas" model (bitwise), serve 16 x
    256 tokens with dndm on the card's kernels with phase 6's checks;
    then a few steps of full-width dndm-mt with source prefixes; then
    the zamba2 leg.  Returns the records and the trained zamba2 model,
    which phase 8b serves."""
    model, text8 = train_run("dndm-text8", "unconditional", TRAIN_STEPS,
                             TRAIN_SEQ, card=card)
    if not text8["loss_last5_mean"] < text8["loss_first5_mean"]:
        raise AssertionError(f"text8 loss did not fall: first 5 "
                             f"{text8['loss_first5_mean']}, last 5 "
                             f"{text8['loss_last5_mean']}")
    convert.save_checkpoint(model, str(TRAIN_CKPT))
    served = Model(model.cfg.replace(attn_impl="pallas"), device="cuda",
                   seed=1)
    convert.load_checkpoint(served, str(TRAIN_CKPT))
    trained = dict(model.named_parameters())
    for name, p in served.named_parameters():
        if not torch.equal(p, trained[name].detach()):
            raise AssertionError(f"checkpoint: {name} not bitwise the "
                                 "trained parameter")
    del model, trained
    _, sched, done, drain_s, counts = main_path(model=served)
    stats = check_main_path(served, sched, done, counts)
    text8["served"] = {
        "requests": len(done), "tokens_per_request": MAIN_LEN,
        "method": "dndm", "T": MAIN_T, "launches": counts,
        "nfe_total": stats["total_nfe"], "drain_s": drain_s,
        "log_likelihood_trained": mean_log_likelihood(
            done, served.cfg.vocab_size - 1),
        "log_likelihood_untrained_seed0": untrained_ll}
    del served, sched
    torch.cuda.empty_cache()
    _, mt = train_run("dndm-mt", "translation", MT_TRAIN_STEPS,
                      MT_TRAIN_SEQ, card=card)
    torch.cuda.empty_cache()
    z_model, zamba = train_run("zamba2-2.7b", "unconditional",
                               ZAMBA_TRAIN_STEPS, TRAIN_SEQ,
                               batch=ZAMBA_TRAIN_BATCH, card=card)
    zamba["reduced"] = [f"batch {TRAIN_BATCH} -> {ZAMBA_TRAIN_BATCH} "
                        "(memory); sequence, depth and width whole",
                        f"data ids {z_model.cfg.vocab_size - 1} -> "
                        f"{TRAIN_DATA_VOCAB} (host time)"]
    # the step's peak: the parameters and AdamW's two moments (f32 each),
    # the forward's saved tensors, and what the loss and the backward
    # hold besides (the gradients come as the backward frees saved ones)
    saved = saved_for_backward(z_model, ZAMBA_TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.empty_cache()
    state_gb = 3 * 4 * zamba["params"] / 1e9
    zamba["memory_gb"] = {
        "peak": zamba["max_memory_allocated_gb"],
        "params_and_moments": state_gb, "saved_for_backward": saved,
        "rest": zamba["max_memory_allocated_gb"] - state_gb - saved["gb"],
        "card_margin": torch.cuda.get_device_properties(0).total_memory
        / 1e9 - zamba["max_memory_allocated_gb"]}
    torch.cuda.empty_cache()
    return {"text8": text8, "mt": mt, "zamba2": zamba}, z_model


def measure_telemetry() -> int:
    """--measure-telemetry: the telemetry phase alone on the full-width
    dndm-text8 and dndm-mt models, with TELEMETRY_MEASURE_PAIRS pairs per
    path."""
    models = [Model(configs_lib.get(a).replace(attn_impl="pallas"),
                    device="cuda", seed=0) for a in ("dndm-text8", "dndm-mt")]
    res = telemetry_phase(telemetry_paths(*models), TELEMETRY_MEASURE_PAIRS)
    print(json.dumps({"telemetry": {"card": gpu_name_and_power(), **res}}))
    return 0


def profile_run(engine, method: str, B: int, N: int, prefix_len: int = 0,
                top: int = 6) -> dict:
    """One sampler run under torch.profiler: device kernel time and
    kernel launches per network call, and the kernels that take most of
    it.  The profiler slows the host, so the path's own unprofiled
    timing gives the wall time per call."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda").manual_seed(3)
    cond = None
    if prefix_len:
        cond = {"prefix_tokens": torch.randint(
            0, engine.noise.vocab_size - 1, (B, prefix_len), generator=g,
            device="cuda", dtype=torch.int32)}
    rt = engine.runtime()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = registry.run(method, g, rt, B, N, cond)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_us = [e.self_device_time_total for e in kernels]
    order = sorted(range(len(kernels)), key=lambda i: -dev_us[i])[:top]
    return {"method": method, "nfe": out.nfe,
            "device_ms_per_call": sum(dev_us) / out.nfe / 1e3,
            "launches_per_call": sum(e.count for e in kernels) / out.nfe,
            "top_kernels": [{"kernel": kernels[i].key[:72],
                             "ms_per_call": dev_us[i] / out.nfe / 1e3,
                             "launches_per_call": kernels[i].count / out.nfe}
                            for i in order]}


def bound(n_bytes: float, n_flops: float,
          tensor_cores: bool = False) -> dict:
    """The least time for ``n_bytes`` moved and ``n_flops`` f32 operations
    at the card's peaks, and which of the two sets it: ``bound_ms`` and
    ``bound_by`` with f32 on the CUDA cores, and under ``bounds`` each
    computed bound by name; for a 3xTF32 kernel also the tensor-core
    bound, its operations at a third of the TF32 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S
    rates = {"f32_cuda_cores": F32_FLOPS}
    if tensor_cores:
        rates["tf32x3_tensor_cores"] = TF32_FLOPS / 3
    bounds = {name: {"ms": max(by_bytes, n_flops / rate) * 1e3,
                     "by": ("bytes" if by_bytes >= n_flops / rate
                            else "operations")}
              for name, rate in rates.items()}
    cores = bounds["f32_cuda_cores"]
    return {"bound_ms": cores["ms"], "bound_by": cores["by"],
            "bounds": bounds}


def device_kernels(fn, calls: int = 5) -> list[dict]:
    """The CUDA kernels that one call of ``fn`` launches, as the profiler
    sees them over ``calls`` calls: name, launches and device microseconds
    per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [{"kernel": e.key[:96], "launches": e.count / calls,
             "us": e.self_device_time_total / calls}
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]


def device_kernel_lists(g) -> dict:
    """The CUDA kernels of one ssd_scan call at the zamba2 shape (the
    wrapper launches the kernel's passes), of PyTorch's f32
    scaled_dot_product_attention at the text8 shape (the yardstick's
    backend) and of one Gumbel slab at the zamba2 path's (4, 256, 32000)
    (core/decode.py's gumbel_noise, drawn once per network call).  Run
    before the paths' profiled runs: after them this process's profiler
    reported no device events."""
    B, S, H, P, N, L = K4_FULL[0]
    ins = ssd_inputs(g, B, S, H, P, N, torch.float32)
    q, k, v = (torch.randn(MAIN_BATCH, 12, MAIN_LEN, 64, generator=g,
                           device="cuda") for _ in range(3))
    return {"ssd_scan": device_kernels(
                lambda: k4_ops.ssd_scan(*ins, chunk=L)),
            "scaled_dot_product_attention": device_kernels(
                lambda: F.scaled_dot_product_attention(q, k, v)),
            "gumbel_noise": device_kernels(
                lambda: gumbel_noise(g, (B, S, 32000), "cuda"))}


def ssd_flops(B, S, H, P, N, L) -> int:
    """The f32 operations the SSD scan needs on these shapes, at least:
    C Bᵀ once per (b, chunk), shared by the heads, and M x on the lower
    triangle only (L (L + 1) / 2 entries each); C S for every chunk but the
    first (its entering state is zero) and the state update for every
    chunk but the last (y does not read it), each 2 L N P per head."""
    nc = -(-S // L)
    return (B * nc * L * (L + 1) * N
            + B * H * (nc * L * (L + 1) * P + (nc - 1) * 4 * L * N * P))


def dndm_update_times(g, B: int, S: int, K: int, T: int):
    """dndm_update at (B, S, K) with Gumbel noise, f32, version 1, as a
    DNDM path of T steps gives it: ``ms`` and ``plain_ms`` launch-paced in
    the order plain, kernel, kernel, plain; ``device_ms`` by
    ``device_time_ms``; the bytes bound.  Returns the record and the
    (logits, mask, noise) it ran on."""
    logits = torch.randn(B, S, K, generator=g, device="cuda")
    x = torch.full((B, S), K - 1, dtype=torch.int32, device="cuda")
    tau = torch.randint(1, T + 1, (1, S), generator=g, device="cuda",
                        dtype=torch.int32).expand(B, S).contiguous()
    mask = torch.zeros(K, device="cuda")
    mask[K - 1] = -1e9
    noise = gumbel_noise(g, (B, S, K), "cuda")
    t = int(tau[0, 0])
    kw = dict(mask=mask, gumbel=noise, version=1, temperature=1.0)
    k1 = lambda: k1_ops.dndm_update(logits, x, tau, t, **kw)  # noqa: E731
    k1p = lambda: k1_ref.dndm_update(logits, x, tau, t, **kw)  # noqa: E731
    p1, m1, m2, p2 = (time_ms(f, 50) for f in (k1p, k1, k1, k1p))
    d1, d2 = (device_time_ms(k1, 50) for _ in range(2))
    return {"shape": [B, S, K], "ms": statistics.median([m1, m2]),
            **device_fields(d1, d2),
            "plain_ms": statistics.median([p1, p2]),
            # logits + gumbel read, mask read, x and tau read, tokens out;
            # per element + mask, + gumbel, compare
            **bound(B * S * K * 8 + K * 4 + B * S * 12, B * S * K * 3),
            "library_ms": None}, (logits, mask, noise)


def measure_flash_decode(g) -> dict:
    """flash_decode at the mixtral decode path's shape, (B, L, H, KV, hd) =
    (2, 32, 32, 8, 128) with window 4096, and over a full ring of 4096
    slots at that shape, f32, pos = L - 1 (every slot holds a key):
    kernel, plain and scaled_dot_product_attention (q of length 1, the
    ring bias as its float mask, enable_gqa) as ``measure_zamba`` takes
    them, and the bounds.  Bytes: q and the output at 32 heads, k and v
    at 8, each read once."""
    out = {}
    B, H, KV, hd, W = DECODE_B, 32, 8, 128, 4096
    for name, L in (("path", DECODE_POS), ("long_ring", 4096)):
        pos = L - 1
        q = torch.randn(B, 1, H, hd, generator=g, device="cuda")
        k, v = (torch.randn(B, L, KV, hd, generator=g, device="cuda")
                for _ in range(2))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        mask = k2_ref.ring_bias(pos, L, W, "cuda")
        kd = lambda: k2_ops.flash_decode(  # noqa: E731
            q, k, v, pos=pos, window=W)
        kp = lambda: k2_ref.decode_attention(q, k, v, pos, W)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        err = float((kd() - lib().transpose(1, 2)).abs().max())
        p1, m1, l1, m2, l2, p2 = (time_ms(f, 200)
                                  for f in (kp, kd, lib, kd, lib, kp))
        d1, dl1, d2, dl2 = (device_time_ms(f, 200)
                            for f in (kd, lib, kd, lib))
        n_bytes = 4 * (2 * B * H * hd + 2 * B * L * KV * hd)
        out[name] = {"shape": [B, L, H, KV, hd], "window": W, "pos": pos,
                     "ms": statistics.median([m1, m2]),
                     **device_fields(d1, d2),
                     "plain_ms": statistics.median([p1, p2]),
                     **bound(n_bytes, 4 * B * H * L * hd),
                     "library_ms": statistics.median([l1, l2]),
                     "library_device_ms": statistics.median([dl1[0],
                                                             dl2[0]]),
                     "max_abs_err_vs_library": err}
    return out


def measure_zamba(g) -> dict:
    """Kernel, plain and library times at the zamba2 path's shapes:
    ssd_scan at (4, 256, 80, 64, 64, 128), flash_attention at (4, 256, 32,
    80), dndm_update and decode_scores at (4, 256, 32000) with Gumbel
    noise, and the drawing of that noise; all f32.  ``ms``, ``plain_ms`` and
    ``library_ms`` launch-paced (``time_ms``) in the order plain, kernel
    (library), kernel (library), plain; ``device_ms`` and
    ``library_device_ms`` by ``device_time_ms``, kernel and library
    alternating."""
    B, S, H, P, N, L = K4_FULL[0]
    ins = ssd_inputs(g, B, S, H, P, N, torch.float32)
    k4 = lambda: k4_ops.ssd_scan(*ins, chunk=L)  # noqa: E731
    k4p = lambda: k4_ref.ssd_chunked(*ins, L)  # noqa: E731
    # bytes: x, dt, A, B, C read once, y written once
    k4_bytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N)
    p1, m1, m2, p2 = (time_ms(f, 20) for f in (k4p, k4, k4, k4p))
    d1, d2 = (device_time_ms(k4, 20) for _ in range(2))
    k4_flops = ssd_flops(B, S, H, P, N, L)
    out = {"ssd_scan": {
        "ms": statistics.median([m1, m2]),
        **device_fields(d1, d2),
        "plain_ms": statistics.median([p1, p2]),
        **bound(k4_bytes, k4_flops, tensor_cores=True),
        "library_ms": None}}

    Hq, hd = 32, 80
    q, k, v = (torch.randn(B, S, Hq, hd, generator=g, device="cuda")
               for _ in range(3))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    k2 = lambda: k2_ops.flash_attention(q, k, v)  # noqa: E731
    k2p = lambda: k2_ref.attention(q, k, v)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    p3, m3, l3, m4, l4, p4 = (time_ms(f, 50)
                              for f in (k2p, k2, lib, k2, lib, k2p))
    d3, dl3, d4, dl4 = (device_time_ms(f, 50) for f in (k2, lib, k2, lib))
    k2_bytes, k2_flops = 4 * B * S * Hq * hd * 4, 4 * B * Hq * S * S * hd
    out["flash_attention"] = {
        "shape": [B, S, Hq, hd], "ms": statistics.median([m3, m4]),
        **device_fields(d3, d4),
        "plain_ms": statistics.median([p3, p4]),
        **bound(k2_bytes, k2_flops, tensor_cores=True),
        "library_ms": statistics.median([l3, l4]),
        "library_device_ms": statistics.median([dl3[0], dl4[0]])}

    K = 32000
    out["dndm_update"], (logits, mask, noise) = dndm_update_times(
        g, B, S, K, ZAMBA_T)

    # decode_scores at the same shape and noise (no path runs it there
    # yet: the ranked samplers on a 32000-entry vocabulary would)
    kw3 = dict(mask=mask, gumbel=noise, temperature=1.0)
    k3 = lambda: k3_ops.decode_scores(logits, **kw3)  # noqa: E731
    k3p = lambda: k3_ref.decode_scores(logits, **kw3)  # noqa: E731
    p7, m7, m8, p8 = (time_ms(f, 50) for f in (k3p, k3, k3, k3p))
    d7, d8 = (device_time_ms(k3, 50) for _ in range(2))
    out["decode_scores"] = {
        "shape": [B, S, K], "ms": statistics.median([m7, m8]),
        **device_fields(d7, d8),
        "plain_ms": statistics.median([p7, p8]),
        # logits + gumbel + mask read, tokens and scores written; per
        # element + mask, + gumbel, compare, exp and the online sum
        **bound(B * S * K * 8 + K * 4 + B * S * 8, B * S * K * 6),
        "library_ms": None}

    # the Gumbel slab the zamba2 path draws per call: rand, clamp_, log,
    # neg, log, neg, each a PyTorch kernel over (B, S, K) f32 (written by
    # rand, read and written by the other five)
    gum = lambda: gumbel_noise(g, (B, S, K), "cuda")  # noqa: E731
    out["gumbel_noise"] = {
        "shape": [B, S, K], "ms": time_ms(gum, 20),
        **device_fields(*(device_time_ms(gum, 20) for _ in range(2))),
        **bound(B * S * K * 4 * 11, 0)}
    return out


# ---------------------------------------------------------------------
# The mixtral path (phase 8c) and the reduced zoo sweep (phase 8d).

def mixtral_model() -> tuple[Model, dict]:
    """mixtral-8x7b at every published width with MIXTRAL_LAYERS of its
    layers, attn_impl="pallas", f32, random weights from seed 0, and the
    record of the cut."""
    full = configs_lib.get("mixtral-8x7b")
    cfg = full.replace(n_layers=MIXTRAL_LAYERS,
                       block_pattern=moe_pattern(MIXTRAL_LAYERS),
                       attn_impl="pallas")
    model = Model(cfg, device="cuda", seed=0)
    size = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    per_layer = sum(p.numel() for p in model.blocks[0].parameters())
    full_params = (model.param_count()
                   + (full.n_layers - cfg.n_layers) * per_layer)
    return model, {
        "config": {k: v for k, v in dataclasses.asdict(cfg).items()
                   if k != "block_pattern"},
        "params": model.param_count(),
        "active_params": model.active_param_count(),
        "weights_gb": size * model.param_count() / 1e9,
        "reduced": [f"n_layers {full.n_layers} -> {cfg.n_layers} "
                    f"({cfg.dtype} weights of {full.n_layers} layers are "
                    f"{size * full_params / 1e9:.1f} GB)"]}


def route_sets(state: dict, T: int, E: int, C: int):
    """One group's routing as (T, E) masks: each token's top-k experts,
    and those of them that kept a capacity slot."""
    chosen = torch.zeros((T, E), dtype=torch.bool, device="cuda")
    chosen.scatter_(1, state["expert_idx"][0], True)
    st, slot, keep = state["st"][0], state["slot"][0], state["keep"][0]
    kept = torch.zeros(T * E + 1, dtype=torch.bool, device="cuda")
    kept[torch.where(keep, st * E + slot // C, T * E)] = True
    return chosen, kept[:T * E].view(T, E)


def moe_block(blk, h, C: int):
    """An "moe" block's forward, step by step: (output, routing state, aux
    losses, the MoE's input)."""
    x = h + blk.attn(blk.ln1(h), causal=False, window=blk.window)
    n = blk.ln2(x)
    buf, state, aux = blk.moe.route(n.reshape(1, -1, n.shape[-1]), C)
    y = x + blk.moe.combine(blk.moe.expert_ffn(buf), state).view_as(x)
    return y, state, aux, n


def check_mixtral_denoiser(model, batch: int, n_tok: int) -> dict:
    """The full-width denoiser block by block, the kernel route (flash
    attention) against the plain one (einsum attention), each block fed
    the same input, the kernel route's output of the block before.  Near
    ties among the router's probabilities may pick other experts where
    the attention outputs differ by rounding, so each block counts the
    tokens whose top-k experts differ (under ROUTE_FLIP_SHARE of them)
    and holds every token whose routing agrees (the same experts, the
    same ones kept) at the logits bar (atol 3e-4, rtol 3e-3); then the
    logits of the last block's two outputs, on its agreeing tokens."""
    cfg = model.cfg
    plain_cfg = cfg.replace(attn_impl="einsum")
    g = torch.Generator(device="cuda").manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (batch, n_tok), generator=g,
                        device="cuda", dtype=torch.int32)
    t = torch.rand(batch, generator=g, device="cuda")
    T, E = batch * n_tok, cfg.n_experts
    C = moe_lib.capacity(cfg, T)
    blocks, moe_in = [], None
    with torch.inference_mode():
        h = F.embedding(tok, model.embed) + model.time(t)[:, None]
        for i, blk in enumerate(model.blocks):
            y, state, aux, n = moe_block(blk, h, C)
            blk.attn.cfg = plain_cfg
            try:
                yp, state_p, _, _ = moe_block(blk, h, C)
            finally:
                blk.attn.cfg = cfg
            if moe_in is None:
                moe_in = n
            chosen, kept = route_sets(state, T, E, C)
            chosen_p, kept_p = route_sets(state_p, T, E, C)
            flipped = (chosen != chosen_p).any(-1)
            agree = ~flipped & ~(kept != kept_p).any(-1)
            a, b = y.reshape(T, -1)[agree], yp.reshape(T, -1)[agree]
            rec = {"block": i, "tokens": T,
                   "top_k_differs": int(flipped.sum()),
                   "routed_differently": int((~agree).sum()),
                   "max_err_agreeing": float((a - b).abs().max()),
                   "dropped_frac": float(aux["dropped_frac"]),
                   "load_balance": float(aux["load_balance"]),
                   "router_z": float(aux["router_z"])}
            blocks.append(rec)
            print(f"mixtral block {i}: {rec['top_k_differs']} of {T} tokens "
                  f"route to other top-{cfg.experts_per_token} experts "
                  f"through the plain route ({rec['routed_differently']} "
                  f"routed differently); agreeing tokens max err "
                  f"{rec['max_err_agreeing']:.3g}; dropped_frac "
                  f"{rec['dropped_frac']:.4f}", flush=True)
            if not (torch.isfinite(y).all() and torch.isfinite(yp).all()):
                raise AssertionError(f"mixtral block {i}: non-finite output")
            if rec["top_k_differs"] >= ROUTE_FLIP_SHARE * T:
                raise AssertionError(f"mixtral block {i}: "
                                     f"{rec['top_k_differs']} of {T} tokens "
                                     "route differently")
            if not torch.allclose(a, b, atol=3e-4, rtol=3e-3):
                raise AssertionError(f"mixtral block {i}: agreeing tokens "
                                     f"max err {rec['max_err_agreeing']}")
            h = y
        head = model.embed.T if model.head is None else model.head
        la = (model.ln_f(y) @ head).reshape(T, -1)[agree]
        lb = (model.ln_f(yp) @ head).reshape(T, -1)[agree]
        logits_err = float((la - lb).abs().max())
        if not (torch.isfinite(la).all()
                and torch.allclose(la, lb, atol=3e-4, rtol=3e-3)):
            raise AssertionError(f"mixtral logits: max err {logits_err}")
    return {"blocks": blocks, "logits_max_err_agreeing": logits_err,
            "moe_input": moe_in, "capacity": C}


def traced_syncs(fn) -> dict:
    """``fn()`` under torch.profiler (CUDA activity): its synchronising
    CUDA runtime calls (SYNC_CALLS), all of them and those that start
    before the end of its last kernel launch (the profiler may flush the
    card with one of its own as it stops), its runtime calls and its
    device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    torch.cuda.synchronize()
    syncs, launch_end, runtime, device = [], 0, 0, 0
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            device += 1
        elif e.name().startswith("cu"):
            runtime += 1
            if e.name() in SYNC_CALLS:
                syncs.append((e.start_ns(), e.name()))
            elif "Launch" in e.name():
                launch_end = max(launch_end, e.start_ns() + e.duration_ns())
    return {"sync_calls": [name for _, name in syncs],
            "before_last_launch": [name for t, name in syncs
                                   if t < launch_end],
            "runtime_calls": runtime, "device_events": device}


def moe_sync_calls(moe, n) -> dict:
    """One MoE layer at the path's shape must make the host wait for the
    card nowhere: run once under ``torch.cuda.set_sync_debug_mode``
    ("error": PyTorch raises at any synchronising op), then under
    torch.profiler beside a baseline that launches one kernel, where no
    synchronising runtime call may start before its last launch ends and
    it may make no more than the baseline (the profiler's own)."""
    with torch.inference_mode():
        moe(n)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe(n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        base = traced_syncs(lambda: torch.zeros(1, device="cuda"))
        own = traced_syncs(lambda: moe(n))
    if not own["runtime_calls"] or not own["device_events"]:
        raise AssertionError(f"MoE profile holds no launch: {own}")
    if (own["before_last_launch"]
            or len(own["sync_calls"]) > len(base["sync_calls"])):
        raise AssertionError(f"MoE layer synchronises: {own}; a profile "
                             f"of one kernel: {base}")
    return {"layer": own, "baseline": base}


def moe_split(moe, n, C: int) -> dict:
    """The MoE layer's time at the path's shape, launch-paced
    (``time_ms``), in its three parts: router and dispatch (``route``),
    the expert products (``expert_ffn``: three batched GEMMs), and the
    gated combine; with the expert products' rate and the share of their
    capacity rows that padding fills."""
    cfg = moe.cfg
    T, d = n.shape[0] * n.shape[1], n.shape[2]
    xg = n.reshape(1, T, d)
    with torch.inference_mode():
        h, state, _ = moe.route(xg, C)
        out = moe.expert_ffn(h)
        ms = {"layer": time_ms(lambda: moe(n), 10),
              "router_and_dispatch": time_ms(lambda: moe.route(xg, C), 20),
              "expert_gemms": time_ms(lambda: moe.expert_ffn(h), 10),
              "combine": time_ms(lambda: moe.combine(out, state), 20)}
        kept = int(state["keep"].sum())
    E, ff = cfg.n_experts, cfg.d_ff
    gemm_flops = (3 if cfg.mlp_type == "swiglu" else 2) * 2 * E * C * d * ff
    return {"ms": ms, "capacity": C, "capacity_rows": E * C,
            "kept_assignments": kept, "padding_share": 1 - kept / (E * C),
            "expert_gemm_tflop": gemm_flops / 1e12,
            "expert_gemm_tflop_per_s": gemm_flops / ms["expert_gemms"] / 1e9}


def measure_mixtral_flash(g) -> dict:
    """flash_attention at the mixtral path's shape, (B, S, H, KV, hd) =
    (4, 256, 32, 8, 128), window 4096 (no key hidden at S = 256), f32:
    kernel, plain and scaled_dot_product_attention (enable_gqa) times as
    ``measure_zamba`` takes them, and the bounds.  Bytes: q and the
    output at 32 heads, k and v at 8."""
    B, S, H, KV, hd, _, W = K2_CASES[-1]
    q = torch.randn(B, S, H, hd, generator=g, device="cuda")
    k, v = (torch.randn(B, S, KV, hd, generator=g, device="cuda")
            for _ in range(2))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    k2 = lambda: k2_ops.flash_attention(q, k, v, window=W)  # noqa: E731
    k2p = lambda: k2_ref.attention(q, k, v, window=W)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, enable_gqa=True)
    err = float((k2() - lib().transpose(1, 2)).abs().max())
    p1, m1, l1, m2, l2, p2 = (time_ms(f, 50)
                              for f in (k2p, k2, lib, k2, lib, k2p))
    d1, dl1, d2, dl2 = (device_time_ms(f, 50) for f in (k2, lib, k2, lib))
    n_bytes = 4 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    return {"shape": [B, S, H, KV, hd], "window": W,
            "ms": statistics.median([m1, m2]), **device_fields(d1, d2),
            "plain_ms": statistics.median([p1, p2]),
            **bound(n_bytes, 4 * B * H * S * S * hd, tensor_cores=True),
            "library_ms": statistics.median([l1, l2]),
            "library_device_ms": statistics.median([dl1[0], dl2[0]]),
            "max_abs_err_vs_library": err}


def mixtral_phase(g, card: str) -> tuple[dict, dict, Model]:
    """Phase 8c: serve MIXTRAL_REQUESTS x MIXTRAL_LEN tokens of the
    mixtral path with dndm through the port's entry points, with phase
    6's checks and the launch counts (flash_attention once per "moe"
    block per network call); the block-by-block denoiser check; the MoE
    layer's synchronising calls and time split; one profiled sampler run;
    flash_attention at the path's shape; phase 8f's decode check; peak
    memory.  Returns the path's record, its launch counts and the model
    (phase 16 runs it once more)."""
    torch.cuda.reset_peak_memory_stats()
    model, info = mixtral_model()
    print(f"mixtral path ({card}): {info['params'] / 1e9:.3f} B parameters "
          f"({info['weights_gb']:.1f} GB); reduced: {info['reduced']}; "
          f"config {info['config']}", flush=True)
    model, sched, done, drain_s, counts = main_path(
        n_req=MIXTRAL_REQUESTS, n_len=MIXTRAL_LEN, batch=MIXTRAL_BATCH,
        steps=MIXTRAL_T, model=model)
    stats = check_main_path(model, sched, done, counts, MIXTRAL_REQUESTS,
                            MIXTRAL_LEN)
    ms_call = 1e3 * stats["timed_wall_s"] / stats["timed_nfe"]
    print(f"mixtral path: {counts}; NFE {stats['timed_nfe']}; "
          f"{ms_call:.2f} ms per network call, "
          f"{len(done) / drain_s:.3f} req/s", flush=True)
    den = check_mixtral_denoiser(model, MIXTRAL_BATCH, MIXTRAL_LEN)
    moe = model.blocks[0].moe
    syncs = moe_sync_calls(moe, den["moe_input"])
    split = moe_split(moe, den["moe_input"], den["capacity"])
    print(f"mixtral MoE layer: synchronising calls "
          f"{syncs['layer']['before_last_launch']} before its last launch, "
          f"{syncs['layer']['sync_calls']} in all (one-kernel baseline "
          f"{syncs['baseline']['sync_calls']}) of "
          f"{syncs['layer']['runtime_calls']} runtime calls; ms "
          f"{split['ms']}; expert GEMMs "
          f"{split['expert_gemm_tflop_per_s']:.1f} TFLOP/s; padding "
          f"{100 * split['padding_share']:.1f}% of the capacity rows",
          flush=True)
    prof = profile_run(GenerationEngine(model, EngineConfig(
        method="dndm", steps=MIXTRAL_PROFILE_T, noise_kind="absorbing",
        x0_mode="sample"), device="cuda"), "dndm", MIXTRAL_BATCH,
        MIXTRAL_LEN, top=10)
    prof["device_busy_share"] = prof["device_ms_per_call"] / ms_call
    flash = measure_mixtral_flash(g)
    decode = decode_check(f"mixtral-8x7b ({MIXTRAL_LAYERS} layers)", model)
    peak = torch.cuda.max_memory_allocated()
    if peak >= CARD_MEMORY_BYTES:
        raise AssertionError(f"mixtral path peak memory {peak / 1e9:.1f} GB")
    del sched, moe, den["moe_input"]
    torch.cuda.empty_cache()
    return {
        "mixtral_path": f"mixtral-8x7b full width, {MIXTRAL_LAYERS} of 32 "
                        f"layers, dndm T={MIXTRAL_T}, absorbing, sample",
        "card": card, **info,
        "requests": len(done), "tokens_per_request": MIXTRAL_LEN,
        "batches": stats["batches"], "nfe_timed": stats["timed_nfe"],
        "nfe_warmup": stats["warmup_nfe"], "nfe_total": stats["total_nfe"],
        "launches": counts, "drain_s": drain_s,
        "timed_wall_s": stats["timed_wall_s"],
        "req_per_s": len(done) / drain_s, "ms_per_network_call": ms_call,
        "compile_seconds": max(r.compile_seconds for r in done.values()),
        "denoiser": {k: v for k, v in den.items() if k != "moe_input"},
        "moe_sync": syncs, "moe_split": split, "profile": prof,
        "flash_attention": flash, "decode": decode,
        "max_memory_allocated_gb": peak / 1e9}, counts, model


# The multi-device code on the one card (phase 16).

@contextlib.contextmanager
def counted_collectives(names):
    """Count the calls of the ``torch.distributed`` functions ``names``
    inside the block ({name: calls})."""
    import torch.distributed as dist
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(dist, n) for n in names}

    def counted(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call
    for n, fn in saved.items():
        setattr(dist, n, counted(n, fn))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def mesh_mixtral_check(model, mesh) -> dict:
    """Phase 8c's 4-layer mixtral, one forward of its serving shape with
    the global dispatch and one with "shard_map" under the (1, 1) mesh:
    logits and every MoE layer's output bitwise equal; each MoE layer
    sends its buffer out and back by all_to_all_single and gathers its
    tokens by all_gather (counted in the last forward)."""
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(16)
    tok = torch.randint(0, cfg.vocab_size - 1, (MIXTRAL_BATCH, MIXTRAL_LEN),
                        generator=g, device="cuda")
    t = torch.rand(MIXTRAL_BATCH, generator=g, device="cuda")
    moes = [blk.moe for blk in model.blocks]
    ys: list = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: ys.append(out[0]))
             for m in moes]
    ms = {}
    try:
        with torch.inference_mode():
            # the first collective of the group pays NCCL's set-up: the
            # sharded forward runs twice, the second checked and timed
            for name in ("global", "shard_map_first", "shard_map"):
                ys.clear()
                with contextlib.ExitStack() as stack:
                    if name != "global":
                        stack.enter_context(swapped_cfg(moes, cfg.replace(
                            moe_dispatch="shard_map")))
                        stack.enter_context(mesh_lib.use_mesh(mesh))
                        calls = stack.enter_context(counted_collectives(
                            ("all_to_all_single", "all_gather")))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits = model(tok, t, causal=False)
                    torch.cuda.synchronize()
                    ms[name] = 1e3 * (time.perf_counter() - t0)
                if name == "global":
                    want, want_y = logits, list(ys)
    finally:
        for h in hooks:
            h.remove()
    n = len(moes)
    if calls != {"all_to_all_single": 2 * n, "all_gather": n}:
        raise AssertionError(f"shard_map forward made collectives {calls}, "
                             f"expected 2 x {n} all-to-alls and {n} gathers")
    same_y = [torch.equal(a, b) for a, b in zip(ys, want_y, strict=True)]
    if not all(same_y) or not torch.equal(logits, want):
        raise AssertionError(f"shard_map is not bitwise the global dispatch: "
                             f"MoE outputs equal {same_y}, logits max diff "
                             f"{(logits - want).abs().max().item():.3g}")
    return {"tokens": list(tok.shape), "moe_layers": n, "collectives": calls,
            "logits_bitwise": True, "moe_outputs_bitwise": same_y,
            "forward_ms": ms}


def mesh_train_check(mesh) -> dict:
    """MESH_TRAIN_STEPS train steps of a reduced mixtral ("shard_map",
    capacity factor 16) with DTensor parameters on the (1, 1) mesh and
    the same steps on one device, the same draws from the same
    generator: metrics and parameters at the f32 bar of
    tests/test_torch_training.py."""
    policy = sharding.ShardingPolicy()
    cfg = configs_lib.get("mixtral-8x7b").reduced(capacity_factor=16.0,
                                                  moe_dispatch="shard_map")
    pipe = iter(DataPipeline(DataConfig(vocab=cfg.vocab_size - 1,
                                        seq_len=MESH_TRAIN_SEQ,
                                        batch=MESH_TRAIN_BATCH)))
    batches = [torch.as_tensor(next(pipe)["x0"], device="cuda")
               for _ in range(MESH_TRAIN_STEPS)]

    def steps(sharded: bool):
        model = Model(cfg, device="cuda", seed=0)
        if sharded:
            sharding.shard_module(model, mesh, policy)
        opt = AdamW(warmup_cosine(TRAIN_LR, TRAIN_LR_WARMUP, 100))
        state = init_state(model, opt)
        step = make_train_step(model, sched_lib.linear(TRAIN_T),
                               noise_lib.absorbing(cfg.vocab_size), opt)
        gen = torch.Generator(device="cuda").manual_seed(0)
        out = []
        for x0 in batches:
            if sharded:
                with mesh_lib.use_mesh(mesh):
                    state, met = step(state, sharding.shard_batch(
                        {"x0": x0}, mesh, policy), gen)
            else:
                state, met = step(state, {"x0": x0}, gen)
            out.append(({k: float(v) for k, v in met.items()},
                        {k: full(p).detach().clone()
                         for k, p in model.named_parameters()},
                        is_sharded(next(model.parameters()))))
        return out

    got, want = steps(True), steps(False)
    lr_sum, worst = 0.0, {}
    for i, ((gm, gp, dt), (wm, wp, _)) in enumerate(zip(got, want)):
        if not dt:
            raise AssertionError("the sharded model's parameters are not "
                                 "DTensors")
        for k in ("lr", "grad_norm", "loss", "ce", "load_balance"):
            if abs(gm[k] - wm[k]) > MESH_ATOL + MESH_RTOL * abs(wm[k]):
                raise AssertionError(f"step {i} {k}: {gm[k]} against "
                                     f"{wm[k]} on one device")
        lr_sum += wm["lr"]
        off = total = 0
        for k, w in wp.items():
            d = (gp[k] - w).abs()
            bar = MESH_ATOL + MESH_RTOL * w.abs()
            if (d > bar + 2 * lr_sum).any():
                raise AssertionError(f"step {i} {k}: off by "
                                     f"{d.max().item():.3g}")
            off += int((d > bar).sum())
            total += d.numel()
            worst[k] = max(worst.get(k, 0.0), d.max().item())
        if off > MESH_ILL_CONDITIONED * total:
            raise AssertionError(f"step {i}: {off} of {total} parameters off "
                                 "the f32 bar")
    return {"config": "mixtral-8x7b reduced, capacity_factor 16, "
                      "moe_dispatch shard_map",
            "steps": MESH_TRAIN_STEPS, "batch": MESH_TRAIN_BATCH,
            "seq": MESH_TRAIN_SEQ,
            "loss": [m["loss"] for m, _, _ in got],
            "loss_one_device": [m["loss"] for m, _, _ in want],
            "params_max_abs_diff": max(worst.values()),
            "params_bitwise": all(torch.equal(gp[k], wp[k])
                                  for (_, gp, _), (_, wp, _) in
                                  zip(got, want) for k in wp)}


def mesh_phase(mx_model, card: str) -> dict:
    """Phase 16: a world-size-1 NCCL group met through a file under
    build/, a (1, 1) ("data", "model") mesh, the sharded MoE dispatch on
    phase 8c's model and a DTensor train step; the group is destroyed at
    the end, whatever happened."""
    import torch.distributed as dist
    MESH_RENDEZVOUS.parent.mkdir(parents=True, exist_ok=True)
    MESH_RENDEZVOUS.unlink(missing_ok=True)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{MESH_RENDEZVOUS}",
                            rank=0, world_size=1)
    try:
        backend = dist.get_backend()
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), "cuda")
        init_s = time.perf_counter() - t0
        moe = mesh_mixtral_check(mx_model, mesh)
        train = mesh_train_check(mesh)
    finally:
        dist.destroy_process_group()
    return {"card": card, "backend": backend,
            "mesh": {"shape": [1, 1], "axes": ["data", "model"]},
            "group_init_s": init_s, "mixtral": moe, "train": train}


def zoo_sweep() -> dict:
    """Phase 8d: every registered config, at
    ``.reduced(attn_impl="pallas")`` with random weights from seed 0,
    through one GenerationEngine dndm batch (B ZOO_B, N ZOO_N, T ZOO_T,
    absorbing noise; the audio and vision configs with the stub's
    frontend embeddings) on the card.  Checks as phase 6's: in-vocabulary
    tokens, no [MASK], NFE = the batch's unique tau values, and each
    kernel's launches per network call (the cold key's warm-up run
    included)."""
    out = {}
    for arch in configs_lib.list_archs():
        cfg = configs_lib.get(arch).reduced(attn_impl="pallas")
        model = Model(cfg, device="cuda", seed=0)
        engine = GenerationEngine(model, EngineConfig(
            method="dndm", steps=ZOO_T, noise_kind="absorbing",
            x0_mode="sample"), device="cuda")
        fe = frontend_lib.fake_frontend_embeds(
            torch.Generator(device="cuda").manual_seed(1), cfg, ZOO_B,
            "cuda")
        cond = None if fe is None else {"frontend_embeds": fe}
        reset_counts()
        engine.network_calls = 0
        res, wall = engine.generate(0, ZOO_B, ZOO_N, cond=cond)
        counts = read_counts(engine)
        tok = res.tokens.cpu()
        if tok.shape != (ZOO_B, ZOO_N) or not (
                (tok >= 0) & (tok < engine.noise.mask_id)).all():
            raise AssertionError(f"zoo {arch}: tokens out of vocabulary or "
                                 "[MASK] left")
        tau, *_ = loop.setup(torch.Generator(device="cuda").manual_seed(0),
                             engine.noise, ZOO_B, ZOO_N,
                             dist=engine.runtime().dist, shared=True,
                             device=engine.device)
        n_unique = len(loop.unique_times(tau.cpu().numpy()))
        if res.nfe != n_unique:
            raise AssertionError(f"zoo {arch}: NFE {res.nfe} != {n_unique}")
        calls = counts["network_calls"]
        if calls != 2 * res.nfe:
            raise AssertionError(f"zoo {arch}: {calls} network calls for "
                                 f"NFE {res.nfe} and its warm-up")
        for k, per in per_call_launches(cfg, "dndm_update").items():
            if counts[k] != per * calls:
                raise AssertionError(f"zoo {arch}: {k} launched {counts[k]}"
                                     f" times, expected {per} x {calls}")
        out[arch] = {"pattern": list(cfg.block_pattern), "nfe": res.nfe,
                     "launches": counts, "wall_s": wall,
                     "frontend": cfg.frontend}
        del model, engine
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------
# The xlstm path (phase 8e) and decode on the card (phase 8f).

@contextlib.contextmanager
def swapped_cfg(modules, cfg):
    """Run ``modules`` with ``cfg`` in place of their own config."""
    saved = [m.cfg for m in modules]
    for m in modules:
        m.cfg = cfg
    try:
        yield
    finally:
        for m, c in zip(modules, saved):
            m.cfg = c


GEMM_RE = re.compile(r"gemm|gemv|xmma", re.I)


def profile_call(fn, top: int = 6) -> dict:
    """One call of ``fn`` (after a warm one) under torch.profiler: device
    ms, kernel launches, the GEMM kernels' ms (by name) and the kernels
    that take most of the time."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_us = [e.self_device_time_total for e in kernels]
    order = sorted(range(len(kernels)), key=lambda i: -dev_us[i])[:top]
    return {"device_ms": sum(dev_us) / 1e3,
            "launches": sum(e.count for e in kernels),
            "gemm_ms": sum(u for e, u in zip(kernels, dev_us)
                           if GEMM_RE.search(e.key)) / 1e3,
            "top_kernels": [{"kernel": kernels[i].key[:72],
                             "ms": dev_us[i] / 1e3,
                             "launches": kernels[i].count} for i in order]}


def xlstm_denoiser(model, batch: int, n_tok: int) -> dict:
    """The full-width denoiser's logits with mLSTM's parallel form against
    the chunked form (mlstm_chunk XLSTM_CHUNK) on the same weights, at the
    repo's logits bar (atol 3e-4, rtol 3e-3); then one network call, one
    mLSTM block and one sLSTM block (both directions, the denoiser's
    mode), each under torch.profiler."""
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size - 1, (batch, n_tok), generator=g,
                        device="cuda", dtype=torch.int32)
    t = torch.rand(batch, generator=g, device="cuda")
    fn = model.denoise_fn()
    with torch.inference_mode():
        par = fn(tok, t, None)
        with swapped_cfg([b.mixer for k, b in zip(cfg.block_pattern,
                                                   model.blocks)
                          if k == "mlstm"],
                         cfg.replace(mlstm_chunk=XLSTM_CHUNK)):
            chunked = fn(tok, t, None)
        torch.cuda.synchronize()
    err = float((chunked - par).abs().max())
    if not (torch.isfinite(par).all() and torch.isfinite(chunked).all()
            and torch.allclose(chunked, par, atol=3e-4, rtol=3e-3)):
        raise AssertionError(f"xlstm parallel vs chunked logits: max err "
                             f"{err}")
    h = torch.randn(batch, n_tok, cfg.d_model, generator=g, device="cuda")
    m_blk = model.blocks[cfg.block_pattern.index("mlstm")]
    s_blk = model.blocks[cfg.block_pattern.index("slstm")]
    n_m, n_s = (cfg.block_pattern.count(k) for k in ("mlstm", "slstm"))
    # a profile can drop kernel events: the blocks' device time must add
    # up to the call's (the head and the embedding are ~2% of it), else
    # the profiles are taken once more, and a second miss fails
    for _ in range(PROFILE_ATTEMPTS):
        profs = {"profile_call": profile_call(lambda: fn(tok, t, None)),
                 "profile_mlstm_block": profile_call(
                     lambda: m_blk(h, causal=False)),
                 "profile_slstm_block": profile_call(
                     lambda: s_blk(h, causal=False))}
        blocks_ms = (n_m * profs["profile_mlstm_block"]["device_ms"]
                     + n_s * profs["profile_slstm_block"]["device_ms"])
        call_ms = profs["profile_call"]["device_ms"]
        if abs(blocks_ms - call_ms) <= PROFILE_SUM_TOL * call_ms:
            break
    else:
        raise AssertionError(f"xlstm profiles: the blocks' {blocks_ms:.2f} "
                             f"ms against the call's {call_ms:.2f} ms")
    return {"logits_max_err_chunked_vs_parallel": err,
            "logits_max_abs": float(par.abs().max()),
            "chunk": XLSTM_CHUNK, **profs}


def xlstm_phase(card: str) -> tuple[dict, dict, Model]:
    """Phase 8e: xlstm-350m at every published width and depth, random
    weights from seed 0, f32, served with dndm through the port's entry
    points with phase 6's checks (dndm_update once per network call at
    K = 50304, no other kernel); the parallel form against the chunked;
    the profiled call, mLSTM block and sLSTM block, and the device-time
    split.  Returns the path's record, its launch counts and the model
    (phase 8f decodes it)."""
    cfg = configs_lib.get("xlstm-350m").replace(attn_impl="pallas")
    model = Model(cfg, device="cuda", seed=0)
    if model.param_count() != XLSTM_PARAMS:
        raise AssertionError(f"xlstm-350m: {model.param_count()} "
                             f"parameters, not {XLSTM_PARAMS}")
    print(f"xlstm path ({card}): {model.param_count()} parameters "
          f"({4 * model.param_count() / 1e9:.2f} GB)", flush=True)
    model, sched, done, drain_s, counts = main_path(
        n_req=XLSTM_REQUESTS, n_len=XLSTM_LEN, batch=XLSTM_BATCH,
        steps=XLSTM_T, model=model)
    stats = check_main_path(model, sched, done, counts, XLSTM_REQUESTS,
                            XLSTM_LEN)
    ms_call = 1e3 * stats["timed_wall_s"] / stats["timed_nfe"]
    print(f"xlstm path: {counts}; NFE {stats['timed_nfe']}; "
          f"{ms_call:.2f} ms per network call, "
          f"{len(done) / drain_s:.3f} req/s", flush=True)
    den = xlstm_denoiser(model, XLSTM_BATCH, XLSTM_LEN)
    call, mb, sb = (den[k] for k in ("profile_call", "profile_mlstm_block",
                                     "profile_slstm_block"))
    n_m = cfg.block_pattern.count("mlstm")
    n_s = cfg.block_pattern.count("slstm")
    split = {"call_device_ms": call["device_ms"],
             "call_gemm_ms": call["gemm_ms"],
             "mlstm_layers_ms": n_m * mb["device_ms"],
             "mlstm_gemm_ms": n_m * mb["gemm_ms"],
             "mlstm_elementwise_ms": n_m * (mb["device_ms"] - mb["gemm_ms"]),
             "slstm_layers_ms": n_s * sb["device_ms"],
             "slstm_gemm_ms": n_s * sb["gemm_ms"],
             "slstm_launches": n_s * sb["launches"],
             "device_busy_share": call["device_ms"] / ms_call}
    print(f"xlstm denoiser: chunked vs parallel logits max err "
          f"{den['logits_max_err_chunked_vs_parallel']:.3g}; one call "
          f"{call['device_ms']:.2f} ms of kernels in {call['launches']} "
          f"launches (GEMMs {call['gemm_ms']:.2f}), busy "
          f"{100 * split['device_busy_share']:.1f}%; mLSTM layers "
          f"{split['mlstm_layers_ms']:.2f} ms (elementwise "
          f"{split['mlstm_elementwise_ms']:.2f}); sLSTM layers "
          f"{split['slstm_layers_ms']:.2f} ms in {split['slstm_launches']} "
          "launches", flush=True)
    line = {
        "xlstm_path": f"xlstm-350m full width and depth, dndm "
                      f"T={XLSTM_T}, absorbing, sample",
        "card": card, "params": model.param_count(),
        "requests": len(done), "tokens_per_request": XLSTM_LEN,
        "batches": stats["batches"], "nfe_timed": stats["timed_nfe"],
        "nfe_thm_d1": XLSTM_T * (1 - (1 - 1 / XLSTM_T) ** XLSTM_LEN),
        "nfe_warmup": stats["warmup_nfe"], "nfe_total": stats["total_nfe"],
        "launches": counts, "drain_s": drain_s,
        "timed_wall_s": stats["timed_wall_s"],
        "req_per_s": len(done) / drain_s, "ms_per_network_call": ms_call,
        "compile_seconds": max(r.compile_seconds for r in done.values()),
        "denoiser": den, "split": split}
    del sched
    return line, counts, model


def decode_check(name: str, model, n_pos: int = DECODE_POS) -> dict:
    """Phase 8f for one model: DECODE_B rows of ``n_pos`` random tokens
    decoded one at a time through the port's caches (``init_cache(B,
    n_pos)``; "pallas" attention through flash_decode) against
    ``forward(causal=True)`` on the same tokens, at the phase's bar; the
    launch counts, zeroed just before the decoding and read just after:
    flash_decode once per attention-family block and position, no other
    kernel.  A "moe" model's forward runs at a capacity that drops no
    assignment (capacity_factor E / K), as one token at a time never
    drops one.  Reports ms per decode step (median, synchronised each
    step)."""
    from repro_torch.models.moe import MoE
    t0 = time.perf_counter()
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(2)
    tok = torch.randint(0, cfg.vocab_size - 1, (DECODE_B, n_pos),
                        generator=g, device="cuda", dtype=torch.int32)
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    no_drop = (cfg.replace(capacity_factor=cfg.n_experts
                           / cfg.experts_per_token) if moes else cfg)
    steps = []
    with torch.inference_mode(), swapped_cfg(moes, no_drop):
        full = model(tok, causal=True)
        cache = model.init_cache(DECODE_B, n_pos)
        torch.cuda.synchronize()
        reset_counts()
        outs = []
        for i in range(n_pos):
            ts = time.perf_counter()
            logits, cache = model.decode_step(tok[:, i:i + 1], cache, i)
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - ts))
            outs.append(logits)
        counts = {k: fn.launches for k, fn in KERNELS.items()}
    dec = torch.cat(outs, 1)
    err = float((dec - full).abs().max())
    scale = float(full.abs().max())
    if not torch.isfinite(dec).all() or err > DECODE_REL * scale + DECODE_ABS:
        raise AssertionError(f"decode {name}: max |decode - forward| {err} "
                             f"over max |forward| {scale}")
    n_attn = sum(k in ("attn", "swa", "shared_attn", "moe")
                 for k in cfg.block_pattern)
    want = {k: 0 for k in KERNELS}
    want["flash_decode"] = n_attn * n_pos
    if counts != want:
        raise AssertionError(f"decode {name}: launches {counts}, expected "
                             f"{want}")
    ring = [c["k"].shape[1] for c in cache if "k" in c]
    rec = {"model": name, "positions": n_pos, "batch": DECODE_B,
           "ring_slots": sorted(set(ring)), "max_abs_err": err,
           "max_abs_forward": scale, "launches": counts,
           "ms_per_step": statistics.median(steps),
           "ms_first_step": steps[0], "seconds": time.perf_counter() - t0}
    print(f"decode {name}: {n_pos} positions, max |decode - forward| "
          f"{err:.3g} (max |forward| {scale:.3g}); "
          f"{rec['ms_per_step']:.2f} ms per step; {counts['flash_decode']} "
          f"flash_decode launches; {rec['seconds']:.1f} s", flush=True)
    return rec


def ring_decode() -> dict:
    """Phase 8f's ring-wrap case: dndm-text8 at ``.reduced()`` with two
    "swa" blocks of window RING_WINDOW, RING_POS positions through rings
    of RING_WINDOW slots (so each wraps twice)."""
    cfg = configs_lib.get("dndm-text8").reduced(
        n_layers=2, block_pattern=("swa", "swa"),
        sliding_window=RING_WINDOW, attn_impl="pallas")
    model = Model(cfg, device="cuda", seed=0)
    rec = decode_check("ring (dndm-text8 reduced, swa window "
                       f"{RING_WINDOW})", model, n_pos=RING_POS)
    if rec["ring_slots"] != [RING_WINDOW]:
        raise AssertionError(f"ring slots {rec['ring_slots']}")
    return rec



def launch_floor(name: str, logits, mask, gumbel, x=None, tau=None,
                 t: int = 0):
    """The floor under a decode wrapper's host time: a bare allocation of
    its output, as the wrapper makes it, and a direct ctypes call of its C
    entry point with arguments computed once (f32, version 1, temperature
    1).  Returns that call, for ``device_time_ms``."""
    fn = getattr(build.library().lib, f"{name}_f32")
    stream = torch.cuda.current_stream().cuda_stream
    B, N, K = logits.shape
    if name == "dndm_update":
        out = torch.empty_like(x)
        args = (logits.data_ptr(), gumbel.data_ptr(), mask.data_ptr(),
                x.data_ptr(), tau.data_ptr(), out.data_ptr(), B * N, K, t,
                1, 1.0, stream)

        def alloc():
            return torch.empty_like(x)
    else:
        tok = logits.new_empty((B, N), dtype=torch.int32)
        score = torch.empty_like(tok, dtype=torch.float32)
        args = (logits.data_ptr(), gumbel.data_ptr(), mask.data_ptr(),
                tok.data_ptr(), score.data_ptr(), B * N, K, 1.0, stream)

        def alloc():
            t = logits.new_empty((B, N), dtype=torch.int32)
            return t, torch.empty_like(t, dtype=torch.float32)
    build.check(fn(*args), name)

    def call():
        alloc()
        fn(*args)
    return call


def measure(g) -> dict:
    """Kernel, plain and library times at the main path's shapes, as
    ``measure_zamba`` takes them."""
    B, N, K = MAIN_BATCH, MAIN_LEN, 28
    logits = torch.randn(B, N, K, generator=g, device="cuda")
    x = torch.full((B, N), K - 1, dtype=torch.int32, device="cuda")
    tau = torch.randint(1, MAIN_T + 1, (1, N), generator=g, device="cuda",
                        dtype=torch.int32).expand(B, N).contiguous()
    mask = torch.zeros(K, device="cuda")
    mask[K - 1] = -1e9
    noise = gumbel_noise(g, (B, N, K), "cuda")
    t = int(tau[0, 0])
    kw = dict(mask=mask, gumbel=noise, version=1, temperature=1.0)
    k1 = lambda: k1_ops.dndm_update(logits, x, tau, t, **kw)  # noqa: E731
    k1p = lambda: k1_ref.dndm_update(logits, x, tau, t, **kw)  # noqa: E731
    # bytes: logits + gumbel read, mask read, x and tau read, tokens out
    k1_bytes = B * N * K * (4 + 4) + K * 4 + B * N * 4 * 3
    k1_ops_n = B * N * K * 3         # + mask, + gumbel, compare
    # plain, kernel, kernel, plain
    p1 = time_ms(k1p, 200)
    m1 = time_ms(k1, 200)
    m2 = time_ms(k1, 200)
    p2 = time_ms(k1p, 200)
    d1, d2 = (device_time_ms(k1, 200) for _ in range(2))
    f1 = launch_floor("dndm_update", logits, mask, noise, x, tau, t)
    floor1 = statistics.median(device_time_ms(f1, 200)[1] for _ in range(2))

    H, hd = 12, 64
    q = torch.randn(B, N, H, hd, generator=g, device="cuda")
    k = torch.randn(B, N, H, hd, generator=g, device="cuda")
    v = torch.randn(B, N, H, hd, generator=g, device="cuda")
    k2 = lambda: k2_ops.flash_attention(q, k, v)  # noqa: E731
    k2p = lambda: k2_ref.attention(q, k, v)  # noqa: E731
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    k2_flops = 4 * B * H * N * N * hd
    k2_bytes = 4 * B * N * H * hd * 4
    p3 = time_ms(k2p, 50)
    m3 = time_ms(k2, 50)
    l3 = time_ms(lib, 50)
    m4 = time_ms(k2, 50)
    l4 = time_ms(lib, 50)
    p4 = time_ms(k2p, 50)
    d3, dl3, d4, dl4 = (device_time_ms(f, 50) for f in (k2, lib, k2, lib))

    # flash_attention at the ranked path's profiled shape: dndm-mt's 8
    # heads of 64 over 128 target tokens after a 56-token prefix
    Hr, Sr = 8, MT_LEN + 56
    qr, kr, vr = (torch.randn(MT_BATCH, Sr, Hr, hd, generator=g,
                              device="cuda") for _ in range(3))
    qrt, krt, vrt = (a.transpose(1, 2) for a in (qr, kr, vr))
    k2r = lambda: k2_ops.flash_attention(qr, kr, vr)  # noqa: E731
    k2rp = lambda: k2_ref.attention(qr, kr, vr)  # noqa: E731
    libr = lambda: F.scaled_dot_product_attention(qrt, krt,  # noqa: E731
                                                  vrt)
    pr1, mr1, lr1, mr2, lr2, pr2 = (time_ms(f, 50) for f in (
        k2rp, k2r, libr, k2r, libr, k2rp))
    dr1, dlr1, dr2, dlr2 = (device_time_ms(f, 50)
                            for f in (k2r, libr, k2r, libr))
    kr_bytes = 4 * MT_BATCH * Sr * Hr * hd * 4
    kr_flops = 4 * MT_BATCH * Hr * Sr * Sr * hd

    # decode_scores at the ranked path's shape, with its Gumbel noise
    B3, N3 = MT_BATCH, MT_LEN
    logits3 = torch.randn(B3, N3, K, generator=g, device="cuda")
    noise3 = gumbel_noise(g, (B3, N3, K), "cuda")
    kw3 = dict(mask=mask, gumbel=noise3, temperature=1.0)
    k3 = lambda: k3_ops.decode_scores(logits3, **kw3)  # noqa: E731
    k3p = lambda: k3_ref.decode_scores(logits3, **kw3)  # noqa: E731
    # bytes: logits + gumbel read, mask read, tokens and scores out
    k3_bytes = B3 * N3 * K * (4 + 4) + K * 4 + B3 * N3 * (4 + 4)
    # per element: + mask, + gumbel, compare, exp and the online sum
    k3_ops_n = B3 * N3 * K * 6
    p5 = time_ms(k3p, 200)
    m5 = time_ms(k3, 200)
    m6 = time_ms(k3, 200)
    p6 = time_ms(k3p, 200)
    d5, d6 = (device_time_ms(k3, 200) for _ in range(2))
    f3 = launch_floor("decode_scores", logits3, mask, noise3)
    floor3 = statistics.median(device_time_ms(f3, 200)[1] for _ in range(2))
    return {
        "dndm_update": {
            "ms": statistics.median([m1, m2]),
            **device_fields(d1, d2), "launch_floor_host_ms": floor1,
            "plain_ms": statistics.median([p1, p2]),
            **bound(k1_bytes, k1_ops_n), "library_ms": None},
        "flash_attention": {
            "ms": statistics.median([m3, m4]),
            **device_fields(d3, d4),
            "plain_ms": statistics.median([p3, p4]),
            **bound(k2_bytes, k2_flops, tensor_cores=True),
            "library_ms": statistics.median([l3, l4]),
            "library_device_ms": statistics.median([dl3[0], dl4[0]])},
        "flash_attention_ranked": {
            "shape": [MT_BATCH, Sr, Hr, hd],
            "ms": statistics.median([mr1, mr2]),
            **device_fields(dr1, dr2),
            "plain_ms": statistics.median([pr1, pr2]),
            **bound(kr_bytes, kr_flops, tensor_cores=True),
            "library_ms": statistics.median([lr1, lr2]),
            "library_device_ms": statistics.median([dlr1[0], dlr2[0]])},
        "decode_scores": {
            "ms": statistics.median([m5, m6]),
            **device_fields(d5, d6), "launch_floor_host_ms": floor3,
            "plain_ms": statistics.median([p5, p6]),
            **bound(k3_bytes, k3_ops_n), "library_ms": None},
    }


# ---------------------------------------------------------------------
# The decode kernels' measurements (--measure-decode [--parent DIR]).

def decode_inputs(g, B: int, N: int, K: int) -> dict:
    """f32 logits, the -1e9 mask at the last id, Gumbel noise, and x, tau,
    t as the text8 path gives them."""
    mask = torch.zeros(K, device="cuda")
    mask[K - 1] = -1e9
    tau = torch.randint(1, MAIN_T + 1, (1, N), generator=g, device="cuda",
                        dtype=torch.int32).expand(B, N).contiguous()
    return {"logits": torch.randn(B, N, K, generator=g, device="cuda"),
            "mask": mask, "gumbel": gumbel_noise(g, (B, N, K), "cuda"),
            "x": torch.full((B, N), K - 1, dtype=torch.int32, device="cuda"),
            "tau": tau, "t": int(tau[0, 0])}


def decode_call(fn, name: str, d: dict):
    """One call of the decode wrapper ``fn`` (``name``'s), f32 with Gumbel
    noise."""
    if name == "dndm_update":
        return lambda: fn(d["logits"], d["x"], d["tau"], d["t"],
                          mask=d["mask"], gumbel=d["gumbel"], version=1,
                          temperature=1.0)
    return lambda: fn(d["logits"], mask=d["mask"],
                      gumbel=d["gumbel"], temperature=1.0)


DECODE_TIMED = (("dndm_update", (8, 256, 28)),
                ("dndm_update", (4, 256, 32000)),
                ("decode_scores", (8, 128, 28)),
                ("decode_scores", (4, 256, 32000)))
PAIRS = 10


def tree_wrappers(tree: Path) -> dict:
    """The four kernel wrappers of the checkout ``tree`` (an unpacked
    ``git archive`` of another commit), loaded into this process beside
    this checkout's: that tree's ``kernels/build.py``, which builds its
    CUDA sources into its own build/, and its four ``ops.py``, each bound
    to that build module while it loads (their ``ref`` imports resolve to
    this checkout's, which serve CPU tensors only)."""
    import importlib.util
    import repro_torch.kernels as kernels_pkg
    src = tree / "src" / "repro_torch" / "kernels"

    def load(name: str, path: Path):
        spec = importlib.util.spec_from_file_location(f"tree_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod  # dataclasses look their module up
        spec.loader.exec_module(mod)
        return mod

    kernels_pkg.build = load("build", src / "build.py")
    try:
        return {k: getattr(load(k, src / k / "ops.py"), k)
                for k in ("dndm_update", "flash_attention", "decode_scores",
                          "ssd_scan")}
    finally:
        kernels_pkg.build = build


def paired_times(fns: dict, iters: int) -> dict:
    """``ms``, ``device_ms`` and ``host_ms`` of the calls ``fns["parent"]``
    and ``fns["change"]`` in PAIRS pairs, the parent first in every other
    pair: each side's medians and host readings, and the number of pairs
    in which the change's host time, and its device time, was the
    lower."""
    r = {k: {"ms": [], "device_ms": [], "host_ms": []} for k in fns}
    for i in range(PAIRS):
        for k in ("parent", "change")[::1 if i % 2 == 0 else -1]:
            r[k]["ms"].append(time_ms(fns[k], iters))
            dev, host = device_time_ms(fns[k], iters)
            r[k]["device_ms"].append(dev)
            r[k]["host_ms"].append(host)
    out = {k: {**{f: statistics.median(v) for f, v in r[k].items()},
               "host_ms_all": r[k]["host_ms"]} for k in fns}
    for f in ("host_ms", "device_ms"):
        out[f"pairs_change_{f}_lower"] = sum(
            c < p for c, p in zip(r["change"][f], r["parent"][f]))
    out["pairs"] = PAIRS
    return out


def compare_parent(g, parent: Path) -> dict:
    """The parent's wrappers (``tree_wrappers``) and this checkout's on the
    same inputs in one process, by ``paired_times``: the decode wrappers at
    the paths' shapes (with this checkout's launch floor, the same C
    interface as the parent's), flash_attention at the ranked shape and
    ssd_scan at the zamba2 shape.  The two trees' outputs must agree."""
    old = tree_wrappers(parent)
    new = {"dndm_update": k1_ops.dndm_update,
           "decode_scores": k3_ops.decode_scores,
           "flash_attention": k2_ops.flash_attention,
           "ssd_scan": k4_ops.ssd_scan}
    out = {}
    for name, (B, N, K) in DECODE_TIMED:
        d = decode_inputs(g, B, N, K)
        fns = {"parent": decode_call(old[name], name, d),
               "change": decode_call(new[name], name, d)}
        a, b = fns["parent"](), fns["change"]()
        if not torch.equal(a if name == "dndm_update" else a[0],
                           b if name == "dndm_update" else b[0]):
            raise AssertionError(f"{name}: the parent's tokens differ")
        iters = 200 if K < BLOCK_MIN_K else 50
        floor = launch_floor(name, d["logits"], d["mask"], d["gumbel"],
                             d["x"], d["tau"], d["t"])
        out[f"{name} {B}x{N}x{K}"] = {
            **paired_times(fns, iters),
            "launch_floor_host_ms": statistics.median(
                device_time_ms(floor, iters)[1] for _ in range(3))}
    qr, kr, vr = (torch.randn(MT_BATCH, MT_LEN + 56, 8, 64, generator=g,
                              device="cuda") for _ in range(3))
    out["flash_attention 8x184x8x64"] = paired_times(
        {t: (lambda f: lambda: f(qr, kr, vr))(w["flash_attention"])
         for t, w in (("parent", old), ("change", new))}, 50)
    B, S, H, P, N, L = K4_FULL[0]
    ins = ssd_inputs(g, B, S, H, P, N, torch.float32)
    out["ssd_scan 4x256x80x64x64x128"] = paired_times(
        {t: (lambda f: lambda: f(*ins, chunk=L))(w["ssd_scan"])
         for t, w in (("parent", old), ("change", new))}, 20)
    return out


def host_pieces(g, iters: int = 4000, repeats: int = 5) -> dict:
    """Host microseconds per call of each piece of a decode wrapper call
    at K = 28 (time.perf_counter over ``iters`` calls, median of
    ``repeats``): its checks, its output allocation, the data_ptr calls,
    the entry point's lookup, the stream query, the ctypes call with
    arguments computed once, build.launch, the launch floor and the whole
    wrapper.  The pieces that launch run a 3 us kernel each, under the
    host's pace."""
    def us(fn) -> float:
        for _ in range(100):
            fn()
        samples = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            samples.append((time.perf_counter() - t0) * 1e6 / iters)
        torch.cuda.synchronize()
        return statistics.median(samples)

    lib = build.library().lib
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    d = decode_inputs(g, 8, 256, 28)
    lg, x, tau, mask, gum = (d[k] for k in ("logits", "x", "tau", "mask",
                                           "gumbel"))
    o1 = torch.empty_like(x)
    args1 = (lg.data_ptr(), gum.data_ptr(), mask.data_ptr(), x.data_ptr(),
             tau.data_ptr(), o1.data_ptr(), 8 * 256, 28, d["t"], 1, 1.0)
    out["dndm_update 8x256x28"] = {
        "wrapper": us(decode_call(k1_ops.dndm_update, "dndm_update", d)),
        "checks": us(lambda: k1_ops._check(lg, x, tau, mask, gum, 1)),
        "alloc": us(lambda: torch.empty_like(x)),
        "data_ptr_x6": us(lambda: (lg.data_ptr(), gum.data_ptr(),
                                   mask.data_ptr(), x.data_ptr(),
                                   tau.data_ptr(), o1.data_ptr())),
        "entry_lookup": us(lambda: build.library().lib.dndm_update_f32),
        "stream_query": us(
            lambda: torch._C._cuda_getCurrentRawStream(dev)),
        "ctypes_call": us(lambda: lib.dndm_update_f32(*args1, stream)),
        "build_launch": us(lambda: build.launch(
            "dndm_update", lib.dndm_update_f32, dev, *args1)),
        "launch_floor": us(launch_floor("dndm_update", lg, mask, gum, x,
                                        tau, d["t"])),
    }
    d = decode_inputs(g, 8, 128, 28)
    lg, mask, gum = d["logits"], d["mask"], d["gumbel"]
    tok = lg.new_empty((8, 128), dtype=torch.int32)
    score = torch.empty_like(tok, dtype=torch.float32)
    args3 = (lg.data_ptr(), gum.data_ptr(), mask.data_ptr(), tok.data_ptr(),
             score.data_ptr(), 8 * 128, 28, 1.0)
    out["decode_scores 8x128x28"] = {
        "wrapper": us(decode_call(k3_ops.decode_scores, "decode_scores",
                                  d)),
        "checks": us(lambda: k3_ops._check(lg, mask, gum)),
        "alloc": us(lambda: (
            lambda t: (t, torch.empty_like(t, dtype=torch.float32)))(
                lg.new_empty((8, 128), dtype=torch.int32))),
        "ctypes_call": us(lambda: lib.decode_scores_f32(*args3, stream)),
        "build_launch": us(lambda: build.launch(
            "decode_scores", lib.decode_scores_f32, dev, *args3)),
        "launch_floor": us(launch_floor("decode_scores", lg, mask, gum)),
    }
    return out


REGIME_KS = (28, 128, 256, 512, 768, 1024, 1536, 2048, 4096, 8192)
REGIME_ROWS = (1024, 2048)


# the launcher's choice of the aligned-noise instantiation (row_select.cuh)
NOISE_CASE_RE = r"return \(g & 15\) == 0 \? kNoiseAligned : kNoiseShifted;"


def decode_variants() -> dict:
    """The two decode sources and row_select.cuh compiled three more
    times into build/, loaded with their f32 and bf16 entry points:
    "warp" and "block" with kBlockMinK set so that every K takes the warp
    regime, or the block regime; "shifted" the block regime with noise
    always taken by the shifted instantiation (the phase read at run
    time), aligned or not."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    variants = {"warp": (1 << 30, False), "block": (1, False),
                "shifted": (1, True)}

    def compile_variant(name: str, spec: tuple[int, bool]):
        min_k, shifted = spec
        d = build.BUILD_DIR / f"regime-{name}"
        d.mkdir(parents=True, exist_ok=True)
        for f in ("dndm_update.cu", "decode_scores.cu"):
            (d / f).write_text((build.CSRC / f).read_text())
        text = re.sub(BLOCK_MIN_K_RE, f"constexpr int kBlockMinK = {min_k};",
                      ROW_SELECT.read_text())
        if shifted:
            text, n = re.subn(NOISE_CASE_RE, "return kNoiseShifted;", text)
            assert n == 1, "the launcher's noise case is not found"
        (d / "row_select.cuh").write_text(text)
        out = d / "decode.so"
        build._compile([d / "dndm_update.cu", d / "decode_scores.cu"], out)
        return out

    with ThreadPoolExecutor(len(variants)) as pool:
        paths = dict(zip(variants, pool.map(compile_variant, variants,
                                            variants.values())))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for entry in ("dndm_update", "decode_scores"):
            for dt in ("f32", "bf16"):
                fn = getattr(lib, f"{entry}_{dt}")
                fn.argtypes = build.ARGTYPES[f"{entry}_{dt}"]
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def variant_calls(libs: dict, d: dict, dt: str) -> dict:
    """Each variant's two entry points on the inputs ``d`` (rows in one
    batch), with arguments computed once; launched once each."""
    rows, K = d["logits"].shape[1:]
    stream = torch.cuda.current_stream().cuda_stream
    o = d["x"].new_empty((2, rows))
    ptrs = (d["logits"].data_ptr(), d["gumbel"].data_ptr(),
            d["mask"].data_ptr())
    args = {"dndm_update": (*ptrs, d["x"].data_ptr(), d["tau"].data_ptr(),
                            o.data_ptr(), rows, K, d["t"], 1, 1.0, stream),
            "decode_scores": (*ptrs, o.data_ptr(), o.data_ptr() + 4 * rows,
                              rows, K, 1.0, stream)}
    calls = {}
    for name, lib in libs.items():
        for entry, a in args.items():
            fn = getattr(lib, f"{entry}_{dt}")
            build.check(fn(*a), entry)
            calls[name, entry] = (lambda f, a: lambda: f(*a))(fn, a)
    calls["out"] = o
    return calls


def regime_sweep(g, libs: dict) -> dict:
    """Device ms of both decode kernels in each regime at K in REGIME_KS
    and the paths' row counts, f32 with Gumbel noise, in the order warp,
    block, block, warp."""
    out = []
    for rows in REGIME_ROWS:
        for K in REGIME_KS:
            calls = variant_calls(libs, decode_inputs(g, 1, rows, K), "f32")
            row = {"rows": rows, "K": K,
                   "bound_ms": (rows * K * 8 + K * 4) / HBM_BYTES_PER_S * 1e3}
            for entry in ("dndm_update", "decode_scores"):
                w1, b1, b2, w2 = (
                    device_time_ms(calls[v, entry], 50)[0]
                    for v in ("warp", "block", "block", "warp"))
                row[entry] = {"warp_ms": statistics.median([w1, w2]),
                              "block_ms": statistics.median([b1, b2])}
            out.append(row)
    return {"block_min_k": BLOCK_MIN_K, "sweep": out}


def noise_phase_check(g, libs: dict) -> dict:
    """Device ms of the block regime's aligned-noise instantiation (as
    shipped, "block") and of its shifted one ("shifted") at (4, 256,
    32000) on Gumbel noise aligned with the logits, f32 and bf16 logits,
    in the order block, shifted, shifted, block, three times: every
    reading is kept, so the spread shows beside the difference.  The two
    builds must agree on every token and score."""
    d = decode_inputs(g, 4, 256, 32000)
    d = {**d, "logits": d["logits"].reshape(1, 1024, 32000),
         "gumbel": d["gumbel"].reshape(1, 1024, 32000),
         "x": d["x"].reshape(1, 1024), "tau": d["tau"].reshape(1, 1024)}
    out = {}
    for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        dd = {**d, "logits": d["logits"].to(dtype)}
        calls = variant_calls(libs, dd, dt)
        for entry in ("dndm_update", "decode_scores"):
            got = {}
            for v in ("block", "shifted"):
                calls[v, entry]()
                got[v] = calls["out"].clone()
            if not torch.equal(got["block"], got["shifted"]):
                raise AssertionError(f"{entry} {dt}: the builds disagree")
            r = {"block_ms": [], "shifted_ms": []}
            for _ in range(3):
                for v in ("block", "shifted", "shifted", "block"):
                    r[f"{v}_ms"].append(
                        device_time_ms(calls[v, entry], 50)[0])
            out[f"{entry} {dt}"] = r
    return out


# one process of --measure-xlstm: argv = the tree's src, batch, tokens,
# calls; prints the calls' wall times (ms), each to its synchronize
XLSTM_CALL_TIMER = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
import repro_torch.configs as configs_lib
from repro_torch.models.model import Model
B, S, n = (int(a) for a in sys.argv[2:5])
cfg = configs_lib.get("xlstm-350m")
fn = Model(cfg, device="cuda", seed=0).denoise_fn()
g = torch.Generator(device="cuda").manual_seed(1)
tok = torch.randint(0, cfg.vocab_size - 1, (B, S), generator=g,
                    device="cuda", dtype=torch.int32)
t = torch.rand(B, generator=g, device="cuda")
ms = []
with torch.inference_mode():
    for _ in range(1 + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(tok, t, None)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
print(json.dumps({"ms": ms[1:]}))
"""


def measure_xlstm(parent: Path | None) -> int:
    """--measure-xlstm: xlstm-350m's network call timed in a fresh process
    per tree (this checkout, and with ``parent`` that tree, in the order
    parent, change, change, parent); the medians per process and per
    tree."""
    print(gpu_name_and_power(), flush=True)
    order = ([("parent", parent), ("change", ROOT), ("change", ROOT),
              ("parent", parent)] if parent is not None
             else [("change", ROOT)])
    runs: dict[str, list] = {}
    for name, tree in order:
        r = subprocess.run(
            [sys.executable, "-c", XLSTM_CALL_TIMER, str(tree / "src"),
             str(XLSTM_BATCH), str(XLSTM_LEN), str(XLSTM_AB_CALLS)],
            capture_output=True, text=True, cwd=tree)
        if r.returncode:
            raise RuntimeError(f"{name} ({tree}): {r.stderr[-2000:]}")
        ms = json.loads(r.stdout.strip().splitlines()[-1])["ms"]
        runs.setdefault(name, []).append(ms)
        print(f"xlstm network call, {name}: median "
              f"{statistics.median(ms):.2f} ms of {len(ms)}", flush=True)
    print(json.dumps({"xlstm_network_call_ms": {
        name: {"median": statistics.median(sum(r, [])),
               "process_medians": [statistics.median(m) for m in r],
               "ms": r} for name, r in runs.items()}}), flush=True)
    return 0


def measure_decode(parent: Path | None) -> int:
    """--measure-decode: the host-time pieces, the noise-phase check, the
    regime sweep and, with --parent DIR, the parent's decode wrappers
    beside these."""
    print(gpu_name_and_power(), flush=True)
    lib = build.library()
    print(f"kernels: {lib.path.name} in {lib.seconds:.2f} s", flush=True)
    for line in ptxas_summary(lib.log):
        print("  " + line)
    g = torch.Generator(device="cuda").manual_seed(0)
    print(json.dumps({"host_pieces_us": host_pieces(g)}), flush=True)
    libs = decode_variants()
    print(json.dumps({"noise_phase": noise_phase_check(g, libs)}),
          flush=True)
    print(json.dumps({"regime_sweep": regime_sweep(g, libs)}), flush=True)
    if parent is not None:
        print(json.dumps({"parent_vs_change": compare_parent(g, parent)}),
              flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    if "--measure-telemetry" in sys.argv:
        return measure_telemetry()
    parent = (Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
              if "--parent" in sys.argv else None)
    if "--measure-decode" in sys.argv:
        return measure_decode(parent)
    if "--measure-xlstm" in sys.argv:
        return measure_xlstm(parent)
    # 1. the card
    print(gpu_name_and_power(), flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 products must not run in TF32")
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          "matmul.allow_tf32=False", flush=True)

    phase_s, t_lap = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - t_lap[0]
        t_lap[0] = now

    # 2. build
    t0 = time.perf_counter()
    lib = build.library()
    print(f"kernels: {lib.path.name} ({'built' if lib.built else 'loaded'}"
          f" by nvcc for sm_90a from {len(build.sources())} sources) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in ptxas_summary(lib.log):
        print("  " + line)
    lap("build")

    g = torch.Generator(device="cuda").manual_seed(0)
    # 3. dndm_update vs plain
    n1, k1_err = check_dndm_update(g)
    print(f"dndm_update: {n1} cases bitwise equal to plain", flush=True)
    # 4. flash_attention vs plain
    n2, k2_err = check_flash_attention(g)
    print(f"flash_attention: {n2} cases within tolerance (f32 1e-4, bf16 "
          f"2e-2); max err at (8,256,12,64) f32 {k2_err:.3g}", flush=True)
    # 4b. flash_decode vs plain
    n2d, k2d_err = check_flash_decode(g)
    print(f"flash_decode: {n2d} cases within tolerance (f32 1e-4, bf16 "
          f"2e-2 scaled by min(1, max |plain|)); max f32 err "
          f"{k2d_err:.3g}", flush=True)
    # 5. decode_scores vs plain
    n3, k3_err = check_decode_scores(g)
    print(f"decode_scores: {n3} cases, tokens bitwise equal to plain, "
          f"scores within {K3_TOL}; max score err {k3_err:.3g}", flush=True)
    # 5b. ssd_scan vs plain
    k4_check = check_ssd_scan(g)
    print(f"ssd_scan: {k4_check['cases']} cases within tolerance (sweep f32 "
          f"3e-5, bf16 5e-2; full width {SSD_FULL_TOL}); max err sweep f32 "
          f"{k4_check['max_err_f32']:.3g}, bf16 "
          f"{k4_check['max_err_bf16']:.3g}; full width "
          f"{k4_check['full']}", flush=True)
    dev_kernels = device_kernel_lists(g)
    for name, ks in dev_kernels.items():
        print(f"{name}: {len(ks)} CUDA kernel(s) per call: "
              + "; ".join(f"{d['kernel']} x{d['launches']:g} "
                          f"{d['us']:.1f} us" for d in ks), flush=True)
    lap("kernel_checks")

    # 8e. the xlstm path, first: its profiles need a profiler that has not
    # yet traced the other paths (a late one dropped kernel events)
    card = gpu_name_and_power()
    xl_line, xl_counts, xl_model = xlstm_phase(card)
    lap("xlstm_path")
    # 8f. decode on the card: xlstm-350m, then the ring-wrap case (zamba2
    # and mixtral decode in their phases, while their models are loaded)
    decode = {"xlstm-350m": decode_check("xlstm-350m", xl_model)}
    del xl_model
    torch.cuda.empty_cache()
    decode["ring"] = ring_decode()
    lap("decode_xlstm_and_ring")

    # 6. the main path
    model, sched, done, drain_s, counts = main_path()
    stats = check_main_path(model, sched, done, counts)
    logits_err = check_denoiser(model, MAIN_LEN)
    untrained_ll = mean_log_likelihood(done, model.cfg.vocab_size - 1)
    print(f"main path: {counts}; full-width logits kernel vs einsum max err "
          f"{logits_err:.3g}", flush=True)
    # 10. (run here, while the model is loaded) the path under a profiler
    main_prof = profile_run(sched.engine, "dndm", MAIN_BATCH, MAIN_LEN)
    lap("text8_path")
    # 11. the text8 path served continuously, and drained, same tape
    cont_text8 = continuous_vs_drain(model, [("dndm", None)] * MAIN_REQUESTS,
                                     MAIN_LEN, MAIN_BATCH, MAIN_T)
    print(f"continuous text8: {cont_text8['continuous']['total_calls']} "
          f"calls against drain's {cont_text8['drain']['total_calls']}",
          flush=True)
    del sched
    lap("text8_continuous")

    # 7. the ranked path
    mt_model, mt_sched, mt_done, mt_drain_s, mt_counts = mt_path()
    mt_stats = check_mt_path(mt_model, mt_sched, mt_done, mt_counts)
    mt_logits_err = check_denoiser(mt_model, MT_LEN, prefix_len=56)
    print(f"ranked path: {mt_counts}; NFE {mt_stats['nfe']}; prefixed "
          f"full-width logits kernel vs einsum max err "
          f"{mt_logits_err:.3g}", flush=True)

    # 10. the ranked path's samplers under a profiler
    mt_prof = {m: profile_run(mt_sched.engine, m, MT_BATCH, MT_LEN,
                              prefix_len=56) for m, _ in MT_METHODS}

    # 8. every registered method
    sweep = registry_sweep(mt_model)
    print(f"registry sweep: {len(sweep)} methods; NFE "
          f"{ {k: v['nfe'] for k, v in sweep.items()} }", flush=True)
    lap("ranked_path_and_sweep")
    # 12. the ranked path served continuously, and drained, same tape
    cont_ranked = continuous_vs_drain(mt_model, ranked_tape(),
                                      MT_LEN, MT_BATCH, MT_T)
    print(f"continuous ranked: {cont_ranked['continuous']['total_calls']} "
          f"calls against drain's {cont_ranked['drain']['total_calls']}",
          flush=True)
    lap("ranked_continuous")
    # 14. telemetry off and on, same process: the ranked tape drained and
    # the text8 tape served continuously
    telemetry = telemetry_phase(telemetry_paths(model, mt_model))
    for name in ("ranked_drain", "text8_continuous"):
        t = telemetry[name]
        print(f"telemetry {name}: ms per call off "
              f"{t['mean_ms']['off']:.3f} on {t['mean_ms']['on']:.3f} "
              f"(pairs {t['ms_per_network_call']}); busy "
              f"{t['device_busy_share']}; syncs per call "
              f"{t['syncs_per_call']}", flush=True)
    del model, mt_model, mt_sched
    torch.cuda.empty_cache()
    lap("telemetry")
    # 13. every registered method served continuously vs its solo run
    csweep = continuous_sweep()
    print(f"continuous sweep: {csweep['requests']} requests of 12 methods "
          f"bitwise equal to their solo runs in {csweep['total_calls']} "
          "calls", flush=True)
    lap("continuous_sweep")

    # 15. training: full-width dndm-text8, its checkpoint served on the
    # kernels; a few prefixed dndm-mt steps; full-width zamba2 through the
    # plain chunked scan
    train, z_model = training_phase(untrained_ll, card)
    for name, r in train.items():
        print(f"training {name} ({card}): {r['ms_per_step']:.2f} ms per "
              f"step (median of "
              f"{r['steps'] - TRAIN_WARMUP - r['profile']['steps']}), "
              f"{r['tokens_per_s']:.0f} tokens/s, {r['tflop_per_s']:.2f} "
              f"TFLOP/s ({100 * r['f32_peak_share']:.1f}% of the f32 "
              f"peak), peak memory {r['max_memory_allocated_gb']:.2f} GB, "
              f"loss first 5 {r['loss_first5_mean']:.4f} last 5 "
              f"{r['loss_last5_mean']:.4f}; profiled: device "
              f"{r['profile']['device_ms_per_step']:.2f} ms per step, GEMMs "
              f"{r['profile']['gemm_ms_per_step']:.2f}, busy "
              f"{100 * r['profile']['device_busy_share']:.1f}%"
              + (f"; reduced: {r['reduced']}" if "reduced" in r else ""),
              flush=True)
    zm = train["zamba2"]["memory_gb"]
    sfb = zm["saved_for_backward"]
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in sfb["gb_by_kind"].items())
    print(f"training zamba2 memory ({card}): peak {zm['peak']:.2f} GB = "
          f"parameters and moments "
          f"{zm['params_and_moments']:.2f} + saved for the backward "
          f"{sfb['gb']:.2f} ({kinds}; "
          f"{sfb['gb_per_mamba2_direction']:.3f} per Mamba-2 direction) + "
          f"the rest {zm['rest']:.2f}; "
          f"{zm['card_margin']:.2f} GB of the card left", flush=True)
    sv = train["text8"]["served"]
    print(f"training: trained text8 served {sv['launches']}; mean "
          f"log-likelihood trained {sv['log_likelihood_trained']:.3f}, "
          f"untrained {sv['log_likelihood_untrained_seed0']:.3f}",
          flush=True)
    lap("training")

    # 8b. the zamba2 path, on the weights phase 15's zamba2 leg trained,
    # served on the kernels
    served = Model(z_model.cfg.replace(attn_impl="pallas"), device="cuda",
                   seed=1)
    served.load_state_dict(z_model.state_dict())
    del z_model
    torch.cuda.empty_cache()
    z_model, z_sched, z_done, z_drain_s, z_counts = main_path(
        "zamba2-2.7b", ZAMBA_REQUESTS, ZAMBA_LEN, ZAMBA_BATCH, ZAMBA_T,
        model=served)
    del served
    z_stats = check_main_path(z_model, z_sched, z_done, z_counts,
                              ZAMBA_REQUESTS, ZAMBA_LEN)
    lap("zamba2_path")
    print(f"zamba2 path: {z_counts}; NFE {z_stats['timed_nfe']}", flush=True)
    z_logits_err = check_denoiser(z_model, ZAMBA_LEN, batch=ZAMBA_BATCH)
    print(f"zamba2 full-width logits kernels vs plain max err "
          f"{z_logits_err:.3g}", flush=True)
    z_prof = profile_run(GenerationEngine(z_model, EngineConfig(
        method="dndm", steps=ZAMBA_PROFILE_T, noise_kind="absorbing",
        x0_mode="sample"), device="cuda"), "dndm", ZAMBA_BATCH, ZAMBA_LEN)
    lap("zamba2_logits_and_profile")
    # 8f. decode on the card, while the model is loaded
    z_decode = decode_check("zamba2-2.7b", z_model)
    del z_model, z_sched
    torch.cuda.empty_cache()
    lap("decode_zamba2")

    # 8c. the mixtral path (the zamba2 model is freed: this one takes
    # 24.4 GB)
    mx_line, mx_counts, mx_model = mixtral_phase(g, card)
    lap("mixtral_path")
    # 16. the multi-device code on the one card, on the mixtral model
    mesh = mesh_phase(mx_model, card)
    del mx_model
    torch.cuda.empty_cache()
    lap("mesh")
    mesh["seconds"] = phase_s["mesh"]
    print(f"mesh ({card}): {mesh['backend']} world size 1, (1, 1) mesh; "
          f"mixtral shard_map bitwise the global dispatch (collectives "
          f"{mesh['mixtral']['collectives']}, forward ms "
          f"{mesh['mixtral']['forward_ms']}); DTensor train steps at the "
          f"f32 bar (params max diff "
          f"{mesh['train']['params_max_abs_diff']:.3g}, bitwise "
          f"{mesh['train']['params_bitwise']}) in "
          f"{mesh['seconds']:.1f} s", flush=True)
    # 8d. every config, reduced, through one dndm batch
    zoo = zoo_sweep()
    print(f"zoo sweep: {len(zoo)} configs; NFE "
          f"{ {k: v['nfe'] for k, v in zoo.items()} }", flush=True)
    lap("zoo_sweep")
    decode.update({"zamba2-2.7b": z_decode,
                   "mixtral-8x7b": mx_line["decode"]})

    def zoo_launches(name: str) -> int:
        return sum(r["launches"][name] for r in zoo.values())

    # 9. times
    t = measure(g)
    tz = measure_zamba(g)
    tfd = measure_flash_decode(g)
    t50304, _ = dndm_update_times(g, XLSTM_BATCH, XLSTM_LEN, 50304, XLSTM_T)
    lap("kernel_times")
    kernels = [
        {"name": "dndm_update", "route": "cuda",
         "source": "src/repro_torch/csrc/dndm_update.cu",
         "replaces": "src/repro/kernels/dndm_update/kernel.py:34",
         "launches": counts["dndm_update"], "max_abs_err": float(k1_err),
         "launches_continuous": {
             "text8": cont_text8["continuous"]["launches"]["dndm_update"],
             "ranked": cont_ranked["continuous"]["launches"]["dndm_update"],
             "sweep": csweep["launches"]["dndm_update"]},
         "launches_training": sv["launches"]["dndm_update"],
         "launches_training_steps": {
             k: r["launches"]["dndm_update"] for k, r in train.items()},
         "launches_zamba2_trained": z_counts["dndm_update"],
         "launches_mixtral": mx_counts["dndm_update"],
         "launches_zoo": zoo_launches("dndm_update"),
         "launches_xlstm": xl_counts["dndm_update"],
         **t["dndm_update"], "at_k32000": tz["dndm_update"],
         "at_k50304": t50304},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
         "launches": counts["flash_attention"], "max_abs_err": k2_err,
         "launches_continuous": {
             "text8": cont_text8["continuous"]["launches"]["flash_attention"],
             "ranked":
             cont_ranked["continuous"]["launches"]["flash_attention"]},
         "launches_training": sv["launches"]["flash_attention"],
         "launches_training_steps": {
             k: r["launches"]["flash_attention"] for k, r in train.items()},
         "launches_zamba2_trained": z_counts["flash_attention"],
         "launches_mixtral": mx_counts["flash_attention"],
         "launches_zoo": zoo_launches("flash_attention"),
         **t["flash_attention"], "at_mixtral": mx_line["flash_attention"]},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
         "launches": sum(r["launches"]["flash_decode"]
                         for r in decode.values()),
         "launches_by_model": {k: r["launches"]["flash_decode"]
                               for k, r in decode.items()},
         "max_abs_err": k2d_err, **tfd["path"],
         "at_long_ring": tfd["long_ring"]},
        {"name": "decode_scores", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_scores.cu",
         "replaces": "src/repro/kernels/decode_scores/kernel.py:35",
         "launches": mt_counts["decode_scores"], "max_abs_err": k3_err,
         "launches_continuous": {
             "text8": cont_text8["continuous"]["launches"]["decode_scores"],
             "ranked": cont_ranked["continuous"]["launches"]["decode_scores"],
             "sweep": csweep["launches"]["decode_scores"]},
         **t["decode_scores"],
         "at_k32000": {**tz["decode_scores"],
                       "launches": z_counts["decode_scores"]}},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/kernel.py:26",
         "launches": z_counts["ssd_scan"],
         "launches_training_steps": {
             k: r["launches"]["ssd_scan"] for k, r in train.items()},
         "launches_zoo": zoo_launches("ssd_scan"),
         "max_abs_err": max(k4_check["max_err_f32"],
                            k4_check["full"]["vs_chunked"]),
         **tz["ssd_scan"]},
    ]
    main_line = {
        "main_path": "dndm-text8 full width, dndm T=1000, absorbing, sample",
        "requests": len(done), "tokens_per_request": MAIN_LEN,
        "batches": stats["batches"], "nfe_timed": stats["timed_nfe"],
        "nfe_warmup": stats["warmup_nfe"], "nfe_total": stats["total_nfe"],
        "drain_s": drain_s, "timed_wall_s": stats["timed_wall_s"],
        "req_per_s": len(done) / drain_s,
        "ms_per_network_call": 1e3 * stats["timed_wall_s"]
        / stats["timed_nfe"],
        "compile_seconds": max(r.compile_seconds for r in done.values()),
        "logits_max_err_vs_einsum": logits_err,
    }
    main_prof["device_busy_share"] = (main_prof["device_ms_per_call"]
                                      / main_line["ms_per_network_call"])
    main_line["profile"] = main_prof
    mt_timed = sum(mt_stats["timed_wall_s"].values())
    mt_line = {
        "ranked_path": "dndm-mt full width, dndm_topk + dndm_c_topk "
                       "T=1000, absorbing, sample, source prefixes",
        "requests": len(mt_done), "tokens_per_request": MT_LEN,
        "prefix_len_min": mt_stats["prefix_len_min"],
        "prefix_len_max": mt_stats["prefix_len_max"],
        "nfe_timed": mt_stats["nfe"], "nfe_total": mt_stats["total_nfe"],
        "launches": mt_counts, "drain_s": mt_drain_s,
        "timed_wall_s": mt_stats["timed_wall_s"],
        "req_per_s": len(mt_done) / mt_drain_s,
        "ms_per_network_call": {
            m: 1e3 * mt_stats["timed_wall_s"][m] / mt_stats["nfe"][m]
            for m in mt_stats["nfe"]},
        "ms_per_network_call_all": 1e3 * mt_timed
        / sum(mt_stats["nfe"].values()),
        "logits_max_err_vs_einsum": mt_logits_err,
        "flash_attention_time": t["flash_attention_ranked"],
    }
    for m, prof in mt_prof.items():
        prof["device_busy_share"] = (prof["device_ms_per_call"]
                                     / mt_line["ms_per_network_call"][m])
    mt_line["profile"] = mt_prof
    z_line = {
        "zamba2_path": "zamba2-2.7b full width, the weights of phase 15's "
                       "zamba2 leg, dndm T=50, absorbing, sample",
        "requests": len(z_done), "tokens_per_request": ZAMBA_LEN,
        "batches": z_stats["batches"], "nfe_timed": z_stats["timed_nfe"],
        "nfe_thm_d1": ZAMBA_T * (1 - (1 - 1 / ZAMBA_T) ** ZAMBA_LEN),
        "nfe_warmup": z_stats["warmup_nfe"],
        "nfe_total": z_stats["total_nfe"], "launches": z_counts,
        "drain_s": z_drain_s, "timed_wall_s": z_stats["timed_wall_s"],
        "req_per_s": len(z_done) / z_drain_s,
        "ms_per_network_call": 1e3 * z_stats["timed_wall_s"]
        / z_stats["timed_nfe"],
        "compile_seconds": max(r.compile_seconds for r in z_done.values()),
        "logits_max_err_vs_plain": z_logits_err,
        "ssd_scan_check": k4_check, "kernel_times": tz,
    }
    z_prof["device_busy_share"] = (z_prof["device_ms_per_call"]
                                   / z_line["ms_per_network_call"])
    z_line["profile"] = z_prof
    print(json.dumps(main_line))
    print(json.dumps(mt_line))
    print(json.dumps(z_line))
    print(json.dumps(mx_line))
    print(json.dumps(xl_line))
    print(json.dumps({"decode": {"card": card, **decode}}))
    print(json.dumps({"zoo_sweep": zoo}))
    print(json.dumps({"registry_sweep": sweep}))
    card = gpu_name_and_power()
    print(json.dumps({"continuous_text8": {
        "path": "dndm-text8 full width, dndm T=1000, 16 x 256 tokens, "
                "max_batch 8, shared_tau=False", "card": card,
        **cont_text8}}))
    print(json.dumps({"continuous_ranked": {
        "path": "dndm-mt full width, 8 dndm_topk + 8 dndm_c_topk T=1000, "
                "128 tokens, prefixes 48 or 64, max_batch 8, "
                "shared_tau=False", "card": card, **cont_ranked}}))
    print(json.dumps({"continuous_sweep": csweep}))
    print(json.dumps({"telemetry": {
        "paths": "ranked tape drained (dndm-mt full width, T=1000, "
                 "shared_tau=False) and text8 tape served continuously "
                 "(dndm-text8 full width, T=1000, shared_tau=False)",
        "card": card, **telemetry}}))
    print(json.dumps({"training": train}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"device_kernels_per_call": dev_kernels}))
    print(json.dumps({"phase_seconds": phase_s}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
