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
     (S = 179, 184) included;
  5. decode_scores kernel vs its plain version, K in {28, 32, 33, 100,
     257, 1000}, the ranked path's (8, 128, 28) and the wide shapes of 3
     ((4, 256, 32000), (2, 16, 50257), the threshold - 1, at it, + 1),
     f32 and bf16, with and without Gumbel noise, temperature 1 and 0.7,
     mask -1e9 at the last id: tokens bitwise equal, scores within
     atol/rtol 1e-5 (the kernel's online logsumexp sums in another
     order);
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
     heads of 64, chunk 128), random weights from seed 0, f32,
     attn_impl="pallas"; a GenerationEngine (method "dndm", T = 50,
     absorbing noise, x0_mode "sample") behind a BatchScheduler
     (max_batch 4, bucket_len 256) drains 4 requests of 256 tokens.
     Checks as in 6, with ssd_scan launches = 90 x total NFE,
     flash_attention = 9 x total NFE, dndm_update = total NFE and
     decode_scores = 0; then the full-width logits of one call through
     the kernels vs the plain route (ref.ssd_chunked and einsum
     attention); then one profiled sampler run;
  9. kernel times at the paths' shapes beside their bounds (bytes or f32
     flops on the CUDA cores; for flash_attention and ssd_scan also the
     tensor-core bound, their flops at a third of the TF32 rate), the
     plain versions and, for attention, scaled_dot_product_attention (a
     yardstick only; the port never calls it), flash_attention also at
     the ranked path's shape (8, 184, 8, 64), decode_scores also at
     (4, 256, 32000).  Two readings: ``ms`` launch-paced, the host
     enqueueing while the device runs (what a path pays per call), and
     ``device_ms`` with each timed run queued behind a busy-wait kernel
     (the kernels' own time), with ``host_ms`` the host's time per call
     and, for the decode kernels at K = 28, ``launch_floor_host_ms``: a
     bare allocation and a direct ctypes call of the C entry point;
 10. one more sampler run of each path's batch shape (dndm on
     dndm-text8; dndm_topk and dndm_c_topk on dndm-mt with a 56-token
     prefix) under torch.profiler: device kernel time and kernel launches
     per network call, the top kernels, and the device busy share (kernel
     time over the path's timed ms per network call).

The last lines are JSON: the main path, the kernels, and
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
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.configs as configs_lib  # noqa: E402
from repro_torch.core.decode import gumbel_noise  # noqa: E402
from repro_torch.core.samplers import loop, registry  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_scores import ops as k3_ops  # noqa: E402
from repro_torch.kernels.decode_scores import ref as k3_ref  # noqa: E402
from repro_torch.kernels.dndm_update import ops as k1_ops  # noqa: E402
from repro_torch.kernels.dndm_update import ref as k1_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k2_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as k2_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as k4_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as k4_ref  # noqa: E402
from repro_torch.models import mamba2 as mamba2_lib  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import (BatchScheduler, EngineConfig,  # noqa: E402
                                 GenerationEngine)

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
               (8, 179, 8, 8, 64, False, 0)])     # prefixed lengths
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

MAIN_REQUESTS, MAIN_LEN, MAIN_BATCH, MAIN_T = 16, 256, 8, 1000

K3_SHAPES = ([(3, 40, K) for K in (28, 32, 33, 100, 257, 1000)]
             + [(8, 128, 28)] + DECODE_WIDE)
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

SWEEP_B, SWEEP_N, SWEEP_T, SWEEP_STRIDE = 4, 64, 50, 2
DECODE_TOKENS_METHODS = frozenset({
    "dndm_topk", "dndm_topk_static", "dndm_c", "dndm_c_topk", "rdm",
    "rdm_k", "mask_predict", "ddim"})
FUSED_METHODS = frozenset({"dndm", "dndm2", "dndm_static"})


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
                             r"|flash_attention_kernel|ssd_state_kernel"
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


def check_decode_scores(g) -> tuple[int, float]:
    """Kernel vs plain on the card: tokens bitwise, scores within
    K3_TOL; returns (cases, max |score difference|)."""
    cases, max_err = 0, 0.0
    for B, N, K in K3_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            logits = torch.randn(B, N, K, generator=g, device="cuda").to(dt)
            mask = torch.zeros(K, device="cuda")
            mask[K - 1] = -1e9
            noise = gumbel_noise(g, (B, N, K), "cuda")
            for gum in (None, noise):
                for temp in (1.0, 0.7):
                    kw = dict(mask=mask, gumbel=gum, temperature=temp)
                    tok, score = k3_ops.decode_scores(logits, **kw)
                    ptok, pscore = k3_ref.decode_scores(logits, **kw)
                    torch.cuda.synchronize()
                    err = float((score - pscore).abs().max())
                    max_err = max(max_err, err)
                    where = (f"at {(B, N, K)} {dt} gumbel={gum is not None} "
                             f"temp={temp}")
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
           "decode_scores": k3_ops.decode_scores,
           "ssd_scan": k4_ops.ssd_scan}


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts(engine) -> dict:
    return {**{k: fn.launches for k, fn in KERNELS.items()},
            "network_calls": engine.network_calls}


def main_path(arch: str = "dndm-text8", n_req: int = MAIN_REQUESTS,
              n_len: int = MAIN_LEN, batch: int = MAIN_BATCH,
              steps: int = MAIN_T):
    """Serve ``n_req`` requests of ``arch`` with dndm through the port's
    entry points; returns the model, the scheduler, the finished
    requests, the drain time and the launch counts."""
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
    want["flash_attention"] = sum(k in ("attn", "swa", "shared_attn")
                                  for k in pattern)
    want["ssd_scan"] = 2 * pattern.count("mamba2")
    return want


def check_main_path(model, sched, done, counts, n_req: int = MAIN_REQUESTS,
                    n_len: int = MAIN_LEN) -> dict:
    engine = sched.engine
    cfg = model.cfg
    mask_id = engine.noise.mask_id
    if len(done) != n_req:
        raise AssertionError(f"{len(done)} of {n_req} requests done")
    batches: dict[int, list] = {}
    for r in done.values():
        if r.result.shape != (n_len,):
            raise AssertionError(f"request {r.rid}: {r.result.shape} tokens")
        if (r.result == mask_id).any():
            raise AssertionError(f"request {r.rid}: [MASK] left")
        if not ((r.result >= 0) & (r.result < cfg.vocab_size)).all():
            raise AssertionError(f"request {r.rid}: token out of vocab")
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
    (einsum attention, and ref.ssd_chunked for Mamba-2 blocks), same
    weights, at the repo's logits bar (atol 3e-4, rtol 3e-3,
    tests/test_models.py)."""
    plain = Model(model.cfg.replace(attn_impl="einsum"), device="cuda",
                  seed=0)
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


def check_mt_path(model, sched, done, counts) -> dict:
    engine = sched.engine
    cfg = model.cfg
    mask_id = engine.noise.mask_id
    n_req = sum(n for _, n in MT_METHODS)
    if len(done) != n_req:
        raise AssertionError(f"{len(done)} of {n_req} requests done")
    batches: dict[int, list] = {}
    for r in done.values():
        if r.result.shape != (MT_LEN,):
            raise AssertionError(f"request {r.rid}: {r.result.shape} tokens")
        if (r.result == mask_id).any():
            raise AssertionError(f"request {r.rid}: [MASK] left")
        if not ((r.result >= 0) & (r.result < cfg.vocab_size)).all():
            raise AssertionError(f"request {r.rid}: token out of vocab")
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
    logits = torch.randn(B, S, K, generator=g, device="cuda")
    x = torch.full((B, S), K - 1, dtype=torch.int32, device="cuda")
    tau = torch.randint(1, ZAMBA_T + 1, (1, S), generator=g, device="cuda",
                        dtype=torch.int32).expand(B, S).contiguous()
    mask = torch.zeros(K, device="cuda")
    mask[K - 1] = -1e9
    noise = gumbel_noise(g, (B, S, K), "cuda")
    t = int(tau[0, 0])
    kw = dict(mask=mask, gumbel=noise, version=1, temperature=1.0)
    k1 = lambda: k1_ops.dndm_update(logits, x, tau, t, **kw)  # noqa: E731
    k1p = lambda: k1_ref.dndm_update(logits, x, tau, t, **kw)  # noqa: E731
    p5, m5, m6, p6 = (time_ms(f, 50) for f in (k1p, k1, k1, k1p))
    d5, d6 = (device_time_ms(k1, 50) for _ in range(2))
    out["dndm_update"] = {
        "shape": [B, S, K], "ms": statistics.median([m5, m6]),
        **device_fields(d5, d6),
        "plain_ms": statistics.median([p5, p6]),
        **bound(B * S * K * 8 + K * 4 + B * S * 12, B * S * K * 3),
        "library_ms": None}

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
    if "--measure-decode" in sys.argv:
        return measure_decode(
            Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
            if "--parent" in sys.argv else None)
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

    # 6. the main path
    model, sched, done, drain_s, counts = main_path()
    stats = check_main_path(model, sched, done, counts)
    logits_err = check_denoiser(model, MAIN_LEN)
    print(f"main path: {counts}; full-width logits kernel vs einsum max err "
          f"{logits_err:.3g}", flush=True)
    # 10. (run here, while the model is loaded) the path under a profiler
    main_prof = profile_run(sched.engine, "dndm", MAIN_BATCH, MAIN_LEN)
    del model, sched
    lap("text8_path")

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
    del mt_model, mt_sched
    lap("ranked_path_and_sweep")

    # 8b. the zamba2 path
    z_model, z_sched, z_done, z_drain_s, z_counts = main_path(
        "zamba2-2.7b", ZAMBA_REQUESTS, ZAMBA_LEN, ZAMBA_BATCH, ZAMBA_T)
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
    del z_model, z_sched
    torch.cuda.empty_cache()
    lap("zamba2_logits_and_profile")

    # 9. times
    t = measure(g)
    tz = measure_zamba(g)
    lap("kernel_times")
    kernels = [
        {"name": "dndm_update", "route": "cuda",
         "source": "src/repro_torch/csrc/dndm_update.cu",
         "replaces": "src/repro/kernels/dndm_update/kernel.py:34",
         "launches": counts["dndm_update"], "max_abs_err": float(k1_err),
         **t["dndm_update"], "at_k32000": tz["dndm_update"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
         "launches": counts["flash_attention"], "max_abs_err": k2_err,
         **t["flash_attention"]},
        {"name": "decode_scores", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_scores.cu",
         "replaces": "src/repro/kernels/decode_scores/kernel.py:35",
         "launches": mt_counts["decode_scores"], "max_abs_err": k3_err,
         **t["decode_scores"],
         "at_k32000": {**tz["decode_scores"],
                       "launches": z_counts["decode_scores"]}},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/kernel.py:26",
         "launches": z_counts["ssd_scan"],
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
        "zamba2_path": "zamba2-2.7b full width, dndm T=50, absorbing, "
                       "sample",
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
    print(json.dumps({"registry_sweep": sweep}))
    print(json.dumps({"device_kernels_per_call": dev_kernels}))
    print(json.dumps({"phase_seconds": phase_s}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
