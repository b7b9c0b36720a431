#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
     sm_90a (at first use, into ``build/``);
  3. dndm_update kernel vs its plain version: tokens bitwise equal;
  4. flash_attention kernel vs its plain version: f32 within atol/rtol
     1e-4 (the sums run in another order), bf16 within 2e-2 (one bf16
     rounding of the output, as tests/test_kernels.py allows);
  5. decode_scores kernel vs its plain version, K in {28, 32, 33, 100,
     257, 1000} and the ranked path's (8, 128, 28), f32 and bf16, with
     and without Gumbel noise, temperature 1 and 0.7, mask -1e9 at the
     last id: tokens bitwise equal, scores within atol/rtol 1e-5 (the
     kernel's online logsumexp sums in another order);
  5b. ssd_scan kernel vs its plain version (ref.ssd_chunked): the four
     shapes of tests/test_kernels.py::test_ssd_scan_sweep (ragged S = 33
     included) in f32 and bf16 at that test's bars (3e-5 f32, 5e-2
     bf16), then the zamba2 path's shape (B, S, H, P, N, L) = (4, 256,
     80, 64, 64, 128) and a ragged S = 200 in f32, where y is also held
     against the exact recurrence ref.ssd_sequential (bar SSD_FULL_TOL);
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
  9. kernel times at the paths' shapes beside their bounds, the plain
     versions and, for attention, scaled_dot_product_attention (a
     yardstick only; the port never calls it);
 10. one more sampler run of each path's batch shape (dndm on
     dndm-text8; dndm_topk and dndm_c_topk on dndm-mt with a 56-token
     prefix) under torch.profiler: device kernel time and kernel launches
     per network call, the top kernels, and the device busy share (kernel
     time over the path's timed ms per network call).

The last lines are JSON: the main path, the kernels, and
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
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

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

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

# H100 SXM data sheet (dense): HBM rate and f32 rate outside the tensor
# cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

K1_SHAPES = [(1, 16, 32), (3, 40, 100), (2, 64, 257), (1, 7, 1000),
             (8, 256, 28), (4, 256, 32000)]
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
               (2, 77, 4, 4, 80, False, 0)])      # hd 80, ragged S
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

MAIN_REQUESTS, MAIN_LEN, MAIN_BATCH, MAIN_T = 16, 256, 8, 1000

K3_SHAPES = [(3, 40, K) for K in (28, 32, 33, 100, 257, 1000)] + [(8, 128, 28)]
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
            base = re.search(r"(dndm_update_kernel|flash_attention_kernel"
                             r"|decode_scores_kernel|ssd_scan_kernel)",
                             mangled)
            dtype = "bf16" if "bfloat16" in mangled else "f32"
            hd = re.search(r"Li(\d+)EE", mangled)
            name = (f"{base.group(1) if base else mangled}<{dtype}"
                    f"{', hd=' + hd.group(1) if hd else ''}>")
        elif "spill stores" in line:
            spill = line.strip()
        elif "ptxas info    : Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = ""
    return out


def time_ms(fn, iters: int, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` launches,
    by CUDA events, after a warm-up."""
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


def bound(n_bytes: float, n_flops: float) -> dict:
    """The least time for ``n_bytes`` moved and ``n_flops`` f32 operations
    at the card's peaks, and which of the two sets it."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


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
    80), dndm_update at (4, 256, 32000); all f32, plain, kernel, kernel,
    plain."""
    B, S, H, P, N, L = K4_FULL[0]
    ins = ssd_inputs(g, B, S, H, P, N, torch.float32)
    k4 = lambda: k4_ops.ssd_scan(*ins, chunk=L)  # noqa: E731
    k4p = lambda: k4_ref.ssd_chunked(*ins, L)  # noqa: E731
    # bytes: x, dt, A, B, C read once, y written once
    k4_bytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N)
    p1, m1, m2, p2 = (time_ms(f, 20) for f in (k4p, k4, k4, k4p))
    out = {"ssd_scan": {
        "ms": statistics.median([m1, m2]),
        "plain_ms": statistics.median([p1, p2]),
        **bound(k4_bytes, ssd_flops(B, S, H, P, N, L)),
        "kernel_flops": 2 * B * H * -(-S // L) * (L * L * (N + P)
                                                  + 2 * L * N * P),
        "library_ms": None}}

    Hq, hd = 32, 80
    q, k, v = (torch.randn(B, S, Hq, hd, generator=g, device="cuda")
               for _ in range(3))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    k2 = lambda: k2_ops.flash_attention(q, k, v)  # noqa: E731
    k2p = lambda: k2_ref.attention(q, k, v)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    p3, m3, l3, m4, p4 = (time_ms(f, 50) for f in (k2p, k2, lib, k2, k2p))
    out["flash_attention"] = {
        "shape": [B, S, Hq, hd], "ms": statistics.median([m3, m4]),
        "plain_ms": statistics.median([p3, p4]),
        **bound(4 * B * S * Hq * hd * 4, 4 * B * Hq * S * S * hd),
        "library_ms": l3}

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
    out["dndm_update"] = {
        "shape": [B, S, K], "ms": statistics.median([m5, m6]),
        "plain_ms": statistics.median([p5, p6]),
        **bound(B * S * K * 8 + K * 4 + B * S * 12, B * S * K * 3),
        "library_ms": None}
    return out


def measure(g) -> dict:
    """Kernel, plain and library times at the main path's shapes."""
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
    p4 = time_ms(k2p, 50)

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
    return {
        "dndm_update": {
            "ms": statistics.median([m1, m2]),
            "plain_ms": statistics.median([p1, p2]),
            **bound(k1_bytes, k1_ops_n), "library_ms": None},
        "flash_attention": {
            "ms": statistics.median([m3, m4]),
            "plain_ms": statistics.median([p3, p4]),
            **bound(k2_bytes, k2_flops), "library_ms": l3},
        "decode_scores": {
            "ms": statistics.median([m5, m6]),
            "plain_ms": statistics.median([p5, p6]),
            **bound(k3_bytes, k3_ops_n), "library_ms": None},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
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
         **t["dndm_update"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
         "launches": counts["flash_attention"], "max_abs_err": k2_err,
         **t["flash_attention"]},
        {"name": "decode_scores", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_scores.cu",
         "replaces": "src/repro/kernels/decode_scores/kernel.py:35",
         "launches": mt_counts["decode_scores"], "max_abs_err": k3_err,
         **t["decode_scores"]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/kernel.py:26",
         "launches": z_counts["ssd_scan"],
         "max_abs_err": max(k4_check["max_err_f32"],
                            k4_check["full"]["vs_chunked"]),
         **{k: v for k, v in tz["ssd_scan"].items() if k != "kernel_flops"}},
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
    print(json.dumps({"phase_seconds": phase_s}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
