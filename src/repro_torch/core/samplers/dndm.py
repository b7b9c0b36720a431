"""DNDM samplers (the paper's contribution).

  * ``sample``        — Algorithm 1 (and Algorithm 3 via ``version=2``):
    the faithful host-driven loop.  Transition times are *predetermined*,
    so the host knows the unique-time set before any network call and
    the network runs exactly ``|T|`` times.  NFE is data-dependent,
    exactly as in the paper.  One host sync per request (tau -> unique
    times); none per step.  With telemetry on, the per-step reveal
    counts |R_t| come from that host copy of tau (``aux["reveal_counts"]``,
    the ``sampler.reveal_count`` histogram and each ``sampler.step``
    event's ``reveal``); ``SamplerConfig.trace`` keeps every
    intermediate state in ``aux["trace"]``, one device-to-host copy per
    step, as the JAX package does.
  * ``sample_static`` — transition times bucketized onto ``nfe_budget``
    quantiles of D_tau, so the NFE is fixed; as nfe_budget -> |T| this
    converges to Algorithm 1.

  * ``sample_scan`` — the fully-stepped form of Algorithm 1: every t
    from T down to 1, with the network called only where some tau
    equals t (the JAX package's ``lax.cond``-gated scan).  It exists for
    equivalence tests: each step reads ``(tau == t).any()`` on the host.

All three decode through :func:`repro_torch.core.decode.fused_update` —
the ``dndm_update`` CUDA kernel on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import decode
from repro_torch.core.noise import NoiseDist
from repro_torch.core.samplers import loop
from repro_torch.core.samplers.base import (DenoiseFn, SamplerConfig,
                                            SamplerOutput)
from repro_torch.core.transition import TransitionDist


def _step_fn(denoise_fn, noise, cfg, tau, cond, version, T, batch, device,
             generator):
    """One DNDM network call + fused eq. (9) decode-update."""
    def step(x, t: int, gumbel):
        logits = denoise_fn(x, loop.t_norm(t, T, batch, device), cond)
        return decode.fused_update(logits, x, tau, t, noise, cfg,
                                   version=version, generator=generator,
                                   gumbel=gumbel)
    return step


def sample(generator, denoise_fn: DenoiseFn, noise: NoiseDist,
           dist: TransitionDist, batch: int, N: int, cond=None,
           cfg: SamplerConfig = SamplerConfig(), version: int = 1,
           order: str = "iid", shared_tau: bool = True, device=None,
           draws=None) -> SamplerOutput:
    """Algorithm 1 (version=1) / Algorithm 3 (version=2) — faithful.

    Times not in the transition set never touch the network, so
    wall-clock scales with |T|, not T.
    """
    tau, x, gumbels, _ = loop.setup(generator, noise, batch, N, dist=dist,
                                    order=order, shared=shared_tau,
                                    device=device, draws=draws)
    # Predetermined: the whole schedule of network calls is known *now*.
    tau_np = tau.cpu().numpy()
    times = loop.unique_times(tau_np)                          # descending
    trace = []
    aux = {"tau": tau, "trace": trace, "times": times}
    step_attrs = reveal_telemetry(tau_np, times, aux, "dndm", version)
    step = _step_fn(denoise_fn, noise, cfg, tau, cond, version, dist.T,
                    batch, device, generator)
    on_step = ((lambda x: trace.append(x.cpu().numpy()))
               if cfg.trace else None)
    x = loop.host_loop(times, x, step, gumbels, on_step=on_step,
                       step_attrs=step_attrs)
    return SamplerOutput(tokens=x, nfe=len(times), aux=aux)


def sample_scan(generator, denoise_fn: DenoiseFn, noise: NoiseDist,
                dist: TransitionDist, batch: int, N: int, cond=None,
                cfg: SamplerConfig = SamplerConfig(), version: int = 1,
                order: str = "iid", shared_tau: bool = True, device=None,
                draws=None) -> SamplerOutput:
    """Faithful DNDM stepped over all T times: a step whose t no tau
    equals makes no network call and no draw, so the NFE counts the calls
    and equals Algorithm 1's.  ``draws`` as for :func:`sample`, with one
    Gumbel slab per network call."""
    tau, x, gumbels, _ = loop.setup(generator, noise, batch, N, dist=dist,
                                    order=order, shared=shared_tau,
                                    device=device, draws=draws)
    step = _step_fn(denoise_fn, noise, cfg, tau, cond, version, dist.T,
                    batch, device, generator)
    nfe = 0
    for t in range(dist.T, 0, -1):
        if bool((tau == t).any()):
            x = step(x, t, None if gumbels is None else gumbels[nfe])
            nfe += 1
    return SamplerOutput(tokens=x, nfe=nfe, aux={"tau": tau})


def reveal_telemetry(tau_np, times, aux: dict, sampler: str,
                     version: int = 1):
    """With telemetry on, the per-step reveal counts |R_t| of a host walk
    over ``times``, from the host copy of tau: stored in
    ``aux["reveal_counts"]``, observed in ``sampler.reveal_count``, and
    returned as the ``step_attrs`` of :func:`loop.host_loop`.  None (and
    nothing computed) with telemetry off."""
    if not obs.enabled():
        return None
    reveals = loop.reveal_series(tau_np, times, version=version)
    aux["reveal_counts"] = reveals
    hist = obs.histogram("sampler.reveal_count",
                         "tokens revealed per network call (|R_t|)")
    for r in reveals:
        hist.observe(float(r), sampler=sampler, version=version)
    return lambda i, t: {"reveal": float(reveals[i])}


def quantile_grid(dist: TransitionDist, nfe_budget: int) -> np.ndarray:
    """Grid times = D_tau quantiles (equal transition mass per call).

    Strictly increasing: when the budget exceeds the number of distinct
    quantile times the repeats are dropped, so no token is revealed
    twice; ``len(grid) <= nfe_budget`` is the actual NFE.
    """
    probs = dist.probs
    if probs is None:
        raise ValueError("need a discretized D_tau")
    cdf = np.concatenate([[0.0], np.cumsum(probs)])
    qs = (np.arange(nfe_budget) + 1) / nfe_budget
    # smallest t with P(tau <= t) >= q  (cdf[t] indexes times directly)
    grid = np.searchsorted(cdf, qs - 1e-12)
    grid = np.clip(grid, 1, dist.T).astype(np.int32)     # times 1..T
    return np.unique(np.maximum.accumulate(grid))


def bucketize(tau: torch.Tensor, grid: np.ndarray) -> torch.Tensor:
    """Round each tau up to the nearest grid time (the last grid time
    for any beyond it); contiguous int32."""
    grid_t = torch.as_tensor(grid, dtype=torch.int32, device=tau.device)
    idx = torch.clamp(torch.searchsorted(grid_t, tau), 0, len(grid) - 1)
    return grid_t[idx].contiguous()


def sample_static(generator, denoise_fn: DenoiseFn, noise: NoiseDist,
                  dist: TransitionDist, batch: int, N: int,
                  nfe_budget: int, cond=None,
                  cfg: SamplerConfig = SamplerConfig(), version: int = 1,
                  order: str = "iid", shared_tau: bool = True, device=None,
                  draws=None) -> SamplerOutput:
    """Static-quantile DNDM: NFE fixed at ``len(quantile_grid)``.

    Each token's tau is rounded *up* to the nearest grid time, preserving
    "every token revealed exactly once" and the reveal order.
    """
    grid = quantile_grid(dist, nfe_budget)
    tau, x, gumbels, _ = loop.setup(generator, noise, batch, N, dist=dist,
                                    order=order, shared=shared_tau,
                                    device=device, draws=draws)
    tau_b = bucketize(tau, grid)
    step = _step_fn(denoise_fn, noise, cfg, tau_b, cond, version, dist.T,
                    batch, device, generator)
    x = loop.scan_loop(grid[::-1], x, step, gumbels)
    return SamplerOutput(tokens=x, nfe=len(grid),
                         aux={"tau": tau, "grid": grid})
