"""DNDM-K — top-k transition time (paper Algorithm 4, App. E).

Instead of revealing the *specific* tokens whose tau equals t, DNDM-K only
uses the transition times to decide *how many* tokens should be revealed
by step t (``K_t = sum_n 1(tau_n >= t)``), and picks *which* tokens by
the network's own confidence scores (log-prob of the decoded token),
never re-updating an already-revealed token.  Network calls happen only
where ``K_{t-1} > K_t`` — the same skip set as Algorithm 1, so the NFE is
identical.

The per-step (token, score) pair comes from
:func:`repro_torch.core.decode.decode_tokens` — the ``decode_scores``
CUDA kernel on the card.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import decode
from repro_torch.core.noise import NoiseDist
from repro_torch.core.samplers import dndm, loop
from repro_torch.core.samplers.base import (DenoiseFn, SamplerConfig,
                                            SamplerOutput)
from repro_torch.core.transition import TransitionDist


def _walk(times, tau, x, denoise_fn, noise, cfg, cond, T, generator,
          gumbels, walk=loop.scan_loop):
    """Call the network at each of ``times`` (descending) by ``walk`` and
    reveal the top-scoring tokens up to ``K_{t-1} = #{n : tau_n >= t}``
    per row."""
    batch = x.shape[0]
    revealed = torch.zeros(x.shape, dtype=torch.bool, device=x.device)

    def step(carry, t: int, gumbel):
        x, revealed = carry
        k_target = (tau >= t).sum(-1)
        logits = denoise_fn(x, loop.t_norm(t, T, batch, x.device), cond)
        x0_hat, score = decode.decode_tokens(logits, noise, cfg,
                                             generator=generator,
                                             gumbel=gumbel)
        return loop.reveal_topk(x, x0_hat, score, revealed, k_target)

    x, _ = walk(times, (x, revealed), step, gumbels)
    return x


def sample(generator, denoise_fn: DenoiseFn, noise: NoiseDist,
           dist: TransitionDist, batch: int, N: int, cond=None,
           cfg: SamplerConfig = SamplerConfig(), order: str = "iid",
           shared_tau: bool = True, device=None, draws=None) -> SamplerOutput:
    """Algorithm 4 — host loop, NFE = |unique tau| as in Algorithm 1.

    Algorithm 4 reveals as many tokens per step as Algorithm 1 would
    (K_{t-1} - K_t = #(tau == t)), so its telemetry reports Algorithm 1's
    reveal counts, from the host copy of tau."""
    tau, x, gumbels, _ = loop.setup(generator, noise, batch, N, dist=dist,
                                    order=order, shared=shared_tau,
                                    device=device, draws=draws)
    tau_np = tau.cpu().numpy()
    times = loop.unique_times(tau_np)                         # descending
    aux = {"tau": tau, "times": times}
    step_attrs = dndm.reveal_telemetry(tau_np, times, aux, "dndm_topk")
    x = _walk(times, tau, x, denoise_fn, noise, cfg, cond, dist.T,
              generator, gumbels,
              functools.partial(loop.host_loop, step_attrs=step_attrs))
    return SamplerOutput(tokens=x, nfe=len(times), aux=aux)


def sample_static(generator, denoise_fn: DenoiseFn, noise: NoiseDist,
                  dist: TransitionDist, batch: int, N: int,
                  nfe_budget: int, cond=None,
                  cfg: SamplerConfig = SamplerConfig(), order: str = "iid",
                  shared_tau: bool = True, device=None,
                  draws=None) -> SamplerOutput:
    """DNDM-K on the quantile grid: the reveal-count schedule of the
    bucketized tau, fixed NFE = ``len(quantile_grid)``."""
    grid = dndm.quantile_grid(dist, nfe_budget)
    tau, x, gumbels, _ = loop.setup(generator, noise, batch, N, dist=dist,
                                    order=order, shared=shared_tau,
                                    device=device, draws=draws)
    # bucketized up to the grid, so the last grid time covers every token
    tau_b = dndm.bucketize(tau, grid)
    x = _walk(grid[::-1], tau_b, x, denoise_fn, noise, cfg, cond, dist.T,
              generator, gumbels)
    return SamplerOutput(tokens=x, nfe=len(grid),
                         aux={"tau": tau, "grid": grid})
