"""Discrete DDIM baseline (Song et al. 2020a App. A; paper App. B.1).

For multinomial diffusion, the DDIM-style non-Markov posterior is
  q(x_{t-1}|x_t, x0) = Cat(sigma_t x_t + (alpha_{t-1} - sigma_t alpha_t) x0
                           + ((1-alpha_{t-1}) - (1-alpha_t) sigma_t) 1/K)
with the "de-randomized" choice sigma_t = (1-alpha_{t-1})/(1-alpha_t),
under which the uniform term vanishes: x_{t-1} keeps x_t w.p. sigma_t and
jumps to x0_hat w.p. 1-sigma_t.  Unlike DNDM there is no predetermined
transition time (paper Remark 3.5), so every step calls the network.

DDIM's acceleration is a timestep subsequence (``stride``): NFE =
ceil(T / stride).  x0_hat comes from
:func:`repro_torch.core.decode.decode_tokens` (the ``decode_scores`` CUDA
kernel on the card; the score is unused here).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import decode
from repro_torch.core.noise import NoiseDist
from repro_torch.core.samplers import loop
from repro_torch.core.samplers.base import (DenoiseFn, SamplerConfig,
                                            SamplerOutput)
from repro_torch.core.schedules import Schedule


def sample(generator, denoise_fn: DenoiseFn, noise: NoiseDist,
           schedule: Schedule, batch: int, N: int, stride: int = 1,
           cond=None, cfg: SamplerConfig = SamplerConfig(), device=None,
           draws=None) -> SamplerOutput:
    """DDIM-multinomial on the timestep subsequence {T, T-s, ..., s}."""
    if noise.kind != "multinomial":
        raise ValueError("discrete DDIM baseline is for multinomial "
                         "diffusion (absorbing D3PM is already DDIM-like)")
    T = schedule.T
    alphas = np.asarray(schedule.alphas, np.float32)
    ts = np.arange(T, 0, -stride)                  # current times
    _, x, gumbels, uniforms = loop.setup(generator, noise, batch, N,
                                         device=device, draws=draws)
    one = np.float32(1.0)

    def step(x, t: int, gumbel, u):
        logits = denoise_fn(x, loop.t_norm(t, T, batch, x.device), cond)
        x0_hat, _ = decode.decode_tokens(logits, noise, cfg,
                                         generator=generator, gumbel=gumbel)
        a_prev, a_t = alphas[max(t - stride, 0)], alphas[t]
        sigma = (one - a_prev) / np.maximum(one - a_t, np.float32(1e-9))
        if u is None:
            u = torch.rand((batch, N), generator=generator, device=x.device,
                           dtype=torch.float32)
        # bernoulli(p) is uniform < p, as jax.random.bernoulli draws it
        keep = u < float(np.clip(sigma, 0, 1))
        return torch.where(keep, x, x0_hat)

    x = loop.scan_loop(ts, x, step, gumbels, uniforms)
    return SamplerOutput(tokens=x, nfe=len(ts), aux={})
