"""D3PM ancestral sampling — the Markov baseline (paper §2, App. B.1).

One network call per step: NFE = T.  Supports multinomial and absorbing
noise through :mod:`repro_torch.core.posterior`.  The posterior needs the
whole x0 probability vector, so this baseline uses no decode kernel:
softmax, posterior and a categorical draw are plain PyTorch, as the JAX
package computes them outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.decode import gumbel_noise
from repro_torch.core.noise import NoiseDist
from repro_torch.core.posterior import posterior
from repro_torch.core.samplers import loop
from repro_torch.core.samplers.base import (DenoiseFn, SamplerConfig,
                                            SamplerOutput)
from repro_torch.core.schedules import Schedule


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s op order: exp(x - max) / sum."""
    e = torch.exp(x - x.max(-1, keepdim=True).values)
    return e / e.sum(-1, keepdim=True)


def sample(generator, denoise_fn: DenoiseFn, noise: NoiseDist,
           schedule: Schedule, batch: int, N: int, cond=None,
           cfg: SamplerConfig = SamplerConfig(), device=None,
           draws=None) -> SamplerOutput:
    T = schedule.T
    alphas = np.asarray(schedule.alphas, np.float32)
    _, x, gumbels, _ = loop.setup(generator, noise, batch, N, device=device,
                                  draws=draws)
    mask = noise.logit_mask(torch.float32, x.device)
    temp = torch.tensor(cfg.temperature, dtype=torch.float32,
                        device=x.device)

    def step(x, t: int, gumbel):
        logits = denoise_fn(x, loop.t_norm(t, T, batch, x.device), cond)
        x0_probs = _softmax((logits + mask) / temp)
        a_tm1 = torch.full((batch, 1), alphas[t - 1], dtype=torch.float32,
                           device=x.device)
        a_t = torch.full((batch, 1), alphas[t], dtype=torch.float32,
                         device=x.device)
        p = posterior(x, x0_probs, a_tm1, a_t, noise)
        # categorical(log p) by the Gumbel-max trick, as
        # jax.random.categorical draws it
        if gumbel is None:
            gumbel = gumbel_noise(generator, p.shape, x.device)
        return (gumbel + torch.log(p + 1e-30)).argmax(-1).to(torch.int32)

    x = loop.scan_loop(range(T, 0, -1), x, step, gumbels)
    return SamplerOutput(tokens=x, nfe=T, aux={})
