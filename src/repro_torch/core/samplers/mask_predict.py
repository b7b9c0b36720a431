"""Mask-Predict baseline (Ghazvininejad et al. 2019; paper App. G.2).

Iterative refinement with a fixed iteration budget M: start all-[MASK],
predict every position each round, keep the most confident tokens and
re-mask the rest on a linear-decay schedule n_i = N (M - 1 - i) / M.
NFE = M.  Absorbing-vocabulary models only (needs a [MASK] id).
Confidence is the per-token score from
:func:`repro_torch.core.decode.decode_tokens` (the ``decode_scores`` CUDA
kernel on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import decode
from repro_torch.core.noise import NoiseDist
from repro_torch.core.samplers import loop
from repro_torch.core.samplers.base import (DenoiseFn, SamplerConfig,
                                            SamplerOutput)


def sample(generator, denoise_fn: DenoiseFn, noise: NoiseDist,
           iterations: int, batch: int, N: int, cond=None,
           cfg: SamplerConfig = SamplerConfig(), device=None,
           draws=None) -> SamplerOutput:
    if noise.kind != "absorbing":
        raise ValueError("Mask-Predict needs an absorbing ([MASK]) vocab")
    # absorbing q_noise IS the all-[MASK] start state
    _, x, gumbels, _ = loop.setup(generator, noise, batch, N, device=device,
                                  draws=draws)
    M = iterations

    def step(x, i: int, gumbel):
        logits = denoise_fn(x, loop.t_norm(M - i, M, batch, x.device), cond)
        x0_hat, score = decode.decode_tokens(logits, noise, cfg,
                                             generator=generator,
                                             gumbel=gumbel)
        # tokens to re-mask, divided in f32 and rounded half to even as
        # the JAX sampler computes it
        n_mask = int(np.round(np.float32(N * (M - 1 - i)) / np.float32(M)))
        # ascending confidence: the lowest-ranked n_mask are re-masked
        order = torch.argsort(score, dim=-1, stable=True)
        remask = torch.argsort(order, dim=-1, stable=True) < n_mask
        return torch.where(remask, noise.mask_id, x0_hat)

    x = loop.scan_loop(range(M), x, step, gumbels)
    return SamplerOutput(tokens=x, nfe=M, aux={})
