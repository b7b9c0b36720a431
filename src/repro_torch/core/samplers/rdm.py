"""RDM / RDM-k sampling (Zheng et al. 2023) — the paper's main baseline.

Reparameterized reverse sampling: the network is called at every step
(NFE = T), a fresh x0_hat is decoded, and the set of "denoised" tokens is
grown so that the clean fraction tracks alpha_{t-1}:

  * RDM   — the newly denoised tokens are chosen uniformly at random
            among the still-noisy ones (the b_t routing variable);
  * RDM-k — they are the still-noisy tokens with the highest decoding
            scores (the discriminative top-k trick, App. E).

Denoised tokens keep their committed value; noisy tokens stay as they
are.  The (token, score) pair comes from
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
from repro_torch.core.schedules import Schedule


def sample(generator, denoise_fn: DenoiseFn, noise: NoiseDist,
           schedule: Schedule, batch: int, N: int, cond=None,
           cfg: SamplerConfig = SamplerConfig(), topk: bool = True,
           device=None, draws=None) -> SamplerOutput:
    T = schedule.T
    alphas = np.asarray(schedule.alphas, np.float32)
    _, x, gumbels, uniforms = loop.setup(generator, noise, batch, N,
                                         device=device, draws=draws)
    denoised = torch.zeros(x.shape, dtype=torch.bool, device=x.device)

    def step(carry, t: int, gumbel, u):
        x, denoised = carry
        logits = denoise_fn(x, loop.t_norm(t, T, batch, x.device), cond)
        x0_hat, score = decode.decode_tokens(logits, noise, cfg,
                                             generator=generator,
                                             gumbel=gumbel)
        # clean tokens after this step: N alpha_{t-1} (the forward
        # marginal), rounded half to even in f32 as jnp.round does, and
        # never fewer than are already clean
        k_target = int(np.round(np.float32(N) * alphas[t - 1]))
        k_target = denoised.sum(-1).clamp(min=k_target)
        if not topk:
            if u is None:
                u = torch.rand((batch, N), generator=generator,
                               device=x.device, dtype=torch.float32)
            score = u
        return loop.reveal_topk(x, x0_hat, score, denoised, k_target)

    x, _ = loop.scan_loop(range(T, 0, -1), (x, denoised), step, gumbels,
                          uniforms)
    return SamplerOutput(tokens=x, nfe=T, aux={})
