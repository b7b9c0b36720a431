"""DNDM-C — continuous-time (infinite-step) sampling (paper Algorithm 2).

Transition timestamps are real numbers in (0, 1] drawn from a continuous
D_tau (a.s. all distinct), so the reverse process reveals exactly one
token per network call and NFE = N however fine the "schedule" — the
T -> infinity limit of Algorithm 1.  The top-k variant mirrors
Algorithm 4 in continuous time; its confidence scores come from
:func:`repro_torch.core.decode.decode_tokens` (the ``decode_scores``
CUDA kernel on the card).
"""
from __future__ import annotations

import torch

from repro_torch.core import decode
from repro_torch.core.noise import NoiseDist
from repro_torch.core.samplers import loop
from repro_torch.core.samplers.base import (DenoiseFn, SamplerConfig,
                                            SamplerOutput)
from repro_torch.core.transition import TransitionDist


def sample(generator, denoise_fn: DenoiseFn, noise: NoiseDist,
           dist: TransitionDist, batch: int, N: int, cond=None,
           cfg: SamplerConfig = SamplerConfig(), topk: bool = False,
           order: str = "iid", shared_tau: bool = False, device=None,
           draws=None) -> SamplerOutput:
    """Algorithm 2: exactly N network calls.

    At call k the current time is each row's k-th largest timestamp; the
    token owning it is revealed (``topk=False``), or the unrevealed token
    with the highest score is (``topk=True``, the DNDM-k-C variant of
    Tables 2/3's infinity rows).
    """
    tau, x, gumbels, _ = loop.setup(generator, noise, batch, N, dist=dist,
                                    order=order, shared=shared_tau,
                                    device=device, continuous=True,
                                    draws=draws)               # (B, N) f32
    revealed = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    # descending timestamps per row; owner[:, k] = token index (stable,
    # as JAX's argsort)
    owner = torch.argsort(-tau, dim=-1, stable=True)
    tau_sorted = tau.gather(-1, owner)
    positions = torch.arange(N, device=x.device)

    def step(carry, k: int, gumbel):
        x, revealed = carry
        t_now = tau_sorted[:, k].contiguous()                  # (B,) f32
        logits = denoise_fn(x, t_now, cond)
        x0_hat, score = decode.decode_tokens(logits, noise, cfg,
                                             generator=generator,
                                             gumbel=gumbel)
        if topk:
            tok_idx = torch.where(revealed, -torch.inf, score).argmax(-1)
        else:
            tok_idx = owner[:, k]
        upd = positions == tok_idx[:, None]
        return torch.where(upd, x0_hat, x), revealed | upd

    x, _ = loop.scan_loop(range(N), (x, revealed), step, gumbels)
    return SamplerOutput(tokens=x, nfe=N, aux={"tau": tau})
