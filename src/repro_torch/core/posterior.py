"""Reverse-process posteriors q(x_{t-1} | x_t, x0) for the D3PM baseline.

Multinomial (uniform noise), Hoogeboom et al. 2021b eq. (15) form:
    theta_post(x_t, x0) ∝ (beta_t x_t + (1-beta_t)/K 1)
                        ⊙ (alpha_{t-1} x0 + (1-alpha_{t-1})/K 1)
with the network's predicted distribution substituted for the one-hot x0.

Absorbing (Austin et al. 2021, see paper App. B.1):
    if x_t = [MASK]: x_{t-1} = [MASK] w.p. (1-alpha_{t-1})/(1-alpha_t)
                     x_{t-1} = x0     w.p. (alpha_{t-1}-alpha_t)/(1-alpha_t)
    else:            x_{t-1} = x_t.

Plain PyTorch in the op order of ``repro.core.posterior``; no kernel
exists for it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.noise import NoiseDist


def _one_hot(ids: torch.Tensor, K: int, dtype) -> torch.Tensor:
    return F.one_hot(ids.long(), K).to(dtype)


def multinomial_posterior(x_t, x0_probs, alpha_tm1, alpha_t,
                          vocab_size: int) -> torch.Tensor:
    """theta_post over x_{t-1}.  x_t: (..., N) ids; x0_probs: (..., N, K).

    alpha_* broadcast against x_t (scalars or (..., 1) shaped).
    Returns (..., N, K) normalized probabilities.
    """
    K = vocab_size
    beta_t = alpha_t / torch.clamp(alpha_tm1, min=1e-12)
    xt_onehot = _one_hot(x_t, K, x0_probs.dtype)
    a = beta_t[..., None] * xt_onehot + (1.0 - beta_t)[..., None] / K
    b = alpha_tm1[..., None] * x0_probs + (1.0 - alpha_tm1)[..., None] / K
    p = a * b
    return p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)


def absorbing_posterior(x_t, x0_probs, alpha_tm1, alpha_t,
                        noise: NoiseDist) -> torch.Tensor:
    """Posterior over x_{t-1} for absorbing diffusion.  Shapes as above."""
    K = noise.vocab_size
    mask_id = noise.mask_id
    denom = torch.clamp(1.0 - alpha_t, min=1e-12)
    p_stay = ((1.0 - alpha_tm1) / denom)[..., None]        # stay masked
    p_reveal = ((alpha_tm1 - alpha_t) / denom)[..., None]  # reveal as x0
    mask_onehot = _one_hot(torch.full_like(x_t, mask_id), K, x0_probs.dtype)
    # forbid the network from revealing [MASK] itself
    x0p = x0_probs * (1.0 - mask_onehot)
    x0p = x0p / torch.clamp(x0p.sum(-1, keepdim=True), min=1e-30)
    masked_branch = p_stay * mask_onehot + p_reveal * x0p
    clean_branch = _one_hot(x_t, K, x0_probs.dtype)
    is_masked = (x_t == mask_id)[..., None]
    return torch.where(is_masked, masked_branch, clean_branch)


def posterior(x_t, x0_probs, alpha_tm1, alpha_t,
              noise: NoiseDist) -> torch.Tensor:
    if noise.kind == "multinomial":
        return multinomial_posterior(x_t, x0_probs, alpha_tm1, alpha_t,
                                     noise.vocab_size)
    return absorbing_posterior(x_t, x0_probs, alpha_tm1, alpha_t, noise)
