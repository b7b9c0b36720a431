"""Training objectives for discrete diffusion denoisers.

The paper (App. B.2/B.3) shows DNDM's ELBO matches the standard discrete
diffusion ELBO up to reweighting, so the network is trained exactly as in
D3PM/RDM and reused *training-free* by every sampler here.

  * ``reparam_ce_loss`` — the RDM (Zheng et al. 2023) reparameterized
    cross-entropy: corrupt x0 -> x_t, predict x0, CE on corrupted positions
    with optional lambda_t reweighting.  The paper's training recipe.
  * ``elbo_loss`` — the Hoogeboom-style variational bound with the
    categorical-posterior KL (eq. 5 / eq. 15), for completeness and tests.

The op order of ``repro.core.losses``.  Draws come from a
``torch.Generator``, or are replayed through ``draws=`` (see
``core/forward.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import forward
from repro_torch.core.noise import NoiseDist
from repro_torch.core.posterior import posterior
from repro_torch.core.schedules import Schedule
from repro_torch.device import gather_last


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy, stable."""
    logz = torch.logsumexp(logits, dim=-1)
    return logz - gather_last(logits, targets)


def weighted_ce(logits, x0, x_t, alpha_t, noise: NoiseDist,
                lambda_weighting: bool = True):
    """The RDM loss and its metrics from logits: (scalar loss, masked
    accuracy, corrupted indicator).  Only corrupted positions contribute
    fully (for absorbing the masked set; for multinomial the corruption
    indicator, which the trainer knows); apparently-clean ones weigh
    0.05, so that p(x0|x_t) stays calibrated."""
    ce = _ce(logits, x0)                      # (B, N)
    corrupted = (x_t != x0) if noise.kind == "multinomial" else (
        x_t == noise.mask_id)
    w = torch.where(corrupted, 1.0, 0.05)
    if lambda_weighting:
        # lambda_t = 1 - alpha_t emphasises noisier examples (RDM App. E)
        w = w * (1.0 - alpha_t)[:, None]
    loss = (ce * w).sum() / torch.clamp(w.sum(), min=1e-6)
    acc = ((logits.argmax(-1) == x0) & corrupted).sum() / torch.clamp(
        corrupted.sum(), min=1)
    return loss, acc, corrupted


def reparam_ce_loss(generator, apply_fn, params, x0: torch.Tensor,
                    schedule: Schedule, noise: NoiseDist,
                    cond: dict | None = None,
                    continuous_time: bool = False,
                    lambda_weighting: bool = True,
                    draws: dict | None = None):
    """RDM-style loss.  ``apply_fn(params, x_t, t_norm, cond) -> logits``.
    Returns (scalar loss, metrics)."""
    if continuous_time:
        x_t, t, alpha_t = forward.corrupt_continuous(
            generator, x0, schedule, noise, draws=draws)
        t_norm = t
    else:
        x_t, t, alpha_t = forward.corrupt_for_training(
            generator, x0, schedule, noise, draws=draws)
        t_norm = t.float() / schedule.T
    logits = apply_fn(params, x_t, t_norm, cond)
    loss, acc, corrupted = weighted_ce(logits, x0, x_t, alpha_t, noise,
                                       lambda_weighting)
    return loss, {"loss": loss, "masked_acc": acc,
                  "frac_corrupted": corrupted.float().mean()}


def elbo_loss(generator, apply_fn, params, x0: torch.Tensor,
              schedule: Schedule, noise: NoiseDist,
              cond: dict | None = None, draws: dict | None = None):
    """Single-t Monte-Carlo estimate of the negative ELBO (eq. 5).

    L_t = KL(q(x_{t-1}|x_t,x0) || p_theta(x_{t-1}|x_t)) with the
    theta_post parameterization; L_1 = -log p_theta(x0|x1).  Draws t,
    then the corruption.
    """
    B = x0.shape[0]
    t = None if draws is None else draws["t"]
    if t is None:
        t = torch.randint(1, schedule.T + 1, (B,), generator=generator,
                          device=x0.device)
    x_t, t, alpha_t = forward.corrupt_for_training(
        generator, x0, schedule, noise, t=t, draws=draws)
    alphas = torch.as_tensor(schedule.alphas, dtype=torch.float32,
                             device=x0.device)
    alpha_tm1 = alphas[t - 1]
    t_norm = t.float() / schedule.T
    logits = apply_fn(params, x_t, t_norm, cond)
    x0_probs = torch.softmax(logits, dim=-1)

    a_tm1 = alpha_tm1[:, None]
    a_t = alpha_t[:, None]
    q_post = posterior(x_t, F.one_hot(x0.long(), noise.vocab_size).to(
        x0_probs.dtype), a_tm1, a_t, noise)
    p_post = posterior(x_t, x0_probs, a_tm1, a_t, noise)
    kl = (q_post * (torch.log(q_post + 1e-20)
                    - torch.log(p_post + 1e-20))).sum(-1)
    l1 = _ce(logits, x0)                      # reconstruction at t == 1
    per_tok = torch.where((t == 1)[:, None], l1, kl)
    # Each term is an unbiased single-sample estimate of its summand; the
    # uniform t draw gives the ELBO up to the constant factor T.
    loss = per_tok.mean() * schedule.T
    return loss, {"elbo_loss": loss, "kl_mean": kl.mean()}
