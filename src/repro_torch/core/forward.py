"""Forward (corruption) processes.

Two mathematically distinct trajectory laws with identical marginals
(paper Thm 3.1):

  * ``markov_trajectory``     — eq. (1):  x_t = b_t x_{t-1} + (1-b_t) w_t
  * ``non_markov_trajectory`` — eq. (6):  x_t = b_t x_{t-1} + (1-b_t) w
                                (one shared noise draw per token)

plus the closed-form marginal sampler ``sample_xt`` used for training
(eq. 3): x_t = x_0 w.p. alpha_t else ~ q_noise.

All functions operate on integer token ids of shape (..., N) and draw
from an explicit ``torch.Generator`` on the tokens' device.  torch cannot
replay JAX's threefry streams, so the training corruptions also take
their draws from the caller (``draws=``): the timestep ``t`` per example,
a uniform ``u`` per token (kept iff ``u < alpha_t``, the law of
``jax.random.bernoulli``) and the noise ids ``w``.  Fed the JAX
package's draws, they give its ``x_t`` bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.core import transition
from repro_torch.core.noise import NoiseDist
from repro_torch.core.schedules import Schedule


def sample_xt(generator: torch.Generator | None, x0: torch.Tensor,
              alpha_t: torch.Tensor, noise: NoiseDist,
              draws: dict | None = None) -> torch.Tensor:
    """Sample x_t ~ q(x_t | x_0) = Cat(alpha_t x_0 + (1-alpha_t) q_noise).

    ``alpha_t`` broadcasts against ``x0`` (scalar, per-batch, or
    per-token).  Draws, in order: a uniform per token, then the noise
    ids; ``draws={"u": ..., "w": ...}`` replays both instead.
    """
    if draws is None:
        u = torch.rand(x0.shape, generator=generator, device=x0.device)
        w = noise.sample(generator, tuple(x0.shape), device=x0.device)
    else:
        u = torch.as_tensor(draws["u"], device=x0.device)
        w = torch.as_tensor(draws["w"], device=x0.device)
    keep = u < alpha_t
    return torch.where(keep, x0, w.to(x0.dtype))


def non_markov_trajectory(generator: torch.Generator, x0: torch.Tensor,
                          schedule: Schedule,
                          noise: NoiseDist) -> torch.Tensor:
    """Full DNDM trajectory {x_t}_{t=0..T} via eq. (6).

    Implemented through the transition-time characterization (eq. 7):
    sample tau per token, then x_t = x0 if t < tau else w, with a single
    shared w per token.  Returns (T+1, ...) stacked trajectory.
    """
    tau = transition.from_schedule(schedule).sample(
        generator, tuple(x0.shape), device=x0.device)
    w = noise.sample(generator, tuple(x0.shape), device=x0.device)
    ts = torch.arange(schedule.T + 1, device=x0.device).reshape(
        (-1,) + (1,) * x0.dim())
    return torch.where(ts < tau[None], x0[None], w.to(x0.dtype)[None])


def markov_trajectory(generator: torch.Generator, x0: torch.Tensor,
                      schedule: Schedule, noise: NoiseDist) -> torch.Tensor:
    """Full D3PM trajectory {x_t}_{t=0..T} via eq. (1) (fresh w_t each
    step)."""
    betas = torch.as_tensor(schedule.betas, dtype=torch.float32)
    traj = [x0]
    x = x0
    for beta_t in betas:
        b = torch.rand(x.shape, generator=generator, device=x.device) < beta_t
        w = noise.sample(generator, tuple(x.shape), device=x.device)
        x = torch.where(b, x, w.to(x.dtype))
        traj.append(x)
    return torch.stack(traj)


def training_draws(generator: torch.Generator, shape: tuple[int, ...],
                   schedule: Schedule, noise: NoiseDist, *,
                   continuous: bool = False, device=None) -> dict:
    """The draws {"t", "u", "w"} of :func:`corrupt_for_training` (or, with
    ``continuous``, :func:`corrupt_continuous`) for tokens of ``shape``,
    in their order: t per example, then a uniform per token, then the
    noise ids.  Both corruptions draw through it."""
    B = shape[0]
    if continuous:
        t = torch.rand((B,), generator=generator, device=device)
    else:
        t = torch.randint(1, schedule.T + 1, (B,), generator=generator,
                          device=device)
    u = torch.rand(shape, generator=generator, device=device)
    w = noise.sample(generator, tuple(shape), device=device)
    return {"t": t, "u": u, "w": w}


def corrupt_for_training(generator: torch.Generator | None,
                         x0: torch.Tensor, schedule: Schedule,
                         noise: NoiseDist, t: torch.Tensor | None = None,
                         draws: dict | None = None):
    """Training-time corruption: sample t ~ Unif{1..T} (or use given t),
    then x_t ~ q(x_t|x_0).  Returns (x_t, t, alpha_t).

    ``t`` has shape x0.shape[:1] (one timestep per example, as in RDM).
    ``draws`` {"t", "u", "w"} replays every draw.
    """
    B = x0.shape[0]
    if t is None and draws is None:
        draws = training_draws(generator, tuple(x0.shape), schedule, noise,
                               device=x0.device)
    if t is None:
        t = draws["t"]
    t = torch.as_tensor(t, device=x0.device).long()
    alphas = torch.as_tensor(schedule.alphas, dtype=torch.float32,
                             device=x0.device)
    alpha_t = alphas[t]
    bshape = (B,) + (1,) * (x0.dim() - 1)
    x_t = sample_xt(generator, x0, alpha_t.reshape(bshape), noise, draws)
    return x_t, t, alpha_t


def corrupt_continuous(generator: torch.Generator | None, x0: torch.Tensor,
                       schedule: Schedule, noise: NoiseDist,
                       draws: dict | None = None):
    """Continuous-time corruption for DNDM-C style training (§3.3, App
    G.1): t ~ Unif[0, 1], x_t = x0 w.p. alpha(t).  Returns (x_t, t,
    alpha_t); ``draws`` {"t", "u", "w"} replays every draw."""
    B = x0.shape[0]
    if draws is None:
        draws = training_draws(generator, tuple(x0.shape), schedule, noise,
                               continuous=True, device=x0.device)
    t = torch.as_tensor(draws["t"], dtype=torch.float32, device=x0.device)
    alpha_t = schedule.alpha_fn(t)
    bshape = (B,) + (1,) * (x0.dim() - 1)
    x_t = sample_xt(generator, x0, alpha_t.reshape(bshape), noise, draws)
    return x_t, t, alpha_t
