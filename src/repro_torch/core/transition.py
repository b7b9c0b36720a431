"""Transition-time machinery — the heart of DNDM.

Definition 3.2: ``tau = min{t : b_t = 0}`` — the (single) step at which a
token flips from clean to noise.  Theorem 3.6: ``P(tau = t) =
alpha_{t-1} - alpha_t``; tokens are independent.  Sampling the whole set
``T = {tau_n}`` *upfront* de-randomizes the reverse process and the NFE is
``|T|`` (unique values), with ``E|T| = (1 - C) T`` (Theorem D.1).

Also the practical Beta(a, b) approximation of the transition law (paper
§3.2 / App. C and F) and the position-ordered variants of App. C Table 6.
The laws are numpy, computed as in ``repro.core.transition`` (bitwise);
draws are torch, from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

from repro_torch.core.schedules import Schedule


@dataclasses.dataclass(frozen=True)
class TransitionDist:
    """Distribution D_tau over {1..T} (discrete) or (0, 1] (continuous)."""

    name: str
    T: int                      # 0 => continuous time
    probs: np.ndarray | None    # (T,) for discrete; None for continuous
    beta_params: tuple[float, float] | None = None  # for beta-based laws

    def sample(self, generator: torch.Generator,
               shape: tuple[int, ...], device=None) -> torch.Tensor:
        """Sample integer transition times in {1..T} (int32)."""
        if self.T <= 0 or self.probs is None:
            raise ValueError("discrete sample() needs a discretized law")
        if not isinstance(generator, torch.Generator):
            raise TypeError("sample() draws from an explicit torch.Generator")
        p = torch.as_tensor(self.probs, dtype=torch.float32, device=device)
        n = int(np.prod(shape))
        idx = torch.multinomial(p, n, replacement=True, generator=generator)
        return (idx + 1).to(torch.int32).reshape(shape)

    def sample_continuous(self, generator: torch.Generator,
                          shape: tuple[int, ...], device=None) -> torch.Tensor:
        """Sample real-valued transition times in (0, 1] (DNDM-C), f32.

        A Beta law draws Beta(a, b); a discretized law draws a bin by its
        probabilities and jitters uniformly within it, ``(t + u) / T``
        with ``t`` the 0-based bin — the laws of
        ``repro.core.transition.TransitionDist.sample_continuous``.
        """
        if not isinstance(generator, torch.Generator):
            raise TypeError("sample_continuous() draws from an explicit "
                            "torch.Generator")
        n = int(np.prod(shape))
        if self.beta_params is not None:
            a, b = self.beta_params
            x = _gamma(generator, a, n, device)
            y = _gamma(generator, b, n, device)
            return (x / (x + y)).to(torch.float32).reshape(shape)
        p = torch.as_tensor(self.probs, dtype=torch.float32, device=device)
        t = torch.multinomial(p, n, replacement=True, generator=generator)
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        return (t.to(torch.float32).reshape(shape) + u) / self.T

    def expected_nfe(self, N: int) -> float:
        """E|T| = [1 - C_{T,N,D}] * T with C = (sum_i (1-p_i)^N) / T."""
        if self.probs is None:
            raise ValueError("expected_nfe needs a discretized law")
        p = self.probs.astype(np.float64)
        c = np.sum((1.0 - p) ** N) / self.T
        return float((1.0 - c) * self.T)


def from_schedule(schedule: Schedule) -> TransitionDist:
    """The exact law of Theorem 3.6: P(tau=t) = alpha_{t-1} - alpha_t."""
    return TransitionDist(name=f"thm3.6[{schedule.name}]", T=schedule.T,
                          probs=schedule.transition_probs())


def beta_approx(T: int, a: float, b: float) -> TransitionDist:
    """Beta(a, b) reshaped onto {1..T} (paper §3.2), discretized by CDF
    differencing at the bin edges k/T.  Used with validation-tuned
    (a, b), e.g. Beta(15, 7)."""
    edges = np.linspace(0.0, 1.0, T + 1)
    cdf = _beta_cdf(edges, a, b)
    probs = np.diff(cdf)
    probs = np.maximum(probs, 0)
    probs = probs / probs.sum()
    return TransitionDist(name=f"beta({a},{b})", T=T, probs=probs,
                          beta_params=(a, b))


def beta_continuous(a: float, b: float) -> TransitionDist:
    """Continuous Beta(a, b) law for DNDM-C timestamps."""
    return TransitionDist(name=f"beta_c({a},{b})", T=0, probs=None,
                          beta_params=(a, b))


def _gamma(generator: torch.Generator, alpha: float, n: int,
           device) -> torch.Tensor:
    """``n`` Gamma(alpha, 1) variates (f64) from ``generator``, by
    Marsaglia & Tsang's (2000) rejection from a cubed normal; alpha < 1
    via Gamma(alpha) = Gamma(alpha + 1) * U^(1/alpha).

    ``torch.distributions.Gamma`` takes no generator, so the draw is
    built from ``randn``/``rand`` here."""
    if alpha <= 0:
        raise ValueError(f"Gamma shape must be positive, got {alpha}")
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    f64 = torch.float64
    out = torch.empty(n, dtype=f64, device=device)
    filled = 0
    while filled < n:
        # acceptance is above 95% for a >= 1: draw what is missing, plus
        # a margin, in one go
        m = n - filled + 16
        z = torch.randn(m, generator=generator, dtype=f64, device=device)
        u = torch.rand(m, generator=generator, dtype=f64, device=device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp(min=1e-300)))
        acc = (d * v)[ok][: n - filled]
        out[filled:filled + acc.numel()] = acc
        filled += acc.numel()
    if alpha < 1.0:
        u = torch.rand(n, generator=generator, dtype=f64, device=device)
        out = out * u ** (1.0 / alpha)
    return out


def _beta_cdf(x: np.ndarray, a: float, b: float, n: int = 4096) -> np.ndarray:
    """Regularized incomplete beta via trapezoid quadrature (no scipy)."""
    grid = np.linspace(0.0, 1.0, n + 1)
    # pdf ~ u^(a-1) (1-u)^(b-1); handle endpoint singularities for a,b < 1
    with np.errstate(divide="ignore", invalid="ignore"):
        pdf = grid ** (a - 1.0) * (1.0 - grid) ** (b - 1.0)
    pdf = np.nan_to_num(pdf, posinf=0.0)
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) * 0.5)])
    cdf /= cdf[-1]
    return np.interp(x, grid, cdf)


def sample_transition_times(
    generator: torch.Generator,
    dist: TransitionDist,
    batch: int,
    N: int,
    order: Literal["iid", "l2r", "r2l"] = "iid",
    shared: bool = False,
    device=None,
    continuous: bool = False,
) -> torch.Tensor:
    """Sample tau for every token: (batch, N) int32 in {1..T}, or f32 in
    (0, 1] with ``continuous=True`` (DNDM-C timestamps); contiguous.

    ``order`` implements App. C Table 6: "l2r" reassigns the sampled times
    so that left positions transition *later in forward time* (revealed
    earlier in the reverse process); "r2l" is the mirror image.

    ``shared=True`` draws ONE transition-time set and broadcasts it across
    the batch — the paper's batched NFE accounting (Tables 7/8), since
    the network is called once per unique time in the whole batch.
    """
    draw = dist.sample_continuous if continuous else dist.sample
    if shared:
        tau = draw(generator, (1, N), device).expand(batch, N)
    else:
        tau = draw(generator, (batch, N), device)
    if order != "iid":
        tau = torch.sort(tau, dim=-1, stable=True).values
        if order == "l2r":
            tau = tau.flip(-1)  # leftmost token gets the largest tau
    # the expand above is a view; the kernels take contiguous tensors
    return tau.contiguous()


def nfe_of(tau: torch.Tensor, T: int) -> torch.Tensor:
    """|T| per batch row: number of *distinct* transition times (the NFE)."""
    return transition_mask_per_step(tau, T).sum(0)


def expected_nfe_mc(dist: TransitionDist, N: int, batch: int,
                    generator: torch.Generator) -> float:
    """Monte-Carlo E|T| over ``batch`` rows of ``N`` tokens (held against
    Theorem D.1's :meth:`TransitionDist.expected_nfe` in the tests)."""
    tau = dist.sample(generator, (batch, N), device=generator.device)
    return float(nfe_of(tau, dist.T).float().mean())


def transition_mask_per_step(tau: torch.Tensor, T: int) -> torch.Tensor:
    """(T, batch) bool: does step t host at least one transition in the
    row?"""
    counts = torch.zeros((tau.shape[0], T + 1), dtype=torch.int32,
                         device=tau.device)
    counts.scatter_add_(1, tau.long(), torch.ones_like(tau, dtype=torch.int32))
    return (counts[:, 1:] > 0).T
