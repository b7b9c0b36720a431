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
from typing import Literal

import numpy as np
import torch

from repro_torch.core.schedules import Schedule


@dataclasses.dataclass(frozen=True)
class TransitionDist:
    """Discrete distribution D_tau over {1..T}."""

    name: str
    T: int
    probs: np.ndarray | None    # (T,)
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
) -> torch.Tensor:
    """Sample tau for every token: (batch, N) int32 in {1..T}, contiguous.

    ``order`` implements App. C Table 6: "l2r" reassigns the sampled times
    so that left positions transition *later in forward time* (revealed
    earlier in the reverse process); "r2l" is the mirror image.

    ``shared=True`` draws ONE transition-time set and broadcasts it across
    the batch — the paper's batched NFE accounting (Tables 7/8), since
    the network is called once per unique time in the whole batch.
    """
    if shared:
        tau = dist.sample(generator, (1, N), device).expand(batch, N)
    else:
        tau = dist.sample(generator, (batch, N), device)
    if order != "iid":
        tau = torch.sort(tau, dim=-1, stable=True).values
        if order == "l2r":
            tau = tau.flip(-1)  # leftmost token gets the largest tau
    # the expand above is a view; the kernels take contiguous tensors
    return tau.contiguous()


def nfe_of(tau: torch.Tensor, T: int) -> torch.Tensor:
    """|T| per batch row: number of *distinct* transition times (the NFE)."""
    counts = torch.zeros((tau.shape[0], T + 1), dtype=torch.int32,
                         device=tau.device)
    counts.scatter_add_(1, tau.long(), torch.ones_like(tau, dtype=torch.int32))
    return (counts[:, 1:] > 0).sum(-1)
