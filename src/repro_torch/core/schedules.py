"""Noise schedules for discrete diffusion.

A schedule is the sequence ``alpha_t = prod_{s<=t} beta_s`` decreasing from
``alpha_0 = 1`` to ``alpha_T ~= 0`` (paper §2, eq. 3).  The discrete arrays
are numpy, computed exactly as in ``repro.core.schedules`` so that
``alphas`` and ``transition_probs`` agree bitwise; the continuous
``alpha(t), t in [0, 1]`` (paper §3.3) takes and returns torch tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Discrete alpha schedule with its continuous counterpart.

    Attributes:
      name: schedule identifier.
      T: number of diffusion steps.
      alphas: array of shape (T + 1,), ``alphas[0] == 1``, decreasing,
        ``alphas[T]`` close to 0.  ``alphas[t] = P(token still clean at t)``.
      alpha_fn: continuous ``alpha(t)`` on [0, 1] (the scale-invariant limit).
    """

    name: str
    T: int
    alphas: np.ndarray
    alpha_fn: Callable[[torch.Tensor], torch.Tensor]

    @property
    def betas(self) -> np.ndarray:
        """Per-step survival probabilities ``beta_t = alpha_t / alpha_{t-1}``."""
        a = self.alphas
        return a[1:] / np.maximum(a[:-1], 1e-12)

    def transition_probs(self) -> np.ndarray:
        """``P(tau = t) = alpha_{t-1} - alpha_t`` for t = 1..T (Theorem 3.6)."""
        p = self.alphas[:-1] - self.alphas[1:]
        # Guard tiny negative rounding and renormalize to a proper law.
        p = np.maximum(p, 0.0)
        s = p.sum()
        if s <= 0:
            raise ValueError(f"degenerate schedule {self.name!r}")
        return p / s


def _as_alphas(name: str, T: int, g: Callable[[np.ndarray], np.ndarray],
               alpha_fn: Callable[[torch.Tensor], torch.Tensor]) -> Schedule:
    t = np.arange(T + 1, dtype=np.float64) / T
    a = np.clip(g(t), 0.0, 1.0)
    a[0] = 1.0
    a[T] = 0.0
    # enforce monotone decrease
    a = np.minimum.accumulate(a)
    return Schedule(name=name, T=T, alphas=a, alpha_fn=alpha_fn)


def linear(T: int) -> Schedule:
    """``alpha_t = 1 - t/T`` (Austin et al. 2021) => uniform transition law."""
    return _as_alphas("linear", T, lambda t: 1.0 - t, lambda t: 1.0 - t)


def cosine(T: int, s: float = 0.008) -> Schedule:
    """``alpha_t = cos(pi/2 * (t/T + s)/(1+s)) / cos(pi/2 * s/(1+s))``."""
    c0 = math.cos(0.5 * math.pi * s / (1 + s))

    def g(t):
        return np.cos(0.5 * np.pi * (t + s) / (1 + s)) / c0

    def alpha_fn(t):
        return torch.cos(0.5 * math.pi * (t + s) / (1 + s)) / c0

    return _as_alphas("cosine", T, g, alpha_fn)


def cosine_sq(T: int, s: float = 0.008) -> Schedule:
    """``alpha_t = cos^2(...)`` (Zheng et al. 2023 / Nichol & Dhariwal)."""
    c0 = math.cos(0.5 * math.pi * s / (1 + s)) ** 2

    def g(t):
        return np.cos(0.5 * np.pi * (t + s) / (1 + s)) ** 2 / c0

    def alpha_fn(t):
        return torch.cos(0.5 * math.pi * (t + s) / (1 + s)) ** 2 / c0

    return _as_alphas("cosine_sq", T, g, alpha_fn)


def from_alpha_fn(name: str, T: int,
                  alpha_fn: Callable[[torch.Tensor], torch.Tensor]) -> Schedule:
    """Discretize an arbitrary continuous ``alpha(t)`` onto T steps.
    ``alpha_fn`` is evaluated in f32, as the JAX package evaluates it."""
    t = np.arange(T + 1, dtype=np.float64) / T
    a = alpha_fn(torch.from_numpy(t).float()).numpy().astype(np.float64)
    a = np.clip(a, 0.0, 1.0)
    a[0], a[T] = 1.0, 0.0
    a = np.minimum.accumulate(a)
    return Schedule(name=name, T=T, alphas=a, alpha_fn=alpha_fn)


_REGISTRY: dict[str, Callable[[int], Schedule]] = {
    "linear": linear,
    "cosine": cosine,
    "cosine_sq": cosine_sq,
}


def get(name: str, T: int) -> Schedule:
    if name not in _REGISTRY:
        raise KeyError(f"unknown schedule {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](T)
