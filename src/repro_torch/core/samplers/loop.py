"""Shared loop skeleton of the samplers.

Draw the predetermined transition-time set and x_T ~ q_noise, then walk
time backwards calling the denoiser: a host loop over the data-dependent
unique transition times (Algorithm 1/3) or over a static grid.

Every random draw comes from one ``torch.Generator``, in a fixed order:
tau, then x_T, then one Gumbel slab per network call.  ``draws`` is the
single injection point that replaces them — ``(tau, x_T, gumbels)`` with
``gumbels`` one (B, N, K) tensor per call, or None — so that tests can
replay the JAX package's random streams.  The serving path never passes
it.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.samplers.base import init_noise_tokens
from repro_torch.core.transition import sample_transition_times


def setup(generator, noise, batch: int, N: int, *, dist=None,
          order: str = "iid", shared: bool = False, device=None,
          draws=None):
    """The common sampler preamble: returns (tau, x_T, gumbels).

    ``tau`` is None when no transition-time law is given.  ``gumbels``
    is None unless ``draws`` supplies them.
    """
    if draws is not None:
        tau, x, gumbels = draws
        tau = None if tau is None else as_tensor(tau, torch.int32, device)
        return tau, as_tensor(x, torch.int32, device), gumbels
    tau = None
    if dist is not None:
        tau = sample_transition_times(generator, dist, batch, N, order=order,
                                      shared=shared, device=device)
    x = init_noise_tokens(generator, noise, batch, N, device)
    return tau, x, None


def as_tensor(a, dtype, device) -> torch.Tensor:
    """An injected draw (numpy or torch) as a contiguous tensor; numpy
    arrays are copied, since draws may be read-only views."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype).contiguous()


def unique_times(tau) -> np.ndarray:
    """Descending unique transition times of a (host) tau set — the
    predetermined network-call schedule of Algorithm 1."""
    return np.unique(np.asarray(tau))[::-1]


def reveal_series(tau, times, version: int = 1) -> np.ndarray:
    """Per-step reveal counts |R_t| for a host walk over ``times``,
    averaged over the batch: tokens with tau == t (version 1) or
    tau >= t (version 2) at each visited t."""
    tau = np.asarray(tau)
    times = np.asarray(times).astype(tau.dtype)
    cmp = (tau[..., None] == times) if version == 1 else \
        (tau[..., None] >= times)
    return cmp.sum(axis=-2).mean(axis=0)


def host_loop(times, carry, step: Callable, gumbels=None):
    """Host-driven walk: ``carry = step(carry, t, gumbel_i)`` per time,
    ``gumbel_i`` the injected slab of call ``i`` or None."""
    for i, t in enumerate(times):
        carry = step(carry, int(t), None if gumbels is None else gumbels[i])
    return carry
