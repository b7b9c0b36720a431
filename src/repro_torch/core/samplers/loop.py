"""Shared loop skeleton of the samplers.

Draw the predetermined transition-time set and x_T ~ q_noise, then walk
time backwards calling the denoiser: a host loop over the data-dependent
unique transition times (:func:`host_loop`, Algorithms 1, 3 and 4: the
registry's ``host`` kind) or over a static grid (:func:`scan_loop`, the
methods the JAX package runs as one ``lax.scan``: the ``scan`` kind).  A
host loop over a known grid is the port's form of that scan; CUDA-graph
capture of it comes later.

Each network call of either loop is a ``sampler.call`` layer span
(``obs.layer_span``: recorded while a torch profiler records).  The host
loop is the telemetry anchor for DNDM's headline claim, as in
the JAX package: with ``repro_torch.obs`` enabled it records per-step
host time (``sampler.step_seconds``) and emits one ``sampler.step`` event
per network call, with whatever the sampler supplies via ``step_attrs``
(the DNDM samplers pass the per-step reveal count |R_t|).  The time is
the host's dispatch time: steps are not synchronised, so telemetry adds
no device sync.  The scan loop emits nothing, as a compiled scan cannot.

Every random draw comes from one ``torch.Generator``, in a fixed order:
tau, then x_T, then per network call the Gumbel slab of the decode (or of
D3PM's categorical draw) and, for RDM's random routing and DDIM's jump,
one (B, N) uniform.  ``draws`` is the single injection point that
replaces them — ``(tau, x_T, gumbels, uniforms)``, with ``gumbels`` one
(B, N, K) array per call and ``uniforms`` one (B, N) array per call,
either list possibly None — so that tests can replay the JAX package's
random streams.  The serving path
never passes it.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.samplers.base import init_noise_tokens
from repro_torch.core.transition import sample_transition_times


def setup(generator, noise, batch: int, N: int, *, dist=None,
          order: str = "iid", shared: bool = False, device=None,
          continuous: bool = False, draws=None):
    """The common sampler preamble: returns (tau, x_T, gumbels,
    uniforms).

    ``tau`` is None when no transition-time law is given (the
    schedule-driven baselines), f32 in (0, 1] with ``continuous=True``
    (DNDM-C), else int32.  ``gumbels`` and ``uniforms`` are None unless
    ``draws`` supplies them.
    """
    if draws is not None:
        tau, x, gumbels, uniforms = draws
        if tau is not None:
            tau = as_tensor(tau, torch.float32 if continuous else torch.int32,
                            device)
        return (tau, as_tensor(x, torch.int32, device),
                _as_tensors(gumbels, device), _as_tensors(uniforms, device))
    tau = None
    if dist is not None:
        tau = sample_transition_times(generator, dist, batch, N, order=order,
                                      shared=shared, device=device,
                                      continuous=continuous)
    x = init_noise_tokens(generator, noise, batch, N, device)
    return tau, x, None, None


def as_tensor(a, dtype, device) -> torch.Tensor:
    """An injected draw (numpy or torch) as a contiguous tensor; numpy
    arrays are copied, since draws may be read-only views."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype).contiguous()


def _as_tensors(arrays, device):
    if arrays is None:
        return None
    return [as_tensor(a, torch.float32, device) for a in arrays]


def t_norm(num, den, batch: int, device) -> torch.Tensor:
    """(batch,) f32 time ``num / den``, divided in f32 as the JAX samplers
    compute ``t / T``."""
    return torch.full((batch,), np.float32(num) / np.float32(den),
                      dtype=torch.float32, device=device)


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


def scan_loop(times, carry, step: Callable, *per_call):
    """Walk a static grid: ``carry = step(carry, t, *draws_i)`` per time,
    where ``draws_i`` holds entry ``i`` of each injected per-call list in
    ``per_call`` (None for a list that is None)."""
    for i, t in enumerate(times):
        with obs.layer_span("sampler.call"):
            carry = step(carry, int(t),
                         *(None if d is None else d[i] for d in per_call))
    return carry


def host_loop(times, carry, step: Callable, *per_call,
              on_step: Callable | None = None,
              step_attrs: Callable[[int, Any], dict] | None = None):
    """Host-driven walk over the predetermined unique transition times,
    as :func:`scan_loop`, plus telemetry when enabled.  ``step_attrs(i,
    t)`` supplies extra attributes for the per-step event and is never
    called on the disabled path; ``on_step(carry)`` runs after each
    step."""
    enabled = obs.enabled()
    if not enabled and on_step is None:
        return scan_loop(times, carry, step, *per_call)
    if enabled:
        hist = obs.histogram(
            "sampler.step_seconds",
            "host-side dispatch seconds per host-loop step (no sync)")
    for i, t in enumerate(times):
        t0 = time.perf_counter()
        with obs.layer_span("sampler.call"):
            carry = step(carry, int(t),
                         *(None if d is None else d[i] for d in per_call))
        if enabled:
            dt = time.perf_counter() - t0
            hist.observe(dt, loop="host")
            extra = step_attrs(i, t) if step_attrs is not None else {}
            obs.event("sampler.step", i=i, t=t, dur_s=dt, **extra)
        if on_step is not None:
            on_step(carry)
    return carry


def reveal_topk(x, x0_hat, score, revealed, k_target):
    """Reveal the top-``score`` unrevealed tokens so that ``k_target``
    (per row) are revealed; returns (x, revealed).

    Already-revealed tokens are pinned at +inf so the top-``k_target``
    set always contains them (Algorithm 4's set U); their values are
    kept.  Ranks are JAX's ``argsort(argsort(-s))`` with ties in index
    order: ``jnp.argsort`` is stable, ``torch.argsort`` only when
    asked."""
    s = torch.where(revealed, torch.inf, score)
    order = torch.argsort(-s, dim=-1, stable=True)
    in_top = torch.argsort(order, dim=-1, stable=True) < k_target[:, None]
    newly = in_top & ~revealed
    return torch.where(newly, x0_hat, x), revealed | newly
