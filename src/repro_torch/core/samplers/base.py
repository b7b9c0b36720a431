"""Sampler API shared by every reverse-process algorithm.

A *denoiser* is any callable ``denoise_fn(x_t, t_norm, cond) -> logits``:
  x_t    : (B, N) int32 current tokens
  t_norm : (B,) float32 time in [0, 1] (t/T for discrete samplers)
  cond   : optional dict of conditioning tensors (e.g. a prefix)
  logits : (B, N, K)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import decode
from repro_torch.core.noise import NoiseDist

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


class SamplerOutput(NamedTuple):
    tokens: torch.Tensor   # (B, N) final x_0
    nfe: int               # network calls actually made for this batch
    aux: dict              # trace / diagnostics


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Common knobs (paper §3.2, App. E/F)."""

    x0_mode: str = "sample"        # "sample" | "argmax"
    temperature: float = 1.0
    trace: bool = False            # record intermediate states (dndm)


def select_x0(logits: torch.Tensor, noise: NoiseDist, cfg: SamplerConfig,
              generator: torch.Generator | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick x0_hat from logits; returns (tokens (B,N), scores (B,N)).

    Thin shim over :func:`repro_torch.core.decode.decode_tokens`, as the
    JAX package keeps one; the decode layer owns the kernel dispatch and
    the Gumbel-max sample mode.
    """
    return decode.decode_tokens(logits, noise, cfg, generator=generator)


def init_noise_tokens(generator, noise: NoiseDist, batch: int, N: int,
                      device=None) -> torch.Tensor:
    """x_T ~ q_noise for every token."""
    return noise.sample(generator, (batch, N), device)
