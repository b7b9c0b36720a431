"""Plain PyTorch version of the fused DNDM decode-update.

The CPU path of :func:`repro_torch.kernels.dndm_update.ops.dndm_update`,
and what ``chip_smoke.py`` holds the CUDA kernel against on the card.
"""
from __future__ import annotations

import torch


def adjust_logits(logits, mask=None, temperature: float = 1.0, gumbel=None):
    """The decode pre-activation: f32 cast, temperature, additive mask,
    optional Gumbel noise.  Op order is the CUDA kernel's — bitwise token
    parity depends on it.  The temperature is divided as a tensor: a
    Python-scalar divisor becomes a multiply by its reciprocal on CUDA,
    which is not the same number."""
    a = logits.to(torch.float32)
    if temperature != 1.0:
        a = a / torch.tensor(temperature, dtype=torch.float32,
                             device=a.device)
    if mask is not None:
        a = a + mask
    if gumbel is not None:
        a = a + gumbel
    return a


def dndm_update(logits, x, tau, t: int, *, version: int = 1, mask=None,
                temperature: float = 1.0, gumbel=None):
    """logits: (B,N,K); x, tau: (B,N) int32; t: int — eq. (9) with argmax
    (or Gumbel-max when ``gumbel`` is given) x0.  Returns (B,N) int32."""
    a = adjust_logits(logits, mask=mask, temperature=temperature,
                      gumbel=gumbel)
    x0_hat = a.argmax(-1).to(torch.int32)
    cond = (tau == t) if version == 1 else (tau >= t)
    return torch.where(cond, x0_hat, x)
