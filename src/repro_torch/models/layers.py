"""Shared neural building blocks: norms, RoPE, MLPs, time embeddings.

Dense weights are stored as in the JAX package, ``(d_in, d_out)``, and
applied as ``x @ W``, so JAX checkpoints load unchanged.  Initialization
draws from an explicit ``torch.Generator``: a truncated normal on
[-2, 2] scaled by ``scale / sqrt(d_in)``, the scheme of
``repro.models.layers.dense_init``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def truncated_normal(generator: torch.Generator, shape: tuple[int, ...],
                     std: float, dtype, device=None) -> nn.Parameter:
    """Truncated-normal (on [-2, 2]) weight times ``std``, by inverse CDF:
    u uniform on [Phi(-2), Phi(2)], x = sqrt(2) erfinv(2u-1)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    w.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)
    return nn.Parameter(w.to(dtype), requires_grad=False)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device=None, scale: float = 1.0) -> nn.Parameter:
    """Weight of shape (d_in, d_out): truncated normal times
    ``scale / sqrt(d_in)``."""
    return truncated_normal(generator, (d_in, d_out), scale / d_in ** 0.5,
                            dtype, device)


# ---------------- RMSNorm ----------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype, device=device),
                                  requires_grad=False)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(dt)


# ---------------- RoPE ----------------

def rope_freqs(hd: int, theta: float,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., hd/2) for integer positions (...,)."""
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation.  x: (B, S, H, hd); cos/sin: (S, hd/2)."""
    dt = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


# ---------------- MLP ----------------

class MLP(nn.Module):
    """SwiGLU (``silu(x W_gate) * (x W_up)``) or GELU (tanh approximation,
    as ``jax.nn.gelu``), then ``W_down``."""

    def __init__(self, generator, d: int, d_ff: int, mlp_type: str, dtype,
                 device=None):
        super().__init__()
        self.mlp_type = mlp_type
        # draw order of repro.models.layers.mlp_init: gate, up, down
        if mlp_type == "swiglu":
            self.gate = dense_init(generator, d, d_ff, dtype, device)
        self.up = dense_init(generator, d, d_ff, dtype, device)
        self.down = dense_init(generator, d_ff, d, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mlp_type == "swiglu":
            h = F.silu(x @ self.gate) * (x @ self.up)
        else:
            h = F.gelu(x @ self.up, approximate="tanh")
        return h @ self.down


# ---------------- Diffusion time embedding ----------------

class TimeEmbed(nn.Module):
    """Sinusoidal features of t in [0,1] (angles x1000) -> 2-layer SiLU
    MLP -> (B, d)."""

    def __init__(self, generator, d: int, dtype, device=None):
        super().__init__()
        self.d = d
        self.w1 = dense_init(generator, d, d, dtype, device)
        self.w2 = dense_init(generator, d, d, dtype, device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.d // 2
        # f32 throughout, as the JAX package computes it.  ``step`` stays a
        # 0-dim CPU tensor, which a CUDA product takes as a scalar: copying
        # it to the card would synchronise host and device on every call
        step = (torch.log(torch.tensor(10_000.0, dtype=torch.float32))
                / max(half - 1, 1))
        freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                        device=t.device) * step)
        ang = t.float()[:, None] * freqs[None, :] * 1000.0
        feats = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        if feats.shape[-1] < self.d:
            feats = F.pad(feats, (0, self.d - feats.shape[-1]))
        h = F.silu(feats.to(self.w1.dtype) @ self.w1)
        return h @ self.w2
