"""Shared neural building blocks: dense products, norms, RoPE, MLPs, time
embeddings.

Dense weights are stored as in the JAX package, ``(d_in, d_out)``, and
applied as ``x @ W`` through :func:`dense`, so JAX checkpoints load
unchanged.  Initialization draws from an explicit ``torch.Generator``: a
truncated normal on [-2, 2] scaled by ``scale / sqrt(d_in)``, the scheme
of ``repro.models.layers.dense_init``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.kernels.dense_gemm import ops as gemm_ops

# The kernel takes an f32 product on the card from DENSE_MIN_ROWS rows and
# DENSE_MIN_MACS multiply-adds (rows x K x N) up; below either, PyTorch's
# f32 GEMM serves it.  Both bounds come from chip_smoke.py
# --measure-dense-gemm on an H100: its row sweep (16 to 8192 rows at K x N
# = 768 x 768, 768 x 3072, 2560 x 2560, 2560 x 10448 and 768 x 28) and the
# host time a product takes through this function against torch.matmul's.
# Under 128 rows the weight's bytes, not the operations, bound the product
# and the kernel's 128-row tile is mostly padding: it loses on the device
# (2560 x 10448 at 64 rows: 0.096 against 0.086 ms).  Above them its device
# time saved has to pay for its wrapper's host time, 10-20 us a product
# more than torch.matmul's, which paces a host-bound call (the ranked
# path's): up to 1.2e9 multiply-adds the sweep saves at most 19 us (768 x
# 768 at 2048 rows, 768 x 3072 at 512), from 1.7e9 up 37 us and more (2560
# x 2560 at 256 rows); DENSE_MIN_MACS, 1.6e9, lies between.  A fixed rule
# of the shape.  Every product of the served cells (text8's 8192 rows but
# its 28-wide head, zamba2's 1024) lies above both; decode steps and the
# time MLP (a row a sequence) lie below.
DENSE_MIN_ROWS = 128
DENSE_MIN_MACS = 3 << 29


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., d_in) and a weight w (d_in, d_out), or a
    transposed view of one (the tied head's ``embed.T``).

    On the card, with no gradient being recorded through either operand,
    no dispatch mode on (a mode such as ``FlopCounterMode`` or
    ``FakeTensorMode`` sees the plain op), at least ``DENSE_MIN_ROWS`` rows
    and ``DENSE_MIN_MACS`` multiply-adds, and operands the kernel takes as
    they lie (``dense_gemm.ops.layout``: both f32, x contiguous or 2-D,
    16-byte aligned rows), the product runs in the 3xTF32 tensor-core
    kernel (``kernels/dense_gemm``), which reads x's leading dims as rows.
    Everything else is ``x @ w``: CPU tensors (so the CPU results are the
    plain product's, bit for bit), bf16, training, tensor subclasses
    (DTensor), unaligned operands and small products.  On the card each
    product is counted by route (``dense.products``, labels ``route``
    "kernel" or "matmul") with telemetry on; ``dense.matmul_calls`` counts
    the plain route's calls on every device."""
    if (x.is_cuda and type(x) is torch.Tensor
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or w.requires_grad))
            and torch._C._len_torch_dispatch_stack() == 0):
        k = x.shape[-1]
        rows = x.numel() // k if k else 0
        if (rows >= DENSE_MIN_ROWS
                and rows * k * w.shape[-1] >= DENSE_MIN_MACS):
            lay = gemm_ops.layout(x, w)
            if lay is not None:
                y = gemm_ops.run(x, w, *lay)
                _count("kernel")
                return y
    dense.matmul_calls += 1
    if x.is_cuda:
        _count("matmul")
    return x @ w


dense.matmul_calls = 0


def _count(route: str) -> None:
    if obs.enabled():
        obs.counter("dense.products",
                    "dense products on the card by route, once per "
                    "call").inc(route=route)


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
            h = F.silu(dense(x, self.gate)) * dense(x, self.up)
        else:
            h = F.gelu(dense(x, self.up), approximate="tanh")
        return dense(h, self.down)


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
        h = F.silu(dense(feats.to(self.w1.dtype), self.w1))
        return dense(h, self.w2)
