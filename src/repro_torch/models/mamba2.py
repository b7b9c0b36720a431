"""Mamba-2 block (SSD — state-space duality), the port of
``repro/models/mamba2.py``'s full-sequence path.

The sequence is cut into chunks of ``ssd_chunk``; inside a chunk the
recurrence is a quadratic form, across chunks an f32 state of shape
(H, N, P) is carried.  The scan is routed by whether autograd records
it.  Serving (under ``torch.inference_mode``) goes through
:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan`: the hand-written CUDA
kernel for CUDA tensors, the plain chunked version for CPU tensors.  A
forward that autograd records (training) goes through the plain chunked
version, ``kernels/ssd_scan/ref.py::ssd_chunked``, on either device: it
computes the JAX package's ``_ssd_scan_ref``, the scan that the
reference's model always runs, with a gradient that stays finite where
the reference's goes NaN, and the kernel has no backward.  In
denoiser mode
(``bidirectional=True``) the block runs once forward and once over the
flipped sequence and sums the two.

Weight layout (groups = 1), the JAX tree's names, so JAX checkpoints
load unchanged:
  in_proj : d -> [z (d_in), x (d_in), B (N), C (N), dt (H)]
  conv_w  : (W, d_in + 2N), depthwise width-W causal conv over [x, B, C]
  conv_b, A_log, D, dt_bias, norm.scale, out_proj: d_in -> d

Decoding (``init_cache``/``decode``, the reference's ``init_cache`` and
``decode_step``) is the exact single-step recurrence over an (H, N, P)
state, with the last W - 1 conv inputs kept in the cache; the cache is
updated in place.  The decode conv is one product over the W-token
window, the forward's conv a sum of W taps, so the two agree to
rounding, not bitwise.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RMSNorm, dense_init


def a_log_linspace(H: int) -> np.ndarray:
    """``jnp.linspace(1, 16, H)`` in f32, bitwise, as XLA compiles it on
    the CPU: step_i = i * f32(1 / (H - 1)), then (1 - step_i) +
    i * f32(16 / (H - 1)) with one rounding (a fused multiply-add), and
    16 appended."""
    f32 = np.float32
    if H == 1:
        return np.ones(1, f32)
    r = f32(1) / f32(H - 1)
    c = f32(16) * r
    i = np.arange(H - 1, dtype=f32)
    one_minus = f32(1) - i * r
    head = (one_minus.astype(np.float64)
            + i.astype(np.float64) * np.float64(c)).astype(f32)
    return np.concatenate([head, np.full(1, 16, f32)])


def a_log_init(H: int) -> np.ndarray:
    """``log(linspace(1, 16, H))`` in f32, the log rounded once from
    float64.  XLA's f32 log is an approximation of its own, so A_log may
    differ from the JAX package's by one ulp."""
    return np.log(a_log_linspace(H).astype(np.float64)).astype(np.float32)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as the JAX sum of W taps, then SiLU.
    xBC (B,S,C); w (W,C)."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out + b)


class Mamba2(nn.Module):
    def __init__(self, generator, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, d_in, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        W = cfg.conv_width
        dt = getattr(torch, cfg.dtype)

        def const(a):
            return nn.Parameter(torch.as_tensor(a).to(device=device, dtype=dt),
                                requires_grad=False)

        # draw order of repro.models.mamba2.init: in_proj, conv_w, out_proj
        self.in_proj = dense_init(generator, d, 2 * d_in + 2 * N + H, dt,
                                  device)
        # truncated normal on [-2, 2] times 1/sqrt(W): dense_init's law
        self.conv_w = dense_init(generator, W, d_in + 2 * N, dt, device)
        self.conv_b = const(np.zeros(d_in + 2 * N, np.float32))
        self.A_log = const(a_log_init(H))
        self.D = const(np.ones(H, np.float32))
        # log(expm1(0.01)) in f32 on the CPU: the JAX package's value
        self.dt_bias = const(torch.log(torch.expm1(torch.full((H,), 0.01))))
        self.norm = RMSNorm(d_in, dt, device, cfg.norm_eps)
        self.out_proj = dense_init(generator, d_in, d, dt, device)

    def _split(self, u):
        d_in, N = self.cfg.d_inner, self.cfg.ssm_state
        zxbcdt = u @ self.in_proj
        return torch.split(zxbcdt, [d_in, d_in + 2 * N, self.cfg.ssm_heads],
                           dim=-1)

    def _post(self, y, z):
        """Gated RMSNorm, then the output projection."""
        return self.norm(y * F.silu(z)) @ self.out_proj

    def _one_direction(self, u: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = u.shape
        d_in, N = cfg.d_inner, cfg.ssm_state
        z, xBC, dt_raw = self._split(u)
        xBC = _causal_conv(xBC, self.conv_w, self.conv_b)
        x, Bm, Cm = torch.split(xBC, [d_in, N, N], dim=-1)
        dtv = F.softplus(dt_raw + self.dt_bias)
        A = -torch.exp(self.A_log.float())
        # views into xBC: the kernel reads them through strides
        xh = x.reshape(B, S, cfg.ssm_heads, cfg.ssm_head_dim)
        if torch.is_grad_enabled() and any(
                a.requires_grad for a in (xh, dtv, A, Bm, Cm)):
            y = ssd_ref.ssd_chunked(xh, dtv, A, Bm, Cm, cfg.ssd_chunk)[0]
        else:
            y, _ = ssd_ops.ssd_scan(xh, dtv, A, Bm, Cm, chunk=cfg.ssd_chunk)
        y = y + xh * self.D[:, None]
        return self._post(y.reshape(B, S, d_in).to(u.dtype), z)

    def forward(self, u: torch.Tensor, *,
                bidirectional: bool = False) -> torch.Tensor:
        """Full-sequence forward.  u: (B, S, d) -> (B, S, d)."""
        y = self._one_direction(u)
        if bidirectional:
            y = y + torch.flip(self._one_direction(torch.flip(u, dims=(1,))),
                               dims=(1,))
        return y

    # ---------------- decode ----------------

    def init_cache(self, batch: int, dtype) -> dict:
        """Zero SSM state (batch, H, N, P) and conv history (batch, W - 1,
        d_in + 2N) in ``dtype``."""
        cfg = self.cfg
        dev = self.in_proj.device
        return {"state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                                      cfg.ssm_head_dim), dtype=dtype,
                                     device=dev),
                "conv": torch.zeros((batch, cfg.conv_width - 1,
                                     cfg.d_inner + 2 * cfg.ssm_state),
                                    dtype=dtype, device=dev)}

    def decode(self, u: torch.Tensor, cache: dict) -> torch.Tensor:
        """One step.  u: (B, 1, d) -> (B, 1, d); ``cache`` is updated in
        place."""
        cfg = self.cfg
        B = u.shape[0]
        d_in, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_head_dim
        z, xBC, dt_raw = self._split(u[:, 0])
        hist = torch.cat([cache["conv"], xBC[:, None]], dim=1)  # (B, W, C)
        xBC = F.silu(torch.einsum("bwc,wc->bc", hist, self.conv_w)
                     + self.conv_b)
        x, Bm, Cm = torch.split(xBC, [d_in, N, N], dim=-1)
        dtv = F.softplus(dt_raw + self.dt_bias)               # (B, H)
        A = -torch.exp(self.A_log.float())
        xh = x.reshape(B, H, P)
        dec = torch.exp(dtv * A)                              # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhnp", dtv, Bm, xh)
        state = cache["state"] * dec[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cm, state)
        y = y + xh * self.D[:, None]
        cache["state"].copy_(state)
        cache["conv"].copy_(hist[:, 1:])
        return self._post(y.reshape(B, 1, d_in).to(u.dtype), z[:, None])
