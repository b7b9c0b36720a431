"""Plain PyTorch versions of the Mamba-2 SSD scan.

``ssd_chunked`` is the CPU path of
:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan` and what
``chip_smoke.py`` holds the CUDA kernel against on the card.  It follows
``repro/models/mamba2.py:_ssd_scan_ref`` op for op, dtype promotion
included: with bf16 inputs, ``C Bᵀ`` is a bf16 product and everything it
meets afterwards is f32, as in JAX.  ``ssd_sequential`` is the exact
step-by-step recurrence (``repro/kernels/ssd_scan/ref.py``), the ground
truth both the chunked form and the kernel must match.

Shapes: x (B,S,H,P); dtv (B,S,H); A (H,) f32, negative; Bm, Cm (B,S,N),
shared across heads.  Both return (y (B,S,H,P) in x's dtype, final state
(B,H,N,P) f32).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s promotion: the operands meet in their common
    dtype (torch's einsum takes only one)."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def ssd_chunked(x, dtv, A, Bm, Cm, chunk: int):
    """Chunked SSD: the quadratic form inside chunks of L = min(chunk, S)
    and an f32 state recurrence across them."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtv = F.pad(dtv, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    xc = x.reshape(Bb, nc, L, H, P)
    dtc = dtv.reshape(Bb, nc, L, H)
    Bc = Bm.reshape(Bb, nc, L, N)
    Cc = Cm.reshape(Bb, nc, L, N)

    logdec = dtc * A                                   # (B,nc,L,H) <= 0
    cs = torch.cumsum(logdec, dim=2)                   # inclusive
    # intra-chunk quadratic form: decay(j -> i) = exp(cs_i - cs_j), j <= i
    gap = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B,nc,L,L,H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    dec = torch.where(tri[None, None, :, :, None], torch.exp(gap),
                      torch.zeros((), dtype=gap.dtype, device=x.device))
    cb = _einsum("bcin,bcjn->bcij", Cc, Bc)            # (B,nc,L,L)
    M = cb[..., None] * dec * dtc[:, :, None, :, :]    # weight dt_j at col j
    y_intra = _einsum("bcijh,bcjhp->bcihp", M, xc)

    # chunk-final states: sum_j exp(cs_L - cs_j) dt_j B_j (x) x_j
    dec_end = torch.exp(cs[:, :, -1:, :] - cs)         # (B,nc,L,H)
    sb = _einsum("bcjh,bcjn,bcjhp->bchnp", dec_end * dtc, Bc, xc)
    chunk_dec = torch.exp(cs[:, :, -1, :])             # (B,nc,H)

    # the inter-chunk state recurrence runs in f32 whatever the activation
    # dtype; prev[c] is the state entering chunk c
    state = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = (state * chunk_dec[:, c].float()[..., None, None]
                 + sb[:, c].float())
    prev = torch.stack(prev, dim=1)                    # (B,nc,H,N,P)

    # inter-chunk: y_i += C_i . (decay(start -> i) * prev_state)
    dec_in = torch.exp(cs)                             # (B,nc,L,H)
    y_inter = _einsum("bcin,bchnp->bcihp", Cc, prev) * dec_in[..., None]
    y = (y_intra + y_inter).reshape(Bb, nc * L, H, P)[:, :S]
    return y.to(x.dtype), state


def ssd_sequential(x, dtv, A, Bm, Cm):
    """The exact per-step recurrence in f32:
    S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_tᵀ,  y_t = C_t S_t."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    x, dtv, Bm, Cm = (a.float() for a in (x, dtv, Bm, Cm))
    state = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dec = torch.exp(dtv[:, t] * A)                 # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhnp", dtv[:, t], Bm[:, t], x[:, t])
        state = state * dec[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], state))
    return torch.stack(ys, dim=1), state
