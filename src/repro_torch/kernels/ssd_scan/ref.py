"""Plain PyTorch versions of the Mamba-2 SSD scan.

``ssd_chunked`` is the CPU path of
:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan` and what
``chip_smoke.py`` holds the CUDA kernel against on the card.  It follows
``repro/models/mamba2.py:_ssd_scan_ref`` op for op, dtype promotion
included: with bf16 inputs, ``C Bᵀ`` is a bf16 product and everything it
meets afterwards is f32, as in JAX.  ``ssd_sequential`` is the exact
step-by-step recurrence (``repro/kernels/ssd_scan/ref.py``), the ground
truth both the chunked form and the kernel must match.  ``chunk_states``
and ``chunk_cb`` (pass 1), ``carry_states`` (pass 2) and ``chunk_output``
(pass 3) are the plain versions of the kernel's passes, in f32 as the
kernel computes them; ``ssd_passes`` composes them.  ``ssd_chunked``
is also the scan a Mamba-2 block trains through; its one departure from
the reference keeps that gradient finite (the intra-chunk decay's
masked entries are exponentiated at 0), with the same values.

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
    # the masked entries (j > i) are exponentiated at 0, not at their gap:
    # a gap there can pass exp's range, and the backward of the mask
    # would multiply its zero by inf (the reference's gradient goes NaN);
    # the kept entries are the reference's, bitwise
    zero = torch.zeros((), dtype=gap.dtype, device=x.device)
    dec = torch.where(tri[None, None, :, :, None],
                      torch.exp(torch.where(tri[None, None, :, :, None], gap,
                                            zero)), zero)
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


def _chunked(L: int, *arrays):
    """Each array from (B, S, ...) to (B, nc, L, ...) in f32, zeros past
    S."""
    S = arrays[0].shape[1]
    pad = -(-S // L) * L - S
    out = []
    for a in arrays:
        a = a.float()
        if pad:
            a = F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        out.append(a.reshape(a.shape[0], -1, L, *a.shape[2:]))
    return out


def chunk_states(x, dtv, A, Bm, chunk: int):
    """Pass 1: each chunk's own state contribution s_c = Σ_j exp(cs_L -
    cs_j) dt_j B_j x_jᵀ and its cs_L, for every chunk but the last:
    (B, nc-1, H, N, P) and (B, nc-1, H), f32."""
    L = min(chunk, x.shape[1])
    xc, dtc, Bc = _chunked(L, x, dtv, Bm)
    cs = torch.cumsum(dtc * A, dim=2)                  # (B,nc,L,H)
    w = torch.exp(cs[:, :, -1:] - cs) * dtc
    s = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, w, xc)
    return s[:, :-1], cs[:, :-1, -1]


def chunk_cb(Bm, Cm, chunk: int):
    """Pass 1, its other part: each chunk's C Bᵀ, (B, nc, L, L) f32, zeros
    past S; shared by the heads."""
    L = min(chunk, Bm.shape[1])
    Bc, Cc = _chunked(L, Bm, Cm)
    return torch.einsum("bcin,bcjn->bcij", Cc, Bc)


def carry_states(states, cs_last):
    """Pass 2: the states entering chunks 1 .. nc-1, S_1 = s_0 and
    S_c+1 = exp(cs_L(c)) S_c + s_c, in the layout of ``states``."""
    if not states.shape[1]:
        return states
    run, out = states[:, 0], [states[:, 0]]
    for c in range(1, states.shape[1]):
        run = run * torch.exp(cs_last[:, c])[..., None, None] + states[:, c]
        out.append(run)
    return torch.stack(out, dim=1)


def chunk_output(x, dtv, A, Cm, cb, entering, chunk: int):
    """Pass 3: y = (C Bᵀ ∘ exp(cs_i - cs_j) ∘ dt_j) x over j <= i, plus
    (exp(cs) C) S_c for chunks c >= 1, with C Bᵀ = cb and S_c =
    entering[:, c - 1]."""
    Bb, S, H, P = x.shape
    L = min(chunk, S)
    xc, dtc, Cc = _chunked(L, x, dtv, Cm)
    cs = torch.cumsum(dtc * A, dim=2)                  # (B,nc,L,H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    gap = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B,nc,L,L,H)
    dec = torch.where(tri[None, None, :, :, None], torch.exp(gap),
                      torch.zeros((), device=x.device))
    M = cb[..., None] * dec * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xc)
    if entering.shape[1]:
        ce = Cc[:, 1:, :, None, :] * torch.exp(cs[:, 1:])[..., None]
        y[:, 1:] += torch.einsum("bcihn,bchnp->bcihp", ce, entering)
    return y.reshape(Bb, -1, H, P)[:, :S].to(x.dtype)


def ssd_passes(x, dtv, A, Bm, Cm, chunk: int):
    """The kernel's three passes composed: y (B,S,H,P) in x's dtype, as
    ``ssd_chunked``'s first output, with what the passes hand on (the
    entering states, cs_L, C Bᵀ), as ``ops.ssd_scan_passes`` returns
    them."""
    states, cs_last = chunk_states(x, dtv, A, Bm, chunk)
    cb = chunk_cb(Bm, Cm, chunk)
    entering = carry_states(states, cs_last)
    return (chunk_output(x, dtv, A, Cm, cb, entering, chunk), entering,
            cs_last, cb)
