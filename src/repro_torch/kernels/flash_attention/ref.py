"""Plain PyTorch versions of the flash-attention kernels.

The CPU paths of :func:`repro_torch.kernels.flash_attention.ops.
flash_attention`, ``flash_decode`` and ``flash_decode_partials``, and
what ``chip_smoke.py`` holds the CUDA kernels against on the card.  Same
layouts as the kernels: q (B,S,H,hd), k and v (B,S,KV,hd) with H a
multiple of KV; for the decode form q (B,1,H,hd) over a ring-buffer
cache k, v (B,L,KV,hd), or over a share of its slots (the partials).
"""
from __future__ import annotations

import torch

NEG = -1e9


def mask_bias(S: int, causal: bool, window: int,
              device=None) -> torch.Tensor:
    """(S, S) additive bias: 0 where a key is visible, ``NEG`` where the
    causal mask or the sliding window (last ``window`` positions when
    causal, ``|i - j| < window`` otherwise) hides it."""
    pos = torch.arange(S, device=device)
    diff = pos[:, None] - pos[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= (diff < window) if causal else (diff.abs() < window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, NEG))


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,KV,hd) -> (B,S,H,hd) by repeating each kv head H/KV times."""
    rep = n_heads // k.shape[2]
    return k.repeat_interleave(rep, dim=2) if rep > 1 else k


def attention(q, k, v, *, causal: bool = False, window: int = 0):
    """softmax(q k^T / sqrt(hd) + bias) v in f32; output in q's dtype."""
    B, S, H, hd = q.shape
    k = repeat_kv(k, H)
    v = repeat_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (hd ** 0.5)
    s = s + mask_bias(S, causal, window, q.device)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def ring_bias(pos: int, L: int, window: int, device=None) -> torch.Tensor:
    """(L,) additive bias of a ring-buffer KV cache for the query at
    position ``pos``: slot i holds position ``pos - ((pos mod L - i) mod
    L)``; 0 where that position is >= 0 and, with a ``window``, less than
    ``window`` behind ``pos``; ``NEG`` elsewhere."""
    idx = torch.arange(L, device=device)
    back = torch.remainder(pos % L - idx, L)    # pos - (the slot's position)
    ok = back <= pos
    if window > 0:
        ok &= back < window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, NEG))


def decode_attention(q, k_cache, v_cache, pos: int, window: int = 0):
    """softmax(q k^T / sqrt(hd) + ring_bias) v in f32 for one query row
    per head, q (B,1,H,hd), over the caches (B,L,KV,hd); output in q's
    dtype."""
    H, hd = q.shape[2], q.shape[3]
    k = repeat_kv(k_cache, H)
    v = repeat_kv(v_cache, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (hd ** 0.5)
    s = s + ring_bias(pos, k.shape[1], window, q.device)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def decode_partials(q, k, v, pos: int, window: int, ring_len: int,
                    slot0: int):
    """The softmax's partial statistics for one query row per head, q
    (B,1,H,hd), over slots ``slot0 .. slot0 + L - 1`` of a ring of
    ``ring_len`` slots (L and 0: the whole cache), which k and v
    (B,L,KV,hd) hold.  With s = q k^T / sqrt(hd) + ring_bias, in f32 and
    natural-log units: m = max s and l = sum exp(s - m), both (B,1,H),
    and acc = sum exp(s - m) v, (B,1,H,hd)."""
    L = k.shape[1]
    H, hd = q.shape[2], q.shape[3]
    k = repeat_kv(k, H).float()
    v = repeat_kv(v, H).float()
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k) / (hd ** 0.5)
    s = s + ring_bias(pos, ring_len, window, q.device)[slot0:slot0 + L]
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(-1), torch.einsum("bqhk,bkhd->bqhd", p, v)


def combine_partials(parts, dtype=torch.float32):
    """The attention output (B,1,H,hd) in ``dtype`` from the partials
    ``[(m, l, acc), ...]`` of disjoint sets of slots that together hold
    the whole ring: M = max m, l = sum exp(m - M) l_i, out = sum exp(m -
    M) acc_i / max(l, 1e-30).  A set whose slots are all masked has m
    near -1e9 and adds nothing."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    l = sum(f * li for f, (_, li, _) in zip(w, parts))
    acc = sum(f[..., None] * a for f, (_, _, a) in zip(w, parts))
    return (acc / l.clamp(min=1e-30)[..., None]).to(dtype)
