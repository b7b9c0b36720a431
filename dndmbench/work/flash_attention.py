"""Self-attention over a whole sequence (``flash_attention``): q (B, S, H,
hd), k and v (B, S, KV, hd), o like q; no mask (the denoiser attends both
ways)."""
from __future__ import annotations


def flops(B: int, S: int, H: int, hd: int) -> int:
    """q kᵀ and p v: 2 products of 2 B H S² hd operations."""
    return 4 * B * H * S * S * hd


def nbytes(B: int, S: int, H: int, KV: int, hd: int,
           itemsize: int = 4) -> int:
    """q, k, v read once and o written once."""
    return itemsize * B * S * hd * (2 * H + 2 * KV)
