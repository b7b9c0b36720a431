"""The fused DNDM decode-update (``dndm_update``) of one call: (rows, K)
logits, a Gumbel slab like them, a (K,) mask, x and tau (rows,) int32 in,
x out (rows,) int32.  It moves bytes and does no work worth counting."""
from __future__ import annotations


def flops(rows: int, K: int) -> int:
    return 0


def nbytes(rows: int, K: int, itemsize: int = 4) -> int:
    """Logits and the f32 slab read once, the mask once, x and tau read
    and x written."""
    return rows * K * (itemsize + 4) + 4 * K + 12 * rows
