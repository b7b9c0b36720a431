"""The streaming (token, score) decode (``decode_scores``) of one call:
(rows, K) logits, a Gumbel slab like them and a (K,) mask in; a token
(int32) and a score (f32) per row out."""
from __future__ import annotations


def flops(rows: int, K: int) -> int:
    return 0


def nbytes(rows: int, K: int, itemsize: int = 4) -> int:
    """Logits and the f32 slab read once, the mask once, two 4-byte
    outputs per row."""
    return rows * K * (itemsize + 4) + 4 * K + 8 * rows
