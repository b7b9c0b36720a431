"""The Mamba-2 SSD scan (``ssd_scan``) of one direction of one block: x
(B, S, H, P), dt (B, S, H), B and C (B, S, N) (one group), chunks of L;
y like x and the final (B, H, N, P) f32 state."""
from __future__ import annotations


def flops(B: int, S: int, H: int, P: int, N: int, L: int) -> int:
    """The operations the chunked scan needs at least: C Bᵀ once per (b,
    chunk), shared by the heads, and M x on the lower triangle only (L (L
    + 1) / 2 entries each); C S for every chunk but the first (its
    entering state is zero) and the state update for every chunk but the
    last (y does not read it), each 2 L N P per head."""
    nc = -(-S // L)
    return (B * nc * L * (L + 1) * N
            + B * H * (nc * L * (L + 1) * P + (nc - 1) * 4 * L * N * P))


def nbytes(B: int, S: int, H: int, P: int, N: int,
           itemsize: int = 4) -> int:
    """x, dt, B and C read once, y written once, the final state (f32)
    written once."""
    return (itemsize * (2 * B * S * H * P + B * S * H + 2 * B * S * N)
            + 4 * B * H * N * P)
