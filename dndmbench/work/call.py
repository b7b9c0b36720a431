"""The model operations of one network call of a denoiser, from the
configuration's widths (a ``configs/*.json`` file) alone.

Every weight matrix counts 2 operations per element per token each time
the call applies it: both directions of a bidirectional Mamba-2 block,
and a Zamba shared block at every site.  The attention's own products
and the SSD scans are added from ``flash_attention`` and ``ssd_scan``;
the time embedding counts once per row.  The input embedding is a
gather and counts nothing."""
from __future__ import annotations

from dndmbench.work import flash_attention, ssd_scan


def _attn_weights(c: dict) -> int:
    d, hd = c["d_model"], c["head_dim"]
    qkvo = d * hd * (2 * c["n_heads"] + 2 * c["n_kv_heads"])
    mlp = (3 if c["mlp_type"] == "swiglu" else 2) * d * c["d_ff"]
    return qkvo + mlp


def _mamba_weights(c: dict) -> int:
    d, d_in, N = c["d_model"], c["d_inner"], c["ssm_state"]
    H = d_in // c["ssm_head_dim"]
    return d * (2 * d_in + 2 * N + H) + d_in * d + c["conv_width"] * (
        d_in + 2 * N)


def flops(c: dict, rows: int, N: int) -> int:
    """Operations of one call over ``rows`` sequences of ``N`` tokens."""
    tokens = rows * N
    dirs = 2 if c["bidirectional"] else 1
    total = 2 * c["d_model"] * c["vocab_size"] * tokens          # head
    total += 2 * 2 * c["d_model"] ** 2 * rows                    # time MLP
    for kind in c["block_pattern"]:
        if kind in ("attn", "shared_attn"):
            total += 2 * _attn_weights(c) * tokens
            total += flash_attention.flops(rows, N, c["n_heads"],
                                           c["head_dim"])
        elif kind == "mamba2":
            H = c["d_inner"] // c["ssm_head_dim"]
            total += dirs * (2 * _mamba_weights(c) * tokens + ssd_scan.flops(
                rows, N, H, c["ssm_head_dim"], c["ssm_state"],
                c["ssd_chunk"]))
        else:
            raise ValueError(f"no work count for block kind {kind!r}")
    return total
