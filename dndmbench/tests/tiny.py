"""Tiny configurations and mixes of the benchmark's cells, for CPU
tests: the same block kinds and paths, small widths, and limits on what
a run must read that a busy test machine still meets."""
from __future__ import annotations

from dndmbench import harness

TEXT8 = {"registry_id": "dndm-text8", "model": dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    mlp_type="swiglu", vocab_size=28, block_unit=["attn"], n_super=2,
    rope_theta=10000.0, norm_eps=1e-5, bidirectional=True,
    time_conditioning=True, tie_embeddings=False, attn_impl="pallas",
    dtype="float32")}

ZAMBA2 = {"registry_id": "zamba2-2.7b", "model": dict(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    mlp_type="swiglu", vocab_size=50,
    block_unit=["mamba2", "mamba2", "shared_attn"], n_super=2,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, d_inner=128, conv_width=4,
    ssd_chunk=8, rope_theta=10000.0, norm_eps=1e-5, bidirectional=True,
    time_conditioning=True, tie_embeddings=False, attn_impl="pallas",
    dtype="float32")}


def serve_mix() -> dict:
    tr = harness.traffic_doc("open-poisson-n256-t1000")
    tr.update(N=32, T=50, rows=4, rate_per_s=20.0, ramp_s=0.5, cap_s=600,
              trace_calls=5, check_trajectories=4, check_min_tokens=32,
              ref_rows=8, tap_every=4, tap_min=1)
    return tr


def batch_mix() -> dict:
    tr = harness.traffic_doc("closed-4x256-t50")
    tr.update(N=32, T=20, rows=2, check_min_tokens=32, ref_rows=4,
              tap_every=4, tap_min=1)
    return tr
