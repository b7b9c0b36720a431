"""Perf hill-climbing driver of the port: hypothesis -> change -> measure
-> validate, on the dry run's H100 roofline (``launch/dryrun.py``).

Runs the chosen (arch x shape) pairs through their iteration ladders on
the single-pod mesh.  Each iteration is one config or policy delta over
the previous; results land in ``results/perf/<arch>__<shape>__single_pod
__<tag>.json`` and the before/after log is printed.

    PYTHONPATH=src python -m repro_torch.launch.perf [pair ...]
    pairs: mixtral_train | llama4_train | deepseek_prefill | xlstm_prefill

The ladders (pairs, tags, archs, shapes, overrides, policy fields) are
the JAX package's; the hypotheses are written for the port, whose terms
are eager PyTorch's op by op (one rank traced on fake tensors) against
an H100's 80 GB, not a compiled program's.
"""
from __future__ import annotations

import os
import sys
import time

from repro_torch.launch.dryrun import run_one
from repro_torch.launch.sharding import ShardingPolicy

OUT = "results/perf"

# Each entry: (pair_name, arch, shape, [(tag, hypothesis, overrides,
#                                        policy_kwargs), ...])
LADDERS = [
    (
        "mixtral_train", "mixtral-8x7b", "train_4k",
        [
            ("it1_local_dispatch",
             "The global sort dispatch cannot be sharded, so every rank "
             "gathers all tokens and every expert weight and routes them "
             "all: useful_ratio near 0 and hundreds of GB per card. "
             "Dispatching within 16 groups changes what each sort sees, "
             "not what each rank holds: expect no gain while the layer "
             "still runs replicated.",
             {"moe_dispatch": "local", "moe_local_groups": 16}, {}),
            ("it2_shard_map",
             "The sharded dispatch makes locality structural: each rank "
             "routes its data shard's tokens through its (E, d, ff/16) "
             "weight shards and one all-reduce over the model axis sums "
             "them. Expect flops per card down ~16x and more, "
             "useful_ratio toward 0.5, the collective term down >10x.",
             {"moe_dispatch": "shard_map"}, {}),
            ("it3_shard_map_blocked_attn",
             "With the MoE local, the 4k x 4k sliding-window attention "
             "logits are the largest remaining traffic. On the card the "
             "attention runs fused (the flash kernel's bytes model): "
             "expect the memory term down 30% or more.",
             {"moe_dispatch": "shard_map",
              "attn_impl": "blocked", "attn_block_k": 1024}, {}),
            ("it4_microbatch4",
             "If the step still does not fit 80 GB per card, gradient "
             "accumulation over 4 microbatches keeps one microbatch of "
             "activations live: expect temp bytes ~/4 (plus the "
             "gradients), the time terms about flat.",
             {"moe_dispatch": "shard_map", "microbatches": 4}, {}),
        ],
    ),
    (
        # the expert-parallel all-to-all
        "llama4_train", "llama4-maverick-400b-a17b", "train_4k",
        [
            ("it1_shard_map_ep",
             "llama4 has 128 experts (divisible by model=16), so the "
             "sharded dispatch runs true expert parallelism: token slices "
             "travel to their experts by all-to-all (2 x buffer bytes per "
             "layer) instead of every rank gathering every expert. "
             "Expect the collective term down >10x with the all-to-all "
             "signature and useful_ratio toward 0.5.",
             {"moe_dispatch": "shard_map"}, {}),
        ],
    ),
    (
        "deepseek_prefill", "deepseek-7b", "prefill_32k",
        [
            ("it1_flash_attn",
             "The denoiser forward (DNDM's unit of cost) is memory-bound "
             "on plain 32k^2 attention: the logits are written and read "
             "several times per layer. The fused kernel reads q, k, v "
             "and writes o once: expect the memory term down ~5-10x.",
             {"attn_impl": "blocked", "attn_block_k": 2048}, {}),
            ("it2_seq_parallel",
             "After the fused attention, per-card activations (2 "
             "sequences of 32k x 4096) dominate the bytes. Sharding the "
             "sequence over the model axis cuts per-card activation "
             "traffic at the cost of gathering keys and values: expect "
             "the memory term down, the collective term up.",
             {"attn_impl": "blocked", "attn_block_k": 2048},
             {"shard_seq_train": True}),
        ],
    ),
    (
        "xlstm_prefill", "xlstm-350m", "prefill_32k",
        [
            ("it1_chunked_mlstm",
             "The mLSTM's parallel form materialises the (B, 32k, 32k, "
             "nh) decay matrix. The chunkwise form (L=2048) carries a (dh "
             "x dh) state across chunks: expect S^2 -> S*L, the memory "
             "term and the counted flops down by about 16x.",
             {"mlstm_chunk": 2048, "mlstm_unroll": True}, {}),
            ("it2_larger_chunks",
             "L=4096 halves the state updates and doubles the "
             "intra-chunk quadratic: if the memory term stays flat, the "
             "projections and the sLSTM's per-step work dominate and "
             "chunk tuning is spent.",
             {"mlstm_chunk": 4096, "mlstm_unroll": True}, {}),
            ("it3_seq_parallel",
             "With the quadratic gone, shard the sequence over the model "
             "axis as deepseek's it2 does: expect the memory term down "
             "where the blocks are sharded, flat where they replicate.",
             {"mlstm_chunk": 4096, "mlstm_unroll": True},
             {"shard_seq_train": True}),
        ],
    ),
]


def run_rung(pair: str, tag: str, out_dir: str = OUT) -> dict:
    """The dry run of one rung of a ladder on the single-pod mesh; its
    record (also written to ``out_dir``)."""
    for name, arch, shape, ladder in LADDERS:
        for t, _, overrides, pol_kw in ladder:
            if (name, t) == (pair, tag):
                return run_one(arch, shape, multi_pod=False,
                               out_dir=out_dir,
                               policy=ShardingPolicy(**pol_kw),
                               tag="__" + tag, overrides=overrides)
    raise KeyError(f"no rung {tag!r} in {pair!r}")


def main(argv=None):
    only = sys.argv[1:] if argv is None else argv
    os.makedirs(OUT, exist_ok=True)
    for pair, arch, shape, ladder in LADDERS:
        if only and pair not in only:
            continue
        print(f"\n===== {pair}: {arch} x {shape} =====", flush=True)
        for tag, hypothesis, _, _ in ladder:
            t0 = time.time()
            rec = run_rung(pair, tag)
            if rec["status"] == "ok":
                r = rec["roofline"]
                print(f"[{time.time()-t0:6.1f}s] {tag}: "
                      f"c={r['compute_s']:.3e} m={r['memory_s']:.3e} "
                      f"x={r['collective_s']:.3e} dom={r['dominant']} "
                      f"useful={r['useful_ratio']:.3f} "
                      f"mem={rec['per_chip_peak_bytes'] / 1e9:.2f}/80GB",
                      flush=True)
            else:
                print(f"[{time.time()-t0:6.1f}s] {tag}: ERROR "
                      f"{rec['error'][:200]}", flush=True)
            print(f"  hypothesis: {hypothesis}", flush=True)


if __name__ == "__main__":
    main()
