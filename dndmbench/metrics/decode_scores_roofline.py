"""decode_scores' bytes (logits, Gumbel slab, mask, outputs) at 3.35 TB/s over its device time."""
from dndmbench import readers

LAYER = "decode kernels (core/decode.py)"
UNIT = "%"
MOVES = "latency_p50_s"
SOURCE = "device_trace"
# the kernels timed, by a part of their names in the trace
KERNELS = ("decode_scores_",)


def read(ctx):
    return readers.roofline(ctx, KERNELS, KERNELS[0],
                            readers.decode_bound(ctx, "decode_scores"))
