"""dndm_update's bytes (logits, Gumbel slab, mask, x, tau, out) at 3.35 TB/s over its device time."""
from dndmbench import readers

LAYER = "decode kernels (core/decode.py)"
UNIT = "%"
MOVES = "tokens_per_s"
SOURCE = "device_trace"
# the kernels timed, by a part of their names in the trace
KERNELS = ("dndm_update_",)


def read(ctx):
    return readers.roofline(ctx, KERNELS, KERNELS[0],
                            readers.decode_bound(ctx, "dndm_update"))
