"""flash_attention's bound (FLOPs at 495 TFLOP/s or q, k, v, o bytes at 3.35 TB/s) over its device time."""
from dndmbench import readers

LAYER = "attention kernel (kernels/flash_attention)"
UNIT = "%"
MOVES = "tokens_per_s"
SOURCE = "device_trace"
# the kernels timed, by a part of their names in the trace
KERNELS = ("flash_attention_kernel",)


def read(ctx):
    return readers.roofline(ctx, KERNELS, KERNELS[0], readers.flash_bound(ctx))
