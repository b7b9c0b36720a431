"""The window's model operations over its seconds, as a share of 495 TFLOP/s."""
from dndmbench import readers

LAYER = "denoiser (models/)"
UNIT = "%"
MOVES = "tokens_per_s"
SOURCE = "host_clock"


def read(ctx):
    return readers.call_mfu(ctx)
