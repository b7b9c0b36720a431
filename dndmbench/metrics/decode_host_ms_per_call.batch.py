"""The decode's host ms per traced call: ``decode.draw`` (the Gumbel slab) and
``decode.kernel`` (``fused_update`` through its launch), outside CUDA
runtime calls."""
from dndmbench import spans

LAYER = "decode kernels (core/decode.py)"
UNIT = "ms"
MOVES = "tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    return spans.layer_host_ms(ctx, spans.DECODE)
