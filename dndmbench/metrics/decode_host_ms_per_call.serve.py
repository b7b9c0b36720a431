"""The decode's host ms per traced call: ``decode.draw`` (the per-row Gumbel
slab) and ``decode.kernel`` (``decode_tokens`` through its launch), outside
CUDA runtime calls."""
from dndmbench import spans

LAYER = "decode kernels (core/decode.py)"
UNIT = "ms"
MOVES = "latency_p50_s"
SOURCE = "program_span"


def read(ctx):
    return spans.layer_host_ms(ctx, spans.DECODE)
