"""The engine's and the sampler loop's host ms per traced call: the self time
of ``engine.generate`` and ``sampler.call``, outside CUDA runtime calls."""
from dndmbench import spans

LAYER = "engine (serving/engine.py)"
UNIT = "ms"
MOVES = "tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    return spans.layer_host_ms(ctx, spans.ENGINE_BATCH)
