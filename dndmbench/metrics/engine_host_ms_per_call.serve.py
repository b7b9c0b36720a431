"""The engine's host ms per traced call: the self time of ``engine.stepwise``,
``runner.inputs`` and ``runner.harvest``, outside CUDA runtime calls."""
from dndmbench import spans

LAYER = "engine (serving/engine.py)"
UNIT = "ms"
MOVES = "latency_p50_s"
SOURCE = "program_span"


def read(ctx):
    return spans.layer_host_ms(ctx, spans.ENGINE_SERVE)
