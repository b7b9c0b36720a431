"""The scheduler's host ms per traced call: the self time of
``scheduler.pump``, ``runner.admit`` and ``engine.plan`` (a request's plan
at submit), outside CUDA runtime calls."""
from dndmbench import spans

LAYER = "scheduler (serving/scheduler.py)"
UNIT = "ms"
MOVES = "latency_p50_s"
SOURCE = "program_span"


def read(ctx):
    return spans.layer_host_ms(ctx, spans.SCHED_SERVE)
