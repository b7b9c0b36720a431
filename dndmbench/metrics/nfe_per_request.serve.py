"""Mean Request.nfe of the requests completed in the window."""
LAYER = "sampler (core/samplers/)"
UNIT = "calls"
MOVES = "latency_p50_s"
SOURCE = "program_counter"


def read(ctx):
    return (sum(r['nfe'] for r in ctx.completed_in_window) / len(ctx.completed_in_window) if ctx.completed_in_window else None)
