"""Mean NFE of the window's batches."""
LAYER = "sampler (core/samplers/)"
UNIT = "calls"
MOVES = "tokens_per_s"
SOURCE = "program_counter"


def read(ctx):
    return (sum(b['nfe'] for b in ctx.batches) / len(ctx.batches) if ctx.batches else None)
