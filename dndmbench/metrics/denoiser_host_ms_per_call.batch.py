"""The denoiser's host ms per traced call: ``model.forward`` with its
``model.block`` children, outside CUDA runtime calls."""
from dndmbench import spans

LAYER = "denoiser (models/)"
UNIT = "ms"
MOVES = "tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    return spans.layer_host_ms(ctx, spans.DENOISER)
