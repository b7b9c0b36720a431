"""Model zoo of the port.  This slice has the paper's dense transformer
denoiser (``attn``/``swa`` blocks); the other block kinds come with later
slices."""
