"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].  48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 (EnCodec codebook).  The EnCodec conv codec is the allowed
frontend STUB: input_specs() provides precomputed conditioning frame
embeddings occupying the first ``frontend_tokens`` positions.
"""
from repro_torch.models.config import ModelConfig, dense_pattern


def get_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", arch_type="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=2048,
        block_pattern=dense_pattern(48),
        mlp_type="gelu",
        frontend="audio", frontend_tokens=128,
        paper="arXiv:2306.05284",
    )
