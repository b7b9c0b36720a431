"""phi3-mini-3.8b [dense] — RoPE + SwiGLU + GQA [arXiv:2404.14219].
32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.models.config import ModelConfig, dense_pattern


def get_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", arch_type="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32064,
        block_pattern=dense_pattern(32),
        paper="arXiv:2404.14219",
    )
