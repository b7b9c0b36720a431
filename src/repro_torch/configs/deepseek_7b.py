"""deepseek-7b [dense] — llama-architecture [arXiv:2401.02954].
30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400.
"""
from repro_torch.models.config import ModelConfig, dense_pattern


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", arch_type="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab_size=102400,
        block_pattern=dense_pattern(30),
        paper="arXiv:2401.02954",
    )
