"""tinyllama-1.1b [dense] — llama2-architecture small [arXiv:2401.02385].
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.models.config import ModelConfig, dense_pattern


def get_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", arch_type="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=5632, vocab_size=32000,
        block_pattern=dense_pattern(22),
        paper="arXiv:2401.02385",
    )
