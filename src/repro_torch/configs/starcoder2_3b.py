"""starcoder2-3b [dense] — GQA + RoPE code model [arXiv:2402.19173].
30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.  GeLU MLP.
"""
from repro_torch.models.config import ModelConfig, dense_pattern


def get_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", arch_type="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab_size=49152,
        block_pattern=dense_pattern(30),
        mlp_type="gelu", rope_theta=1e5,
        paper="arXiv:2402.19173",
    )
