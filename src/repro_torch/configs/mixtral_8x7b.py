"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000.
"""
from repro_torch.models.config import ModelConfig, moe_pattern


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", arch_type="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        block_pattern=moe_pattern(32),
        n_experts=8, experts_per_token=2,
        sliding_window=4096, rope_theta=1e6,
        paper="arXiv:2401.04088",
    )
