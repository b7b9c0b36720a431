"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].  48L d_model=5120 40H (GQA kv=8)
expert d_ff=8192 vocab=202048.
"""
from repro_torch.models.config import ModelConfig, moe_pattern


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", arch_type="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202048,
        block_pattern=moe_pattern(48),
        n_experts=128, experts_per_token=1,
        rope_theta=5e5,
        paper="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
