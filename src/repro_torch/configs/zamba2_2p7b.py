"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].  54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64.  Unit: 5 Mamba2 layers + 1 shared-weight
attention block (the Zamba trick: one global attention parameter set
reused at every application site), repeated 9x = 54 layers.
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    unit = ("mamba2",) * 5 + ("shared_attn",)
    return ModelConfig(
        name="zamba2-2.7b", arch_type="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab_size=32000,
        block_pattern=unit * 9,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssd_chunk=128,
        paper="arXiv:2411.15242",
    )
