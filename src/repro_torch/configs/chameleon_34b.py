"""chameleon-34b [vlm] — early-fusion mixed-modal transformer over text +
VQ image tokens [arXiv:2405.09818].  48L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=65536.  The VQ image encoder is the allowed frontend
STUB: input_specs() supplies precomputed patch embeddings fused into the
first ``frontend_tokens`` positions.
"""
from repro_torch.models.config import ModelConfig, dense_pattern


def get_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", arch_type="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab_size=65536,
        block_pattern=dense_pattern(48),
        frontend="vision", frontend_tokens=512,
        paper="arXiv:2405.09818",
    )
