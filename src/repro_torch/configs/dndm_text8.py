"""The paper's own unconditional model: 12-layer decoder-only Transformer
for text8-style character diffusion (paper §4.2), 27 chars + [MASK].
"""
from repro_torch.models.config import ModelConfig, dense_pattern


def get_config() -> ModelConfig:
    return ModelConfig(
        name="dndm-text8", arch_type="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=28,
        block_pattern=dense_pattern(12),
        bidirectional=True,
        paper="DNDM paper §4.2 (Hoogeboom-style 12L Transformer)",
    )
