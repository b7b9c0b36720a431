"""The paper's conditional MT setup adapted to the decoder-only early-
fusion form: source prefix + target canvas, bidirectional attention
(paper §4.1 uses a FairSeq encoder-decoder; this realizes the same
q(x0 | x_t, z) with prefix conditioning).
"""
from repro_torch.models.config import ModelConfig, dense_pattern


def get_config() -> ModelConfig:
    return ModelConfig(
        name="dndm-mt", arch_type="dense",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab_size=28,
        block_pattern=dense_pattern(6),
        bidirectional=True,
        paper="DNDM paper §4.1 (RDM/FairSeq-scale transformer)",
    )
