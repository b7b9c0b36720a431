"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].
24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.  xLSTM blocks carry
their own up/down projections, so d_ff=0 (no separate FFN).  Ratio ~5:1
mLSTM:sLSTM (the paper's large models are mLSTM-dominant).
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    unit = ("mlstm",) * 5 + ("slstm",)
    return ModelConfig(
        name="xlstm-350m", arch_type="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_pattern=unit * 4,
        lstm_heads=4,
        paper="arXiv:2405.04517",
    )
