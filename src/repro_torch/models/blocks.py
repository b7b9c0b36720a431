"""Block registry of the port: the attention-family blocks ("attn",
"swa") with pre-norm residual wiring.

    h = rmsnorm(x);  x = x + attention(h)
    h = rmsnorm(x);  x = x + mlp(h)

"moe", "mamba2", "mlstm", "slstm" and "shared_attn" blocks come with
later slices (the model zoo, and Mamba-2 with the ``ssd_scan`` kernel).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, RMSNorm

_LATER = {
    "moe": "the model-zoo slice (mixture-of-experts MLP)",
    "mamba2": "the Mamba-2 slice, with the ssd_scan kernel",
    "mlstm": "the model-zoo slice (xLSTM)",
    "slstm": "the model-zoo slice (xLSTM)",
    "shared_attn": "the model-zoo slice (Zamba shared attention)",
}


class AttnBlock(nn.Module):
    """"attn"/"swa" block: windowed iff ``window > 0``."""

    def __init__(self, generator, cfg: ModelConfig, window: int,
                 device=None):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        self.window = window
        # draw order of repro.models.blocks._attn_init: attention, then mlp
        self.ln1 = RMSNorm(cfg.d_model, dt, device, cfg.norm_eps)
        self.attn = Attention(generator, cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device, cfg.norm_eps)
        self.mlp = (MLP(generator, cfg.d_model, cfg.d_ff, cfg.mlp_type, dt,
                        device) if cfg.d_ff > 0 else None)

    def forward(self, x: torch.Tensor, *, causal: bool) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), causal=causal, window=self.window)
        if self.mlp is not None:
            x = x + self.mlp(self.ln2(x))
        return x


def build(kind: str, generator, cfg: ModelConfig, device=None) -> nn.Module:
    if kind == "attn":
        return AttnBlock(generator, cfg, 0, device)
    if kind == "swa":
        return AttnBlock(generator, cfg, cfg.sliding_window, device)
    if kind in _LATER:
        raise NotImplementedError(
            f"{kind!r} blocks are not ported yet; they come with {_LATER[kind]}")
    raise KeyError(kind)
