"""Block registry of the port, with pre-norm residual wiring.

The attention-family blocks ("attn", "swa", "moe", and "shared_attn",
which is an "attn" block whose one weight set the model reuses at every
site):

    h = rmsnorm(x);  x = x + attention(h)
    h = rmsnorm(x);  x = x + mlp(h)        # "moe": x + moe(h)

"swa" blocks always window and "moe" blocks window when the config sets
``sliding_window`` (Mixtral: sliding-window attention and MoE in one
layer).  The Mamba-2 block ("mamba2"), bidirectional in denoiser mode:

    x = x + mamba2(rmsnorm(x))

Every block's ``forward(x, causal=...)`` returns ``(x, aux)``: a "moe"
block's aux losses, ``None`` for every other block.  "mlstm" and
"slstm" blocks come with the next model-zoo slice (xLSTM).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, RMSNorm
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.moe import MoE

_LATER = {
    "mlstm": "the next model-zoo slice (xLSTM)",
    "slstm": "the next model-zoo slice (xLSTM)",
}


class AttnBlock(nn.Module):
    """"attn"/"swa"/"shared_attn"/"moe" block: windowed iff ``window > 0``;
    with ``moe`` the MLP is the mixture of experts."""

    def __init__(self, generator, cfg: ModelConfig, window: int,
                 device=None, moe: bool = False):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        self.window = window
        # draw order of repro.models.blocks._attn_init: attention, then
        # the moe or the mlp
        self.ln1 = RMSNorm(cfg.d_model, dt, device, cfg.norm_eps)
        self.attn = Attention(generator, cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device, cfg.norm_eps)
        self.moe = MoE(generator, cfg, device) if moe else None
        self.mlp = (MLP(generator, cfg.d_model, cfg.d_ff, cfg.mlp_type, dt,
                        device) if cfg.d_ff > 0 and not moe else None)

    def forward(self, x: torch.Tensor, *,
                causal: bool) -> tuple[torch.Tensor, dict | None]:
        x = x + self.attn(self.ln1(x), causal=causal, window=self.window)
        if self.moe is not None:
            y, aux = self.moe(self.ln2(x))
            return x + y, aux
        if self.mlp is not None:
            x = x + self.mlp(self.ln2(x))
        return x, None


class Mamba2Block(nn.Module):
    """"mamba2" block: ``x + mamba2(rmsnorm(x))``, scanning both ways
    unless causal."""

    def __init__(self, generator, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, getattr(torch, cfg.dtype), device,
                          cfg.norm_eps)
        self.mixer = Mamba2(generator, cfg, device)

    def forward(self, x: torch.Tensor, *,
                causal: bool) -> tuple[torch.Tensor, None]:
        return x + self.mixer(self.ln(x), bidirectional=not causal), None


def build(kind: str, generator, cfg: ModelConfig, device=None) -> nn.Module:
    """A block's module.  A "shared_attn" block built here holds the one
    weight set that ``Model`` reuses at every "shared_attn" site."""
    if kind in ("attn", "shared_attn"):
        return AttnBlock(generator, cfg, 0, device)
    if kind == "swa":
        return AttnBlock(generator, cfg, cfg.sliding_window, device)
    if kind == "moe":
        return AttnBlock(generator, cfg, cfg.sliding_window, device,
                         moe=True)
    if kind == "mamba2":
        return Mamba2Block(generator, cfg, device)
    if kind in _LATER:
        raise NotImplementedError(
            f"{kind!r} blocks are not ported yet; they come with {_LATER[kind]}")
    raise KeyError(kind)
