"""Block registry of the port, with pre-norm residual wiring.

The attention-family blocks ("attn", "swa", "moe", and "shared_attn",
which is an "attn" block whose one weight set the model reuses at every
site):

    h = rmsnorm(x);  x = x + attention(h)
    h = rmsnorm(x);  x = x + mlp(h)        # "moe": x + moe(h)

"swa" blocks always window and "moe" blocks window when the config sets
``sliding_window`` (Mixtral: sliding-window attention and MoE in one
layer).  The mixer blocks, "mamba2" (Mamba-2), "mlstm" and "slstm"
(xLSTM), bidirectional in denoiser mode:

    x = x + mixer(rmsnorm(x))

Every block's ``forward(x, causal=...)`` returns ``(x, aux)``: a "moe"
block's aux losses, ``None`` for every other block.  Every block also has
``init_cache(batch, max_seq, dtype)`` and ``decode(x, cache, pos)``, one
token (B, 1, d) at position ``pos`` (a Python int), causal, with the
cache updated in place: a ring buffer of keys and values for the
attention family (the window's length for windowed blocks, so it wraps
past the window), the recurrent state for the mixers.  Each branch
joins the residual stream through ``_add``, which the sharded forms of
``launch/spmd.py`` override (installed by ``launch/sharding.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, RMSNorm
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.moe import MoE
from repro_torch.models.xlstm import MLSTM, SLSTM


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

    def _ffn(self, x: torch.Tensor) -> tuple[torch.Tensor, dict | None]:
        if self.moe is not None:
            y, aux = self.moe(self.ln2(x))
            return x + y, aux
        if self.mlp is not None:
            x = self._add(x, self.mlp(self.ln2(x)))
        return x, None

    @staticmethod
    def _add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """A branch's output ``y`` added to the residual stream ``x``."""
        return x + y

    def forward(self, x: torch.Tensor, *,
                causal: bool) -> tuple[torch.Tensor, dict | None]:
        x = self._add(x, self.attn(self.ln1(x), causal=causal,
                                   window=self.window))
        return self._ffn(x)

    def init_cache(self, batch: int, max_seq: int, dtype) -> dict:
        return self.attn.init_cache(batch, max_seq, self.window, dtype)

    def decode(self, x: torch.Tensor, cache: dict, pos: int) -> torch.Tensor:
        x = self._add(x, self.attn.decode_step(self.ln1(x), cache, pos,
                                               self.window))
        return self._ffn(x)[0]


class MixerBlock(nn.Module):
    """"mamba2", "mlstm" or "slstm" block: ``x + mixer(rmsnorm(x))``,
    running both ways unless causal."""

    MIXERS = {"mamba2": Mamba2, "mlstm": MLSTM, "slstm": SLSTM}

    def __init__(self, kind: str, generator, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, getattr(torch, cfg.dtype), device,
                          cfg.norm_eps)
        self.mixer = self.MIXERS[kind](generator, cfg, device)

    _add = staticmethod(AttnBlock._add)

    def forward(self, x: torch.Tensor, *,
                causal: bool) -> tuple[torch.Tensor, None]:
        return self._add(x, self.mixer(self.ln(x),
                                       bidirectional=not causal)), None

    def init_cache(self, batch: int, max_seq: int, dtype) -> dict:
        return self.mixer.init_cache(batch, dtype)

    def decode(self, x: torch.Tensor, cache: dict, pos: int) -> torch.Tensor:
        return self._add(x, self.mixer.decode(self.ln(x), cache))


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
    if kind in MixerBlock.MIXERS:
        return MixerBlock(kind, generator, cfg, device)
    raise KeyError(kind)
