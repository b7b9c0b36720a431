"""Config registry: ``--arch <id>`` ids -> ModelConfig factories.

The port's own copy of ``repro.configs``: the ten assigned architectures
(public-literature pool) plus the paper's own models, with the same ids,
fields and order.  ``for_long_context`` swaps full attention for
sliding-window attention, the documented substitute that makes
``long_500k`` lowerable for otherwise-quadratic architectures.  Every
config builds a ``Model``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs import shapes
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "xlstm-350m": "xlstm_350m",
    "mixtral-8x7b": "mixtral_8x7b",
    "musicgen-large": "musicgen_large",
    "starcoder2-3b": "starcoder2_3b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "deepseek-7b": "deepseek_7b",
    "chameleon-34b": "chameleon_34b",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "dndm-text8": "dndm_text8",
    "dndm-mt": "dndm_mt",
}

ASSIGNED_ARCHS = tuple(list(_ARCH_MODULES)[:10])


def get(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.get_config()


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


LONG_CONTEXT_WINDOW = 4096


def for_long_context(cfg: ModelConfig) -> ModelConfig:
    """Sub-quadratic variant for long_500k decode.

    SSM / hybrid / SWA architectures are already sub-quadratic; pure
    full-attention blocks are swapped for sliding-window ("swa") blocks
    with a 4k window (the documented dense-arch substitute).  Zamba's
    shared attention keeps its full span.
    """
    pattern = tuple("swa" if k == "attn" else k for k in cfg.block_pattern)
    window = cfg.sliding_window or LONG_CONTEXT_WINDOW
    return cfg.replace(block_pattern=pattern, sliding_window=window)


__all__ = ["get", "list_archs", "ASSIGNED_ARCHS", "SHAPES", "InputShape",
           "shapes", "for_long_context", "LONG_CONTEXT_WINDOW"]
