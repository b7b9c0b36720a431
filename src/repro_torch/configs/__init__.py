"""Config registry: ``--arch <id>`` ids -> ModelConfig factories.

The port carries the paper's two models and the Mamba-2 hybrid
``zamba2-2.7b``; the rest of the architecture zoo of ``repro.configs``
comes with a later slice.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "dndm-text8": "dndm_text8",
    "dndm-mt": "dndm_mt",
    "zamba2-2.7b": "zamba2_2p7b",
}


def get(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.get_config()


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


__all__ = ["get", "list_archs"]
