"""Modality frontend stubs, the port of ``repro/models/frontend.py``.

For [audio] (MusicGen) and [vlm] (Chameleon) the repo implements the
language / decoder transformer only.  The conv codec (EnCodec) and the
vision encoder (VQ tokenizer) are represented by precomputed embeddings
of the right shape, (batch, ``cfg.frontend_tokens``, d_model), made here
from a seeded generator.

``frontend_embeds`` occupy the first ``cfg.frontend_tokens`` positions of
the sequence (early fusion): the model overwrites its token embeddings at
those positions with the given vectors.  ``frontend_spec`` is the dry
run's shape-only stand-in (``launch/dryrun.py``).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def fake_frontend_embeds(generator: torch.Generator, cfg: ModelConfig,
                         batch: int, device=None) -> torch.Tensor | None:
    """Stand-in for EnCodec frames / ViT patch embeddings: a standard
    normal times 0.02 in ``cfg.dtype``; ``None`` without a frontend."""
    if not cfg.frontend:
        return None
    return torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                       generator=generator, device=device,
                       dtype=getattr(torch, cfg.dtype)) * 0.02


def frontend_spec(cfg: ModelConfig, batch: int, mesh=None,
                  placements=None) -> torch.Tensor | None:
    """A shape-only (batch, ``cfg.frontend_tokens``, d_model) stand-in in
    ``cfg.dtype`` for the dry run, ``None`` without a frontend: a fake
    tensor inside a fake tensor mode (``torch.empty`` allocates nothing
    there), else a meta tensor.  With a ``mesh`` it is a DTensor placed
    by ``placements``."""
    if not cfg.frontend:
        return None
    from torch._guards import detect_fake_mode
    spec = torch.empty((batch, cfg.frontend_tokens, cfg.d_model),
                       dtype=getattr(torch, cfg.dtype),
                       device="cpu" if detect_fake_mode() else "meta")
    if mesh is None:
        return spec
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(spec, mesh, placements, src_data_rank=None)


def fuse(h: torch.Tensor,
         frontend_embeds: torch.Tensor | None) -> torch.Tensor:
    """Early fusion: overwrite the first F positions of h (B, S, d)."""
    if frontend_embeds is None:
        return h
    F = frontend_embeds.shape[1]
    return torch.cat([frontend_embeds.to(h.dtype), h[:, F:]], dim=1)
