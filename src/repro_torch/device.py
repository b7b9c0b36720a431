"""Device resolution shared by the port's entry points.

``Model``, ``GenerationEngine``, ``BatchScheduler`` and
``launch/serve.py`` run on ``cuda`` unless the caller names another
device (the CPU tests pass ``device="cpu"``).  Without a GPU and without
a device they raise: nothing falls back to the CPU silently.

``is_sharded`` and ``full`` read the DTensors of a model sharded over a
mesh (``launch/sharding.py``).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which
    must exist.  A CUDA device gets its index (``cuda`` -> ``cuda:0``), so
    that devices compare equal to the devices of the tensors on them."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor."""
    return isinstance(t, DTensor)


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (a collective), else ``t``."""
    return t.full_tensor() if is_sharded(t) else t
