"""Device resolution shared by the port's entry points.

``Model``, ``GenerationEngine``, ``BatchScheduler`` and
``launch/serve.py`` run on ``cuda`` unless the caller names another
device (the CPU tests pass ``device="cpu"``).  Without a GPU and without
a device they raise: nothing falls back to the CPU silently.

``is_sharded``, ``full``, ``local_block``, ``gather_last`` and
``take_rows`` read the DTensors of a model sharded over a mesh
(``launch/sharding.py``) on plain tensors and DTensors alike; the
sharded forms of the model's layers are in ``launch/spmd.py``.
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


class AllReduce(torch.autograd.Function):
    """The sum over ``group``.  The output is replicated, so each rank's
    gradient is the output's, unchanged (the reference's psum)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def local_block(t) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(shape, offset) of this rank's block of the evenly sharded DTensor
    ``t``: a dim sharded over several mesh dims is split by each in mesh
    order, major first, as DTensor places it.  Reads only the mesh
    coordinates, so it works on fake tensors too."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    shape, off = list(t.shape), [0] * t.dim()
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            shape[p.dim] //= mesh.size(i)
            off[p.dim] += mesh.get_local_rank(i) * shape[p.dim]
    return tuple(shape), tuple(off)


def gather_last(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[..., idx]`` element by element: ``t`` (..., V), ``idx`` (...).
    DTensor ``t`` (placed as ``idx``, V whole) is gathered block by block:
    DTensor's own gather backward builds its zeros whole and replicated
    when the batch is sharded over two mesh axes (the multi-pod mesh)."""
    if is_sharded(t):
        out = torch.gather(t.to_local(), -1,
                           idx.to_local().long()[..., None])[..., 0]
        return DTensor.from_local(out, t.device_mesh, idx.placements)
    return torch.gather(t, -1, idx.long()[..., None])[..., 0]


def take_rows(t: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Rows ``lo .. lo + n`` of ``t``.  A DTensor's slice of its sharded
    dim 0 comes back whole on every rank: it is placed as ``t`` again
    (the rows are the same; each rank keeps its share)."""
    sub = t[lo:lo + n]
    if is_sharded(t) and sub.placements != t.placements:
        sub = sub.redistribute(t.device_mesh, t.placements)
    return sub
