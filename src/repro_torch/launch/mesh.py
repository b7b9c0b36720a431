"""Device meshes of the port: torch ``DeviceMesh`` in place of
``jax.sharding.Mesh``.

Single pod: (16, 16) = ("data", "model"); multi-pod: (2, 16, 16) =
("pod", "data", "model") — the JAX package's production shapes.  A mesh
needs a process group of as many ranks as it has devices, one process
per device (``torchrun``), where JAX runs one process over all of them.

The helpers take either a ``DeviceMesh`` (``shape`` a tuple, names in
``mesh_dim_names``) or a metadata stand-in with ``shape`` a dict of axis
sizes and ``axis_names``, as the sharding rules need no devices:
:func:`axis_names` and :func:`axis_sizes` are the one place that reads
either.

``use_mesh`` makes a mesh ambient, the counterpart of ``jax.set_mesh``:
the MoE layer's "shard_map" dispatch reads it through
:func:`current_mesh`.

``fake_world(n)`` opens a process group of ``n`` ranks in one process, as
rank 0, for the dry run (``launch/dryrun.py``): PyTorch's "fake" backend
completes every collective at once without moving data, so
``make_production_mesh(device_type="cpu")`` builds the 256- or 512-rank
mesh on fake tensors.  Its rendezvous store, ``FakeStore``, lives in
``torch.testing._internal.distributed.fake_pg``, an internal module of
PyTorch, the one the fake backend is registered with.
"""
from __future__ import annotations

import contextlib
import math

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

_ambient: list = []


def make_mesh(shape, axis_names, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group, whose
    world size must be the product of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) or (2, 16, 16) production mesh; raises unless the
    process group holds exactly that many ranks."""
    import torch.distributed as dist
    shape, axes = PRODUCTION[multi_pod]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return make_mesh(shape, axes, device_type)


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0, for the
    block (module docstring); destroyed on exit.  Raises if a process
    group is already open."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process "
                           "group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size}, in the mesh's axis order."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: shape[a] for a in axis_names(mesh)}
    return dict(zip(axis_names(mesh), shape))


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes used for data parallelism: ("pod", "data") or ("data",)."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def axis_size(mesh, *names: str) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[n] for n in names)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block (nestable)."""
    _ambient.append(mesh)
    try:
        yield mesh
    finally:
        _ambient.pop()


def current_mesh():
    """The innermost ambient mesh, or None."""
    return _ambient[-1] if _ambient else None
