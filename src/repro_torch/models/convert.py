"""Weight bridge between the JAX package's parameter tree and the port's
module state, both ways.

The JAX ``Model.init`` tree is ``{"embed", "ln_f": {"scale"}, "head",
"time": {"w1", "w2"}, "unit": {"b{i}": {...}}}`` where every leaf under
``unit/b{i}`` carries a leading ``n_super`` axis.  Slot ``i`` of
superblock ``j`` is the port's ``blocks[j * len(unit) + i]``.  A Zamba
model's one shared attention block, ``shared/...``, maps onto the port's
``shared.*``; the tree has no ``unit/b{i}`` entry for the shared slot,
and the port's sites there hold no parameters.  Dense weights keep their
``(d_in, d_out)`` layout; every array is copied bitwise.
``to_jax_tree`` is the inverse of ``to_state_dict``: the checkpoint
writer and the trainer's optimizer state go through it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.training import checkpoint


def flatten(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def to_state_dict(params: dict, unit: tuple[str, ...],
                  n_super: int) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state-dict keys."""
    state = {}
    for path, arr in flatten(params).items():
        # a copy: arrays read from an npz or a JAX tree are read-only
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.array(arr))
        parts = path.split("/")
        if parts[0] == "unit":
            i = int(parts[1][1:])
            rest = ".".join(parts[2:])
            if t.shape[0] != n_super:
                raise ValueError(f"{path}: leading axis {t.shape[0]} != "
                                 f"n_super {n_super}")
            for j in range(n_super):
                state[f"blocks.{j * len(unit) + i}.{rest}"] = t[j]
        else:
            state[".".join(parts)] = t
    return state


def to_jax_tree(state: dict, unit: tuple[str, ...], n_super: int) -> dict:
    """The port's state-dict keys -> the JAX parameter tree, the inverse
    of :func:`to_state_dict`: slot ``i`` of every superblock is stacked
    back along a leading ``n_super`` axis at ``unit/b{i}/...``, and every
    other key (``shared.*`` included) becomes its nested path.  Leaves
    are detached tensors, bitwise the inputs."""
    tree: dict = {}
    slots: dict[tuple[int, str], dict[int, torch.Tensor]] = {}
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            j, i = divmod(int(parts[1]), len(unit))
            slots.setdefault((i, ".".join(parts[2:])), {})[j] = t.detach()
        else:
            _put(tree, parts, t.detach())
    for (i, rest), per in slots.items():
        if sorted(per) != list(range(n_super)):
            raise ValueError(f"unit slot {i} {rest}: superblocks "
                             f"{sorted(per)} of {n_super}")
        _put(tree, ["unit", f"b{i}", *rest.split(".")],
             torch.stack([per[j] for j in range(n_super)]))
    return tree


def jax_path(name: str, unit: tuple[str, ...]) -> tuple[str, bool]:
    """The JAX tree path of the port's parameter ``name`` and whether the
    leaf there is stacked along ``n_super`` (``blocks.{k}.rest`` is slot
    ``k % len(unit)`` of ``unit/b{i}/rest``), as :func:`to_jax_tree`
    places it."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return "/".join(parts), False
    return "/".join(["unit", f"b{int(parts[1]) % len(unit)}", *parts[2:]]), \
        True


def _put(tree: dict, parts: list[str], leaf) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = leaf


def load_params(model, params: dict) -> None:
    """Copy a JAX parameter tree into ``model`` in place.  Every module
    parameter must be covered and every array must fit exactly."""
    _copy_exact(model, to_state_dict(params, model.unit, model.n_super))


def load_tree(module, tree: dict) -> None:
    """Copy an unstacked JAX parameter tree (one block's or one layer's,
    e.g. ``repro.models.mamba2.init``'s) into ``module`` in place, under
    the same rule as :func:`load_params`."""
    _copy_exact(module, {path.replace("/", "."): torch.from_numpy(
        np.array(arr)) for path, arr in flatten(tree).items()})


def _copy_exact(module, state: dict) -> None:
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"parameter mismatch: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in own.items():
            src = state[name]
            if src.shape != p.shape or src.dtype != p.dtype:
                raise ValueError(f"{name}: {tuple(src.shape)} {src.dtype} "
                                 f"does not fit {tuple(p.shape)} {p.dtype}")
            p.copy_(src)


def load_checkpoint(model, path: str) -> None:
    """Load a JAX checkpoint (``.npz`` + ``.json`` manifest) into
    ``model``."""
    load_params(model, checkpoint.load(path))


def save_checkpoint(model, path: str) -> None:
    """Write ``model``'s parameters as the JAX package's checkpoint
    (``.npz`` + ``.json`` manifest, the JAX tree's keys), which
    ``repro.training.checkpoint.load`` and :func:`load_checkpoint` read."""
    checkpoint.save(path, to_jax_tree(dict(model.named_parameters()),
                                      model.unit, model.n_super))
