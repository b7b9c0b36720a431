"""Weight bridge: JAX package parameters -> the port's module state.

The JAX ``Model.init`` tree is ``{"embed", "ln_f": {"scale"}, "head",
"time": {"w1", "w2"}, "unit": {"b{i}": {...}}}`` where every leaf under
``unit/b{i}`` carries a leading ``n_super`` axis.  Slot ``i`` of
superblock ``j`` is the port's ``blocks[j * len(unit) + i]``.  A Zamba
model's one shared attention block, ``shared/...``, maps onto the port's
``shared.*``; the tree has no ``unit/b{i}`` entry for the shared slot,
and the port's sites there hold no parameters.  Dense weights keep their
``(d_in, d_out)`` layout; every array is copied bitwise.
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
