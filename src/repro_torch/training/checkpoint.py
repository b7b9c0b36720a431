"""Checkpoints in the JAX package's format: flat-path ``.npz`` arrays
plus a JSON manifest (no pickle), as ``repro.training.checkpoint`` writes
and reads them.

``save`` writes a nested dict/list/tuple of torch tensors, numpy arrays
or Python scalars (for a model, the JAX tree that
``models/convert.py::to_jax_tree`` builds, so that the JAX package loads
it).  A dtype numpy lacks (bfloat16) is widened to f32 on disk and kept
in the manifest.  ``load`` restores a nested dict (lists where the keys
are ``[i]``) of numpy arrays; arrays the manifest records in a dtype
numpy lacks come back as torch tensors of that dtype.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

_SEP = "/"
_TORCH_ONLY = {"bfloat16": torch.bfloat16}
_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16",
           "int8", "uint64", "uint32", "uint16", "uint8", "bool"}


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b/[0]": (array on disk, dtype name)}, keys sorted as the JAX
    package sorts them."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{_SEP}{k}" if prefix
                                else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}[{i}]" if prefix
                                else f"[{i}]"))
    elif isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        out[prefix] = ((t.float() if name not in _NATIVE else t).numpy(),
                       name)
    else:
        a = np.asarray(tree)
        name = str(a.dtype)
        out[prefix] = (a.astype(np.float32) if name not in _NATIVE else a,
                       name)
    return out


def save(path: str, tree) -> None:
    """Write ``tree`` to ``path`` (``.npz``, added if missing) and its
    manifest beside it (``.json``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    manifest = {k: {"shape": list(a.shape), "dtype": name}
                for k, (a, name) in flat.items()}
    base = path[:-4] if path.endswith(".npz") else path
    np.savez(base + ".npz", **{k: a for k, (a, _) in flat.items()})
    with open(base + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load(path: str) -> dict:
    base = path[:-4] if path.endswith(".npz") else path
    with open(base + ".json") as f:
        manifest = json.load(f)
    tree: dict = {}
    with np.load(base + ".npz", allow_pickle=False) as npz:
        for key in npz.files:
            parts = key.split(_SEP)
            node = tree
            for p in parts[:-1]:
                idx = int(p[1:-1]) if p.startswith("[") else p
                node = node.setdefault(idx, {})
            last = parts[-1]
            idx = int(last[1:-1]) if last.startswith("[") else last
            arr = npz[key]
            want = manifest.get(key, {}).get("dtype")
            if want and want != str(arr.dtype):
                if want not in _TORCH_ONLY:
                    raise TypeError(f"{key}: cannot restore dtype {want!r}")
                arr = torch.from_numpy(arr).to(_TORCH_ONLY[want])
            node[idx] = arr
    return _lists(tree)


def _lists(node):
    """Convert {0:..,1:..} int-keyed dicts back into lists."""
    if isinstance(node, dict):
        node = {k: _lists(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node[i] for i in range(len(node))]
    return node
