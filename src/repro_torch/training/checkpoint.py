"""Read the JAX package's checkpoints: flat-path ``.npz`` arrays plus a
JSON manifest (no pickle), as written by ``repro.training.checkpoint.save``.

Restores a nested dict (lists where the keys are ``[i]``) of numpy arrays.
Arrays the manifest records in a dtype numpy lacks (bfloat16 is widened
to f32 on disk) come back as torch tensors of that dtype.  Writing
checkpoints comes with the training slice.
"""
from __future__ import annotations

import json

import numpy as np
import torch

_SEP = "/"
_TORCH_ONLY = {"bfloat16": torch.bfloat16}


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
