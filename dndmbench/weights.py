"""The weights of a run, made on the device from the run's seed in two
large draws (one normal, one uniform) and cut into the checkpoint layout
that the configuration's reference (``reference/model.py`` by default)
reads and the program loads (``repro_torch.models.convert.load_params``).
The reference gives the leaves and their order (``param_shapes``), and
may give a leaf its own law: its ``leaf_rule(path, shape, c)`` returns
``(kind, scale, offset)`` as :func:`_leaf_rule` does, or None for the
default laws.  Every leaf is a view of the two flat buffers; the
default laws:

* dense weights (d_in, d_out): normal / sqrt(d_in); the residual
  branches' output projections (``wo``, ``down``, ``out_proj``) also
  times 1 / sqrt(n_layers), so the residual stream stays of order one
  over 54 layers; the head normal / sqrt(d), so logits are of order one;
* the embedding normal; RMSNorm scales and Mamba-2's D 1 + 0.1 normal;
  the conv taps normal / sqrt(width), its bias 0.1 normal;
* Mamba-2's A_log = log(A), A uniform on [1, 16], and dt_bias the
  inverse softplus of a dt log-uniform on [0.001, 0.1] (Mamba-2's
  initialisation ranges).
"""
from __future__ import annotations

import math

import torch

from dndmbench.reference import model as ref_model

_RESIDUAL_OUT = ("attn/wo", "mlp/down", "mixer/out_proj")


def _leaf_rule(path: str, shape: tuple, c: dict):
    """(kind, scale, offset) of a leaf: kind "normal" or one of the
    uniform-derived laws."""
    name = path.split("/", 2)[-1] if path.startswith("unit/") else path
    if name.endswith("A_log"):
        return "a_log", 0.0, 0.0
    if name.endswith("dt_bias"):
        return "dt_bias", 0.0, 0.0
    if name.endswith("scale") or name.endswith("mixer/D"):
        return "normal", 0.1, 1.0
    if name.endswith("conv_b"):
        return "normal", 0.1, 0.0
    if name.endswith("conv_w"):
        return "normal", 1.0 / math.sqrt(shape[-2]), 0.0
    if name == "embed":
        return "normal", 1.0, 0.0
    d_in = shape[-2]
    s = 1.0 / math.sqrt(d_in)
    if any(name.endswith(k) for k in _RESIDUAL_OUT):
        s /= math.sqrt(c["n_layers"])
    return "normal", s, 0.0


def make(c: dict, seed: int, device, reference=ref_model) -> dict:
    """The nested parameter dict of configuration ``c`` (a config file's
    ``model``) from ``seed``, with the leaves of ``reference``."""
    shapes = reference.param_shapes(c)
    own = getattr(reference, "leaf_rule", lambda path, shape, c: None)
    rules = {p: own(p, s, c) or _leaf_rule(p, s, c)
             for p, s in shapes.items()}
    sizes = {p: math.prod(s) for p, s in shapes.items()}
    n_norm = sum(sizes[p] for p in shapes if rules[p][0] == "normal")
    n_unif = sum(sizes[p] for p in shapes if rules[p][0] != "normal")
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    normal = torch.randn(n_norm, generator=g, device=device,
                         dtype=torch.float32)
    unif = torch.rand(max(n_unif, 1), generator=g, device=device,
                      dtype=torch.float32)
    tree: dict = {}
    on, ou = 0, 0
    with torch.no_grad():
        for p, shape in shapes.items():
            kind, scale, offset = rules[p]
            n = sizes[p]
            if kind == "normal":
                leaf = normal[on:on + n].view(shape)
                on += n
                leaf.mul_(scale).add_(offset)
            else:
                leaf = unif[ou:ou + n].view(shape)
                ou += n
                if kind == "a_log":
                    leaf.mul_(15.0).add_(1.0).log_()
                else:
                    dt = torch.exp(leaf * (math.log(0.1) - math.log(1e-3))
                                   + math.log(1e-3))
                    leaf.copy_(dt + torch.log(-torch.expm1(-dt)))
            node = tree
            parts = p.split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = leaf
    return tree
