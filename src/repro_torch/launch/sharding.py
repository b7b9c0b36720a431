"""Declarative sharding rules: parameter path / activation -> partition
spec, the port's copy of ``repro.launch.sharding``, and their application
to a model as DTensors.

A spec is a tuple with one entry per tensor dim: None (replicated), an
axis name, or a tuple of axis names (sharded over each, major first) —
a ``PartitionSpec`` without JAX, trailing Nones dropped.  The rules are
keyed on the JAX package's tree path and shape (a layer's leaves under
``unit/b{i}/...`` carry a leading ``n_super`` axis), so the two packages'
rules compare leaf by leaf; :func:`shard_module` maps each of the port's
parameter names onto that path through the weight bridge
(``models/convert.py``).

``ShardingPolicy`` is the tuning surface: every change of a sharding
scheme changes exactly one field.  Every rule degrades gracefully: an
axis applies only when the dim divides by its size (``_ok``), otherwise
the dim is replicated.
"""
from __future__ import annotations

import dataclasses
import re

from torch import nn

from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Baseline = classic Megatron-style TP + DP, expert-parallel MoE."""

    attn_tp: bool = True             # shard attention heads on "model"
    mlp_tp: bool = True              # shard d_ff on "model"
    moe_expert_parallel: bool = True  # experts on "model" when divisible
    ssm_tp: bool = False             # baseline: SSM/xLSTM blocks replicated
    embed_vocab_shard: bool = True   # embedding rows on "model"
    # activations
    shard_seq_train: bool = False    # sequence parallelism on "data"
    decode_cache_seq: str = "auto"   # "auto": shard cache seq on "data"
    #   when the batch is too small to fill the data axis; "always"/"never"
    logits_vocab_shard: bool = True


def _ok(dim: int, mesh, *axes: str) -> bool:
    sizes = axis_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return dim % size == 0 and size > 1


def _spec(mesh, shape, assignment: dict[int, tuple[str, ...]]) -> tuple:
    """Build a spec, dropping non-divisible assignments."""
    names = axis_names(mesh)
    entries = []
    for i, dim in enumerate(shape):
        axes = assignment.get(i)
        if axes and all(a in names for a in axes) and _ok(dim, mesh, *axes):
            entries.append(axes if len(axes) > 1 else axes[0])
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


# ------------------------------------------------------------------
# Parameter rules
# ------------------------------------------------------------------

_RULES: list[tuple[str, dict[int, tuple[str, ...]]]] = [
    # (regex on the JAX path WITHOUT the leading stack dim, rule)
    (r".*/attn/wq$", {1: ("model",)}),
    (r".*/attn/wk$", {1: ("model",)}),
    (r".*/attn/wv$", {1: ("model",)}),
    (r".*/attn/wo$", {0: ("model",)}),
    (r".*/mlp/(gate|up)$", {1: ("model",)}),
    (r".*/mlp/down$", {0: ("model",)}),
    (r".*/moe/(gate|up)$", {0: ("model",)}),      # expert-parallel
    (r".*/moe/down$", {0: ("model",)}),
    (r".*/moe/router$", {}),
    (r"^embed$", {0: ("model",)}),
    (r"^head$", {1: ("model",)}),
]

_SSM_TP_RULES: list[tuple[str, dict[int, tuple[str, ...]]]] = [
    (r".*/mixer/in_proj$", {1: ("model",)}),
    (r".*/mixer/out_proj$", {0: ("model",)}),
    (r".*/mixer/(up|wq|wk|wv)$", {1: ("model",)}),
    (r".*/mixer/down$", {0: ("model",)}),
]


def param_spec(path: str, shape: tuple[int, ...], mesh,
               policy: ShardingPolicy, cfg: ModelConfig) -> tuple:
    """The spec of the JAX tree's leaf ``path`` of ``shape``."""
    stacked = path.startswith("unit/")
    eff_shape = shape[1:] if stacked else shape

    rules = list(_RULES)
    if policy.ssm_tp:
        rules += _SSM_TP_RULES
    rule = None
    for pat, assignment in rules:
        if re.match(pat, path):
            rule = dict(assignment)
            break
    if rule is None:
        rule = {}

    # policy gates
    if not policy.attn_tp and "/attn/" in path:
        rule = {}
    if not policy.mlp_tp and "/mlp/" in path:
        rule = {}
    if "/moe/" in path and "router" not in path:
        if not (policy.moe_expert_parallel and
                _ok(cfg.n_experts, mesh, "model")):
            # fall back to tensor parallelism inside each expert
            if path.endswith("down"):
                rule = {1: ("model",)}       # (E, ff, d): shard ff
            else:
                rule = {2: ("model",)}       # (E, d, ff): shard ff
    if path == "embed" and not policy.embed_vocab_shard:
        rule = {}
    if path == "head" and not policy.logits_vocab_shard:
        rule = {}

    spec = _spec(mesh, eff_shape, rule)
    if stacked:
        spec = (None, *spec)
    return spec


# ------------------------------------------------------------------
# Activation / input rules
# ------------------------------------------------------------------

def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a != "model")


def tokens_spec(mesh, batch: int, policy: ShardingPolicy,
                seq_shard: bool = False) -> tuple:
    da = data_axes(mesh)
    baxes = da if _ok(batch, mesh, *da) else ()
    b = baxes if baxes else None
    if seq_shard and policy.shard_seq_train:
        return (b, "model")
    return (b, None)


def cache_spec(mesh, shape: tuple[int, ...], batch: int,
               policy: ShardingPolicy, kind: str) -> tuple:
    """KV cache (B, L, KV, hd) or SSM state (B, ...), with leading stack
    dim.  Context parallelism: shard L on the data axes when the batch is
    too small to occupy them."""
    da = data_axes(mesh)
    b_ok = _ok(batch, mesh, *da)
    if kind == "kv":                          # (stack, B, L, KV, hd)
        rule: dict[int, tuple[str, ...]] = {}
        if b_ok:
            rule[1] = da
            seq_on_data = policy.decode_cache_seq == "always"
        else:
            seq_on_data = policy.decode_cache_seq in ("auto", "always")
        if seq_on_data:
            rule[2] = da if not b_ok else ()
        rule[3] = ("model",)                  # kv heads if divisible
        return _spec(mesh, shape, {k: v for k, v in rule.items() if v})
    # ssm state: (stack, B, ...) — batch on data, rest replicated/model
    rule = {1: da} if b_ok else {}
    return _spec(mesh, shape, rule)


# ------------------------------------------------------------------
# Specs as DTensor placements
# ------------------------------------------------------------------

def placements(spec: tuple, mesh) -> list:
    """One placement per mesh dim: ``Shard(i)`` where tensor dim ``i``'s
    entry names that axis (alone or in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for a in axis_names(mesh):
        dims = [i for i, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def module_param_spec(model, name: str, shape: tuple[int, ...], mesh,
                      policy: ShardingPolicy) -> tuple:
    """The spec of the port's parameter ``name`` (of ``shape``): its JAX
    leaf's spec, without the stacked leaf's leading ``n_super`` entry."""
    path, stacked = convert.jax_path(name, model.unit)
    jshape = (model.n_super, *shape) if stacked else tuple(shape)
    spec = param_spec(path, jshape, mesh, policy, model.cfg)
    return spec[1:] if stacked else spec


def shard_module(model: nn.Module, mesh,
                 policy: ShardingPolicy = ShardingPolicy()) -> nn.Module:
    """Replace every parameter of ``model`` (built whole, identically on
    every rank) by a DTensor on ``mesh`` under ``policy``'s rules: each
    rank keeps its shard, and the sharded weights are bitwise the whole
    ones.  In place; returns ``model``."""
    from torch.distributed.tensor import distribute_tensor
    for mod_name, mod in model.named_modules():
        for pn, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{pn}" if mod_name else pn
            spec = module_param_spec(model, name, tuple(p.shape), mesh,
                                     policy)
            # every rank holds the whole tensor: each slices its own shard
            d = distribute_tensor(p.detach(), mesh, placements(spec, mesh),
                                  src_data_rank=None)
            mod.register_parameter(pn, nn.Parameter(
                d, requires_grad=p.requires_grad))
    return model


def shard_batch(batch: dict, mesh, policy: ShardingPolicy) -> dict:
    """Token arrays (B, ...) as DTensors placed by :func:`tokens_spec`
    (batch on the data axes when it divides them)."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for k, v in batch.items():
        spec = tokens_spec(mesh, v.shape[0], policy)[:v.dim()]
        out[k] = distribute_tensor(v, mesh, placements(spec, mesh),
                                   src_data_rank=None)
    return out

