"""The port's sharding rules and mesh helpers against
``repro.launch.sharding`` and ``repro.launch.mesh``, on mesh metadata
(no devices): every case of ``tests/test_distribution.py``, then every
leaf of every registry config's JAX tree on the (16, 16) and (2, 16, 16)
production meshes under four policies.  Specs are compared normalised as
that file's ``_norm`` does.
"""
import dataclasses

import jax
import pytest

import repro.configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsharding
from repro.models.model import Model as JModel

import repro_torch.configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.models import convert
from repro_torch.models.model import Model as TModel


class FakeMesh:
    """Mesh metadata stand-in (axis sizes only), as in
    tests/test_distribution.py."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
POL = tsharding.ShardingPolicy()
CFG = tconfigs.get("mixtral-8x7b")
POLICIES = {"default": {}, "ssm_tp": {"ssm_tp": True},
            "no_attn_tp": {"attn_tp": False},
            "no_moe_ep": {"moe_expert_parallel": False}}


def _norm(spec):
    """Entries as tuples, trailing Nones dropped."""
    out = []
    for e in spec:
        out.append(tuple(e) if isinstance(e, (tuple, list))
                   else ((e,) if e else None))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _policies(name):
    kw = POLICIES[name]
    return jsharding.ShardingPolicy(**kw), tsharding.ShardingPolicy(**kw)


def test_policy_fields_are_the_jax_packages():
    j = {f.name: f.default for f in dataclasses.fields(
        jsharding.ShardingPolicy)}
    t = {f.name: f.default for f in dataclasses.fields(
        tsharding.ShardingPolicy)}
    assert t == j


# ------------------------------------------- tests/test_distribution.py

def test_param_rules_tp():
    ps = tsharding.param_spec
    assert ps("unit/b0/attn/wq", (32, 4096, 4096), MESH, POL, CFG) == \
        (None, None, "model")
    assert ps("unit/b0/attn/wo", (32, 4096, 4096), MESH, POL, CFG) == \
        (None, "model")
    assert ps("unit/b0/mlp/down", (32, 14336, 4096), MESH, POL, CFG) == \
        (None, "model")
    assert ps("embed", (32000, 4096), MESH, POL, CFG) == ("model",)
    assert ps("head", (4096, 32000), MESH, POL, CFG) == (None, "model")
    assert ps("ln_f/scale", (4096,), MESH, POL, CFG) == ()


def test_param_rules_moe_fallback():
    ps = tsharding.param_spec
    assert ps("unit/b0/moe/up", (32, 8, 4096, 14336), MESH, POL, CFG) == \
        (None, None, None, "model")
    assert ps("unit/b0/moe/down", (32, 8, 14336, 4096), MESH, POL, CFG) == \
        (None, None, "model")
    cfg4 = tconfigs.get("llama4-maverick-400b-a17b")
    assert ps("unit/b0/moe/up", (48, 128, 5120, 8192), MESH, POL, cfg4) == \
        (None, "model")


def test_param_rules_nondivisible_replicates():
    spec = tsharding.param_spec("unit/b0/attn/wq", (30, 3072, 100), MESH,
                                POL, CFG)
    assert _norm(spec) == ()


def test_cache_specs():
    cs = tsharding.cache_spec
    assert _norm(cs(MESH, (32, 128, 32768, 8, 128), 128, POL, "kv"))[1] == \
        ("data",)
    assert _norm(cs(MESH, (9, 1, 524288, 32, 80), 1, POL, "kv"))[2] == \
        ("data",)
    assert _norm(cs(MESH3, (32, 128, 32768, 8, 128), 128, POL, "kv"))[1] \
        == ("pod", "data")


def test_mesh_helpers():
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert tmesh.batch_axes(m) == ("pod", "data") == jmesh.batch_axes(m)
    assert tmesh.axis_size(m, "pod", "data") == 32 == jmesh.axis_size(
        m, "pod", "data")
    assert tmesh.axis_size(m, "model") == 16
    assert tmesh.axis_names(m) == ("pod", "data", "model")


def test_mesh_helpers_read_a_device_mesh_shape():
    """A ``DeviceMesh`` keeps its sizes in a tuple and its names in
    ``mesh_dim_names``; the helpers read both forms alike."""
    class DeviceMeshLike:
        shape = (2, 4)
        mesh_dim_names = ("data", "model")

    m = DeviceMeshLike()
    assert tmesh.axis_sizes(m) == {"data": 2, "model": 4}
    assert tmesh.batch_axes(m) == ("data",)
    assert tmesh.axis_size(m, "data", "model") == 8
    assert tsharding.tokens_spec(m, 6, POL) == (("data",), None)


def test_production_mesh_needs_its_world_size():
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")


def test_ambient_mesh_nests():
    assert tmesh.current_mesh() is None
    with tmesh.use_mesh(MESH):
        with tmesh.use_mesh(MESH3):
            assert tmesh.current_mesh() is MESH3
        assert tmesh.current_mesh() is MESH
    assert tmesh.current_mesh() is None


# ------------------------------------------------ the registry, swept

def _leaves(arch):
    shapes = jax.eval_shape(JModel(jconfigs.get(arch)).init,
                            jax.random.PRNGKey(0))
    return convert.flatten(shapes)


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_param_specs_match_jax_on_every_leaf(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    leaves = _leaves(arch)
    assert any(k.startswith("unit/") for k in leaves)
    for mesh in (MESH, MESH3):
        for pol in POLICIES:
            jpol, tpol = _policies(pol)
            for path, leaf in leaves.items():
                want = jsharding.param_spec(path, leaf.shape, mesh, jpol,
                                            jcfg)
                got = tsharding.param_spec(path, leaf.shape, mesh, tpol,
                                           tcfg)
                assert _norm(got) == _norm(want), (arch, pol, path)


@pytest.mark.parametrize("batch", [1, 2, 16, 24, 32, 128, 256, 512])
def test_activation_specs_match_jax(batch):
    for mesh in (MESH, MESH3):
        assert tsharding.data_axes(mesh) == jsharding.data_axes(mesh)
        for shard_seq in (False, True):
            jpol = jsharding.ShardingPolicy(shard_seq_train=shard_seq)
            tpol = tsharding.ShardingPolicy(shard_seq_train=shard_seq)
            for seq_shard in (False, True):
                assert _norm(tsharding.tokens_spec(
                    mesh, batch, tpol, seq_shard)) == _norm(
                    jsharding.tokens_spec(mesh, batch, jpol, seq_shard))
        for seq in ("auto", "always", "never"):
            jpol = jsharding.ShardingPolicy(decode_cache_seq=seq)
            tpol = tsharding.ShardingPolicy(decode_cache_seq=seq)
            for kind, shape in (("kv", (32, batch, 4096, 8, 128)),
                                ("kv", (9, batch, 2048, 3, 80)),
                                ("ssm", (27, batch, 80, 64, 64)),
                                ("ssm", (4, batch, 4096))):
                assert _norm(tsharding.cache_spec(
                    mesh, shape, batch, tpol, kind)) == _norm(
                    jsharding.cache_spec(mesh, shape, batch, jpol, kind)), \
                    (batch, seq, kind, shape)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mixtral-8x7b",
                                  "xlstm-350m"])
def test_port_names_map_onto_the_jax_tree(arch):
    """``convert.jax_path`` of every port parameter is the leaf that
    ``to_jax_tree`` puts it in, so ``shard_module`` reads the rule of the
    right leaf; the per-tensor spec drops the stack entry."""
    pattern = tconfigs.get(arch).reduced().block_pattern * 2
    cfg = tconfigs.get(arch).reduced(n_layers=len(pattern),
                                     block_pattern=pattern)
    tm = TModel(cfg, device="cpu", seed=0)
    named = dict(tm.named_parameters())
    tree = convert.flatten(convert.to_jax_tree(named, tm.unit, tm.n_super))
    for name, p in named.items():
        path, stacked = convert.jax_path(name, tm.unit)
        assert path in tree, name
        assert tuple(tree[path].shape) == ((tm.n_super, *p.shape) if stacked
                                           else tuple(p.shape)), name
        mesh = FakeMesh({"data": 2, "model": 2})
        spec = tsharding.module_param_spec(tm, name, tuple(p.shape), mesh,
                                           POL)
        want = tsharding.param_spec(path, tuple(tree[path].shape), mesh,
                                    POL, cfg)
        assert spec == (want[1:] if stacked else want)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh({"pod": 2, "data": 4, "model": 2})
    assert tsharding.placements((None, "model"), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    assert tsharding.placements((("pod", "data"), None), mesh) == [
        Shard(0), Shard(0), Replicate()]
    assert tsharding.placements((), mesh) == [Replicate()] * 3
