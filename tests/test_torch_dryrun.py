"""The port's dry run (``repro_torch.launch.dryrun``, ``perf``,
``mesh.fake_world``, ``sharding.shard_cache``) on the CPU.

One subprocess runs the dry run at ``.reduced()`` widths on the 256-rank
fake mesh (one on the 512-rank one): a dense model, the "shard_map" MoE,
zamba2 and xLSTM, covering train, prefill and decode, and the CLI.  Its
records must be ``ok`` and carry the reference's keys (read from
``repro/launch/dryrun.py`` with ``ast``); remat must lower the train
step's temp bytes (four layers, four superblocks).  A subprocess, because the dry run opens a process
group, and because importing ``repro.launch.dryrun`` or ``perf`` sets
``XLA_FLAGS`` to 512 devices (``tests/conftest.py``): the reference's
``LADDERS`` and record keys are read from its source instead.
"""
import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel

from repro_torch.launch import analysis as tanalysis
from repro_torch.launch import perf as tperf
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.model import Model as TModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro", "launch")

SCRIPT = r'''
import dataclasses, json, os, sys
before = dict(os.environ)
import torch.distributed as dist
import repro_torch.launch.dryrun as dryrun
import repro_torch.launch.perf  # noqa: F401
out = {"env_untouched": dict(os.environ) == before,
       "no_group_at_import": not dist.is_initialized()}
import repro_torch.configs as C
from repro_torch.launch import mesh as M
from repro_torch.launch.sharding import ShardingPolicy

def reduced(arch, **kw):
    full, small = C.get(arch), C.get(arch).reduced(**kw)
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
            if getattr(small, f.name) != getattr(full, f.name)}

d = sys.argv[1]
cases = [("tinyllama-1.1b", "train_4k", False, {}),
         ("mixtral-8x7b", "prefill_32k", False, {"moe_dispatch": "shard_map"}),
         ("zamba2-2.7b", "decode_32k", False, {}),
         ("xlstm-350m", "long_500k", False, {}),
         ("tinyllama-1.1b", "decode_32k", True, {})]
out["records"] = []
for arch, shape, multi, kw in cases:
    rec = dryrun.run_one(arch, shape, multi, d, tag="__t",
                         overrides={**reduced(arch), **kw})
    out["records"].append(rec)
with M.fake_world(256):
    mesh = M.make_production_mesh(device_type="cpu")
    out["mesh"] = list(mesh.shape)
    temp = {}
    for remat in (True, False):
        trace, _, _ = dryrun.lower_one(
            "tinyllama-1.1b", "train_4k", mesh, ShardingPolicy(),
            remat=remat, overrides=reduced(
                "tinyllama-1.1b", n_layers=4, block_pattern=("attn",) * 4))
        temp[remat] = trace.memory["temp_bytes"]
    out["temp"] = [temp[True], temp[False]]
    peak = []
    for mb in (1, 4):
        trace, _, _ = dryrun.lower_one(
            "tinyllama-1.1b", "train_4k", mesh, ShardingPolicy(),
            overrides={**reduced("tinyllama-1.1b"), "microbatches": mb})
        peak.append(trace.memory["temp_bytes"])
    out["microbatch_temp"] = peak
out["group_closed"] = not dist.is_initialized()
dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--mesh",
             "both", "--out", d])
out["files"] = sorted(os.listdir(d))
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(d)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _ref_tree(name: str):
    with open(os.path.join(REF, name)) as f:
        return ast.parse(f.read())


def _ref_record_keys() -> set:
    """Every key of a dict literal in the reference's ``analyse`` and
    ``run_one``: the record's keys, nested ones included."""
    keys = set()
    for node in ast.walk(_ref_tree("dryrun.py")):
        if isinstance(node, ast.FunctionDef) and node.name in (
                "analyse", "run_one"):
            for d in ast.walk(node):
                if isinstance(d, ast.Dict):
                    keys |= {k.value for k in d.keys
                             if isinstance(k, ast.Constant)}
                if isinstance(d, ast.Assign) and isinstance(
                        d.targets[0], ast.Subscript):
                    keys.add(d.targets[0].slice.value)
    # analyse's {"train": "train", ...} maps the shape's kind to a mode
    return keys - {"train", "prefill", "decode"}


def _keys(rec: dict) -> set:
    out = set()
    for k, v in rec.items():
        out.add(k)
        if isinstance(v, dict):
            out |= _keys(v)
    return out


def test_import_leaves_the_environment_alone(run):
    assert run["env_untouched"] and run["no_group_at_import"]
    assert run["group_closed"]
    assert run["mesh"] == [16, 16]


def test_records_are_ok_with_the_reference_keys(run):
    """Dense train, the "shard_map" MoE's prefill, zamba2's decode, xLSTM
    at long_500k, and a multi-pod decode: every record ``ok`` with every
    key of the reference's records (error records excepted: the cases
    are all ok)."""
    want = _ref_record_keys() - {"error", "traceback"}
    assert {"memory", "roofline", "argument_bytes", "alias_bytes",
            "useful_ratio", "walls"} <= want
    kinds = set()
    for rec in run["records"]:
        assert rec["status"] == "ok", rec.get("traceback")
        missing = want - _keys(rec)
        assert not missing, (rec["arch"], missing)
        r = rec["roofline"]
        assert all(r[k] >= 0 for k in ("compute_s", "memory_s",
                                       "collective_s"))
        assert r["dominant"] in ("compute", "memory", "collective")
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
        assert rec["memory"]["temp_bytes"] > 0
        assert rec["walls"]["compile_s"] == 0.0
        kinds.add(rec["shape"].split("_")[0])
        assert rec["n_chips"] == (512 if rec["mesh"] == "multi_pod" else 256)
    assert kinds == {"train", "prefill", "decode", "long"}


def test_records_see_their_collectives(run):
    """The data-parallel gradients are summed (train); the sharded MoE's
    one all-reduce per layer over the model axis (prefill); the decode
    steps write their caches in place (the alias bytes)."""
    train, moe, zamba, xlstm, multi = run["records"]
    assert train["collectives"]["all-reduce"] > 0
    assert moe["collectives"]["all-reduce"] > 0
    assert moe["collectives"]["count"] > 0
    for rec in (zamba, xlstm, multi):
        assert rec["memory"]["alias_bytes"] > 0
    assert train["memory"]["alias_bytes"] > 0        # in-place AdamW


def test_remat_lowers_temp_bytes(run):
    with_remat, without = run["temp"]
    assert 0 < with_remat < without


def test_microbatches_stay_sharded(run):
    """Four microbatches keep one microbatch's activations live, each
    placed over the data axis as the batch is (a DTensor slice of the
    sharded batch would otherwise gather it whole on every rank)."""
    one, four = run["microbatch_temp"]
    assert 0 < four < one / 2


def test_cli_names_files_as_the_reference(run):
    for mesh in ("single_pod", "multi_pod"):
        assert f"xlstm-350m__decode_32k__{mesh}.json" in run["files"]
    assert "tinyllama-1.1b__train_4k__single_pod__t.json" in run["files"]


def test_perf_ladders_match_the_reference():
    """Pairs, archs, shapes, tags, overrides and policy fields of every
    rung equal the JAX package's (its hypotheses are rewritten)."""
    for node in ast.walk(_ref_tree("perf.py")):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "LADDERS":
            ref = ast.literal_eval(node.value)
    strip = [(p, a, s, [(t, o, k) for t, _, o, k in ladder])
             for p, a, s, ladder in ref]
    port = [(p, a, s, [(t, o, k) for t, _, o, k in ladder])
            for p, a, s, ladder in tperf.LADDERS]
    assert port == strip
    for _, _, _, ladder in tperf.LADDERS:
        for _, hypothesis, _, _ in ladder:
            for tpu in ("TPU", "VMEM", "GSPMD", "16 GB", "ICI"):
                assert tpu not in hypothesis


def test_shard_cache_places_the_reference_specs():
    """``shard_cache`` places each leaf as ``cache_spec`` says (kv for
    ``k``/``v``, ssm for the rest), on a (2, 2) mesh of a fake group of
    4: a batch of 4 on the data axis, kv heads on the model axis; a
    batch of 1 shards the slots instead (context parallelism)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import sharding as tsharding
    cfg = TConfig(name="t", arch_type="x", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=50,
                  block_pattern=("attn", "mamba2"), ssm_state=16,
                  ssm_head_dim=32)
    with tmesh.fake_world(4):
        mesh = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            m = TModel(cfg, device="cpu")
        pol = tsharding.ShardingPolicy()
        big = tsharding.shard_cache(m.init_cache(4, 8), mesh, 4, pol)
        one = tsharding.shard_cache(m.init_cache(1, 8), mesh, 1, pol)
    assert big[0]["k"].placements == (Shard(0), Shard(2))
    assert big[1]["state"].placements == (Shard(0), Replicate())
    assert one[0]["v"].placements == (Shard(1), Shard(2))
    assert one[1]["conv"].placements == (Replicate(), Replicate())
    assert big[0]["k"].shape == (4, 8, 2, 16)


def test_mamba2_decode_in_bfloat16_matches_jax():
    """C7: a bf16 Mamba-2 decode step raised where the reference promotes
    C (bf16) against the f32 state (``models/mamba2.py::Mamba2.decode``).
    Both packages decode 6 tokens of a zamba-style model with the same
    bf16 weights; each is held to the JAX f32 decode of those weights,
    and the port's bf16 error may be at most twice the reference's own
    (bf16 rounding, in two orders of operations)."""
    base = dict(name="t", arch_type="x", n_layers=4, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=50,
                block_pattern=("mamba2", "shared_attn") * 2, ssm_state=16,
                ssm_head_dim=32, ssd_chunk=8)
    jm = JModel(JConfig(**base, dtype="bfloat16"))
    params = jm.init(jax.random.PRNGKey(0))
    jm32 = JModel(JConfig(**base))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tm32 = TModel(TConfig(**base), device="cpu")
    convert.load_params(tm32, jax.tree.map(np.asarray, params32))
    tm = TModel(TConfig(**base, dtype="bfloat16"), device="cpu")
    tm.load_state_dict({k: v.to(torch.bfloat16)
                        for k, v in tm32.state_dict().items()})
    assert next(tm.parameters()).dtype == torch.bfloat16
    tok = np.random.default_rng(3).integers(0, 50, (2, 6)).astype(np.int32)
    jcache, jcache32 = jm.init_cache(2, 8), jm32.init_cache(2, 8)
    cache = tm.init_cache(2, 8)
    step, step32 = jax.jit(jm.decode_step), jax.jit(jm32.decode_step)
    err_port = err_jax = 0.0
    with torch.no_grad():
        for i in range(6):
            t = jnp.asarray(tok[:, i:i + 1])
            want, jcache = step(params, t, jcache, jnp.asarray(i))
            exact, jcache32 = step32(params32, t, jcache32, jnp.asarray(i))
            got, _ = tm.decode_step(torch.from_numpy(tok[:, i:i + 1]),
                                    cache, i)
            assert got.dtype == torch.bfloat16
            exact = np.asarray(exact)
            err_port = max(err_port, np.abs(got.float().numpy()
                                            - exact).max())
            err_jax = max(err_jax, np.abs(np.asarray(
                want.astype(jnp.float32)) - exact).max())
    assert 0 < err_port <= 2 * err_jax, (err_port, err_jax)


def test_cross_entropy_gathers_block_by_block():
    """C9: the gold logit's ``torch.gather`` on DTensor logits whose batch
    is sharded over two mesh axes (the multi-pod mesh) built its
    backward's zeros whole and replicated on every rank.  On a (2, 2, 2)
    fake mesh the loss's backward now holds no tensor of the whole
    logits' size, and the loss and gradient equal the plain ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.core import losses as tlosses
    from repro_torch.launch import mesh as tmesh
    pl = [Shard(0), Shard(0), Replicate()]
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((8, 16, 64), generator=g)
    tok = torch.randint(0, 64, (8, 16), generator=g)
    want = torch.autograd.grad(tlosses._ce(logits.requires_grad_(True),
                                           tok).sum(), [logits])[0]
    with tmesh.fake_world(8):
        mesh = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        whole = logits.detach()
        d_logits = distribute_tensor(whole, mesh, pl, src_data_rank=None
                                     ).requires_grad_(True)
        d_tok = distribute_tensor(tok, mesh, pl[:2] + [Replicate()],
                                  src_data_rank=None)
        ce = tlosses._ce(d_logits, d_tok)
        got = torch.autograd.grad(ce.to_local().sum(), [d_logits])[0]
        assert torch.equal(ce.to_local(), tlosses._ce(whole, tok)[:2])
        assert torch.equal(got.to_local(), want[:2])
        with FakeTensorMode():
            big = distribute_tensor(torch.empty((256, 64, 512)), mesh, pl,
                                    src_data_rank=None).requires_grad_(True)
            t = distribute_tensor(torch.empty((256, 64), dtype=torch.int64),
                                  mesh, pl[:2] + [Replicate()],
                                  src_data_rank=None)
            rec = _Largest()
            with rec:
                torch.autograd.grad(tlosses._ce(big, t).to_local().sum(),
                                    [big])
    assert 0 < rec.largest <= 256 * 64 * 512 * 4 / 4      # one rank's block


class _Largest(tanalysis.Recorder):
    """A recorder that also keeps the largest storage allocated."""

    largest = 0

    def _add(self, t):
        self.largest = max(self.largest, t.untyped_storage().nbytes())
        return super()._add(t)


def test_pallas_plain_routes_refuse_cuda_tensors(monkeypatch):
    """The sharded forms' route with no kernel, a rank's subset of query
    rows, runs its plain version on CPU tensors only: under
    ``attn_impl="pallas"`` a CUDA tensor (a fake one here) raises instead
    of running plain code on the card.  The softmax completed over ranks
    that shard the cache's slots takes each rank's statistics from the
    kernel's wrapper ``flash_decode_partials`` (a spy on the fake CUDA
    tensors; its CPU route on CPU tensors).  "einsum" and "blocked" are
    plain by the config's choice."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import spmd
    cfg = TConfig(name="t", arch_type="x", n_layers=1, d_model=64,
                  n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=50,
                  block_pattern=("attn",), attn_impl="pallas")
    slots = dict(pos=40, window=0, slot0=32, ring_len=64)
    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.device.type, kw))
        B, _, H, hd = q.shape
        return (torch.zeros((B, 1, H), device=q.device),
                torch.ones((B, 1, H), device=q.device),
                torch.zeros((B, 1, H, hd), device=q.device))

    with FakeTensorMode():
        for dev in ("cuda", "cpu"):
            q = torch.empty((2, 8, 4, 16), device=dev)
            kv = torch.empty((2, 32, 4, 16), device=dev)
            one = torch.empty((2, 1, 4, 16), device=dev)
            if dev == "cuda":
                with pytest.raises(NotImplementedError, match="row offset"):
                    spmd.local_attention(q, kv, kv, cfg, causal=False,
                                         window=0, row0=8, S=32)
                with monkeypatch.context() as mp:
                    mp.setattr(spmd.flash_ops, "flash_decode_partials", spy)
                    y = spmd.slot_sharded_decode(one, kv, kv, [], cfg,
                                                 **slots)
                assert calls == [("cuda", dict(pos=40, window=0,
                                               ring_len=64, slot0=32))]
                assert y.shape == one.shape and y.device.type == "cuda"
                continue
            y = spmd.local_attention(q, kv, kv, cfg, causal=False, window=0,
                                     row0=8, S=32)
            assert y.shape == q.shape and y.device.type == "cpu"
            y = spmd.slot_sharded_decode(one, kv, kv, [], cfg, **slots)
            assert y.shape == one.shape
    with FakeTensorMode():
        q = torch.empty((2, 8, 4, 16), device="cuda")
    for impl in ("einsum", "blocked"):          # plain by the config's choice
        assert spmd._no_kernel(q, cfg.replace(attn_impl=impl), "") is None


def _moe_model(mesh_shape, batch, seq, **kw):
    """A one-block "shard_map" MoE model sharded on a fake (data, model)
    mesh, called under it on a DTensor batch of ``batch`` x ``seq``
    tokens; (model, logits)."""
    import math
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import sharding as tsharding
    cfg = TConfig(name="t", arch_type="x", n_layers=1, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                  block_pattern=("moe",), n_experts=4, experts_per_token=2,
                  moe_dispatch="shard_map", **kw)
    pol = tsharding.ShardingPolicy()
    with tmesh.fake_world(math.prod(mesh_shape)):
        mesh = tmesh.make_mesh(mesh_shape, ("data", "model"), "cpu")
        with FakeTensorMode():
            model = tsharding.shard_module(TModel(cfg, device="cpu"), mesh,
                                           pol)
            tok = tsharding.shard_batch(
                {"x": torch.empty((batch, seq), dtype=torch.int64)}, mesh,
                pol)["x"]
            with tmesh.use_mesh(mesh), implicit_replication(), \
                    torch.no_grad():
                return model, model(tok, causal=False)


def test_shard_map_tokens_that_do_not_split_raise():
    """Expert parallel (4 experts on a model axis of 2): each data shard's
    tokens are split over the model ranks.  One token per data shard does
    not split, and the layer raises, as the reference's equal slices fail
    in its gather, instead of running the replicated global dispatch;
    two tokens do."""
    with pytest.raises(ValueError, match="do not split over 2 model ranks"):
        _moe_model((2, 2), 2, 1)
    _, logits = _moe_model((2, 2), 2, 2)
    assert logits.shape == (2, 2, 64)


def test_shard_module_installs_the_sharded_forms():
    """``shard_module`` swaps the model's modules for their sharded forms
    (``launch/spmd.py``), parameters and state dict unchanged; a model
    built whole keeps the plain classes, whose layers test for no
    DTensor."""
    import inspect
    from repro_torch.launch import spmd
    from repro_torch.models import attention, blocks
    model, _ = _moe_model((2, 2), 2, 2)
    kinds = {type(m) for m in model.modules()}
    assert {spmd.ShardedModel, spmd.ShardedAttnBlock, spmd.ShardedAttention,
            spmd.ShardedMoE} <= kinds
    assert not kinds & set(spmd._FORMS)
    plain = TModel(TConfig(name="t", arch_type="x", n_layers=1, d_model=64,
                           n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                           block_pattern=("attn",)), device="cpu")
    assert type(plain) is TModel
    assert type(plain.blocks[0].attn) is attention.Attention
    for mod in (attention, blocks):
        assert "is_sharded" not in inspect.getsource(mod)


@pytest.mark.parametrize("ssm_tp", [False, True])
def test_sharded_mixer_blocks_run_either_policy(ssm_tp):
    """A zamba-style model sharded on a fake (2, 2) mesh runs its
    forward through ``ShardedMixerBlock``: with the default policy the
    Mamba-2 mixer's weights are replicated and it runs on local rows;
    with ``ssm_tp`` they are sharded and its branch joins the residual
    through ``_add``, placed as the stream."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import sharding as tsharding
    from repro_torch.launch import spmd
    cfg = TConfig(name="t", arch_type="x", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=64,
                  block_pattern=("mamba2", "shared_attn"), ssm_state=16,
                  ssm_head_dim=32, ssd_chunk=8)
    pol = tsharding.ShardingPolicy(ssm_tp=ssm_tp)
    with tmesh.fake_world(4):
        mesh = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            model = tsharding.shard_module(TModel(cfg, device="cpu"), mesh,
                                           pol)
            tok = tsharding.shard_batch(
                {"x": torch.empty((2, 16), dtype=torch.int64)}, mesh,
                pol)["x"]
            with tmesh.use_mesh(mesh), implicit_replication(), \
                    torch.no_grad():
                logits = model(tok, causal=False)
    assert type(model.blocks[0]) is spmd.ShardedMixerBlock
    assert spmd._replicated(model.blocks[0].mixer, tok.float()[..., None]) \
        is not ssm_tp
    assert logits.shape == (2, 16, 64)
    x, y = torch.ones(3), torch.full((3,), 2.0)
    assert torch.equal(model.blocks[0]._add(x, y), x + y)
