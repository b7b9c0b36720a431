"""The port's compile-only analysis (``repro_torch.launch.analysis``)
against the JAX package's (``repro.launch.analysis``), on the CPU.

Parameter counts, analytic model FLOPs and the reference's corrections
must equal the JAX package's exactly, for every config of the registry
and every assigned arch x shape; the port's models are built under a
fake tensor mode (shapes only, nothing allocated).  The roofline is held
to a case computed by hand at the H100 constants; ``collective_bytes``
to the JAX ``test_collective_parser`` values, from real collectives on a
fake process group.  ``frontend_spec`` to the JAX package's for all 12
configs.  (``repro.launch.analysis`` sets no XLA flags; ``dryrun`` and
``perf`` do, and are not imported here.)
"""
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as jconfigs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import analysis as janalysis
from repro.models import frontend as jfrontend
from repro.models.model import Model as JModel

import repro_torch.configs as tconfigs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import analysis
from repro_torch.launch import mesh as tmesh
from repro_torch.models import frontend as tfrontend
from repro_torch.models.model import Model as TModel

_MODELS: dict = {}


def _models(arch: str, **kw):
    """(JAX model, port model built under a fake tensor mode)."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg = jconfigs.get(arch).replace(**kw)
        tcfg = tconfigs.get(arch).replace(**kw)
        with FakeTensorMode():
            tm = TModel(tcfg, device="cpu")
        _MODELS[key] = (JModel(jcfg), tm)
    return _MODELS[key]


def _mode(shape):
    return SHAPES[shape].kind


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_param_counts_match_jax(arch):
    jm, tm = _models(arch)
    assert analysis.param_counts(tm) == janalysis.param_counts(jm)


@pytest.mark.parametrize("arch", tconfigs.ASSIGNED_ARCHS)
def test_model_flops_and_corrections_match_jax(arch):
    """Every shape's mode, the config as it is and with "blocked"
    attention (the flash correction's case)."""
    assert tuple(SHAPES) == tuple(JSHAPES)
    for shape, shp in SHAPES.items():
        mode = _mode(shape)
        B, S = shp.global_batch, shp.seq_len
        n = B * S if mode != "decode" else B
        jm, tm = _models(arch)
        assert analysis.model_flops(tm, n, mode) == \
            janalysis.model_flops(jm, n, mode)
        for impl in ("einsum", "blocked"):
            for bidir in (False, True):
                kw = dict(attn_impl=impl, bidirectional=bidir,
                          attn_block_k=1024)
                jcfg = jconfigs.get(arch).replace(**kw)
                tcfg = tconfigs.get(arch).replace(**kw)
                assert analysis.scan_correction(tcfg, B, S, mode) == \
                    janalysis.scan_correction(jcfg, B, S, mode)
                assert analysis.flash_attn_correction(tcfg, B, S, mode) == \
                    janalysis.flash_attn_correction(jcfg, B, S, mode)
                assert analysis.corrections(tcfg, B, S, mode) == \
                    janalysis.corrections(jcfg, B, S, mode)


def test_corrections_are_exercised():
    """The equality above covers non-zero values of both corrections."""
    xl = tconfigs.get("xlstm-350m").replace(bidirectional=True)
    assert analysis.scan_correction(xl, 256, 4096, "train") > 0
    dense = tconfigs.get("tinyllama-1.1b").replace(attn_impl="blocked")
    f, b = analysis.flash_attn_correction(dense, 256, 4096, "train")
    assert f > 0 and b != 0


def test_roofline_at_the_h100_constants():
    """Each term one second by hand: 989e12 bf16 FLOPs (67e12 in f32),
    3.35e12 bytes, and a collective's bytes over NVLink (450 GB/s, a
    group inside one host of 8 cards) or InfiniBand (50 GB/s, a group
    that spans two hosts)."""
    nvlink = [{"kind": "all-reduce", "bytes": int(450e9),
               "ranks": list(range(8))}]
    ib = [{"kind": "all-gather", "bytes": int(50e9), "ranks": [0, 8]}]
    assert analysis.collective_seconds(nvlink) == pytest.approx(1.0)
    assert analysis.collective_seconds(ib) == pytest.approx(1.0)
    assert analysis.collective_seconds(nvlink + ib) == pytest.approx(2.0)
    # the same bytes across hosts cost 9x
    assert analysis.collective_seconds(
        [dict(nvlink[0], ranks=[0, 15])]) == pytest.approx(9.0)
    cost = {"flops": 989e12, "bytes accessed": 3.35e12}
    coll = analysis.collective_bytes(nvlink)
    t = analysis.roofline(cost, coll, 256, model_flops=989e12 * 256,
                          collective_s=analysis.collective_seconds(nvlink))
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(1.0)
    assert t.useful_ratio == pytest.approx(1.0)
    assert t.bound_s == pytest.approx(1.0)
    f32 = analysis.roofline({"flops": 67e12}, {"count": 0}, 1, 67e12,
                            dtype="float32")
    assert f32.compute_s == pytest.approx(1.0)
    assert f32.dominant == "compute"
    # whole-program corrections spread over the cards; bytes floor at 0
    t = analysis.roofline({"flops": 0.0, "bytes accessed": 1.0}, {}, 4,
                          0.0, 4 * 989e12, -8.0)
    assert t.compute_s == pytest.approx(1.0) and t.memory_s == 0.0
    # without the records' groups every collective byte crosses hosts
    t = analysis.roofline({}, {"all-reduce": int(50e9), "count": 1}, 256,
                          1.0)
    assert t.collective_s == pytest.approx(1.0)


def test_collective_bytes_from_a_fake_group():
    """The JAX ``test_collective_parser`` values, from collectives issued
    on a fake process group of 256 ranks: an f32 (16, 512, 1024)
    all-reduce, an all-gather with a bf16 (4, 1024) result, and a u32
    scalar received (the permute); count 3.  The groups are recorded."""
    import torch.distributed as dist
    rec = analysis.Recorder()
    with tmesh.fake_world(256):
        group = dist.new_group(list(range(4)))
        with FakeTensorMode():
            x = torch.empty((16, 512, 1024))
            out = torch.empty((4, 1024), dtype=torch.bfloat16)
            inp = torch.empty((1, 1024), dtype=torch.bfloat16)
            r = torch.empty((), dtype=torch.uint32)
            with rec:
                dist.all_reduce(x)
                dist.all_gather_into_tensor(out, inp, group=group)
                dist.recv(r, src=1)
    assert not dist.is_initialized()
    got = analysis.collective_bytes(rec.collectives)
    assert got["all-reduce"] == 16 * 512 * 1024 * 4
    assert got["all-gather"] == 4 * 1024 * 2
    assert got["collective-permute"] == 4
    assert got["count"] == 3
    assert [len(c["ranks"]) for c in rec.collectives] == [256, 4, 256]
    assert rec.flops == 0


def test_recorder_counts_flops_bytes_and_memory():
    """A matmul's FLOPs as FlopCounterMode counts them, each op's inputs
    and outputs once (views and allocations nothing), and the peak of
    live bytes, the arguments included, falling when a temporary dies."""
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        a = torch.empty((64, 32))
        b = torch.empty((32, 16))
        rec = analysis.Recorder()
        assert rec.track((a, b, a)) == (64 * 32 + 32 * 16) * 4
        with rec, FlopCounterMode(display=False) as fc:
            c = (a @ b).t()           # mm reads a, b and writes c; t: view
            d = c * 2.0               # reads c, writes d
            del c
            e = d.sum()
    assert rec.flops == fc.get_total_flops() == 2 * 64 * 32 * 16
    mm = (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert rec.bytes == mm + 2 * 64 * 16 * 4 + 64 * 16 * 4 + 4
    args = (64 * 32 + 32 * 16) * 4
    assert rec.peak == args + 2 * 64 * 16 * 4
    assert rec.live == args + 64 * 16 * 4 + 4
    assert d.shape == (16, 64) and e.shape == ()


def test_flash_and_ssd_flops_are_what_the_counter_sees_of_the_plain_versions():
    """The analytic FLOPs that ``chip_smoke.py`` adds for the two kernels
    the counter cannot see on the card are what it counts of their plain
    versions on the CPU: exactly for attention, within 1% for the scan
    (its three-operand einsum's small outer product)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_scan import ref as sref
    with FakeTensorMode():
        q = torch.empty((2, 96, 4, 16))
        kv = torch.empty((2, 96, 2, 16))
        with FlopCounterMode(display=False) as fc:
            fref.attention(q, kv, kv)
        assert fc.get_total_flops() == analysis.flash_attention_flops(
            2, 96, 4, 16)
        B, S, H, P, N, L = 2, 80, 3, 8, 16, 32
        with FlopCounterMode(display=False) as fc:
            sref.ssd_chunked(torch.empty((B, S, H, P)), torch.empty((B, S, H)),
                             torch.empty((H,)), torch.empty((B, S, N)),
                             torch.empty((B, S, N)), L)
    want = analysis.ssd_scan_flops(B, S, H, P, N, L)
    assert abs(fc.get_total_flops() - want) <= 0.01 * want


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_frontend_spec_matches_jax(arch):
    """None without a frontend; else the JAX spec's shape and dtype, a
    meta tensor outside a fake mode and a fake CPU one inside it."""
    for dtype in ("float32", "bfloat16"):
        jcfg = jconfigs.get(arch).replace(dtype=dtype)
        tcfg = tconfigs.get(arch).replace(dtype=dtype)
        want = jfrontend.frontend_spec(jcfg, 3)
        got = tfrontend.frontend_spec(tcfg, 3)
        if want is None:
            assert got is None
            continue
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        assert got.device.type == "meta"
        with FakeTensorMode():
            fake = tfrontend.frontend_spec(tcfg, 3)
        assert fake.device.type == "cpu" and fake.shape == got.shape
        assert jnp.dtype(want.dtype) == jnp.dtype(dtype)


def test_h100_constants_are_the_data_sheets():
    assert analysis.peak_flops("bfloat16") == 989e12
    assert analysis.peak_flops(torch.float32) == 67e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.link_bw(range(8)) == 450e9
    assert analysis.link_bw([7, 8]) == 50e9


def test_recorder_counts_one_rank_on_the_fake_mesh():
    """Rank 0's counted FLOPs of a dense prefill on the 256-rank (16, 16)
    mesh are the whole call's on one device (``dryrun.count_call``) over
    the sharding factor, exactly: every product of the reduced model,
    widened to 16 heads so that heads, d_ff and vocab divide the model
    axis, is split 16 ways by the batch and 16 by the model axis; the
    time embedding's two (B, d) x (d, d) products, whose weights are
    replicated, only by the batch.  Counting DTensor's whole-size shape
    propagation too would multiply them."""
    import dataclasses
    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import ShardingPolicy
    arch, shape = "tinyllama-1.1b", "prefill_32k"
    full = tconfigs.get(arch)
    small = full.reduced(n_heads=16, n_kv_heads=16)
    over = {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
            if getattr(small, f.name) != getattr(full, f.name)}
    with tmesh.fake_world(256):
        mesh = tmesh.make_production_mesh(device_type="cpu")
        trace, model, _ = dryrun.lower_one(arch, shape, mesh,
                                           ShardingPolicy(), overrides=over)
    B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    cfg = model.cfg
    assert cfg.time_conditioning and cfg.n_heads == 16
    whole = dryrun.count_call(cfg, B, S)["flops"]
    time_flops = 2 * 2 * B * cfg.d_model * cfg.d_model
    want = (whole - time_flops) // 256 + time_flops // 16
    assert trace.flops == want, (trace.flops, want, whole)


def test_recorder_refuses_without_the_propagation_frame(monkeypatch):
    """The recorder finds DTensor's shape propagation by a private frame
    name; a torch without it stops the recorder instead of counting
    whole-size ops into a rank's."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    analysis.Recorder()
    for name in [n for n in vars(ShardingPropagator)
                 if n.startswith("_propagate_tensor_meta")]:
        monkeypatch.delattr(ShardingPropagator, name)
    with pytest.raises(RuntimeError, match="_propagate_tensor_meta"):
        analysis.Recorder()


def test_fuse_counts_the_kernels_bytes():
    """Under ``Recorder.fuse``, a call of ``ssd_scan`` (its plain version
    on CPU tensors) keeps its counted bytes, and ``fused_bytes`` makes
    them the fused kernel's: x, dt, A, B, C read once and y written
    once.  Outside the context the wrapper is the module's own again."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    B, S, H, P, N, L = 2, 64, 4, 8, 16, 16
    fn = ssd_ops.ssd_scan
    with FakeTensorMode():
        args = (torch.empty((B, S, H, P)), torch.empty((B, S, H)),
                torch.empty((H,)), torch.empty((B, S, N)),
                torch.empty((B, S, N)))
        plain = analysis.Recorder()
        with plain:
            ssd_ops.ssd_scan(*args, chunk=L)
        rec = analysis.Recorder()
        with rec.fuse(ssd_ops, "ssd_scan"), rec:
            ssd_ops.ssd_scan(*args, chunk=L)
    assert ssd_ops.ssd_scan is fn
    fused = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N)
    assert rec.bytes == plain.bytes > fused
    assert rec.bytes + rec.fused_bytes == fused


def test_mfu_is_model_flops_over_the_peak():
    """6 x 1e9 active parameters x 1e5 tokens in 2 s on 4 cards in bf16,
    and 2 x the same in f32 on one card."""
    assert analysis.mfu(6e14, 2.0, 4, "bfloat16") == pytest.approx(
        6e14 / (2.0 * 4 * 989e12), rel=1e-12)
    assert analysis.mfu(2e14, 5.0, 1, "float32") == pytest.approx(
        2e14 / (5.0 * 67e12), rel=1e-12)
