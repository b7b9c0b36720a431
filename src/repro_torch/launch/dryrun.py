"""Multi-pod dry run of the port: trace every (architecture x input shape)
on the production meshes without a device, and record memory, cost and
collective analysis against an H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        [--arch A|all] [--shape S|all] [--mesh single|multi|both]

The port of ``repro.launch.dryrun``, with its functions, flags, output
names (``<out>/<arch>__<shape>__<mesh><tag>.json``) and record keys.
Where the reference lowers and compiles under 512 placeholder XLA
devices, the port traces one rank eagerly:

* the 256- or 512-rank mesh lives in a fake process group
  (``launch/mesh.py::fake_world``): collectives complete at once;
* weights, optimizer state, inputs and activations are fake tensors
  (``FakeTensorMode``): shapes and dtypes, no memory, no arithmetic;
* the model is sharded by ``launch/sharding.py``'s rules as DTensors,
  and ``launch/analysis.py::Recorder`` counts what rank 0 runs: FLOPs,
  bytes of every op, collectives with their groups, and the peak of
  live bytes.

Per combination the step the shape dictates runs once, with the mesh
ambient (``use_mesh``):

  train_4k     -> the train step (loss, gradients, AdamW; ``microbatches``
                  from the overrides)
  prefill_32k  -> the denoiser forward, ``causal=False`` (one DNDM NFE)
  decode_*     -> ``Model.decode_step`` at ``pos = seq_len - 1`` over a
                  sharded cache, updated in place

There is no compiler: the numbers are those of eager PyTorch, one kernel
per op, with the attention's S x S traffic replaced by the fused
kernel's model where the card runs it fused (:func:`attention_bytes`),
and so the SSD scan's chunk intermediates at inference, where the card
runs ``ssd_scan`` (``analysis.Recorder.fuse``; training scans through the
plain version on the card too).
They are model-based bounds, not measurements.  Importing this module
opens no process group and leaves the environment alone.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

import repro_torch.configs as configs_lib
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import noise as noise_lib
from repro_torch.core import schedules as sched_lib
from repro_torch.launch import analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import spmd
from repro_torch.launch.sharding import (ShardingPolicy, placements,
                                         shard_batch, shard_cache,
                                         shard_module, tokens_spec)
from repro_torch.models.frontend import frontend_spec
from repro_torch.models.model import Model
from repro_torch.training.optim import AdamW, constant
from repro_torch.training.trainer import init_state, make_train_step


def build_model(arch: str, shape_name: str, policy: ShardingPolicy,
                dtype: str = "bfloat16", remat: bool = True,
                overrides: dict | None = None) -> Model:
    """The model of ``arch`` for ``shape_name``, on the CPU: call it under
    a fake tensor mode, where it allocates nothing."""
    cfg = configs_lib.get(arch)
    shp = SHAPES[shape_name]
    if shp.name == "long_500k":
        cfg = configs_lib.for_long_context(cfg)
    cfg = cfg.replace(dtype=dtype, scan_layers=False,
                      remat=(remat and shp.kind == "train"),
                      bidirectional=(shp.kind != "decode"))
    if overrides:
        cfg = cfg.replace(**overrides)
    return Model(cfg, device="cpu")


def input_specs(model: Model, shape_name: str, mesh,
                policy: ShardingPolicy) -> dict:
    """Fake DTensor stand-ins for every model input, placed as the
    reference places them."""
    cfg = model.cfg
    shp = SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    tok_spec = tokens_spec(mesh, B, policy,
                           seq_shard=(shp.kind in ("train", "prefill")))
    batch_pl = placements(tok_spec[:1], mesh)
    specs: dict = {}
    if shp.kind in ("train", "prefill"):
        from torch.distributed.tensor import distribute_tensor
        specs["tokens"] = distribute_tensor(
            torch.empty((B, S), dtype=torch.int64), mesh,
            placements(tok_spec, mesh), src_data_rank=None)
        specs["t"] = distribute_tensor(torch.empty((B,)), mesh, batch_pl,
                                       src_data_rank=None)
        if cfg.frontend:
            specs["frontend_embeds"] = frontend_spec(cfg, B, mesh, batch_pl)
    else:
        specs["token"] = shard_batch(
            {"token": torch.empty((B, 1), dtype=torch.int64)}, mesh,
            policy)["token"]
        specs["pos"] = S - 1
        specs["cache"] = shard_cache(
            model.init_cache(B, S, getattr(torch, cfg.dtype)), mesh, B,
            policy)
    return specs


def param_specs(model: Model, mesh, policy: ShardingPolicy) -> dict:
    """Shards ``model``'s parameters in place; {name: DTensor}."""
    shard_module(model, mesh, policy)
    return dict(model.named_parameters())


def state_specs(model: Model, optimizer, mesh, policy: ShardingPolicy):
    """The train state of the sharded model: parameters, AdamW moments
    placed as they are, step counters."""
    param_specs(model, mesh, policy)
    return init_state(model, optimizer)


def attention_bytes(cfg, q_shape: tuple, S: int, mode: str) -> float:
    """Bytes per card that the dry run adds for one rank's attention
    blocks (whole step): the fused kernel's model, q and o of the rank's
    rows and k and v of all rows read or written once (the backward
    twice that), less what the recorder counted for the plain version
    that the CPU traces (its S x S logits).  Zero for "einsum", which
    materialises its logits on the card too, and for decode.  ``q_shape``
    is the rank's (B, rows, heads, hd) block of the queries."""
    n_attn = analysis.attention_blocks(cfg)
    if (cfg.attn_impl not in ("pallas", "blocked", "blocked_unrolled")
            or mode == "decode" or not n_attn):
        return 0.0
    B, Sq, H, hd = q_shape
    dt = getattr(torch, cfg.dtype)
    flash = float(dt.itemsize * B * H * hd * (2 * Sq + 2 * S))
    train = mode == "train"
    q = torch.empty(q_shape, dtype=dt, requires_grad=train)
    k, v = (torch.empty((B, S, H, hd), dtype=dt, requires_grad=train)
            for _ in range(2))
    fwd, bwd = analysis.Recorder(), analysis.Recorder()
    with fwd:
        y = spmd.local_attention(q, k, v, cfg, causal=False,
                                          window=0, row0=0, S=S)
    if not train:
        return n_attn * (flash - fwd.bytes)
    with bwd:
        y.sum().backward()
    n_fwd = 2 if cfg.remat else 1              # remat runs it again
    return n_attn * (n_fwd * (flash - fwd.bytes) + 2 * flash - bwd.bytes)


def _q_block(model: Model, tokens, mesh) -> tuple:
    """The rank's (B, rows, heads, hd) block of the queries for ``tokens``
    placed as they are: heads split over the model axis as
    ``spmd.ShardedAttention._split_heads`` keeps them."""
    from repro_torch.device import local_block
    cfg = model.cfg
    (B, S), _ = local_block(tokens)
    H = cfg.n_heads
    attn = next((b.attn for b in [model.shared, *model.blocks]
                 if hasattr(b, "attn")), None)
    if attn is not None and getattr(attn.wq, "placements", None):
        m = mesh_lib.axis_sizes(mesh).get("model", 1)
        if any(getattr(p, "dim", None) == 1 for p in attn.wq.placements) \
                and H % m == 0:
            H //= m
    return (B, S, H, cfg.hd)


def count_call(cfg, batch: int, seq: int) -> dict:
    """One denoiser call of ``cfg`` (``batch`` x ``seq`` tokens, causal
    False, no autograd) on one device, counted on fake CPU tensors:
    {"flops", "bytes", "attn_bytes"} (:func:`attention_bytes`),
    "fused_bytes" (the ``ssd_scan`` launches', ``Recorder.fuse``) and
    "model_flops" (``analysis.model_flops``).  The kernels' CPU routes run
    their plain versions, whose products the counter sees."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rec = analysis.Recorder()
    with FakeTensorMode():
        model = Model(cfg, device="cpu")
        tokens = torch.empty((batch, seq), dtype=torch.int64)
        t = torch.empty((batch,))
        with torch.no_grad(), rec.fuse(ssd_ops, "ssd_scan"), rec:
            model(tokens, t, causal=False)
        attn = attention_bytes(cfg, (batch, seq, cfg.n_heads, cfg.hd), seq,
                               "prefill")
        mf = analysis.model_flops(model, batch * seq, "prefill")
    return {"flops": rec.flops, "bytes": rec.bytes, "attn_bytes": attn,
            "fused_bytes": rec.fused_bytes, "model_flops": mf}


class Trace:
    """What :func:`lower_one` counted for rank 0: ``flops``, ``bytes``,
    ``collectives``, ``attn_bytes`` (per card, :func:`attention_bytes`),
    ``fused_bytes`` (per card, ``Recorder.fuse``) and ``memory`` (the
    reference's four fields)."""

    def __init__(self, rec: analysis.Recorder, arg_bytes: int,
                 out_bytes: int, alias_bytes: int, attn_bytes: float):
        self.flops = rec.flops
        self.bytes = rec.bytes
        self.collectives = rec.collectives
        self.attn_bytes = attn_bytes
        self.fused_bytes = rec.fused_bytes
        self.memory = {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "temp_bytes": rec.peak - arg_bytes,
                       "alias_bytes": alias_bytes}


def lower_one(arch: str, shape_name: str, mesh, policy: ShardingPolicy,
              remat: bool = True, overrides: dict | None = None):
    """Traces one combination on fake tensors; returns (trace, model,
    wall_times)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    overrides = dict(overrides or {})
    microbatches = overrides.pop("microbatches", 1)   # trainer-level knob
    shp = SHAPES[shape_name]
    rec = analysis.Recorder()
    with FakeTensorMode():
        model = build_model(arch, shape_name, policy, remat=remat,
                            overrides=overrides)
        cfg = model.cfg
        t0 = time.time()
        if shp.kind == "train":
            opt = AdamW(schedule=constant(1e-4))
            state = state_specs(model, opt, mesh, policy)
            specs = input_specs(model, shape_name, mesh, policy)
            batch = {"x0": specs["tokens"]}
            if cfg.frontend:
                batch["frontend_embeds"] = specs["frontend_embeds"]
            step = make_train_step(model, sched_lib.linear(50),
                                   noise_lib.absorbing(cfg.vocab_size), opt,
                                   microbatches=microbatches)
            args = (state, batch)
            arg_bytes = rec.track(args)
            gen = torch.Generator().manual_seed(0)
            with mesh_lib.use_mesh(mesh), rec:
                out = step(state, batch, gen)
        else:
            param_specs(model, mesh, policy)
            specs = input_specs(model, shape_name, mesh, policy)
            args = (dict(model.named_parameters()), specs)
            arg_bytes = rec.track(args)
            with mesh_lib.use_mesh(mesh), implicit_replication(), \
                    torch.no_grad(), rec.fuse(ssd_ops, "ssd_scan"), rec:
                if shp.kind == "prefill":
                    out = model(specs["tokens"], specs["t"],
                                specs.get("frontend_embeds"), causal=False)
                else:
                    out = model.decode_step(specs["token"], specs["cache"],
                                            specs["pos"])
        t_lower = time.time() - t0
        arg_keys = {id(analysis.local(t).untyped_storage())
                    for t in analysis._tensors(args)}
        outs = {id(st): st.nbytes() for st in (
            analysis.local(t).untyped_storage()
            for t in analysis._tensors(out))}
        out_bytes = sum(outs.values())
        alias_bytes = sum(b for k, b in outs.items() if k in arg_keys)
        attn = 0.0
        if shp.kind != "decode":
            attn = attention_bytes(cfg, _q_block(model, specs["tokens"],
                                                 mesh),
                                   shp.seq_len, shp.kind)
    trace = Trace(rec, arg_bytes, out_bytes, alias_bytes, attn)
    # no compiler: eager PyTorch runs what was traced, op by op
    return trace, model, {"lower_s": t_lower, "compile_s": 0.0}


def analyse(arch: str, shape_name: str, mesh_name: str, trace: Trace,
            model, walls: dict) -> dict:
    shp = SHAPES[shape_name]
    n_chips = 512 if mesh_name == "multi_pod" else 256
    coll = analysis.collective_bytes(trace.collectives)
    n_tokens = (shp.global_batch * shp.seq_len
                if shp.kind in ("train", "prefill") else shp.global_batch)
    mode = shp.kind
    mf = analysis.model_flops(model, n_tokens, mode)
    cost = {"flops": trace.flops, "bytes accessed": trace.bytes}
    terms = analysis.roofline(
        cost, coll, n_chips, mf, 0.0,
        (trace.attn_bytes + trace.fused_bytes) * n_chips,
        dtype=model.cfg.dtype,
        collective_s=analysis.collective_seconds(trace.collectives))
    total, active = analysis.param_counts(model)
    per_card = trace.memory["argument_bytes"] + trace.memory["temp_bytes"]
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_chips": n_chips,
        "params_total": total, "params_active": active,
        "memory": dict(trace.memory),
        "cost": cost,
        "collectives": coll,
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "model_flops": terms.model_flops,
            "hlo_flops_per_chip": terms.hlo_flops,
            "useful_ratio": terms.useful_ratio,
            "scan_correction_flops": terms.scan_correction_flops,
            "attn_bytes_correction_per_chip": trace.attn_bytes,
            "fused_bytes_correction_per_chip": trace.fused_bytes,
        },
        "per_chip_peak_bytes": per_card,
        "fits_80gb": per_card <= 80e9,
        "walls": walls,
    }


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: str, policy: ShardingPolicy | None = None,
            tag: str = "", overrides: dict | None = None) -> dict:
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    out_path = os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_name}{tag}.json")
    policy = policy or ShardingPolicy()
    shape, _ = mesh_lib.PRODUCTION[multi_pod]
    try:
        with mesh_lib.fake_world(math.prod(shape)):
            mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                 device_type="cpu")
            trace, model, walls = lower_one(arch, shape_name, mesh, policy,
                                            overrides=overrides)
            rec = analyse(arch, shape_name, mesh_name, trace, model, walls)
        rec["status"] = "ok"
        rec["tag"] = tag
        rec["overrides"] = overrides or {}
    except Exception as e:  # noqa: BLE001 — record failures, don't die
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summary(rec: dict) -> str:
    """One line of a record: status, and for an ``ok`` one the dominant
    term, the three times and the per-card memory against 80 GB."""
    if rec["status"] != "ok":
        return f"{rec['status']} {rec['error'][:160]}"
    r = rec["roofline"]
    return (f"ok dom={r['dominant']} c={r['compute_s']:.3e}s "
            f"m={r['memory_s']:.3e}s x={r['collective_s']:.3e}s "
            f"useful={r['useful_ratio']:.3f} "
            f"mem={rec['per_chip_peak_bytes'] / 1e9:.2f}/80GB "
            f"({'fits' if rec['fits_80gb'] else 'does not fit'})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = (configs_lib.ASSIGNED_ARCHS if args.arch == "all"
             else [args.arch])
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                mesh_name = "multi_pod" if mp else "single_pod"
                path = os.path.join(
                    args.out, f"{arch}__{shape_name}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"skip {path}")
                    continue
                t0 = time.time()
                rec = run_one(arch, shape_name, mp, args.out)
                print(f"[{time.time()-t0:6.1f}s] {arch} x {shape_name} x "
                      f"{mesh_name}: {summary(rec)}", flush=True)


if __name__ == "__main__":
    main()
