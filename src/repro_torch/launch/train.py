"""Training launcher: the counterpart of ``repro.launch.train``, with its
options and defaults.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dndm-text8 \
        --steps 100 --batch 32 --seq 128 --ckpt /tmp/text8

Runs on ``cuda`` unless ``--device`` names another device; without a GPU
and without ``--device`` it raises.  ``--ckpt`` writes the trained
parameters in the JAX package's checkpoint format.

Under ``torchrun`` (``WORLD_SIZE`` > 1) it trains on a ("data", "model")
mesh of ``(dp, world // dp)``, one process per device, with ``dp`` from
``--data-axis`` (0: every rank):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \
        --data-axis 2 --device cpu

The process group is NCCL on ``cuda`` (each rank on ``LOCAL_RANK``'s
card) and gloo with ``--device cpu``; a caller that has already
initialised one keeps it.  Model and optimizer are sharded by
``ShardingPolicy()``'s rules (``launch/sharding.py``), the tokens by
``tokens_spec``, and a MoE config dispatches through "shard_map", the
one dispatch a sharded MoE layer runs.  Only rank 0 prints and writes
``--ckpt``, after every rank has gathered the whole parameters.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

import repro_torch.configs as configs_lib
from repro_torch import device as device_lib
from repro_torch.core import noise as noise_lib, schedules as sched_lib
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.training import checkpoint
from repro_torch.training.optim import AdamW, warmup_cosine
from repro_torch.training.trainer import init_state, make_train_step


def _init_distributed(device: str | None):
    """(device, rank, world size or None alone, whether this call made the
    process group): one device alone, or a rank of the process group that
    ``torchrun``'s variables describe."""
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and not dist.is_initialized():
        return device_lib.resolve(device), 0, None, False
    cpu = device is not None and torch.device(device).type == "cpu"
    dev = torch.device("cpu") if cpu else device_lib.resolve(
        f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo" if cpu else "nccl")
    return dev, dist.get_rank(), dist.get_world_size(), made


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dndm-text8",
                    choices=configs_lib.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--T", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-axis", type=int, default=0,
                    help="data-parallel size (0 = all devices)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without a GPU)")
    args = ap.parse_args(argv)

    dev, rank, world, made_group = _init_distributed(args.device)
    cfg = configs_lib.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(bidirectional=True)
    mesh = policy = None
    if world is not None:
        dp = args.data_axis or world
        mesh = mesh_lib.make_mesh((dp, world // dp), ("data", "model"),
                                  dev.type)
        policy = sharding.ShardingPolicy()
        if cfg.n_experts:
            cfg = cfg.replace(moe_dispatch="shard_map")
    model = Model(cfg, device=dev, seed=0)
    if mesh is not None:
        sharding.shard_module(model, mesh, policy)
    sch = sched_lib.linear(args.T)
    nz = noise_lib.absorbing(cfg.vocab_size)
    opt = AdamW(schedule=warmup_cosine(args.lr, 20, args.steps))
    state = init_state(model, opt)
    step_fn = make_train_step(model, sch, nz, opt)
    gen = torch.Generator(device=dev).manual_seed(0)

    pipe = DataPipeline(DataConfig(task="unconditional",
                                   vocab=cfg.vocab_size - 1,
                                   seq_len=args.seq, batch=args.batch))
    t0 = time.time()
    for i, batch in enumerate(pipe):
        if i >= args.steps:
            break
        x0 = {"x0": torch.as_tensor(batch["x0"], device=dev)}
        if mesh is None:
            state, metrics = step_fn(state, x0, gen)
        else:
            with mesh_lib.use_mesh(mesh):
                state, metrics = step_fn(
                    state, sharding.shard_batch(x0, mesh, policy), gen)
        if rank == 0 and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"acc {float(metrics['masked_acc']):.3f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    if args.ckpt:
        named = {k: device_lib.full(p) for k, p in model.named_parameters()}
        if rank == 0:
            checkpoint.save(args.ckpt, convert.to_jax_tree(
                named, model.unit, model.n_super))
            print(f"saved params -> {args.ckpt}")
    if made_group:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
