"""Training launcher on one device: the single-device counterpart of
``repro.launch.train``, with its options and defaults.  It has no
``--data-axis``: the port has no mesh yet.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dndm-text8 \
        --steps 100 --batch 32 --seq 128 --ckpt /tmp/text8

Runs on ``cuda`` unless ``--device`` names another device; without a GPU
and without ``--device`` it raises.  ``--ckpt`` writes the trained
parameters in the JAX package's checkpoint format.
"""
from __future__ import annotations

import argparse
import time

import torch

import repro_torch.configs as configs_lib
from repro_torch import device as device_lib
from repro_torch.core import noise as noise_lib, schedules as sched_lib
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.training.optim import AdamW, warmup_cosine
from repro_torch.training.trainer import init_state, make_train_step


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
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without a GPU)")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = configs_lib.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(bidirectional=True)
    model = Model(cfg, device=dev, seed=0)
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
        x0 = torch.as_tensor(batch["x0"], device=dev)
        state, metrics = step_fn(state, {"x0": x0}, gen)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"acc {float(metrics['masked_acc']):.3f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    if args.ckpt:
        convert.save_checkpoint(model, args.ckpt)
        print(f"saved params -> {args.ckpt}")


if __name__ == "__main__":
    main()
