"""Serving launcher: load a JAX checkpoint through the weight bridge (or
initialize from a seed), build the generation engine, drain a batch of
synthetic requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch dndm-text8 \
        --requests 16 --len 256 --steps 1000

Runs on ``cuda`` unless ``--device`` names another device; without a GPU
and without ``--device`` it raises.  With ``REPRO_TRACE=path.jsonl`` the
trace ends with the final metrics record, so that
``python -m repro_torch.obs.schema path.jsonl`` can check it.
"""
from __future__ import annotations

import argparse
import time

import repro_torch.configs as configs_lib
from repro_torch import device as device_lib
from repro_torch import obs
from repro_torch.core.samplers import registry
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.serving import BatchScheduler, EngineConfig, GenerationEngine


def main(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="registered samplers:\n" + registry.describe())
    ap.add_argument("--arch", default="dndm-text8",
                    choices=configs_lib.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default="",
                    help="JAX checkpoint (.npz + .json manifest)")
    ap.add_argument("--method", default="dndm_topk_static",
                    choices=registry.names(),
                    help="sampler (from the registry); ddim needs "
                         "--noise-kind multinomial, mask_predict absorbing")
    ap.add_argument("--noise-kind", default="absorbing",
                    choices=("absorbing", "multinomial"))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--nfe-budget", type=int, default=16)
    ap.add_argument("--ddim-stride", type=int, default=1,
                    help="DDIM timestep stride: NFE = ceil(steps / stride)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--len", type=int, default=64)
    ap.add_argument("--attn-impl", default="pallas",
                    choices=("einsum", "blocked", "pallas"),
                    help="pallas = the CUDA flash kernel on a CUDA device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without a GPU)")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = configs_lib.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(bidirectional=True, attn_impl=args.attn_impl)
    model = Model(cfg, device=dev, seed=args.seed)
    if args.ckpt:
        convert.load_checkpoint(model, args.ckpt)

    engine = GenerationEngine(model, EngineConfig(
        method=args.method, steps=args.steps, nfe_budget=args.nfe_budget,
        noise_kind=args.noise_kind, ddim_stride=args.ddim_stride),
        device=dev)
    sched = BatchScheduler(engine, max_batch=args.max_batch,
                           bucket_len=args.len, seed=args.seed, device=dev)
    t0 = time.time()
    for _ in range(args.requests):
        sched.submit(args.len)
    done = sched.run()
    wall = time.time() - t0
    nfe = sum(r.nfe for r in done.values())
    print(f"{len(done)} requests in {wall:.2f}s "
          f"({len(done) / wall:.2f} req/s), total NFE {nfe} on {dev}")
    if obs.tracing.sink_path() is not None:
        obs.tracing.close_sink(final_metrics=True)
    return done


if __name__ == "__main__":
    main()
