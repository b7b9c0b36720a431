#!/usr/bin/env python3
"""Readings that set a cell's limits and rate; not part of a run.

    python3 dndmbench/calibrate.py --workload CELL --seeds 1,2,3 \\
        --control 3 --seconds S
        Per seed, in one process (the engine built once, the weights made
        anew from each seed): a short window of the cell's traffic, then
        the reference check of the window's trajectories; the first
        ``--control`` seeds also read the control, the reference with
        TF32 products.  One JSON line per seed.
    python3 dndmbench/calibrate.py --workload CELL --seeds 1 \\
        --sweep 2.0,2.4,2.8 --seconds S
        An open-loop cell served at each rate for ``S`` seconds: latency
        percentiles, requests due and completed, the queue at the close.
    ``--fault NAME`` plants a fault of ``faults.py`` under the program
    for the readings.  A routed configuration's readings are taken with
    the program's expert choices forced into the reference, and add
    ``routing_shortfall`` (with ``--control``, the TF32 reference's).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from dndmbench import faults, harness, readers, weights  # noqa: E402


def window(doc, p, engine, traffic, seed, seconds, device, first,
           recording=None):
    ctx = harness.Context("calibrate", p.reference.expand(doc["model"]),
                          traffic, device, p.work)
    ctx.tap = harness.tap_for(engine, traffic, seed, recording)
    serve = {"open": harness.run_open,
             "closed": harness.run_closed}[traffic["loop"]]
    out = serve(engine, traffic, seed, seconds, False, device, ctx,
                time.perf_counter(), warm=first)
    return ctx, out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sweep", default="")
    p.add_argument("--fault", default="",
                   choices=["", *faults.FAULTS, *faults.ROUTED_FAULTS],
                   help="a fault of faults.py planted under the program")
    a = p.parse_args()
    spec = harness.load_spec()
    cell = harness.cell_entry(spec, a.workload)
    doc = harness.config_doc(spec, cell["config"])
    traffic = harness.traffic_doc(cell["traffic"])
    device = torch.device("cuda:0")
    seeds = [int(s) for s in a.seeds.split(",")]
    p = harness.parts(doc)
    engine = harness.build_program(doc, traffic,
                                   harness.subseed(seeds[0], 0), device, p)
    if a.fault:
        {**faults.FAULTS, **faults.ROUTED_FAULTS}[a.fault](setattr)
    print(json.dumps({"card": torch.cuda.get_device_name(device),
                      "setup_s": time.perf_counter() - T_START}), flush=True)
    if a.sweep:
        for i, rate in enumerate(float(r) for r in a.sweep.split(",")):
            tr = dict(traffic, rate_per_s=rate)
            ctx, out = window(doc, p, engine, tr, seeds[0], a.seconds,
                              device, i == 0)
            sched = out["sched"]
            late = [r for r in ctx.requests if "done" not in r]
            print(json.dumps({
                "rate_per_s": rate, "due": len(ctx.requests),
                "completed": len(ctx.requests) - len(late),
                "latency_p50_s": readers.latency(ctx, 50),
                "latency_p90_s": readers.latency(ctx, 90),
                "queue_wait_p90_s": readers.queue_wait(ctx, 90),
                "rows_per_call": readers.live_rows_per_call(ctx),
                "ms_per_call": readers.ms_per_call(ctx),
                "queued_at_close": ctx.queued_at_close,
                "tokens_per_s": ctx.tokens / ctx.window_s}), flush=True)
            del out, sched
            gc.collect()
        return 0
    with harness.routing_for(p.reference, traffic) as recording:
        for i, seed in enumerate(seeds):
            readings(doc, p, engine, traffic, seed, i < a.control,
                     a.seconds, device, i == 0, recording)
    return 0


def readings(doc, p, engine, traffic, seed, control, seconds, device,
             first, recording):
    """One seed's window on weights made anew from ``seed`` (but the
    first's, which the engine was built with), and its readings as one
    JSON line."""
    from repro_torch.models import convert
    t0 = time.perf_counter()
    if not first:
        convert.load_params(engine.model, weights.make(
            doc["model"], harness.subseed(seed, 0), device, p.reference))
    ctx, out = window(doc, p, engine, traffic, seed, seconds, device, first,
                      recording)
    sample, trajs, attempted, failed, counts = harness.trajectories(
        traffic, out, ctx, seed)
    t1 = time.perf_counter()
    check = __import__(f"dndmbench.reference.{traffic['reference_check']}",
                       fromlist=["check"])
    tree = weights.make(doc["model"], harness.subseed(seed, 0), device,
                        p.reference)
    r = check.check_logits(ctx.tap.kept, tree, doc["model"], device=device,
                           control=control, reference=p.reference)
    ctx.tap.kept = []
    r = check.check(sample, tree, doc["model"], T=traffic["T"],
                    shared=traffic["shared_tau"], device=device,
                    block_rows=traffic["ref_rows"], control=control,
                    readings=r, reference=p.reference)
    del tree
    routed = harness.is_routed(p.reference)
    print(json.dumps({
        "seed": seed, "logit_err": r.logit_err,
        "control_logit_err": r.control_logit_err if control else None,
        "calls": r.calls, "widest_gap": r.widest_gap,
        "control_gap": r.control_gap if control else None,
        "control_flips": r.control_flips if control else None,
        **({"routing_shortfall": r.routing_shortfall,
            "control_routing_shortfall": (r.control_routing_shortfall
                                          if control else None)}
           if routed else {}),
        "tokens": r.tokens, "nfe_wrong": r.nfe_wrong,
        "mask_left": r.mask_left, "attempted": attempted,
        "failed": failed, "faults": counts,
        "ms_per_call": readers.ms_per_call(ctx),
        "window_s": t1 - t0, "check_s": time.perf_counter() - t1}),
        flush=True)
    del out
    gc.collect()


if __name__ == "__main__":
    sys.exit(main())
