#!/usr/bin/env python3
"""Where the program's spans put a traced stretch's host and idle time;
what recording them costs.  Not part of a run.

    python3 dndmbench/span_report.py --workload CELL --seed N --seconds S
        ``run.py --trace 1`` (its result line), then one more JSON line
        from the same traced stretch: host ms and device-idle ms per call
        by span (``model.block`` by kind; ``spans.by_span``), the share of
        ``cudaLaunchKernel*`` calls inside spans, and the layer readers'
        sum beside ``host_ms_per_call``.
    python3 dndmbench/span_report.py --cost --calls 200 --seed N
        text8-serve's shape (``ContinuousScheduler``, 32 rows, N 256, T
        1000, the queue kept full): ``calls`` warm calls per arm under
        the profiler (CUDA activity) with span recording on and with it
        forced off, in blocks of a quarter, on, off, off, on, twice,
        then half as many with no profiler: ms per call and the host's
        own ms per call (outside CUDA runtime calls) per block; first,
        the seconds of one empty span, recorded and not.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT / "src"), str(ROOT)]
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402

from dndmbench import harness, spans  # noqa: E402
from dndmbench.trace import Profiled  # noqa: E402

SERVE_LAYERS = ["sched_host_ms_per_call.serve",
                "engine_host_ms_per_call.serve",
                "denoiser_host_ms_per_call.serve",
                "decode_host_ms_per_call.serve"]
BATCH_LAYERS = ["engine_host_ms_per_call.batch",
                "denoiser_host_ms_per_call.batch",
                "decode_host_ms_per_call.batch"]


def report(a) -> int:
    seen = {}
    records = spans.records

    def keep(ctx):
        seen["ctx"] = ctx
        return records(ctx)
    spans.records = keep
    rc = harness.main(["--workload", a.workload, "--seed", str(a.seed),
                       "--seconds", str(a.seconds), "--trace", "1"], T_START)
    ctx = seen.get("ctx")
    table = spans.by_span(ctx) if ctx is not None else None
    if table is not None:
        names = SERVE_LAYERS if a.workload.endswith("serve") else BATCH_LAYERS
        table["layers_ms"] = {
            n: harness.metric_reader(n).read(ctx) for n in names}
        table["calls"] = ctx.trace.calls
        table["wall_s"] = ctx.trace.wall_s
    print(json.dumps({"span_report": a.workload, "table": table}))
    return rc


def cost(a) -> int:
    from repro_torch.obs import tracing
    from repro_torch.serving.scheduler import ContinuousScheduler
    spec = harness.load_spec()
    cell = harness.cell_entry(spec, "text8-serve")
    doc = harness.config_doc(spec, cell["config"])
    traffic = harness.traffic_doc(cell["traffic"])
    device = torch.device("cuda:0")
    engine = harness.build_program(doc, traffic, a.seed, device)
    sched = ContinuousScheduler(engine, max_batch=traffic["rows"],
                                bucket_len=traffic["N"], seed=a.seed,
                                device=device)

    def serve(n):
        for _ in range(n):
            while len(sched.queue) < 2:
                sched.submit(traffic["N"])
            sched.pump()

    serve(20)
    torch.cuda.synchronize(device)
    card = torch.cuda.get_device_name(device)
    prof = Profiled(device)
    with prof:
        on = _span_seconds(tracing)
    prof.collect()
    print(json.dumps({"span_us_recorded": 1e6 * on,
                      "span_us_off": 1e6 * _span_seconds(tracing),
                      "card": card}), flush=True)
    profiling = tracing._profiling
    n = a.calls // 4
    for arm in ("on", "off", "off", "on") * 2 + ("bare", "bare"):
        tracing.clear()
        if arm == "bare":
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            serve(n)
            torch.cuda.synchronize(device)
            line = {"ms_per_call": 1e3 * (time.perf_counter() - t0) / n}
        else:
            if arm == "off":
                tracing._profiling = lambda: False
            prof = Profiled(device)
            try:
                with prof as tr:
                    serve(n)
            finally:
                tracing._profiling = profiling
            prof.collect()
            line = {"ms_per_call": 1e3 * tr.wall_s / n,
                    "host_ms_per_call": 1e3 * tr.host_own_s() / n}
        line.update(arm=arm, calls=n, card=card,
                    spans=len(tracing.records()))
        print(json.dumps(line), flush=True)
    return 0


def _span_seconds(tracing, n: int = 20000) -> float:
    """Seconds per empty ``layer_span`` (recorded while a profiler
    records, else the no-op singleton)."""
    t0 = time.perf_counter()
    for _ in range(n):
        with tracing.layer_span("span_report.probe"):
            pass
    dt = (time.perf_counter() - t0) / n
    tracing.clear()
    return dt


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=45.0)
    p.add_argument("--cost", action="store_true")
    p.add_argument("--calls", type=int, default=200)
    a = p.parse_args()
    return cost(a) if a.cost else report(a)


if __name__ == "__main__":
    sys.exit(main())
