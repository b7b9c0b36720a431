"""One run of one cell: set-up, the measured window, the reference check,
the metrics, and the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration, whose
file holds the widths as run, and a traffic mix, ``traffic/<mix>.json``.
The mix's ``loop`` picks how it is served: ``open`` serves arrivals drawn by
``arrivals.py`` through ``ContinuousScheduler.submit``/``pump``;
``closed`` keeps one batch queued ahead of ``BatchScheduler.run``.  Its
``reference_check`` names the module of ``reference/`` that decides
``correct``.  Every metric, end-to-end and per-layer, is a reader
``metrics/<name>.py`` with ``read(ctx)``, given the :class:`Context`
below; a reader that finds nothing returns None and the metric is left
out.

A configuration file (``configs/<name>.json``) holds ``model``, the
widths as run, and names the parts that depend on its architecture
(:func:`parts` resolves them); a key left out means the default:

* ``reference``: a module of ``reference/`` (default ``"model"``), the
  plain forward that draws the weights and decides ``correct``; its
  interface is in ``reference/__init__.py``;
* ``work``: a module of ``work/`` (default ``"call"``) whose
  ``flops(c, rows, N)`` counts the model operations of one network call
  from the expanded widths ``c``; ``call_mfu`` reads it;
* ``config_factory``: ``"<module of repro_torch>:<function>"``, which
  returns the port's ``ModelConfig``; without it ``registry_id`` names an
  entry of ``repro_torch.configs``.  The reference's expansion of
  ``model`` is ``.replace``d onto that config.

So an architecture joins the benchmark as new files: its configuration,
its reference and its work count.  A cell joins as new files (its
configuration, its mix, its new metrics' readers) and entries appended
to ``BENCHMARK.json``, whose ``workloads`` of a metric is the only list
of the cells it reports in: no file that is there is edited.

A configuration whose reference defines ``forward_routed`` is routed:
its window runs under :func:`routes.recording`, the tap keeps every
call's expert choices, and the checks force them into the reference and
add ``routing_shortfall`` (``reference/routing.py``).  Only closed-loop
mixes serve a routed configuration.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

import numpy as np
import torch

from dndmbench import arrivals, routes, weights
from dndmbench.reference.routing import is_routed
from dndmbench.trace import Profiled, Trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
clock = time.perf_counter


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entry(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config_doc(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_doc(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def metric_reader(name: str, bench: Path = BENCH):
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "dndmbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_entries(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (those that list it, or list no
    cells), or with ``trace`` the per-layer ones that list it."""
    if trace:
        return [m for m in spec["per_layer"] if cell in m["workloads"]]
    return [m for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def subseed(seed: int, k: int) -> int:
    """An independent seed for purpose ``k`` of a run."""
    ss = np.random.SeedSequence([seed % 2 ** 64, k])
    return int(ss.generate_state(1, np.uint64)[0] >> 2)


class Parts(NamedTuple):
    """What a configuration file names: its reference and work modules,
    and the port's config of its widths."""
    reference: ModuleType
    work: ModuleType
    config: object               # repro_torch.models.config.ModelConfig


def part_module(kind: str, name: str, bench: Path = BENCH) -> ModuleType:
    """Module ``name`` of ``bench/<kind>/`` (``kind`` "reference" or
    "work").  The package's own are imported as ``dndmbench.<kind>.<name>``,
    so that a reference built on ``reference.model``'s helpers shares its
    precision switch; a module of another copy of the benchmark is loaded
    from its file."""
    if not name.isidentifier():
        raise ValueError(f"{kind} module {name!r} is not a module name")
    if bench == BENCH:
        return importlib.import_module(f"dndmbench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"dndmbench_{kind}_{name}", bench / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parts(doc: dict, bench: Path = BENCH) -> Parts:
    """The reference, work module and port config that configuration file
    ``doc`` names (module docstring)."""
    from repro_torch import configs as registry
    ref = part_module("reference", doc.get("reference", "model"), bench)
    work = part_module("work", doc.get("work", "call"), bench)
    if "config_factory" in doc:
        module, fn = doc["config_factory"].split(":")
        if module.split(".")[0] != "repro_torch":
            raise ValueError(f"config_factory {doc['config_factory']!r} is "
                             "not in repro_torch")
        base = getattr(importlib.import_module(module), fn)()
    else:
        base = registry.get(doc["registry_id"])
    c = ref.expand(doc["model"])
    fields = {k: v for k, v in c.items()
              if k not in ("block_unit", "n_super", "d_inner")}
    fields["block_pattern"] = tuple(c["block_pattern"])
    cfg = base.replace(**fields)
    if "d_inner" in c and cfg.d_inner != c["d_inner"]:
        raise ValueError(f"d_inner {cfg.d_inner} != {c['d_inner']}")
    return Parts(ref, work, cfg)


def percentile(values, q: int) -> float:
    """The q-th percentile, interpolated between order statistics."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


@dataclasses.dataclass
class Context:
    """What the metric readers read."""
    cell: str
    config: dict                 # the configuration's widths, expanded
    traffic: dict
    device: torch.device
    work: ModuleType | None = None   # the configuration's work module
    setup_s: float = 0.0
    window_s: float = 0.0        # open to close, on the host's clock
    calls: int = 0               # network calls made in the window
    tokens: int = 0              # tokens completed in the window
    requests: list = dataclasses.field(default_factory=list)
    completed_in_window: list = dataclasses.field(default_factory=list)
    queued_at_close: int = 0
    batches: list = dataclasses.field(default_factory=list)
    trace: Trace | None = None
    profiled: Profiled | None = None
    tap: LogitTap | None = None


# ---------------------------------------------------------------- program

def build_program(doc: dict, traffic: dict, seed: int, device,
                  p: Parts | None = None):
    """The port's model with the run's weights, and its engine; ``p`` is
    ``parts(doc)`` where the caller has it."""
    from repro_torch.models import convert
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, GenerationEngine
    p = p or parts(doc)
    model = Model(p.config, device=device, seed=0)
    convert.load_params(model, weights.make(doc["model"], seed, device,
                                            p.reference))
    engine = GenerationEngine(model, EngineConfig(
        method=traffic["method"], steps=traffic["T"],
        schedule=traffic["schedule"], noise_kind=traffic["noise"],
        x0_mode=traffic["x0_mode"], shared_tau=traffic["shared_tau"]),
        device=device)
    return engine


class Completions(dict):
    """A scheduler's ``done``, counting how often each request is
    finished: the scheduler records a finished row by ``done[rid] =
    request``, and a dict alone would keep one of two."""

    def __init__(self):
        super().__init__()
        self.count: dict[int, int] = {}

    def __setitem__(self, rid, request):
        self.count[rid] = self.count.get(rid, 0) + 1
        super().__setitem__(rid, request)

    def twice(self) -> int:
        """Completions beyond the first, over all requests."""
        return sum(n - 1 for n in self.count.values())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LogitTap:
    """Keeps the inputs and logits of some network calls of the window.

    It wraps ``GenerationEngine.denoise_fn``, the denoiser entry that
    both schedulers' samplers call once per network call, before any
    scheduler exists.  While ``active``, call ``i`` of the window is kept
    (cloned on the device, no synchronisation) as (x, t, logits,
    routing) when ``i % every == offset``, up to ``most`` calls.

    With a :class:`routes.Recording` as ``routes`` (a routed
    configuration), every call of the window also leaves its routed
    layers, (B, S, K) ids each, in ``routing[batch]``, in call order
    (``batch`` is set by the closed loop before each batch); without
    one, ``routing`` of a kept call is None."""

    def __init__(self, engine, every: int, offset: int, most: int):
        self.fn, self.every, self.offset, self.most = \
            engine.denoise_fn, every, offset, most
        self.routes: routes.Recording | None = None
        self.batch, self.routing = 0, {}
        self.active, self.seen, self.kept = False, 0, []
        engine.denoise_fn = self

    @property
    def active(self) -> bool:
        return self._active

    @active.setter
    def active(self, on: bool) -> None:
        self._active = on
        if self.routes is not None:
            self.routes.on = on

    def __call__(self, x, t, cond):
        out = self.fn(x, t, cond)
        if self.active:
            layers = None
            if self.routes is not None:
                layers = self.routes.take(*x.shape)
                self.routing.setdefault(self.batch, []).append(layers)
            if (self.seen % self.every == self.offset
                    and len(self.kept) < self.most and cond is None):
                self.kept.append((x.clone(), t.clone(), out.clone(), layers))
            self.seen += 1
        return out


def tap_for(engine, traffic: dict, seed: int,
            recording: routes.Recording | None = None) -> LogitTap:
    """The engine's tap, installed once and emptied for each window; the
    calls it keeps are every ``tap_every``-th, from an offset drawn from
    the seed.  ``recording`` is the open routing recording of a routed
    configuration."""
    every = traffic["tap_every"]
    offset = int(np.random.default_rng(subseed(seed, 5)).integers(every))
    tap = engine.denoise_fn
    if not isinstance(tap, LogitTap):
        tap = LogitTap(engine, every, offset, traffic["tap_most"])
    tap.routes, tap.batch, tap.routing = recording, 0, {}
    tap.offset, tap.active, tap.seen, tap.kept = offset, False, 0, []
    return tap


def routing_for(ref: ModuleType, traffic: dict):
    """The routing recording a run of ``traffic`` needs: open for a
    routed reference, nothing otherwise."""
    if not is_routed(ref):
        return contextlib.nullcontext()
    if traffic["loop"] != "closed":
        raise ValueError("a routed configuration is served only on a "
                         f"closed-loop mix, not {traffic['loop']!r}")
    return routes.recording()


# ---------------------------------------------------------------- loops

def warm_open(engine, traffic: dict, seed: int, device) -> None:
    """A throwaway scheduler makes a few full-width calls: every kernel of
    the cell's shape is built and loaded before the arrival clock
    starts."""
    from repro_torch.serving.scheduler import ContinuousScheduler
    s = ContinuousScheduler(engine, max_batch=traffic["rows"],
                            bucket_len=traffic["N"], seed=seed, device=device)
    for _ in range(traffic["rows"]):
        s.submit(traffic["N"])
    for _ in range(traffic.get("warm_calls", 3)):
        s.pump()
    _sync(device)


def run_open(engine, traffic: dict, seed: int, seconds: float, trace: bool,
             device, ctx: Context, t_start: float, warm: bool = True) -> dict:
    """Serve the arrival schedule; the window is ``seconds`` long after a
    ramp of ``ramp_s``, and the run goes on until every request due in it
    is done (or ``cap_s`` has passed).  With ``trace``, the first
    ``trace_calls`` calls after the close run under the profiler, whose
    stop takes seconds: the window stays clean.  Arrivals go on being
    submitted until those calls are done, so that the trace sees
    ``submit``; they are not due in the window and nothing waits for
    them."""
    from repro_torch.serving.scheduler import ContinuousScheduler
    N, cap = traffic["N"], traffic["cap_s"]
    if warm:
        warm_open(engine, traffic, subseed(seed, 3), device)
    sched_seed = subseed(seed, 1)
    sched = ContinuousScheduler(engine, max_batch=traffic["rows"],
                                bucket_len=N, seed=sched_seed, device=device)
    sched.done = Completions()
    due = arrivals.schedule(traffic, traffic["ramp_s"] + seconds
                            + (cap if trace else 0.0))
    t0 = clock()
    t_open, t_close = t0 + traffic["ramp_s"], t0 + traffic["ramp_s"] + seconds

    def in_window(rec):
        return t_open <= rec["due"] < t_close
    ctx.setup_s = t_open - t_start
    recs: dict[int, dict] = {}
    queued: set[int] = set()
    lateness = []
    i, busy, calls_open, calls_close = 0, False, None, None
    tracer, traced = None, 0
    while True:
        now = clock()
        feed = (float("inf") if trace and traced < traffic["trace_calls"]
                else t_close)
        while i < len(due) and t0 + due[i] <= now and t0 + due[i] < feed:
            rid = sched.submit(N)
            recs[rid] = {"due": t0 + due[i], "submit": clock(),
                         "order": len(recs)}
            if in_window(recs[rid]):
                lateness.append(recs[rid]["submit"] - recs[rid]["due"])
            queued.add(rid)
            i += 1
        if calls_open is None and now >= t_open:
            calls_open = sched.total_calls
            ctx.tap.active = True
        if calls_close is None and now >= t_close:
            calls_close = sched.total_calls
            ctx.tap.active = False
            ctx.queued_at_close = len(sched.queue)
        if now >= t_close and (now > t_close + cap or all(
                "done" in r for r in recs.values() if in_window(r))):
            break
        if not (busy or sched.queue):
            nxt = t0 + due[i] if i < len(due) else t_close
            time.sleep(max(0.0, min(nxt, t_close) - now) or 0.001)
            continue
        if trace and ctx.trace is None and now >= t_close:
            tracer = ctx.profiled = Profiled(device)
            ctx.trace = tracer.__enter__()
        before = set(queued)
        n_done = len(sched.done)
        t_pump = clock()
        busy = sched.pump()
        t_after = clock()
        for rid in before - {r.rid for r in sched.queue}:
            recs[rid]["admit"] = t_pump
            queued.discard(rid)
        if len(sched.done) != n_done:
            for rid in sched.done:
                recs[rid].setdefault("done", t_after)
        if tracer is not None:
            traced += 1
            if traced == traffic["trace_calls"]:
                tracer.__exit__(None, None, None)
                tracer = None
    if tracer is not None:
        tracer.__exit__(None, None, None)
    if ctx.trace is not None:
        ctx.trace.calls = traced
    _sync(device)
    if calls_close is None:
        calls_close = sched.total_calls
    ctx.window_s = seconds
    ctx.calls = calls_close - calls_open
    for rid, rec in recs.items():
        r = sched.done.get(rid)
        rec["nfe"] = r.nfe if r is not None else None
    done_in = [recs[rid] for rid in recs
               if "done" in recs[rid] and t_open <= recs[rid]["done"] < t_close]
    ctx.tokens = N * len(done_in)
    ctx.requests = [dict(rec, rid=rid) for rid, rec in recs.items()
                    if in_window(rec)]
    ctx.completed_in_window = done_in
    print(f"generator lateness: max {max(lateness, default=0.0):.6f} s, p90 "
          f"{percentile(lateness, 90) if lateness else 0.0:.6f} s over "
          f"{len(lateness)} arrivals due in the window", file=sys.stderr)
    return {"sched": sched, "records": recs, "sched_seed": sched_seed}


def run_closed(engine, traffic: dict, seed: int, seconds: float,
               trace: bool, device, ctx: Context, t_start: float,
               warm: bool = True) -> dict:
    """Batches of ``rows`` requests, one queued as the last completes; the
    first batch (the engine's cold key) is set-up.  The window opens at
    the dispatch of the first timed batch and closes at the completion of
    the last batch that ends inside ``seconds``.  With ``trace``, one
    more batch runs under the profiler after the window."""
    from repro_torch.serving.scheduler import BatchScheduler
    rows, N = traffic["rows"], traffic["N"]
    # the mix fixes the batches' seeds, so every run does the same sampler
    # work (a batch's NFE is its |unique tau|); the run's seed makes the
    # weights
    sched_seed = traffic["batch_seed"]
    sched = BatchScheduler(engine, max_batch=rows, bucket_len=N,
                           seed=sched_seed, device=device)
    sched.done = Completions()

    def one_batch():
        rids = [sched.submit(N) for _ in range(rows)]
        t0 = clock()
        sched.run()
        return rids, t0, clock()

    if warm:
        one_batch()                               # set-up: the cold key
    ctx.tap.active = True
    t_open = clock()
    ctx.setup_s = t_open - t_start
    batches = []
    while True:
        ctx.tap.batch = len(batches) + int(warm)
        rids, t0, t1 = one_batch()
        reqs = [sched.done[r] for r in rids]
        batches.append({"index": len(batches) + int(warm), "start": t0,
                        "end": t1, "nfe": reqs[0].nfe, "rids": rids})
        if t1 - t_open > seconds:
            batches.pop()
            break
        mean = (t1 - t_open) / len(batches)
        if t1 - t_open + mean > seconds:
            break
    ctx.tap.active = False
    if not batches:
        raise RuntimeError(f"no batch finished inside {seconds} s")
    t_close = batches[-1]["end"]
    ctx.window_s = t_close - t_open
    ctx.calls = sum(b["nfe"] for b in batches)
    ctx.tokens = rows * N * len(batches)
    ctx.batches = batches
    if trace:
        # one more batch, after the window, under the profiler
        prof = ctx.profiled = Profiled(device)
        with prof as tr:
            rids, _, _ = one_batch()
        ctx.trace = tr
        tr.calls = sched.done[rids[0]].nfe
    return {"sched": sched, "sched_seed": sched_seed}


# ---------------------------------------------------------------- checks

def trajectories(traffic: dict, out: dict, ctx: Context, seed: int):
    """(the sample of trajectories to replay, all of them, attempted,
    failed, accounting faults).  A trajectory is a request (open loop)
    or a batch (closed loop); its seed is the one the reference draws
    for it from the scheduler's seed.  ``done_twice`` counts the
    completions of any request beyond its first."""
    from dndmbench.reference.sampler import Trajectory, scheduler_seeds
    sched = out["sched"]
    rng = np.random.default_rng(subseed(seed, 4))
    trajs, seed_wrong = [], 0
    if traffic["loop"] == "open":
        seeds = scheduler_seeds(out["sched_seed"], len(out["records"]))
        attempted = len(ctx.requests)
        failed = sum(1 for rec in ctx.requests if "done" not in rec
                     or rec["done"] - rec["due"] > traffic["cap_s"])
        for rec in ctx.requests:
            r = sched.done.get(rec["rid"])
            if r is not None:
                want = seeds[rec["order"]]
                seed_wrong += int(r.seed != want)
                trajs.append(Trajectory(want, r.result[None], r.nfe))
        faults = {"seed_wrong": seed_wrong}
    else:
        seeds = scheduler_seeds(out["sched_seed"],
                                ctx.batches[-1]["index"] + 1)
        nfe_split = 0
        routing = ctx.tap.routing if ctx.tap.routes is not None else None
        for b in ctx.batches:
            reqs = [sched.done[r] for r in b["rids"]]
            want = seeds[b["index"]]
            seed_wrong += int(any(r.seed != want for r in reqs))
            nfe_split += int(len({r.nfe for r in reqs}) != 1)
            trajs.append(Trajectory(
                want, np.stack([r.result for r in reqs]), reqs[0].nfe,
                None if routing is None else routing.get(b["index"], [])))
        attempted, failed = len(trajs) * traffic["rows"], 0
        faults = {"seed_wrong": seed_wrong, "nfe_split": nfe_split}
    faults["done_twice"] = sched.done.twice()
    pick = set(rng.choice(len(trajs), size=min(traffic["check_trajectories"],
                                               len(trajs)),
                          replace=False).tolist())
    # the most-called trajectory is always among those replayed
    longest = max(range(len(trajs)), key=lambda j: trajs[j].nfe, default=None)
    if longest is not None and longest not in pick:
        pick.discard(max(pick))
        pick.add(longest)
    sample = [trajs[j] for j in sorted(pick)]
    return sample, trajs, attempted, failed, faults


def judge(traffic: dict, doc: dict, seed: int, device, sample, trajs,
          faults: dict, failed: int, kept: list, ref: ModuleType) -> dict:
    """The numbers compared, each with its limit: {name: (value,
    limit)}.  A number passes when it is at most its limit.  The
    configuration's reference ``ref`` draws the weights and computes the
    logits; a routed one is forced to the program's expert choices, and
    adds ``routing_shortfall``."""
    check = importlib.import_module(
        f"dndmbench.reference.{traffic['reference_check']}")
    tree = weights.make(doc["model"], seed, device, ref)
    T, shared = traffic["T"], traffic["shared_tau"]
    r = check.check_logits(kept, tree, doc["model"], device=device,
                           reference=ref)
    kept.clear()
    r = check.check(sample, tree, doc["model"], T=T, shared=shared,
                    device=device, block_rows=traffic["ref_rows"], readings=r,
                    reference=ref)
    probs = torch.as_tensor(check.linear_transition_probs(T),
                            dtype=torch.float32, device=device)
    nfe_wrong = sum(int(t.nfe != check.nfe_of(t.seed, probs, t.tokens.shape[0],
                                              t.tokens.shape[1], shared,
                                              device)) for t in trajs)
    mask_left = sum(int((t.tokens == doc["model"]["vocab_size"] - 1).sum())
                    for t in trajs)
    checks = {"logit_err": (r.logit_err, traffic["limits"]["logit_err"]),
              "logit_calls_short": (max(0, traffic["tap_min"] - r.calls), 0),
              "widest_gap": (r.widest_gap, traffic["limits"]["widest_gap"]),
              **({"routing_shortfall": (
                  r.routing_shortfall,
                  traffic["limits"]["routing_shortfall"])}
                 if is_routed(ref) else {}),
              "tokens_checked_short": (
                  max(0, traffic["check_min_tokens"] - r.tokens), 0),
              "nfe_wrong": (nfe_wrong, 0),
              "mask_left": (mask_left, 0),
              "failed": (failed, 0)}
    checks.update({k: (v, 0) for k, v in faults.items()})
    return checks


# ---------------------------------------------------------------- a run

def no_jax() -> list[str]:
    """Modules loaded whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(spec: dict, cell: str, doc: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             bench: Path = BENCH) -> dict:
    """One run; returns the result line's object.  ``bench`` holds the
    parts that ``doc`` names and the metric readers."""
    device = torch.device(device)
    p = parts(doc, bench)
    ctx = Context(cell, p.reference.expand(doc["model"]), traffic, device,
                  p.work)
    routed = routing_for(p.reference, traffic)
    engine = build_program(doc, traffic, subseed(seed, 0), device, p)
    with routed as recording:
        ctx.tap = tap_for(engine, traffic, seed, recording)
        if device.type == "cuda":
            # the peak of serving, not of the load's transient weight
            # buffers
            torch.cuda.reset_peak_memory_stats(device)
        serve = {"open": run_open, "closed": run_closed}[traffic["loop"]]
        out = serve(engine, traffic, seed, seconds, trace, device, ctx,
                    t_start)
        _sync(device)
    if ctx.profiled is not None:
        ctx.profiled.collect()
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.wall_s
    sample, trajs, attempted, failed, faults = trajectories(
        traffic, out, ctx, seed)
    kept = ctx.tap.kept
    ctx.tap = None
    del out, engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(traffic, doc, subseed(seed, 0), device, sample, trajs,
                   faults, failed, kept, p.reference)
    metrics = {}
    for m in metric_entries(spec, cell, trace):
        value = metric_reader(m["name"], bench).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace and ctx.trace is not None and ctx.trace.device_ops:
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv: list[str], t_start: float) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    spec = load_spec()
    cell = cell_entry(spec, a.workload)
    doc = config_doc(spec, cell["config"])
    traffic = traffic_doc(cell["traffic"])
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, a.workload, doc, traffic, a.seed, a.seconds,
                      bool(a.trace), "cuda:0", t_start)
    found = no_jax()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
