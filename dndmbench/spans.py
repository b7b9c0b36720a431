"""The program's spans over the traced stretch: what the per-layer
host-time and idle-attribution readers share.

The port records its spans (``repro_torch.obs.tracing``) while a
``torch.profiler`` session records, so the harness's ``Profiled``
stretch holds them, stamped (``t0_ns``, ``t1_ns``) on the profiler's
own time base, Unix-epoch nanoseconds.  Each instant of the stretch
belongs to the innermost span open then: a span's *self* time is its
interval less its child spans'.  A layer's
host time is the self time of its spans less the CUDA runtime calls in
it: ``host_ms_per_call``'s arithmetic restricted to the layer, so the
layers' host times sum to at most that metric.  A program that records
no such spans (stamps absent) gives None, as does a run without a trace.
"""
from __future__ import annotations

import bisect
import collections
import time

# the layers the readers name, as span names
SCHED_SERVE = ("scheduler.pump", "runner.admit", "engine.plan")
ENGINE_SERVE = ("engine.stepwise", "runner.inputs", "runner.harvest")
ENGINE_BATCH = ("engine.generate", "sampler.call")
DENOISER = ("model.forward", "model.block")
DECODE = ("decode.draw", "decode.kernel")


def records(ctx) -> list | None:
    """The span records that overlap the traced stretch, or None."""
    t = ctx.trace
    if t is None or not t.calls or not t.wall_s:
        return None
    from repro_torch.obs import tracing
    recs = [r for r in tracing.records()
            if r.get("kind") == "span" and "t0_ns" in r]
    if not recs:
        return None
    lo, hi = stretch(ctx)
    return [r for r in recs if r["t1_ns"] > lo and r["t0_ns"] < hi] or None


def stretch(ctx) -> tuple[int, int]:
    """The traced stretch in Unix-epoch ns: ``Profiled``'s start on the
    host's monotonic clock, shifted by the program's epoch offset, and
    its wall time."""
    from repro_torch.obs import tracing
    offset = tracing.clock_ns() - time.perf_counter_ns()
    start = round(ctx.profiled._t0 * 1e9) + offset
    return start, start + round(ctx.trace.wall_s * 1e9)


def label(rec: dict) -> str:
    """A span's name; a block's with its kind (``model.block[attn]``)."""
    kind = rec["attrs"].get("kind") if rec["name"] == "model.block" else None
    return f"{rec['name']}[{kind}]" if kind else rec["name"]


def self_pieces(recs: list) -> list:
    """Each span's interval less its children's, as (start, end, record)
    pieces: disjoint, since spans nest on the serving thread."""
    kids = collections.defaultdict(list)
    for r in recs:
        kids[r["parent_id"]].append((r["t0_ns"], r["t1_ns"]))
    out = []
    for r in recs:
        cur = r["t0_ns"]
        for s, e in sorted(kids.get(r["span_id"], ())):
            if s > cur:
                out.append((cur, s, r))
            cur = max(cur, e)
        if r["t1_ns"] > cur:
            out.append((cur, r["t1_ns"], r))
    return out


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Cover:
    """Overlap queries against a union of intervals."""

    def __init__(self, intervals):
        self.iv = merged(intervals)
        self.starts = [s for s, _ in self.iv]

    def overlap(self, s: int, e: int) -> int:
        """ns of [s, e] that the union covers."""
        total = 0
        i = max(bisect.bisect_right(self.starts, s) - 1, 0)
        while i < len(self.iv) and self.iv[i][0] < e:
            total += max(0, min(e, self.iv[i][1]) - max(s, self.iv[i][0]))
            i += 1
        return total

    def holds(self, s: int, e: int) -> bool:
        """[s, e] lies inside one interval of the union."""
        i = bisect.bisect_right(self.starts, s) - 1
        return i >= 0 and e <= self.iv[i][1]


def _runtime(ctx) -> Cover:
    return Cover((s, s + d) for _, s, d in ctx.trace.runtime)


def layer_host_ms(ctx, names: tuple) -> float | None:
    """ms per traced call in which the innermost open span is one of
    ``names``, outside CUDA runtime calls."""
    recs = records(ctx)
    if recs is None:
        return None
    rt = _runtime(ctx)
    ns = sum(e - s - rt.overlap(s, e) for s, e, r in self_pieces(recs)
             if r["name"] in names)
    return ns / 1e6 / ctx.trace.calls


def idle_cover(ctx):
    """(idle ns of the stretch, a Cover of its idle intervals): the
    stretch less the union of its device operations."""
    lo, hi = stretch(ctx)
    busy = merged((max(s, lo), min(s + d, hi))
                  for _, s, d in ctx.trace.device_ops if s + d > lo and s < hi)
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return sum(e - s for s, e in gaps), Cover(gaps)


def idle_in_spans_share(ctx) -> float | None:
    """The share (%) of the device's idle time in the traced stretch
    during which some program span was open on the host."""
    recs = records(ctx)
    if recs is None or not ctx.trace.device_ops:
        return None
    total, idle = idle_cover(ctx)
    if total <= 0:
        return None
    opened = merged((r["t0_ns"], r["t1_ns"]) for r in recs)
    return 100.0 * sum(idle.overlap(s, e) for s, e in opened) / total


def by_span(ctx) -> dict | None:
    """Per span label, ms per traced call of host time (self time outside
    runtime calls) and of device idle time while it was the innermost
    open span; ``(outside spans)`` holds the rest of each, and
    ``launches_in_spans`` the share (%) of ``cudaLaunchKernel*`` runtime
    calls that lie inside some span's [t0, t1]."""
    recs = records(ctx)
    if recs is None:
        return None
    t, calls = ctx.trace, ctx.trace.calls
    rt = _runtime(ctx)
    total_idle, idle = idle_cover(ctx)
    host = collections.Counter()
    idle_ms = collections.Counter()
    for s, e, r in self_pieces(recs):
        host[label(r)] += (e - s - rt.overlap(s, e)) / 1e6 / calls
        idle_ms[label(r)] += idle.overlap(s, e) / 1e6 / calls
    host_all = 1e3 * t.host_own_s() / calls
    host["(outside spans)"] = host_all - sum(host.values())
    idle_ms["(outside spans)"] = total_idle / 1e6 / calls - sum(
        idle_ms.values())
    opened = Cover((r["t0_ns"], r["t1_ns"]) for r in recs)
    launches = [(s, s + d) for n, s, d in t.runtime
                if n.startswith("cudaLaunchKernel")]
    inside = sum(opened.holds(s, e) for s, e in launches)
    return {"host_ms": dict(host), "idle_ms": dict(idle_ms),
            "host_ms_per_call": host_all,
            "launches": len(launches),
            "launches_in_spans": (100.0 * inside / len(launches)
                                  if launches else None)}
