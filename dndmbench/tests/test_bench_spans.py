"""The span readers (``spans.py``, ``metrics/*_host_ms_per_call.*``,
``metrics/idle_in_spans_share.*``) on a hand-built trace and span
records with known answers, and on the tiny text8 model served under the
profiler on the CPU."""
from __future__ import annotations

import time
import types

import pytest

from dndmbench import harness, readers, spans
from dndmbench.tests import tiny
from dndmbench.trace import Trace

US = 1000                       # ns
SERVE = ["sched_host_ms_per_call.serve", "engine_host_ms_per_call.serve",
         "denoiser_host_ms_per_call.serve", "decode_host_ms_per_call.serve"]
BATCH = ["engine_host_ms_per_call.batch", "denoiser_host_ms_per_call.batch",
         "decode_host_ms_per_call.batch"]


def _span(sid, parent, name, t0, t1, **attrs):
    return {"kind": "span", "name": name, "span_id": sid,
            "parent_id": parent, "ts": t0 / 1e9, "dur_s": (t1 - t0) / 1e9,
            "t0_ns": t0, "t1_ns": t1, "attrs": attrs}


# a serving stretch of 100 us and 2 calls, times in us from its start
SERVE_SPANS = [(1, None, "scheduler.pump", 0, 90),
               (2, 1, "runner.admit", 2, 6),
               (3, 1, "engine.stepwise", 10, 80),
               (4, 3, "runner.inputs", 12, 14),
               (5, 3, "model.forward", 15, 50),
               (6, 5, "model.block", 20, 40, {"kind": "attn"}),
               (7, 3, "decode.draw", 52, 58), (8, 3, "decode.kernel", 60, 70),
               (9, 3, "runner.harvest", 72, 78),
               (10, None, "engine.plan", 92, 96)]
BATCH_SPANS = [(1, None, "scheduler.batch", 0, 98),
               (2, 1, "engine.generate", 1, 97),
               (3, 2, "sampler.call", 10, 50), (4, 3, "model.forward", 12, 40),
               (5, 3, "decode.draw", 41, 44), (6, 3, "decode.kernel", 45, 49),
               (7, 2, "sampler.call", 55, 95), (8, 7, "model.forward", 56, 90),
               (9, 7, "decode.draw", 91, 92), (10, 7, "decode.kernel", 92, 94)]
# (name, start, end) in us: a runtime call in a block, one in the decode,
# one in the admission, one in the pump's own time, one outside spans
RUNTIME = [("cudaLaunchKernel", 21, 23), ("cudaLaunchKernel", 61, 62),
           ("cudaMemcpyAsync", 3, 4), ("cudaStreamSynchronize", 85, 86),
           ("cudaLaunchKernel", 97, 99)]
DEVICE = [("k1", 25, 45), ("k2", 65, 88)]


def _ctx(monkeypatch, table, calls=2):
    """A context whose traced stretch is [0, 100] us, with ``table``'s
    spans in the program's record buffer."""
    lo = 10 ** 15
    recs = [_span(row[0], row[1], row[2], lo + row[3] * US,
                  lo + row[4] * US, **(row[5] if len(row) > 5 else {}))
            for row in table]
    monkeypatch.setattr("repro_torch.obs.tracing.records", lambda: recs)
    monkeypatch.setattr(spans, "stretch", lambda ctx: (lo, lo + 100 * US))
    tr = Trace([(n, lo + s * US, (e - s) * US) for n, s, e in DEVICE],
               [(n, lo + s * US, (e - s) * US) for n, s, e in RUNTIME],
               wall_s=100e-6, calls=calls)
    return harness.Context("t", {}, {}, None, trace=tr)


def _read(name, ctx):
    return harness.metric_reader(name).read(ctx)


def test_serve_layers_by_hand(monkeypatch):
    ctx = _ctx(monkeypatch, SERVE_SPANS)
    # pump's own 16 us less the 1 us runtime call in it, the admission's
    # 4 less 1, the plan's 4: 22 us over 2 calls
    want = {"sched_host_ms_per_call.serve": 22,
            "engine_host_ms_per_call.serve": 11 + 2 + 6,
            "denoiser_host_ms_per_call.serve": 35 - 2,
            "decode_host_ms_per_call.serve": 6 + 10 - 1}
    for name, us in want.items():
        assert _read(name, ctx) == pytest.approx(us / 1e3 / 2), name
    host = readers.host_ms_per_call(ctx)
    assert host == pytest.approx((100 - 7) / 1e3 / 2)
    assert sum(_read(n, ctx) for n in SERVE) <= host
    # idle [0, 25] + [45, 65] + [88, 100] = 57 us; spans open over
    # [0, 90] and [92, 96]: 25 + 20 + 2 + 4 = 51 us of it
    assert _read("idle_in_spans_share.serve", ctx) == pytest.approx(
        100 * 51 / 57)


def test_batch_layers_by_hand(monkeypatch):
    ctx = _ctx(monkeypatch, BATCH_SPANS)
    # generate's own 16 us less the runtime call at 3-4, the calls' own 5
    # and 3; the forwards' 28 and 34 less the calls at 21-23, 61-62, 85-86
    want = {"engine_host_ms_per_call.batch": 16 - 1 + 5 + 3,
            "denoiser_host_ms_per_call.batch": 28 - 2 + 34 - 2,
            "decode_host_ms_per_call.batch": 3 + 4 + 1 + 2}
    for name, us in want.items():
        assert _read(name, ctx) == pytest.approx(us / 1e3 / 2), name
    assert sum(_read(n, ctx) for n in BATCH) <= readers.host_ms_per_call(ctx)
    # spans open over [0, 98]: idle 25 + 20 + 10 of the 57
    assert _read("idle_in_spans_share.batch", ctx) == pytest.approx(
        100 * 55 / 57)


def test_by_span_table(monkeypatch):
    ctx = _ctx(monkeypatch, SERVE_SPANS)
    table = spans.by_span(ctx)
    assert table["host_ms"]["model.block[attn]"] == pytest.approx(
        (20 - 2) / 1e3 / 2)
    # [90, 92], [96, 97] and [99, 100] us lie outside every span
    assert table["host_ms"]["(outside spans)"] == pytest.approx(4 / 1e3 / 2)
    assert sum(table["host_ms"].values()) == pytest.approx(
        table["host_ms_per_call"])
    assert table["idle_ms"]["(outside spans)"] == pytest.approx(6 / 1e3 / 2)
    # the pump's own [0, 2], [6, 10] and [80, 90] meet idle [0, 25] and
    # [88, 100] for 2 + 4 + 2 us
    assert table["idle_ms"]["scheduler.pump"] == pytest.approx(8 / 1e3 / 2)
    # two of the three launches lie in spans
    assert table["launches"] == 3
    assert table["launches_in_spans"] == pytest.approx(100 * 2 / 3)


def test_nothing_to_read(monkeypatch):
    """No trace, no spans, or spans without stamps (a program before
    them): every reader returns None."""
    ctx = _ctx(monkeypatch, SERVE_SPANS)
    names = SERVE + BATCH + ["idle_in_spans_share.serve",
                             "idle_in_spans_share.batch"]
    monkeypatch.setattr("repro_torch.obs.tracing.records", lambda: [])
    assert all(_read(n, ctx) is None for n in names)
    old = [{k: v for k, v in _span(1, None, "engine.generate", 0, 9).items()
            if k not in ("t0_ns", "t1_ns")}]
    monkeypatch.setattr("repro_torch.obs.tracing.records", lambda: old)
    assert all(_read(n, ctx) is None for n in names)
    ctx.trace = None
    assert all(_read(n, ctx) is None for n in names)


def test_stretch_is_on_the_program_clock():
    from repro_torch import obs
    ctx = types.SimpleNamespace(
        profiled=types.SimpleNamespace(_t0=time.perf_counter()),
        trace=Trace([], [], wall_s=0.5))
    lo, hi = spans.stretch(ctx)
    assert abs(obs.clock_ns() - lo) < 50_000_000
    assert hi - lo == 500_000_000


@pytest.mark.parametrize("kind", ["serve", "batch"])
def test_traced_tiny_serving_reports_the_layers(kind):
    """The tiny text8 model served under ``Profiled`` on the CPU (a CPU
    profile: spans, no device events), continuously with arrivals or one
    batch: each layer's host time, within the traced wall per call."""
    import torch
    from repro_torch.obs import tracing
    from repro_torch.serving.scheduler import (BatchScheduler,
                                               ContinuousScheduler)
    from dndmbench.trace import Profiled
    mix = tiny.serve_mix() if kind == "serve" else tiny.batch_mix()
    cpu = torch.device("cpu")
    engine = harness.build_program(tiny.TEXT8, mix, 7, cpu)
    kw = dict(max_batch=mix["rows"], bucket_len=mix["N"], seed=3,
              device=cpu)
    if kind == "serve":
        sched = ContinuousScheduler(engine, **kw)
        for _ in range(mix["rows"]):
            sched.submit(mix["N"])
        sched.pump()
    else:
        sched = BatchScheduler(engine, **kw)
        sched.submit(mix["N"])
        sched.run()                               # the cold key
    tracing.clear()
    ctx = harness.Context(f"text8-{kind}", {}, mix, cpu)
    try:
        ctx.profiled = Profiled(cpu)
        with ctx.profiled as ctx.trace:
            if kind == "serve":
                for _ in range(5):
                    sched.submit(mix["N"])
                    sched.pump()
            else:
                rid = sched.submit(mix["N"])
                sched.run()
        ctx.trace.calls = 5 if kind == "serve" else sched.done[rid].nfe
        names = SERVE if kind == "serve" else BATCH
        got = {n: _read(n, ctx) for n in names}
    finally:
        tracing.clear()
    assert all(v > 0 for v in got.values()), got
    assert sum(got.values()) <= 1e3 * ctx.trace.wall_s / ctx.trace.calls
