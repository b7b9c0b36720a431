"""The port's spans at each serving layer: recorded while a
``torch.profiler`` session records (telemetry off), on ``obs.clock_ns``,
nested per network call; nothing without a profiler or under
``obs.suppressed()``; the served tokens unchanged."""
from __future__ import annotations

import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as configs
from repro_torch import obs
from repro_torch.models.model import Model
from repro_torch.serving import (BatchScheduler, ContinuousScheduler,
                                 EngineConfig, GenerationEngine)

N, ROWS = 16, 4
LAYER = {"engine.plan", "runner.admit", "runner.inputs", "runner.harvest",
         "sampler.call", "model.forward", "model.block", "decode.draw",
         "decode.kernel"}
CALL = {"runner.inputs", "model.forward", "decode.draw", "decode.kernel"}


@pytest.fixture(scope="module")
def engine():
    cfg = configs.get("dndm-text8").reduced()
    return GenerationEngine(Model(cfg, device="cpu"),
                            EngineConfig(steps=20, shared_tau=False),
                            device="cpu")


@pytest.fixture(autouse=True)
def _quiet():
    """Telemetry off and an empty record buffer around every test."""
    obs.disable()
    obs.tracing.clear()
    yield
    obs.disable()
    obs.tracing.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _serve(engine, submits=5, seed=1, method="dndm"):
    s = ContinuousScheduler(engine, max_batch=ROWS, bucket_len=N, seed=seed,
                            device="cpu")
    rids = [s.submit(N, method=method) for _ in range(submits)]
    done = s.run()
    return s, [done[r] for r in rids]


def _batch(engine, method="dndm", seed=2):
    s = BatchScheduler(engine, max_batch=2, bucket_len=N, seed=seed,
                       device="cpu")
    rids = [s.submit(N, method=method) for _ in range(2)]
    done = s.run()
    return [done[r] for r in rids]


def _spans():
    recs = [r for r in obs.tracing.records() if r["kind"] == "span"]
    return recs, {r["span_id"]: r for r in recs}


def _children(recs):
    kids = collections.defaultdict(list)
    for r in recs:
        kids[r["parent_id"]].append(r)
    return kids


def test_nothing_recorded_without_a_profiler(engine):
    _serve(engine)
    _batch(engine)
    assert obs.tracing.records() == []


@pytest.mark.parametrize("method", ["dndm", "dndm_topk"])
def test_serving_spans_nest_per_call(engine, method):
    with _profiled():
        sched, reqs = _serve(engine, method=method)
    recs, by_id = _spans()
    kids = _children(recs)
    names = collections.Counter(r["name"] for r in recs)
    calls = sched.total_calls
    assert names["scheduler.pump"] == names["engine.stepwise"] == calls
    assert names["engine.plan"] == len(reqs)
    assert names["model.forward"] == names["decode.kernel"] == calls
    for r in recs:
        parent = by_id.get(r["parent_id"], {}).get("name")
        want = {"engine.plan": None, "scheduler.pump": None,
                "runner.admit": "scheduler.pump",
                "engine.stepwise": "scheduler.pump",
                "model.block": "model.forward"}.get(r["name"],
                                                    "engine.stepwise")
        assert parent == want, (r["name"], parent)
        if r["name"] in LAYER:
            assert not {"request_id", "request_ids"} & set(r["attrs"])
    harvests = 0
    for st in (r for r in recs if r["name"] == "engine.stepwise"):
        got = collections.Counter(k["name"] for k in kids[st["span_id"]])
        assert set(got) - {"runner.harvest"} == CALL, got
        assert all(n == 1 for n in got.values()), got
        harvests += got["runner.harvest"]
    finishing = len({r.t_done for r in reqs})
    assert harvests == finishing
    pattern = list(engine.model.cfg.block_pattern)
    for fwd in (r for r in recs if r["name"] == "model.forward"):
        assert [b["attrs"]["kind"] for b in kids[fwd["span_id"]]] == pattern


@pytest.mark.parametrize("method", ["dndm", "dndm_c"])
def test_batch_spans_nest_per_call(engine, method):
    """One ``sampler.call`` per network call (the cold key's suppressed
    warm-up records nothing), each holding one forward, draw and decode."""
    with _profiled():
        reqs = _batch(engine, method=method)
    recs, by_id = _spans()
    kids = _children(recs)
    gen = [r for r in recs if r["name"] == "engine.generate"]
    assert len(gen) == 1
    assert by_id[gen[0]["parent_id"]]["name"] == "scheduler.batch"
    sampler_calls = [r for r in recs if r["name"] == "sampler.call"]
    assert len(sampler_calls) == reqs[0].nfe
    for c in sampler_calls:
        assert c["parent_id"] == gen[0]["span_id"]
        assert sorted(k["name"] for k in kids[c["span_id"]]) == [
            "decode.draw", "decode.kernel", "model.forward"]


def test_nothing_under_suppressed(engine):
    with _profiled(), obs.suppressed():
        _serve(engine)
        _batch(engine, method="dndm_topk")
    assert obs.tracing.records() == []


def test_span_holds_its_ops_profiler_events(engine):
    """Each ``aten::embedding`` the profiler saw lies inside a
    ``model.forward`` span's [t0_ns, t1_ns]: one clock."""
    with _profiled() as prof:
        _batch(engine)
    fwd = [(r["t0_ns"], r["t1_ns"]) for r in obs.tracing.records()
           if r["name"] == "model.forward"]
    emb = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::embedding"]
    assert len(emb) >= len(fwd) > 0
    for s, e in emb:
        assert any(t0 <= s and e <= t1 for t0, t1 in fwd), (s, e)


def test_tokens_unchanged_by_recording(engine):
    _, off = _serve(engine, seed=9)
    with _profiled():
        _, on = _serve(engine, seed=9)
    assert obs.tracing.records()
    for a, b in zip(off, on):
        assert a.nfe == b.nfe
        np.testing.assert_array_equal(a.result, b.result)


def test_request_stamps_on_the_clock(engine):
    t0 = obs.clock_ns() / 1e9
    _, reqs = _serve(engine)
    reqs += _batch(engine)
    t1 = obs.clock_ns() / 1e9
    for r in reqs:
        assert t0 <= r.t_submit <= r.t_admit <= r.t_done <= t1
    assert abs(obs.clock_ns() - time.time_ns()) < 50_000_000
    ticks = [obs.clock_ns() for _ in range(1000)]
    assert ticks == sorted(ticks)


def test_enabled_trace_keeps_request_spans_only(engine):
    """Telemetry on without a profiler: the request-level spans, none of
    the layers below a call, so an enabled trace keeps the JAX package's
    per-request timelines; a profiler adds the layers."""
    obs.enable()
    _serve(engine)
    names = {r["name"] for r in obs.tracing.records() if r["kind"] == "span"}
    assert names == {"scheduler.pump", "engine.stepwise"}
    obs.tracing.clear()
    with _profiled():
        _serve(engine)
    names = {r["name"] for r in obs.tracing.records() if r["kind"] == "span"}
    assert names == {"scheduler.pump", "engine.stepwise"} | LAYER - {
        "sampler.call"}
