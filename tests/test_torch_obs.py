"""The port's telemetry copy (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU.

The same operations, from numpy draws with a seed, go through both
packages: metric snapshots are equal and the Prometheus text is
byte-equal; DDSketch quantiles, SLO parsing and burn accounting, schema
verdicts and regression-gate verdicts agree; each package's schema reads
the other's trace.  Plus the port's own contracts: ``suppressed()``
nesting, the disabled path's cost, the live exporter on an ephemeral
port, the snapshot writer, timelines from a file, the buffered sink and
the ``REPRO_TORCH_PROFILE`` hook.  Sinks are set with ``set_sink``,
never through the environment: both packages read it at import, so the
module clears the telemetry variables and undoes what they set up.
"""
import json
import re
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from repro import obs as jobs
from repro.obs import exporter as jexporter
from repro.obs import regress as jregress
from repro.obs import schema as jschema
from repro.obs import sketch as jsketch
from repro.obs import slo as jslo

from repro_torch import obs as tobs
from repro_torch.obs import exporter as texporter
from repro_torch.obs import regress as tregress
from repro_torch.obs import schema as tschema
from repro_torch.obs import sketch as tsketch
from repro_torch.obs import slo as tslo

PACKAGES = [jobs, tobs]


# Both packages run ``configure_from_env()`` at import, on the same
# variables: set in the environment, they would give the two packages one
# trace file or one port.  The tests own every sink, exporter and SLO.
TELEMETRY_ENV = ("REPRO_TRACE", "REPRO_METRICS", "REPRO_METRICS_PORT",
                 "REPRO_SNAPSHOT", "REPRO_SNAPSHOT_INTERVAL", "REPRO_SLO",
                 "REPRO_JAX_PROFILE", "REPRO_TORCH_PROFILE")


@pytest.fixture(scope="module", autouse=True)
def _no_env_telemetry():
    """Clear the telemetry variables for this module and undo what they
    set up at import."""
    with pytest.MonkeyPatch.context() as mp:
        for var in TELEMETRY_ENV:
            mp.delenv(var, raising=False)
        for o in (jobs, tobs):
            o.exporter.stop()
            o.tracing.close_sink()
            o.slo.clear()
            o.disable()
        yield


def _reset():
    for o in PACKAGES:
        o.tracing.close_sink()
        o.metrics.reset()
        o.tracing.clear()
        o.slo.clear()
        o.disable()


@pytest.fixture()
def telemetry():
    """Both packages enabled and empty for one test; disabled after."""
    _reset()
    for o in PACKAGES:
        o.enable()
    yield
    _reset()


def _metric_ops(seed: int) -> list:
    """A seeded script of record calls: (kind, name, value, labels)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(300):
        kind = ("counter", "gauge", "histogram")[int(rng.integers(3))]
        name = f"t.{kind}.{int(rng.integers(3))}"
        labels = {"method": ("dndm", "rdm_k", "dndm_c")[int(
            rng.integers(3))]}
        if rng.random() < 0.3:
            labels["mode"] = ("drain", "continuous")[int(rng.integers(2))]
        if kind == "histogram":
            # long-tailed, across the decade buckets, some zeros
            value = (0.0 if rng.random() < 0.05
                     else float(rng.lognormal(-4.0, 3.0)))
        elif kind == "counter":
            value = int(rng.integers(1, 20))
        else:
            value = float(rng.normal())
        ops.append((kind, name, value, labels))
    return ops


def _apply(o, ops):
    for kind, name, value, labels in ops:
        if kind == "counter":
            o.counter(name, f"{name} help").inc(value, **labels)
        elif kind == "gauge":
            o.gauge(name).set(value, **labels)
        else:
            o.histogram(name, "seconds").observe(value, **labels)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshots_and_prometheus_text_equal(telemetry, seed):
    ops = _metric_ops(seed)
    for o in PACKAGES:
        _apply(o, ops)
    jsnap, tsnap = jobs.snapshot(), tobs.snapshot()
    assert tsnap == jsnap
    text = texporter.prometheus_text()
    assert text == jexporter.prometheus_text()
    assert texporter.parse_prometheus_text(text) == \
        jexporter.parse_prometheus_text(text)
    tschema.validate_metrics_snapshot(tsnap)
    jschema.validate_metrics_snapshot(tsnap)


def test_reset_clears_values_not_instruments(telemetry):
    for o in PACKAGES:
        o.counter("t.reset", "kept").inc(3)
        o.reset()
    assert tobs.snapshot() == jobs.snapshot() == {}
    assert tobs.metrics._REGISTRY["t.reset"].help == "kept"
    with pytest.raises(TypeError):
        tobs.gauge("t.reset")


@pytest.mark.parametrize("alpha,max_bins,seed", [
    (0.01, 2048, 0), (0.01, 64, 1), (0.05, 128, 2), (0.02, 2048, 3)])
def test_sketch_quantiles_equal(alpha, max_bins, seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.lognormal(0.0, 4.0, 3000), np.zeros(20),
                           -rng.random(5)])
    sketches = []
    for mod in (jsketch, tsketch):
        a = mod.DDSketch(alpha, max_bins)
        b = mod.DDSketch(alpha, max_bins)
        for i, v in enumerate(vals):
            (a if i % 2 else b).add(float(v))
        sketches.append(a.copy().merge(b))
    js, ts = sketches
    assert ts.to_dict() == js.to_dict()
    qs = np.linspace(0.0, 1.0, 41)
    assert [ts.quantile(q) for q in qs] == [js.quantile(q) for q in qs]
    snap = {"sketch": json.loads(json.dumps(ts.to_dict()))}
    assert tsketch.quantile_of_snapshot(snap, 0.99) == \
        jsketch.quantile_of_snapshot(snap, 0.99)


@pytest.mark.parametrize("bad", [
    {"alpha": 0.0}, {"alpha": 1.0}, {"merge_alpha": 0.05},
    {"quantile": 1.5}])
def test_sketch_rejects_what_jax_rejects(bad):
    for mod in (jsketch, tsketch):
        with pytest.raises(ValueError):
            if "alpha" in bad:
                mod.DDSketch(alpha=bad["alpha"])
            elif "merge_alpha" in bad:
                mod.DDSketch().merge(mod.DDSketch(alpha=bad["merge_alpha"]))
            else:
                mod.DDSketch().quantile(bad["quantile"])


SLO_SPECS = ["latency<0.25@0.95, nfe<64@1.0, dndm_c.queue<0.1",
             "nfe<12@0.9;latency<1000", "dndm.latency<0.01@0.5"]


@pytest.mark.parametrize("spec", SLO_SPECS)
def test_slo_parse_and_status_agree(telemetry, spec):
    jb, tb = jslo.parse(spec), tslo.parse(spec)
    assert [(b.name, b.metric, b.limit, b.objective, b.method)
            for b in tb] == [(b.name, b.metric, b.limit, b.objective,
                              b.method) for b in jb]
    rng = np.random.default_rng(len(spec))
    reqs = [(("dndm", "dndm_c", "rdm_k")[int(rng.integers(3))],
             float(rng.exponential(0.1)), float(rng.exponential(0.05)),
             int(rng.integers(4, 80))) for _ in range(200)]
    for mod, budgets in ((jslo, jb), (tslo, tb)):
        mod.configure(budgets)
        for m, lat, queue, nfe in reqs:
            mod.observe_request(m, latency_s=lat, queue_s=queue, nfe=nfe)
    assert tslo.status() == jslo.status()
    assert tobs.snapshot() == jobs.snapshot()


@pytest.mark.parametrize("entry", ["latency", "walltime<1.0",
                                   "latency<0.1@0"])
def test_slo_rejects_what_jax_rejects(entry):
    for mod in (jslo, tslo):
        with pytest.raises(ValueError):
            mod.parse(entry)


def test_slo_noop_without_budgets(telemetry):
    assert not tslo.active()
    tslo.observe_request("dndm", latency_s=9e9, queue_s=9e9, nfe=9e9)
    assert tobs.snapshot() == {} and tslo.status() == {}


def _trace(o, path, seed: int):
    """A nested trace written by package ``o``: spans with events and a
    final metrics record."""
    rng = np.random.default_rng(seed)
    o.set_sink(str(path))
    with o.span("scheduler.batch", method="dndm", request_ids="req-1,req-2"):
        o.event("scheduler.admit", request_id="req-1", queue_s=0.1)
        with o.span("engine.generate", method="dndm", batch=2) as sp:
            for i in range(5):
                o.event("sampler.step", i=i, t=np.int32(10 - i),
                        dur_s=float(rng.random()),
                        reveal=np.float32(rng.random()))
                o.histogram("sampler.step_seconds").observe(
                    float(rng.random()), loop="host")
            sp.set(nfe=5, cache="miss")
    o.event("scheduler.complete", request_id="req-2", nfe=5)
    o.tracing.close_sink(final_metrics=True)
    return path.read_text().splitlines()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_schema_reads_each_trace(telemetry, tmp_path, writer):
    o = jobs if writer == "jax" else tobs
    lines = _trace(o, tmp_path / "t.jsonl", 0)
    jrec = jschema.validate_trace_lines(lines)
    trec = tschema.validate_trace_lines(lines)
    assert jrec == trec and len(trec) == 10
    assert [r["kind"] for r in trec].count("metrics") == 1
    steps = [r for r in trec if r.get("name") == "sampler.step"]
    assert all(isinstance(r["attrs"]["t"], int) for r in steps)


def test_both_packages_write_the_same_trace_shape(telemetry, tmp_path):
    shape = []
    for o, name in ((jobs, "j.jsonl"), (tobs, "t.jsonl")):
        recs = [json.loads(x) for x in _trace(o, tmp_path / name, 1)]
        shape.append([(r["kind"], r.get("name"), sorted(r["attrs"]),
                       r["parent_id"] is None) for r in recs])
    assert shape[0] == shape[1]


MALFORMED_TRACES = [
    ['{"kind": "span", "name": "x"}'],
    ["not json"],
    ['{"kind": "other", "ts": 1.0, "span_id": 1, "parent_id": null, '
     '"attrs": {}}'],
    ['{"kind": "event", "name": "e", "ts": 1.0, "span_id": 0, '
     '"parent_id": null, "attrs": {}}'],
    ['{"kind": "span", "name": "e", "ts": 1.0, "span_id": 1, '
     '"parent_id": "x", "attrs": {}, "dur_s": 0.1}'],
]


@pytest.mark.parametrize("lines", MALFORMED_TRACES)
def test_schemas_reject_the_same_traces(lines):
    for mod in (jschema, tschema):
        with pytest.raises(mod.SchemaError):
            mod.validate_trace_lines(lines)


def _bench():
    return {"schema": 2, "jax_backend": "cpu", "quick": True,
            "config": {"batch": 2, "seq": 8, "steps": 4},
            "methods": {"dndm": {
                "noise": "absorbing", "kind": "host", "wall_seconds": 0.1,
                "compile_seconds": 0.2, "nfe": 4, "tokens_per_second": 9.0,
                "us_per_nfe": 3.0, "metrics": {"jit_cache_hits": 1,
                                               "jit_cache_misses": 1}}},
            "telemetry": {"enabled": True, "trace": None, "metrics": {}}}


def _serving(wall=10.0, rps=5.0, p95=0.4, nfe=100, parity=True,
             fewer=True):
    mode = {"wall_seconds": wall, "throughput_rps": rps,
            "latency_p50_s": p95 / 2, "latency_p95_s": p95,
            "latency_p99_s": p95 * 1.2, "aggregate_nfe": nfe}
    return {"schema": 2, "kind": "serving", "jax_backend": "cpu",
            "quick": True,
            "config": {"max_batch": 4, "seq": 8, "steps": 4, "requests": 8,
                       "method": "dndm", "arrival_rate_rps": 5.0},
            "modes": {"drain": dict(mode),
                      "continuous": dict(mode, steps_skipped=3,
                                         admissions_midflight=1)},
            "comparison": {"nfe_ratio": 0.5, "throughput_ratio": 1.2,
                           "solo_parity": parity, "fewer_nfe": fewer},
            "telemetry": {"enabled": False, "metrics": {}}}


def _drop(record, *path):
    rec = json.loads(json.dumps(record))
    d = rec
    for k in path[:-1]:
        d = d[k]
    del d[path[-1]]
    return rec


@pytest.mark.parametrize("make,validator,broken", [
    (_bench, "validate_bench", None),
    (_bench, "validate_bench", ("methods", "dndm", "nfe")),
    (_bench, "validate_bench", ("telemetry", "trace")),
    (_serving, "validate_serving", None),
    (_serving, "validate_serving", ("modes", "continuous", "steps_skipped")),
    (_serving, "validate_serving", ("comparison", "solo_parity")),
])
def test_bench_readers_agree(make, validator, broken):
    record = make() if broken is None else _drop(make(), *broken)
    verdicts = []
    for mod in (jschema, tschema):
        try:
            getattr(mod, validator)(record)
            verdicts.append("ok")
        except mod.SchemaError as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]
    assert (verdicts[1] == "ok") == (broken is None)


@pytest.mark.parametrize("new", [
    _serving(), _serving(wall=5.0, rps=9.0, p95=0.2, nfe=50),
    _serving(wall=20.0), _serving(parity=False), _serving(fewer=False),
    _serving(wall=13.0, rps=4.0)])
def test_regress_gate_agrees(new):
    base = _serving()
    assert tregress.compare(base, new) == jregress.compare(base, new)


def test_regress_cli(tmp_path):
    b, n = tmp_path / "b.json", tmp_path / "n.json"
    b.write_text(json.dumps(_serving()))
    n.write_text(json.dumps(_serving(wall=20.0)))
    assert tregress.main([str(b), str(b)]) == 0
    assert tregress.main([str(b), str(n)]) == 1
    assert tregress.main([str(b), str(n), "--wall-tol", "2.0"]) == 0
    assert tregress.main([str(b), str(tmp_path / "missing.json")]) == 2


def test_schema_cli_takes_a_trace_alone(telemetry, tmp_path, capsys):
    """``python -m repro_torch.obs.schema trace.jsonl``: the structural
    check passes, the content check wants a serving trace."""
    path = tmp_path / "t.jsonl"
    _trace(tobs, path, 2)
    assert tschema.main([str(path)]) == 1       # not a serving trace
    assert "validation FAILED" in capsys.readouterr().err
    bench = tmp_path / "b.json"
    bench.write_text(json.dumps(_bench()))
    assert tschema.main([str(bench)]) == 0
    assert tschema.main([]) == 2


def test_suppressed_nests_without_flipping_global(telemetry):
    c = tobs.counter("suppress.probe")
    c.inc()
    with tobs.suppressed():
        assert not tobs.enabled()
        c.inc()
        tobs.event("suppress.nope")
        with tobs.suppressed():
            c.inc()
            assert tobs.span("x") is tobs.tracing.NULL_SPAN
        c.inc()                     # still inside the outer context
    assert tobs.enabled()
    c.inc()
    assert c.value() == 2
    assert all(r["name"] != "suppress.nope"
               for r in tobs.tracing.records())


def test_disabled_path_overhead():
    """With telemetry off, an instrumented site costs one guard check: no
    allocation, no records (the JAX package's budget, 10 us for the
    span + event + counter trio)."""
    _reset()
    c = tobs.counter("t.overhead")
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        tobs.span("x", a=1)
        tobs.event("y", b=2)
        c.inc(3, d="z")
    per_op = (time.perf_counter() - t0) / n
    assert per_op < 10e-6, f"disabled telemetry costs {per_op * 1e6:.2f}us"
    assert tobs.tracing.records() == [] and tobs.snapshot() == {}


def test_span_nesting_and_timeline(telemetry, tmp_path):
    path = tmp_path / "tl.jsonl"
    _trace(tobs, path, 3)
    for p in (None, str(path)):
        tl = tobs.timeline("req-1", path=p)
        names = [r["name"] for r in tl]
        # the batch span names req-1; its children follow it in
        assert names[:3] == ["scheduler.batch", "scheduler.admit",
                             "engine.generate"]
        assert names.count("sampler.step") == 5
        assert "scheduler.complete" not in names        # req-2's
    # req-2 rides the same batch, and its completion follows
    assert len(tobs.timeline("req-2", path=str(path))) == 9
    assert jobs.timeline("req-1", path=str(path)) == \
        tobs.timeline("req-1", path=str(path))


def test_dropped_records_counted_and_surfaced(telemetry, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(tobs.tracing, "_MAX_RECORDS", 4)
    path = tmp_path / "drop.jsonl"
    tobs.set_sink(str(path))
    for i in range(10):
        tobs.event("spam", i=i)
    assert tobs.tracing.dropped_records() == 6
    assert "6 trace records dropped" in tobs.summary()
    tobs.tracing.close_sink(final_metrics=True)
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert sum(r.get("name") == "spam" for r in recs) == 10
    g = recs[-1]["metrics"]["obs.trace.dropped_records_total"]
    assert g["series"][0]["value"] == 6


def test_sink_is_buffered(telemetry, tmp_path):
    path = tmp_path / "buf.jsonl"
    tobs.set_sink(str(path))
    n = 600
    for i in range(n):
        tobs.event("b", i=i)
    assert len(path.read_text().splitlines()) < n   # not per record
    tobs.flush_sink()
    assert len(path.read_text().splitlines()) == n
    tobs.tracing.close_sink()


def test_metrics_server_serves_live_scrapes(telemetry):
    tobs.counter("t.live.count").inc(7, x="y")
    srv = texporter.MetricsServer(port=0)
    try:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=5) as r:
            text = r.read().decode()
        assert text == texporter.prometheus_text()
        parsed = texporter.parse_prometheus_text(text)
        assert parsed[("t_live_count", (("x", "y"),))] == 7.0
        with urllib.request.urlopen(srv.url + "/snapshot", timeout=5) as r:
            snap = json.loads(r.read().decode())
        assert snap["t.live.count"]["series"][0]["value"] == 7
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/nope", timeout=5)
        assert ei.value.code == 404
    finally:
        srv.stop()


def test_serve_returns_one_server(telemetry):
    srv = texporter.serve(port=0)
    try:
        assert texporter.serve(port=0) is srv
    finally:
        texporter.stop()
    assert texporter._server is None


def test_snapshot_writer_atomic_file(telemetry, tmp_path):
    tobs.counter("t.snapwrite").inc(2)
    path = tmp_path / "snap.json"
    w = texporter.SnapshotWriter(str(path), interval_s=3600)
    w.stop(final=True)
    snap = json.loads(path.read_text())
    assert snap["t.snapwrite"]["series"][0]["value"] == 2
    assert not (tmp_path / "snap.json.tmp").exists()


def test_summary_lists_spans_and_metrics(telemetry, tmp_path):
    _trace(tobs, tmp_path / "s.jsonl", 4)
    text = tobs.summary()
    assert "engine.generate" in text and "scheduler.batch" in text
    assert "sampler.step_seconds{loop=host} count=5" in text


def test_profile_hook(monkeypatch, tmp_path):
    """Off: the shared no-op.  ``REPRO_TORCH_PROFILE=dir``: one Chrome
    trace per region in ``dir``."""
    import torch
    monkeypatch.delenv("REPRO_TORCH_PROFILE", raising=False)
    assert tobs.maybe_profile() is tobs.tracing.NULL_SPAN
    monkeypatch.setenv("REPRO_TORCH_PROFILE", str(tmp_path / "prof"))
    with tobs.maybe_profile():
        torch.ones(8).sum()
    traces = list((tmp_path / "prof").glob("trace-*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_configure_from_env(monkeypatch, tmp_path):
    """REPRO_METRICS and REPRO_SLO, as the JAX package reads them."""
    _reset()
    try:
        monkeypatch.setenv("REPRO_METRICS", "1")
        monkeypatch.setenv("REPRO_SLO", "nfe<8@1.0")
        tobs.configure_from_env()
        assert tobs.enabled()
        assert [b.name for b in tslo.budgets()] == ["nfe<8"]
    finally:
        _reset()


# ------------------------------------------------------------------
# every name the JAX serving stack emits, in the port's counterpart
# ------------------------------------------------------------------

NAME_RE = r'"((?:engine|scheduler|sampler|decode|kernel)\.[a-z_.]+)"'
SRC = Path(__file__).resolve().parents[1] / "src"


def _names(*files) -> set:
    return {m for f in files
            for m in re.findall(NAME_RE, (SRC / f).read_text())}


@pytest.mark.parametrize("jax_files,port_files", [
    (["repro/serving/engine.py"], ["repro_torch/serving/engine.py"]),
    (["repro/serving/scheduler.py"], ["repro_torch/serving/scheduler.py"]),
    (["repro/core/decode.py"], ["repro_torch/core/decode.py"]),
    (["repro/core/samplers/loop.py"], ["repro_torch/core/samplers/loop.py"]),
    # dndm_topk records its reveal counts through dndm's helper
    (["repro/core/samplers/dndm.py", "repro/core/samplers/dndm_topk.py"],
     ["repro_torch/core/samplers/dndm.py",
      "repro_torch/core/samplers/dndm_topk.py"]),
    (["repro/obs/slo.py"], ["repro_torch/obs/slo.py"]),
])
def test_every_jax_name_has_its_port_site(jax_files, port_files):
    want = _names(*jax_files)
    assert want, jax_files
    assert want <= _names(*port_files), want - _names(*port_files)


def test_the_names_left_out_are_the_kernel_facts():
    """Only ``kernel.traces`` and ``kernel.pad_*`` (facts of JAX tracing
    and Pallas tile padding, ROADMAP.md C) have no port site."""
    jax_all = _names(*(SRC / "repro").rglob("*.py"))
    port_all = _names(*(SRC / "repro_torch").rglob("*.py"))
    assert jax_all - port_all == {"kernel.traces", "kernel.pad_n",
                                  "kernel.pad_k", "kernel.pad_fraction"}
