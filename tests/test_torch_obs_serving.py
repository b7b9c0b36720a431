"""The port's serving telemetry against the JAX package's, on one tape.

One request tape goes through ``BatchScheduler`` (drain) and then
``ContinuousScheduler`` in each package, with telemetry on and a trace
file per package: ``dndm`` and ``dndm_topk`` (the registry's ``host``
kind) and ``dndm_c`` and ``rdm_k`` (``scan`` kind), at reduced
``dndm-text8``'s vocabulary, on the integer-valued denoiser of
``tests/test_torch_continuous.py``.  The port replays the JAX package's
draws (drain: each batch's key; continuous: each request's plan), so both
packages make the same calls and choose the same tokens.

Held equal: per request (ids mapped in submission order), the
``obs.timeline`` sequence of (kind, name, attribute keys); in the final
metrics record, the metric names and label sets, and the values of the
``engine.*`` counters, every ``scheduler.*`` counter (SLO counters
included), the count and sum of ``sampler.reveal_count`` and the number of
``sampler.step`` events.  ``decode.backend_calls`` is compared by labels
only: the port counts once per call, the JAX package once per compiled
program, and the JAX package compiles a host sampler's per-step program
inside the engine's suppressed warm-up, so it never counts the host
samplers' ``fused_update`` (``ROADMAP.md`` C).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import transition as jtrans
from repro.obs import schema as jschema
from repro.serving import BatchScheduler as JBatch
from repro.serving import ContinuousScheduler as JContinuous
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import GenerationEngine as JEngine

import repro_torch.configs as tconfigs
from repro_torch import obs as tobs
from repro_torch.core.samplers import SamplerConfig as TSamplerConfig
from repro_torch.core.samplers import registry as tregistry
from repro_torch.obs import schema as tschema
from repro_torch.serving import BatchScheduler as TBatch
from repro_torch.serving import ContinuousScheduler as TContinuous
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import GenerationEngine as TEngine

K = tconfigs.get("dndm-text8").reduced().vocab_size
T, SEQ, MAX_BATCH = 20, 10, 4
HOST, SCAN = ("dndm", "dndm_topk"), ("dndm_c", "rdm_k")
SLO = "nfe<12@0.9,latency<1000"
ENGINE_KW = dict(steps=T, shared_tau=False, x0_mode="sample")
SEED_DRAIN, SEED_CONT = 3, 4


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


def _j_oracle():
    """A fresh integer-valued denoiser per run: the JAX package's jitted
    steps are cached per denoiser, so a new one makes its compile-time
    counters independent of earlier tests in the process."""
    def fn(x_t, t, cond):
        k = jnp.arange(K, dtype=jnp.int32)
        n = jnp.arange(x_t.shape[1], dtype=jnp.int32)
        tt = jnp.round(jnp.asarray(t, jnp.float32) * T).astype(jnp.int32)
        v = (x_t[..., None] * 3 + k * 7 + n[None, :, None] * 5
             + tt[:, None, None]) % 11
        return v.astype(jnp.float32)
    return fn


def t_oracle(x_t, t, cond):
    k = torch.arange(K, dtype=torch.int32)
    n = torch.arange(x_t.shape[1], dtype=torch.int32)
    tt = torch.round(t * T).to(torch.int32)
    v = (x_t[..., None] * 3 + k * 7 + n[None, :, None] * 5
         + tt[:, None, None]) % 11
    return v.to(torch.float32)


class _Cfg:
    vocab_size = K


class JOracleModel:
    cfg = _Cfg()

    def __init__(self):
        self.fn = _j_oracle()

    def denoise_fn(self, params, cond=None):
        return self.fn


class TOracleModel:
    cfg = _Cfg()
    device = torch.device("cpu")

    def denoise_fn(self):
        return t_oracle


# (method, length) in submission order: three dndm in a bucket of 4 pad
# one row; dndm's second batch meets a warm engine key
DRAIN_TAPE = ([("dndm", SEQ)] * 3 + [("dndm_topk", SEQ - 2)] * 2
              + [("dndm_c", SEQ), ("rdm_k", SEQ - 1)]
              + [("dndm", SEQ - 1)] * 3)
# ("submit", method, length) or ("pump",): later requests land mid-flight
CONT_TAPE = ([("submit", m, SEQ) for m in HOST + SCAN] + [("pump",)] * 3
             + [("submit", m, SEQ - 1) for m in HOST + SCAN]
             + [("pump",)] + [("submit", "dndm", SEQ)])


def _n_calls(method, rt, tau, n_tok):
    if method in HOST:
        return len(np.unique(tau))
    return n_tok if method == "dndm_c" else rt.steps


def _drain_draws(method, key, rt, batch, n_tok):
    """(tau, x_T, gumbels, None) of one JAX drain batch, as its sampler
    draws them: the key splits into (tau, x_T, loop), the loop key into
    one key per call, and ``rdm_k`` splits each call's key once more."""
    k_tau, k_x, k_loop = jax.random.split(key, 3)
    tau = None
    if method != "rdm_k":
        continuous = method == "dndm_c"
        tau = np.asarray(jtrans.sample_transition_times(
            k_tau, rt.cdist if continuous else rt.dist, batch, n_tok,
            order=rt.order, shared=rt.shared_tau, continuous=continuous))
    x = np.asarray(rt.noise.sample(k_x, (batch, n_tok))).astype(np.int32)
    gumbels = []
    for k in jax.random.split(k_loop, _n_calls(method, rt, tau, n_tok)):
        k_sel = jax.random.split(k)[0] if method == "rdm_k" else k
        gumbels.append(np.asarray(jax.random.gumbel(
            k_sel, (batch, n_tok, K), jnp.float32)))
    return tau, x, gumbels, None


def _plan_draws(r):
    """(tau, x_T, gumbels, None) of one JAX continuous request, as the
    JAX row steps draw them from the plan's per-call keys."""
    plan = r.plan
    gumbels = []
    for key in plan.step_keys:
        k_sel = jax.random.split(key)[0] if r.method == "rdm_k" else key
        gumbels.append(np.asarray(jax.random.gumbel(k_sel, (SEQ, K),
                                                    jnp.float32)))
    return plan.tau, plan.x0, gumbels, None


def _play(drain, cont):
    """Serve both tapes; returns the requests in submission order."""
    order = [drain.submit(n, method=m) for m, n in DRAIN_TAPE]
    done = drain.run()
    out = [done[rid] for rid in order]
    order = []
    for op in CONT_TAPE:
        if op[0] == "submit":
            order.append(cont.submit(op[2], method=op[1]))
        else:
            cont.pump()
    done = cont.run()
    return out + [done[rid] for rid in order]


def _run_jax(path):
    m = JOracleModel()
    eng = JEngine(m, {}, JEngineConfig(**ENGINE_KW))
    jobs.set_sink(str(path))
    reqs = _play(JBatch(eng, max_batch=MAX_BATCH, bucket_len=SEQ,
                        seed=SEED_DRAIN),
                 JContinuous(eng, max_batch=MAX_BATCH, bucket_len=SEQ,
                             seed=SEED_CONT))
    jobs.tracing.close_sink(final_metrics=True)
    return eng, reqs


def _run_port(path, jeng, jreqs):
    """The port on the JAX run's draws; ``path`` None runs it with
    telemetry off."""
    eng = TEngine(TOracleModel(), TEngineConfig(**ENGINE_KW), device="cpu")

    def drain_keys():              # the JAX BatchScheduler's batch keys
        key = jax.random.PRNGKey(SEED_DRAIN)
        while True:
            key, k = jax.random.split(key)
            yield k

    batch_keys = drain_keys()
    plans = iter(_plan_draws(r) for r in jreqs[len(DRAIN_TAPE):])
    generate, plan_request = eng.generate, eng.plan_request

    def generate_with_jax_draws(seed, batch, N, cond=None, method=None,
                                draws=None):
        return generate(seed, batch, N, cond=cond, method=method,
                        draws=_drain_draws(method, next(batch_keys),
                                           jeng.runtime(), batch, N))

    def plan_with_jax_draws(seed, N, method=None, draws=None):
        return plan_request(seed, N, method, draws=next(plans))

    eng.generate = generate_with_jax_draws
    eng.plan_request = plan_with_jax_draws
    if path is not None:
        tobs.set_sink(str(path))
    reqs = _play(TBatch(eng, max_batch=MAX_BATCH, bucket_len=SEQ,
                        seed=SEED_DRAIN, device="cpu"),
                 TContinuous(eng, max_batch=MAX_BATCH, bucket_len=SEQ,
                             seed=SEED_CONT, device="cpu"))
    if path is not None:
        tobs.tracing.close_sink(final_metrics=True)
    return reqs


def _reset_both():
    for o in (jobs, tobs):
        o.tracing.close_sink()
        o.metrics.reset()
        o.tracing.clear()
        o.slo.clear()
        o.disable()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The tape through both packages with telemetry on, then through the
    port with telemetry off; returns the paths, the requests of each run
    and both final snapshots."""
    d = tmp_path_factory.mktemp("obs_serving")
    _reset_both()
    jpath, tpath = d / "jax.jsonl", d / "port.jsonl"
    try:
        jobs.slo.configure(jobs.slo.parse(SLO))
        jobs.enable()
        jeng, jreqs = _run_jax(jpath)
        jslo = jobs.slo.status()
        tobs.slo.configure(tobs.slo.parse(SLO))
        tobs.enable()
        treqs = _run_port(tpath, jeng, jreqs)
        tslo = tobs.slo.status()
        _reset_both()
        off = _run_port(None, jeng, jreqs)
    finally:
        _reset_both()
    return {"jpath": jpath, "tpath": tpath, "jreqs": jreqs, "treqs": treqs,
            "off": off, "jslo": jslo, "tslo": tslo}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _final_metrics(path):
    return [r for r in _records(path) if r["kind"] == "metrics"][-1][
        "metrics"]


def _labels(snap):
    return {name: sorted(json.dumps(s["labels"], sort_keys=True)
                         for s in inst["series"])
            for name, inst in snap.items()}


def _values(snap, name):
    return {json.dumps(s["labels"], sort_keys=True): s["value"]
            for s in snap.get(name, {"series": []})["series"]}


def _shape(records):
    return [(r["kind"], r.get("name"), tuple(sorted(r["attrs"])))
            for r in records]


def test_the_port_serves_what_jax_serves(served):
    """The replay holds: same requests, tokens and NFE in both packages."""
    jreqs, treqs = served["jreqs"], served["treqs"]
    assert len(jreqs) == len(treqs) == len(DRAIN_TAPE) + sum(
        op[0] == "submit" for op in CONT_TAPE)
    for j, t in zip(jreqs, treqs):
        assert (t.method, t.nfe, t.steps_skipped) == (j.method, j.nfe,
                                                      j.steps_skipped)
        np.testing.assert_array_equal(t.result, np.asarray(j.result))
        assert t.request_id.startswith("req-") and t.request_id != ""
    assert {r.method for r in treqs} == set(HOST + SCAN)


def test_telemetry_changes_no_output(served):
    """Tokens and NFE bitwise equal with telemetry on and off."""
    for on, off in zip(served["treqs"], served["off"]):
        assert (on.nfe, on.steps_skipped) == (off.nfe, off.steps_skipped)
        np.testing.assert_array_equal(on.result, off.result)


@pytest.mark.parametrize("reader", ["jax", "port"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_schema_accepts_each_trace(served, reader, writer):
    schema = {"jax": jschema, "port": tschema}[reader]
    path = served["jpath" if writer == "jax" else "tpath"]
    with open(path) as f:
        records = schema.validate_trace_lines(f)
    schema.validate_trace_content(records)
    assert any(r["kind"] == "metrics" for r in records)


@pytest.mark.parametrize("mode", ["drain", "continuous"])
def test_per_request_timelines_match_jax(served, mode):
    """Per request, the port's timeline is the JAX package's record for
    record: (kind, name, attribute keys), in order."""
    n = len(DRAIN_TAPE)
    pairs = list(zip(served["jreqs"], served["treqs"]))
    pairs = pairs[:n] if mode == "drain" else pairs[n:]
    jpath, tpath = str(served["jpath"]), str(served["tpath"])
    for j, t in pairs:
        jtl = jobs.timeline(j.request_id, path=jpath)
        ttl = tobs.timeline(t.request_id, path=tpath)
        assert _shape(ttl) == _shape(jtl), (mode, j.method, j.request_id)
        # the JAX package's reader rebuilds the port's timeline the same
        assert _shape(jobs.timeline(t.request_id, path=tpath)) == \
            _shape(ttl)


@pytest.mark.parametrize("mode", ["drain", "continuous"])
def test_timeline_rebuilds_each_request(served, mode):
    """submit -> admit -> per-call -> complete, once each, and one
    ``engine.stepwise`` span per call of a continuous request."""
    n = len(DRAIN_TAPE)
    reqs = served["treqs"][:n] if mode == "drain" else served["treqs"][n:]
    for r in reqs:
        tl = tobs.timeline(r.request_id, path=str(served["tpath"]))
        names = [x["name"] for x in tl]
        # a drain batch's span pulls in its other members' admissions
        lifecycle = [x["name"] for x in tl
                     if x["attrs"].get("request_id") == r.request_id]
        assert lifecycle == ["scheduler.submit", "scheduler.admit",
                             "scheduler.complete"], (r.method, names)
        assert all(x["attrs"].get("mode", mode) == mode for x in tl)
        if mode == "continuous":
            calls = [x for x in tl if x["name"] == "engine.stepwise"]
            assert len(calls) == r.steps_executed == r.nfe
            assert all(r.request_id in x["attrs"]["request_ids"].split(",")
                       for x in calls)
        else:
            assert names.count("engine.generate") == 1
            steps = names.count("sampler.step")
            assert steps == (r.nfe if r.method in HOST else 0)


def test_final_metrics_match_jax(served):
    jm, tm = _final_metrics(served["jpath"]), _final_metrics(served["tpath"])
    jl, tl = _labels(jm), _labels(tm)
    assert set(tl) == set(jl)
    for name in jl:
        if name != "decode.backend_calls":
            assert tl[name] == jl[name], name
    exact = ["engine.requests", "engine.nfe", "engine.tokens",
             "engine.stepwise_calls", "engine.jit_cache.misses",
             "engine.jit_cache.hits"]
    exact += [n for n, inst in jm.items()
              if n.startswith("scheduler.") and inst["type"] == "counter"]
    assert {"scheduler.batches", "scheduler.requests",
            "scheduler.padded_rows", "scheduler.steps_skipped",
            "scheduler.admissions_midflight", "scheduler.slo_requests",
            "scheduler.slo_breaches"} <= set(exact)
    for name in exact:
        assert _values(tm, name) == _values(jm, name), name
    jr = _values(jm, "sampler.reveal_count")
    tr = _values(tm, "sampler.reveal_count")
    assert set(tr) == set(jr)
    for k in jr:
        assert (tr[k]["count"], tr[k]["sum"]) == (jr[k]["count"],
                                                  jr[k]["sum"]), k
    steps = [sum(r["kind"] == "event" and r["name"] == "sampler.step"
                 for r in _records(served[p])) for p in ("jpath", "tpath")]
    assert steps[0] == steps[1] > 0
    (hist,) = _values(tm, "sampler.step_seconds").values()
    assert hist["count"] == steps[1]
    assert served["tslo"] == served["jslo"]


def test_decode_backend_calls_labels(served):
    """By labels only.  The port counts every decode: fused_update for
    drained ``dndm``, decode_tokens for the rest.  The JAX package counts
    per compiled program and compiles the host samplers' steps inside the
    suppressed warm-up, so its drained ``dndm`` decodes never count."""
    def key(op):
        return json.dumps({"backend": "reference", "op": op}, sort_keys=True)

    jl = set(_labels(_final_metrics(served["jpath"]))["decode.backend_calls"])
    tl = set(_labels(_final_metrics(served["tpath"]))["decode.backend_calls"])
    assert tl == {key("fused_update"), key("decode_tokens")}
    assert jl == tl - {key("fused_update")}


def test_suppressed_warmup_records_nothing():
    """A cold engine key runs the request twice (untimed warm-up, then
    timed); telemetry sees one run.  Under ``suppressed()`` nothing is
    recorded at all."""
    _reset_both()
    eng = TEngine(TOracleModel(), TEngineConfig(**ENGINE_KW), device="cpu")
    try:
        tobs.enable()
        with tobs.suppressed():
            eng.generate(5, 2, SEQ, method="dndm")
        assert tobs.snapshot() == {} and tobs.tracing.records() == []
        cold, _ = eng.generate(6, 2, SEQ, method="dndm_topk")
        steps = [r for r in tobs.tracing.records()
                 if r["name"] == "sampler.step"]
        assert len(steps) == cold.nfe == len(cold.aux["reveal_counts"])
        assert tobs.counter("engine.jit_cache.misses").value(
            method="dndm_topk", kind="host") == 1
        calls = tobs.counter("decode.backend_calls").value(
            op="decode_tokens", backend="reference")
        assert calls == cold.nfe
    finally:
        _reset_both()


def test_sampler_trace_keeps_every_state():
    """``SamplerConfig.trace``: dndm keeps each intermediate state."""
    eng = TEngine(TOracleModel(), TEngineConfig(**ENGINE_KW), device="cpu")
    rt = eng.runtime()
    g = torch.Generator().manual_seed(0)
    out = tregistry.run("dndm", g, dataclasses.replace(
        rt, cfg=TSamplerConfig(trace=True)), 2, SEQ)
    assert len(out.aux["trace"]) == out.nfe
    np.testing.assert_array_equal(out.aux["trace"][-1], out.tokens.numpy())
    out = tregistry.run("dndm", torch.Generator().manual_seed(0), rt, 2, SEQ)
    assert out.aux["trace"] == []
