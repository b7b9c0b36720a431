"""Documented telemetry schemas + zero-dependency validator.

Three artifacts round-trip through this module:

**BENCH_*.json** (``benchmarks/run.py --json``, schema version 2)::

    {"schema": 2, "jax_backend": str, "quick": bool,
     "config": {"batch": int, "seq": int, "steps": int},
     "methods": {<name>: {"noise": str, "kind": "host"|"scan",
                          "wall_seconds": float, "compile_seconds": float,
                          "nfe": int, "tokens_per_second": float,
                          "us_per_nfe": float,
                          "metrics": {"jit_cache_hits": int,
                                      "jit_cache_misses": int}}},
     "telemetry": {"enabled": bool, "trace": str|null,
                   "metrics": {<metric>: {"type": str, "help": str,
                                          "series": [{"labels": {...},
                                                      "value": any}]}}}}

**BENCH_serving.json** (``benchmarks/run.py --serving``, schema
version 2, tagged ``"kind": "serving"``)::

    {"schema": 2, "kind": "serving", "jax_backend": str, "quick": bool,
     "config": {"max_batch": int, "seq": int, "steps": int,
                "requests": int, "method": str, "shared_tau": bool,
                "arrival_rate_rps": float},
     "modes": {"drain":      {"wall_seconds": float, "aggregate_nfe": int,
                              "throughput_rps": float,
                              "latency_p50_s": float,
                              "latency_p95_s": float,
                              "latency_p99_s": float},
               "continuous": {... same keys ..., "steps_skipped": int,
                              "admissions_midflight": int}},
     "comparison": {"nfe_ratio": float, "throughput_ratio": float,
                    "fewer_nfe": bool, "solo_parity": bool},
     "telemetry": {... as BENCH ...}}

**REPRO_TRACE JSON-lines** — one object per line, three kinds::

    {"kind": "span",    "name": str, "ts": float, "span_id": int,
     "parent_id": int|null, "dur_s": float, "t0_ns": int, "t1_ns": int,
     "attrs": {...}}
    {"kind": "event",   "name": str, "ts": float, "span_id": int,
     "parent_id": int|null, "attrs": {...}}
    {"kind": "metrics", "ts": float, "span_id": int, "parent_id": null,
     "attrs": {}, "metrics": {<metric>: {...}}}

CLI::

    PYTHONPATH=src python -m repro_torch.obs.schema [BENCH.json] trace.jsonl

validates the benchmark record (a reader here: the port writes no BENCH
record yet), every trace line, and the acceptance-level content of a
serving trace that ran a DNDM host sampler behind a scheduler: an
``engine.generate`` span with nfe/backend/jit-cache attrs, per-step
``sampler.step`` events carrying |R_t| (``reveal``), and a ``metrics``
record with scheduler occupancy.  ``ts`` is seconds on the port's
``obs.clock_ns`` (monotonic, on the Unix epoch); a span's ``t0_ns`` and
``t1_ns`` are its two stamps (the JAX package's spans have neither, and
neither schema requires them).  A lone ``*.jsonl`` argument is checked
as a trace.  This is the port's copy of ``repro.obs.schema``: the two
accept each other's traces.
"""
from __future__ import annotations

import json
import sys
from typing import Iterable

BENCH_SCHEMA_VERSION = 2

_SPAN_KINDS = ("span", "event", "metrics")


class SchemaError(ValueError):
    pass


def _check(ok: bool, path: str, msg: str) -> None:
    if not ok:
        raise SchemaError(f"{path}: {msg}")


def _typed(obj: dict, path: str, key: str, types) -> object:
    _check(key in obj, path, f"missing key {key!r}")
    v = obj[key]
    _check(isinstance(v, types), path,
           f"{key!r} is {type(v).__name__}, want {types}")
    return v


def _number(obj, path, key, minimum=None):
    v = _typed(obj, path, key, (int, float))
    _check(not isinstance(v, bool), path, f"{key!r} is bool, want number")
    if minimum is not None:
        _check(v >= minimum, path, f"{key!r}={v} < {minimum}")
    return v


def validate_metrics_snapshot(snap: dict, path: str = "metrics") -> None:
    _check(isinstance(snap, dict), path, "snapshot must be an object")
    for name, inst in snap.items():
        p = f"{path}.{name}"
        _typed(inst, p, "type", str)
        _typed(inst, p, "help", str)
        series = _typed(inst, p, "series", list)
        for i, s in enumerate(series):
            sp = f"{p}.series[{i}]"
            _check(isinstance(s, dict), p, f"series[{i}] must be an object")
            _typed(s, sp, "labels", dict)
            _check("value" in s, sp, "missing 'value'")
            if inst["type"] == "histogram":
                # quantiles are first-class: every histogram series
                # carries sketch-backed p50/p95/p99 plus the serialized
                # sketch itself (repro_torch.obs.sketch) for arbitrary q
                v = _typed(s, sp, "value", dict)
                for q in ("p50", "p95", "p99"):
                    _number(v, f"{sp}.value", q, minimum=0.0)
                sk = _typed(v, f"{sp}.value", "sketch", dict)
                _number(sk, f"{sp}.value.sketch", "alpha", minimum=0.0)
                _number(sk, f"{sp}.value.sketch", "count", minimum=0)
                _typed(sk, f"{sp}.value.sketch", "bins", dict)


def validate_bench(record: dict) -> None:
    """Raise :class:`SchemaError` unless ``record`` is a valid v2 bench."""
    p = "bench"
    _check(isinstance(record, dict), p, "record must be an object")
    _check(record.get("schema") == BENCH_SCHEMA_VERSION, p,
           f"schema={record.get('schema')!r}, want {BENCH_SCHEMA_VERSION}")
    _typed(record, p, "jax_backend", str)
    _typed(record, p, "quick", bool)
    cfg = _typed(record, p, "config", dict)
    for k in ("batch", "seq", "steps"):
        _number(cfg, f"{p}.config", k, minimum=1)
    methods = _typed(record, p, "methods", dict)
    _check(len(methods) > 0, p, "methods is empty")
    for m, rec in methods.items():
        mp = f"{p}.methods.{m}"
        _typed(rec, mp, "noise", str)
        kind = _typed(rec, mp, "kind", str)
        _check(kind in ("host", "scan"), mp, f"kind={kind!r}")
        _number(rec, mp, "wall_seconds", minimum=0.0)
        _number(rec, mp, "compile_seconds", minimum=0.0)
        _number(rec, mp, "nfe", minimum=0)
        _number(rec, mp, "tokens_per_second", minimum=0.0)
        _number(rec, mp, "us_per_nfe", minimum=0.0)
        met = _typed(rec, mp, "metrics", dict)
        _number(met, f"{mp}.metrics", "jit_cache_hits", minimum=0)
        _number(met, f"{mp}.metrics", "jit_cache_misses", minimum=0)
    tel = _typed(record, p, "telemetry", dict)
    _typed(tel, f"{p}.telemetry", "enabled", bool)
    _check("trace" in tel, f"{p}.telemetry", "missing 'trace'")
    _check(tel["trace"] is None or isinstance(tel["trace"], str),
           f"{p}.telemetry", "trace must be str or null")
    validate_metrics_snapshot(tel.get("metrics", {}),
                              f"{p}.telemetry.metrics")


_MODE_KEYS = ("wall_seconds", "throughput_rps", "latency_p50_s",
              "latency_p95_s", "latency_p99_s")


def validate_serving(record: dict) -> None:
    """Raise :class:`SchemaError` unless ``record`` is a valid serving
    benchmark artifact (``benchmarks/run.py --serving``)."""
    p = "serving"
    _check(isinstance(record, dict), p, "record must be an object")
    _check(record.get("schema") == BENCH_SCHEMA_VERSION, p,
           f"schema={record.get('schema')!r}, want {BENCH_SCHEMA_VERSION}")
    _check(record.get("kind") == "serving", p,
           f"kind={record.get('kind')!r}, want 'serving'")
    _typed(record, p, "jax_backend", str)
    _typed(record, p, "quick", bool)
    cfg = _typed(record, p, "config", dict)
    for k in ("max_batch", "seq", "steps", "requests"):
        _number(cfg, f"{p}.config", k, minimum=1)
    _typed(cfg, f"{p}.config", "method", str)
    _number(cfg, f"{p}.config", "arrival_rate_rps", minimum=0.0)
    modes = _typed(record, p, "modes", dict)
    for mode in ("drain", "continuous"):
        _check(mode in modes, f"{p}.modes", f"missing mode {mode!r}")
        mp = f"{p}.modes.{mode}"
        rec = modes[mode]
        _check(isinstance(rec, dict), mp, "mode record must be an object")
        for k in _MODE_KEYS:
            _number(rec, mp, k, minimum=0.0)
        _number(rec, mp, "aggregate_nfe", minimum=1)
    cp = f"{p}.comparison"
    cmp_rec = _typed(record, p, "comparison", dict)
    _number(cmp_rec, cp, "nfe_ratio", minimum=0.0)
    _number(cmp_rec, cp, "throughput_ratio", minimum=0.0)
    _typed(cmp_rec, cp, "fewer_nfe", bool)
    _typed(cmp_rec, cp, "solo_parity", bool)
    _number(modes["continuous"], f"{p}.modes.continuous", "steps_skipped",
            minimum=0)
    _number(modes["continuous"], f"{p}.modes.continuous",
            "admissions_midflight", minimum=0)
    tel = _typed(record, p, "telemetry", dict)
    _typed(tel, f"{p}.telemetry", "enabled", bool)
    validate_metrics_snapshot(tel.get("metrics", {}),
                              f"{p}.telemetry.metrics")


def validate_trace_lines(lines: Iterable[str]) -> list[dict]:
    """Structural check of a JSON-lines trace; returns parsed records."""
    out: list[dict] = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        p = f"trace:{i + 1}"
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise SchemaError(f"{p}: not JSON ({e})") from None
        _check(isinstance(rec, dict), p, "line must be an object")
        kind = _typed(rec, p, "kind", str)
        _check(kind in _SPAN_KINDS, p, f"kind={kind!r}")
        _number(rec, p, "ts", minimum=0.0)
        _number(rec, p, "span_id", minimum=1)
        _check("parent_id" in rec, p, "missing 'parent_id'")
        _check(rec["parent_id"] is None
               or isinstance(rec["parent_id"], int), p,
               "parent_id must be int or null")
        _typed(rec, p, "attrs", dict)
        if kind in ("span", "event"):
            _typed(rec, p, "name", str)
        if kind == "span":
            _number(rec, p, "dur_s", minimum=0.0)
        if kind == "metrics":
            validate_metrics_snapshot(_typed(rec, p, "metrics", dict), p)
        out.append(rec)
    return out


def validate_trace_content(records: list[dict]) -> None:
    """Acceptance-level content checks for a full DNDM benchmark trace."""
    p = "trace"
    gen = [r for r in records
           if r["kind"] == "span" and r["name"] == "engine.generate"]
    _check(len(gen) > 0, p, "no engine.generate span")
    _check(any({"nfe", "backend", "cache"} <= set(r["attrs"]) for r in gen),
           p, "no engine.generate span with nfe/backend/cache attrs")
    steps = [r for r in records
             if r["kind"] == "event" and r["name"] == "sampler.step"]
    _check(any("reveal" in r["attrs"] for r in steps),
           p, "no sampler.step event with a per-step reveal count (|R_t|)")
    mets = [r for r in records if r["kind"] == "metrics"]
    _check(len(mets) > 0, p, "no metrics record")
    final = mets[-1]["metrics"]
    for required in ("engine.jit_cache.misses", "scheduler.occupancy",
                     "decode.backend_calls"):
        _check(required in final, p,
               f"final metrics record lacks {required!r}")


def _check_trace_file(path: str) -> None:
    with open(path) as f:
        records = validate_trace_lines(f)
    validate_trace_content(records)
    spans = sum(r["kind"] == "span" for r in records)
    events = sum(r["kind"] == "event" for r in records)
    print(f"ok: {path} valid ({spans} spans, {events} events, "
          f"{len(records)} records)")


def main(argv: list[str]) -> int:
    if not argv or len(argv) > 2:
        print("usage: python -m repro_torch.obs.schema [BENCH.json] "
              "trace.jsonl", file=sys.stderr)
        return 2
    try:
        if len(argv) == 1 and argv[0].endswith(".jsonl"):
            _check_trace_file(argv[0])
            return 0
        with open(argv[0]) as f:
            record = json.load(f)
        if record.get("kind") == "serving":
            validate_serving(record)
            print(f"ok: {argv[0]} valid serving record (schema "
                  f"{BENCH_SCHEMA_VERSION}, "
                  f"{len(record['modes'])} modes)")
        else:
            validate_bench(record)
            print(f"ok: {argv[0]} valid (schema {BENCH_SCHEMA_VERSION}, "
                  f"{len(record['methods'])} methods)")
        if len(argv) == 2:
            _check_trace_file(argv[1])
    except (OSError, json.JSONDecodeError, SchemaError) as e:
        print(f"schema validation FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
