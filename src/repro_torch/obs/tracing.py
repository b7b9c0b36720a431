"""Nestable trace spans with a JSON-lines exporter.

A span is a timed region (``with obs.span("engine.generate", method=m)``)
that records name, wall duration, attributes, and its parent span — the
nesting is tracked per-thread, so a scheduler batch span contains the
engine span which contains the per-step sampler events.  An *event* is a
point-in-time record attached to the current span.

When disabled (the default), :func:`span` returns a shared no-op
singleton and :func:`event` returns after one guard check — nothing is
allocated or recorded.  When enabled, records accumulate in a bounded
in-memory buffer (``records()``/:func:`summary`) and, if a sink is set
(``REPRO_TRACE=path.jsonl`` or :func:`set_sink`), each record is also
appended to the file as one JSON line.  The export schema is documented
and validated in :mod:`repro_torch.obs.schema`.

``maybe_profile()`` is the optional device-level hook: when
``REPRO_TORCH_PROFILE=dir`` is set it wraps the region in
``torch.profiler.profile`` (CPU activity, and CUDA activity where a card
is present) and writes one Chrome trace per region into ``dir``;
otherwise it is the same no-op singleton.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time

from repro_torch.obs import metrics as _metrics

# In-memory record bound: _emit keeps the first _MAX_RECORDS records and
# counts (never silently swallows) everything after — the drop total is
# the obs.trace.dropped_records counter, shows up in summary() and in
# the metrics footer record close_sink(final_metrics=True) appends.  A
# sink keeps receiving every record regardless: only the in-memory
# buffer is bounded.
_MAX_RECORDS = 200_000

# sink buffering: one write+flush per record made tracing the hot path's
# dominant syscall cost; records now accumulate and hit the file every
# _SINK_FLUSH_RECORDS records or _SINK_FLUSH_SECONDS since the last
# flush, plus always on flush_sink()/close_sink()/set_sink()
_SINK_FLUSH_RECORDS = 256
_SINK_FLUSH_SECONDS = 1.0

_tls = threading.local()
_next_id = itertools.count(1).__next__
_records: list[dict] = []
_dropped = 0
_sink = None
_sink_path: str | None = None
_sink_buf: list[str] = []
_sink_last_flush = 0.0
_sink_lock = threading.Lock()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _coerce(v):
    """Attribute values must be JSON scalars; numpy/torch scalars unwrap."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if hasattr(v, "item"):
        try:
            return v.item()
        except Exception:           # noqa: BLE001 — fall through to str
            pass
    return str(v)


def _emit(rec: dict) -> None:
    global _dropped
    if len(_records) < _MAX_RECORDS:
        _records.append(rec)
    else:
        _dropped += 1
        _metrics.counter(
            "obs.trace.dropped_records",
            "trace records past the in-memory bound (_MAX_RECORDS); "
            "the file sink still received them").inc()
    if _sink is not None:
        with _sink_lock:
            _sink_buf.append(json.dumps(rec) + "\n")
            if (len(_sink_buf) >= _SINK_FLUSH_RECORDS
                    or time.time() - _sink_last_flush
                    >= _SINK_FLUSH_SECONDS):
                _flush_locked()


def _flush_locked() -> None:
    global _sink_last_flush
    if _sink is not None and _sink_buf:
        _sink.write("".join(_sink_buf))
        _sink.flush()
    _sink_buf.clear()
    _sink_last_flush = time.time()


def flush_sink() -> None:
    """Force buffered records to the sink file (tests, live tailing)."""
    with _sink_lock:
        _flush_locked()


def dropped_records() -> int:
    """Records discarded from the in-memory buffer (sink unaffected)."""
    return _dropped


class _NullSpan:
    """Shared do-nothing span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "ts", "_t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        st = _stack()
        self.parent_id = st[-1].span_id if st else None
        self.span_id = _next_id()
        self.ts = time.time()
        self._t0 = time.perf_counter()
        st.append(self)
        return self

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        _emit({"kind": "span", "name": self.name, "ts": self.ts,
               "span_id": self.span_id, "parent_id": self.parent_id,
               "dur_s": dur,
               "attrs": {k: _coerce(v) for k, v in self.attrs.items()}})
        return False


def span(name: str, **attrs):
    """Timed region; no-op singleton when telemetry is disabled."""
    if not _metrics.enabled():
        return NULL_SPAN
    return Span(name, attrs)


def event(name: str, **attrs) -> None:
    """Point-in-time record under the current span."""
    if not _metrics.enabled():
        return
    st = _stack()
    _emit({"kind": "event", "name": name, "ts": time.time(),
           "span_id": _next_id(),
           "parent_id": st[-1].span_id if st else None,
           "attrs": {k: _coerce(v) for k, v in attrs.items()}})


def write_metrics_record() -> None:
    """Append the current metrics snapshot as one trace record.

    The footer record a trace file ends with (``close_sink(
    final_metrics=True)``): alongside every live metric it carries
    ``obs.trace.dropped_records`` whenever the in-memory buffer
    overflowed, so a truncated ``records()`` view is always detectable
    from the file alone.
    """
    if not _metrics.enabled():
        return
    if _dropped:        # counter may predate enable(); pin the total
        _metrics.gauge("obs.trace.dropped_records_total",
                       "final in-memory drop total").set(_dropped)
    _emit({"kind": "metrics", "ts": time.time(), "span_id": _next_id(),
           "parent_id": None, "attrs": {},
           "metrics": _metrics.snapshot()})


def set_sink(path: str) -> None:
    """Open (append) a JSON-lines sink; closes any previous sink."""
    global _sink, _sink_path, _sink_last_flush
    close_sink()
    with _sink_lock:
        _sink = open(path, "a")
        _sink_path = path
        _sink_last_flush = time.time()


def close_sink(final_metrics: bool = False) -> None:
    global _sink, _sink_path
    if _sink is None:
        return
    if final_metrics:
        write_metrics_record()
    with _sink_lock:
        _flush_locked()
        _sink.close()
        _sink = None
        _sink_path = None


def sink_path() -> str | None:
    return _sink_path


# The sink is write-buffered (_SINK_FLUSH_RECORDS); a process that sets
# REPRO_TRACE and exits without close_sink() must not lose the tail.
atexit.register(close_sink)


def records() -> list[dict]:
    return list(_records)


def clear() -> None:
    global _dropped
    _records.clear()
    _dropped = 0
    _tls.stack = []


def summary() -> str:
    """Human-readable roll-up: spans aggregated by name, then metrics."""
    agg: dict[str, list[float]] = {}
    for r in _records:
        if r["kind"] == "span":
            agg.setdefault(r["name"], []).append(r["dur_s"])
    lines = ["== spans ==",
             f"{'name':<28} {'count':>6} {'total_s':>9} {'mean_s':>9} "
             f"{'max_s':>9}"]
    for name in sorted(agg):
        d = agg[name]
        lines.append(f"{name:<28} {len(d):>6} {sum(d):>9.4f} "
                     f"{sum(d) / len(d):>9.4f} {max(d):>9.4f}")
    if _dropped:
        lines.append(f"!! {_dropped} trace records dropped from the "
                     f"in-memory buffer (bound {_MAX_RECORDS}); the span "
                     "table above is a truncated view (file sink, if "
                     "set, is complete)")
    lines.append("== metrics ==")
    for name, inst in sorted(_metrics.snapshot().items()):
        for s in inst["series"]:
            labels = ",".join(f"{k}={v}" for k, v in s["labels"].items())
            v = s["value"]
            if isinstance(v, dict):                     # histogram stats
                v = (f"count={v['count']} mean={v['mean']:.4g} "
                     f"min={v['min']:.4g} max={v['max']:.4g} "
                     f"p50={v['p50']:.4g} p95={v['p95']:.4g} "
                     f"p99={v['p99']:.4g}")
            lines.append(f"{name}{{{labels}}} {v}")
    return "\n".join(lines)


# ------------------------------------------------------------------
# per-request timelines
# ------------------------------------------------------------------

def _matches(rec: dict, request_id: str) -> bool:
    a = rec.get("attrs", {})
    if a.get("request_id") == request_id:
        return True
    ids = a.get("request_ids")
    return bool(ids) and request_id in str(ids).split(",")


def timeline(request_id: str, path: str | None = None) -> list[dict]:
    """One request's full lifecycle, reconstructed from the trace.

    Returns every record that names ``request_id`` — directly via an
    ``attrs.request_id`` / ``attrs.request_ids`` entry (submit /
    admission / completion events, the batched ``engine.stepwise`` and
    ``scheduler.batch`` spans the request rode) — plus every record
    nested (transitively) under one of those spans, e.g. the
    ``engine.generate`` span and its ``sampler.step`` events inside a
    drain batch.  Sorted by timestamp: submit → admission → each
    batched network call → completion.

    Reads the in-memory buffer by default; pass ``path`` to reconstruct
    from a trace *file* instead (works in a fresh process, which is the
    point of the JSONL export).  Note spans are emitted at exit, so a
    span's file position is later than its children's — ``ts`` (span
    start time) is the sort key that restores causal order.
    """
    if path is not None:
        with open(path) as f:
            recs = [json.loads(line) for line in f if line.strip()]
    else:
        flush_sink()
        recs = list(_records)
    direct = [r for r in recs if _matches(r, request_id)]
    want = {r["span_id"] for r in direct}
    parents = {r["span_id"]: r.get("parent_id") for r in recs}
    out = list(direct)
    for r in recs:
        if r["span_id"] in want:
            continue
        pid = r.get("parent_id")
        seen = set()
        while pid is not None and pid not in seen:
            if pid in want:
                out.append(r)
                want.add(r["span_id"])
                break
            seen.add(pid)
            pid = parents.get(pid)
    return sorted(out, key=lambda r: (r["ts"], r["span_id"]))


class _Profile:
    """torch.profiler wrapper that never breaks the serving path: a
    profiler that fails to start or to write leaves the region running
    unprofiled."""

    __slots__ = ("dir", "_prof")

    def __init__(self, dir: str):
        self.dir = dir
        self._prof = None

    def __enter__(self):
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        except Exception:           # noqa: BLE001 — profiling is best-effort
            self._prof = None
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            try:
                self._prof.__exit__(*exc)
                os.makedirs(self.dir, exist_ok=True)
                self._prof.export_chrome_trace(os.path.join(
                    self.dir, f"trace-{os.getpid()}-{_next_id()}.json"))
            except Exception:       # noqa: BLE001
                pass
        return False


def maybe_profile():
    """``torch.profiler`` context if ``REPRO_TORCH_PROFILE=dir`` is set."""
    d = os.environ.get("REPRO_TORCH_PROFILE", "").strip()
    if not d:
        return NULL_SPAN
    return _Profile(d)
