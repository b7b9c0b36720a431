"""Process-wide metrics registry: counters, gauges, histograms — labeled.

Zero-dependency and **disabled by default**: every record method opens
with a single ``if not _ENABLED or _SUPPRESSED: return`` guard, so with
telemetry off the cost of an instrumented call site is one short-circuited
module-global read (no label-dict construction, no allocation, verified
by ``tests/test_torch_obs.py::test_disabled_path_overhead``).  Enable
with :func:`enable` or by setting ``REPRO_METRICS=1`` / ``REPRO_TRACE=...``
in the environment (read once when ``repro_torch.obs`` is imported);
silence a
re-executed computation without flipping the global with
:func:`suppressed`.

Instruments are created lazily by name (``counter(name)`` is
get-or-create; name collisions across types raise) and accept arbitrary
keyword labels per record call::

    obs.counter("engine.nfe").inc(out.nfe, method="dndm")
    obs.histogram("engine.wall_seconds").observe(wall, method="dndm")

Semantics: the port runs eagerly, so a record call counts once per
execution of its call site — ``decode.backend_calls`` once per decode
call, where the JAX package, which records inside ``jax.jit``-traced
bodies, counts once per compiled program.
"""
from __future__ import annotations

import contextlib
import copy
import threading

from repro_torch.obs.sketch import DDSketch

_ENABLED = False
_SUPPRESSED = 0


def enabled() -> bool:
    return _ENABLED and not _SUPPRESSED


@contextlib.contextmanager
def suppressed():
    """Temporarily silence every instrument, trace event and span (a
    profiler session included) without touching the global on/off
    state.  For work that re-executes an already-measured
    computation — e.g. the engine's untimed host-sampler warm-up run —
    where recording would double-count real serving metrics.  Reentrant;
    not thread-local (the repo's schedulers are single-threaded)."""
    global _SUPPRESSED
    _SUPPRESSED += 1
    try:
        yield
    finally:
        _SUPPRESSED -= 1


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Instrument:
    kind = "abstract"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.series: dict = {}       # labels-key -> value/stats

    def _snapshot_value(self, v):
        return v

    def snapshot(self) -> dict:
        return {"type": self.kind, "help": self.help,
                "series": [{"labels": dict(k),
                            "value": self._snapshot_value(v)}
                           for k, v in sorted(self.series.items())]}


class Counter(_Instrument):
    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        if not _ENABLED or _SUPPRESSED:
            return
        k = _labels_key(labels)
        with _lock:
            self.series[k] = self.series.get(k, 0) + value

    def value(self, **labels):
        return self.series.get(_labels_key(labels), 0)


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value, **labels) -> None:
        if not _ENABLED or _SUPPRESSED:
            return
        with _lock:
            self.series[_labels_key(labels)] = value

    def value(self, **labels):
        return self.series.get(_labels_key(labels))


# decade buckets: 100ns .. 100s covers step timings and reveal counts
_BUCKET_EDGES = tuple(10.0 ** e for e in range(-7, 3))

# pre-computed quantiles every histogram snapshot carries; arbitrary
# quantiles stay available via the serialized sketch
# (repro_torch.obs.sketch.quantile_of_snapshot)
QUANTILES = (0.5, 0.95, 0.99)


class Histogram(_Instrument):
    """Decade-bucket histogram + DDSketch per series.

    Every series carries a fixed-memory relative-error quantile sketch
    (``sketch.DDSketch``, alpha = 1%) next to the coarse decade buckets,
    so p50/p95/p99 are first-class in snapshots, ``summary()`` and the
    Prometheus exporter — with documented ≤ 1% relative error instead of
    "somewhere in this decade".
    """

    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        if not _ENABLED or _SUPPRESSED:
            return
        k = _labels_key(labels)
        with _lock:
            s = self.series.get(k)
            if s is None:
                s = self.series[k] = {
                    "count": 0, "sum": 0.0, "min": value, "max": value,
                    "buckets": [0] * (len(_BUCKET_EDGES) + 1),
                    "sketch": DDSketch()}
            s["count"] += 1
            s["sum"] += value
            if value < s["min"]:
                s["min"] = value
            if value > s["max"]:
                s["max"] = value
            i = 0
            for edge in _BUCKET_EDGES:
                if value <= edge:
                    break
                i += 1
            s["buckets"][i] += 1
            s["sketch"].add(value)

    def value(self, **labels):
        return self.series.get(_labels_key(labels))

    def _snapshot_value(self, s: dict) -> dict:
        buckets = {}
        for i, c in enumerate(s["buckets"]):
            if c:
                le = (f"{_BUCKET_EDGES[i]:g}" if i < len(_BUCKET_EDGES)
                      else "inf")
                buckets[f"le_{le}"] = c
        sk: DDSketch = s["sketch"]
        out = {"count": s["count"], "sum": s["sum"], "min": s["min"],
               "max": s["max"],
               "mean": s["sum"] / s["count"] if s["count"] else 0.0,
               "buckets": buckets, "sketch": sk.to_dict()}
        for q in QUANTILES:
            out[f"p{int(q * 100)}"] = sk.quantile(q)
        return out


_lock = threading.RLock()
_REGISTRY: dict[str, _Instrument] = {}


def _get(cls, name: str, help: str) -> _Instrument:
    with _lock:
        inst = _REGISTRY.get(name)
        if inst is None:
            inst = _REGISTRY[name] = cls(name, help)
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{inst.kind}, not {cls.kind}")
        return inst


def counter(name: str, help: str = "") -> Counter:
    return _get(Counter, name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _get(Gauge, name, help)


def histogram(name: str, help: str = "") -> Histogram:
    return _get(Histogram, name, help)


def snapshot() -> dict:
    """JSON-able view of every instrument with at least one series.

    Taken under the registry lock that every record call also holds, so
    a concurrent reader (the ``/metrics`` exporter thread, the snapshot
    writer) never observes a torn series — e.g. a histogram whose
    ``count`` was bumped but whose ``sum``/sketch were not yet.  The
    returned structure is freshly built (histogram buckets and sketches
    are serialized copies), so callers can hold it across further
    recording without aliasing live state.
    """
    with _lock:
        return copy.deepcopy({name: inst.snapshot()
                              for name, inst in sorted(_REGISTRY.items())
                              if inst.series})


def reset() -> None:
    """Clear recorded values; registered instruments survive."""
    with _lock:
        for inst in _REGISTRY.values():
            inst.series.clear()
