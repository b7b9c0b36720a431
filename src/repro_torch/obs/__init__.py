"""Runtime telemetry of the port: metrics registry + trace spans +
quantile sketches + live export + SLOs + schema.

The counterpart of the JAX package's ``repro.obs``: the same metric,
span and event names, attributes, file formats and environment
variables, in its own copy (the port imports nothing of ``repro``), so
either package's ``schema`` and ``regress`` read the other's artifacts.

Disabled by default and near-free when disabled (one guard check per
instrumented call site).  Ways to turn it on:

* ``REPRO_TRACE=path.jsonl``  — enable metrics *and* export every span /
  event / metrics record as JSON lines to ``path`` (buffered; schema in
  :mod:`repro_torch.obs.schema`);
* ``REPRO_METRICS=1``         — enable the in-process metrics registry
  only (``obs.snapshot()`` / ``obs.summary()``);
* ``REPRO_METRICS_PORT=9099`` — enable metrics *and* serve them live:
  Prometheus text at ``/metrics``, JSON at ``/snapshot``
  (:mod:`repro_torch.obs.exporter`);
* ``REPRO_SNAPSHOT=path.json`` (``REPRO_SNAPSHOT_INTERVAL=5``) — enable
  metrics and write the JSON snapshot to a file every interval, for
  headless runs nothing can scrape;
* ``REPRO_SLO=latency<0.25@0.99,nfe<64`` — declarative per-request
  budgets scored at request completion (:mod:`repro_torch.obs.slo`);
* ``obs.enable()``            — programmatic, e.g. from tests.

``REPRO_TORCH_PROFILE=dir`` additionally wraps every ``engine.generate``
in ``torch.profiler.profile`` (CPU and, on a card, CUDA activity) and
writes a Chrome trace per call into ``dir``.

Every serving-path record carries the request id minted at
``submit()``; ``obs.timeline(request_id)`` (optionally with a trace-file
path) reconstructs one request's full submit → admission → per-call →
completion history.
"""
from __future__ import annotations

import os

from repro_torch.obs import exporter, metrics, sketch, slo, tracing
from repro_torch.obs.metrics import (counter, disable, enable, enabled,
                                     gauge, histogram, reset, snapshot,
                                     suppressed)
from repro_torch.obs.tracing import (event, flush_sink, maybe_profile,
                                     set_sink, span, summary, timeline,
                                     write_metrics_record)

__all__ = [
    "counter", "gauge", "histogram", "snapshot", "reset",
    "enable", "disable", "enabled", "suppressed",
    "span", "event", "summary", "set_sink", "flush_sink", "timeline",
    "write_metrics_record", "maybe_profile",
    "metrics", "tracing", "sketch", "exporter", "slo",
    "configure_from_env",
]


def configure_from_env() -> None:
    """Read REPRO_TRACE / REPRO_METRICS / exporter / SLO env; idempotent."""
    trace = os.environ.get("REPRO_TRACE", "").strip()
    port = os.environ.get("REPRO_METRICS_PORT", "").strip()
    snap = os.environ.get("REPRO_SNAPSHOT", "").strip()
    if trace:
        enable()
        if tracing.sink_path() != trace:
            set_sink(trace)
    elif os.environ.get("REPRO_METRICS", "").strip() not in ("", "0"):
        enable()
    if port:
        enable()
        exporter.serve(int(port))
    if snap:
        enable()
        interval = float(
            os.environ.get("REPRO_SNAPSHOT_INTERVAL", "5") or 5)
        exporter.start_snapshot_writer(snap, interval)
    spec = os.environ.get("REPRO_SLO", "").strip()
    if spec and not slo.active():
        slo.configure(slo.parse(spec))


configure_from_env()
