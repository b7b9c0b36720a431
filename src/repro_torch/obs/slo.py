"""Declarative serving SLOs: latency / NFE budgets with error-budget
burn accounting.

A :class:`Budget` says "metric X of a completed request must stay under
``limit`` for at least ``objective`` of requests" — e.g. p99-style
"99% of dndm requests complete within 250 ms", or "no request may spend
more than 64 network calls".  Both schedulers report every completed
request here (:func:`observe_request`); each matching budget counts the
request and, if it blew the limit, the breach:

* ``scheduler.slo_requests``  (counter; labels budget, method) — total
  requests a budget evaluated;
* ``scheduler.slo_breaches``  (counter; labels budget, method) —
  requests over the limit.

:func:`status` turns the counters into error-budget burn: a budget with
``objective = 0.99`` over ``n`` requests has an allowance of
``0.01 * n`` breaches; ``burn = breaches / allowance`` (> 1.0 means the
error budget is spent — the alerting threshold).  ``burn`` is exposed
per budget as the ``scheduler.slo_burn`` gauge every time it is read,
so the live ``/metrics`` endpoint carries it.

Configuration is data, not code::

    slo.configure([slo.Budget("latency", 0.25),                # all methods
                   slo.Budget("nfe", 64, objective=1.0),
                   slo.Budget("latency", 0.5, method="dndm_c")])

or the environment (read by ``obs.configure_from_env``)::

    REPRO_SLO="latency<0.25@0.99,nfe<64@1.0,dndm_c.latency<0.5"

entry grammar: ``[method.]metric<limit[@objective]`` — metric is one of
``latency`` (admission → completion seconds), ``queue`` (submit →
admission seconds) or ``nfe`` (network calls); objective defaults to
0.99; no method means every method.

With no budgets configured (the default) :func:`observe_request`
returns after one list check — the schedulers pay nothing.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs import metrics as _metrics

METRICS = ("latency", "queue", "nfe")


@dataclasses.dataclass(frozen=True)
class Budget:
    metric: str                 # latency | queue | nfe
    limit: float                # per-request ceiling
    objective: float = 0.99     # target fraction of requests within limit
    method: str = "*"           # "*" = every method

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(f"unknown SLO metric {self.metric!r}; "
                             f"choose from {METRICS}")
        if not 0.0 < self.objective <= 1.0:
            raise ValueError(f"objective must be in (0, 1], got "
                             f"{self.objective}")

    @property
    def name(self) -> str:
        scope = "" if self.method == "*" else f"{self.method}."
        return f"{scope}{self.metric}<{self.limit:g}"


_budgets: list[Budget] = []


def configure(budgets: list[Budget]) -> None:
    _budgets[:] = list(budgets)


def clear() -> None:
    _budgets.clear()


def budgets() -> tuple[Budget, ...]:
    return tuple(_budgets)


def active() -> bool:
    return bool(_budgets)


def parse(spec: str) -> list[Budget]:
    """``REPRO_SLO`` grammar -> budgets (see module docstring)."""
    out: list[Budget] = []
    for entry in spec.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        head, _, obj = entry.partition("@")
        metric, _, limit = head.partition("<")
        if not limit:
            raise ValueError(f"SLO entry {entry!r} lacks '<limit'")
        method, _, m = metric.rpartition(".")
        out.append(Budget(m.strip(), float(limit),
                          objective=float(obj) if obj else 0.99,
                          method=method.strip() or "*"))
    return out


def observe_request(method: str, *, latency_s: float | None = None,
                    queue_s: float | None = None,
                    nfe: float | None = None) -> None:
    """Score one completed request against every matching budget."""
    if not _budgets:
        return
    values = {"latency": latency_s, "queue": queue_s, "nfe": nfe}
    for b in _budgets:
        v = values[b.metric]
        if v is None or (b.method != "*" and b.method != method):
            continue
        _metrics.counter("scheduler.slo_requests",
                         "requests evaluated per SLO budget").inc(
            budget=b.name, method=method)
        if v > b.limit:
            _metrics.counter("scheduler.slo_breaches",
                             "requests over their SLO budget").inc(
                budget=b.name, method=method)


def status() -> dict:
    """Error-budget burn per budget: {name: {requests, breaches,
    allowance, burn, objective, limit}}.  Also refreshes the
    ``scheduler.slo_burn`` gauge so live scrapes carry it."""
    req = _metrics.counter("scheduler.slo_requests")
    brk = _metrics.counter("scheduler.slo_breaches")
    burn_g = _metrics.gauge("scheduler.slo_burn",
                            "error-budget burn (>1 = budget spent)")
    out: dict = {}
    for b in _budgets:
        with _metrics._lock:        # consistent read vs a recording pump
            n = sum(v for k, v in req.series.items()
                    if dict(k).get("budget") == b.name)
            breaches = sum(v for k, v in brk.series.items()
                           if dict(k).get("budget") == b.name)
        allowance = (1.0 - b.objective) * n
        burn = (breaches / allowance if allowance > 0
                else float(breaches > 0))
        burn_g.set(round(burn, 6), budget=b.name)
        out[b.name] = {"requests": int(n), "breaches": int(breaches),
                       "allowance": round(allowance, 3),
                       "burn": round(burn, 4),
                       "objective": b.objective, "limit": b.limit,
                       "metric": b.metric, "method": b.method}
    return out
