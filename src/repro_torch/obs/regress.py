"""Bench-regression gate: compare two schema-2 benchmark artifacts (the
port's copy of ``repro.obs.regress``, a reader of the same artifacts).

::

    python -m repro_torch.obs.regress BASE.json NEW.json [--wall-tol 0.5] ...

Both ``benchmarks/run.py --json`` (per-method bench) and ``--serving``
(Poisson drain-vs-continuous) artifacts are understood; BASE and NEW
must be the same kind.  Exit status: 0 = no regression, 1 = regression,
2 = usage / unreadable artifact — so CI can gate on it directly against
a committed baseline (``benchmarks/baselines/cpu_seed.json``).

Two classes of field, compared differently:

* **noise-aware relative thresholds** for anything timing-derived —
  wall seconds, throughput, latency quantiles, and (in serving mode)
  aggregate NFE, whose continuous-mode value counts *pump* calls and so
  wobbles with arrival interleaving.  A field regresses when it is
  worse than ``base * (1 + tol)`` (or ``base / (1 + tol)`` for
  higher-is-better fields).  Defaults are sized to sit well above
  run-to-run jitter on a loaded CI box yet catch a 2x wall regression:
  ``--wall-tol 0.5`` (also latency), ``--throughput-tol 0.35``,
  ``--nfe-tol 0.25``.  Improvements never fail the gate.
* **exact-match** for the token-parity / structural claims the paper
  rests on: ``comparison.solo_parity`` and ``comparison.fewer_nfe`` in
  serving artifacts, method coverage (a method present in BASE must be
  present in NEW), schema version and artifact kind.  These encode
  "continuous batching still reproduces the solo tokens with fewer
  calls" — any flip is a regression regardless of magnitude.

The report prints one line per comparison (``ok``/``REGRESSION``) so
the CI log shows *what* moved, not just that something did.
"""
from __future__ import annotations

import argparse
import json
import sys

BETTER_LOW = "low"          # lower is better (wall, latency, nfe)
BETTER_HIGH = "high"        # higher is better (throughput, tokens/s)


class _Gate:
    def __init__(self):
        self.failures: list[str] = []
        self.lines: list[str] = []

    def rel(self, path: str, base: float, new: float, tol: float,
            better: str) -> None:
        if base <= 0:       # degenerate baseline: nothing to gate on
            self.lines.append(f"ok         {path}: base={base:g} (skipped)")
            return
        if better == BETTER_LOW:
            worse = new > base * (1.0 + tol)
        else:
            worse = new < base / (1.0 + tol)
        delta = (new - base) / base
        tag = "REGRESSION" if worse else "ok"
        self.lines.append(f"{tag:<10} {path}: {base:g} -> {new:g} "
                          f"({delta:+.1%}, tol {tol:.0%})")
        if worse:
            self.failures.append(path)

    def exact(self, path: str, base, new, degrade_only: bool = False) -> None:
        """``degrade_only``: only a True->False flip fails (a baseline
        that never had the property cannot regress it)."""
        bad = (base != new) if not degrade_only else (bool(base)
                                                     and not bool(new))
        tag = "REGRESSION" if bad else "ok"
        self.lines.append(f"{tag:<10} {path}: {base!r} -> {new!r} (exact)")
        if bad:
            self.failures.append(path)


def _compare_bench(base: dict, new: dict, g: _Gate, tols: dict) -> None:
    for m, b in sorted(base["methods"].items()):
        n = new["methods"].get(m)
        if n is None:
            g.exact(f"methods.{m}", "present", "MISSING")
            continue
        g.rel(f"methods.{m}.wall_seconds", b["wall_seconds"],
              n["wall_seconds"], tols["wall"], BETTER_LOW)
        g.rel(f"methods.{m}.tokens_per_second", b["tokens_per_second"],
              n["tokens_per_second"], tols["throughput"], BETTER_HIGH)
        g.rel(f"methods.{m}.nfe", b["nfe"], n["nfe"], tols["nfe"],
              BETTER_LOW)


def _compare_serving(base: dict, new: dict, g: _Gate, tols: dict) -> None:
    for mode, b in sorted(base["modes"].items()):
        n = new["modes"].get(mode)
        if n is None:
            g.exact(f"modes.{mode}", "present", "MISSING")
            continue
        p = f"modes.{mode}"
        g.rel(f"{p}.wall_seconds", b["wall_seconds"], n["wall_seconds"],
              tols["wall"], BETTER_LOW)
        g.rel(f"{p}.throughput_rps", b["throughput_rps"],
              n["throughput_rps"], tols["throughput"], BETTER_HIGH)
        for q in ("latency_p50_s", "latency_p95_s", "latency_p99_s"):
            if q in b and q in n:
                g.rel(f"{p}.{q}", b[q], n[q], tols["wall"], BETTER_LOW)
        g.rel(f"{p}.aggregate_nfe", b["aggregate_nfe"],
              n["aggregate_nfe"], tols["nfe"], BETTER_LOW)
    bc, nc = base.get("comparison", {}), new.get("comparison", {})
    g.exact("comparison.solo_parity", bc.get("solo_parity"),
            nc.get("solo_parity"), degrade_only=True)
    g.exact("comparison.fewer_nfe", bc.get("fewer_nfe"),
            nc.get("fewer_nfe"), degrade_only=True)


def compare(base: dict, new: dict, wall_tol: float = 0.5,
            throughput_tol: float = 0.35,
            nfe_tol: float = 0.25) -> tuple[bool, list[str]]:
    """Returns (ok, report_lines).  ``ok`` is False on any regression."""
    g = _Gate()
    tols = {"wall": wall_tol, "throughput": throughput_tol,
            "nfe": nfe_tol}
    g.exact("schema", base.get("schema"), new.get("schema"))
    g.exact("kind", base.get("kind"), new.get("kind"))
    if g.failures:
        return False, g.lines
    if base.get("kind") == "serving":
        _compare_serving(base, new, g, tols)
    else:
        _compare_bench(base, new, g, tols)
    return not g.failures, g.lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="Gate a new benchmark artifact against a baseline.")
    ap.add_argument("base", help="baseline artifact (committed)")
    ap.add_argument("new", help="freshly produced artifact")
    ap.add_argument("--wall-tol", type=float, default=0.5,
                    help="relative tolerance for wall/latency (default "
                         "0.5 = +50%% passes, 2x fails)")
    ap.add_argument("--throughput-tol", type=float, default=0.35)
    ap.add_argument("--nfe-tol", type=float, default=0.25)
    args = ap.parse_args(argv)
    try:
        with open(args.base) as f:
            base = json.load(f)
        with open(args.new) as f:
            new = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"regress: cannot read artifact: {e}", file=sys.stderr)
        return 2
    ok, lines = compare(base, new, wall_tol=args.wall_tol,
                        throughput_tol=args.throughput_tol,
                        nfe_tol=args.nfe_tol)
    for line in lines:
        print(line)
    n_bad = sum(line.startswith("REGRESSION") for line in lines)
    if ok:
        print(f"regress: OK ({len(lines)} comparisons, 0 regressions)")
        return 0
    print(f"regress: FAILED ({n_bad} regression"
          f"{'s' if n_bad != 1 else ''})", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
