"""Fixed-memory mergeable quantile sketch (DDSketch-style).

Latency and NFE distributions are long-tailed, so the decade-bucket
histograms that back ``obs.histogram`` can only answer "which decade" —
useless for p95/p99 SLOs.  This module adds a relative-error sketch in
the style of DDSketch (Masson et al., VLDB 2019): values are mapped to
geometric buckets ``(gamma^(i-1), gamma^i]`` with
``gamma = (1 + alpha) / (1 - alpha)``, so any quantile estimate is
within a factor ``(1 ± alpha)`` of the true value — **relative** error
``alpha`` (default 1%), independent of the value's magnitude.

Guarantees (relied on by the exporter, the serving benchmark JSON and
the regression gate):

* ``quantile(q)`` has relative error ≤ ``alpha`` for every recorded
  value above the collapse floor (see below);
* memory is fixed: at most ``max_bins`` buckets.  When a recording
  would exceed the bound, the *lowest* buckets are collapsed into one —
  upper quantiles (p50/p95/p99, the ones SLOs care about) keep their
  guarantee, only the extreme low tail degrades;
* ``merge`` is exact bucket-count addition — associative and
  commutative, so per-shard sketches combine into the same sketch as a
  single global one (property-tested on the JAX package's copy in
  tests/test_properties.py; tests/test_torch_obs.py holds the two copies
  equal);
* values ``<= 0`` land in a dedicated zero bucket (exact, rank 0).

``to_dict`` / ``from_dict`` round-trip the full state through JSON —
snapshots carry the serialized sketch so readers can compute *any*
quantile after the fact (``quantile_of_snapshot``), not just the
p50/p95/p99 pre-computed by ``Histogram._snapshot_value``.
"""
from __future__ import annotations

import math

DEFAULT_ALPHA = 0.01
DEFAULT_MAX_BINS = 2048


class DDSketch:
    __slots__ = ("alpha", "gamma", "_log_gamma", "max_bins", "bins",
                 "zeros", "count", "_min_key")

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 max_bins: int = DEFAULT_MAX_BINS):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self.max_bins = max_bins
        self.bins: dict[int, int] = {}      # bucket index -> count
        self.zeros = 0                      # values <= 0 (exact bucket)
        self.count = 0
        self._min_key: int | None = None    # collapse floor, lazily known

    def _key(self, value: float) -> int:
        # bucket i covers (gamma^(i-1), gamma^i]
        return math.ceil(math.log(value) / self._log_gamma)

    def _value(self, key: int) -> float:
        # midpoint estimator: est/true in [1-alpha, 1+alpha] over the bin
        return 2.0 * self.gamma ** key / (self.gamma + 1.0)

    def add(self, value: float, n: int = 1) -> None:
        self.count += n
        if value <= 0.0:
            self.zeros += n
            return
        k = self._key(value)
        self.bins[k] = self.bins.get(k, 0) + n
        if len(self.bins) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        """Fold the lowest buckets into one until within ``max_bins``.

        Collapsing low (not high) keeps the upper-quantile guarantee:
        p95/p99 sit in the highest buckets, which are never merged.
        """
        keys = sorted(self.bins)
        spill = 0
        while len(keys) > self.max_bins:
            spill += self.bins.pop(keys.pop(0))
        if spill:
            floor = keys[0]
            self.bins[floor] += spill
            self._min_key = floor

    def merge(self, other: "DDSketch") -> "DDSketch":
        """In-place exact merge (bucket-count addition); returns self."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError("cannot merge sketches with different alpha")
        for k, c in other.bins.items():
            self.bins[k] = self.bins.get(k, 0) + c
        self.zeros += other.zeros
        self.count += other.count
        if len(self.bins) > self.max_bins:
            self._collapse()
        return self

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]; 0.0 on an empty sketch.

        Rank semantics: the returned estimate covers the value of the
        element at (0-based) rank ``floor(q * (count - 1))`` in the
        sorted stream — the same convention as ``numpy.percentile`` with
        nearest-rank interpolation, up to the bucket's relative error.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = int(q * (self.count - 1))
        if rank < self.zeros:
            return 0.0
        seen = self.zeros
        for k in sorted(self.bins):
            seen += self.bins[k]
            if seen > rank:
                return self._value(k)
        return self._value(max(self.bins))      # q == 1 safety

    def copy(self) -> "DDSketch":
        s = DDSketch(self.alpha, self.max_bins)
        s.bins = dict(self.bins)
        s.zeros = self.zeros
        s.count = self.count
        s._min_key = self._min_key
        return s

    def to_dict(self) -> dict:
        """JSON-able full state (bucket keys become strings)."""
        return {"alpha": self.alpha, "max_bins": self.max_bins,
                "zeros": self.zeros, "count": self.count,
                "bins": {str(k): c for k, c in self.bins.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "DDSketch":
        s = cls(d["alpha"], d.get("max_bins", DEFAULT_MAX_BINS))
        s.bins = {int(k): int(c) for k, c in d["bins"].items()}
        s.zeros = int(d["zeros"])
        s.count = int(d["count"])
        return s


def quantile_of_snapshot(hist_value: dict, q: float) -> float:
    """Quantile from a histogram *snapshot* series value (the JSON form
    carrying a serialized ``"sketch"``) — what artifact readers and the
    regression gate use to query arbitrary quantiles post hoc."""
    return DDSketch.from_dict(hist_value["sketch"]).quantile(q)
