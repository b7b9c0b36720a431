"""The one arrival generator of the open-loop mixes.

A mix gives ``rate_per_s``; arrivals are a Poisson process at that
rate, the cumulative sum of exponential gaps.  The gaps come from the
mix's own ``gaps_seed``, so every run's seed gets the same arrival
times and changes only what is asked (a permuted order gives the same
load in other bursts, and its p90 then moves with the seed more than
between two runs of one seed).
"""
from __future__ import annotations

import numpy as np


def schedule(traffic: dict, horizon_s: float) -> list[float]:
    """Offsets (seconds from the start of the ramp) of the arrivals due
    before ``horizon_s``, ascending."""
    lam = float(traffic["rate_per_s"])
    n = int(lam * horizon_s * 1.5) + 16
    t = np.cumsum(np.random.default_rng(traffic["gaps_seed"])
                  .exponential(1.0 / lam, n))
    return t[t < horizon_s].tolist()
