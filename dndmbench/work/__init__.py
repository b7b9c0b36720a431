"""Frozen work counts: the operations and bytes of each operation, worked
out from its shapes alone, so that they read the same whatever kernel
implements it; and the card's peaks (``peaks.json``).  A configuration
file names the module that counts one network call of its architecture
(``"work"``, ``call.py`` by default)."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_seconds(flops: float, nbytes: float,
                  dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the operations
    at the peak for ``dtype`` operands and the bytes at HBM bandwidth."""
    return max(flops / PEAKS["flops_per_s"][dtype],
               nbytes / PEAKS["hbm_bytes_per_s"])
