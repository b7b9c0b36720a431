#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 dndmbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  Needs a CUDA device (exits 2 without one)
and the port under ``src/``; builds its kernels into ``build/`` there.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT / "src"), str(ROOT)]
# every build and kernel cache inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")

from dndmbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
