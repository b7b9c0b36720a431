"""The benchmark of ``repro_torch``, the PyTorch/CUDA port of DNDM.

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Configurations (``configs/``), traffic mixes (``traffic/``) and
per-layer metrics (``metrics/``) are files of their own, found by the
names that ``BENCHMARK.json`` gives; ``work/`` holds the frozen
operation and byte counts and the card's peaks, and ``reference/`` the
plain PyTorch reference that decides ``correct``.  A configuration file
names its reference, its work count and the port's config
(``harness.parts``), so an architecture is added as files of its own.
"""
