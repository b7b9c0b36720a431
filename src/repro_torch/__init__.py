"""PyTorch/CUDA port of the DNDM system (``repro``, JAX + Pallas).

The package mirrors ``repro``'s layout so that each module's counterpart
sits at the same path.  It imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``repro``.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; without a GPU and without a device
they raise (see :mod:`repro_torch.device`).
"""
