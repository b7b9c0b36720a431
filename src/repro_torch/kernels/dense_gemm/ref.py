"""Plain PyTorch version of the dense f32 GEMM.

The CPU path of :func:`repro_torch.kernels.dense_gemm.ops.dense_gemm`,
and what the tests and ``chip_smoke.py`` hold the CUDA kernel against on
the card, there with TF32 off (``torch.backends.cuda.matmul.allow_tf32``
False, PyTorch's default): a full f32 product on the CUDA cores.
"""
from __future__ import annotations

import torch


def dense_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) in f32 -> (M, N)."""
    return torch.matmul(a, b)
