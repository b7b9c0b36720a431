"""Wrapper of the fused DNDM decode-update kernel
(``repro_torch/csrc/dndm_update.cu``).

A CUDA tensor goes to the kernel, launched on the current stream; a CPU
tensor goes to the plain version in ``ref.py``.  Any K is handled in the
kernel, so nothing is padded.  ``dndm_update.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dndm_update import ref

_LOGIT_DTYPES = (torch.float32, torch.bfloat16)


def _check(logits, x, tau, mask, gumbel, version: int) -> None:
    if logits.dim() != 3:
        raise ValueError(f"logits must be (B, N, K), got {tuple(logits.shape)}")
    if logits.dtype not in _LOGIT_DTYPES:
        raise TypeError(f"logits dtype {logits.dtype}; want f32 or bf16")
    B, N, K = logits.shape
    if version not in (1, 2):
        raise ValueError(f"version must be 1 or 2, got {version}")
    for name, a in (("x", x), ("tau", tau)):
        if a.shape != (B, N) or a.dtype != torch.int32:
            raise ValueError(f"{name} must be (B, N) = ({B}, {N}) int32, "
                             f"got {tuple(a.shape)} {a.dtype}")
    if mask.shape != (K,) or mask.dtype != torch.float32:
        raise ValueError(f"mask must be ({K},) f32, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if gumbel is not None and (gumbel.shape != logits.shape
                               or gumbel.dtype != torch.float32):
        raise ValueError(f"gumbel must be {tuple(logits.shape)} f32, got "
                         f"{tuple(gumbel.shape)} {gumbel.dtype}")
    arrays = [logits, x, tau, mask] + ([gumbel] if gumbel is not None else [])
    if any(a.device != logits.device for a in arrays):
        raise ValueError("dndm_update inputs lie on different devices")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("dndm_update inputs must be contiguous")


def dndm_update(logits, x, tau, t: int, *, mask=None, gumbel=None,
                version: int = 1, temperature: float = 1.0):
    """logits: (B,N,K) f32|bf16; x, tau: (B,N) int32; t: int; ``mask``
    (K,) f32 additive logit penalty; ``gumbel`` optional (B,N,K) f32
    noise (sample mode).  Returns the updated tokens (B,N) int32."""
    K = logits.shape[-1]
    if mask is None:
        mask = torch.zeros((K,), dtype=torch.float32, device=logits.device)
    _check(logits, x, tau, mask, gumbel, version)
    if logits.device.type == "cpu":
        return ref.dndm_update(logits, x, tau, int(t), version=version,
                               mask=mask, temperature=temperature,
                               gumbel=gumbel)
    if logits.device.type != "cuda":
        raise ValueError(f"dndm_update runs on cuda or cpu, not "
                         f"{logits.device}")
    lib = build.library().lib
    fn = (lib.dndm_update_f32 if logits.dtype == torch.float32
          else lib.dndm_update_bf16)
    B, N, _ = logits.shape
    out = torch.empty((B, N), dtype=torch.int32, device=logits.device)
    build.launch("dndm_update", fn, logits.device, logits.data_ptr(),
                 gumbel.data_ptr() if gumbel is not None else None,
                 mask.data_ptr(), x.data_ptr(), tau.data_ptr(),
                 out.data_ptr(), B * N, K, int(t), version,
                 float(temperature))
    dndm_update.launches += 1
    return out


dndm_update.launches = 0
