"""Wrapper of the fused DNDM decode-update kernel
(``repro_torch/csrc/dndm_update.cu``).

A CUDA tensor goes to the kernel, launched on the current stream; a CPU
tensor goes to the plain version in ``ref.py``.  Any K and any contiguous
view (whatever its alignment) is handled in the kernel, so nothing is
padded.  ``dndm_update.launches`` counts kernel launches.

The kernel takes about 3 us at the paper's K = 28, so the host time of
this wrapper paces the decode there: the checks compare shapes, dtypes
and device indices without building ``torch.device`` objects or lists.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dndm_update import ref


def _check(logits, x, tau, mask, gumbel, version: int) -> None:
    """Raise on what the kernel cannot take."""
    if logits.dim() != 3:
        raise ValueError(f"logits must be (B, N, K), got {tuple(logits.shape)}")
    if logits.dtype != torch.float32 and logits.dtype != torch.bfloat16:
        raise TypeError(f"logits dtype {logits.dtype}; want f32 or bf16")
    if version != 1 and version != 2:
        raise ValueError(f"version must be 1 or 2, got {version}")
    B, N, K = logits.shape
    if x.shape != (B, N) or x.dtype != torch.int32:
        raise ValueError(f"x must be (B, N) = ({B}, {N}) int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if tau.shape != x.shape or tau.dtype != torch.int32:
        raise ValueError(f"tau must be (B, N) = ({B}, {N}) int32, got "
                         f"{tuple(tau.shape)} {tau.dtype}")
    if mask.shape != (K,) or mask.dtype != torch.float32:
        raise ValueError(f"mask must be ({K},) f32, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if gumbel is not None and (gumbel.shape != logits.shape
                               or gumbel.dtype != torch.float32):
        raise ValueError(f"gumbel must be {tuple(logits.shape)} f32, got "
                         f"{tuple(gumbel.shape)} {gumbel.dtype}")
    build.inputs_agree("dndm_update", logits, x, tau, mask, gumbel)


def dndm_update(logits, x, tau, t: int, *, mask=None, gumbel=None,
                version: int = 1, temperature: float = 1.0):
    """logits: (B,N,K) f32|bf16; x, tau: (B,N) int32; t: int; ``mask``
    (K,) f32 additive logit penalty; ``gumbel`` optional (B,N,K) f32
    noise (sample mode).  Returns the updated tokens (B,N) int32."""
    if mask is None:
        mask = torch.zeros((logits.shape[-1],), dtype=torch.float32,
                           device=logits.device)
    _check(logits, x, tau, mask, gumbel, version)
    if logits.is_cuda:
        B, N, K = logits.shape
        lib = build.library().lib
        fn = (lib.dndm_update_f32 if logits.dtype == torch.float32
              else lib.dndm_update_bf16)
        out = torch.empty_like(x)
        build.launch("dndm_update", fn, logits.get_device(),
                     logits.data_ptr(),
                     None if gumbel is None else gumbel.data_ptr(),
                     mask.data_ptr(), x.data_ptr(), tau.data_ptr(),
                     out.data_ptr(), B * N, K, int(t), version,
                     float(temperature))
        dndm_update.launches += 1
        return out
    if logits.device.type == "cpu":
        return ref.dndm_update(logits, x, tau, int(t), version=version,
                               mask=mask, temperature=temperature,
                               gumbel=gumbel)
    raise ValueError(f"dndm_update runs on cuda or cpu, not {logits.device}")


dndm_update.launches = 0
