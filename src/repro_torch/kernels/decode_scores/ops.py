"""Wrapper of the streaming (token, score) decode kernel
(``repro_torch/csrc/decode_scores.cu``).

A CUDA tensor goes to the kernel, launched on the current stream; a CPU
tensor goes to the plain version in ``ref.py``.  Any K is handled in the
kernel, so nothing is padded.  ``decode_scores.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_scores import ref

_LOGIT_DTYPES = (torch.float32, torch.bfloat16)


def _check(logits, mask, gumbel) -> None:
    if logits.dim() != 3:
        raise ValueError(f"logits must be (B, N, K), got {tuple(logits.shape)}")
    if logits.dtype not in _LOGIT_DTYPES:
        raise TypeError(f"logits dtype {logits.dtype}; want f32 or bf16")
    K = logits.shape[-1]
    if mask.shape != (K,) or mask.dtype != torch.float32:
        raise ValueError(f"mask must be ({K},) f32, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if gumbel is not None and (gumbel.shape != logits.shape
                               or gumbel.dtype != torch.float32):
        raise ValueError(f"gumbel must be {tuple(logits.shape)} f32, got "
                         f"{tuple(gumbel.shape)} {gumbel.dtype}")
    arrays = [logits, mask] + ([gumbel] if gumbel is not None else [])
    if any(a.device != logits.device for a in arrays):
        raise ValueError("decode_scores inputs lie on different devices")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("decode_scores inputs must be contiguous")


def decode_scores(logits, *, mask=None, gumbel=None,
                  temperature: float = 1.0):
    """logits: (B,N,K) f32|bf16; ``mask`` (K,) f32 additive logit
    penalty; ``gumbel`` optional (B,N,K) f32 noise (sample mode).
    Returns (tokens (B,N) int32, scores (B,N) f32)."""
    K = logits.shape[-1]
    if mask is None:
        mask = torch.zeros((K,), dtype=torch.float32, device=logits.device)
    _check(logits, mask, gumbel)
    if logits.device.type == "cpu":
        return ref.decode_scores(logits, mask=mask, temperature=temperature,
                                 gumbel=gumbel)
    if logits.device.type != "cuda":
        raise ValueError(f"decode_scores runs on cuda or cpu, not "
                         f"{logits.device}")
    lib = build.library().lib
    fn = (lib.decode_scores_f32 if logits.dtype == torch.float32
          else lib.decode_scores_bf16)
    B, N, _ = logits.shape
    tok = torch.empty((B, N), dtype=torch.int32, device=logits.device)
    score = torch.empty((B, N), dtype=torch.float32, device=logits.device)
    build.launch("decode_scores", fn, logits.device, logits.data_ptr(),
                 gumbel.data_ptr() if gumbel is not None else None,
                 mask.data_ptr(), tok.data_ptr(), score.data_ptr(), B * N, K,
                 float(temperature))
    decode_scores.launches += 1
    return tok, score


decode_scores.launches = 0
