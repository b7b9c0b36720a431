"""Wrapper of the streaming (token, score) decode kernel
(``repro_torch/csrc/decode_scores.cu``).

A CUDA tensor goes to the kernel, launched on the current stream; a CPU
tensor goes to the plain version in ``ref.py``.  Any K and any contiguous
view (whatever its alignment) is handled in the kernel, so nothing is
padded.  It raises where autograd would need a gradient through it
(``build.no_backward``).  ``decode_scores.launches`` counts kernel
launches.

As for ``dndm_update``, the host time of this wrapper paces the decode
at K = 28: the checks build no ``torch.device`` objects or lists, and
the two outputs are allocated without a ``torch.device`` object.  They
are two allocations:
on the H100's host one int32 buffer cut into two views (tokens, scores
viewed as f32) took longer than a second allocation.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_scores import ref


def _check(logits, mask, gumbel) -> None:
    """Raise on what the kernel cannot take."""
    if logits.dim() != 3:
        raise ValueError(f"logits must be (B, N, K), got {tuple(logits.shape)}")
    if logits.dtype != torch.float32 and logits.dtype != torch.bfloat16:
        raise TypeError(f"logits dtype {logits.dtype}; want f32 or bf16")
    K = logits.shape[2]
    if mask.shape != (K,) or mask.dtype != torch.float32:
        raise ValueError(f"mask must be ({K},) f32, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if gumbel is not None and (gumbel.shape != logits.shape
                               or gumbel.dtype != torch.float32):
        raise ValueError(f"gumbel must be {tuple(logits.shape)} f32, got "
                         f"{tuple(gumbel.shape)} {gumbel.dtype}")
    build.inputs_agree("decode_scores", logits, mask, gumbel)


def decode_scores(logits, *, mask=None, gumbel=None,
                  temperature: float = 1.0):
    """logits: (B,N,K) f32|bf16; ``mask`` (K,) f32 additive logit
    penalty; ``gumbel`` optional (B,N,K) f32 noise (sample mode).
    Returns (tokens (B,N) int32, scores (B,N) f32)."""
    if mask is None:
        mask = torch.zeros((logits.shape[-1],), dtype=torch.float32,
                           device=logits.device)
    _check(logits, mask, gumbel)
    build.no_backward("decode_scores", logits, mask, gumbel)
    if logits.is_cuda:
        B, N, K = logits.shape
        lib = build.library().lib
        fn = (lib.decode_scores_f32 if logits.dtype == torch.float32
              else lib.decode_scores_bf16)
        tok = logits.new_empty((B, N), dtype=torch.int32)
        score = torch.empty_like(tok, dtype=torch.float32)
        build.launch("decode_scores", fn, logits.get_device(),
                     logits.data_ptr(),
                     None if gumbel is None else gumbel.data_ptr(),
                     mask.data_ptr(), tok.data_ptr(), score.data_ptr(),
                     B * N, K, float(temperature))
        decode_scores.launches += 1
        return tok, score
    if logits.device.type == "cpu":
        return ref.decode_scores(logits, mask=mask, temperature=temperature,
                                 gumbel=gumbel)
    raise ValueError(f"decode_scores runs on cuda or cpu, not "
                     f"{logits.device}")


decode_scores.launches = 0
