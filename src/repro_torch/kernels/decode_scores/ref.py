"""Plain PyTorch version of the streaming (token, score) decode.

The CPU path of :func:`repro_torch.kernels.decode_scores.ops.
decode_scores`, and what ``chip_smoke.py`` holds the CUDA kernel against
on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dndm_update.ref import adjust_logits


def decode_scores(logits, *, mask=None, temperature: float = 1.0,
                  gumbel=None):
    """logits: (B,N,K) -> (tokens (B,N) int32, scores (B,N) f32).

    Tokens are the argmax of the adjusted logits (+ Gumbel noise in
    sample mode), the selection ``dndm_update`` applies, so the two agree
    bitwise.  Scores are the log-softmax of the *noise-free* adjusted
    logits at the chosen token, in the op order of the JAX package's
    ``decode_scores_ref``: ``a[tok] - (m + log(s))`` with ``m = max(a)``
    and ``s = sum(exp(a - m))``, not ``log_softmax``, which groups as
    ``(a[tok] - m) - log(s)``.
    """
    a = adjust_logits(logits, mask=mask, temperature=temperature)
    sel = a if gumbel is None else a + gumbel
    tok = sel.argmax(-1).to(torch.int32)
    a_tok = a.gather(-1, tok.long()[..., None])[..., 0]
    m = a.max(-1).values
    s = torch.exp(a - m[..., None]).sum(-1)
    return tok, a_tok - (m + torch.log(s))
