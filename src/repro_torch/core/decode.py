"""Decode layer: the one place where a sampler step decodes x0_hat from
the (B, N, K) denoiser logits.

``fused_update`` (select x0 + eq. (9), the DNDM samplers) goes to the
``dndm_update`` CUDA kernel, and ``decode_tokens`` ((token, score) pairs,
the confidence-ranked samplers) to the ``decode_scores`` CUDA kernel, for
CUDA tensors; both go to their plain versions for CPU tensors.  There is
no other backend switch.  Decode modes follow ``SamplerConfig.x0_mode``:
``"argmax"`` picks the highest adjusted logit; ``"sample"`` draws
categorically by the Gumbel-max trick (argmax of logits/temp + mask +
Gumbel(0,1) noise), with the noise drawn from the caller's generator on
the logits' device, so kernel and plain version give bitwise-identical
tokens for the same noise, and the two ops give the same tokens.

A rolling batch of independent requests (continuous serving,
``samplers/stepwise.py``) draws its slab row by row from each request's
own generator: :func:`row_gumbel_noise` and :func:`row_uniform`.

With telemetry on, every decode counts in ``decode.backend_calls`` (labels
``op`` and ``backend``: ``kernel`` for CUDA tensors, ``reference`` for the
plain version on CPU tensors), once per call: the JAX package counts at
trace time, once per compiled program.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import obs
from repro_torch.kernels.decode_scores import ops as _sops
from repro_torch.kernels.dndm_update import ops as _ops


def gumbel_noise(generator: torch.Generator, shape,
                 device=None) -> torch.Tensor:
    """Gumbel(0, 1) f32 noise, ``-log(-log(u))`` with ``u`` uniform on
    [tiny, 1) so that no draw is infinite."""
    if not isinstance(generator, torch.Generator):
        raise TypeError("Gumbel noise draws from an explicit torch.Generator")
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def row_gumbel_noise(sources, shape, device=None) -> torch.Tensor:
    """(B, *shape) f32 Gumbel slab of a rolling batch, row i from
    ``sources[i]``: a ``torch.Generator`` (draws a ``shape`` uniform, the
    same numbers :func:`gumbel_noise` draws for ``(1, *shape)`` from that
    state), a tensor (an injected ``shape`` Gumbel slab, copied) or None
    (a free row: zeros in, finite noise out, no generator advanced).

    One ``rand`` per drawing row, then one clamp/log/neg chain over the
    whole slab: drawing rows + 5 launches, element for element the solo
    slab."""
    slab = (torch.empty if all(isinstance(s, torch.Generator)
                               for s in sources) else torch.zeros)(
        (len(sources), *shape), dtype=torch.float32, device=device)
    for i, s in enumerate(sources):
        if isinstance(s, torch.Generator):
            torch.rand(shape, generator=s, out=slab[i])
    slab.clamp_(min=torch.finfo(torch.float32).tiny)
    slab.log_().neg_().log_().neg_()
    for i, s in enumerate(sources):
        if isinstance(s, torch.Tensor):
            slab[i].copy_(s.reshape(shape))
    return slab


def row_uniform(sources, n: int, device=None) -> torch.Tensor:
    """(B, n) f32 uniforms on [0, 1), row i from ``sources[i]`` as in
    :func:`row_gumbel_noise` (an injected row is an (n,) uniform); the
    same numbers a solo ``torch.rand((1, n))`` draws from that state."""
    u = (torch.empty if all(isinstance(s, torch.Generator) for s in sources)
         else torch.zeros)((len(sources), n), dtype=torch.float32,
                           device=device)
    for i, s in enumerate(sources):
        if isinstance(s, torch.Generator):
            torch.rand((n,), generator=s, out=u[i])
        elif isinstance(s, torch.Tensor):
            u[i].copy_(s.reshape(n))
    return u


def _gumbel(generator, shape, x0_mode: str, device) -> torch.Tensor | None:
    if x0_mode == "argmax":
        return None
    if x0_mode != "sample":
        raise ValueError(f"unknown x0_mode {x0_mode!r}")
    return gumbel_noise(generator, shape, device)


def backend(device) -> str:
    """The decode backend that tensors on ``device`` take: the CUDA
    kernels on a card, their plain versions on the CPU."""
    return "kernel" if torch.device(device).type == "cuda" else "reference"


def _count(op: str, logits: torch.Tensor) -> None:
    if obs.enabled():
        obs.counter("decode.backend_calls",
                    "decode calls by op and backend, once per call (the "
                    "JAX package counts once per compiled program)").inc(
            op=op, backend=backend(logits.device))


@functools.lru_cache(maxsize=32)
def _logit_mask(noise, device: torch.device) -> torch.Tensor:
    return noise.logit_mask(torch.float32, device)


def fused_update(logits: torch.Tensor, x: torch.Tensor, tau: torch.Tensor,
                 t: int, noise, cfg, *, version: int = 1,
                 generator: torch.Generator | None = None,
                 gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Decode x0_hat and apply the eq. (9) token update in one pass.

    ``x_{t-1} = where(tau == t, x0_hat, x_t)`` (``tau >= t`` for
    Algorithm 3 / version=2).  Returns the updated tokens (B, N) int32.

    ``gumbel`` overrides the noise drawn from ``generator`` (sample mode
    only) — the tests replay the JAX package's draws through it.
    """
    _count("fused_update", logits)
    mask = _logit_mask(noise, logits.device)
    if gumbel is None:
        gumbel = _gumbel(generator, logits.shape, cfg.x0_mode, logits.device)
    return _ops.dndm_update(logits, x, tau, int(t), mask=mask,
                            gumbel=gumbel, version=version,
                            temperature=cfg.temperature)


def decode_tokens(logits: torch.Tensor, noise, cfg, *,
                  generator: torch.Generator | None = None,
                  gumbel: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick x0_hat from logits; returns (tokens (B,N) int32, scores (B,N)
    f32).

    Scores are the per-token log-probabilities of the chosen token under
    the noise-free adjusted logits — the quantity DNDM-K, RDM-k,
    Mask-Predict and DNDM-C rank on (paper App. E).  ``gumbel``
    overrides the noise drawn from ``generator`` (sample mode only), as in
    :func:`fused_update`.
    """
    _count("decode_tokens", logits)
    mask = _logit_mask(noise, logits.device)
    if gumbel is None:
        gumbel = _gumbel(generator, logits.shape, cfg.x0_mode, logits.device)
    return _sops.decode_scores(logits, mask=mask, gumbel=gumbel,
                               temperature=cfg.temperature)
