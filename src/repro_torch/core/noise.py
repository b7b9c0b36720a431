"""Noise distributions ``q_noise`` for discrete diffusion.

  * multinomial diffusion — ``q_noise`` uniform over the vocabulary
    (Hoogeboom et al. 2021b);
  * absorbing diffusion — ``q_noise`` is a point mass on a [MASK] token
    (Austin et al. 2021).

Tokens are int32 ids.  Random draws take an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class NoiseDist:
    """A categorical noise distribution over ``vocab_size`` tokens."""

    kind: str            # "multinomial" | "absorbing"
    vocab_size: int      # includes the mask token for absorbing diffusion
    mask_id: int = -1    # only used by absorbing

    def sample(self, generator: torch.Generator | None,
               shape: tuple[int, ...], device=None) -> torch.Tensor:
        """Draw noise token ids ``w ~ q_noise`` (int32).  Absorbing noise
        draws nothing from ``generator``."""
        if self.kind == "multinomial":
            if not isinstance(generator, torch.Generator):
                raise TypeError("multinomial noise draws from an explicit "
                                "torch.Generator")
            return torch.randint(0, self.vocab_size, shape,
                                 generator=generator, device=device,
                                 dtype=torch.int32)
        return torch.full(shape, self.mask_id, dtype=torch.int32,
                          device=device)

    def probs(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The row vector ``q_noise`` over the vocabulary: uniform for
        multinomial, one-hot at ``mask_id`` for absorbing."""
        if self.kind == "multinomial":
            return torch.full((self.vocab_size,), 1.0 / self.vocab_size,
                              dtype=dtype, device=device)
        p = torch.zeros((self.vocab_size,), dtype=dtype, device=device)
        p[self.mask_id] = 1
        return p

    @property
    def pad_id(self) -> int:
        """Token id used to left-pad short conditioning prefixes in a
        mixed-length batch: [MASK] for absorbing diffusion (the only id
        that does not condition the row on spurious content), 0 for
        multinomial, which has no reserved id."""
        if self.kind == "absorbing":
            return self.mask_id
        return 0

    def logit_mask(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """Additive mask that forbids predicting the noise-only token:
        -1e9 (not -inf) at [MASK] for absorbing diffusion, zeros for
        multinomial."""
        m = torch.zeros((self.vocab_size,), dtype=dtype, device=device)
        if self.kind == "absorbing":
            m[self.mask_id] = -1e9
        return m


def multinomial(vocab_size: int) -> NoiseDist:
    return NoiseDist(kind="multinomial", vocab_size=vocab_size)


def absorbing(vocab_size: int, mask_id: int | None = None) -> NoiseDist:
    """Absorbing noise; by convention [MASK] is the last id unless given."""
    if mask_id is None:
        mask_id = vocab_size - 1
    if not 0 <= mask_id < vocab_size:
        raise ValueError(f"mask_id {mask_id} outside vocab {vocab_size}")
    return NoiseDist(kind="absorbing", vocab_size=vocab_size, mask_id=mask_id)


def get(kind: str, vocab_size: int, mask_id: int | None = None) -> NoiseDist:
    if kind == "multinomial":
        return multinomial(vocab_size)
    if kind == "absorbing":
        return absorbing(vocab_size, mask_id)
    raise KeyError(f"unknown noise kind {kind!r}")
