"""Tokenizers: character-level (text8-style, 27 symbols) and byte-level
(enwik8-style, 256 symbols), plus special ids.

The absorbing [MASK] token is appended *after* the base vocabulary, so
``vocab_size = base + 1`` for absorbing-diffusion models and ``base`` for
multinomial ones.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CharTokenizer:
    """Lower-case letters + space (text8's 27 categories)."""

    alphabet: str = "abcdefghijklmnopqrstuvwxyz "

    @property
    def base_size(self) -> int:
        return len(self.alphabet)

    def encode(self, text: str) -> np.ndarray:
        lut = {c: i for i, c in enumerate(self.alphabet)}
        return np.asarray([lut.get(c, self.base_size - 1) for c in text],
                          np.int32)

    def decode(self, ids) -> str:
        return "".join(self.alphabet[int(i)] if 0 <= int(i) <
                       self.base_size else "?" for i in np.asarray(ids))


@dataclasses.dataclass(frozen=True)
class ByteTokenizer:
    """Raw bytes (enwik8's 256 categories)."""

    @property
    def base_size(self) -> int:
        return 256

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8", "replace"),
                             np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        return bytes(int(i) & 0xFF for i in np.asarray(ids)).decode(
            "utf-8", "replace")
