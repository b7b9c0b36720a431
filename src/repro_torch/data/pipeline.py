"""Input pipeline: deterministic, seeded, shardable batch streams.

``DataPipeline`` yields numpy batches; the trainer moves them onto its
device.  Unconditional batches are {"x0": (B, N)}; conditional ones add
{"src": (B, P)} — the source prefix that stays clean during diffusion.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.data.synthetic import MarkovLanguage, TranslationTask


@dataclasses.dataclass
class DataConfig:
    task: str = "unconditional"      # unconditional | translation
    vocab: int = 27                  # base vocab (without [MASK])
    seq_len: int = 64
    src_len: int = 64                # translation source length
    batch: int = 32
    seed: int = 0
    mt_reverse: bool = False         # harder MT: also reverse each word


class DataPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.task == "translation":
            self.task = TranslationTask(cfg.vocab, seed=cfg.seed,
                                        reverse_words=cfg.mt_reverse)
        else:
            self.lang = MarkovLanguage(cfg.vocab, seed=cfg.seed)

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.cfg.seed + 1)
        while True:
            yield self.batch(rng)

    def batch(self, rng: np.random.Generator) -> dict:
        c = self.cfg
        if c.task == "translation":
            src, tgt = self.task.sample_pairs(rng, c.batch, c.seq_len)
            return {"x0": tgt, "src": src}
        return {"x0": self.lang.sample_batch(rng, c.batch, c.seq_len)}

    def eval_batches(self, n: int, seed: int = 12345) -> list[dict]:
        """Fixed held-out batches (deterministic across runs)."""
        rng = np.random.default_rng(seed)
        return [self.batch(rng) for _ in range(n)]
