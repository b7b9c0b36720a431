"""Deterministic synthetic corpora (offline container: no downloads).

Two task families mirroring the paper's experiments:

* ``markov_language`` — unconditional generation (text8/enwik8 analog):
  a seeded order-2 Markov chain over the character alphabet whose
  transition table is itself sampled once from a Dirichlet, giving text
  with strong local statistics a model can learn and a held-out
  perplexity that is meaningful to compare across samplers.

* ``translation_pairs`` — conditional seq2seq (IWSLT/WMT analog): the
  "source" is Markov-language text; the "target" is a deterministic
  cipher + per-word reversal of the source.  Exact references exist, so
  BLEU against them behaves like the paper's Tables 2/3 quality axis.
"""
from __future__ import annotations

import numpy as np


class MarkovLanguage:
    """Order-1 character Markov chain with a seeded, SPARSE transition
    table (each state can reach only ``branching`` successors).

    Sparsity makes the language *learnable* rather than a pure
    |V|^order lookup-memorization task: a small denoiser reaches well
    below the entropy of uniform noise within a few hundred steps, which
    is what the quality benchmarks need on CPU.
    """

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        branching = min(branching, vocab)
        table = np.zeros((vocab, vocab), np.float64)
        for a in range(vocab):
            succ = rng.choice(vocab, size=branching, replace=False)
            w = rng.dirichlet(np.full(branching, 0.7))
            table[a, succ] = w
        self.table = table / table.sum(-1, keepdims=True)

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        return self.sample_batch(rng, 1, length)[0]

    def sample_batch(self, rng: np.random.Generator, batch: int,
                     length: int) -> np.ndarray:
        """Vectorized batch sampling via inverse-CDF on shared uniforms."""
        cdf = np.cumsum(self.table, axis=-1)
        a = rng.integers(self.vocab, size=batch)
        u = rng.random((length, batch))
        out = np.empty((batch, length), np.int32)
        for i in range(length):
            c = (cdf[a] < u[i][:, None]).sum(-1)
            out[:, i] = c
            a = c
        return out

    def log_likelihood(self, seq: np.ndarray) -> float:
        """Per-token log-likelihood under the true chain (quality oracle).

        Out-of-alphabet ids (e.g. a stray [MASK]) score as impossible
        transitions (p = 1e-12) rather than crashing.
        """
        seq = np.asarray(seq)
        if seq.ndim == 1:
            seq = seq[None]
        a = seq[:, :-1].reshape(-1)
        b = seq[:, 1:].reshape(-1)
        ok = (a < self.vocab) & (b < self.vocab) & (a >= 0) & (b >= 0)
        p = np.where(ok, self.table[np.minimum(a, self.vocab - 1),
                                    np.minimum(b, self.vocab - 1)], 0.0)
        return float(np.log(np.maximum(p, 1e-12)).mean())


def cipher_permutation(vocab: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(vocab).astype(np.int32)


def translate(src: np.ndarray, perm: np.ndarray, space_id: int,
              reverse_words: bool = False) -> np.ndarray:
    """Deterministic 'translation': cipher each token; optionally also
    reverse each word (harder positional task).  Spaces are word
    boundaries and map to themselves.
    """
    src = np.asarray(src)
    if not reverse_words:
        return perm[src]
    out = np.empty_like(src)
    if src.ndim == 2:
        for i, row in enumerate(src):
            out[i] = translate(row, perm, space_id, True)
        return out
    start = 0
    for i in range(len(src) + 1):
        if i == len(src) or src[i] == space_id:
            out[start:i] = perm[src[start:i]][::-1]
            if i < len(src):
                out[i] = space_id
            start = i + 1
    return out


class TranslationTask:
    """Paired (source, target) sentences with exact references."""

    def __init__(self, vocab: int, space_id: int | None = None,
                 seed: int = 0, reverse_words: bool = False):
        self.vocab = vocab
        self.space_id = vocab - 1 if space_id is None else space_id
        self.reverse_words = reverse_words
        self.lang = MarkovLanguage(vocab, seed=seed)
        # bijective cipher that pins the space (word boundaries preserved)
        self.perm = _fix_perm(cipher_permutation(vocab, seed=seed + 1),
                              self.space_id, vocab)

    def sample_pairs(self, rng: np.random.Generator, batch: int,
                     length: int) -> tuple[np.ndarray, np.ndarray]:
        src = self.lang.sample_batch(rng, batch, length)
        tgt = translate(src, self.perm, self.space_id, self.reverse_words)
        return src, tgt


def _fix_perm(perm: np.ndarray, pin: int, vocab: int) -> np.ndarray:
    """Repair a permutation so that perm[pin] == pin and it stays bijective."""
    perm = perm.copy()
    cur = int(np.where(perm == pin)[0][0])
    perm[cur], perm[pin] = perm[pin], pin
    assert len(set(perm.tolist())) == vocab
    return perm


def bleu(hyp: np.ndarray, ref: np.ndarray, max_n: int = 4) -> float:
    """Corpus BLEU on token ids (uniform n-gram weights, brevity penalty).

    hyp/ref: (B, N) arrays (equal length here, BP == 1, but kept general).
    """
    hyp = np.asarray(hyp)
    ref = np.asarray(ref)
    if hyp.ndim == 1:
        hyp, ref = hyp[None], ref[None]
    logs = []
    for n in range(1, max_n + 1):
        match, total = 0, 0
        for h, r in zip(hyp, ref):
            h_ngrams: dict = {}
            r_ngrams: dict = {}
            for i in range(len(h) - n + 1):
                g = tuple(h[i:i + n])
                h_ngrams[g] = h_ngrams.get(g, 0) + 1
            for i in range(len(r) - n + 1):
                g = tuple(r[i:i + n])
                r_ngrams[g] = r_ngrams.get(g, 0) + 1
            for g, c in h_ngrams.items():
                match += min(c, r_ngrams.get(g, 0))
            total += max(len(h) - n + 1, 0)
        logs.append(np.log(max(match, 1e-9) / max(total, 1)))
    hyp_len = sum(len(h) for h in hyp)
    ref_len = sum(len(r) for r in ref)
    bp = min(1.0, np.exp(1 - ref_len / max(hyp_len, 1)))
    return float(100.0 * bp * np.exp(np.mean(logs)))
