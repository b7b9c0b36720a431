"""The block regime of the decode kernels (``csrc/row_select.cuh``),
emulated in float32 on the CPU.

Above ``kBlockMinK`` a (b, n) row is reduced by one block of 128 threads:
thread j takes the row's element j if it lies before the logits row's
first 16-byte boundary (the head), then vectors j, j + 128, j + 256, ...
of 4 f32 (or 8 bf16) values, then element j of the tail; each thread keeps
a first argmax (a strict >) and an online logsumexp with one exp per
element; then the 32 lanes of each warp merge by shuffles (offsets 16, 8,
4, 2, 1) and warp 0 merges the 4 warps' partials the same way.  This file
replays that order in torch float32 (each operation rounded as the
kernel's IEEE ``__fmul_rn``/``__fadd_rn``; the CPU's exp and log differ
from CUDA's expf and logf by ulps) and holds:

* the tokens bitwise against the plain version (ties to the lowest index
  across the head, the vectors, the tail and the merge tree);
* the scores within 1e-5 (K3_TOL of chip_smoke.py) of the plain version's
  ``a[tok] - (m + log(sum(exp(a - m))))`` at K = 32000 and GPT-2's odd
  K = 50257, whose rows start at every phase of 16 bytes;
* the plain version against the JAX package's oracle at (1, 8, 32000).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_scores import ref as j_scores_ref

from repro_torch.kernels.decode_scores import ops as t_scores
from repro_torch.kernels.decode_scores import ref as t_scores_ref
from repro_torch.kernels.dndm_update.ref import adjust_logits

THREADS, WARP = 128, 32
TOL = 1e-5
NEG_INF = float("-inf")


def _thread_order(K: int, start: int, vec: int) -> torch.Tensor:
    """(THREADS, L) element indices in the order each thread visits them
    (-1 pads), for a row whose first element lies ``start`` elements past
    a 16-byte boundary."""
    head = min(K, (-start) % vec)
    nvec = (K - head) // vec
    tail = head + nvec * vec
    seqs = []
    for j in range(THREADS):
        s = [j] if j < head else []
        for v in range(j, nvec, THREADS):
            s.extend(range(head + v * vec, head + (v + 1) * vec))
        if tail + j < K:
            s.append(tail + j)
        seqs.append(s)
    L = max(len(s) for s in seqs)
    return torch.tensor([s + [-1] * (L - len(s)) for s in seqs])


def _merge(a, b):
    """Merge partial b into a, both dicts of (R, lanes) tensors: the
    selection lexicographic (value desc, index asc), the logsumexp
    partials skipping an empty side."""
    take = (b["best"] > a["best"]) | ((b["best"] == a["best"])
                                      & (b["idx"] < a["idx"]))
    out = {k: torch.where(take, b[k], a[k]) for k in ("best", "idx", "best_a")}
    mn = torch.maximum(a["m"], b["m"])
    with torch.no_grad():
        both = (a["m"] != NEG_INF) & (b["m"] != NEG_INF)
        ea = torch.exp(torch.where(both, a["m"] - mn, torch.zeros_like(mn)))
        eb = torch.exp(torch.where(both, b["m"] - mn, torch.zeros_like(mn)))
        s = a["s"] * ea + b["s"] * eb
    out["m"] = torch.where(b["m"] == NEG_INF, a["m"],
                           torch.where(a["m"] == NEG_INF, b["m"], mn))
    out["s"] = torch.where(b["m"] == NEG_INF, a["s"],
                           torch.where(a["m"] == NEG_INF, b["s"], s))
    return out


def _shfl_tree(p, lanes: int):
    """The shuffle tree over the last axis (``lanes`` = 32 per group):
    lane i merges lane i + off for off = 16, 8, 4, 2, 1 (a lane whose
    source is out of range gets its own value back, as __shfl_down_sync
    gives it).  Returns lane 0's partial of each group."""
    p = {k: v.reshape(*v.shape[:-1], -1, lanes) for k, v in p.items()}
    off = lanes // 2
    while off:
        src = {k: torch.cat([v[..., off:], v[..., lanes - off:]], -1)
               for k, v in p.items()}
        p = _merge(p, src)
        off //= 2
    return {k: v[..., 0] for k, v in p.items()}


def emulate_block_regime(logits, mask, gumbel, temperature, offset=0):
    """Tokens and scores of the block regime for each row of (B, N, K)
    ``logits``; ``offset`` is the logits' element offset from a 16-byte
    boundary."""
    B, N, K = logits.shape
    vec = 16 // logits.element_size()
    a = adjust_logits(logits, mask=mask, temperature=temperature).reshape(
        B * N, K)
    sel = a if gumbel is None else a + gumbel.reshape(B * N, K)
    toks, scores = [], []
    for r in range(B * N):
        order = _thread_order(K, offset + r * K, vec)
        valid = order >= 0
        av = torch.where(valid, a[r][order.clamp(min=0)],
                         torch.full_like(order, 0, dtype=torch.float32))
        sv = torch.where(valid, sel[r][order.clamp(min=0)], av)
        p = {"best": torch.full((THREADS,), NEG_INF),
             "idx": torch.zeros(THREADS, dtype=torch.long),
             "best_a": torch.full((THREADS,), NEG_INF),
             "m": torch.full((THREADS,), NEG_INF),
             "s": torch.zeros(THREADS)}
        for i in range(order.shape[1]):
            ok, x, y, k = valid[:, i], av[:, i], sv[:, i], order[:, i]
            up = ok & (y > p["best"])
            p["best"] = torch.where(up, y, p["best"])
            p["idx"] = torch.where(up, k, p["idx"])
            p["best_a"] = torch.where(up, x, p["best_a"])
            live = ok & (x != NEG_INF)
            new_max = live & (x > p["m"])
            d = torch.exp(torch.where(new_max, p["m"] - x, x - p["m"]))
            d = torch.where(live, d, torch.zeros_like(d))
            s_up = torch.where(new_max, p["s"] * d + 1.0, p["s"] + d)
            p["s"] = torch.where(live, s_up, p["s"])
            p["m"] = torch.where(new_max, x, p["m"])
        warps = _shfl_tree(p, WARP)                        # (4,)
        empty = {"best": torch.full((WARP - len(warps["m"]),), NEG_INF),
                 "idx": torch.zeros(WARP - len(warps["m"]), dtype=torch.long),
                 "best_a": torch.full((WARP - len(warps["m"]),), NEG_INF),
                 "m": torch.full((WARP - len(warps["m"]),), NEG_INF),
                 "s": torch.zeros(WARP - len(warps["m"]))}
        row = _shfl_tree({k: torch.cat([warps[k], empty[k]]) for k in warps},
                         WARP)
        toks.append(int(row["idx"]))
        scores.append(row["best_a"] - (row["m"] + torch.log(row["s"])))
    return (torch.tensor(toks, dtype=torch.int32).reshape(B, N),
            torch.stack(scores).reshape(B, N))


def _inputs(B, N, K, seed, dtype=torch.float32, gumbel=True):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(
        rng.standard_normal((B, N, K)).astype(np.float32)).to(dtype)
    mask = torch.zeros(K)
    mask[-1] = -1e9
    noise = (torch.from_numpy(rng.gumbel(size=(B, N, K)).astype(np.float32))
             if gumbel else None)
    return logits, mask, noise


@pytest.mark.parametrize("K,offset", [(32000, 0), (50257, 0), (32000, 1)])
@pytest.mark.parametrize("dtype,gumbel,temperature", [
    (torch.float32, True, 1.0), (torch.float32, False, 0.7),
    (torch.bfloat16, True, 0.7)])
def test_block_regime_order_matches_plain(K, offset, dtype, gumbel,
                                          temperature):
    logits, mask, noise = _inputs(1, 6, K, seed=K + offset, dtype=dtype,
                                  gumbel=gumbel)
    tok, score = emulate_block_regime(logits, mask, noise, temperature,
                                      offset=offset)
    ptok, pscore = t_scores_ref.decode_scores(logits, mask=mask, gumbel=noise,
                                              temperature=temperature)
    assert torch.equal(tok, ptok)
    torch.testing.assert_close(score, pscore, atol=TOL, rtol=TOL)


def test_block_regime_ties_go_to_the_lowest_index():
    """bf16 logits without noise tie often; an all-equal row answers 0; a
    maximum in the head (the first elements of an unaligned row) and one
    in the tail are found."""
    K = 50257
    logits, mask, _ = _inputs(1, 4, K, seed=3, dtype=torch.bfloat16,
                              gumbel=False)
    logits = (logits * 2).round()           # few distinct values: ties
    logits[0, 1] = 0.0                      # all equal -> 0
    logits[0, 2, 1] = 100.0                 # in row 2's head (start 2 K)
    logits[0, 3, K - 3] = 100.0             # in row 3's tail
    tok, score = emulate_block_regime(logits, mask, None, 1.0)
    ptok, pscore = t_scores_ref.decode_scores(logits, mask=mask)
    assert torch.equal(tok, ptok)
    assert tok[0, 1] == 0 and tok[0, 2] == 1 and tok[0, 3] == K - 3
    torch.testing.assert_close(score, pscore, atol=TOL, rtol=TOL)


def test_plain_version_matches_jax_oracle_at_32000():
    logits, mask, noise = _inputs(1, 8, 32000, seed=7)
    jtok, jscore = j_scores_ref.decode_scores_ref(
        jnp.asarray(logits.numpy()), mask=jnp.asarray(mask.numpy()),
        gumbel=jnp.asarray(noise.numpy()), temperature=0.7)
    tok, score = t_scores.decode_scores(logits, mask=mask, gumbel=noise,
                                        temperature=0.7)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), atol=TOL,
                               rtol=TOL)
