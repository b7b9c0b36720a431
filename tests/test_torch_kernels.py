"""The port's kernel modules on the CPU vs the JAX package's Pallas kernels
in interpret mode.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py`` and tests/test_torch_cuda.py.  Inputs are numpy from a
fixed seed, handed to both frameworks.

Tolerances: ``dndm_update`` and ``decode_scores`` tokens are bitwise
(same IEEE op order on both sides).  ``decode_scores`` scores are
allclose at 2e-6 against the JAX oracle and against the interpreted
kernel when K fits one 64-wide vocab tile (the two frameworks' exp, log
and sum order differ by ulps; the largest difference seen is 9.5e-7), and
at 2e-5 when K spans several tiles (the online logsumexp; the JAX
suite's own bar in tests/test_kernels.py).  Attention is allclose at
3e-5 in f32 (the flash kernel sums in tiles, the plain version in one
softmax) and at 2e-2 in bf16, the bar of tests/test_kernels.py (one bf16
rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_scores import ops as j_scores
from repro.kernels.decode_scores import ref as j_scores_ref
from repro.kernels.dndm_update import ops as j_dndm
from repro.kernels.flash_attention import ops as j_flash

from repro_torch.kernels.decode_scores import ops as t_scores
from repro_torch.kernels.decode_scores import ref as t_scores_ref
from repro_torch.kernels.dndm_update import ops as t_dndm
from repro_torch.kernels.dndm_update import ref as t_dndm_ref
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention import ref as t_flash_ref

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _dndm_inputs(B, N, K, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, N, K)).astype(np.float32)
    x = rng.integers(0, K, (B, N)).astype(np.int32)
    tau = rng.integers(1, 20, (B, N)).astype(np.int32)
    gumbel = rng.gumbel(size=(B, N, K)).astype(np.float32)
    mask = np.where(np.arange(K) == K - 1, -1e9, 0.0).astype(np.float32)
    return logits, x, tau, gumbel, mask


@pytest.mark.parametrize("B,N,K", [(1, 16, 32), (3, 40, 100),
                                   (2, 64, 257), (1, 7, 1000)])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["argmax", "gumbel_temp0.7"])
def test_dndm_update_matches_jax_interpret(B, N, K, version, dtype, mode):
    logits, x, tau, gumbel, mask = _dndm_inputs(B, N, K, seed=B * N + K)
    jdt, tdt = DT[dtype]
    temp = 1.0 if mode == "argmax" else 0.7
    g = None if mode == "argmax" else gumbel
    # bf16: both frameworks round the same f32 values to nearest-even
    jl = jnp.asarray(logits).astype(jdt)
    tl = torch.from_numpy(logits).to(tdt)
    for t in (1, 5, 19):
        want = j_dndm.dndm_update(
            jl, jnp.asarray(x), jnp.asarray(tau), t, mask=jnp.asarray(mask),
            gumbel=None if g is None else jnp.asarray(g), version=version,
            temperature=temp, block_n=16, block_v=64, interpret=True)
        got = t_dndm.dndm_update(
            tl, torch.from_numpy(x), torch.from_numpy(tau), t,
            mask=torch.from_numpy(mask),
            gumbel=None if g is None else torch.from_numpy(g),
            version=version, temperature=temp)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dndm_update_ties_go_to_the_lowest_index():
    logits = torch.zeros((2, 3, 40))
    logits[:, :, 7] = 1.0
    logits[:, :, 33] = 1.0
    logits[1, 2] = 0.0                        # all equal -> index 0
    x = torch.full((2, 3), 5, dtype=torch.int32)
    tau = torch.ones((2, 3), dtype=torch.int32)
    out = t_dndm.dndm_update(logits, x, tau, 1)
    assert out[0].tolist() == [7, 7, 7]
    assert out[1].tolist() == [7, 7, 0]
    # versions: only tau == t (v1) / tau >= t (v2) positions change
    tau = torch.tensor([[1, 2, 3]] * 2, dtype=torch.int32)
    assert t_dndm.dndm_update(logits, x, tau, 2, version=1)[0].tolist() \
        == [5, 7, 5]
    assert t_dndm.dndm_update(logits, x, tau, 2, version=2)[0].tolist() \
        == [5, 7, 7]


# tests/test_kernels.py::test_decode_scores_sweep's shapes, plus the
# paper's K = 28 (fewer vocab entries than warp lanes) and K = 33
SCORE_SHAPES = [(1, 16, 32), (3, 40, 100), (2, 64, 257), (1, 7, 1000),
                (2, 24, 28), (2, 24, 33)]


@pytest.mark.parametrize("B,N,K", SCORE_SHAPES)
@pytest.mark.parametrize("dtype,gumbel", [("f32", False), ("f32", True),
                                          ("bf16", True)])
def test_decode_scores_matches_jax(B, N, K, dtype, gumbel):
    logits, _, _, noise, mask = _dndm_inputs(B, N, K, seed=B * N + K)
    jdt, tdt = DT[dtype]
    g = noise if gumbel else None
    jl = jnp.asarray(logits).astype(jdt)
    jkw = dict(mask=jnp.asarray(mask), temperature=0.7,
               gumbel=None if g is None else jnp.asarray(g))
    ref_tok, ref_score = j_scores_ref.decode_scores_ref(jl, **jkw)
    int_tok, int_score = j_scores.decode_scores(jl, block_n=16, block_v=64,
                                                interpret=True, **jkw)
    tok, score = t_scores.decode_scores(
        torch.from_numpy(logits).to(tdt), mask=torch.from_numpy(mask),
        gumbel=None if g is None else torch.from_numpy(g), temperature=0.7)
    assert tok.dtype == torch.int32 and score.dtype == torch.float32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(int_tok))
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score),
                               atol=2e-6, rtol=2e-6)
    tol = 2e-6 if K <= 64 else 2e-5
    np.testing.assert_allclose(score.numpy(), np.asarray(int_score),
                               atol=tol, rtol=tol)
    assert (score.numpy() <= 1e-6).all()            # log-probabilities
    assert not (tok.numpy() == K - 1).any()         # masked id never chosen


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_decode_scores_tokens_are_dndm_update_tokens(temperature):
    """The two decode ops select with the same adjusted logits, so where
    eq. (9) reveals every token (version 2 at t = 1) their tokens agree;
    the score is the chosen token's log-softmax."""
    logits, x, _, noise, mask = _dndm_inputs(3, 20, 28, seed=5)
    args = [torch.from_numpy(a) for a in (logits, mask, noise)]
    tau = torch.ones((3, 20), dtype=torch.int32)
    for gum in (None, args[2]):
        tok, score = t_scores.decode_scores(args[0], mask=args[1], gumbel=gum,
                                            temperature=temperature)
        fused = t_dndm.dndm_update(args[0], torch.from_numpy(x), tau, 1,
                                   mask=args[1], gumbel=gum, version=2,
                                   temperature=temperature)
        assert torch.equal(tok, fused)
        a = args[0] / temperature + args[1]
        want = torch.log_softmax(a, -1).gather(-1, tok.long()[..., None])
        torch.testing.assert_close(score, want[..., 0], atol=1e-6, rtol=1e-6)


def test_decode_scores_cpu_path_counts_nothing():
    t_scores.decode_scores.launches = 0
    logits, _, _, noise, mask = _dndm_inputs(2, 8, 28, seed=1)
    kw = dict(mask=torch.from_numpy(mask), gumbel=torch.from_numpy(noise),
              temperature=0.7)
    got = t_scores.decode_scores(torch.from_numpy(logits), **kw)
    want = t_scores_ref.decode_scores(torch.from_numpy(logits), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert t_scores.decode_scores.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "mask", "gumbel", "layout",
                                 "rank"])
def test_decode_scores_rejects_what_the_kernel_cannot_take(bad):
    logits = torch.randn(2, 4, 10)
    kw = {}
    if bad == "dtype":
        logits = logits.half()
    elif bad == "mask":
        kw["mask"] = torch.zeros(11)
    elif bad == "gumbel":
        kw["gumbel"] = torch.zeros(2, 4, 10, dtype=torch.float64)
    elif bad == "layout":
        logits = torch.randn(2, 10, 4).transpose(1, 2)
    else:
        logits = torch.randn(8, 10)
    with pytest.raises((ValueError, TypeError)):
        t_scores.decode_scores(logits, **kw)


def _jax_bias(B, S, causal, window):
    pos = np.arange(S)
    diff = pos[:, None] - pos[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= (diff < window) if causal else (np.abs(diff) < window)
    return np.broadcast_to(np.where(ok, 0.0, -1e9).astype(np.float32),
                           (B, S, S))


FLASH_CASES = [
    # (B, S, H, KV, hd, causal, window): tests/test_kernels.py's sweep ...
    (1, 32, 2, 2, 16, True, 0), (1, 32, 2, 2, 16, False, 0),
    (2, 64, 4, 4, 32, True, 0), (2, 64, 4, 4, 32, False, 0),
    (1, 128, 2, 2, 64, True, 0), (1, 128, 2, 2, 64, False, 0),
    (2, 48, 3, 3, 32, True, 0), (2, 48, 3, 3, 32, False, 0),
    # ... plus ragged S, grouped-query heads and sliding windows
    (2, 37, 2, 2, 16, False, 0), (2, 37, 4, 2, 16, True, 0),
    (2, 40, 4, 2, 32, True, 8), (1, 40, 4, 1, 32, False, 8),
    # zamba2-2.7b's head dim (2560 / 32 heads)
    (2, 40, 4, 4, 80, False, 0),
]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_jax_interpret(B, S, H, KV, hd, causal,
                                               window, dtype):
    rng = np.random.default_rng(S * hd + H)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    jdt, tdt = DT[dtype]
    rep = H // KV        # the JAX kernel takes kv heads already repeated
    want = j_flash.flash_attention(
        jnp.asarray(q).astype(jdt),
        jnp.asarray(np.repeat(k, rep, axis=2)).astype(jdt),
        jnp.asarray(np.repeat(v, rep, axis=2)).astype(jdt),
        jnp.asarray(_jax_bias(B, S, causal, window)),
        block_q=16, block_k=16, interpret=True)
    got = t_flash.flash_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (B, S, H, hd)
    tol = 3e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    t_dndm.dndm_update.launches = 0
    t_flash.flash_attention.launches = 0
    logits, x, tau, gumbel, mask = _dndm_inputs(2, 8, 28, seed=0)
    args = (torch.from_numpy(logits), torch.from_numpy(x),
            torch.from_numpy(tau), 3)
    kw = dict(mask=torch.from_numpy(mask), gumbel=torch.from_numpy(gumbel),
              version=1, temperature=0.7)
    assert torch.equal(t_dndm.dndm_update(*args, **kw),
                       t_dndm_ref.dndm_update(*args, **kw))
    q = torch.randn(2, 24, 4, 16)
    kv = torch.randn(2, 24, 2, 16)
    assert torch.equal(t_flash.flash_attention(q, kv, kv, causal=True),
                       t_flash_ref.attention(q, kv, kv, causal=True))
    assert t_dndm.dndm_update.launches == 0
    assert t_flash.flash_attention.launches == 0


def test_flash_attention_takes_strided_views():
    """The kernel reads (B, S, heads, hd) through strides; the wrapper
    accepts any view whose head-dim axis is contiguous."""
    qkv = torch.randn(2, 20, 3, 4, 32)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = t_flash.flash_attention(q, k, v)
    want = t_flash_ref.attention(q.contiguous(), k.contiguous(),
                                 v.contiguous())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "head_dim", "heads",
                                 "layout"])
def test_flash_attention_rejects_what_the_kernel_cannot_take(bad):
    q = torch.randn(1, 8, 4, 16)
    k = torch.randn(1, 8, 2, 16)
    v = torch.randn(1, 8, 2, 16)
    if bad == "dtype":
        q = q.double()
    elif bad == "shape":
        k = torch.randn(1, 9, 2, 16)
    elif bad == "head_dim":
        q, k, v = (torch.randn(1, 8, h, 24) for h in (4, 2, 2))
    elif bad == "heads":
        k, v = torch.randn(1, 8, 3, 16), torch.randn(1, 8, 3, 16)
    else:
        q = torch.randn(1, 8, 16, 4).transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        t_flash.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["dtype", "x_dtype", "mask", "gumbel",
                                 "layout", "version"])
def test_dndm_update_rejects_what_the_kernel_cannot_take(bad):
    logits = torch.randn(2, 4, 10)
    x = torch.zeros((2, 4), dtype=torch.int32)
    tau = torch.ones((2, 4), dtype=torch.int32)
    kw = {}
    if bad == "dtype":
        logits = logits.half()
    elif bad == "x_dtype":
        x = x.long()
    elif bad == "mask":
        kw["mask"] = torch.zeros(11)
    elif bad == "gumbel":
        kw["gumbel"] = torch.zeros(2, 4, 10, dtype=torch.float64)
    elif bad == "layout":
        logits = torch.randn(2, 10, 4).transpose(1, 2)
    else:
        kw["version"] = 3
    with pytest.raises((ValueError, TypeError)):
        t_dndm.dndm_update(logits, x, tau, 1, **kw)


def _c_entry_points() -> dict[str, int]:
    """name -> parameter count of every C entry point in csrc/*.cu,
    including those stamped out by a FLASH_ENTRY-style macro."""
    import re
    from repro_torch.kernels import build
    found = {}
    for src in build.sources():
        text = src.read_text().replace("\\\n", " ")
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            if name != "NAME":              # the macro's own template
                found[name] = len(params.split(","))
        for macro, params in re.findall(
                r'#define (\w+)\(NAME, T\)\s+extern "C" int NAME\(([^)]*)\)',
                text):
            for name in re.findall(rf"^{macro}\((\w+),", text, re.M):
                found[name] = len(params.split(","))
    return found


def test_ctypes_bindings_match_the_cuda_sources():
    """The argtypes the wrappers bind must name every C entry point and
    give each its exact parameter count: a mismatch would only show on
    the card, as a corrupted launch."""
    from repro_torch.kernels import build
    entries = _c_entry_points()
    assert set(entries) == set(build.ARGTYPES)
    for name, n in entries.items():
        assert len(build.ARGTYPES[name]) == n, name
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
