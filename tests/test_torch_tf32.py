"""Why the tensor-core kernels split every f32 operand in three TF32
products (3xTF32), held on the CPU.

``flash_attention.cu`` and ``ssd_scan.cu`` run their products as
mma.sync TF32 with f32 accumulation, ``dense_gemm.cu`` as wgmma TF32.  A
TF32 operand keeps 10 of f32's 23 mantissa bits.  This file emulates the
kernels' arithmetic in numpy: operands rounded to TF32 as
``tc::tf32_rna`` in ``csrc/tf32.cuh`` rounds them (to nearest, ties away
from zero, by integer operations on the bits), products of TF32 values
(exact in f32) summed in f32.  It holds:

* the 3xTF32 split (big = tf32(a), small = a - big cut to TF32 by the
  tensor cores, which read an operand's top 19 bits; a b ~ small_a big_b
  + big_a small_b + big_a big_b) meets the kernels' f32 bars against
  the plain f32 versions: attention at the text8 and zamba2 head dims
  within atol/rtol 1e-4 (chip_smoke.py, tests/test_torch_cuda.py), the SSD
  chunk algorithm at the zamba2 shape within 3e-5 (tests/test_torch_cuda.py),
  the dense products at the served depths K within f32's own error of
  the exact product, where the tensor cores' sums, which round toward
  zero, join an f32 total every 64 of K (``mm_wgmma``); carried through
  all of K they miss it;
* one TF32 pass does not meet them, which is why the kernels take three.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.ssd_scan import ref as ssd_ref

ATTN_TOL = 1e-4
SSD_TOL = 3e-5


def tf32(a: np.ndarray) -> np.ndarray:
    """f32 -> the nearest TF32 value, ties away from zero (cvt.rna)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def truncate(a: np.ndarray) -> np.ndarray:
    """f32 -> its top 19 bits, the TF32 value the tensor cores read."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def mm(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a @ b as the kernels compute it: 3 passes (the split, small
    products first) or 1 (plain TF32), f32 accumulation."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    a_big, b_big = tf32(a), tf32(b)
    if passes == 1:
        return np.matmul(a_big, b_big)
    a_small, b_small = truncate(a - a_big), truncate(b - b_big)
    return (np.matmul(a_small, b_big) + np.matmul(a_big, b_small)
            + np.matmul(a_big, b_big))


def test_tf32_rounding_is_cvt_rna():
    x = np.array([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -10 + 2.0 ** -11,
                  -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 3.0e-39], np.float32)
    want = np.array([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -9,
                     -(1 + 2.0 ** -10), 1.0, 3.0e-39], np.float32)
    got = tf32(x)
    np.testing.assert_array_equal(got[:5], want[:5])
    assert (got.view(np.uint32) & 0x1FFF == 0).all()       # 10 mantissa bits
    # big + small, as the tensor cores read them, holds 21 of the 24
    # significant bits
    a = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    big = tf32(a)
    err = np.abs(a - big - truncate(a - big)) / np.abs(a)
    assert err.max() < 2.0 ** -21


def _attention(q, k, v, passes):
    """softmax(q k^T / sqrt(hd)) v with both products emulated; q, k, v
    (B, S, H, hd) numpy f32."""
    hd = q.shape[-1]
    qh, kh, vh = (np.transpose(a, (0, 2, 1, 3)) for a in (q, k, v))
    s = mm(qh, np.swapaxes(kh, -1, -2), passes) * np.float32(1 / hd ** 0.5)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.transpose(mm(p, vh, passes), (0, 2, 1, 3))


@pytest.mark.parametrize("hd,H", [(64, 12), (80, 32)])
def test_attention_needs_three_tf32_passes(hd, H):
    """text8's head dim 64 and zamba2's 80, S = 256: 3xTF32 within the f32
    bar of the plain version, one TF32 pass not."""
    rng = np.random.default_rng(hd)
    q, k, v = (rng.standard_normal((1, 256, H, hd)).astype(np.float32)
               for _ in range(3))
    want = flash_ref.attention(*map(torch.from_numpy, (q, k, v))).numpy()
    three = _attention(q, k, v, 3)
    one = _attention(q, k, v, 1)
    np.testing.assert_allclose(three, want, atol=ATTN_TOL, rtol=ATTN_TOL)
    assert not np.allclose(one, want, atol=ATTN_TOL, rtol=ATTN_TOL)
    assert np.abs(one - want).max() > 2 * ATTN_TOL


def _ssd(x, dtv, A, Bm, Cm, L, passes):
    """The kernel's chunk algorithm (ssd_scan.cu) with every product
    emulated: C B^T per chunk; per head M x, the chunk states (B^T w) x,
    the carry and (e^cs C) S.  Shapes as ref.ssd_chunked, S a multiple
    of L."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // L
    xc = x.reshape(Bb, nc, L, H, P).transpose(0, 1, 3, 2, 4)  # (B,c,H,L,P)
    dtc = dtv.reshape(Bb, nc, L, H).transpose(0, 1, 3, 2)     # (B,c,H,L)
    Bc = Bm.reshape(Bb, nc, L, N)
    Cc = Cm.reshape(Bb, nc, L, N)
    cs = np.cumsum(dtc * A[None, None, :, None], axis=-1, dtype=np.float32)
    cb = mm(Cc, np.swapaxes(Bc, -1, -2), passes)[:, :, None]  # (B,c,1,L,L)
    tri = np.tril(np.ones((L, L), bool))
    gap = np.where(tri, cs[..., :, None] - cs[..., None, :], 0)
    M = np.where(tri, cb * np.exp(gap) * dtc[..., None, :], 0)
    y = mm(M, xc, passes)                                     # (B,c,H,L,P)
    w = np.exp(cs[..., -1:] - cs) * dtc                       # (B,c,H,L)
    bw = np.swapaxes(Bc[:, :, None] * w[..., None], -1, -2)   # (B,c,H,N,L)
    s_c = mm(bw, xc, passes)                                  # (B,c,H,N,P)
    state = np.zeros((Bb, H, N, P), np.float32)
    for c in range(1, nc):
        state = state * np.exp(cs[:, c - 1, :, -1])[..., None, None] \
            + s_c[:, c - 1]
        ce = Cc[:, c, None] * np.exp(cs[:, c])[..., None]      # (B,H,L,N)
        y[:, c] += mm(ce, state, passes)
    return y.transpose(0, 1, 3, 2, 4).reshape(Bb, S, H, P)


def test_ssd_needs_three_tf32_passes():
    """The zamba2 shape (H 80, S 256, P 64, N 64, chunk 128), inputs in the
    laws of the JAX sweep: 3xTF32 within 3e-5 of the plain f32 chunked
    version, one TF32 pass not."""
    H, S, P, N, L = 80, 256, 64, 64, 128
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((1, S, H, P)) * 0.5).astype(np.float32)
    dtv = np.log1p(np.exp(rng.standard_normal((1, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((1, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((1, S, N)) * 0.3).astype(np.float32)
    want, _ = ssd_ref.ssd_chunked(*map(torch.from_numpy,
                                       (x, dtv, A, Bm, Cm)), L)
    want = want.numpy()
    three = _ssd(x, dtv, A, Bm, Cm, L, 3)
    one = _ssd(x, dtv, A, Bm, Cm, L, 1)
    np.testing.assert_allclose(three, want, atol=SSD_TOL, rtol=SSD_TOL)
    assert not np.allclose(one, want, atol=SSD_TOL, rtol=SSD_TOL)
    assert np.abs(one - want).max() > 10 * SSD_TOL


# f32-class error of a dense product at the served depths, for unit-scale
# activations and weights of scale 1 / sqrt(K) (dense_init): the plain f32
# product itself is 1.3e-6 to 1.8e-6 off the exact one at these K
# (measured on these inputs), and the card tests hold the kernel to the
# plain f32 product at 1e-4 (tests/test_torch_cuda.py)
DENSE_F32_CLASS = 1e-5
DENSE_TOL = 1e-4


@pytest.mark.parametrize("K", [768, 3072, 2560, 5120])
def test_dense_products_need_three_tf32_passes(K):
    """dense_gemm.cu's arithmetic at text8's depths (768, 3072) and
    zamba2's (2560, 5120), against the float64 product: 3xTF32 (the
    split, small products first, f32 sums) within f32-class error, as
    close as the plain f32 product; one TF32 pass some 1e-3 off, past the
    card tests' bar and the benchmark's logit limits (2e-4, 5e-4)."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((64, K)).astype(np.float32)
    w = (rng.standard_normal((K, 128)) / np.sqrt(K)).astype(np.float32)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    plain = np.abs(a @ w - exact).max()
    three = np.abs(mm(a, w, 3) - exact).max()
    one = np.abs(mm(a, w, 1) - exact).max()
    assert three < DENSE_F32_CLASS and three < 2 * plain
    assert one > 5 * DENSE_TOL and one > 100 * three


def rz32(v: np.ndarray) -> np.ndarray:
    """float64 -> f32 rounded toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def mm_wgmma(a: np.ndarray, b: np.ndarray, block: int | None) -> np.ndarray:
    """a @ b as dense_gemm.cu's tensor cores sum it: per 8 of K three
    products (small_a big_b, big_a small_b, big_a big_b), each summed
    exactly and added into an f32 accumulator rounding toward zero; every
    ``block`` of K the accumulator joins an f32 total rounded to nearest
    and starts afresh (None: one accumulator through all of K)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = truncate(a - a_big), truncate(b - b_big)
    pairs = [(a_small, b_big), (a_big, b_small), (a_big, b_big)]
    d = np.zeros((a.shape[0], b.shape[1]), np.float32)
    total = np.zeros_like(d)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        for x, y in pairs:
            d = rz32(d + x[:, k].astype(np.float64) @ y[k].astype(np.float64))
        if block and (k0 + 8) % block == 0:
            total, d = total + d, np.zeros_like(d)
    return total + d


@pytest.mark.parametrize("K", [768, 2560, 5120, 10240])
def test_dense_products_need_the_promotion(K):
    """The tensor cores' accumulator rounds toward zero, so a sum carried
    through all of K drifts: 3e-5 off the float64 product at K = 768, 4e-4
    at 10240 (the kernel read 3.1e-4 there on an H100 before it promoted).
    Adding each 64-deep block's sum to an f32 total, as the kernel does,
    keeps 3xTF32 within f32-class error at every served depth, within 3x
    the plain f32 product's."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((64, K)).astype(np.float32)
    w = (rng.standard_normal((K, 64)) / np.sqrt(K)).astype(np.float32)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    plain = np.abs(a @ w - exact).max()
    promoted = np.abs(mm_wgmma(a, w, 64) - exact).max()
    carried = np.abs(mm_wgmma(a, w, None) - exact).max()
    assert promoted < DENSE_F32_CLASS and promoted < 3 * plain
    assert carried > DENSE_F32_CLASS and carried > 10 * promoted
