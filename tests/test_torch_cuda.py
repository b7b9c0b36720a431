"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (the card is
looked for inside the fixture, never at import).  On a machine with an
H100:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.dense_gemm import ops as k5_ops
from repro_torch.kernels.dense_gemm import ref as k5_ref
from repro_torch.kernels.decode_scores import ops as k3_ops
from repro_torch.kernels.decode_scores import ref as k3_ref
from repro_torch.kernels.dndm_update import ops as k1_ops
from repro_torch.kernels.dndm_update import ref as k1_ref
from repro_torch.kernels.flash_attention import ops as k2_ops
from repro_torch.kernels.flash_attention import ref as k2_ref
from repro_torch.kernels.ssd_scan import ops as k4_ops
from repro_torch.kernels.ssd_scan import ref as k4_ref
from repro_torch.models import layers

pytestmark = pytest.mark.cuda

# K from which the decode kernels give a row a block (row_select.cuh),
# and the decode shapes beyond the paths' K = 28: the zamba2 path's
# vocabulary, GPT-2's odd one (no row 16-byte aligned) and K on both
# sides of the regime threshold
BLOCK_MIN_K = int(re.search(r"constexpr int kBlockMinK = (\d+);",
                            (build.CSRC / "row_select.cuh").read_text())[1])
DECODE_WIDE = [(4, 256, 32000), (2, 16, 50257), (2, 64, BLOCK_MIN_K - 1),
               (2, 64, BLOCK_MIN_K), (2, 64, BLOCK_MIN_K + 1)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("B,N,K", [(1, 16, 32), (2, 64, 257), (8, 256, 28),
                                   *DECODE_WIDE])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dndm_update_kernel_is_bitwise_plain(gen, B, N, K, dtype):
    logits = torch.randn(B, N, K, generator=gen, device="cuda").to(dtype)
    x = torch.randint(0, K, (B, N), generator=gen, device="cuda",
                      dtype=torch.int32)
    tau = torch.randint(1, 20, (B, N), generator=gen, device="cuda",
                        dtype=torch.int32)
    u = torch.rand(B, N, K, generator=gen, device="cuda").clamp_(min=1e-30)
    gumbel = -torch.log(-torch.log(u))
    mask = torch.zeros(K, device="cuda")
    mask[-1] = -1e9
    before = k1_ops.dndm_update.launches
    for version in (1, 2):
        for temp in (1.0, 0.7):
            kw = dict(mask=mask, gumbel=gumbel, version=version,
                      temperature=temp)
            assert torch.equal(k1_ops.dndm_update(logits, x, tau, 5, **kw),
                               k1_ref.dndm_update(logits, x, tau, 5, **kw))
    assert k1_ops.dndm_update.launches == before + 4


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (8, 256, 12, 12, 64, False, 0), (8, 256, 12, 4, 64, True, 0),
    (2, 37, 2, 2, 16, False, 0), (2, 100, 4, 2, 128, False, 16),
    (4, 256, 32, 32, 80, False, 0), (2, 77, 4, 4, 80, False, 0),
    # the ranked path: 128 target tokens after a 48-64-token prefix
    (8, 184, 8, 8, 64, False, 0), (8, 179, 8, 8, 64, False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(gen, B, S, H, KV, hd, causal,
                                              window, dtype):
    q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dtype)
    got = k2_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = k2_ref.attention(q, k, v, causal=causal, window=window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# (B, L, H, KV, hd, pos, window): unwrapped (pos < L) and wrapped rings,
# windows, grouped-query attention, every head dim; then the kernel's
# chunk edges (ops.decode_chunk): L not a multiple of the chunk, chunks
# that the window masks whole, slots never written (pos < L) filling whole
# chunks; and groups G = H / KV of 1, 2, 4, 8 and 12 (two blocks per kv
# head)
DECODE_CASES = [(2, 4096, 32, 8, 128, 4095, 0), (2, 4096, 32, 32, 80, 4200, 0),
                (2, 4096, 12, 12, 64, 100, 0), (2, 16, 4, 2, 16, 40, 16),
                (3, 16, 8, 2, 128, 15, 0), (2, 48, 4, 4, 32, 70, 9),
                (1, 33, 2, 1, 80, 5, 0), (2, 300, 8, 4, 64, 1000, 64),
                (1, 4133, 8, 1, 64, 4132, 0), (2, 4096, 16, 2, 64, 5000, 300),
                (2, 4096, 8, 4, 128, 1000, 0), (2, 2048, 8, 8, 64, 2047, 0),
                (2, 2048, 8, 4, 32, 2047, 0), (2, 2048, 16, 4, 16, 2047, 0),
                (2, 2048, 32, 4, 64, 2047, 0), (1, 1000, 24, 2, 128, 999, 0)]


@pytest.mark.parametrize("B,L,H,KV,hd,pos,window", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(gen, B, L, H, KV, hd, pos, window,
                                           dtype):
    q = torch.randn(B, 1, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, L, KV, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, L, KV, hd, generator=gen, device="cuda").to(dtype)
    before = k2_ops.flash_decode.launches
    got = k2_ops.flash_decode(q, k, v, pos=pos, window=window)
    want = k2_ref.decode_attention(q, k, v, pos, window)
    assert k2_ops.flash_decode.launches == before + 1
    # bf16: one rounding of the output, measured against the output's own
    # size (a 4096-slot ring's outputs are about 0.03)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    atol = (tol if dtype == torch.float32
            else tol * min(1.0, float(want.float().abs().max())))
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=tol)


# tinyllama-1.1b's per-layer decode shapes (chip_smoke.py phase 8g):
# decode_32k at 16 rows, long_500k
DECODE_LONG = [(16, 32768, 32, 4, 64), (1, 524288, 32, 4, 64)]


@pytest.mark.parametrize("B,L,H,KV,hd", DECODE_LONG)
def test_flash_decode_kernel_matches_plain_on_long_caches(gen, B, L, H, KV,
                                                          hd):
    """f32, the last position of a full ring: two passes, over 66 chunks
    (long_500k) or 4 (decode_32k) of each (b, kv head)."""
    q = torch.randn(B, 1, H, hd, generator=gen, device="cuda")
    k = torch.randn(B, L, KV, hd, generator=gen, device="cuda")
    v = torch.randn(B, L, KV, hd, generator=gen, device="cuda")
    assert k2_ops.decode_splits(B, KV, L, hd, 4) > 1
    got = k2_ops.flash_decode(q, k, v, pos=L - 1)
    want = k2_ref.decode_attention(q, k, v, L - 1)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# (B, L, H, KV, hd, pos, window): one ring cut into 2 and 4 shards of
# slots, so that slot0 != 0; a window that masks some shards whole
PARTIAL_CASES = [(2, 4096, 32, 8, 128, 4095, 0), (1, 8192, 32, 4, 64, 9000, 0),
                 (2, 1024, 16, 2, 64, 1500, 200), (2, 64, 4, 2, 80, 40, 0)]


@pytest.mark.parametrize("B,L,H,KV,hd,pos,window", PARTIAL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_partials_kernel_matches_plain(gen, B, L, H, KV, hd,
                                                    pos, window, dtype):
    """Each shard's (m, l, acc) against ref.decode_partials (m within
    1e-4 and 1e-6 of itself: a shard masked whole has m near -1e9, which
    the kernel reaches in base 2), and the shards joined on the card
    against the plain whole."""
    q = torch.randn(B, 1, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, L, KV, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, L, KV, hd, generator=gen, device="cuda").to(dtype)
    want = k2_ref.decode_attention(q, k, v, pos, window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for shards in (2, 4):
        n = L // shards
        before = k2_ops.flash_decode_partials.launches
        parts = [k2_ops.flash_decode_partials(
            q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n], pos=pos,
            window=window, ring_len=L, slot0=i * n) for i in range(shards)]
        assert k2_ops.flash_decode_partials.launches == before + shards
        for i, (m, l, acc) in enumerate(parts):
            rm, rl, racc = k2_ref.decode_partials(
                q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n], pos,
                window, L, i * n)
            torch.testing.assert_close(m, rm, atol=1e-4, rtol=1e-6)
            torch.testing.assert_close(l, rl, atol=tol, rtol=tol)
            torch.testing.assert_close(acc, racc, atol=tol * float(
                racc.abs().max().clamp(min=1)), rtol=tol)
        got = k2_ref.combine_partials(parts, dtype)
        atol = (tol if dtype == torch.float32
                else tol * min(1.0, float(want.float().abs().max())))
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=tol)


def _misaligned(shape, dtype):
    """A view of ``shape`` that starts one element past a 16-byte
    boundary."""
    n = 1
    for d in shape:
        n *= d
    return torch.randn(n + 1, device="cuda").to(dtype)[1:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_rejects_misaligned_kv(gen, dtype):
    """The kernel stages k and v by 16-byte copies: a view whose rows do
    not start on 16-byte boundaries raises, and nothing is launched."""
    q = torch.randn(2, 64, 4, 64, generator=gen, device="cuda").to(dtype)
    k = _misaligned((2, 64, 4, 64), dtype)
    v = torch.randn(2, 64, 4, 64, generator=gen, device="cuda").to(dtype)
    before = k2_ops.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        k2_ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        k2_ops.flash_attention(q, v, k)
    assert k2_ops.flash_attention.launches == before


@pytest.mark.parametrize("B,N,K", [(3, 40, 28), (3, 40, 32), (3, 40, 33),
                                   (2, 64, 257), (8, 128, 28), *DECODE_WIDE])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_scores_kernel_matches_plain(gen, B, N, K, dtype):
    """Tokens bitwise; scores within 1e-5 (the kernel's online logsumexp
    sums in another order)."""
    logits = torch.randn(B, N, K, generator=gen, device="cuda").to(dtype)
    u = torch.rand(B, N, K, generator=gen, device="cuda").clamp_(min=1e-30)
    gumbel = -torch.log(-torch.log(u))
    mask = torch.zeros(K, device="cuda")
    mask[-1] = -1e9
    before = k3_ops.decode_scores.launches
    for gum in (None, gumbel):
        for temp in (1.0, 0.7):
            kw = dict(mask=mask, gumbel=gum, temperature=temp)
            tok, score = k3_ops.decode_scores(logits, **kw)
            ptok, pscore = k3_ref.decode_scores(logits, **kw)
            assert torch.equal(tok, ptok)
            torch.testing.assert_close(score, pscore, atol=1e-5, rtol=1e-5)
    assert k3_ops.decode_scores.launches == before + 4


def _both_decodes(logits, **kw):
    """dndm_update's tokens where eq. (9) reveals every position (version
    2 at t = 1) and decode_scores' (tokens, scores), each against its plain
    version; asserts one launch per call.  Returns the tokens."""
    B, N, _ = logits.shape
    x = torch.zeros((B, N), dtype=torch.int32, device=logits.device)
    tau = torch.ones_like(x)
    before = (k1_ops.dndm_update.launches, k3_ops.decode_scores.launches)
    fused = k1_ops.dndm_update(logits, x, tau, 1, version=2, **kw)
    tok, score = k3_ops.decode_scores(logits, **kw)
    assert (k1_ops.dndm_update.launches,
            k3_ops.decode_scores.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(fused, k1_ref.dndm_update(logits, x, tau, 1,
                                                 version=2, **kw))
    ptok, pscore = k3_ref.decode_scores(logits, **kw)
    assert torch.equal(tok, ptok) and torch.equal(fused, tok)
    torch.testing.assert_close(score, pscore, atol=1e-5, rtol=1e-5)
    return tok


@pytest.mark.parametrize("K", [28, BLOCK_MIN_K + 1, 32000, 50257])
def test_decode_kernels_break_ties_to_the_lowest_index(gen, K):
    """bf16 logits without noise tie at the maximum in many rows; an
    all-equal row answers 0; a maximum among a row's first elements (the
    scalar head of an unaligned row) and one among its last (the tail)
    are found."""
    B, N = 2, 16
    logits = torch.randn(B, N, K, generator=gen, device="cuda")
    logits = (logits * 2).round().to(torch.bfloat16)
    logits[0, 0] = 0.0                        # all equal -> 0
    logits[0, 1, 1] = 100.0                   # among the first elements
    logits[0, 2, K - 2] = 100.0               # among the last
    mask = torch.zeros(K, device="cuda")
    tok = _both_decodes(logits, mask=mask)
    assert tok[0, :3].tolist() == [0, 1, K - 2]
    # with the -1e9 mask at the last id, f32 with noise at temperature 0.7
    mask[-1] = -1e9
    u = torch.rand(B, N, K, generator=gen, device="cuda").clamp_(min=1e-30)
    _both_decodes(logits.float(), mask=mask, gumbel=-torch.log(-torch.log(u)),
                  temperature=0.7)


@pytest.mark.parametrize("K", [28, BLOCK_MIN_K + 1, 32000, 50257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", ["logits", "gumbel", "both"])
def test_decode_kernels_take_views_at_any_alignment(gen, K, dtype, offset):
    """Contiguous views that start one element past an allocation (so not
    on a 16-byte boundary) are taken, not refused: the logits, the noise,
    or both (then the two lie at the same phase again)."""
    shape = (2, 16, K)
    logits = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    u = torch.rand(shape, generator=gen, device="cuda").clamp_(min=1e-30)
    gumbel = -torch.log(-torch.log(u))
    if offset != "gumbel":
        logits = _misaligned(shape, dtype).copy_(logits)
    if offset != "logits":
        gumbel = _misaligned(shape, torch.float32).copy_(gumbel)
    assert logits.is_contiguous() and gumbel.is_contiguous()
    mask = torch.zeros(K, device="cuda")
    mask[-1] = -1e9
    for temp in (1.0, 0.7):
        _both_decodes(logits, mask=mask, gumbel=gumbel, temperature=temp)


@pytest.mark.parametrize("which", ["mask", "gumbel", "tau"])
def test_decode_wrappers_reject_inputs_off_the_card(gen, which):
    """A CUDA logits tensor with another input on the CPU raises (the
    device is compared by index on the card), and nothing is launched."""
    logits = torch.randn(2, 8, 40, generator=gen, device="cuda")
    kw = {"mask": torch.zeros(40, device="cuda"),
          "gumbel": torch.zeros(2, 8, 40, device="cuda")}
    x = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    tau = torch.ones_like(x)
    if which == "tau":
        tau = tau.cpu()
    else:
        kw[which] = kw[which].cpu()
    before = (k1_ops.dndm_update.launches, k3_ops.decode_scores.launches)
    with pytest.raises(ValueError, match="different devices"):
        k1_ops.dndm_update(logits, x, tau, 1, **kw)
    if which != "tau":
        with pytest.raises(ValueError, match="different devices"):
            k3_ops.decode_scores(logits, **kw)
    assert (k1_ops.dndm_update.launches,
            k3_ops.decode_scores.launches) == before


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 16, 1, 4, 8, 4), (2, 48, 3, 8, 16, 16), (1, 64, 2, 16, 8, 32),
    (2, 33, 2, 8, 8, 16), (4, 256, 80, 64, 64, 128),
    (2, 200, 8, 64, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(gen, B, S, H, P, N, chunk, dtype):
    """The sweep shapes of tests/test_kernels.py, the zamba2 path's shape
    and a ragged one, at that test's bars: 3e-5 in f32, 5e-2 in bf16."""
    x = (torch.randn(B, S, H, P, generator=gen, device="cuda") * 0.5).to(dtype)
    dtv = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device="cuda")).to(dtype)
    A = -torch.exp(torch.randn(H, generator=gen, device="cuda") * 0.3)
    Bm = (torch.randn(B, S, N, generator=gen, device="cuda") * 0.3).to(dtype)
    Cm = (torch.randn(B, S, N, generator=gen, device="cuda") * 0.3).to(dtype)
    before = k4_ops.ssd_scan.launches
    got, _ = k4_ops.ssd_scan(x, dtv, A, Bm, Cm, chunk=chunk)
    want, _ = k4_ref.ssd_chunked(x, dtv, A, Bm, Cm, chunk)
    assert k4_ops.ssd_scan.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    tol = 3e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 48, 3, 8, 16, 16), (2, 33, 2, 8, 8, 16), (1, 64, 2, 16, 8, 32),
    (4, 256, 80, 64, 64, 128), (2, 200, 8, 64, 64, 128)])
def test_ssd_scan_passes_match_their_plain_versions(gen, B, S, H, P, N,
                                                    chunk):
    """What each of the kernel's passes leaves in its scratch holds
    against the plain pass in ref.py, f32: the states entering chunks
    1 .. nc-1 (passes 1 and 2; three chunks and more run the carry), cs_L
    and C Bᵀ on and below the diagonal; y against their composition."""
    x = torch.randn(B, S, H, P, generator=gen, device="cuda") * 0.5
    dtv = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device="cuda"))
    A = -torch.exp(torch.randn(H, generator=gen, device="cuda") * 0.3)
    Bm = torch.randn(B, S, N, generator=gen, device="cuda") * 0.3
    Cm = torch.randn(B, S, N, generator=gen, device="cuda") * 0.3
    before = k4_ops.ssd_scan.launches
    got = k4_ops.ssd_scan_passes(x, dtv, A, Bm, Cm, chunk=chunk)
    assert k4_ops.ssd_scan.launches == before + 1
    want = k4_ref.ssd_passes(x, dtv, A, Bm, Cm, chunk)
    y, entering, cs_last, cb = got
    torch.testing.assert_close(y, want[0], atol=3e-5, rtol=3e-5)
    torch.testing.assert_close(entering, want[1], atol=3e-5, rtol=3e-5)
    torch.testing.assert_close(cs_last, want[2], atol=3e-5, rtol=3e-5)
    torch.testing.assert_close(torch.tril(cb), torch.tril(want[3]),
                               atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("which", ["x", "Bm", "Cm"])
def test_ssd_scan_rejects_misaligned_f32_views(gen, which):
    """In f32 the kernel stages x, Bm and Cm by 16-byte copies: a view
    whose rows do not start on 16-byte boundaries raises, and nothing is
    launched."""
    B, S, H, P, N = 2, 48, 3, 8, 16
    args = dict(
        x=torch.randn(B, S, H, P, generator=gen, device="cuda") * 0.5,
        dtv=torch.nn.functional.softplus(
            torch.randn(B, S, H, generator=gen, device="cuda")),
        A=-torch.exp(torch.randn(H, generator=gen, device="cuda") * 0.3),
        Bm=torch.randn(B, S, N, generator=gen, device="cuda") * 0.3,
        Cm=torch.randn(B, S, N, generator=gen, device="cuda") * 0.3)
    args[which] = _misaligned(tuple(args[which].shape), torch.float32)
    before = k4_ops.ssd_scan.launches
    with pytest.raises(ValueError, match="16-byte"):
        k4_ops.ssd_scan(*args.values(), chunk=16)
    assert k4_ops.ssd_scan.launches == before


# (M, K, N) of the served dense products: text8 at 32 x 256 tokens (q, k,
# v, o; gate, up; down), zamba2 at 4 x 256 (Mamba-2 in_proj, out_proj; the
# shared block's q, k, v, o, gate, up, down; the head)
DENSE_SHAPES = [(8192, 768, 768), (8192, 768, 3072), (8192, 3072, 768),
                (1024, 2560, 10448), (1024, 5120, 2560), (1024, 2560, 2560),
                (1024, 2560, 10240), (1024, 10240, 2560), (1024, 2560, 32000)]
# Activations of unit scale (an RMSNorm's output) and weights of the
# cells' scale, 1 / sqrt(K) (dense_init), so outputs are of unit scale.
# 3xTF32 keeps each product within 2^-21 of f32's; the kernel and the
# plain f32 GEMM sum K terms in different orders, which alone moves a sum
# of K = 10240 unit-scale terms by about 1e-5.  1e-4 is the f32 bar of the
# tensor-core kernels here (flash); one TF32 pass misses it
# (tests/test_torch_tf32.py).
DENSE_TOL = 1e-4


def _dense_inputs(gen, M, K, N):
    a = torch.randn(M, K, generator=gen, device="cuda")
    w = torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5
    return a, w


def _no_tf32():
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.fail("the plain version must run in f32 (TF32 off)")


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("M,K,N", DENSE_SHAPES)
def test_dense_gemm_kernel_matches_plain(gen, M, K, N):
    """The served shapes; ``dense_gemm.split_launches`` counts the product
    only where the rule splits its K."""
    _no_tf32()
    a, w = _dense_inputs(gen, M, K, N)
    before = (k5_ops.dense_gemm.launches, k5_ops.dense_gemm.split_launches)
    got = k5_ops.dense_gemm(a, w)
    split = k5_ops.split_k(M, N, K, _sms()) > 1
    assert (k5_ops.dense_gemm.launches,
            k5_ops.dense_gemm.split_launches) == (before[0] + 1,
                                                  before[1] + split)
    assert got.shape == (M, N) and got.is_contiguous()
    torch.testing.assert_close(got, k5_ref.dense_gemm(a, w), atol=DENSE_TOL,
                               rtol=DENSE_TOL)


@pytest.mark.parametrize("K", [768, 3072, 5120, 10240])
def test_dense_gemm_kernel_is_as_accurate_as_f32(gen, K):
    """Against the float64 product, at the served depths: the kernel's
    error within 3x the plain f32 GEMM's.  The tensor cores' accumulator
    rounds toward zero; summed through all of K it would drift some 200x
    past f32's error at K = 10240, which the kernel's promotion of each
    pair of K tiles (64 deep) to a CUDA-core sum prevents."""
    _no_tf32()
    a, w = _dense_inputs(gen, 512, K, 256)
    exact = a.double() @ w.double()
    err = (k5_ops.dense_gemm(a, w).double() - exact).abs().max().item()
    plain = (k5_ref.dense_gemm(a, w).double() - exact).abs().max().item()
    assert err <= 3 * plain, (err, plain)


# A block walks the output tiles i, i + grid, ... (grid = min(tiles, SMs):
# 132 on an H100); K runs through a ring of 4 stages of 32, promoted every
# two stages.
DENSE_WALKS = [(128, 64, 128),             # 1 tile
               (131 * 128, 64, 128),       # 131 tiles: one block idle
               (132 * 128, 64, 128),       # 132: one tile a block
               (133 * 128, 64, 128),       # 133: one block walks two
               (40 * 128, 64, 50 * 128)]   # 2000: 15-16 a block
DENSE_DEPTHS = [(256, 4, 256), (256, 32, 256), (256, 64, 256),
                (256, 96, 256)]            # fewer K tiles than stages; 3
                                           # tiles: a promotion of one


@pytest.mark.parametrize("M,K,N", [(1000, 200, 100), (129, 36, 132),
                                   (1, 8, 4), (300, 1000, 4), (257, 96, 28),
                                   (130, 4, 132), *DENSE_WALKS,
                                   *DENSE_DEPTHS])
@pytest.mark.parametrize("layout", ["row_major", "transposed"])
def test_dense_gemm_kernel_masks_ragged_edges(gen, M, K, N, layout):
    """M, N and K that are no multiples of the tiles (128, 128, 32), tile
    counts about the SM count (the persistent walk) and K of 1-3 tiles,
    with B stored or as a transposed view; against the plain product and
    the float64 one, at the same bar."""
    _no_tf32()
    a, w = _dense_inputs(gen, M, K, N)
    if layout == "transposed":
        w = w.T.contiguous().T
        assert w.stride(0) == 1
    got = k5_ops.dense_gemm(a, w)
    torch.testing.assert_close(got, k5_ref.dense_gemm(a, w), atol=DENSE_TOL,
                               rtol=DENSE_TOL)
    torch.testing.assert_close(got.double(), a.double() @ w.double(),
                               atol=DENSE_TOL, rtol=DENSE_TOL)


@pytest.mark.parametrize("M,K,N,parts", [(8192, 768, 768, None),
                                         (1024, 5120, 2560, None),
                                         (133 * 128, 96, 128, None),
                                         (300, 1000, 132, 3)])
@pytest.mark.parametrize("layout", ["row_major", "transposed"])
def test_dense_gemm_kernel_is_deterministic(gen, M, K, N, parts, layout,
                                            monkeypatch):
    """Two launches on the same inputs give the same bits: each output
    element is computed by one block in one fixed K order, and K parts are
    summed in a fixed order (``parts``: forced, else the rule's)."""
    if parts is not None:
        monkeypatch.setattr(k5_ops, "split_k", lambda *_: parts)
    a, w = _dense_inputs(gen, M, K, N)
    if layout == "transposed":
        w = w.T.contiguous().T
    first = k5_ops.dense_gemm(a, w)
    assert torch.equal(first, k5_ops.dense_gemm(a, w))


def test_dense_gemm_kernel_carries_nothing_between_products(gen):
    """Different products queued back to back on one stream, without a
    synchronisation between them (other shapes, layouts, K parts and tile
    walks), each give the bits they give alone: no ring stage, barrier
    phase or map is carried from one launch to the next."""
    cases = []
    for (M, K, N), transposed in (((8192, 768, 768), False),
                                  ((257, 96, 28), True),
                                  ((1024, 5120, 2560), False),
                                  ((133 * 128, 4, 128), True),
                                  ((1000, 200, 100), False)):
        a, w = _dense_inputs(gen, M, K, N)
        if transposed:
            w = w.T.contiguous().T
        alone = k5_ops.dense_gemm(a, w)
        torch.cuda.synchronize()
        cases.append((a, w, alone))
    got = [k5_ops.dense_gemm(a, w) for a, w, _ in cases + cases[::-1]]
    torch.cuda.synchronize()
    for (_, _, alone), out in zip(cases + cases[::-1], got):
        assert torch.equal(out, alone)


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_dense_gemm_kernel_splits_k(gen, parts, monkeypatch):
    """Every count of K parts gives the product (zamba2's out_proj shape,
    K 5120, and a ragged one), and ``dense_gemm.split_launches`` counts the
    products of more than one part; the rule's own choice is covered
    above."""
    _no_tf32()
    monkeypatch.setattr(k5_ops, "split_k", lambda *_: parts)
    for M, K, N in ((1024, 5120, 2560), (300, 1000, 132)):
        a, w = _dense_inputs(gen, M, K, N)
        before = k5_ops.dense_gemm.split_launches
        torch.testing.assert_close(k5_ops.dense_gemm(a, w),
                                   k5_ref.dense_gemm(a, w), atol=DENSE_TOL,
                                   rtol=DENSE_TOL)
        assert k5_ops.dense_gemm.split_launches == before + (parts > 1)


@pytest.mark.parametrize("V", [28, 32000, 50257])
def test_dense_takes_the_tied_head_and_leading_dims(gen, V):
    """``layers.dense`` as the tied head calls it, h (B, S, d) @ embed.T,
    at text8's, zamba2's and GPT-2's vocabularies, over 32 x 256 tokens:
    the kernel reads the transposed view; the output keeps the leading
    dims.  text8's head (8192 x 768 x 28, below ``DENSE_MIN_MACS``) takes
    the plain route."""
    _no_tf32()
    h = torch.randn(32, 256, 768, generator=gen, device="cuda")
    embed = torch.randn(V, 768, generator=gen, device="cuda") / 768 ** 0.5
    kernel = 32 * 256 * 768 * V >= layers.DENSE_MIN_MACS
    before = k5_ops.dense_gemm.launches
    with torch.inference_mode():
        got = layers.dense(h, embed.T)
    assert k5_ops.dense_gemm.launches == before + kernel
    assert got.shape == (32, 256, V)
    torch.testing.assert_close(got, h @ embed.T, atol=DENSE_TOL,
                               rtol=DENSE_TOL)


@pytest.mark.parametrize("case", ["kernel", "cpu", "bf16", "grad", "small",
                                  "few_macs", "unaligned"])
def test_dense_routes_and_counts(gen, case):
    """The kernel for f32 on the card at ``DENSE_MIN_ROWS`` rows and
    ``DENSE_MIN_MACS`` multiply-adds and more, with nothing recording a
    gradient; ``x @ w`` for CPU tensors, bf16, autograd, fewer rows, fewer
    multiply-adds and rows off 16-byte boundaries, counted in
    ``dense.matmul_calls``."""
    rows = layers.DENSE_MIN_ROWS
    x = torch.randn(2, 512, 1024, generator=gen, device="cuda")
    w = torch.randn(1024, 2048, generator=gen, device="cuda") / 32
    assert 1024 * 1024 * 2048 >= layers.DENSE_MIN_MACS
    if case == "cpu":
        x, w = x.cpu(), w.cpu()
    elif case == "bf16":
        x, w = x.bfloat16(), w.bfloat16()
    elif case == "grad":
        w.requires_grad_(True)
    elif case == "small":
        x = torch.randn(rows - 1, 8192, generator=gen, device="cuda")
        w = torch.randn(8192, 2048, generator=gen, device="cuda") / 90
        assert (rows - 1) * 8192 * 2048 >= layers.DENSE_MIN_MACS
    elif case == "few_macs":
        w = w[:, :96]
    elif case == "unaligned":
        x = torch.randn(2, 512, 1025, generator=gen, device="cuda")[..., 1:]
    before = (k5_ops.dense_gemm.launches, layers.dense.matmul_calls)
    y = layers.dense(x, w)
    kernel = case == "kernel"
    assert (k5_ops.dense_gemm.launches,
            layers.dense.matmul_calls) == (before[0] + kernel,
                                           before[1] + (not kernel))
    assert y.requires_grad == (case == "grad")
    if kernel:
        torch.testing.assert_close(y, x @ w, atol=DENSE_TOL, rtol=DENSE_TOL)
    else:
        assert torch.equal(y, x @ w)


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows", "layout",
                                 "device", "grad", "offset", "odd_k",
                                 "odd_n"])
def test_dense_gemm_rejects_what_the_kernel_cannot_take(gen, bad):
    """Bad input raises before a launch, as do operands off the 16-byte
    copies' terms: A's rows off 16-byte boundaries, K or a row-major B's N
    no multiple of 4."""
    a, w = _dense_inputs(gen, 64, 32, 48)
    err = (TypeError if bad == "dtype" else
           RuntimeError if bad == "grad" else ValueError)
    if bad == "dtype":
        a, w = a.bfloat16(), w.bfloat16()
    elif bad == "shape":
        w = w[:31]
    elif bad == "rows":
        a = torch.randn(32, 64, generator=gen, device="cuda").T
    elif bad == "layout":
        w = torch.randn(64, 96, generator=gen, device="cuda")[::2, ::2]
    elif bad == "device":
        w = w.cpu()
    elif bad == "offset":
        a = torch.randn(64, 33, generator=gen, device="cuda")[:, 1:]
    elif bad == "odd_k":
        a, w = _dense_inputs(gen, 64, 33, 48)
    elif bad == "odd_n":
        a, w = _dense_inputs(gen, 64, 32, 47)
    else:
        w.requires_grad_(True)
    before = k5_ops.dense_gemm.launches
    with pytest.raises(err):
        k5_ops.dense_gemm(a, w)
    assert k5_ops.dense_gemm.launches == before


def test_moe_shard_map_on_one_rank_of_nccl(gen, tmp_path):
    """The sharded MoE dispatch on a world-size-1 NCCL group and a (1, 1)
    ("data", "model") mesh: with m = 1 it takes the expert-parallel
    branch, so all_to_all_single and all_gather run on NCCL, and y is
    bitwise the global dispatch's."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.moe import MoE
    cfg = ModelConfig(name="t", arch_type="moe", n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=50,
                      block_pattern=("moe",), n_experts=8,
                      experts_per_token=2)
    layer = MoE(gen, cfg, device="cuda")
    x = torch.randn(4, 16, 64, generator=gen, device="cuda")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), "cuda")
        with torch.inference_mode():
            want, _ = layer(x)
            layer.cfg = cfg.replace(moe_dispatch="shard_map")
            with mesh_lib.use_mesh(mesh):
                got, _ = layer(x)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)
