"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (the card is
looked for inside the fixture, never at import).  On a machine with an
H100:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.decode_scores import ops as k3_ops
from repro_torch.kernels.decode_scores import ref as k3_ref
from repro_torch.kernels.dndm_update import ops as k1_ops
from repro_torch.kernels.dndm_update import ref as k1_ref
from repro_torch.kernels.flash_attention import ops as k2_ops
from repro_torch.kernels.flash_attention import ref as k2_ref
from repro_torch.kernels.ssd_scan import ops as k4_ops
from repro_torch.kernels.ssd_scan import ref as k4_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("B,N,K", [(1, 16, 32), (2, 64, 257), (8, 256, 28),
                                   (4, 256, 32000)])
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
    (4, 256, 32, 32, 80, False, 0), (2, 77, 4, 4, 80, False, 0)])
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


@pytest.mark.parametrize("B,N,K", [(3, 40, 28), (3, 40, 32), (3, 40, 33),
                                   (2, 64, 257), (8, 128, 28)])
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
