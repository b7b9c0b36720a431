"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (the card is
looked for inside the fixture, never at import).  On a machine with an
H100:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_scores import ops as k3_ops
from repro_torch.kernels.decode_scores import ref as k3_ref
from repro_torch.kernels.dndm_update import ops as k1_ops
from repro_torch.kernels.dndm_update import ref as k1_ref
from repro_torch.kernels.flash_attention import ops as k2_ops
from repro_torch.kernels.flash_attention import ref as k2_ref
from repro_torch.kernels.ssd_scan import ops as k4_ops
from repro_torch.kernels.ssd_scan import ref as k4_ref

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
# windows, grouped-query attention, every head dim
DECODE_CASES = [(2, 4096, 32, 8, 128, 4095, 0), (2, 4096, 32, 32, 80, 4200, 0),
                (2, 4096, 12, 12, 64, 100, 0), (2, 16, 4, 2, 16, 40, 16),
                (3, 16, 8, 2, 128, 15, 0), (2, 48, 4, 4, 32, 70, 9),
                (1, 33, 2, 1, 80, 5, 0), (2, 300, 8, 4, 64, 1000, 64)]


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
