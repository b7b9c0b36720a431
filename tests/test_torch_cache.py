"""The port's KV/state caches and ``decode_step`` against the JAX
package's, on the CPU.

* ``Model.decode_step`` for every block kind (the six families of
  tests/test_models.py, each attention family through every
  ``attn_impl``), one token at a time, against the port's own
  ``forward(causal=True)`` and against the JAX ``decode_step`` (jitted,
  "pallas" in interpret mode) at every position, at the JAX package's
  bar for decode against forward (atol 2e-4, rtol 2e-3); weights cross
  through ``convert``.  The swa family's ring (window 8) wraps at
  positions 8 and 9; the ring-wrap test runs 12 positions through a
  ring of 4.
* The ring buffer's bias (``ref.ring_bias``) equals the JAX
  ``decode_step``'s, and ``ref.decode_attention`` (``flash_decode``'s CPU
  route) equals the JAX flash kernel in interpret mode fed that bias,
  within 1e-5.
* Every registered config at ``.reduced()`` decodes 4 tokens through a
  16-token cache, as tests/test_arch_smoke.py does in JAX, and agrees
  with its causal forward.

Tests marked ``cuda`` run decode on the card and skip without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_flash
from repro.models import attention as j_attention
from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel

import repro_torch.configs as tconfigs
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention import ref as t_ref
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.model import Model as TModel

ATOL, RTOL = 2e-4, 2e-3
IMPLS = ("einsum", "blocked", "pallas")


def tiny(pattern, **kw):
    """tests/test_models.py's tiny config, for both packages, with blocks
    of 8 so that "blocked" and the JAX kernel cross a tile."""
    base = dict(name="t", arch_type="x", n_layers=len(pattern), d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=50,
                block_pattern=pattern, ssm_state=16, ssm_head_dim=32,
                ssd_chunk=8, lstm_heads=2, sliding_window=8,
                attn_block_q=8, attn_block_k=8)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


FAMILIES = {
    "dense": (("attn",) * 2, {}),
    "swa": (("swa",) * 2, {}),
    "moe": (("moe",) * 2, dict(n_experts=4, experts_per_token=2,
                               capacity_factor=8.0)),
    "mamba": (("mamba2",) * 2, {}),
    "xlstm": (("mlstm", "slstm"), {}),
    "zamba": (("mamba2", "shared_attn") * 2, {}),
}
# the mixer-only families have no attention to choose
CASES = [(fam, impl) for fam in FAMILIES
         for impl in (IMPLS if fam not in ("mamba", "xlstm") else
                      ("einsum",))]


def _pair(pattern, seed=0, **kw):
    jcfg, tcfg = tiny(pattern, **kw)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = TModel(tcfg, device="cpu", seed=1)
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _decode_all(jm, params, tm, tok, max_seq):
    """Both packages' decode logits at every position, (B, S, V) each."""
    B, S = tok.shape
    jcache = jm.init_cache(B, max_seq)
    step = jax.jit(jm.decode_step)
    cache = tm.init_cache(B, max_seq)
    want, got = [], []
    with torch.no_grad():
        for i in range(S):
            lg, jcache = step(params, jnp.asarray(tok[:, i:i + 1]), jcache,
                              jnp.asarray(i))
            want.append(np.asarray(lg[:, 0]))
            out, same = tm.decode_step(torch.from_numpy(tok[:, i:i + 1]),
                                       cache, i)
            assert same is cache and out.shape == (B, 1, tm.cfg.vocab_size)
            got.append(out[:, 0].numpy())
    return np.stack(got, 1), np.stack(want, 1)


@pytest.mark.parametrize("fam,impl", CASES)
def test_decode_matches_forward_and_jax(fam, impl):
    pattern, kw = FAMILIES[fam]
    jm, params, tm = _pair(pattern, attn_impl=impl, **kw)
    tok = np.random.default_rng(1).integers(0, 50, (2, 10)).astype(np.int32)
    got, want = _decode_all(jm, params, tm, tok, 10)
    with torch.no_grad():
        full = tm(torch.from_numpy(tok), causal=True).numpy()
    np.testing.assert_allclose(got, full, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_buffer_decode_beyond_window(impl):
    """tests/test_models.py::test_ring_buffer_decode_beyond_window: an swa
    block with window 4 and a physical cache of 4 slots decodes 12
    positions, so the ring wraps twice."""
    W, S = 4, 12
    jm, params, tm = _pair(("swa",), sliding_window=W, attn_impl=impl)
    tok = np.random.default_rng(8).integers(0, 50, (1, S)).astype(np.int32)
    assert tm.init_cache(1, W)[0]["k"].shape == (1, W, 2, 16)
    got, want = _decode_all(jm, params, tm, tok, W)
    with torch.no_grad():
        full = tm(torch.from_numpy(tok), causal=True).numpy()
    np.testing.assert_allclose(got, full, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _jax_ring_bias(pos: int, L: int, window: int) -> np.ndarray:
    """The bias of repro/models/attention.py's decode_step, (L,)."""
    pos = jnp.asarray(pos)
    slot = jnp.mod(pos, L)
    k_pos = pos - jnp.mod(slot - jnp.arange(L), L)
    bias = j_attention._mask_bias(pos[None], k_pos, causal=True,
                                  window=window)
    return np.asarray(jnp.where((k_pos >= 0)[None, :], bias,
                                j_attention.NEG)[0])


@pytest.mark.parametrize("pos", [0, 3, 15, 16, 17, 40])
@pytest.mark.parametrize("L,window", [(16, 0), (16, 16), (16, 5), (48, 0),
                                      (48, 7)])
def test_ring_bias_matches_jax(pos, L, window):
    np.testing.assert_array_equal(t_ref.ring_bias(pos, L, window).numpy(),
                                  _jax_ring_bias(pos, L, window))


# (B, L, H, KV, hd, pos, window)
DECODE_ATTN = [(2, 16, 2, 2, 16, 5, 0), (2, 16, 4, 2, 16, 40, 0),
               (1, 32, 4, 1, 64, 31, 0), (2, 48, 4, 4, 64, 100, 9),
               (2, 24, 4, 2, 80, 23, 0), (1, 16, 2, 2, 80, 16, 16),
               (2, 40, 8, 2, 128, 7, 0), (2, 16, 4, 4, 128, 53, 6)]


@pytest.mark.parametrize("B,L,H,KV,hd,pos,window", DECODE_ATTN)
def test_decode_attention_matches_the_jax_kernel(B, L, H, KV, hd, pos,
                                                 window):
    """ref.decode_attention and flash_decode on CPU tensors against the
    JAX flash kernel (interpret) over the repeated kv heads with the ring
    bias, as the JAX decode_step calls it with attn_impl="pallas"."""
    rng = np.random.default_rng(hd + L + pos)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, L, KV, hd)).astype(np.float32)
            for _ in range(2))
    bias = np.broadcast_to(_jax_ring_bias(pos, L, window), (B, 1, L))
    rep = H // KV
    want = j_flash.flash_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=2),
        jnp.repeat(jnp.asarray(v), rep, axis=2), jnp.asarray(bias),
        block_q=8, block_k=8)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = t_ref.decode_attention(qt, kt, vt, pos, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    before = t_flash.flash_decode.launches
    assert torch.equal(t_flash.flash_decode(qt, kt, vt, pos=pos,
                                            window=window), got)
    assert t_flash.flash_decode.launches == before


def test_flash_decode_rejects_bad_input():
    q = torch.zeros(2, 1, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    bad = [
        (ValueError, dict(q=torch.zeros(2, 2, 4, 16))),    # two query rows
        (ValueError, dict(k=torch.zeros(2, 0, 2, 16), v=torch.zeros(
            2, 0, 2, 16))),                                # empty cache
        (ValueError, dict(k=torch.zeros(2, 8, 3, 16), v=torch.zeros(
            2, 8, 3, 16))),                                # 4 % 3 heads
        (ValueError, dict(q=torch.zeros(2, 1, 4, 24), k=torch.zeros(
            2, 8, 2, 24), v=torch.zeros(2, 8, 2, 24))),    # head dim 24
        (ValueError, dict(v=torch.zeros(2, 9, 2, 16))),    # v's length
        (TypeError, dict(q=q.double())),                   # dtypes differ
        (ValueError, dict(pos=-1)),
        (ValueError, dict(pos=torch.tensor(3))),           # not an int
        (ValueError, dict(window=-2)),
        (ValueError, dict(q=q.to("meta"), k=k.to("meta"),
                          v=k.to("meta"))),                # not cuda or cpu
    ]
    before = t_flash.flash_decode.launches
    for err, kw in bad:
        args = dict(q=q, k=k, v=k, pos=3, window=0)
        args.update(kw)
        with pytest.raises(err):
            t_flash.flash_decode(args["q"], args["k"], args["v"],
                                 pos=args["pos"], window=args["window"])
    assert t_flash.flash_decode.launches == before


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_smoke_decode_step(arch):
    """tests/test_arch_smoke.py::test_smoke_decode_step for the port:
    B = 2, a 16-token cache, 4 tokens, finite logits of (B, 1, V) that
    agree with the causal forward."""
    cfg = tconfigs.get(arch).reduced()
    model = TModel(cfg, device="cpu", seed=0)
    B = 2
    cache = model.init_cache(B, 16)
    assert len(cache) == len(model.blocks)
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size - 1, (B, 4)))
    outs = []
    with torch.no_grad():
        for i in range(4):
            logits, cache = model.decode_step(tok[:, i:i + 1], cache, i)
            assert logits.shape == (B, 1, cfg.vocab_size)
            assert torch.isfinite(logits).all(), arch
            outs.append(logits)
        full = model(tok, causal=True)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=ATOL, rtol=RTOL)


def test_shared_attention_sites_keep_their_own_caches():
    """A Zamba model's two "shared_attn" sites: one weight set, two
    caches, each written by its own site."""
    _, tcfg = tiny(("mamba2", "shared_attn") * 2)
    tm = TModel(tcfg, device="cpu", seed=0)
    cache = tm.init_cache(1, 6)
    with torch.no_grad():
        tm.decode_step(torch.tensor([[3]]), cache, 0)
    k1, k3 = cache[1]["k"], cache[3]["k"]
    assert k1 is not k3 and k1.abs().sum() > 0 and k3.abs().sum() > 0
    assert not torch.equal(k1[:, 0], k3[:, 0])
    assert not k1[:, 1:].any() and not k3[:, 1:].any()


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_decode_step_on_the_card_matches_the_cpu(fam):
    """One tiny config per family, "pallas" (flash_decode on the card)
    against the same weights' einsum decode on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    pattern, kw = FAMILIES[fam]
    _, tcfg = tiny(pattern, attn_impl="einsum", **kw)
    cpu = TModel(tcfg, device="cpu", seed=3)
    gpu = TModel(tcfg.replace(attn_impl="pallas"), device="cuda", seed=3)
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    tok = torch.from_numpy(np.random.default_rng(9).integers(0, 50, (2, 12)))
    c_cache, g_cache = cpu.init_cache(2, 12), gpu.init_cache(2, 12)
    before = t_flash.flash_decode.launches
    with torch.inference_mode():
        for i in range(12):
            want, _ = cpu.decode_step(tok[:, i:i + 1], c_cache, i)
            got, _ = gpu.decode_step(tok[:, i:i + 1].cuda(), g_cache, i)
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       atol=ATOL, rtol=RTOL)
    n_attn = sum(k in ("attn", "swa", "moe", "shared_attn") for k in pattern)
    assert t_flash.flash_decode.launches - before == 12 * n_attn
