"""The decode kernel's split over the cache's slots, on the CPU.

``flash_decode`` splits a ring buffer's slots into chunks and joins the
chunks' softmax statistics (``ops.decode_chunk``), and
``flash_decode_partials`` hands a share of a ring's statistics to ranks
that shard the slots.  Their plain versions, ``ref.decode_partials`` and
``ref.combine_partials``, are held here to ``ref.decode_attention`` and
to the JAX flash kernel (interpret) fed the ring's bias over the
repeated kv heads, at 1e-5 (f32 sums in another order); the split's
rule is held to its properties; and a reduced tinyllama decodes late
positions of a pre-filled cache as the JAX ``decode_step`` does.  The
CUDA kernel itself is held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 4b).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels.flash_attention import ops as j_flash
from repro.models import attention as j_attention
from repro.models.model import Model as JModel

import repro_torch.configs as tconfigs
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention import ref as t_ref
from repro_torch.models import convert
from repro_torch.models.model import Model as TModel


def _jax_ring_bias(pos: int, L: int, window: int) -> np.ndarray:
    """The bias of repro/models/attention.py's decode_step, (L,)."""
    pos = jnp.asarray(pos)
    slot = jnp.mod(pos, L)
    k_pos = pos - jnp.mod(slot - jnp.arange(L), L)
    bias = j_attention._mask_bias(pos[None], k_pos, causal=True,
                                  window=window)
    return np.asarray(jnp.where((k_pos >= 0)[None, :], bias,
                                j_attention.NEG)[0])


# (B, L, H, KV, hd, pos, window, chunk bounds): one chunk; uneven chunks
# of which the window masks two whole; slots never written (pos < L)
# filling a chunk; wrapped rings; every head dim
SPLITS = [(2, 16, 4, 2, 16, 5, 0, (0, 16)),
          (2, 48, 4, 4, 64, 100, 9, (0, 7, 20, 33, 48)),
          (1, 32, 4, 1, 64, 10, 0, (0, 11, 32)),
          (2, 40, 8, 2, 128, 47, 0, (0, 3, 8, 40)),
          (1, 24, 4, 2, 80, 23, 0, (0, 12, 24)),
          (2, 30, 6, 3, 32, 77, 12, (0, 10, 20, 30))]


def _inputs(B, L, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, L, KV, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("B,L,H,KV,hd,pos,window,bounds", SPLITS)
def test_partials_joined_equal_decode_attention_and_the_jax_kernel(
        B, L, H, KV, hd, pos, window, bounds):
    q, k, v = _inputs(B, L, H, KV, hd, L + pos)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    parts = [t_ref.decode_partials(qt, kt[:, a:b], vt[:, a:b], pos, window,
                                   L, a)
             for a, b in zip(bounds, bounds[1:])]
    for m, l, acc in parts:
        assert m.shape == l.shape == (B, 1, H) and acc.shape == (B, 1, H, hd)
        assert torch.isfinite(m).all() and (l >= 1).all()
    got = t_ref.combine_partials(parts)
    whole = t_ref.decode_attention(qt, kt, vt, pos, window)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5,
                               rtol=1e-5)
    rep = H // KV
    bias = np.broadcast_to(_jax_ring_bias(pos, L, window), (B, 1, L))
    want = j_flash.flash_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=2),
        jnp.repeat(jnp.asarray(v), rep, axis=2), jnp.asarray(bias),
        block_q=8, block_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_a_chunk_masked_whole_drops_out():
    """Every slot of the second chunk lies past the window: its m is
    near -1e9 and the join equals the first chunk's softmax alone."""
    q, k, v = _inputs(1, 32, 4, 2, 16, 0)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    pos, window = 15, 8                    # visible: slots 8 .. 15
    first = t_ref.decode_partials(qt, kt[:, :16], vt[:, :16], pos, window,
                                  32, 0)
    second = t_ref.decode_partials(qt, kt[:, 16:], vt[:, 16:], pos, window,
                                   32, 16)
    assert (second[0] < -1e8).all()
    got = t_ref.combine_partials([first, second])
    alone = first[2] / first[1][..., None]
    np.testing.assert_allclose(got.numpy(), alone.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_partials_returns_the_dtype(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _inputs(2, 20, 4, 2, 32, 3))
    parts = [t_ref.decode_partials(q, k[:, :9], v[:, :9], 30, 0, 20, 0),
             t_ref.decode_partials(q, k[:, 9:], v[:, 9:], 30, 0, 20, 9)]
    got = t_ref.combine_partials(parts, dtype)
    assert got.dtype == dtype
    torch.testing.assert_close(got, t_ref.decode_attention(q, k, v, 30),
                               atol=1e-2 if dtype == torch.bfloat16 else 1e-6,
                               rtol=1e-2 if dtype == torch.bfloat16 else 1e-6)


# (B, KV, L, hd) of the three long shapes the split serves: tinyllama-1.1b's
# long_500k and decode_32k (16 rows) steps, the mixtral ring of 4096
LONG = [(1, 4, 524288, 64), (16, 4, 32768, 64), (2, 8, 4096, 128)]


@pytest.mark.parametrize("B,KV,L,hd", LONG + [
    (2, 8, 32, 128), (2, 12, 16, 64), (1, 1, 4133, 64), (3, 2, 1000, 80),
    (1, 1, 1, 16), (64, 8, 100000, 32), (1, 4, 524288, 128)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_decode_chunk_properties(B, KV, L, hd, itemsize):
    chunk = t_flash.decode_chunk(B, KV, L, hd, itemsize)
    n = t_flash.decode_splits(B, KV, L, hd, itemsize)
    assert n >= 1 and n == -(-L // chunk)
    if n == 1:
        assert chunk == L
    else:                          # whole tiles, at least the floor
        assert chunk % t_flash.DECODE_TILE == 0
        assert chunk >= t_flash.DECODE_MIN_CHUNK
        assert (n - 1) * chunk < L <= n * chunk
    resident = t_flash.SMS * t_flash.decode_blocks_per_sm(hd, itemsize)
    if n > 1:                      # one wave of the resident blocks
        assert B * KV * n <= resident
    if (B, KV, L, hd) in LONG:     # ... filled but for a chunk per pair
        assert B * KV * n > resident - B * KV


def test_decode_blocks_per_sm_fit_the_sm():
    """The kernel's shared memory (stages 3 x 2 x 64 rows of hd + 16
    bytes, at least the P v join) times the blocks fits 228 KB."""
    for hd in t_flash.HEAD_DIMS:
        for itemsize in (4, 2):
            n = t_flash.decode_blocks_per_sm(hd, itemsize)
            stages = 3 * 2 * 64 * (hd * itemsize + 16)
            assert 1 <= n <= 4
            assert n * (stages + 1024) <= t_flash.SM_SHARED_BYTES
    assert t_flash.decode_blocks_per_sm(64, 4) == 2       # long_500k's
    assert t_flash.decode_blocks_per_sm(128, 4) == 1      # 203 KB


def test_the_split_rule_reads_the_kernels_constants():
    """``ops``' model of the pass-1 block is the source's."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kDecTile") == t_flash.DECODE_TILE
    assert const("kDecStages") == t_flash.DECODE_STAGES
    assert 32 * const("kDecWarps") == t_flash.DECODE_THREADS
    assert const("kDecGroup") == t_flash.DECODE_GROUP


def test_short_rings_take_one_pass():
    """Phase 8f's rings of 16-48 slots stay one chunk: one launch."""
    for B, KV, L, hd in [(2, 8, 32, 128), (2, 32, 48, 80), (2, 2, 16, 64),
                         (2, 12, 16, 64)]:
        assert t_flash.decode_splits(B, KV, L, hd, 4) == 1


@pytest.mark.parametrize("B,L,H,KV,hd,pos,window,slot0,ring_len",
                         [(2, 16, 4, 2, 16, 40, 0, 16, 48),
                          (1, 33, 8, 1, 80, 5, 0, 0, 33),
                          (2, 8, 4, 4, 64, 100, 9, 32, 64)])
def test_flash_decode_partials_on_cpu_is_the_plain_version(
        B, L, H, KV, hd, pos, window, slot0, ring_len):
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, L, H, KV, hd, 7))
    before = (t_flash.flash_decode.launches,
              t_flash.flash_decode_partials.launches)
    got = t_flash.flash_decode_partials(q, k, v, pos=pos, window=window,
                                        ring_len=ring_len, slot0=slot0)
    want = t_ref.decode_partials(q, k, v, pos, window, ring_len, slot0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (t_flash.flash_decode.launches,
            t_flash.flash_decode_partials.launches) == before


def test_flash_decode_partials_rejects_bad_slots():
    q = torch.zeros(2, 1, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    for kw in (dict(slot0=-1, ring_len=16), dict(slot0=9, ring_len=16),
               dict(slot0=0, ring_len=7), dict(slot0=1.0, ring_len=16),
               dict(slot0=0, ring_len=True)):
        with pytest.raises(ValueError):
            t_flash.flash_decode_partials(q, k, k, pos=3, window=0, **kw)
    with pytest.raises(ValueError):                  # the shared checks
        t_flash.flash_decode_partials(q, k, k, pos=-1, window=0, ring_len=8,
                                      slot0=0)


# a reduced tinyllama (two "attn" blocks, 4 heads on 2 kv heads of 64):
# max_seq slots, the first PREFILLED filled from numpy, then DECODED
# positions decoded one step each
MAX_SEQ, PREFILLED, DECODED = 96, 90, 4


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_reduced_tinyllama_decodes_a_prefilled_cache_as_jax(impl):
    """Both packages' decode_step over the same pre-filled cache at
    positions PREFILLED .. PREFILLED + DECODED - 1, at the JAX package's
    bar for decode (atol 2e-4, rtol 2e-3: f32 sums in another order
    through two layers and the head)."""
    kw = dict(n_layers=2, block_pattern=("attn", "attn"), attn_impl=impl)
    jcfg = jconfigs.get("tinyllama-1.1b").reduced(**kw)
    tcfg = tconfigs.get("tinyllama-1.1b").reduced(**kw)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu", seed=1)
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    B = 2
    rng = np.random.default_rng(5)
    jcache = jm.init_cache(B, MAX_SEQ)
    shape = jcache["b0"]["k"].shape            # (layers, B, L, KV, hd)
    assert shape[:3] == (2, B, MAX_SEQ)
    fill = {x: np.zeros(shape, np.float32) for x in ("k", "v")}
    for x in fill:
        fill[x][:, :, :PREFILLED] = rng.standard_normal(
            (2, B, PREFILLED) + shape[3:]).astype(np.float32)
    jcache = {"b0": {x: jnp.asarray(a) for x, a in fill.items()}}
    tcache = tm.init_cache(B, MAX_SEQ)
    for i, c in enumerate(tcache):
        for x in ("k", "v"):
            c[x].copy_(torch.from_numpy(fill[x][i]))
    tok = rng.integers(0, tcfg.vocab_size, (B, DECODED)).astype(np.int32)
    step = jax.jit(jm.decode_step)
    with torch.no_grad():
        for i in range(DECODED):
            pos = PREFILLED + i
            want, jcache = step(params, jnp.asarray(tok[:, i:i + 1]), jcache,
                                jnp.asarray(pos))
            got, _ = tm.decode_step(torch.from_numpy(tok[:, i:i + 1]),
                                    tcache, pos)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-4, rtol=2e-3)
    for i, c in enumerate(tcache):             # the same slots written
        np.testing.assert_allclose(c["k"].numpy(),
                                   np.asarray(jcache["b0"]["k"][i]),
                                   atol=1e-5, rtol=1e-5)
