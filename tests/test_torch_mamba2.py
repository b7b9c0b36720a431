"""The port's Mamba-2 slice vs the JAX package, on the CPU.

The same numpy inputs from a seed go through both frameworks.

* ``ssd_scan`` on CPU tensors is the plain chunked version
  (``ref.ssd_chunked``), held against the JAX package's chunked oracle
  (``_ssd_scan_ref``), its exact recurrence (``ssd_sequential_ref``) and
  its Pallas kernel in interpret mode, at the bars of
  ``tests/test_kernels.py``: y within 3e-5 in f32 and 5e-2 in bf16 (one
  bf16 rounding of the output, and of C Bᵀ in the chunked forms), the
  final f32 state within 3e-5.
* The ``Mamba2`` block and the Zamba model (two shared-attention sites)
  with weights carried across by ``convert``: outputs within atol 3e-4,
  rtol 3e-3, the JAX package's bar for comparing implementations
  (``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels.ssd_scan import ops as j_ssd
from repro.kernels.ssd_scan import ref as j_ssd_ref
from repro.models import mamba2 as j_mamba2
from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel

import repro_torch.configs as tconfigs
from repro_torch.kernels.ssd_scan import ops as t_ssd
from repro_torch.kernels.ssd_scan import ref as t_ssd_ref
from repro_torch.models import convert
from repro_torch.models import mamba2 as t_mamba2
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.model import Model as TModel

ATOL, RTOL = 3e-4, 3e-3
Y_TOL = {"f32": 3e-5, "bf16": 5e-2}
STATE_TOL = 3e-5
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
# (B, S, H, P, N, chunk): the shapes of tests/test_kernels.py's sweep
SWEEP = [(1, 16, 1, 4, 8, 4), (2, 48, 3, 8, 16, 16), (1, 64, 2, 16, 8, 32),
         (2, 33, 2, 8, 8, 16)]


def _ssd_inputs(B, S, H, P, N, seed):
    """numpy f32 (x, dtv, A, Bm, Cm) in the laws of the JAX sweep."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dtv = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    return x, dtv, A, Bm, Cm


def _both(arrays, dtype):
    """The same arrays in JAX and torch, all but A (f32) in ``dtype``
    (both frameworks round f32 to bf16 to nearest even)."""
    jdt, tdt = DT[dtype]
    x, dtv, A, Bm, Cm = arrays
    j = [jnp.asarray(a).astype(jdt) for a in (x, dtv)] + [jnp.asarray(A)] + \
        [jnp.asarray(a).astype(jdt) for a in (Bm, Cm)]
    t = [torch.from_numpy(a).to(tdt) for a in (x, dtv)] + \
        [torch.from_numpy(A)] + [torch.from_numpy(a).to(tdt) for a in (Bm, Cm)]
    return j, t


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_scan_matches_jax(B, S, H, P, N, chunk, dtype):
    j, t = _both(_ssd_inputs(B, S, H, P, N, seed=B * S + H * P + N),
                 dtype)
    got, none = t_ssd.ssd_scan(*t, chunk=chunk)
    assert none is None and got.dtype == t[0].dtype
    assert got.shape == (B, S, H, P)
    _, t_state = t_ssd_ref.ssd_chunked(*t, chunk)
    tol = Y_TOL[dtype]
    y_chunk, j_state = j_mamba2._ssd_scan_ref(*j, chunk)
    y_seq, _ = j_ssd_ref.ssd_sequential_ref(*j)
    y_kern, _ = j_ssd.ssd_scan(*j, chunk=chunk, interpret=True)
    for want in (y_chunk, y_seq, y_kern):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(t_state.numpy(), np.asarray(j_state),
                               atol=STATE_TOL, rtol=STATE_TOL)


@pytest.mark.parametrize("chunk", [5, 8, 40, 64])
def test_ssd_chunked_matches_sequential(chunk):
    """The chunks of tests/test_kernels.py::
    test_ssd_chunked_ref_matches_sequential, ragged ones included."""
    j, t = _both(_ssd_inputs(2, 40, 2, 8, 16, seed=7), "f32")
    j_y, j_s = j_ssd_ref.ssd_sequential_ref(*j)
    for y, s in (t_ssd_ref.ssd_chunked(*t, chunk),
                 t_ssd_ref.ssd_sequential(*t)):
        np.testing.assert_allclose(y.numpy(), np.asarray(j_y), atol=3e-5,
                                   rtol=3e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(j_s),
                                   atol=STATE_TOL, rtol=STATE_TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_kernel_passes_compose_to_the_jax_oracles(B, S, H, P, N, chunk,
                                                      dtype):
    """The plain versions of the CUDA kernel's three passes (chunk
    states and each chunk's C Bᵀ, the carry across chunks, the output),
    composed, hold against the JAX package's chunked oracle and its exact
    recurrence at the sweep's bars; on the CPU ``ssd_scan_passes`` hands
    them back in the kernel scratch's shapes."""
    j, t = _both(_ssd_inputs(B, S, H, P, N, seed=B * S + H * P + N + 1),
                 dtype)
    got, entering, cs_last, cb = t_ssd.ssd_scan_passes(*t, chunk=chunk)
    assert got.dtype == t[0].dtype and got.shape == (B, S, H, P)
    L = min(chunk, S)
    nc = -(-S // L)
    assert entering.shape == (B, nc - 1, H, N, P)
    assert cs_last.shape == (B, nc - 1, H) and cb.shape == (B, nc, L, L)
    y_chunk, _ = j_mamba2._ssd_scan_ref(*j, chunk)
    y_seq, _ = j_ssd_ref.ssd_sequential_ref(*j)
    for want in (y_chunk, y_seq):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=Y_TOL[dtype],
                                   rtol=Y_TOL[dtype])


@pytest.mark.parametrize("chunk", [5, 8, 16, 40])
def test_ssd_carried_states_are_the_recurrence_at_chunk_starts(chunk):
    """Passes 1 and 2 give the state entering each chunk c >= 1: the exact
    recurrence's state after the first c L positions (three and more
    chunks exercise the carry)."""
    _, t = _both(_ssd_inputs(2, 40, 2, 8, 16, seed=9), "f32")
    x, dtv, A, Bm, Cm = t
    states, cs_last = t_ssd_ref.chunk_states(x, dtv, A, Bm, chunk)
    nc = -(-40 // chunk)
    assert states.shape == (2, nc - 1, 2, 16, 8)
    assert cs_last.shape == (2, nc - 1, 2)
    entering = t_ssd_ref.carry_states(states, cs_last)
    for c in range(1, nc):
        n = c * chunk
        _, want = t_ssd_ref.ssd_sequential(x[:, :n], dtv[:, :n], A,
                                           Bm[:, :n], Cm[:, :n])
        np.testing.assert_allclose(entering[:, c - 1].numpy(), want.numpy(),
                                   atol=STATE_TOL, rtol=STATE_TOL)


def test_ssd_scan_cpu_path_counts_no_launch_and_rejects_bad_input():
    _, t = _both(_ssd_inputs(2, 48, 3, 8, 16, seed=1), "f32")
    x, dtv, A, Bm, Cm = t
    before = t_ssd.ssd_scan.launches
    t_ssd.ssd_scan(x, dtv, A, Bm, Cm, chunk=16)
    assert t_ssd.ssd_scan.launches == before
    # views through strides are taken as they are (the model's layout)
    xbc = torch.cat([x.reshape(2, 48, 24), Bm, Cm], dim=-1)
    xv, Bv, Cv = torch.split(xbc, [24, 16, 16], dim=-1)
    y_view, _ = t_ssd.ssd_scan(xv.reshape(2, 48, 3, 8), dtv, A, Bv, Cv,
                               chunk=16)
    torch.testing.assert_close(y_view, t_ssd.ssd_scan(x, dtv, A, Bm, Cm,
                                                      chunk=16)[0])
    bad = [
        (ValueError, dict(x=x[0])),                       # not 4-d
        (ValueError, dict(dtv=dtv[:, :-1])),              # S mismatch
        (ValueError, dict(Bm=Bm[..., :-1])),              # Bm != Cm
        (ValueError, dict(A=A[:-1])),                     # A not (H,)
        (ValueError, dict(A=A.double())),                 # A not f32
        (TypeError, dict(dtv=dtv.bfloat16())),            # mixed dtypes
        (TypeError, dict(x=x.half(), dtv=dtv.half(), Bm=Bm.half(),
                         Cm=Cm.half())),                  # f16
        (ValueError, dict(x=x.transpose(2, 3).contiguous().transpose(2, 3))),
        (ValueError, dict(chunk=0)),
        (ValueError, dict(x=torch.zeros(2, 48, 3, 129), chunk=16)),
        (ValueError, dict(x=x.to("meta"), dtv=dtv.to("meta"),
                          A=A.to("meta"), Bm=Bm.to("meta"),
                          Cm=Cm.to("meta"))),             # not cuda or cpu
    ]
    for err, kw in bad:
        args = dict(x=x, dtv=dtv, A=A, Bm=Bm, Cm=Cm, chunk=16)
        args.update(kw)
        chunk = args.pop("chunk")
        with pytest.raises(err):
            t_ssd.ssd_scan(*args.values(), chunk=chunk)
    assert t_ssd.ssd_scan.launches == before


# ------------------------------------------------------------------
# the Mamba-2 block and the Zamba model
# ------------------------------------------------------------------

def tiny(pattern, **kw):
    """tests/test_models.py's tiny config, for both packages."""
    base = dict(name="t", arch_type="x", n_layers=len(pattern), d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=50,
                block_pattern=pattern, ssm_state=16, ssm_head_dim=32,
                ssd_chunk=8, lstm_heads=2, sliding_window=8,
                attn_impl="pallas", attn_block_q=8, attn_block_k=8)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


ZAMBA = ("mamba2", "shared_attn") * 2


@pytest.mark.parametrize("bidirectional", [False, True])
def test_mamba2_block_matches_jax(bidirectional):
    jcfg, tcfg = tiny(("mamba2",), ssd_chunk=16)
    params = j_mamba2.init(jax.random.PRNGKey(4), jcfg)
    mixer = t_mamba2.Mamba2(torch.Generator().manual_seed(0), tcfg)
    convert.load_tree(mixer, jax.tree.map(np.asarray, params))
    # S = 40 is ragged at chunk 16: three chunks, the state carried twice
    u = np.random.default_rng(5).standard_normal((2, 40, 64)).astype(
        np.float32)
    want = j_mamba2.apply(params, jnp.asarray(u), jcfg,
                          bidirectional=bidirectional)
    got = mixer(torch.from_numpy(u), bidirectional=bidirectional)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _zamba_pair(seed=0):
    jcfg, tcfg = tiny(ZAMBA)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = TModel(tcfg, device="cpu", seed=1)
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("prefix_len", [0, 6])
def test_zamba_logits_match_jax(prefix_len):
    """Two shared-attention sites, bidirectional Mamba-2 blocks, through
    the samplers' denoiser (with a source prefix when ``prefix_len``)."""
    jm, params, tm = _zamba_pair()
    rng = np.random.default_rng(prefix_len)
    x_t = rng.integers(0, 50, (2, 20)).astype(np.int32)
    t = np.asarray([0.25, 0.75], np.float32)
    jcond = tcond = None
    if prefix_len:
        prefix = rng.integers(0, 49, (2, prefix_len)).astype(np.int32)
        jcond = {"prefix_tokens": jnp.asarray(prefix)}
        tcond = {"prefix_tokens": torch.from_numpy(prefix)}
    want = jm.denoise_fn(params)(jnp.asarray(x_t), jnp.asarray(t), jcond)
    got = tm.denoise_fn()(torch.from_numpy(x_t), torch.from_numpy(t), tcond)
    assert got.shape == (2, 20, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_load_params_covers_every_parameter_once():
    jm, params, tm = _zamba_pair()
    names = [n for n, _ in tm.named_parameters()]
    assert len(names) == len(set(names))
    # the shared weights appear once, under shared.*, and no site holds any
    assert any(n.startswith("shared.") for n in names)
    assert not any(n.startswith(("blocks.1.", "blocks.3.")) for n in names)
    assert sum(p.numel() for p in tm.parameters()) == jm.param_count(params)
    # both shared sites run the same module
    assert tm.blocks[1] is not tm.shared and not list(
        tm.blocks[1].parameters())
    tree = jax.tree.map(np.asarray, params)
    del tree["shared"]
    with pytest.raises(KeyError, match="shared"):
        convert.load_params(tm, tree)
    tree = jax.tree.map(np.asarray, params)
    tree["unit"]["b1"] = tree["unit"]["b0"]
    with pytest.raises(KeyError, match="blocks.1"):
        convert.load_params(tm, tree)


def test_a_future_token_changes_past_logits():
    """The port's counterpart of tests/test_models.py::
    test_bidirectional_uses_future_context for the Zamba family."""
    _, tcfg = tiny(ZAMBA, attn_impl="einsum")
    tm = TModel(tcfg, device="cpu", seed=2)
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, 50, (1, 10)))
    tok2 = tok.clone()
    tok2[0, -1] = (tok2[0, -1] + 1) % 50
    a, b = tm(tok, None, causal=False), tm(tok2, None, causal=False)
    assert float((a[0, 0] - b[0, 0]).abs().max()) > 1e-6
    a, b = tm(tok, None, causal=True), tm(tok2, None, causal=True)
    assert float((a[0, 0] - b[0, 0]).abs().max()) < 1e-6


@pytest.mark.parametrize("reduced", [False, True])
def test_zamba2_config_matches_jax(reduced):
    j, t = jconfigs.get("zamba2-2.7b"), tconfigs.get("zamba2-2.7b")
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.superblock() == j.superblock()
    assert (t.hd, t.d_inner, t.ssm_heads) == (80, 5120, 80) or reduced


@pytest.mark.parametrize("H", [1, 4, 16, 80])
def test_mamba2_init_formulas_match_jax(H):
    """A_log, D and dt_bias are formulas, not draws: D and dt_bias are
    bitwise the JAX values and so is the linspace under A_log; the log is
    within one ulp (XLA's f32 log is an approximation of its own)."""
    jcfg, tcfg = tiny(("mamba2",), d_model=H * 16, ssm_head_dim=32)
    want = j_mamba2.init(jax.random.PRNGKey(0), jcfg)
    mixer = t_mamba2.Mamba2(torch.Generator().manual_seed(0), tcfg)
    assert mixer.A_log.shape == (H,)
    np.testing.assert_array_equal(mixer.D.numpy(), np.asarray(want["D"]))
    np.testing.assert_array_equal(mixer.dt_bias.numpy(),
                                  np.asarray(want["dt_bias"]))
    np.testing.assert_array_equal(t_mamba2.a_log_linspace(H),
                                  np.asarray(jnp.linspace(1.0, 16.0, H)))
    ulps = np.abs(mixer.A_log.numpy().view(np.int32)
                  - np.asarray(want["A_log"]).view(np.int32))
    assert ulps.max() <= 1
    # conv_w: truncated normal on [-2, 2] times 1/sqrt(W); conv_b zero
    W = tcfg.conv_width
    assert mixer.conv_w.shape == (W, tcfg.d_inner + 2 * tcfg.ssm_state)
    assert float(mixer.conv_w.abs().max()) <= 2.0 / W ** 0.5 + 1e-7
    assert not mixer.conv_b.any()


@pytest.mark.parametrize("kind", ["moe", "mlstm", "slstm"])
def test_kinds_still_to_port_raise(kind):
    _, tcfg = tiny((kind,), n_experts=4, experts_per_token=2)
    with pytest.raises(NotImplementedError, match="model-zoo"):
        TModel(tcfg, device="cpu")
