"""The port's xLSTM blocks (``repro_torch/models/xlstm.py``) against the
JAX package's (``repro/models/xlstm.py``), on the CPU.

The same numpy inputs from a seed go through both frameworks; weights
made by the JAX init cross through ``convert``.  The mixers and their
plain functions are held at atol 1e-5 / rtol 1e-4 in f32 (the two
frameworks sum in other orders; nothing else differs), the models'
logits likewise without the diffusion time embedding.  With it, the JAX
package's f32 logits are up to 5e-5 from their float64 value (XLA's f32
sin and cos at the embedding's angles of up to 1000 rad miss by 3.8e-6,
and the blocks carry that to the logits), while the port's stay within
3e-6: there the port is held to its own float64 logits at the f32 bar,
and to the JAX package's at the logits bar of tests/test_torch_zoo.py
(atol 3e-4, rtol 3e-3).  The chunked mLSTM runs at S = 20, so that the
last chunk pads, against the JAX package's chunked form (its scan and
its unrolled loop) and against the parallel form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import xlstm as j_xlstm
from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel

import repro_torch.configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import xlstm as t_xlstm
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.model import Model as TModel

ATOL, RTOL = 1e-5, 1e-4


def tiny(pattern, **kw):
    """tests/test_models.py's tiny config, for both packages."""
    base = dict(name="t", arch_type="x", n_layers=len(pattern), d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=50,
                block_pattern=pattern, lstm_heads=2)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _gate_inputs(B, S, nh, dh, seed):
    """numpy f32 q, k, v (B,S,nh,dh) and logi, logf (B,S,nh), logf a log
    sigmoid as the mixer makes it."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, nh, dh)).astype(np.float32)
               for _ in range(3))
    logi = rng.standard_normal((B, S, nh)).astype(np.float32)
    f = rng.standard_normal((B, S, nh)).astype(np.float32) + 2.0
    logf = (-np.log1p(np.exp(-f))).astype(np.float32)
    return q, k, v, logi, logf


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def test_mlstm_parallel_matches_jax():
    ins = _gate_inputs(2, 20, 2, 16, 0)
    _close(t_xlstm._mlstm_parallel(*_t(ins)),
           j_xlstm._mlstm_parallel(*_j(ins)))


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("unroll", [False, True])
def test_mlstm_chunked_matches_jax_and_the_parallel_form(chunk, unroll):
    """S = 20: the last chunk pads (logi -1e9, logf 0); the matrix memory
    is carried across two (chunk 8) or one (chunk 16) boundaries."""
    ins = _gate_inputs(2, 20, 2, 16, chunk)
    got = t_xlstm._mlstm_chunked(*_t(ins), chunk)
    assert got.shape == (2, 20, 2, 16)
    _close(got, j_xlstm._mlstm_chunked(*_j(ins), chunk, unroll))
    _close(got, t_xlstm._mlstm_parallel(*_t(ins)))


def _mixer_pair(kind, seed=0, **kw):
    """A mixer of each package with the JAX init's weights."""
    jcfg, tcfg = tiny((kind,), **kw)
    init = j_xlstm.mlstm_init if kind == "mlstm" else j_xlstm.slstm_init
    params = init(jax.random.PRNGKey(seed), jcfg)
    cls = t_xlstm.MLSTM if kind == "mlstm" else t_xlstm.SLSTM
    mixer = cls(torch.Generator().manual_seed(seed), tcfg)
    convert.load_tree(mixer, jax.tree.map(np.asarray, params))
    return jcfg, params, mixer


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("chunk", [0, 8])
def test_mlstm_mixer_matches_jax(bidirectional, chunk):
    jcfg, params, mixer = _mixer_pair("mlstm", mlstm_chunk=chunk)
    u = np.random.default_rng(1).standard_normal((2, 20, 64)).astype(
        np.float32)
    want = j_xlstm.mlstm_apply(params, jnp.asarray(u), jcfg,
                               bidirectional=bidirectional)
    with torch.no_grad():
        got = mixer(torch.from_numpy(u), bidirectional=bidirectional)
    _close(got, want)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_slstm_mixer_matches_jax(bidirectional):
    jcfg, params, mixer = _mixer_pair("slstm")
    u = np.random.default_rng(2).standard_normal((2, 20, 64)).astype(
        np.float32)
    want = j_xlstm.slstm_apply(params, jnp.asarray(u), jcfg,
                               bidirectional=bidirectional)
    with torch.no_grad():
        got = mixer(torch.from_numpy(u), bidirectional=bidirectional)
    _close(got, want)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_decode_matches_jax_and_the_causal_forward(kind):
    """Each step's output and every cache entry against the JAX
    ``*_decode``; the steps together against the causal forward."""
    jcfg, params, mixer = _mixer_pair(kind, seed=3)
    S = 12
    u = np.random.default_rng(4).standard_normal((2, S, 64)).astype(
        np.float32)
    jinit = (j_xlstm.mlstm_init_cache if kind == "mlstm"
             else j_xlstm.slstm_init_cache)
    jdecode = j_xlstm.mlstm_decode if kind == "mlstm" else \
        j_xlstm.slstm_decode
    jcache = jinit(jcfg, 2, jnp.float32)
    cache = mixer.init_cache(2, torch.float32)
    assert set(cache) == set(jcache)
    outs = []
    with torch.no_grad():
        for i in range(S):
            y, jcache = jdecode(params, jnp.asarray(u[:, i:i + 1]), jcache,
                                jcfg)
            got = mixer.decode(torch.from_numpy(u[:, i:i + 1]), cache)
            _close(got, y)
            for name in cache:
                _close(cache[name], jcache[name])
            outs.append(got)
        full = mixer(torch.from_numpy(u))
    _close(torch.cat(outs, 1), full)


def test_init_draws_and_shapes():
    """The JAX tree's names and shapes; r a truncated normal in
    +-2/sqrt(dh); wif at a tenth of the dense scale."""
    jcfg, tcfg = tiny(("mlstm", "slstm"), lstm_heads=4)
    jm = JModel(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = TModel(tcfg, device="cpu", seed=0)
    want = {k: v.shape for k, v in convert.to_state_dict(
        tree, jm.unit, jm.n_super).items()}
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == want
    dh = 64 // 4
    r = tm.blocks[1].mixer.r
    assert r.shape == (4, dh, 4 * dh)
    assert float(r.abs().max()) <= 2.0 / dh ** 0.5 + 1e-7
    assert float(tm.blocks[0].mixer.wif.abs().max()) <= 0.1 * 2 / 128 ** 0.5
    # one seed, one set of weights
    again = TModel(tcfg, device="cpu", seed=0)
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(),
                                                 again.parameters()))


def _model_pair(pattern, seed=0, **kw):
    jcfg, tcfg = tiny(pattern, **kw)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = TModel(tcfg, device="cpu", seed=1)
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [0, 8])
def test_tiny_xlstm_logits_match_jax(causal, chunk):
    """tests/test_models.py's ``tiny(("mlstm", "slstm"))``, both directions
    or causal, parallel or chunked, without the time embedding."""
    jm, params, tm = _model_pair(("mlstm", "slstm"), mlstm_chunk=chunk)
    tok = np.random.default_rng(5).integers(0, 50, (2, 20)).astype(np.int32)
    want, _ = jm.forward(params, jnp.asarray(tok), None, causal=causal)
    with torch.no_grad():
        got = tm(torch.from_numpy(tok), None, causal=causal)
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_tiny_xlstm_logits_with_time_match_float64_and_jax(causal):
    """With the time embedding: the port's f32 logits against its own
    float64 logits at the f32 bar, and against the JAX package's at the
    logits bar (see the module's docstring)."""
    jm, params, tm = _model_pair(("mlstm", "slstm"))
    rng = np.random.default_rng(7)
    tok = rng.integers(0, 50, (2, 20)).astype(np.int32)
    t = rng.random(2).astype(np.float32)
    want, _ = jm.forward(params, jnp.asarray(tok), jnp.asarray(t),
                         causal=causal)
    with torch.no_grad():
        got = tm(torch.from_numpy(tok), torch.from_numpy(t), causal=causal)
        exact = tm.double()(torch.from_numpy(tok),
                            torch.from_numpy(t).double(), causal=causal)
    _close(got, exact)
    _close(got, want, atol=3e-4, rtol=3e-3)


def test_reduced_xlstm_350m_logits_match_jax():
    """The registry's xlstm-350m at ``.reduced()`` (one mLSTM and one
    sLSTM block, d_model 256, 2 lstm heads) as a denoiser, without the
    time embedding."""
    jcfg = jconfigs.get("xlstm-350m").reduced(bidirectional=True)
    tcfg = tconfigs.get("xlstm-350m").reduced(bidirectional=True)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu", seed=1)
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    assert tm.param_count() == jm.param_count(params)
    tok = np.random.default_rng(6).integers(0, tcfg.vocab_size,
                                            (2, 40)).astype(np.int32)
    want, _ = jm.forward(params, jnp.asarray(tok), None, causal=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(tok), None, causal=False)
    _close(got, want)


def test_xlstm_tree_round_trips_bitwise():
    """JAX tree -> the port's state dict -> the JAX tree, every xLSTM leaf
    bitwise, with no leaf renamed or reshaped."""
    jm, params, tm = _model_pair(("mlstm", "slstm") * 2)
    tree = convert.flatten(jax.tree.map(np.asarray, params))
    back = convert.flatten(convert.to_jax_tree(
        dict(tm.named_parameters()), tm.unit, tm.n_super))
    assert set(back) == set(tree)
    assert any("mixer/r" in k for k in tree)
    for k, v in tree.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_full_xlstm_350m_counts_the_jax_packages_parameters():
    """508,171,264 at the published widths: the JAX package's count by
    ``eval_shape``, the port's from one block of each kind at full width
    (the whole model's 2 GB of weights are not made here)."""
    jcfg = jconfigs.get("xlstm-350m")
    jm = JModel(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert want == 508_171_264
    tcfg = tconfigs.get("xlstm-350m")
    g = torch.Generator().manual_seed(0)
    blocks = [t_xlstm.MLSTM(g, tcfg), t_xlstm.SLSTM(g, tcfg)]
    per = [sum(p.numel() for p in b.parameters()) + tcfg.d_model
           for b in blocks]                  # + each block's pre-norm
    d, V = tcfg.d_model, tcfg.vocab_size
    # embed, head, ln_f, the time embedding's two (d, d) weights
    total = 20 * per[0] + 4 * per[1] + 2 * V * d + d + 2 * d * d
    assert total == want
