"""The port's config registry and model zoo against the JAX package's, on
the CPU.

Every registered config equals the JAX package's field by field (and so
do its reduced and long-context variants and the input shapes).  Every
assigned architecture gives the JAX package's logits at
``.reduced(bidirectional=True)`` through the weight bridge, at the
logits bar of tests/test_torch_model.py (atol 3e-4, rtol 3e-3); the
audio and vision configs get the same numpy frontend embeddings on both
sides.  Each also serves a request through the serving CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import frontend as jfrontend
from repro.models.model import Model as JModel

import repro_torch.configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import frontend as tfrontend
from repro_torch.models.model import Model as TModel

ATOL, RTOL = 3e-4, 3e-3
BUILT = list(jconfigs.ASSIGNED_ARCHS)


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_registered_config_equals_the_jax_packages(arch):
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.superblock() == j.superblock()
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert (dataclasses.asdict(tconfigs.for_long_context(t))
            == dataclasses.asdict(jconfigs.for_long_context(j)))


def test_registry_constants_and_shapes_equal_the_jax_packages():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert tconfigs.LONG_CONTEXT_WINDOW == jconfigs.LONG_CONTEXT_WINDOW
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in jconfigs.SHAPES.items():
        assert (dataclasses.asdict(tconfigs.shapes.get(name))
                == dataclasses.asdict(shape))


def _embeds(cfg, batch: int, seed: int = 3):
    if not cfg.frontend:
        return None
    return (np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)


@pytest.mark.parametrize("arch", BUILT)
def test_reduced_logits_match_jax(arch):
    jcfg = jconfigs.get(arch).reduced(bidirectional=True)
    tcfg = tconfigs.get(arch).reduced(bidirectional=True)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu", seed=1)
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(4)
    tok = rng.integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    t = rng.random(2).astype(np.float32)
    fe = _embeds(tcfg, 2)
    want, want_aux = jm.forward(params, jnp.asarray(tok), jnp.asarray(t),
                                None if fe is None else jnp.asarray(fe),
                                causal=False)
    with torch.no_grad():
        got, got_aux = tm(torch.from_numpy(tok), torch.from_numpy(t),
                          None if fe is None else torch.from_numpy(fe),
                          causal=False, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    for k in want_aux:
        np.testing.assert_allclose(float(got_aux[k]), float(want_aux[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    if fe is not None:
        # and the denoiser adapter passes the embeddings through
        den = tm.denoise_fn({"frontend_embeds": torch.from_numpy(fe)})
        with torch.no_grad():
            assert torch.equal(den(torch.from_numpy(tok),
                                   torch.from_numpy(t), None), got)


def test_fuse_matches_jax():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 10, 16)).astype(np.float32)
    fe = rng.standard_normal((2, 3, 16)).astype(np.float32)
    want = jfrontend.fuse(jnp.asarray(h), jnp.asarray(fe))
    got = tfrontend.fuse(torch.from_numpy(h), torch.from_numpy(fe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tfrontend.fuse(torch.from_numpy(h), None).numpy(), h)


@pytest.mark.parametrize("arch", ["musicgen-large", "chameleon-34b"])
def test_fake_frontend_embeds_feed_the_model(arch):
    """The stub's embeddings: (batch, F, d) in the config's dtype, a
    standard normal times 0.02, reproducible from the generator; the
    model's logits depend on them; a config without a frontend gets
    None."""
    cfg = tconfigs.get(arch).reduced(bidirectional=True)
    fe = tfrontend.fake_frontend_embeds(torch.Generator().manual_seed(0),
                                        cfg, 64, "cpu")
    assert fe.shape == (64, cfg.frontend_tokens, cfg.d_model)
    assert fe.dtype == torch.float32
    assert abs(float(fe.std()) - 0.02) < 1e-3
    assert torch.equal(fe, tfrontend.fake_frontend_embeds(
        torch.Generator().manual_seed(0), cfg, 64, "cpu"))
    assert tfrontend.fake_frontend_embeds(
        torch.Generator(), tconfigs.get("dndm-text8"), 2, "cpu") is None
    tm = TModel(cfg, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = tm(tok, None, fe[:2], causal=False)
        fe2 = fe[:2].clone()
        fe2[0, 0] += 1.0
        b = tm(tok, None, fe2, causal=False)
    assert float((a - b).abs().max()) > 1e-6
    assert a.shape == (2, 12, cfg.vocab_size)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-maverick-400b-a17b",
                                  "tinyllama-1.1b"])
def test_param_counts_match_jax(arch):
    jcfg = jconfigs.get(arch).reduced(n_layers=2, block_pattern=(
        jconfigs.get(arch).block_pattern[0],) * 2)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tconfigs.get(arch).reduced(n_layers=2, block_pattern=(
        jcfg.block_pattern[0],) * 2), device="cpu")
    assert tm.param_count() == jm.param_count(params)
    assert tm.active_param_count() == jm.active_param_count(params)
    if jcfg.n_experts:
        assert tm.active_param_count() < tm.param_count()


@pytest.mark.parametrize("arch", BUILT)
def test_serve_cli_serves_every_built_arch(arch):
    """``launch/serve.py --arch <id> --reduced --device cpu``: every
    request done, in vocabulary, no [MASK] left."""
    done = tserve.main(["--arch", arch, "--reduced", "--requests", "2",
                        "--max-batch", "2", "--len", "16", "--steps", "10",
                        "--method", "dndm", "--device", "cpu"])
    vocab = tconfigs.get(arch).reduced().vocab_size
    assert len(done) == 2
    for r in done.values():
        assert r.result.shape == (16,)
        assert ((r.result >= 0) & (r.result < vocab - 1)).all()
