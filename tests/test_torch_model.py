"""The port's denoiser vs the JAX package's, at reduced size on the CPU.

Weights cross through the bridge (``repro_torch.models.convert``) from
the JAX package's own checkpoint format and must arrive bitwise.  Logits
are then held at the JAX package's own bar for comparing attention
implementations (atol 3e-4, rtol 3e-3, tests/test_models.py): the two
frameworks run the same f32 arithmetic in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel
from repro.training import checkpoint as jckpt

import repro_torch.configs as tconfigs
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.model import Model as TModel
from repro_torch.training import checkpoint as tckpt

ATOL, RTOL = 3e-4, 3e-3


def _pair(arch: str, **kw):
    """(JAX model, JAX params, port model with the same weights)."""
    jcfg = jconfigs.get(arch).reduced(**kw)
    tcfg = tconfigs.get(arch).reduced(**kw)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu", seed=1)
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def test_checkpoint_bridge_is_bitwise(tmp_path):
    cfg = jconfigs.get("dndm-text8").reduced(n_layers=2,
                                             block_pattern=("attn",) * 2)
    params = JModel(cfg).init(jax.random.PRNGKey(0))
    path = str(tmp_path / "ckpt")
    jckpt.save(path, params)
    tm = TModel(tconfigs.get("dndm-text8").reduced(
        n_layers=2, block_pattern=("attn",) * 2), device="cpu", seed=7)
    convert.load_checkpoint(tm, path)

    flat = convert.flatten(tckpt.load(path))
    own = dict(tm.named_parameters())
    n_super = 2
    seen = set()
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "unit":
            for j in range(n_super):
                name = f"blocks.{j}.{'.'.join(parts[2:])}"
                np.testing.assert_array_equal(own[name].numpy(), arr[j])
                assert own[name].dtype == torch.float32
                seen.add(name)
        else:
            name = ".".join(parts)
            np.testing.assert_array_equal(own[name].numpy(), arr)
            seen.add(name)
    assert seen == set(own)
    # and the JAX arrays themselves (not just the file) arrived bitwise
    np.testing.assert_array_equal(
        own["blocks.1.attn.wq"].numpy(),
        np.asarray(params["unit"]["b0"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(own["embed"].numpy(),
                                  np.asarray(params["embed"]))


def test_checkpoint_restores_bfloat16(tmp_path):
    tree = {"a": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
            "b": {"c": np.ones(3, np.int32)}}
    jckpt.save(str(tmp_path / "c"), tree)
    back = tckpt.load(str(tmp_path / "c"))
    assert back["a"].dtype == torch.bfloat16
    assert back["a"].float().tolist() == [[0, 1, 2], [3, 4, 5]]
    np.testing.assert_array_equal(back["b"]["c"], np.ones(3, np.int32))


def test_bridge_rejects_a_mismatched_tree():
    _, params, tm = _pair("dndm-text8")
    tree = jax.tree.map(np.asarray, params)
    del tree["head"]
    with pytest.raises(KeyError):
        convert.load_params(tm, tree)
    tree = jax.tree.map(np.asarray, params)
    tree["embed"] = tree["embed"][:, :-1]
    with pytest.raises(ValueError):
        convert.load_params(tm, tree)


@pytest.mark.parametrize("impl", ["einsum", "blocked", "pallas"])
def test_text8_logits_match_jax(impl):
    jm, params, tm = _pair("dndm-text8", attn_impl=impl, attn_block_q=16,
                           attn_block_k=16)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 28, (2, 40)).astype(np.int32)
    t = rng.random(2).astype(np.float32)
    want, _ = jm.forward(params, jnp.asarray(tok), jnp.asarray(t),
                         causal=False)
    got = tm(torch.from_numpy(tok), torch.from_numpy(t), causal=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_mt_prefix_logits_match_jax():
    """dndm-mt with a source prefix: [prefix | x_t], target logits only."""
    jm, params, tm = _pair("dndm-mt", attn_impl="pallas", attn_block_q=16,
                           attn_block_k=16)
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, 27, (2, 12)).astype(np.int32)
    x_t = rng.integers(0, 28, (2, 20)).astype(np.int32)
    t = np.asarray([0.25, 0.75], np.float32)
    want = jm.denoise_fn(params)(jnp.asarray(x_t), jnp.asarray(t),
                                 {"prefix_tokens": jnp.asarray(prefix)})
    got = tm.denoise_fn()(torch.from_numpy(x_t), torch.from_numpy(t),
                          {"prefix_tokens": torch.from_numpy(prefix)})
    assert got.shape == (2, 20, 28)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
@pytest.mark.parametrize("kind,causal", [("attn", True), ("swa", True),
                                         ("swa", False)])
def test_block_kinds_match_jax(kind, causal, mlp_type):
    """Causal and sliding-window attention, both MLP types, grouped kv
    heads, no time conditioning."""
    base = dict(name="t", arch_type="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=50,
                block_pattern=(kind,) * 2, sliding_window=6,
                mlp_type=mlp_type, time_conditioning=False,
                attn_impl="pallas", attn_block_q=8, attn_block_k=8)
    jm = JModel(JConfig(**base))
    params = jm.init(jax.random.PRNGKey(3))
    tm = TModel(TConfig(**base), device="cpu")
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    tok = np.random.default_rng(2).integers(0, 50, (2, 24)).astype(np.int32)
    want, _ = jm.forward(params, jnp.asarray(tok), None, causal=causal)
    got = tm(torch.from_numpy(tok), None, causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_seeded_init_is_reproducible_and_scaled():
    cfg = tconfigs.get("dndm-text8").reduced()
    a, b = TModel(cfg, device="cpu", seed=3), TModel(cfg, device="cpu",
                                                       seed=3)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    w = a.blocks[0].attn.wq
    # truncated normal on [-2, 2] scaled by 1 / sqrt(d_in)
    assert w.abs().max() <= 2.0 / cfg.d_model ** 0.5 + 1e-7
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 0.88) < 0.02
