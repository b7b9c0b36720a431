"""The port's mixture-of-experts MLP (``repro_torch.models.moe``) against
``repro.models.moe``, on the CPU at the sizes of tests/test_models.py.

Weights cross through the bridge (``convert.load_tree`` for one layer,
``convert.load_params`` for a model) and inputs come from a numpy seed.
Routing is compared exactly: each token's experts, and the sorted
assignments' tokens, slots and ``keep``.  Floats are held at 1e-5 for
one layer's output, 1e-6 for its aux losses, and at the logits bar of
tests/test_torch_model.py (atol 3e-4, rtol 3e-3) for whole models: the
frameworks run the same f32 arithmetic in different orders.  The MoE
laws of tests/test_models.py are held on the port's own layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import noise as jnoise
from repro.core import schedules as jschedules
from repro.data import DataConfig, DataPipeline
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel
from repro.training import optim as joptim
from repro.training import trainer as jtrainer

import repro_torch.configs as tconfigs
from repro_torch.core import noise as tnoise
from repro_torch.core import schedules as tschedules
from repro_torch.models import convert
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.model import Model as TModel
from repro_torch.training import optim as toptim
from repro_torch.training import trainer as ttrainer

Y_TOL, AUX_TOL = 1e-5, 1e-6
ATOL, RTOL = 3e-4, 3e-3
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-6       # tests/test_torch_training.py


def tiny(**kw):
    """tests/test_models.py's tiny MoE config, for both packages."""
    base = dict(name="t", arch_type="moe", n_layers=1, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=50,
                block_pattern=("moe",), n_experts=4, experts_per_token=2)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def layer_pair(seed: int = 0, **kw):
    """(JAX config, JAX params, the port's config, its layer with the same
    weights)."""
    jcfg, tcfg = tiny(**kw)
    params = jmoe.init(jax.random.PRNGKey(seed), jcfg)
    layer = tmoe.MoE(torch.Generator().manual_seed(1), tcfg)
    convert.load_tree(layer, jax.tree.map(np.asarray, params))
    return jcfg, params, tcfg, layer


def groups_of(cfg, T: int) -> int:
    G = cfg.moe_local_groups
    return G if cfg.moe_dispatch == "local" and G > 1 and T % G == 0 else 1


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dispatch", ["global", "local", "shard_map"])
@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_moe_layer_matches_jax(mlp_type, dispatch, capacity_factor):
    """Routing exactly, y within 1e-5, the aux losses within 1e-6.  At
    capacity factor 0.5 tokens are dropped; "shard_map" without a mesh
    is the global dispatch in both packages."""
    jcfg, params, tcfg, layer = layer_pair(
        mlp_type=mlp_type, moe_dispatch=dispatch, moe_local_groups=4,
        capacity_factor=capacity_factor)
    x = np.random.default_rng(0).standard_normal((2, 64, 64)).astype(
        np.float32)
    want, want_aux = jmoe.apply(params, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, got_aux = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=Y_TOL,
                               rtol=Y_TOL)
    assert sorted(got_aux) == sorted(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(float(got_aux[k]), float(want_aux[k]),
                                   atol=AUX_TOL, rtol=AUX_TOL, err_msg=k)
    if capacity_factor < 1:
        assert float(got_aux["dropped_frac"]) > 0

    # routing: per group, each token's experts and the sorted assignments
    T = x.shape[0] * x.shape[1]
    G = groups_of(tcfg, T)
    C = tmoe.capacity(tcfg, T // G)
    assert C == jmoe.capacity(jcfg, T // G)
    xg = x.reshape(G, T // G, 64)
    with torch.no_grad():
        _, state, _ = layer.route(torch.from_numpy(xg), C)
    for g in range(G):
        xt = jnp.asarray(xg[g])
        probs = jax.nn.softmax((xt @ params["router"]).astype(jnp.float32))
        np.testing.assert_array_equal(
            state["expert_idx"][g].numpy(),
            np.asarray(jax.lax.top_k(probs, jcfg.experts_per_token)[1]))
        _, jstate, _ = jmoe._route(params, xt, jcfg, C)
        for k in ("st", "keep", "slot"):
            np.testing.assert_array_equal(state[k][g].numpy(),
                                          np.asarray(jstate[k]), err_msg=k)


@pytest.mark.parametrize("K", [1, 2])
def test_zero_router_ties_pick_the_lowest_experts(K):
    """All E probabilities equal: experts 0..K-1 for every token, as
    ``jax.lax.top_k`` picks them (``torch.topk`` does not promise so)."""
    jcfg, params, tcfg, layer = layer_pair(experts_per_token=K)
    params = {**params, "router": jnp.zeros_like(params["router"])}
    with torch.no_grad():
        layer.router.zero_()
    x = np.random.default_rng(3).standard_normal((1, 12, 64)).astype(
        np.float32)
    with torch.no_grad():
        _, state, _ = layer.route(torch.from_numpy(x), 8)
        got, _ = layer(torch.from_numpy(x))
    assert (state["expert_idx"][0] == torch.arange(K)).all()
    _, jstate, _ = jmoe._route(params, jnp.asarray(x[0]), jcfg, 8)
    for k in ("st", "keep", "slot"):
        np.testing.assert_array_equal(state[k][0].numpy(),
                                      np.asarray(jstate[k]), err_msg=k)
    want, _ = jmoe.apply(params, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=Y_TOL,
                               rtol=Y_TOL)


def test_moe_dispatch_is_weighted_permutation():
    """With ample capacity, the output is the dense per-token mix of every
    token's top-k experts by their normalized gates."""
    _, _, tcfg, layer = layer_pair(capacity_factor=16.0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 6, 64)).astype(np.float32))
    with torch.no_grad():
        y, aux = layer(x)
        xt = x.reshape(-1, 64)
        probs = torch.softmax(xt @ layer.router, -1)
        gv, ei = torch.sort(probs, dim=-1, descending=True, stable=True)
        gv, ei = gv[:, :2], ei[:, :2]
        gv = gv / gv.sum(-1, keepdim=True)
        act = (torch.nn.functional.silu(torch.einsum("td,edf->tef", xt,
                                                     layer.gate))
               * torch.einsum("td,edf->tef", xt, layer.up))
        out_all = torch.einsum("tef,efd->ted", act, layer.down)
        ref = sum(out_all[torch.arange(len(xt)), ei[:, k]] * gv[:, k, None]
                  for k in range(2))
    assert float(aux["dropped_frac"]) == 0.0
    np.testing.assert_allclose(y.reshape(-1, 64).numpy(), ref.numpy(),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("seed", range(8))
def test_moe_never_nan(seed):
    _, _, _, layer = layer_pair(seed)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, 8, 64)).astype(np.float32) * 3)
    with torch.no_grad():
        y, aux = layer(x)
    assert torch.isfinite(y).all()
    assert 0 <= float(aux["dropped_frac"]) <= 1


def test_moe_local_dispatch_matches_global():
    """Per-group dispatch == global dispatch with ample capacity."""
    _, _, tcfg, layer = layer_pair(capacity_factor=16.0, moe_local_groups=4)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 16, 64)).astype(np.float32))
    with torch.no_grad():
        yg, _ = layer(x)
        layer.cfg = tcfg.replace(moe_dispatch="local")
        yl, al = layer(x)
    np.testing.assert_allclose(yg.numpy(), yl.numpy(), atol=1e-5, rtol=1e-5)
    assert float(al["dropped_frac"]) == 0.0


def model_pair(arch: str, **kw):
    """(JAX model, its params, the port's model with the same weights)."""
    jcfg = jconfigs.get(arch).reduced(bidirectional=True, **kw)
    tcfg = tconfigs.get(arch).reduced(bidirectional=True, **kw)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu", seed=1)
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("arch", ["mixtral-8x7b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_model_logits_and_aux_match_jax(arch):
    """Reduced mixtral (SWA + top-2, across its 32-token window) and
    llama4 (top-1): logits at the logits bar, aux sums at 1e-6."""
    jm, params, tm = model_pair(arch)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    t = rng.random(2).astype(np.float32)
    want, want_aux = jm.forward(params, jnp.asarray(tok), jnp.asarray(t),
                                causal=False)
    with torch.no_grad():
        got, got_aux = tm(torch.from_numpy(tok), torch.from_numpy(t),
                          causal=False, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert sorted(got_aux) == sorted(want_aux)
    for k in want_aux:
        assert got_aux[k].dtype == torch.float32
        np.testing.assert_allclose(float(got_aux[k]), float(want_aux[k]),
                                   atol=AUX_TOL, rtol=AUX_TOL, err_msg=k)
        assert float(got_aux[k]) > 0


def _jax_draws(key, shape, jsch, jnz):
    """The draws of ``repro.core.forward.corrupt_for_training`` under
    ``key`` (tests/test_torch_training.py's discipline)."""
    k_t, k_x = jax.random.split(key)
    t = jax.random.randint(k_t, shape[:1], 1, jsch.T + 1)
    k_keep, k_noise = jax.random.split(k_x)
    u = jax.random.uniform(k_keep, shape, jnp.float32)
    w = jnz.sample(k_noise, shape)
    return {"t": np.array(t), "u": np.array(u), "w": np.array(w)}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "musicgen-large"])
def test_train_step_matches_jax(arch):
    """One train step at reduced size (vocab 28) on the JAX draws: the
    loss, its CE and load_balance at tests/test_torch_training.py's f32
    bar.  Mixtral's MoE aux terms enter the loss; musicgen's batch
    carries frontend embeddings, which the step feeds the model."""
    jm, params, tm = model_pair(arch, vocab_size=28)
    jsch, tsch = jschedules.linear(50), tschedules.linear(50)
    jnz, tnz = jnoise.get("absorbing", 28), tnoise.get("absorbing", 28)
    jopt = joptim.AdamW(schedule=joptim.warmup_cosine(3e-4, 20, 100))
    topt = toptim.AdamW(schedule=toptim.warmup_cosine(3e-4, 20, 100))
    jstep = jax.jit(jtrainer.make_train_step(jm, jsch, jnz, jopt))
    tstep = ttrainer.make_train_step(tm, tsch, tnz, topt)
    batch = next(iter(DataPipeline(DataConfig(
        task="unconditional", vocab=27, seq_len=16, batch=4, seed=1))))
    cfg = tm.cfg
    if cfg.frontend:
        batch["frontend_embeds"] = (np.random.default_rng(2).standard_normal(
            (4, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    key = jax.random.PRNGKey(9)
    _, jmet = jstep({"params": params, "opt": jopt.init(params),
                     "step": jnp.zeros((), jnp.int32)},
                    {k: jnp.asarray(v) for k, v in batch.items()}, key)
    _, tmet = tstep(ttrainer.init_state(tm, topt),
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    None, draws=[_jax_draws(key, batch["x0"].shape, jsch,
                                            jnz)])
    assert (float(tmet["load_balance"]) > 0) == bool(cfg.n_experts)
    for k in ("loss", "ce", "load_balance"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=k)


def test_moe_leaves_round_trip_bitwise():
    """JAX tree -> the port's state -> ``to_jax_tree``: every MoE leaf
    (router, gate, up, down of each superblock) comes back bitwise."""
    jm, params, tm = model_pair("mixtral-8x7b", n_layers=2,
                                block_pattern=("moe",) * 2)
    back = convert.flatten(convert.to_jax_tree(
        dict(tm.named_parameters()), tm.unit, tm.n_super))
    want = convert.flatten(jax.tree.map(np.asarray, params))
    assert sorted(back) == sorted(want)
    moe_keys = [k for k in want if "/moe/" in k]
    assert sorted(k.rsplit("/", 1)[1] for k in moe_keys) == [
        "down", "gate", "router", "up"]
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), want[k], err_msg=k)
    assert tuple(tm.blocks[1].moe.up.shape) == (4, 256, 512)


@pytest.mark.cuda
def test_moe_layer_on_the_card_matches_the_cpu():
    """One reduced MoE layer on the card against the same layer on the
    CPU: routing equal, y within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, tcfg, layer = layer_pair(capacity_factor=1.0)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 64, 64)).astype(np.float32))
    C = tmoe.capacity(tcfg, x.shape[0] * x.shape[1])
    with torch.no_grad():
        y_cpu, aux_cpu = layer(x)
        _, s_cpu, _ = layer.route(x.reshape(1, -1, 64), C)
        layer.cuda()
        y_gpu, aux_gpu = layer(x.cuda())
        _, s_gpu, _ = layer.route(x.reshape(1, -1, 64).cuda(), C)
    for k in ("expert_idx", "st", "keep", "slot"):
        assert torch.equal(s_gpu[k].cpu(), s_cpu[k]), k
    np.testing.assert_allclose(y_gpu.cpu().numpy(), y_cpu.numpy(),
                               atol=Y_TOL, rtol=Y_TOL)
    for k in aux_cpu:
        np.testing.assert_allclose(float(aux_gpu[k]), float(aux_cpu[k]),
                                   atol=AUX_TOL, rtol=AUX_TOL, err_msg=k)
