"""The port against the JAX package's golden trajectories and its small
remainders (``dndm.sample_scan``, ``transition.expected_nfe_mc``,
``NoiseDist.probs``), on the CPU.

``tests/golden/trajectories.json`` holds four generations of the
one-layer model of ``tests/test_golden.py`` (``PRNGKey(0)`` weights),
each drawn under ``PRNGKey(42)``: their tokens, NFE and, for the planned
methods, the call times of a batch-of-one plan.  The port replays them
with the same weights, bridged by ``convert.load_params``, and the JAX
package's draws recomputed from its key discipline (``loop.setup``
splits the key into (tau, x_T, loop); the loop key splits into one key
per network call; ``rdm`` and ``ddim`` split each call key into (sel,
other)).  NFE, call times and tokens are held bitwise, the logits at
rtol 1e-5 / atol 1e-5.  The fixture is read, never written.

One token set is not bitwise, and by a float near-tie, not a fault:
``dndm_topk``'s row 0 at its call at t = 4 reveals one token by score,
and positions 0, 5, 6 and 7 score -0.8123100 within one f32 ulp
(2.4e-7) of each other.  The JAX package ranks position 0 first, the
port position 5, whose logits differ from JAX's by 1e-6; the rows part
from there.  Row 1 is held bitwise, and row 0 is held on the fixture's
own trajectory (``test_golden_dndm_topk_row_0_parts_at_a_near_tie``).

The fixture was recorded under jax 0.4.37, whose threefry streams were
not yet "partitionable" (the default changed in jax 0.5): the weights
and draws are recomputed with ``jax.threefry_partitionable(False)``,
under which the JAX package itself reproduces the fixture.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as jnoise
from repro.core import schedules as jsched
from repro.core import transition as jtrans
from repro.core.samplers import SamplerConfig as JSamplerConfig
from repro.core.samplers import dndm as jdndm
from repro.models import Model as JModel
from repro.models import ModelConfig as JModelConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import GenerationEngine as JEngine

from repro_torch.core import noise as tnoise
from repro_torch.core import schedules as tsched
from repro_torch.core import transition as ttrans
from repro_torch.core.samplers import SamplerConfig as TSamplerConfig
from repro_torch.core.samplers import dndm as tdndm
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.model import Model as TModel
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import GenerationEngine as TEngine

GOLDEN = pathlib.Path(__file__).parent / "golden" / "trajectories.json"
VOCAB, SEQ, STEPS, BATCH = 12, 8, 6, 2
# tests/test_golden.py's model and cases
MODEL = dict(name="golden", arch_type="dense", n_layers=1, d_model=32,
             n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=VOCAB,
             block_pattern=("attn",), bidirectional=True)
CASES = [("dndm", "absorbing"), ("dndm_topk", "absorbing"),
         ("rdm", "absorbing"), ("ddim", "multinomial")]
ENGINE = dict(steps=STEPS, shared_tau=False, ddim_stride=2)


def _n_calls(method, rt, tau):
    if method in ("dndm", "dndm_topk"):
        return len(np.unique(tau))
    if method == "ddim":
        return len(range(rt.steps, 0, -rt.ddim_stride))
    return rt.steps                                       # rdm


def jax_draws(method, key, rt, batch):
    """(tau, x_T, gumbels, uniforms) as the JAX samplers draw them."""
    k_tau, k_x, k_loop = jax.random.split(key, 3)
    tau = None
    if method.startswith("dndm"):
        tau = np.asarray(jtrans.sample_transition_times(
            k_tau, rt.dist, batch, SEQ, order=rt.order,
            shared=rt.shared_tau))
    x = np.asarray(rt.noise.sample(k_x, (batch, SEQ))).astype(np.int32)
    split = method in ("rdm", "ddim")
    gumbels = [] if rt.cfg.x0_mode == "sample" else None
    uniforms = [] if split else None
    for k in jax.random.split(k_loop, _n_calls(method, rt, tau)):
        k_sel, k_other = jax.random.split(k) if split else (k, None)
        if gumbels is not None:
            gumbels.append(np.asarray(jax.random.gumbel(
                k_sel, (batch, SEQ, VOCAB), jnp.float32)))
        if uniforms is not None:
            uniforms.append(np.asarray(jax.random.uniform(
                k_other, (batch, SEQ), jnp.float32)))
    return tau, x, gumbels, uniforms


# the fixture's random streams (see the module docstring)
RECORDED_STREAMS = jax.threefry_partitionable(False)


@pytest.fixture(scope="module")
def models():
    jm = JModel(JModelConfig(**MODEL))
    with RECORDED_STREAMS:
        params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(TModelConfig(**MODEL), device="cpu", seed=1)
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def test_golden_logits_match_jax(models):
    """The bridged one-layer model: logits of both frameworks on the same
    noisy tokens and times, at rtol 1e-5 / atol 1e-5."""
    jm, params, tm = models
    rng = np.random.default_rng(0)
    tok = rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    t = np.array([1 / STEPS, 5 / STEPS], np.float32)
    want, _ = jm.forward(params, jnp.asarray(tok), jnp.asarray(t),
                         causal=False)
    with torch.inference_mode():
        got = tm(torch.from_numpy(tok), torch.from_numpy(t), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("method,kind", CASES)
def test_golden_trajectories_replay_in_the_port(models, method, kind):
    jm, params, tm = models
    want = json.loads(GOLDEN.read_text())
    assert want["config"] == {"vocab": VOCAB, "seq": SEQ, "steps": STEPS,
                              "batch": BATCH}
    entry = want["trajectories"][method]
    engine_method = "dndm" if kind == "absorbing" else "ddim"
    rt = JEngine(jm, params, JEngineConfig(
        method=engine_method, noise_kind=kind, **ENGINE)).runtime()
    teng = TEngine(tm, TEngineConfig(method=engine_method, noise_kind=kind,
                                     **ENGINE), device="cpu")
    key = jax.random.PRNGKey(42)
    with RECORDED_STREAMS:
        draws = jax_draws(method, key, rt, BATCH)
        tau, x, _, _ = jax_draws(method, key, rt, 1)
    out, _ = teng.generate(0, BATCH, SEQ, method=method, draws=draws)
    assert out.nfe == entry["nfe"]
    rows = NEAR_TIE_FREE_ROWS.get(method, range(BATCH))
    assert [out.tokens.tolist()[r] for r in rows] == [
        entry["tokens"][r] for r in rows]
    if "call_times" in entry:
        plan = teng.plan_request(0, SEQ, method, draws=(tau, x, None, None))
        assert np.asarray(plan.times).tolist() == entry["call_times"]


# dndm_topk's row 0 parts from the fixture at a near-tie (module docstring)
NEAR_TIE_FREE_ROWS = {"dndm_topk": [1]}


def test_golden_dndm_topk_row_0_parts_at_a_near_tie(models):
    """dndm_topk on the fixture's own trajectory, call by call: the port's
    decode of the JAX package's state gives the same tokens and scores
    within 1e-6, and the same reveal set but at one call, row 0 at t = 4,
    where the scores at the set's boundary lie within 1e-6; following the
    JAX package's reveals ends on the fixture's tokens."""
    from repro.core.decode import decode_tokens as j_decode_tokens
    from repro_torch.core import decode as tdecode
    from repro_torch.core.samplers import loop as tloop
    jm, params, tm = models
    want = json.loads(GOLDEN.read_text())["trajectories"]["dndm_topk"]
    rt = JEngine(jm, params, JEngineConfig(method="dndm", **ENGINE)).runtime()
    with RECORDED_STREAMS:
        tau, x, gumbels, _ = jax_draws("dndm_topk", jax.random.PRNGKey(42),
                                       rt, BATCH)
    fn = jax.jit(jm.denoise_fn(params))
    tnz = tnoise.absorbing(VOCAB)
    revealed = torch.zeros((BATCH, SEQ), dtype=torch.bool)
    x, tau_t = torch.from_numpy(x), torch.from_numpy(np.array(tau))
    flips = []
    for i, t in enumerate(np.unique(tau)[::-1]):
        t_norm = np.full((BATCH,), np.float32(t) / np.float32(STEPS))
        jtok, jscore = j_decode_tokens(
            None, fn(jnp.asarray(x.numpy()), jnp.asarray(t_norm), None),
            rt.noise, rt.cfg, gumbel=jnp.asarray(gumbels[i]))
        with torch.inference_mode():
            ttok, tscore = tdecode.decode_tokens(
                tm(x, torch.from_numpy(t_norm), causal=False), tnz,
                TSamplerConfig(),
                gumbel=torch.from_numpy(np.array(gumbels[i])))
        jtok, jscore = (torch.from_numpy(np.array(jtok)),
                        torch.from_numpy(np.array(jscore)))
        assert torch.equal(ttok, jtok)
        np.testing.assert_allclose(tscore.numpy(), jscore.numpy(), rtol=0,
                                   atol=1e-6)
        k = (tau_t >= t).sum(-1)
        x_j, rev_j = tloop.reveal_topk(x, jtok, jscore, revealed, k)
        _, rev_t = tloop.reveal_topk(x, ttok, tscore, revealed, k)
        for b in range(BATCH):
            if torch.equal(rev_t[b], rev_j[b]):
                continue
            s = jscore[b][~revealed[b]].sort(descending=True).values
            n_new = int(k[b] - revealed[b].sum())
            assert s[n_new - 1] - s[n_new] <= 1e-6, (b, t)
            flips.append((b, int(t)))
        x, revealed = x_j, rev_j
    assert x.tolist() == want["tokens"]
    assert flips == [(0, 4)]


# ------------------------------------------------------------ sample_scan

K, B, N, T = 24, 4, 16, 40


def j_oracle(x_t, t, cond):
    """Integer-valued logits in [0, 11): both frameworks compute them
    exactly, with many ties (tests/test_torch_slice.py's oracle)."""
    k = jnp.arange(K, dtype=jnp.int32)
    n = jnp.arange(x_t.shape[1], dtype=jnp.int32)
    tt = jnp.round(t * T).astype(jnp.int32)
    v = (x_t[..., None] * 3 + k * 7 + n[None, :, None] * 5
         + tt[:, None, None]) % 11
    return v.astype(jnp.float32)


def t_oracle(x_t, t, cond):
    k = torch.arange(K, dtype=torch.int32)
    n = torch.arange(x_t.shape[1], dtype=torch.int32)
    tt = torch.round(t * T).to(torch.int32)
    v = (x_t[..., None] * 3 + k * 7 + n[None, :, None] * 5
         + tt[:, None, None]) % 11
    return v.to(torch.float32)


def _scan_draws(key, dist, noise, shared):
    """The JAX ``sample_scan``'s draws: its loop key splits into one key
    per step t = T .. 1, and a step that calls the network draws its
    Gumbel slab from its own key; one slab per call, in call order."""
    k_tau, k_x, k_loop = jax.random.split(key, 3)
    tau = np.asarray(jtrans.sample_transition_times(
        k_tau, dist, B, N, order="iid", shared=shared))
    x = np.asarray(noise.sample(k_x, (B, N))).astype(np.int32)
    keys = jax.random.split(k_loop, dist.T)
    gumbels = [np.asarray(jax.random.gumbel(keys[dist.T - t], (B, N, K),
                                            jnp.float32))
               for t in range(dist.T, 0, -1) if (tau == t).any()]
    return tau, x, gumbels, None


@pytest.mark.parametrize("kind,version,shared", [
    ("absorbing", 1, True), ("absorbing", 2, False),
    ("multinomial", 1, False)])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_scan_matches_jax_under_replayed_draws(kind, version, shared,
                                                      seed):
    jd = jtrans.from_schedule(jsched.linear(T))
    td = ttrans.from_schedule(tsched.linear(T))
    jn, tn = jnoise.get(kind, K), tnoise.get(kind, K)
    key = jax.random.PRNGKey(seed)
    want = jdndm.sample_scan(key, j_oracle, jn, jd, B, N,
                             cfg=JSamplerConfig(x0_mode="sample"),
                             version=version, shared_tau=shared)
    got = tdndm.sample_scan(None, t_oracle, tn, td, B, N,
                            cfg=TSamplerConfig(x0_mode="sample"),
                            version=version, shared_tau=shared,
                            device="cpu",
                            draws=_scan_draws(key, jd, jn, shared))
    assert got.nfe == want.nfe
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))


@pytest.mark.parametrize("kind,version", [("absorbing", 1),
                                          ("absorbing", 2),
                                          ("multinomial", 1)])
def test_sample_scan_equals_sample(kind, version):
    """The fully-stepped form and Algorithm 1's host loop: equal tokens and
    NFE from the same generator seed (a step without a call draws
    nothing) and under the same injected draws."""
    td = ttrans.from_schedule(tsched.linear(T))
    tn = tnoise.get(kind, K)
    cfg = TSamplerConfig(x0_mode="sample")
    kw = dict(cfg=cfg, version=version, shared_tau=False, device="cpu")
    a = tdndm.sample(torch.Generator().manual_seed(3), t_oracle, tn, td, B,
                     N, **kw)
    b = tdndm.sample_scan(torch.Generator().manual_seed(3), t_oracle, tn, td,
                          B, N, **kw)
    assert a.nfe == b.nfe == len(np.unique(a.aux["tau"].numpy()))
    assert torch.equal(a.tokens, b.tokens)
    jd = jtrans.from_schedule(jsched.linear(T))
    draws = _scan_draws(jax.random.PRNGKey(7), jd, jnoise.get(kind, K), False)
    a = tdndm.sample(None, t_oracle, tn, td, B, N, draws=draws, **kw)
    b = tdndm.sample_scan(None, t_oracle, tn, td, B, N, draws=draws, **kw)
    assert a.nfe == b.nfe
    assert torch.equal(a.tokens, b.tokens)


# ------------------------------------------------------------ the helpers

@pytest.mark.parametrize("law", ["linear", "beta"])
def test_expected_nfe_mc_matches_thm_d1(law):
    """Monte-Carlo E|T| within 3% of Theorem D.1's closed form, the bar of
    tests/test_schedules.py::test_thm_d1_expected_nfe."""
    Tn, Nn = 50, 16
    dist = (ttrans.from_schedule(tsched.linear(Tn)) if law == "linear"
            else ttrans.beta_approx(Tn, 5.0, 3.0))
    want = dist.expected_nfe(Nn)
    got = ttrans.expected_nfe_mc(dist, Nn, 4000,
                                 torch.Generator().manual_seed(0))
    assert abs(got - want) / want < 0.03, (dist.name, got, want)
    assert 1 <= want <= min(Nn, Tn)


@pytest.mark.parametrize("kind", ["absorbing", "multinomial"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noise_probs_match_jax(kind, dtype):
    want = np.asarray(jnoise.get(kind, 28).probs(getattr(jnp, dtype)),
                      np.float32)
    got = tnoise.get(kind, 28).probs(getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (28,)
    np.testing.assert_array_equal(got.float().numpy(), want)
