"""Port vs JAX package: configs, schedules, transition laws, noise.

Everything here is numpy on both sides, so it is held bitwise; the
port's own torch draws are held to the analytic laws with the
statistical bars of tests/test_distribution.py (chi-square at dof + 4 sd)
and tests/test_samplers.py (mean NFE within 5% of Theorem D.1).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import jax
import jax.numpy as jnp

from repro.core import noise as jnoise
from repro.core import posterior as jpost
from repro.core import schedules as jsched
from repro.core import transition as jtrans
from repro.core.samplers import dndm as jdndm
from repro.models import config as jconfig

import repro_torch.configs as tconfigs
from repro_torch.core import noise as tnoise
from repro_torch.core import posterior as tpost
from repro_torch.core import schedules as tsched
from repro_torch.core import transition as ttrans
from repro_torch.core.samplers import dndm as tdndm
from repro_torch.models import config as tconfig


def test_model_config_fields_and_defaults_match():
    jf = {f.name: (f.type, f.default) for f in
          dataclasses.fields(jconfig.ModelConfig)}
    tf = {f.name: (f.type, f.default) for f in
          dataclasses.fields(tconfig.ModelConfig)}
    assert jf == tf


@pytest.mark.parametrize("arch", ["dndm-text8", "dndm-mt"])
def test_paper_configs_match(arch):
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.superblock() == t.superblock()
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert j.hd == t.hd


def test_config_registry_has_only_the_paper_models():
    # the JAX package's registry, id for id and in its order: the paper's
    # two models and the ten assigned architectures
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    with pytest.raises(KeyError):
        tconfigs.get("no-such-arch")


@pytest.mark.parametrize("name", ["linear", "cosine", "cosine_sq"])
@pytest.mark.parametrize("T", [10, 50, 1000])
def test_schedules_bitwise(name, T):
    j, t = jsched.get(name, T), tsched.get(name, T)
    np.testing.assert_array_equal(j.alphas, t.alphas)
    np.testing.assert_array_equal(j.betas, t.betas)
    np.testing.assert_array_equal(j.transition_probs(), t.transition_probs())
    # the continuous alpha(t) runs in f32 on both sides (JAX without x64);
    # cos is a different implementation in each, so ulps may differ
    grid = np.linspace(0, 1, 17, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(j.alpha_fn(grid)), t.alpha_fn(torch.from_numpy(grid)),
        rtol=1e-6, atol=1e-6)


def test_from_alpha_fn_matches():
    """Both discretize in f32 (JAX runs without x64)."""
    j = jsched.from_alpha_fn("sq", 40, lambda t: (1 - t) ** 2)
    t = tsched.from_alpha_fn("sq", 40, lambda t: (1 - t) ** 2)
    np.testing.assert_array_equal(j.alphas, t.alphas)


@pytest.mark.parametrize("T,a,b", [(50, 15.0, 7.0), (1000, 3.0, 3.0),
                                   (40, 0.5, 2.0)])
def test_beta_approx_bitwise(T, a, b):
    j, t = jtrans.beta_approx(T, a, b), ttrans.beta_approx(T, a, b)
    np.testing.assert_array_equal(j.probs, t.probs)
    assert j.name == t.name and j.beta_params == t.beta_params
    x = np.linspace(0, 1, 33)
    np.testing.assert_array_equal(jtrans._beta_cdf(x, a, b),
                                  ttrans._beta_cdf(x, a, b))


@pytest.mark.parametrize("T,N", [(50, 16), (1000, 256)])
def test_from_schedule_and_expected_nfe_match(T, N):
    j = jtrans.from_schedule(jsched.linear(T))
    t = ttrans.from_schedule(tsched.linear(T))
    np.testing.assert_array_equal(j.probs, t.probs)
    assert j.expected_nfe(N) == t.expected_nfe(N)


@pytest.mark.parametrize("budget", [1, 4, 25, 200])
@pytest.mark.parametrize("law", ["linear", "beta"])
def test_quantile_grid_bitwise(budget, law):
    if law == "linear":
        jd = jtrans.from_schedule(jsched.linear(100))
        td = ttrans.from_schedule(tsched.linear(100))
    else:
        jd, td = jtrans.beta_approx(100, 15, 7), ttrans.beta_approx(100, 15, 7)
    jg, tg = jdndm.quantile_grid(jd, budget), tdndm.quantile_grid(td, budget)
    np.testing.assert_array_equal(jg, tg)
    assert jg.dtype == tg.dtype


@pytest.mark.parametrize("kind", ["absorbing", "multinomial"])
def test_noise_mask_and_pad_match(kind):
    j, t = jnoise.get(kind, 28), tnoise.get(kind, 28)
    assert (j.kind, j.vocab_size, j.mask_id) == (t.kind, t.vocab_size,
                                                 t.mask_id)
    assert j.pad_id == t.pad_id
    np.testing.assert_array_equal(np.asarray(j.logit_mask()),
                                  t.logit_mask().numpy())
    g = torch.Generator().manual_seed(0)
    x = t.sample(g, (3, 5))
    assert x.dtype == torch.int32 and x.shape == (3, 5)
    if kind == "absorbing":
        assert (x == t.mask_id).all()
        assert t.logit_mask()[t.mask_id].item() == np.float32(-1e9)
    else:
        assert ((x >= 0) & (x < 28)).all()


def _chi_square(counts, expected, min_expected=8.0):
    """Pearson statistic with small-expectation bins pooled, as in
    tests/test_distribution.py."""
    stat, dof, o_acc, e_acc = 0.0, 0, 0.0, 0.0
    for o, e in zip(counts, expected):
        o_acc += o
        e_acc += e
        if e_acc >= min_expected:
            stat += (o_acc - e_acc) ** 2 / e_acc
            dof += 1
            o_acc = e_acc = 0.0
    if e_acc > 0:
        stat += (o_acc - e_acc) ** 2 / max(e_acc, min_expected)
        dof += 1
    return stat, dof - 1


@pytest.mark.parametrize("law", ["thm36_linear", "thm36_cosine",
                                 "beta15_7"])
def test_torch_tau_marginal_chi_square(law):
    """The port's torch.multinomial draw reproduces D_tau: chi-square
    below dof + 4 sd (false alarm ~3e-5 were the seed free)."""
    n = 20_000
    if law == "beta15_7":
        T = 40
        dist = ttrans.beta_approx(T, 15.0, 7.0)
        expected = np.diff(ttrans._beta_cdf(np.arange(T + 1) / T, 15.0, 7.0))
    else:
        T = 50
        sch = tsched.linear(T) if law == "thm36_linear" else tsched.cosine(T)
        dist = ttrans.from_schedule(sch)
        expected = dist.probs
    tau = dist.sample(torch.Generator().manual_seed(0), (n,)).numpy()
    assert tau.dtype == np.int32
    assert tau.min() >= 1 and tau.max() <= T
    counts = np.bincount(tau, minlength=T + 1)[1:].astype(float)
    stat, dof = _chi_square(counts, n * expected)
    assert stat < dof + 4 * np.sqrt(2 * dof), (stat, dof)


@pytest.mark.parametrize("T,N", [(40, 16), (1000, 256)])
def test_torch_mean_nfe_matches_thm_d1(T, N):
    """Average per-row NFE of the port's draws ~ E|T| (Theorem D.1)."""
    dist = ttrans.from_schedule(tsched.linear(T))
    tau = ttrans.sample_transition_times(torch.Generator().manual_seed(3),
                                         dist, 2000, N)
    got = float(ttrans.nfe_of(tau, T).float().mean())
    want = dist.expected_nfe(N)
    assert abs(got - want) / want < 0.05


@pytest.mark.parametrize("order", ["iid", "l2r", "r2l"])
@pytest.mark.parametrize("shared", [False, True])
def test_sample_transition_times_layout(order, shared):
    dist = ttrans.from_schedule(tsched.linear(30))
    tau = ttrans.sample_transition_times(torch.Generator().manual_seed(1),
                                         dist, 4, 12, order=order,
                                         shared=shared)
    assert tau.shape == (4, 12) and tau.dtype == torch.int32
    assert tau.is_contiguous()
    if shared:
        assert (tau == tau[:1]).all()
    if order == "l2r":
        assert (tau[:, :-1] >= tau[:, 1:]).all()
    if order == "r2l":
        assert (tau[:, :-1] <= tau[:, 1:]).all()
    # nfe_of == the number of distinct values per row
    want = [len(np.unique(r)) for r in tau.numpy()]
    assert ttrans.nfe_of(tau, 30).tolist() == want


def _ks(x: np.ndarray, cdf) -> float:
    """Kolmogorov-Smirnov distance of a sample from a CDF."""
    x = np.sort(x)
    n = len(x)
    F = cdf(x)
    hi = np.arange(1, n + 1) / n
    return max(np.abs(hi - F).max(), np.abs(F - (hi - 1 / n)).max())


@pytest.mark.parametrize("a,b", [(15.0, 7.0), (17.0, 4.0), (0.5, 0.7)])
def test_continuous_beta_ks(a, b):
    """DNDM-C timestamps ~ Beta(a, b) on (0, 1], drawn from a generator
    by Marsaglia-Tsang gamma variates (shape < 1 included); the bar of
    tests/test_distribution.py::test_continuous_beta_ks."""
    n = 4_000
    cdist = ttrans.beta_continuous(a, b)
    x = cdist.sample_continuous(torch.Generator().manual_seed(2),
                                (n,)).numpy()
    assert x.dtype == np.float32 and (x > 0).all() and (x <= 1).all()
    ks = _ks(x, lambda v: ttrans._beta_cdf(v, a, b))
    assert ks < 2.22 / np.sqrt(n) + 2e-3, ks


def test_continuous_from_discrete_law_ks():
    """A probs-backed law: a bin by its probabilities, then a uniform
    jitter within it — the CDF interpolates cumsum(probs) linearly at the
    bin edges t/T (tests/test_distribution.py's bar)."""
    T, n = 50, 4_000
    dist = ttrans.from_schedule(tsched.cosine(T))
    x = dist.sample_continuous(torch.Generator().manual_seed(3),
                               (n,)).numpy()
    knots = np.concatenate([[0.0], np.cumsum(dist.probs)])
    ks = _ks(x, lambda v: np.interp(v, np.arange(T + 1) / T, knots))
    assert ks < 2.22 / np.sqrt(n) + 2e-3, ks


@pytest.mark.parametrize("order", ["iid", "l2r"])
@pytest.mark.parametrize("shared", [False, True])
def test_continuous_transition_times_layout(order, shared):
    tau = ttrans.sample_transition_times(
        torch.Generator().manual_seed(1), ttrans.beta_continuous(17, 4), 3,
        10, order=order, shared=shared, continuous=True)
    assert tau.shape == (3, 10) and tau.dtype == torch.float32
    assert tau.is_contiguous()
    if shared:
        assert (tau == tau[:1]).all()
    if order == "l2r":
        assert (tau[:, :-1] >= tau[:, 1:]).all()


def test_transition_mask_per_step_matches_jax():
    T = 12
    tau = np.random.default_rng(0).integers(1, T + 1, (5, 9)).astype(
        np.int32)
    want = np.asarray(jtrans.transition_mask_per_step(jnp.asarray(tau), T))
    got = ttrans.transition_mask_per_step(torch.from_numpy(tau), T)
    assert got.shape == (T, 5) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ttrans.nfe_of(torch.from_numpy(tau),
                                                T).numpy(),
                                  np.asarray(jtrans.nfe_of(jnp.asarray(tau),
                                                           T)))


@pytest.mark.parametrize("kind", ["absorbing", "multinomial"])
def test_posterior_matches_jax(kind):
    """Same numpy inputs through both posteriors: allclose at 1e-6 (f32
    softmax-scale products; the op order is the reference's)."""
    K, B, N = 11, 3, 7
    rng = np.random.default_rng(4)
    x_t = rng.integers(0, K, (B, N)).astype(np.int32)
    x_t[:, ::2] = K - 1                     # masked positions (absorbing)
    logits = rng.standard_normal((B, N, K)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    for t in (1, 5, 9):
        a = tsched.cosine(10).alphas.astype(np.float32)
        a_tm1 = np.full((B, 1), a[t - 1], np.float32)
        a_t = np.full((B, 1), a[t], np.float32)
        want = np.asarray(jpost.posterior(
            jnp.asarray(x_t), jnp.asarray(probs), jnp.asarray(a_tm1),
            jnp.asarray(a_t), jnoise.get(kind, K)))
        got = tpost.posterior(
            torch.from_numpy(x_t), torch.from_numpy(probs),
            torch.from_numpy(a_tm1), torch.from_numpy(a_t),
            tnoise.get(kind, K))
        assert got.dtype == torch.float32 and got.shape == (B, N, K)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
