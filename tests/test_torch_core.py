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
from repro.core import noise as jnoise
from repro.core import schedules as jsched
from repro.core import transition as jtrans
from repro.core.samplers import dndm as jdndm
from repro.models import config as jconfig

import repro_torch.configs as tconfigs
from repro_torch.core import noise as tnoise
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
    assert tconfigs.list_archs() == ["dndm-text8", "dndm-mt"]
    with pytest.raises(KeyError):
        tconfigs.get("mixtral-8x7b")


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
