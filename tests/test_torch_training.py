"""The port's training slice against the JAX package, on the CPU at
reduced size (2 layers, d_model 64).

torch cannot replay threefry, so every comparison that draws feeds the
port the JAX package's own draws, recomputed from its key discipline
(``_jax_draws``): the tokens that come out are then bitwise equal.  Bars
are f32 ``rtol 1e-5 / atol 1e-6`` unless a test states another.
Gradients sum in another order through a whole backward pass: the port's
f32 gradients are held to its own f64 ones at ``rtol 1e-4 / atol 1e-6``,
and to ``jax.grad`` at ``rtol 1e-4`` with ``atol`` 1e-4 of the leaf's
largest gradient, the bar at which JAX's own f32 gradients are held to
the port's f64 ones: the scaled atol is the reference's rounding on the
CPU, not the port's.  The port's own draws are held to the paper's laws,
as the JAX package's tests hold its own.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import data as jdata
from repro.core import forward as jforward
from repro.core import losses as jlosses
from repro.core import noise as jnoise
from repro.core import schedules as jschedules
from repro.launch import train as jtrain
from repro.models.model import Model as JModel
from repro.training import checkpoint as jckpt
from repro.training import optim as joptim
from repro.training import trainer as jtrainer

import repro_torch.configs as tconfigs
from repro_torch import data as tdata
from repro_torch.core import forward as tforward
from repro_torch.core import losses as tlosses
from repro_torch.core import noise as tnoise
from repro_torch.core import schedules as tschedules
from repro_torch.kernels.decode_scores import ops as k3_ops
from repro_torch.kernels.dndm_update import ops as k1_ops
from repro_torch.kernels.flash_attention import ops as k2_ops
from repro_torch.kernels.ssd_scan import ops as k4_ops
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models.model import Model as TModel
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optim as toptim
from repro_torch.training import trainer as ttrainer

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
GRAD_SCALE_ATOL = 1e-4         # x the leaf's largest |gradient|, vs JAX
SMALL = dict(n_layers=2, block_pattern=("attn",) * 2, d_model=64, d_ff=128)
# the other families at the same width: a reduced zamba2-2.7b (two
# Mamba-2 blocks, each followed by the shared attention), an xLSTM with
# both cell kinds, and a mixture of experts (4 experts, top 2).  The
# xLSTM runs without the time embedding, as tests/test_torch_xlstm.py
# holds it: XLA's f32 sin/cos at t x 1000 rad move the JAX package's
# grad_norm 4e-6 off its float64 value there, where the port's stays
# within 1e-7
FAMILIES = {
    "zamba2-2.7b": dict(n_layers=4, block_pattern=("mamba2", "shared_attn")
                        * 2, vocab_size=28),
    "xlstm-350m": dict(block_pattern=("mlstm", "slstm"), vocab_size=28,
                       time_conditioning=False),
    "mixtral-8x7b": dict(block_pattern=("moe",) * 2, vocab_size=28),
}
T = 50


def _cfgs(arch: str, **kw):
    kw = {**SMALL, **kw}
    return jconfigs.get(arch).reduced(**kw), tconfigs.get(arch).reduced(**kw)


def _pair(arch: str = "dndm-text8", **kw):
    """(JAX model, its params, the port's model with the same weights)."""
    jcfg, tcfg = _cfgs(arch, **{**FAMILIES.get(arch, {}), **kw})
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu", seed=1)
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _noises(kind: str, V: int):
    return jnoise.get(kind, V), tnoise.get(kind, V)


def _jax_draws(key, shape, jsch, jnz, continuous: bool = False, t=None):
    """The draws of ``corrupt_for_training`` / ``corrupt_continuous`` under
    ``key``: {"t", "u", "w"} as numpy.  ``jax.random.bernoulli`` keeps a
    token iff a uniform of ``alpha_t``'s dtype is below it; the test that
    feeds these checks that law against JAX's own x_t."""
    k_t, k_x = jax.random.split(key)
    if t is None:
        t = (jax.random.uniform(k_t, shape[:1]) if continuous else
             jax.random.randint(k_t, shape[:1], 1, jsch.T + 1))
    k_keep, k_noise = jax.random.split(k_x)
    u = jax.random.uniform(k_keep, shape, jnp.float32)
    w = jnz.sample(k_noise, shape)
    return {"t": np.array(t), "u": np.array(u), "w": np.array(w)}


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got: dict, want: dict, rtol=RTOL, atol=ATOL,
                        scale_atol: float = 0.0):
    """Nested dicts with the same keys; leaves allclose (torch or numpy),
    ``atol`` raised to ``scale_atol`` x the leaf's largest |value|."""
    g, w = convert.flatten(got), convert.flatten(_tree_np(want))
    assert sorted(g) == sorted(w)
    for k in w:
        a = g[k].detach().numpy() if isinstance(g[k], torch.Tensor) else g[k]
        tol = max(atol, scale_atol * float(np.abs(w[k]).max(initial=0)))
        np.testing.assert_allclose(a, w[k], rtol=rtol, atol=tol, err_msg=k)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("task", ["unconditional", "translation"])
def test_data_pipeline_batches_are_bitwise(task):
    kw = dict(task=task, vocab=27, seq_len=24, src_len=16, batch=4, seed=3)
    jp = jdata.DataPipeline(jdata.DataConfig(**kw))
    tp = tdata.DataPipeline(tdata.DataConfig(**kw))
    for jb, tb in zip(list(zip(range(3), jp)), list(zip(range(3), tp))):
        assert sorted(jb[1]) == sorted(tb[1])
        for k in jb[1]:
            assert jb[1][k].dtype == tb[1][k].dtype
            np.testing.assert_array_equal(jb[1][k], tb[1][k])
    for jb, tb in zip(jp.eval_batches(2), tp.eval_batches(2)):
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])


def test_data_oracles_are_the_jax_packages():
    """MarkovLanguage's table and log-likelihood, TranslationTask's pairs,
    the cipher with words reversed, BLEU and the tokenizers."""
    rng = np.random.default_rng(0)
    jl, tl = jdata.MarkovLanguage(27, seed=5), tdata.MarkovLanguage(27, seed=5)
    np.testing.assert_array_equal(jl.table, tl.table)
    seq = rng.integers(0, 28, (3, 40))        # 27 = [MASK], out of alphabet
    assert jl.log_likelihood(seq) == tl.log_likelihood(seq)
    jt = jdata.TranslationTask(27, seed=2, reverse_words=True)
    tt = tdata.TranslationTask(27, seed=2, reverse_words=True)
    for a, b in zip(jt.sample_pairs(np.random.default_rng(1), 3, 30),
                    tt.sample_pairs(np.random.default_rng(1), 3, 30)):
        np.testing.assert_array_equal(a, b)
    hyp, ref = rng.integers(0, 5, (4, 20)), rng.integers(0, 5, (4, 20))
    assert jdata.bleu(hyp, ref) == tdata.bleu(hyp, ref)
    text = "the quick brown fox, 42"
    np.testing.assert_array_equal(jdata.CharTokenizer().encode(text),
                                  tdata.CharTokenizer().encode(text))
    np.testing.assert_array_equal(jdata.ByteTokenizer().encode(text),
                                  tdata.ByteTokenizer().encode(text))


# ------------------------------------------------------------ corruption

@pytest.mark.parametrize("kind", ["absorbing", "multinomial"])
@pytest.mark.parametrize("continuous", [False, True])
def test_replayed_corruption_is_bitwise(kind, continuous):
    jsch, tsch = jschedules.cosine(T), tschedules.cosine(T)
    jnz, tnz = _noises(kind, 28)
    x0 = np.random.default_rng(0).integers(0, 27, (6, 33)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    fn = jforward.corrupt_continuous if continuous else (
        jforward.corrupt_for_training)
    jx, jt, ja = fn(key, jnp.asarray(x0), jsch, jnz)
    d = _jax_draws(key, x0.shape, jsch, jnz, continuous)
    # the law the replay rests on: bernoulli(p) == uniform < p
    np.testing.assert_array_equal(
        np.asarray(jx), np.where(d["u"] < np.asarray(ja)[:, None], x0, d["w"]))
    tfn = tforward.corrupt_continuous if continuous else (
        tforward.corrupt_for_training)
    tx, tt, ta = tfn(None, torch.from_numpy(x0), tsch, tnz, draws=d)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL,
                               atol=ATOL)
    if not continuous:
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("seed,T_", [(0, 2), (1, 9), (2, 30)])
def test_own_corruption_marginal(seed, T_):
    """x_t == x0 with frequency alpha_t + (1 - alpha_t) / K for
    multinomial noise: the law and bar of
    tests/test_core_math.py::test_corruption_marginal_property."""
    K = 12
    gen = torch.Generator().manual_seed(seed)
    sch = tschedules.linear(T_)
    x0 = torch.zeros((5000,), dtype=torch.int32)
    t = torch.full((5000,), T_ // 2 + 1)
    x_t, _, alpha = tforward.corrupt_for_training(
        gen, x0, sch, tnoise.multinomial(K), t=t)
    frac = float((x_t == 0).float().mean())
    expect = float(alpha[0] + (1 - alpha[0]) / K)
    assert abs(frac - expect) < 0.04


def _chi_square(counts: np.ndarray, expected: np.ndarray) -> tuple[float, int]:
    """Pearson statistic and its degrees of freedom (every expected count
    is large here)."""
    return float(((counts - expected) ** 2 / expected).sum()), len(counts) - 1


def test_own_trajectories_share_marginals():
    """Thm 3.1 on the port's draws: the non-Markov (eq. 6) and Markov
    (eq. 1) trajectories have the marginal alpha_t x0 + (1 - alpha_t) / K,
    at the bars of tests/test_schedules.py (0.01 on P(x_t == x0), 0.015
    between histograms) and by a chi-square against the analytic law,
    accepted up to dof + 4 sd (tests/test_distribution.py).  Each token
    flips at most once along a non-Markov trajectory (eq. 7)."""
    T_, K, n = 10, 8, 30_000
    sch = tschedules.linear(T_)
    nz = tnoise.multinomial(K)
    gen = torch.Generator().manual_seed(0)
    x0 = torch.zeros((n,), dtype=torch.int32)
    nm = tforward.non_markov_trajectory(gen, x0, sch, nz).numpy()
    mk = tforward.markov_trajectory(gen, x0, sch, nz).numpy()
    assert nm.shape == mk.shape == (T_ + 1, n)
    for t in (3, 7, 10):
        a = sch.alphas[t]
        law = np.full(K, (1 - a) / K)
        law[0] += a
        hists = []
        for traj in (nm, mk):
            counts = np.bincount(traj[t], minlength=K)
            assert abs(counts[0] / n - law[0]) < 0.01
            stat, dof = _chi_square(counts, n * law)
            assert stat < dof + 4 * np.sqrt(2 * dof), (t, stat)
            hists.append(counts / n)
        np.testing.assert_allclose(hists[0], hists[1], atol=0.015)
    flips = (nm[1:] != nm[:-1]).sum(0)
    assert flips.max() <= 1


# ----------------------------------------------------------------- losses

def _apply_fns(jm):
    def japply(p, x, t, c):
        return jm.forward(p, x, t, causal=False)[0]

    def tapply(m, x, t, c):
        return m(x, t, causal=False)
    return japply, tapply


@pytest.mark.parametrize("kind", ["absorbing", "multinomial"])
@pytest.mark.parametrize("continuous", [False, True])
def test_reparam_ce_loss_matches_jax(kind, continuous):
    jm, params, tm = _pair()
    jsch, tsch = jschedules.linear(T), tschedules.linear(T)
    jnz, tnz = _noises(kind, 28)
    x0 = np.random.default_rng(2).integers(0, 27, (4, 24)).astype(np.int32)
    key = jax.random.PRNGKey(5)
    japply, tapply = _apply_fns(jm)
    _, jmet = jlosses.reparam_ce_loss(key, japply, params, jnp.asarray(x0),
                                       jsch, jnz, continuous_time=continuous)
    d = _jax_draws(key, x0.shape, jsch, jnz, continuous)
    with torch.no_grad():
        _, tmet = tlosses.reparam_ce_loss(
            None, tapply, tm, torch.from_numpy(x0), tsch, tnz,
            continuous_time=continuous, draws=d)
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kind", ["absorbing", "multinomial"])
def test_elbo_loss_matches_jax(kind):
    jm, params, tm = _pair()
    jsch, tsch = jschedules.cosine(T), tschedules.cosine(T)
    jnz, tnz = _noises(kind, 28)
    x0 = np.random.default_rng(3).integers(0, 27, (4, 24)).astype(np.int32)
    key = jax.random.PRNGKey(8)
    japply, tapply = _apply_fns(jm)
    _, jmet = jlosses.elbo_loss(key, japply, params, jnp.asarray(x0), jsch,
                                 jnz)
    k_c, k_t = jax.random.split(key)
    t = jax.random.randint(k_t, (4,), 1, T + 1)
    d = _jax_draws(k_c, x0.shape, jsch, jnz, t=t)
    with torch.no_grad():
        _, tmet = tlosses.elbo_loss(None, tapply, tm, torch.from_numpy(x0),
                                     tsch, tnz, draws=d)
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("arch,continuous", [
    ("dndm-text8", False), ("dndm-text8", True), ("zamba2-2.7b", False),
    ("xlstm-350m", False), ("mixtral-8x7b", False)],
    ids=["False", "True", "zamba2", "xlstm", "moe"])
def test_gradients_match_jax_grad(arch, continuous):
    """Every leaf's gradient of the RDM loss, through ``to_jax_tree``:
    against the port's f64 gradients at rtol 1e-4 / atol 1e-6, against
    ``jax.grad`` at rtol 1e-4 / atol 1e-4 of the leaf's scale.  Every
    family: zamba2's Mamba-2 blocks differentiate the plain chunked scan
    (24 tokens cross its chunk of 16), as the reference's model does."""
    jm, params, tm = _pair(arch)
    jsch, tsch = jschedules.linear(T), tschedules.linear(T)
    jnz, tnz = _noises("absorbing", 28)
    x0 = np.random.default_rng(4).integers(0, 27, (4, 24)).astype(np.int32)
    key = jax.random.PRNGKey(6)
    japply, tapply = _apply_fns(jm)
    jgrads = jax.grad(lambda p: jlosses.reparam_ce_loss(
        key, japply, p, jnp.asarray(x0), jsch, jnz,
        continuous_time=continuous)[0])(params)
    d = _jax_draws(key, x0.shape, jsch, jnz, continuous)

    def grads(model):
        named = dict(model.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        loss, _ = tlosses.reparam_ce_loss(
            None, tapply, model, torch.from_numpy(x0), tsch, tnz,
            continuous_time=continuous, draws=d)
        g = torch.autograd.grad(loss, list(named.values()))
        return convert.to_jax_tree(dict(zip(named, g)), model.unit,
                                   model.n_super)
    tgrads = grads(tm)
    f64 = jax.tree.map(lambda g: g.numpy(), grads(tm.double()))
    _assert_trees_close(tgrads, f64, GRAD_RTOL, GRAD_ATOL)
    _assert_trees_close(_tree_np(jgrads), f64, GRAD_RTOL,
                        scale_atol=GRAD_SCALE_ATOL)
    _assert_trees_close(tgrads, jgrads, GRAD_RTOL,
                        scale_atol=GRAD_SCALE_ATOL)


# ------------------------------------------------------------- optimizer

def _step_draws(key, batch, jsch, jnz, microbatches, continuous):
    """The draws of one JAX train step under ``key``, per microbatch."""
    x0 = batch["x0"]
    mb = x0.shape[0] // microbatches
    keys = ([key] if microbatches == 1 else
            [jax.random.fold_in(key, i) for i in range(microbatches)])
    return [_jax_draws(k, (mb,) + x0.shape[1:], jsch, jnz, continuous)
            for k in keys]


# at most this share of the parameters may move off the f32 bar in a
# train step, each by no more than AdamW's largest move (below)
ILL_CONDITIONED_SHARE = 1e-4


def _assert_params_close(got: dict, want: dict, lr_sum: float):
    """Parameters after AdamW steps on the two frameworks' gradients.  An
    element whose gradient lies within the reference's rounding of zero
    gets u = g / (|g| + eps) of either sign, so it moves by up to lr
    either way: every element is held within 2 x the sum of the step's
    learning rates, and all but ILL_CONDITIONED_SHARE of them at the f32
    bar.  ``test_adamw_matches_jax_on_the_same_gradients`` holds every
    element at the f32 bar where the gradients are the same."""
    g, w = convert.flatten(got), convert.flatten(_tree_np(want))
    assert sorted(g) == sorted(w)
    off = total = 0
    for k in w:
        d = np.abs(g[k].detach().numpy() - w[k])
        bar = ATOL + RTOL * np.abs(w[k])
        assert (d <= bar + 2 * lr_sum).all(), k
        off += int((d > bar).sum())
        total += d.size
    assert off <= ILL_CONDITIONED_SHARE * total, (off, total)


@pytest.mark.parametrize("arch,microbatches,continuous", [
    ("dndm-text8", 1, False), ("dndm-text8", 2, False),
    ("dndm-text8", 1, True), ("dndm-mt", 2, False),
    ("zamba2-2.7b", 1, False), ("xlstm-350m", 1, False),
    ("mixtral-8x7b", 1, False)])
def test_train_steps_match_jax(arch, microbatches, continuous):
    """lr, grad_norm, the losses, mu and nu after each of 3 steps of
    ``make_train_step`` (dndm-mt with a source prefix) at the f32 bar,
    the parameters as ``_assert_params_close`` holds them; AdamW on the
    launcher's warmup_cosine(3e-4, 20, 100)."""
    _check_train_steps(arch, microbatches, continuous)


@pytest.mark.parametrize("arch,microbatches", [
    ("dndm-text8", 2), ("zamba2-2.7b", 1), ("mixtral-8x7b", 1)])
def test_remat_train_steps_match_jax(arch, microbatches):
    """With ``remat`` set in both packages (``jax.checkpoint`` of each
    superblock there, ``torch.utils.checkpoint`` here), 3 steps as
    :func:`test_train_steps_match_jax` holds them."""
    _check_train_steps(arch, microbatches, False, remat=True)


@pytest.mark.parametrize("arch", ["dndm-text8", "zamba2-2.7b", "xlstm-350m",
                                  "mixtral-8x7b"])
def test_remat_is_bitwise_and_saves_less(arch):
    """``remat`` recomputes each superblock in the backward: the loss and
    every gradient are bitwise those without it, and the forward saves
    fewer bytes for the backward (zamba2's superblock holds a Mamba-2
    block and a shared-attention site)."""
    x0 = torch.from_numpy(
        np.random.default_rng(4).integers(0, 27, (4, 24)).astype(np.int32))
    jsch, tsch = jschedules.linear(T), tschedules.linear(T)
    jnz, tnz = _noises("absorbing", 28)
    d = _jax_draws(jax.random.PRNGKey(6), tuple(x0.shape), jsch, jnz)
    out = {}
    for remat in (False, True):
        _, _, tm = _pair(arch, remat=remat)
        named = dict(tm.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = tlosses.reparam_ce_loss(
                None, lambda m, x, t, c: m(x, t, causal=False), tm, x0,
                tsch, tnz, draws=d)
        out[remat] = (loss, torch.autograd.grad(loss, list(named.values())),
                      saved[0])
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
    assert out[True][2] < out[False][2]


def _check_train_steps(arch, microbatches, continuous, **kw):
    jm, params, tm = _pair(arch, **kw)
    jsch, tsch = jschedules.linear(T), tschedules.linear(T)
    jnz, tnz = _noises("absorbing", 28)
    jopt = joptim.AdamW(schedule=joptim.warmup_cosine(3e-4, 20, 100))
    topt = toptim.AdamW(schedule=toptim.warmup_cosine(3e-4, 20, 100))
    jstep = jax.jit(jtrainer.make_train_step(
        jm, jsch, jnz, jopt, continuous_time=continuous,
        microbatches=microbatches))
    tstep = ttrainer.make_train_step(
        tm, tsch, tnz, topt, continuous_time=continuous,
        microbatches=microbatches)
    jstate = {"params": params, "opt": jopt.init(params),
              "step": jnp.zeros((), jnp.int32)}
    tstate = ttrainer.init_state(tm, topt)
    task = "translation" if arch == "dndm-mt" else "unconditional"
    pipe = jdata.DataPipeline(jdata.DataConfig(
        task=task, vocab=27, seq_len=16, batch=4, seed=1))
    lr_sum = 0.0
    for s, batch in zip(range(3), pipe):
        key = jax.random.fold_in(jax.random.PRNGKey(9), s)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, key)
        draws = _step_draws(key, batch, jsch, jnz, microbatches, continuous)
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, None,
                             draws=draws)
        assert tstate["step"] == int(jstate["step"]) == s + 1
        assert tstate["opt"]["step"] == int(jstate["opt"]["step"])
        for k in ("lr", "grad_norm", "loss", "ce", "load_balance"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        lr_sum += float(jmet["lr"])
        _assert_params_close(convert.to_jax_tree(tstate["params"], tm.unit,
                                                 tm.n_super),
                             jstate["params"], lr_sum)
        for part in ("mu", "nu"):
            _assert_trees_close(convert.to_jax_tree(
                tstate["opt"][part], tm.unit, tm.n_super),
                jstate["opt"][part])


def test_adamw_matches_jax_on_the_same_gradients():
    """Both optimizers fed the same gradients for 3 steps (a clipped one
    and unclipped ones): params, mu, nu, lr and grad_norm at the f32
    bar, every element."""
    jm, params, tm = _pair()
    jopt = joptim.AdamW(schedule=joptim.warmup_cosine(3e-4, 2, 10))
    topt = toptim.AdamW(schedule=toptim.warmup_cosine(3e-4, 2, 10))
    named = dict(tm.named_parameters())
    jstate, tstate = jopt.init(params), topt.init(named)
    jupdate = jax.jit(jopt.update)
    rng = np.random.default_rng(0)
    for s, scale in enumerate((1.0, 1e-3, 3e-3)):
        tgrads = {k: torch.from_numpy(
            (scale * rng.standard_normal(p.shape)).astype(np.float32))
            for k, p in named.items()}
        jgrads = jax.tree.map(lambda g: jnp.asarray(g.numpy()),
                              convert.to_jax_tree(tgrads, tm.unit,
                                                  tm.n_super))
        params, jstate, jmet = jupdate(jgrads, jstate, params)
        _, tstate, tmet = topt.update(tgrads, tstate, named)
        assert tstate["step"] == int(jstate["step"]) == s + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        _assert_trees_close(convert.to_jax_tree(named, tm.unit, tm.n_super),
                            params)
        for part in ("mu", "nu"):
            _assert_trees_close(convert.to_jax_tree(
                tstate[part], tm.unit, tm.n_super), jstate[part])


@pytest.mark.parametrize("arch", ["dndm-text8", "zamba2-2.7b"])
def test_weight_decay_mask_is_the_jax_packages(arch):
    """Zero gradients leave only the decay: a block's RMSNorm scales (and
    Mamba-2's vectors) are decayed, as JAX decays every leaf of rank 2 or
    more of its stacked tree; ``ln_f.scale`` and the shared block's norms
    are not.  Both optimizers give the same parameters."""
    if arch == "zamba2-2.7b":
        jcfg = jconfigs.get(arch).reduced()
        tcfg = tconfigs.get(arch).reduced()
        jm = JModel(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        tm = TModel(tcfg, device="cpu", seed=1)
        convert.load_params(tm, _tree_np(params))
    else:
        jm, params, tm = _pair(arch)
    # move every leaf off 1.0 / 0.0, so that a decay shows everywhere
    params = jax.tree.map(lambda p: p + 0.5, params)
    convert.load_params(tm, _tree_np(params))
    jopt = joptim.AdamW(schedule=joptim.constant(0.1), weight_decay=0.5)
    topt = toptim.AdamW(schedule=toptim.constant(0.1), weight_decay=0.5)
    jnew, _, _ = jax.jit(jopt.update)(jax.tree.map(jnp.zeros_like, params),
                                      jopt.init(params), params)
    named = {k: p.clone() for k, p in tm.named_parameters()}
    before = {k: p.clone() for k, p in named.items()}
    topt.update({k: torch.zeros_like(p) for k, p in named.items()},
                topt.init(named), named)
    _assert_trees_close(convert.to_jax_tree(named, tm.unit, tm.n_super),
                        jnew)
    decayed = {k for k in named if not torch.equal(named[k], before[k])}
    want = {k for k in named if k.startswith("blocks.") or named[k].dim() > 1}
    assert decayed == want
    assert "ln_f.scale" not in decayed
    assert {"blocks.0.ln1.scale", "blocks.1.ln2.scale"} <= decayed or (
        arch != "dndm-text8")
    if arch == "zamba2-2.7b":
        assert {"blocks.0.mixer.A_log", "blocks.0.mixer.D",
                "blocks.0.mixer.dt_bias", "blocks.0.mixer.conv_b",
                "blocks.0.ln.scale"} <= decayed
        assert "shared.ln1.scale" not in decayed


def test_adamw_schedules_match_jax():
    for jfn, tfn in ((joptim.warmup_cosine(3e-4, 20, 100),
                      toptim.warmup_cosine(3e-4, 20, 100)),
                     (joptim.constant(0.1), toptim.constant(0.1))):
        for s in (0, 1, 19, 20, 21, 57, 100, 140):
            assert float(tfn(s)) == float(jfn(jnp.asarray(s, jnp.int32)))


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("arch", ["dndm-text8", "zamba2-2.7b"])
def test_to_jax_tree_inverts_to_state_dict(arch):
    jcfg = jconfigs.get(arch).reduced(
        **(SMALL if arch == "dndm-text8" else {"n_layers": 4,
                                                "block_pattern": (
                                                    "mamba2", "shared_attn")
                                                * 2}))
    jm = JModel(jcfg)
    params = _tree_np(jm.init(jax.random.PRNGKey(2)))
    unit, n_super = jcfg.superblock()
    assert n_super == 2
    back = convert.to_jax_tree(convert.to_state_dict(params, unit, n_super),
                               unit, n_super)
    flat, want = convert.flatten(back), convert.flatten(params)
    assert sorted(flat) == sorted(want)
    if arch == "zamba2-2.7b":
        assert any(k.startswith("shared/") for k in want)
    for k in want:
        assert flat[k].numpy().dtype == want[k].dtype
        np.testing.assert_array_equal(flat[k].numpy(), want[k], err_msg=k)


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    """Port save -> repro.training.checkpoint.load: the keys, shapes and
    dtypes of repro's Model(cfg).init, every array bitwise the port's."""
    jcfg, tcfg = _cfgs("dndm-text8")
    tm = TModel(tcfg, device="cpu", seed=4)
    path = str(tmp_path / "port")
    convert.save_checkpoint(tm, path)
    back = convert.flatten(jckpt.load(path))
    shapes = convert.flatten(jax.eval_shape(JModel(jcfg).init,
                                            jax.random.PRNGKey(0)))
    assert sorted(back) == sorted(shapes)
    for k, s in shapes.items():
        assert back[k].shape == s.shape and back[k].dtype == s.dtype, k
    own = convert.to_state_dict(back, tm.unit, tm.n_super)
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(own[name].numpy(), p.numpy())


def test_jax_checkpoint_round_trips_through_the_port(tmp_path):
    """JAX save -> port load -> port save: the same manifest and bitwise
    the same arrays on disk, bf16 leaves and lists included."""
    params = JModel(_cfgs("dndm-text8")[0]).init(jax.random.PRNGKey(1))
    tree = {"params": params,
            "extra": [jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 7,
                      np.ones(3, np.int32)]}
    jckpt.save(str(tmp_path / "j"), tree)
    tckpt.save(str(tmp_path / "t.npz"), tckpt.load(str(tmp_path / "j")))
    with open(tmp_path / "j.json") as f, open(tmp_path / "t.json") as g:
        assert json.load(f) == json.load(g)
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_bfloat16_round_trips(tmp_path):
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    tckpt.save(str(tmp_path / "b"), {"w": x, "n": {"i": torch.arange(4)}})
    jback = jckpt.load(str(tmp_path / "b"))
    assert str(jback["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jback["w"], np.float32),
                                  x.float().numpy())
    assert jback["n"]["i"].dtype == np.int64
    tback = tckpt.load(str(tmp_path / "b"))
    assert tback["w"].dtype == torch.bfloat16
    assert torch.equal(tback["w"], x)


# ------------------------------------------------ trainer and launcher

def test_trainer_run_lowers_the_loss(tmp_path):
    """Trainer.run on the CPU: the loss of the last 5 steps is below that
    of the first 5; the checkpoint it writes loads bitwise through the
    bridge."""
    _, tcfg = _cfgs("dndm-text8")
    tm = TModel(tcfg, device="cpu", seed=0)
    path = str(tmp_path / "run")
    tr = ttrainer.Trainer(tm, tschedules.linear(T), tnoise.absorbing(28),
                          toptim.AdamW(toptim.warmup_cosine(3e-3, 5, 40)),
                          log_every=1, ckpt_path=path)
    pipe = tdata.DataPipeline(tdata.DataConfig(vocab=27, seq_len=32,
                                               batch=16))
    state, hist = tr.run(iter(pipe), 40, seed=0, verbose=False)
    assert len(hist) == 40 and state["step"] == 40
    losses = [h["loss"] for h in hist]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    fresh = TModel(tcfg, device="cpu", seed=9)
    convert.load_checkpoint(fresh, path)
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a.detach(), b), n


def test_model_aux_terms_are_zeros():
    _, tcfg = _cfgs("dndm-text8")
    tm = TModel(tcfg, device="cpu", seed=0)
    tok = torch.randint(0, 28, (2, 8), generator=torch.Generator())
    t = torch.rand(2, generator=torch.Generator())
    with torch.no_grad():
        logits, aux = tm(tok, t, return_aux=True)
        assert torch.equal(logits, tm(tok, t))
    assert sorted(aux) == ["load_balance", "router_z"]
    for v in aux.values():
        assert v.dtype == torch.float32 and v.dim() == 0 and float(v) == 0


def test_train_cli_runs_and_writes_a_jax_checkpoint(tmp_path, capsys):
    path = str(tmp_path / "cli")
    ttrain.main(["--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
                 "--device", "cpu", "--ckpt", path])
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "step    2 loss" in out
    cfg = jconfigs.get("dndm-text8").reduced()
    shapes = convert.flatten(jax.eval_shape(JModel(cfg).init,
                                            jax.random.PRNGKey(0)))
    back = convert.flatten(jckpt.load(path))
    assert {k: v.shape for k, v in back.items()} == {
        k: v.shape for k, v in shapes.items()}


def test_train_cli_trains_zamba2(capsys):
    """The reduced zamba2-2.7b (one Mamba-2 and one shared-attention
    block) trains through the plain chunked scan and ends on a finite
    loss."""
    ttrain.main(["--arch", "zamba2-2.7b", "--reduced", "--steps", "2",
                 "--batch", "2", "--seq", "32", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["0", "1"]
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)


def test_mamba2_scan_route_follows_autograd(monkeypatch):
    """The Mamba-2 block scans through the kernel's wrapper when autograd
    does not record (serving), and through the plain chunked scan when
    it does; the kernel is never skipped where it could serve."""
    from repro_torch.models import mamba2
    calls = []
    for mod, name in ((mamba2.ssd_ops, "ssd_scan"),
                      (mamba2.ssd_ref, "ssd_chunked")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    tm = _pair("zamba2-2.7b")[2]
    tok = torch.zeros((2, 20), dtype=torch.int32)
    t = torch.full((2,), 0.5)
    with torch.inference_mode():
        served = tm(tok, t, causal=False)
    # two blocks, both directions; on the CPU the wrapper itself runs the
    # plain scan, so each direction calls the wrapper, then the scan
    assert calls[::2] == ["ssd_scan"] * 4 and len(calls) == 8
    calls.clear()
    for p in tm.parameters():
        p.requires_grad_(True)
    trained = tm(tok, t, causal=False)
    assert calls == ["ssd_chunked"] * 4
    assert torch.equal(trained.detach(), served)


class _Parsed(Exception):
    pass


def _defaults(main, argv, monkeypatch):
    """The defaults of the parser that ``main`` builds, caught at
    ``parse_args`` before it runs anything."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen.update({a.dest: a.default for a in self._actions
                     if a.dest != "help"})
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        main(*argv)
    return seen


def test_train_cli_defaults_match_jax(monkeypatch):
    jdef = _defaults(jtrain.main, (), monkeypatch)
    tdef = _defaults(ttrain.main, ([],), monkeypatch)
    shared = sorted(set(jdef) & set(tdef))
    assert {"arch", "reduced", "steps", "batch", "seq", "T", "lr",
            "ckpt"} <= set(shared)
    assert {k: tdef[k] for k in shared} == {k: jdef[k] for k in shared}
    assert set(jdef) - set(tdef) == set()
    assert set(tdef) - set(jdef) == {"device"}


# --------------------------------------- the kernels take no gradient

def _kernel_calls(device):
    """Each wrapper on a small input that requires a gradient: (name,
    call, the same call's inputs)."""
    g = torch.Generator(device=device).manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=device)
    logits = r(2, 8, 28)
    x = torch.zeros((2, 8), dtype=torch.int32, device=device)
    tau = torch.ones_like(x)
    q, k, v = r(1, 16, 2, 16), r(1, 16, 2, 16), r(1, 16, 2, 16)
    xs, dtv = r(1, 16, 2, 4), torch.rand(1, 16, 2, generator=g,
                                         device=device)
    A, Bm, Cm = -torch.rand(2, generator=g, device=device), r(1, 16, 4), \
        r(1, 16, 4)
    return {
        "dndm_update": (lambda a: k1_ops.dndm_update(a[0], x, tau, 1),
                        [logits]),
        "decode_scores": (lambda a: k3_ops.decode_scores(a[0]), [logits]),
        "flash_attention": (lambda a: k2_ops.flash_attention(*a),
                            [q, k, v]),
        "flash_decode": (lambda a: k2_ops.flash_decode(*a, pos=19,
                                                       window=0),
                         [q[:, :1], k, v]),
        "ssd_scan": (lambda a: k4_ops.ssd_scan(*a, chunk=8)[0],
                     [xs, dtv, A, Bm, Cm]),
    }


def _check_no_backward(device, name):
    fn, inputs = _kernel_calls(device)[name]
    want = fn(inputs)                       # nothing requires a gradient
    for i in range(len(inputs)):
        grad_in = [a.clone().requires_grad_(j == i)
                   for j, a in enumerate(inputs)]
        with pytest.raises(RuntimeError, match="no backward"):
            fn(grad_in)
        with torch.no_grad():
            got = fn(grad_in)
        with torch.inference_mode():
            fn(grad_in)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["dndm_update", "decode_scores",
                                  "flash_attention", "flash_decode",
                                  "ssd_scan"])
def test_kernel_wrappers_refuse_a_gradient_on_the_cpu(name):
    """On a CPU tensor a wrapper takes the differentiable plain version,
    but it raises as on the card when autograd would record it; under
    no_grad and inference_mode it serves as before."""
    _check_no_backward("cpu", name)


def test_training_through_the_kernel_route_raises():
    """attn_impl "pallas" is the flash kernel's route: a train step
    through it raises instead of leaving wq, wk and wv untrained."""
    _, tcfg = _cfgs("dndm-text8", attn_impl="pallas")
    tm = TModel(tcfg, device="cpu", seed=0)
    opt = toptim.AdamW(toptim.constant(1e-3))
    step = ttrainer.make_train_step(tm, tschedules.linear(T),
                                    tnoise.absorbing(28), opt)
    x0 = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        step(ttrainer.init_state(tm, opt), {"x0": x0},
             torch.Generator().manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dndm_update", "decode_scores",
                                  "flash_attention", "flash_decode",
                                  "ssd_scan"])
def test_kernel_wrappers_refuse_a_gradient_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _check_no_backward("cuda", name)
