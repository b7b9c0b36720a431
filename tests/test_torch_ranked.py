"""The port's confidence-ranked samplers and the rest of the registry vs
the JAX package, on the CPU.

torch's generators cannot replay JAX's threefry streams, so the JAX
package's draws are recomputed from its key discipline and injected
through the port's one injection point (``draws`` in
``samplers/loop.py``):

* ``loop.setup`` splits the key into (tau, x_T, loop); DNDM-C draws tau
  continuous;
* the loop key splits into one key per network call;
* ``rdm`` splits each call key into (sel, route): the Gumbel slab of the
  decode, then ``uniform(route, (B, N))``;
* ``ddim`` splits each call key into (sel, jump), and
  ``bernoulli(jump, p)`` is ``uniform(jump, (B, N)) < p``;
* ``d3pm`` draws ``categorical(k, log p)``, the argmax of a (B, N, K)
  Gumbel slab plus ``log p``.

With the integer-valued oracle denoiser both frameworks compute the same
logits.  Their scores (a log-softmax) differ by ulps, but the oracle's
score values are either equal (identical logit rows, hence ties that the
stable sorts must order by index) or far apart, so tokens and NFE are
bitwise equal.

The whole slice runs the reduced ``dndm-mt`` with bridged weights and
source prefixes.  Its logits agree to ~1e-5, not bitwise, so each network
call is compared on JAX's own trajectory (teacher-forced): tokens where
the top-2 selection gap exceeds 1e-4, scores within 1e-4, and the reveal
set where the score gap at its boundary exceeds 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import noise as jnoise
from repro.core import schedules as jsched
from repro.core import transition as jtrans
from repro.core.decode import decode_tokens as j_decode_tokens
from repro.core.samplers import SamplerConfig as JSamplerConfig
from repro.core.samplers import dndm as jdndm
from repro.core.samplers import registry as jregistry
from repro.core.samplers.dndm_topk import _reveal_topk as j_reveal_topk
from repro.models.model import Model as JModel
from repro.serving import BatchScheduler as JBatchScheduler
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import GenerationEngine as JEngine

import repro_torch.configs as tconfigs
from repro_torch.core import decode as tdecode
from repro_torch.core import noise as tnoise
from repro_torch.core import schedules as tsched
from repro_torch.core import transition as ttrans
from repro_torch.core.samplers import SamplerConfig as TSamplerConfig
from repro_torch.core.samplers import loop as tloop
from repro_torch.core.samplers import registry as tregistry
from repro_torch.core.samplers.base import select_x0
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models.model import Model as TModel
from repro_torch.serving import BatchScheduler as TBatchScheduler
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import GenerationEngine as TEngine

K, B, N, T = 24, 4, 16, 40


def j_oracle(x_t, t, cond):
    """Integer-valued logits in [0, 11), depending on x_t, position and
    step (tests/test_torch_slice.py's oracle)."""
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


def _n_calls(method, rt, tau, n_tok):
    if method == "dndm_topk":
        return len(np.unique(tau))
    if method == "dndm_topk_static":
        return len(jdndm.quantile_grid(rt.dist, rt.nfe_budget
                                       or max(n_tok // 2, 1)))
    if method.startswith("dndm_c"):
        return n_tok
    if method == "ddim":
        return len(range(rt.steps, 0, -rt.ddim_stride))
    return rt.steps                        # d3pm, rdm*, mask_predict


def jax_draws(method, key, rt, batch, n_tok, vocab):
    """(tau, x_T, gumbels, uniforms) exactly as the JAX samplers draw
    them (see the module docstring)."""
    k_tau, k_x, k_loop = jax.random.split(key, 3)
    tau = None
    if method.startswith("dndm"):
        continuous = method.startswith("dndm_c")
        tau = np.asarray(jtrans.sample_transition_times(
            k_tau, rt.cdist if continuous else rt.dist, batch, n_tok,
            order=rt.order, shared=rt.shared_tau, continuous=continuous))
    x = np.asarray(rt.noise.sample(k_x, (batch, n_tok))).astype(np.int32)
    keys = jax.random.split(k_loop, _n_calls(method, rt, tau, n_tok))
    split = method in ("rdm", "rdm_k", "ddim")
    gumbels = [] if method == "d3pm" or rt.cfg.x0_mode == "sample" else None
    uniforms = [] if method in ("rdm", "ddim") else None
    for k in keys:
        k_sel, k_other = jax.random.split(k) if split else (k, None)
        if gumbels is not None:
            gumbels.append(np.asarray(jax.random.gumbel(
                k_sel, (batch, n_tok, vocab), jnp.float32)))
        if uniforms is not None:
            uniforms.append(np.asarray(jax.random.uniform(
                k_other, (batch, n_tok), jnp.float32)))
    return tau, x, gumbels, uniforms


def _runtimes(kind, x0_mode, order, shared, budget, stride, jfn, tfn):
    jsch, tsch = jsched.linear(T), tsched.linear(T)
    jrt = jregistry.SamplerRuntime(
        denoise_fn=jfn, noise=jnoise.get(kind, K), schedule=jsch,
        dist=jtrans.from_schedule(jsch), cdist=jtrans.beta_continuous(17, 4),
        cfg=JSamplerConfig(x0_mode=x0_mode), steps=T, nfe_budget=budget,
        order=order, shared_tau=shared, ddim_stride=stride)
    trt = tregistry.SamplerRuntime(
        denoise_fn=tfn, noise=tnoise.get(kind, K), schedule=tsch,
        dist=ttrans.from_schedule(tsch), cdist=ttrans.beta_continuous(17, 4),
        cfg=TSamplerConfig(x0_mode=x0_mode), steps=T, nfe_budget=budget,
        device=torch.device("cpu"), order=order, shared_tau=shared,
        ddim_stride=stride)
    return jrt, trt


REPLAY_CASES = [
    # (method, noise, x0_mode, order, shared_tau, nfe_budget, ddim_stride,
    #  N); at N = 64 an unstable torch.argsort orders ties differently
    ("dndm_topk", "absorbing", "sample", "iid", True, 0, 1, 16),
    ("dndm_topk", "multinomial", "argmax", "l2r", False, 0, 1, 16),
    ("dndm_topk_static", "absorbing", "sample", "iid", True, 6, 1, 16),
    ("dndm_topk_static", "multinomial", "argmax", "r2l", True, 25, 1, 16),
    ("dndm_c", "absorbing", "sample", "iid", True, 0, 1, 16),
    ("dndm_c", "multinomial", "argmax", "l2r", False, 0, 1, 16),
    ("dndm_c_topk", "absorbing", "argmax", "iid", True, 0, 1, 16),
    ("dndm_c_topk", "multinomial", "sample", "r2l", False, 0, 1, 16),
    ("rdm", "absorbing", "sample", "iid", True, 0, 1, 16),
    ("rdm", "multinomial", "argmax", "iid", True, 0, 1, 16),
    ("rdm_k", "absorbing", "argmax", "iid", True, 0, 1, 16),
    ("rdm_k", "multinomial", "sample", "iid", True, 0, 1, 16),
    ("mask_predict", "absorbing", "sample", "iid", True, 0, 1, 16),
    ("mask_predict", "absorbing", "argmax", "iid", True, 0, 1, 16),
    ("ddim", "multinomial", "sample", "iid", True, 0, 1, 16),
    ("ddim", "multinomial", "argmax", "iid", True, 0, 3, 16),
    ("d3pm", "absorbing", "sample", "iid", True, 0, 1, 16),
    ("d3pm", "multinomial", "argmax", "iid", True, 0, 1, 16),
    ("dndm_topk", "absorbing", "argmax", "iid", True, 0, 1, 64),
    ("dndm_topk_static", "multinomial", "sample", "iid", True, 9, 1, 64),
    ("rdm_k", "absorbing", "argmax", "iid", True, 0, 1, 64),
    ("mask_predict", "absorbing", "argmax", "iid", True, 0, 1, 64),
]


@pytest.mark.parametrize(
    "method,kind,x0_mode,order,shared,budget,stride,n_tok", REPLAY_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_samplers_bitwise_under_replayed_draws(method, kind, x0_mode, order,
                                               shared, budget, stride, n_tok,
                                               seed):
    jrt, trt = _runtimes(kind, x0_mode, order, shared, budget, stride,
                         j_oracle, t_oracle)
    key = jax.random.PRNGKey(seed)
    want = jregistry.run(method, key, jrt, B, n_tok)
    draws = jax_draws(method, key, jrt, B, n_tok, K)
    got = tregistry.run(method, None, trt, B, n_tok, draws=draws)
    assert got.nfe == want.nfe
    spec = tregistry.get(method)
    if spec.kind == "scan":
        assert got.nfe == spec.static_nfe(trt, n_tok)
    assert got.tokens.dtype == torch.int32
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_registry_names_match_jax():
    assert tregistry.names() == jregistry.names()
    assert len(tregistry.names()) == 12
    for kind in ("absorbing", "multinomial"):
        assert tregistry.names(kind) == jregistry.names(kind)
    for name in tregistry.names():
        t, j = tregistry.get(name), jregistry.get(name)
        assert (t.kind, t.knobs, t.noise_kinds) == (j.kind, j.knobs,
                                                   j.noise_kinds)
    jrt, trt = _runtimes("absorbing", "argmax", "iid", True, 7, 3, j_oracle,
                         t_oracle)
    for name in tregistry.names():
        t, j = tregistry.get(name), jregistry.get(name)
        if t.kind == "scan":
            assert t.static_nfe(trt, 50) == j.static_nfe(jrt, 50), name
    with pytest.raises(ValueError, match="static_nfe"):
        tregistry.register(tregistry.SamplerSpec("no_rule", "scan",
                                                 lambda *a: None))


# ------------------------------------------------------------------
# the decode layer
# ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["absorbing", "multinomial"])
@pytest.mark.parametrize("x0_mode", ["argmax", "sample"])
def test_decode_tokens_matches_jax_reference(kind, x0_mode):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 10, 28)).astype(np.float32)
    gumbel = (rng.gumbel(size=logits.shape).astype(np.float32)
              if x0_mode == "sample" else None)
    for temp in (1.0, 0.7):
        jt, js = j_decode_tokens(
            None, jnp.asarray(logits), jnoise.get(kind, 28),
            JSamplerConfig(x0_mode=x0_mode, temperature=temp),
            backend="reference",
            gumbel=None if gumbel is None else jnp.asarray(gumbel))
        tcfg = TSamplerConfig(x0_mode=x0_mode, temperature=temp)
        tl = torch.from_numpy(logits)
        tg = None if gumbel is None else torch.from_numpy(gumbel)
        tt, ts = tdecode.decode_tokens(tl, tnoise.get(kind, 28), tcfg,
                                       gumbel=tg)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6,
                                   rtol=2e-6)
        # the same tokens as the fused DNDM update where it reveals all
        tau = torch.ones((3, 10), dtype=torch.int32)
        fused = tdecode.fused_update(tl, tt, tau, 1, tnoise.get(kind, 28),
                                     tcfg, version=2, gumbel=tg)
        assert torch.equal(fused, tt)
    if x0_mode == "sample":
        # drawn noise: the same generator state gives the same tokens
        a = tdecode.decode_tokens(tl, tnoise.get(kind, 28), tcfg,
                                  generator=torch.Generator().manual_seed(3))
        b = select_x0(tl, tnoise.get(kind, 28), tcfg,
                      generator=torch.Generator().manual_seed(3))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------------------------
# the whole slice at reduced size: dndm-mt with prefixes
# ------------------------------------------------------------------

TOL = 1e-4


def _teacher_forced(method, jfn, tfn, rt, noise, tnz, tcfg, key, batch,
                    n_tok, jcond, tcond):
    """Walk JAX's trajectory call by call; at each call the port decodes
    JAX's own state.  Returns (JAX's final tokens, whether any call had a
    gap below TOL)."""
    tau, x, gumbels, _ = jax_draws(method, key, rt, batch, n_tok,
                                   noise.vocab_size)
    revealed = np.zeros(x.shape, bool)
    mask = np.asarray(noise.logit_mask(jnp.float32))
    if method == "dndm_topk":
        calls = [(t, np.float32(t) / np.float32(rt.steps))
                 for t in np.unique(tau)[::-1]]
    else:
        owner = np.argsort(-tau, axis=-1, kind="stable")
        tau_sorted = np.take_along_axis(tau, owner, -1)
        calls = [(k, tau_sorted[:, k]) for k in range(n_tok)]
    near_tie = False
    for i, (t, t_now) in enumerate(calls):
        t_now = np.broadcast_to(np.float32(t_now), (batch,))
        jl = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t_now), jcond))
        jt, js = j_decode_tokens(None, jnp.asarray(jl), noise, rt.cfg,
                                 backend="reference",
                                 gumbel=jnp.asarray(gumbels[i]))
        jt, js = np.asarray(jt), np.asarray(js)
        with torch.inference_mode():
            tl = tfn(torch.tensor(x), torch.tensor(t_now), tcond)
            tt, ts = tdecode.decode_tokens(tl, tnz, tcfg,
                                           gumbel=torch.tensor(gumbels[i]))
        tt, ts = tt.numpy(), ts.numpy()
        sel = np.sort(jl + mask + gumbels[i], -1)
        sel_gap = sel[..., -1] - sel[..., -2]
        assert (sel_gap[tt != jt] < TOL).all(), (method, i)
        np.testing.assert_allclose(ts, js, atol=TOL, rtol=TOL)
        # the reveal set, ranked on each framework's own scores
        if method == "dndm_topk":
            k_target = (tau >= t).sum(-1)
            jx, jrev = (np.asarray(a) for a in j_reveal_topk(
                jnp.asarray(x), jnp.asarray(jt), jnp.asarray(js),
                jnp.asarray(revealed), jnp.asarray(k_target)))
            _, trev = tloop.reveal_topk(*(torch.tensor(a) for a in (
                x, tt, ts, revealed, k_target)))
            # gap between the k-th and (k+1)-th largest pinned score
            s = np.sort(np.where(revealed, np.inf, js), -1)[:, ::-1]
            kk = np.clip(k_target, 1, n_tok - 1)
            rows = np.arange(batch)
            gap = np.where((k_target > 0) & (k_target < n_tok),
                           s[rows, kk - 1] - s[rows, kk], np.inf)
        else:
            s = np.where(revealed, -np.inf, js)
            pick = s.argmax(-1)
            jrev = revealed.copy()
            jrev[np.arange(batch), pick] = True
            jx = np.where(jrev & ~revealed, jt, x)
            trev = revealed.copy()
            trev[np.arange(batch),
                 np.where(revealed, -np.inf, ts).argmax(-1)] = True
            top2 = np.sort(s, -1)
            gap = top2[:, -1] - top2[:, -2]
        differ = (np.asarray(trev) != jrev).any(-1)
        assert (gap[differ] < TOL).all(), (method, i, gap[differ])
        near_tie |= bool((gap < TOL).any() or (sel_gap < TOL).any())
        x, revealed = jx, jrev
    return x, near_tie


@pytest.mark.parametrize("method", ["dndm_topk", "dndm_c_topk"])
def test_mt_slice_with_prefixes_matches_jax(method):
    # the JAX reference attends with einsum (tests/test_models.py holds
    # it to the Pallas kernel); the port takes its flash path
    jcfg = jconfigs.get("dndm-mt").reduced(attn_impl="einsum")
    tcfg = tconfigs.get("dndm-mt").reduced(attn_impl="pallas")
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu")
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    ecfg = dict(method=method, steps=20, x0_mode="sample")
    jeng = JEngine(jm, params, JEngineConfig(**ecfg))
    teng = TEngine(tm, TEngineConfig(**ecfg), device="cpu")
    n_tok, max_batch, n_req, seed = 10, 4, 5, 7
    jsch = JBatchScheduler(jeng, max_batch=max_batch, bucket_len=n_tok,
                           seed=seed)
    tsch = TBatchScheduler(teng, max_batch=max_batch, bucket_len=n_tok,
                           seed=seed, device="cpu")
    rng = np.random.default_rng(1)
    for i in range(n_req):
        prefix = rng.integers(0, 27, 4 + i % 3).astype(np.int32)
        jsch.submit(n_tok, prefix=prefix)
        tsch.submit(n_tok, prefix=prefix)

    key, batch_keys = jax.random.PRNGKey(seed), []
    for _ in range(-(-n_req // max_batch)):
        key, k = jax.random.split(key)
        batch_keys.append(k)
    replay = iter(batch_keys)
    generate, used = teng.generate, []

    def generate_with_jax_draws(seed_, batch, N_, cond=None, method=None,
                                draws=None):
        k = next(replay)
        used.append((k, batch, cond))
        return generate(seed_, batch, N_, cond=cond, method=method,
                        draws=jax_draws(method, k, jeng.runtime(), batch, N_,
                                        tcfg.vocab_size))

    teng.generate = generate_with_jax_draws
    jdone, tdone = jsch.run(), tsch.run()
    assert sorted(jdone) == sorted(tdone) and len(used) == len(batch_keys)

    jfn = jax.jit(jm.denoise_fn(params))
    tfn = tm.denoise_fn()
    rids = sorted(jdone)
    for b, (k, batch, cond) in enumerate(used):
        pre = cond["prefix_tokens"]
        members = rids[b * max_batch:(b + 1) * max_batch]
        toks, near_tie = _teacher_forced(
            method, jfn, tfn, jeng.runtime(), jeng.noise, teng.noise,
            teng.runtime().cfg, k, batch, n_tok,
            {"prefix_tokens": jnp.asarray(pre.numpy())},
            {"prefix_tokens": pre})
        for i, rid in enumerate(members):
            j, t = jdone[rid], tdone[rid]
            np.testing.assert_array_equal(toks[i], j.result)
            assert t.nfe == j.nfe
            assert t.result.shape == (n_tok,)
            assert not (t.result == teng.noise.mask_id).any()
            if method == "dndm_c_topk":
                assert t.nfe == n_tok
            if not near_tie:
                np.testing.assert_array_equal(t.result, j.result)


# ------------------------------------------------------------------
# invariants of the port on its own draws (tests/test_samplers.py)
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def target():
    return torch.randint(0, K - 1, (B, N), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(7))


def _one_hot_oracle(target):
    def oracle(x_t, t, cond):
        return torch.nn.functional.one_hot(target.long(), K).float() * 25.0
    return oracle


def _run(name, kind, target, seed=0, stride=1):
    _, trt = _runtimes(kind, "argmax", "iid", True, 0, stride, j_oracle,
                       _one_hot_oracle(target))
    return tregistry.run(name, torch.Generator().manual_seed(seed), trt, B,
                         N)


@pytest.mark.parametrize("name,kind,stride", [
    ("d3pm", "absorbing", 1), ("d3pm", "multinomial", 1),
    ("rdm", "multinomial", 1), ("rdm_k", "multinomial", 1),
    ("rdm", "absorbing", 1), ("mask_predict", "absorbing", 1),
    ("ddim", "multinomial", 1), ("ddim", "multinomial", 2),
    ("ddim", "multinomial", 5)])
def test_oracle_recovery_and_nfe(name, kind, stride, target):
    out = _run(name, kind, target, stride=stride)
    assert torch.equal(out.tokens, target), name
    assert out.nfe == (-(-T // stride) if name == "ddim" else T)


def test_dndm_topk_nfe_matches_dndm(target):
    a = _run("dndm", "absorbing", target, seed=3)
    b = _run("dndm_topk", "absorbing", target, seed=3)
    assert a.nfe == b.nfe == len(np.unique(b.aux["tau"].numpy()))
    assert torch.equal(b.tokens, target)


@pytest.mark.parametrize("name", ["dndm_c", "dndm_c_topk"])
def test_dndm_continuous_nfe_is_n(name, target):
    out = _run(name, "multinomial", target)
    assert out.nfe == N and torch.equal(out.tokens, target)
    tau = out.aux["tau"]
    assert tau.dtype == torch.float32 and (tau > 0).all() and (tau <= 1).all()


def test_ranked_samplers_reveal_every_token_on_their_own_draws():
    rt = _runtimes("absorbing", "sample", "iid", True, 5, 1, j_oracle,
                   t_oracle)[1]
    for name in ("dndm_topk", "dndm_topk_static", "dndm_c", "dndm_c_topk",
                 "rdm", "rdm_k", "mask_predict"):
        a = tregistry.run(name, torch.Generator().manual_seed(2), rt, B, N)
        b = tregistry.run(name, torch.Generator().manual_seed(2), rt, B, N)
        assert torch.equal(a.tokens, b.tokens), name      # reproducible
        assert not (a.tokens == rt.noise.mask_id).any(), name


def test_engine_serves_every_method_and_keys_the_ddim_stride():
    cfg = tconfigs.get("dndm-mt").reduced()
    tm = TModel(cfg, device="cpu")
    for kind in ("absorbing", "multinomial"):
        eng = TEngine(tm, TEngineConfig(steps=6, noise_kind=kind,
                                        ddim_stride=2), device="cpu")
        for name in tregistry.names(kind):
            out, _ = eng.generate(1, 2, 6, method=name)
            assert out.tokens.shape == (2, 6), name
            spec = tregistry.get(name)
            if spec.kind == "scan":
                assert out.nfe == spec.static_nfe(eng.runtime(), 6), name
        if kind == "multinomial":
            calls = eng.network_calls
            eng.cfg.ddim_stride = 3          # a new key: warm-up again
            out, _ = eng.generate(1, 2, 6, method="ddim")
            assert out.nfe == 2 and eng.network_calls == calls + 4
    rt = eng.runtime()
    assert rt.cdist.beta_params == (17, 4) and rt.ddim_stride == 3
    eng.cfg.beta = (15.0, 7.0)
    assert eng.runtime().cdist.beta_params == (15.0, 7.0)


def test_serve_cli_takes_the_ddim_stride(capsys):
    done = tserve.main(["--reduced", "--requests", "2", "--max-batch", "2",
                        "--len", "8", "--steps", "9", "--device", "cpu",
                        "--method", "ddim", "--noise-kind", "multinomial",
                        "--ddim-stride", "4"])
    assert {r.nfe for r in done.values()} == {3}
    assert "2 requests" in capsys.readouterr().out
