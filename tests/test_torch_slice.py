"""The port's serving slice vs the JAX package, on the CPU.

torch's generators cannot replay JAX's threefry streams, so the JAX
package's draws are recomputed from its key discipline and injected
through the port's one injection point (``draws`` in
``samplers/loop.py``): ``loop.setup`` splits the key into (tau, x_T,
loop) and the loop splits one key per network call, whose Gumbel slab
the decode draws.

* Samplers: with an integer-valued oracle denoiser both frameworks
  compute exactly the same numbers, so tokens and NFE are bitwise equal.
* The whole slice: the reduced ``dndm-text8`` / ``dndm-mt`` /
  ``zamba2-2.7b`` denoiser with bridged weights, behind the engine and the drain scheduler.  Its
  logits agree to ~1e-5, not bitwise, so a token may differ where JAX's
  top-2 adjusted logits are closer than 1e-4; the test asserts that gap
  for every position that differs.  NFE is equal.
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
from repro.core.samplers import SamplerConfig as JSamplerConfig
from repro.core.samplers import dndm as jdndm
from repro.models.model import Model as JModel
from repro.serving import BatchScheduler as JBatchScheduler
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import GenerationEngine as JEngine

import repro_torch.configs as tconfigs
from repro_torch.core import noise as tnoise
from repro_torch.core import schedules as tsched
from repro_torch.core import transition as ttrans
from repro_torch.core.samplers import SamplerConfig as TSamplerConfig
from repro_torch.core.samplers import dndm as tdndm
from repro_torch.core.samplers import registry as tregistry
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models.model import Model as TModel
from repro_torch.serving import BatchScheduler as TBatchScheduler
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import GenerationEngine as TEngine

K, B, N, T = 24, 4, 16, 40


def jax_draws(key, dist, noise, batch, n_tok, vocab, *, method, budget=0,
              x0_mode="sample", order="iid", shared=True):
    """(tau, x_T, gumbels, uniforms) exactly as the JAX DNDM samplers
    draw them; they draw no uniforms."""
    k_tau, k_x, k_loop = jax.random.split(key, 3)
    tau = np.asarray(jtrans.sample_transition_times(
        k_tau, dist, batch, n_tok, order=order, shared=shared))
    x = np.asarray(noise.sample(k_x, (batch, n_tok))).astype(np.int32)
    calls = (len(jdndm.quantile_grid(dist, budget))
             if method == "dndm_static" else len(np.unique(tau)))
    gumbels = None
    if x0_mode == "sample":
        keys = jax.random.split(k_loop, calls)
        gumbels = [np.asarray(jax.random.gumbel(keys[i],
                                                (batch, n_tok, vocab),
                                                jnp.float32))
                   for i in range(calls)]
    return tau, x, gumbels, None


def j_oracle(x_t, t, cond):
    """Integer-valued logits in [0, 11), depending on x_t, position and
    step: many ties (argmax must take the first) and exact arithmetic."""
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


SAMPLER_CASES = [
    # (method, version, budget, noise, x0_mode, order, shared)
    ("dndm", 1, 0, "absorbing", "sample", "iid", True),
    ("dndm", 1, 0, "absorbing", "argmax", "iid", True),
    ("dndm", 1, 0, "multinomial", "sample", "iid", False),
    ("dndm", 1, 0, "absorbing", "sample", "l2r", False),
    ("dndm2", 2, 0, "absorbing", "sample", "iid", True),
    ("dndm2", 2, 0, "multinomial", "argmax", "r2l", True),
    ("dndm_static", 1, 6, "absorbing", "sample", "iid", True),
    ("dndm_static", 1, 25, "multinomial", "sample", "iid", False),
    ("dndm_static", 1, 10, "absorbing", "argmax", "l2r", True),
]


@pytest.mark.parametrize("method,version,budget,kind,x0_mode,order,shared",
                         SAMPLER_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_samplers_bitwise_under_replayed_draws(method, version, budget, kind,
                                               x0_mode, order, shared, seed):
    jd = jtrans.from_schedule(jsched.linear(T))
    td = ttrans.from_schedule(tsched.linear(T))
    jn, tn = jnoise.get(kind, K), tnoise.get(kind, K)
    key = jax.random.PRNGKey(seed)
    jcfg = JSamplerConfig(x0_mode=x0_mode)
    tcfg = TSamplerConfig(x0_mode=x0_mode)
    common = dict(order=order, shared_tau=shared)
    if method == "dndm_static":
        want = jdndm.sample_static(key, j_oracle, jn, jd, B, N, budget,
                                   cfg=jcfg, **common)
    else:
        want = jdndm.sample(key, j_oracle, jn, jd, B, N, cfg=jcfg,
                            version=version, **common)
    draws = jax_draws(key, jd, jn, B, N, K, method=method, budget=budget,
                      x0_mode=x0_mode, order=order, shared=shared)
    if method == "dndm_static":
        got = tdndm.sample_static(None, t_oracle, tn, td, B, N, budget,
                                  cfg=tcfg, device="cpu", draws=draws,
                                  **common)
    else:
        got = tdndm.sample(None, t_oracle, tn, td, B, N, cfg=tcfg,
                           version=version, device="cpu", draws=draws,
                           **common)
    assert got.nfe == want.nfe
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


# ------------------------------------------------------------------
# the whole slice: engine + drain scheduler, bridged weights
# ------------------------------------------------------------------

def _jax_gaps(jm, params, cfg, engine_cfg, noise, key, batch, n_tok, cond,
              method):
    """Replay one JAX batch step by step; returns (tokens, gap) where
    gap[b, n] is the top-2 adjusted-logit gap at the call that last set
    token (b, n)."""
    dist = jtrans.from_schedule(jsched.get(engine_cfg.schedule,
                                           engine_cfg.steps))
    budget = engine_cfg.nfe_budget or max(n_tok // 2, 1)
    tau, x, gumbels, _ = jax_draws(key, dist, noise, batch, n_tok,
                                   cfg.vocab_size, method=method,
                                   budget=budget, x0_mode=engine_cfg.x0_mode)
    version = 2 if method == "dndm2" else 1
    if method == "dndm_static":
        grid = jdndm.quantile_grid(dist, budget)
        idx = np.clip(np.searchsorted(grid, tau), 0, len(grid) - 1)
        tau, times = grid[idx], grid[::-1]
    else:
        times = np.unique(tau)[::-1]
    fn = jax.jit(jm.denoise_fn(params))
    mask = np.asarray(noise.logit_mask(jnp.float32))
    gap = np.full(tau.shape, np.inf, np.float32)
    for i, t in enumerate(times):
        t_norm = np.full((batch,), np.float32(t) / np.float32(dist.T))
        logits = np.asarray(fn(jnp.asarray(x), jnp.asarray(t_norm), cond))
        a = logits / np.float32(engine_cfg.temperature) + mask + gumbels[i]
        top2 = np.sort(a, axis=-1)[..., -2:]
        sel = (tau == t) if version == 1 else (tau >= t)
        x = np.where(sel, a.argmax(-1).astype(np.int32), x)
        gap = np.where(sel, top2[..., 1] - top2[..., 0], gap)
    return x, gap


SLICE_CASES = [
    # (arch, method, prefixes)
    ("dndm-text8", "dndm", False),
    ("dndm-text8", "dndm_static", False),
    ("dndm-mt", "dndm2", True),
    # the Mamba-2 hybrid: bidirectional mamba2 blocks + a shared attention
    # block; the JAX denoiser runs the chunked _ssd_scan_ref
    ("zamba2-2.7b", "dndm", False),
    ("zamba2-2.7b", "dndm2", True),
]


@pytest.mark.parametrize("arch,method,prefixes", SLICE_CASES)
def test_engine_and_scheduler_match_jax(arch, method, prefixes):
    jcfg = jconfigs.get(arch).reduced(attn_impl="pallas", attn_block_q=16,
                                      attn_block_k=16)
    tcfg = tconfigs.get(arch).reduced(attn_impl="pallas")
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu")
    convert.load_params(tm, jax.tree.map(np.asarray, params))
    ecfg = dict(method=method, steps=20, x0_mode="sample", nfe_budget=5)
    jeng = JEngine(jm, params, JEngineConfig(**ecfg))
    teng = TEngine(tm, TEngineConfig(**ecfg), device="cpu")
    n_tok, max_batch, n_req, seed = 12, 4, 6, 5
    jsched_ = JBatchScheduler(jeng, max_batch=max_batch, bucket_len=n_tok,
                              seed=seed)
    tsched_ = TBatchScheduler(teng, max_batch=max_batch, bucket_len=n_tok,
                              seed=seed, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(n_req):
        prefix = (rng.integers(0, 27, 3 + i % 3).astype(np.int32)
                  if prefixes else None)
        jsched_.submit(n_tok, prefix=prefix)
        tsched_.submit(n_tok, prefix=prefix)

    # the JAX scheduler's per-batch keys, in its order
    key, batch_keys = jax.random.PRNGKey(seed), []
    for _ in range(-(-n_req // max_batch)):
        key, k = jax.random.split(key)
        batch_keys.append(k)
    replay = iter(batch_keys)
    generate = teng.generate
    used = []

    def generate_with_jax_draws(seed_, batch, N_, cond=None, method=None,
                                draws=None):
        k = next(replay)
        used.append((k, batch, cond))
        return generate(seed_, batch, N_, cond=cond, method=method,
                        draws=jax_draws(k, jeng.runtime().dist, jeng.noise,
                                        batch, N_, tcfg.vocab_size,
                                        method=method,
                                        budget=ecfg["nfe_budget"]))

    teng.generate = generate_with_jax_draws
    jdone = jsched_.run()
    tdone = tsched_.run()
    assert sorted(jdone) == sorted(tdone) and len(used) == len(batch_keys)

    # JAX's own trajectory, replayed step by step for the top-2 gaps
    gaps, rows = {}, {}
    for (k, batch, cond), members in zip(used, _batches(jdone, max_batch)):
        jcond = (None if cond is None else
                 {"prefix_tokens": jnp.asarray(cond["prefix_tokens"].numpy())})
        toks, gap = _jax_gaps(jm, params, jcfg, jeng.cfg, jeng.noise, k,
                              batch, n_tok, jcond, method)
        for i, rid in enumerate(members):
            gaps[rid], rows[rid] = gap[i], toks[i]
    for rid in jdone:
        j, t = jdone[rid], tdone[rid]
        np.testing.assert_array_equal(rows[rid], j.result)
        assert t.nfe == j.nfe and t.result.shape == (n_tok,)
        differ = np.flatnonzero(t.result != j.result)
        assert (gaps[rid][differ] < 1e-4).all(), (rid, differ,
                                                  gaps[rid][differ])
        if jeng.noise.kind == "absorbing":
            assert not (t.result == teng.noise.mask_id).any()


def _batches(done, max_batch):
    rids = sorted(done)
    return [rids[i:i + max_batch] for i in range(0, len(rids), max_batch)]


# ------------------------------------------------------------------
# invariants of the port on its own draws
# ------------------------------------------------------------------

@pytest.mark.parametrize("method", ["dndm", "dndm2", "dndm_static"])
def test_absorbing_diffusion_reveals_every_token(method):
    td = ttrans.from_schedule(tsched.linear(T))
    tn = tnoise.absorbing(K)
    rt = tregistry.SamplerRuntime(
        denoise_fn=t_oracle, noise=tn, schedule=tsched.linear(T), dist=td,
        cfg=TSamplerConfig(x0_mode="sample"), steps=T, nfe_budget=7,
        device=torch.device("cpu"))
    out = tregistry.run(method, torch.Generator().manual_seed(4), rt, B, N)
    assert out.tokens.dtype == torch.int32
    assert not (out.tokens == tn.mask_id).any()
    if method != "dndm_static":
        assert out.nfe == len(np.unique(out.aux["tau"].numpy()))
    else:
        assert out.nfe == len(out.aux["grid"]) <= 7


def test_static_grid_never_reveals_twice():
    """Budgets past the number of distinct quantile times dedupe to the
    same grid, and every token's bucketized time is visited once."""
    dist = ttrans.from_schedule(tsched.linear(3))
    grids = {b: tdndm.quantile_grid(dist, b) for b in (3, 5, 9)}
    for g in grids.values():
        assert len(np.unique(g)) == len(g) <= 3
    np.testing.assert_array_equal(grids[5], grids[9])
    tn = tnoise.absorbing(K)
    outs = {}
    for b in (5, 9):
        outs[b] = tdndm.sample_static(torch.Generator().manual_seed(0),
                                      t_oracle, tn, dist, B, N, b,
                                      device="cpu")
        assert outs[b].nfe == len(grids[b]) < b
        tau = outs[b].aux["tau"].numpy()
        grid = outs[b].aux["grid"]
        tau_b = grid[np.clip(np.searchsorted(grid, tau), 0, len(grid) - 1)]
        visits = (tau_b[..., None] == grid).sum(-1)
        assert (visits == 1).all()
    torch.testing.assert_close(outs[5].tokens, outs[9].tokens)


def test_engine_replays_a_seed_and_reports_warmup():
    cfg = tconfigs.get("dndm-text8").reduced(attn_impl="pallas")
    tm = TModel(cfg, device="cpu")
    eng = TEngine(tm, TEngineConfig(method="dndm", steps=20), device="cpu")
    a, wall_a = eng.generate(11, 2, 8)
    assert eng.network_calls == 2 * a.nfe          # warm-up replay + run
    assert a.aux["compile_seconds"] >= 0.0 and wall_a > 0.0
    b, _ = eng.generate(11, 2, 8)
    assert b.aux["compile_seconds"] == 0.0
    assert eng.network_calls == 3 * a.nfe
    torch.testing.assert_close(a.tokens, b.tokens)
    c, _ = eng.generate(12, 2, 8)
    assert not torch.equal(a.aux["tau"], c.aux["tau"])
    with pytest.raises(KeyError, match="available"):
        eng.generate(0, 1, 8, method="no_such_method")


def test_scheduler_buckets_and_seeds_are_reproducible():
    cfg = tconfigs.get("dndm-text8").reduced()
    results = []
    for _ in range(2):
        eng = TEngine(TModel(cfg, device="cpu"),
                      TEngineConfig(method="dndm_static", steps=10,
                                    nfe_budget=3), device="cpu")
        s = TBatchScheduler(eng, max_batch=4, bucket_len=8, seed=2,
                            device="cpu")
        assert [s.batch_bucket(n) for n in (1, 2, 3, 5, 9)] == [1, 2, 4, 4, 4]
        for i in range(5):
            s.submit(8 if i else 6)
        done = s.run()
        assert [done[r].batch_size for r in sorted(done)] == [4] * 4 + [1]
        assert done[1].result.shape == (6,)
        results.append({r: (d.result, d.seed) for r, d in done.items()})
    for r in results[0]:
        np.testing.assert_array_equal(results[0][r][0], results[1][r][0])
        assert results[0][r][1] == results[1][r][1]


def test_entry_points_raise_without_a_gpu_and_a_device(monkeypatch):
    cfg = tconfigs.get("dndm-text8").reduced()
    cpu_model = TModel(cfg, device="cpu")
    cpu_engine = TEngine(cpu_model, TEngineConfig(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TModel(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(cpu_model, TEngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TBatchScheduler(cpu_engine)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--reduced", "--requests", "1", "--len", "8"])


def test_serve_cli_serves_zamba2_on_the_cpu(capsys):
    done = tserve.main(["--arch", "zamba2-2.7b", "--reduced", "--requests",
                        "2", "--max-batch", "2", "--len", "20", "--steps",
                        "10", "--device", "cpu"])
    assert len(done) == 2
    assert all(r.result.shape == (20,) and (r.result < 256).all()
               for r in done.values())
    assert "2 requests" in capsys.readouterr().out


def test_serve_cli_on_the_cpu(capsys):
    done = tserve.main(["--reduced", "--requests", "3", "--max-batch", "2",
                        "--len", "8", "--steps", "10", "--device", "cpu"])
    assert len(done) == 3
    assert all(r.result.shape == (8,) for r in done.values())
    assert "3 requests" in capsys.readouterr().out
