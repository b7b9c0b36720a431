"""The port's continuous serving (``ContinuousScheduler``, ``StepwiseRunner``
and the row steps of ``samplers/stepwise.py``) vs the JAX package, and vs
its own solo runs, on the CPU.

* Parity layer 2: the JAX ``ContinuousScheduler`` and the port's run the
  same tape of submits and pumps (all 12 methods under both noise kinds,
  lengths below ``bucket_len``, mid-flight admissions, two prefix lengths)
  with integer-valued denoisers that take per-row t.  The port replays
  each request's JAX draws through ``plan_request(draws=...)``: tau and
  x_T from JAX's plan and, per call, ``gumbel(step_key or its k_sel
  half, (N, K))`` and, for ``rdm`` and ``ddim``, ``uniform(k_route,
  (N,))``.  Tokens, NFE, executed and skipped steps and ``total_calls``
  are bitwise equal.
* Solo parity on the port's own draws: every row served continuously
  equals ``engine.generate(r.seed, 1, N, method)``.
* The per-row draws: a row's slab equals the solo (1, N, K) slab drawn
  from the same generator state, and a free row advances no generator.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.samplers import registry as jregistry
from repro.launch import serve as jserve
from repro.serving import ContinuousScheduler as JContinuous
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import GenerationEngine as JEngine

import repro_torch.configs as tconfigs
from repro_torch import device as device_lib
from repro_torch.core import decode as tdecode
from repro_torch.core.samplers import registry as tregistry
from repro_torch.core.samplers import stepwise as tstepwise
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model as TModel
from repro_torch.serving import BatchScheduler as TBatchScheduler
from repro_torch.serving import ContinuousScheduler as TContinuous
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import GenerationEngine as TEngine

K, T, SEQ = 24, 30, 12
CPU = torch.device("cpu")


def j_oracle(x_t, t, cond):
    """Integer-valued logits in [0, 15), depending on x_t, position, the
    row's own step and its prefix: many ties and exact arithmetic."""
    k = jnp.arange(K, dtype=jnp.int32)
    n = jnp.arange(x_t.shape[1], dtype=jnp.int32)
    tt = jnp.round(jnp.asarray(t, jnp.float32) * T).astype(jnp.int32)
    v = (x_t[..., None] * 3 + k * 7 + n[None, :, None] * 5
         + tt[:, None, None]) % 11
    if cond is not None:
        v = v + (cond["prefix_tokens"].sum(-1) % 5)[:, None, None]
    return v.astype(jnp.float32)


def t_oracle(x_t, t, cond):
    k = torch.arange(K, dtype=torch.int32, device=x_t.device)
    n = torch.arange(x_t.shape[1], dtype=torch.int32, device=x_t.device)
    tt = torch.round(t * T).to(torch.int32)
    v = (x_t[..., None] * 3 + k * 7 + n[None, :, None] * 5
         + tt[:, None, None]) % 11
    if cond is not None:
        v = v + (cond["prefix_tokens"].sum(-1) % 5)[:, None, None]
    return v.to(torch.float32)


class _Cfg:
    vocab_size = K


class JOracleModel:
    cfg = _Cfg()

    def init(self, key):
        return {}

    def denoise_fn(self, params, cond=None):
        return j_oracle


class TOracleModel:
    """The port's engine takes any model with ``device``, ``cfg`` and
    ``denoise_fn()``; this one is elementwise per row, so a row's
    trajectory does not depend on the batch around it."""

    cfg = _Cfg()

    def __init__(self, device=CPU):
        self.device = torch.device(device)

    def denoise_fn(self):
        return t_oracle


ENGINE_KW = dict(steps=T, shared_tau=False, nfe_budget=7, ddim_stride=3)


def _engines(kind, x0_mode="sample"):
    m = JOracleModel()
    jeng = JEngine(m, m.init(None), JEngineConfig(
        noise_kind=kind, x0_mode=x0_mode, **ENGINE_KW))
    teng = TEngine(TOracleModel(), TEngineConfig(
        noise_kind=kind, x0_mode=x0_mode, **ENGINE_KW), device="cpu")
    return jeng, teng


def _tape(kind):
    """Submits and pumps: two requests of every method (the second after
    pumps, so it lands mid-flight), lengths below bucket_len, and prefixed
    requests of two lengths for three methods."""
    rng = np.random.default_rng(3)
    ops = []
    for i, m in enumerate(tregistry.names(kind)):
        ops.append(("submit", SEQ - i % 3, m, None))
        ops.append(("pump",))
    for i, m in enumerate(tregistry.names(kind)):
        ops.append(("submit", SEQ, m, None))
        ops += [("pump",)] * (i % 3)
    for m in ("dndm_topk", "rdm", "dndm_c"):
        for P in (3, 5, 3):
            pre = rng.integers(0, K - 1, P).astype(np.int32)
            ops.append(("submit", SEQ - P % 2, m, pre))
        ops.append(("pump",))
    return ops


def _play(sched, ops):
    rids = []
    for op in ops:
        if op[0] == "submit":
            _, length, m, pre = op
            rids.append(sched.submit(length, prefix=pre, method=m))
        else:
            sched.pump()
    return rids, sched.run()


def _jax_plan_draws(r, x0_mode):
    """(tau, x_T, gumbels, uniforms) of a JAX request, as the JAX row
    steps draw them from the plan's per-call keys."""
    plan, m = r.plan, r.method
    gumbels = [] if m == "d3pm" or x0_mode == "sample" else None
    uniforms = [] if m in ("rdm", "ddim") else None
    for key in plan.step_keys:
        k_sel, k_other = (jax.random.split(key)
                          if m in ("rdm", "rdm_k", "ddim") else (key, None))
        if gumbels is not None:
            gumbels.append(np.asarray(jax.random.gumbel(k_sel, (SEQ, K),
                                                        jnp.float32)))
        if uniforms is not None:
            uniforms.append(np.asarray(jax.random.uniform(k_other, (SEQ,))))
    return plan.tau, plan.x0, gumbels, uniforms


@pytest.mark.parametrize("kind,x0_mode", [("absorbing", "sample"),
                                          ("multinomial", "sample"),
                                          ("absorbing", "argmax")])
def test_continuous_scheduler_matches_jax(kind, x0_mode):
    jeng, teng = _engines(kind, x0_mode)
    ops = _tape(kind)
    jsch = JContinuous(jeng, max_batch=3, bucket_len=SEQ, seed=4)
    jrids, jdone = _play(jsch, ops)

    draws = iter(_jax_plan_draws(jdone[rid], x0_mode) for rid in jrids)
    plan_request = teng.plan_request

    def plan_with_jax_draws(seed, N, method=None, draws_=None):
        return plan_request(seed, N, method, draws=next(draws))

    teng.plan_request = plan_with_jax_draws
    tsch = TContinuous(teng, max_batch=3, bucket_len=SEQ, seed=4,
                       device="cpu")
    trids, tdone = _play(tsch, ops)
    assert trids == jrids and sorted(tdone) == sorted(jdone)
    assert tsch.total_calls == jsch.total_calls
    for rid in jrids:
        j, t = jdone[rid], tdone[rid]
        assert t.method == j.method
        np.testing.assert_array_equal(t.result, np.asarray(j.result),
                                      err_msg=f"{j.method} rid {rid}")
        assert (t.nfe, t.steps_executed, t.steps_skipped) == (
            j.nfe, j.steps_executed, j.steps_skipped), j.method
        np.testing.assert_array_equal(t.plan.times, j.plan.times)


def test_registry_stepwise_fields_match_jax():
    for name in tregistry.names():
        t, j = tregistry.get(name), jregistry.get(name)
        assert t.schedule_fn is not None and t.stepwise_step is not None
        assert t.continuous_time == j.continuous_time, name
    assert {n for n in tregistry.names()
            if tregistry.get(n).continuous_time} == {"dndm_c", "dndm_c_topk"}


@pytest.mark.parametrize("missing", ["schedule_fn", "stepwise_step"])
def test_register_requires_the_continuous_fields(missing):
    fields = {"schedule_fn": tstepwise.dndm_plan,
              "stepwise_step": tstepwise.dndm_stepwise(1), missing: None}
    with pytest.raises(ValueError, match="stepwise_step"):
        tregistry.register(tregistry.SamplerSpec(
            "no_stepwise", "host", lambda *a: None, **fields))
    assert "no_stepwise" not in tregistry.names()


# ------------------------------------------------------------------
# solo parity on the port's own draws
# ------------------------------------------------------------------

def _solo(eng, r, prefix=None):
    cond = (None if prefix is None else
            {"prefix_tokens": torch.as_tensor(prefix)[None]})
    out, _ = eng.generate(r.seed, 1, SEQ, method=r.method, cond=cond)
    return out.tokens[0, : r.length].numpy()


@pytest.mark.parametrize("kind", ["absorbing", "multinomial"])
def test_every_method_matches_its_solo_run(kind):
    _, teng = _engines(kind)
    sched = TContinuous(teng, max_batch=3, bucket_len=SEQ, seed=7,
                        device="cpu")
    rids, done = _play(sched, _tape(kind))
    assert sorted(done) == sorted(rids)
    for rid in rids:
        r = done[rid]
        np.testing.assert_array_equal(_solo(teng, r, r.prefix), r.result,
                                      err_msg=f"{r.method} rid {rid}")
        assert r.nfe == len(r.plan.times) == r.steps_executed
        if r.method.startswith("dndm_c"):
            assert (r.steps_executed, r.steps_skipped) == (SEQ, 0)
        else:
            assert r.steps_executed + r.steps_skipped == T


@pytest.fixture(scope="module")
def text8():
    return TModel(tconfigs.get("dndm-text8").reduced(), device="cpu")


def test_real_model_dndm_and_dndm2_match_solo(text8):
    """dndm and dndm2 decode by Gumbel-max over per-row noise, which the
    reduced transformer's cross-batch-shape rounding cannot flip."""
    eng = TEngine(text8, TEngineConfig(method="dndm", steps=6,
                                       shared_tau=False), device="cpu")
    for method in ("dndm", "dndm2"):
        sched = TContinuous(eng, max_batch=4, bucket_len=8, seed=3,
                            device="cpu")
        rids = [sched.submit(n, method=method) for n in (8, 5, 8, 6, 8)]
        done = sched.run()
        assert sorted(done) == sorted(rids)
        for rid in rids:
            r = done[rid]
            solo, _ = eng.generate(r.seed, 1, 8, method=method)
            np.testing.assert_array_equal(solo.tokens[0, : r.length].numpy(),
                                          r.result, err_msg=f"{method} {rid}")
            assert r.steps_executed + r.steps_skipped == 6
            assert r.nfe == len(r.plan.times)


def test_fewer_calls_than_drain(text8):
    """Independent tau sets: a drain batch walks the union of its rows'
    schedules, continuous serving each row's own."""
    eng = TEngine(text8, TEngineConfig(method="dndm", steps=8,
                                       shared_tau=False), device="cpu")
    lengths = [8, 6, 8, 5, 8, 7]
    drain = TBatchScheduler(eng, max_batch=4, bucket_len=8, seed=11,
                            device="cpu")
    for n in lengths:
        drain.submit(n, method="dndm")
    drain_calls = sum({r.seed: r.nfe for r in drain.run().values()}.values())
    cont = TContinuous(eng, max_batch=4, bucket_len=8, seed=11, device="cpu")
    for n in lengths:
        cont.submit(n, method="dndm")
    calls = eng.network_calls
    done = cont.run()
    assert cont.total_calls < drain_calls
    assert cont.total_calls <= sum(r.steps_executed for r in done.values())
    assert eng.network_calls - calls == cont.total_calls


def test_conditional_rows_match_solo():
    """Prefixed requests get a conditional runner per (method, prefix
    length); each row equals its solo conditional run."""
    _, eng = _engines("absorbing")
    sched = TContinuous(eng, max_batch=2, bucket_len=SEQ, seed=9,
                        device="cpu")
    rng = np.random.default_rng(0)
    subs = []
    for m, P in [("dndm", 3), ("rdm_k", 4), ("dndm_topk", 3), ("d3pm", 4),
                 ("dndm", 4)]:
        pre = rng.integers(0, K - 1, size=P).astype(np.int32)
        subs.append((sched.submit(SEQ, prefix=pre, method=m), pre))
    done = sched.run()
    assert sorted(done) == sorted(rid for rid, _ in subs)
    assert set(sched._runners) == {("dndm", 3), ("rdm_k", 4),
                                   ("dndm_topk", 3), ("d3pm", 4), ("dndm", 4)}
    for rid, pre in subs:
        r = done[rid]
        np.testing.assert_array_equal(_solo(eng, r, pre), r.result)


def test_round_robin_no_group_starvation():
    """A steady stream of one method does not starve a queued request of
    another: groups with work are served round-robin."""
    _, eng = _engines("absorbing")
    sched = TContinuous(eng, max_batch=2, bucket_len=SEQ, seed=1,
                        device="cpu")
    sched.submit(SEQ, method="dndm")
    sched.submit(SEQ, method="dndm")
    sched.pump()                        # the dndm runner is live
    rid_b = sched.submit(SEQ, method="rdm")
    n_calls_b = sched.queue[-1].plan.nfe
    pumps = 0
    while rid_b not in sched.done:
        sched.submit(SEQ, method="dndm")   # keep the dndm queue non-empty
        assert sched.pump()
        pumps += 1
        assert pumps <= 2 * n_calls_b + 2, "rdm starved by the dndm stream"
    done = sched.run()
    assert sorted(done) == list(range(1, sched._rid + 1))


def test_plan_is_admitted_once_and_submit_checks():
    _, eng = _engines("absorbing")
    plan = eng.plan_request(5, SEQ, "dndm")
    runner = eng.stepwise(2, SEQ, "dndm")
    runner.admit(0, plan)
    with pytest.raises(ValueError, match="already admitted"):
        runner.admit(1, plan)
    with pytest.raises(ValueError, match="occupied"):
        runner.admit(0, eng.plan_request(6, SEQ, "dndm"))
    with pytest.raises(ValueError, match="prefix"):
        eng.stepwise(2, SEQ, "dndm", prefix_len=3).admit(0, plan)
    sched = TContinuous(eng, max_batch=2, bucket_len=SEQ, device="cpu")
    with pytest.raises(ValueError, match="bucket_len"):
        sched.submit(SEQ + 1)
    with pytest.raises(ValueError, match="supports"):
        sched.submit(SEQ, method="ddim")        # multinomial only


# ------------------------------------------------------------------
# the per-row draws
# ------------------------------------------------------------------

def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return device_lib.resolve(name)


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.mark.parametrize("dev", DEVICES)
def test_row_slab_equals_the_solo_draws(dev):
    """Row i of the assembled slab is the (1, N, K) Gumbel slab and the
    (1, N) uniforms a solo run draws from the same generator state, for
    the paths' shapes; a free row is zeros in, finite out."""
    dev = _device(dev)
    for n, k in [(16, 28), (64, 28), (256, 28), (128, 28), (8, 32000)]:
        seeds = [11, None, 12, 13]
        gens = [None if s is None else
                torch.Generator(device=dev).manual_seed(s) for s in seeds]
        slab = tdecode.row_gumbel_noise(gens, (n, k), dev)
        u = tdecode.row_uniform(gens, n, dev)
        assert slab.shape == (4, n, k) and u.shape == (4, n)
        assert torch.isfinite(slab).all()
        for i, s in enumerate(seeds):
            if s is None:
                assert (u[i] == 0).all()
                continue
            g = torch.Generator(device=dev).manual_seed(s)
            solo = tdecode.gumbel_noise(g, (1, n, k), dev)
            solo_u = torch.rand((1, n), generator=g, device=dev)
            assert torch.equal(slab[i], solo[0]), (n, k, i)
            assert torch.equal(u[i], solo_u[0]), (n, k, i)


@pytest.mark.parametrize("dev", DEVICES)
def test_free_rows_advance_no_generator(dev):
    """A free row, and a finished one, draw nothing: a generator's state
    moves only on the calls of its own live row."""
    dev = _device(dev)
    gens = [torch.Generator(device=dev).manual_seed(s) for s in (1, 2)]
    states = [g.get_state() for g in gens]
    tdecode.row_gumbel_noise([gens[0], None], (8, 28), dev)
    tdecode.row_uniform([gens[0], None], 8, dev)
    assert torch.equal(gens[1].get_state(), states[1])
    assert not torch.equal(gens[0].get_state(), states[0])
    # a runner's free row, a finished request's row, a plan not admitted
    eng = TEngine(TOracleModel(dev), TEngineConfig(**ENGINE_KW), device=dev)
    plans = [eng.plan_request(s, SEQ, "dndm") for s in range(3, 9)]
    short = plans[0]
    long = next(p for p in plans[1:] if p.nfe != short.nfe)
    short, long = sorted((short, long), key=lambda p: p.nfe)
    idle = plans[-1].generator.get_state()
    runner = eng.stepwise(3, SEQ, "dndm")
    runner.admit_many([(1, short), (2, long)])
    for _ in range(short.nfe):
        runner.step()
    assert runner.free_rows() == [0, 1]
    after = short.generator.get_state()
    while runner.active_rows():
        runner.step()
    assert torch.equal(short.generator.get_state(), after)
    assert torch.equal(plans[-1].generator.get_state(), idle)


@pytest.mark.parametrize("method", ["d3pm", "ddim"])
def test_sentinel_time_reaches_d3pm_and_ddim_rows(method):
    """A free row sits at T + 1, past the end of ``alphas``: the gather
    is clamped, no index error, and the row is left as it was."""
    kind = "multinomial" if method == "ddim" else "absorbing"
    _, eng = _engines(kind)
    rt = eng.runtime()
    assert len(rt.schedule.alphas) == T + 1
    x = torch.randint(0, K, (2, SEQ), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(0))
    plan = eng.plan_request(2, SEQ, method)
    state = {"x": x, "revealed": torch.zeros_like(x, dtype=torch.bool)}
    t_row = np.array([T + 1, plan.times[0]], np.int32)
    out = tregistry.get(method).stepwise_step(
        state, torch.zeros_like(x), t_row, [None, (plan, 0)], None, rt)
    assert torch.equal(out["x"][0], x[0])
    # the stepwise module clamps, numpy would have raised
    with pytest.raises(IndexError):
        np.asarray(rt.schedule.alphas)[T + 1]
    assert tstepwise._at(np.arange(T + 1), np.array([T + 1]))[0] == T


# ------------------------------------------------------------------
# the serve CLI's defaults (ROADMAP C1)
# ------------------------------------------------------------------

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


def test_serve_cli_defaults_match_jax(monkeypatch):
    jdef = _defaults(jserve.main, (), monkeypatch)
    tdef = _defaults(tserve.main, ([],), monkeypatch)
    shared = sorted(set(jdef) & set(tdef))
    assert {"method", "arch", "steps", "nfe_budget", "len"} <= set(shared)
    assert {k: tdef[k] for k in shared} == {k: jdef[k] for k in shared}
    assert tdef["method"] == "dndm_topk_static"
