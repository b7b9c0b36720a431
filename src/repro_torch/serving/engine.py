"""Generation engine: binds a model and the sampler family, and serves
batched requests.

Every sampler is dispatched through ``repro_torch.core.samplers.registry``
— no per-method branches.  For conditional requests,
``cond={"prefix_tokens": src}``: the model feeds [src | x_t] with
bidirectional attention and returns target logits.

A request is seeded by an integer: ``generate`` and ``plan_request``
build a fresh ``torch.Generator`` on the engine's device from it, so the
same seed replays the same run, solo or as one row of a
:class:`StepwiseRunner` (the rolling batch of continuous serving).

With ``repro_torch.obs`` enabled, every ``generate`` is an
``engine.generate`` span feeding the ``engine.*`` metrics, and every
runner call an ``engine.stepwise`` span, with the JAX package's names and
attributes.  Both spans also record while a ``torch.profiler`` session
records, and so do the layer spans below them (``obs.layer_span``):
``engine.plan`` (``plan_request``), ``runner.admit``, ``runner.inputs``
(a call's per-row host columns) and ``runner.harvest`` (the copy of
finishing rows to the host).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import obs
from repro_torch.core import decode as decode_lib
from repro_torch.core import schedules as sched_lib
from repro_torch.core import transition as trans_lib
from repro_torch.core.noise import NoiseDist, absorbing, multinomial
from repro_torch.core.samplers import SamplerConfig, SamplerOutput, registry
from repro_torch.core.samplers.stepwise import CallSchedule, to_device


@dataclasses.dataclass
class EngineConfig:
    method: str = "dndm"
    steps: int = 50                   # T for discrete methods
    schedule: str = "linear"
    noise_kind: str = "absorbing"
    beta: tuple[float, float] | None = None   # Beta approx of D_tau
    nfe_budget: int = 0               # static variants
    x0_mode: str = "sample"
    temperature: float = 1.0
    order: str = "iid"                # iid | l2r | r2l
    shared_tau: bool = True           # one tau-set per batch (paper NFE)
    ddim_stride: int = 1              # DDIM baseline subsequence stride


class GenerationEngine:
    """Serves ``model`` (a :class:`repro_torch.models.model.Model`) on
    ``device`` (``None`` means ``cuda``, which must exist); the model's
    weights must already lie there.

    ``network_calls`` counts the denoiser calls of every sampler run the
    engine executed, untimed warm-up replays included.
    """

    def __init__(self, model, engine_cfg: EngineConfig, *, device=None):
        self.device = device_lib.resolve(device)
        if model.device != self.device:
            raise ValueError(f"model lies on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = engine_cfg
        v = model.cfg.vocab_size
        self.noise: NoiseDist = (absorbing(v)
                                 if engine_cfg.noise_kind == "absorbing"
                                 else multinomial(v))
        self.check_method(engine_cfg.method)    # fail fast, list alternatives
        self.denoise_fn = model.denoise_fn()
        self._law_cache: dict = {}
        self._warm: set = set()
        self.network_calls = 0

    def check_method(self, name: str) -> registry.SamplerSpec:
        """Resolve a method and validate it against the engine's noise
        kind (also used by the scheduler before enqueueing)."""
        spec = registry.get(name)
        if self.noise.kind not in spec.noise_kinds:
            raise ValueError(
                f"{spec.name} supports {sorted(spec.noise_kinds)} noise, "
                f"engine is configured with {self.noise.kind!r}")
        return spec

    def _laws(self):
        """(schedule, dist, cdist) derived from the *current* config —
        mutating steps/schedule/beta must never serve stale laws.  The
        continuous law of DNDM-C is Beta(a, b) from ``beta``, else
        Beta(17, 4), as in the JAX package."""
        c = self.cfg
        lk = (c.schedule, c.steps, c.beta)
        if lk not in self._law_cache:
            schedule = sched_lib.get(c.schedule, c.steps)
            if c.beta:
                a, b = c.beta
                dist = trans_lib.beta_approx(c.steps, a, b)
                cdist = trans_lib.beta_continuous(a, b)
            else:
                dist = trans_lib.from_schedule(schedule)
                cdist = trans_lib.beta_continuous(17, 4)
            self._law_cache[lk] = (schedule, dist, cdist)
        return self._law_cache[lk]

    def runtime(self) -> registry.SamplerRuntime:
        c = self.cfg
        schedule, dist, cdist = self._laws()
        return registry.SamplerRuntime(
            denoise_fn=self.denoise_fn, noise=self.noise,
            schedule=schedule, dist=dist, cdist=cdist,
            cfg=SamplerConfig(x0_mode=c.x0_mode, temperature=c.temperature),
            steps=c.steps, nfe_budget=c.nfe_budget, device=self.device,
            order=c.order, shared_tau=c.shared_tau,
            ddim_stride=c.ddim_stride)

    def _cache_key(self, method: str, batch: int, N: int,
                   rt: registry.SamplerRuntime, cond: dict | None):
        # every knob that changes the run is in the key, and so is the
        # conditioning's structure
        c = self.cfg
        cond_key = None if cond is None else tuple(
            sorted((k, tuple(v.shape), str(v.dtype)) for k, v in cond.items()))
        return (method, batch, N, c.schedule, c.beta, rt.steps,
                rt.nfe_budget, rt.order, rt.shared_tau, rt.ddim_stride,
                rt.cfg, cond_key)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _execute(self, spec, seed: int, rt, batch: int, N: int, cond,
                 draws) -> SamplerOutput:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            out = spec.run(gen, rt, batch, N, cond, draws)
        self._sync()
        self.network_calls += out.nfe
        return out

    def generate(self, seed: int, batch: int, N: int,
                 cond: dict | None = None, method: str | None = None,
                 draws=None) -> tuple[SamplerOutput, float]:
        """Returns (SamplerOutput, wall_seconds).

        ``method`` overrides the engine's configured sampler per call.
        ``draws`` replaces the sampler's random draws (see
        ``samplers/loop.py``); the serving path never passes it.

        ``wall_seconds`` is steady-state execution, timed between two
        ``torch.cuda.synchronize()``.  The first call per (method, shape,
        knobs) key first runs the same request once untimed under the
        same seed — identical output — so that kernel build and load and
        cuBLAS initialisation do not land in the timed run; that one-time
        cost is ``aux["compile_seconds"]`` (0.0 on a warm key).

        With ``repro_torch.obs`` enabled, every call is an
        ``engine.generate`` span (method/kind/batch/seq + nfe/wall/cache/
        backend) and feeds the ``engine.*`` metrics; the warm-up runs
        with telemetry suppressed, so a cold key records its steps once.
        ``REPRO_TORCH_PROFILE=dir`` also writes a ``torch.profiler``
        trace of the call.
        """
        m = method or self.cfg.method
        spec = self.check_method(m)
        rt = self.runtime()
        with obs.span("engine.generate", method=m, kind=spec.kind,
                      batch=batch, seq=N) as sp, obs.maybe_profile():
            out, wall, cache = self._run(spec, m, seed, rt, batch, N, cond,
                                         draws)
            if obs.enabled():
                compile_s = out.aux["compile_seconds"]
                obs.counter("engine.requests").inc(method=m, kind=spec.kind)
                obs.counter("engine.nfe").inc(out.nfe, method=m)
                obs.counter("engine.tokens").inc(batch * N, method=m)
                obs.histogram("engine.wall_seconds").observe(wall, method=m)
                # observed on every miss: the CPU's warm-up can run as
                # fast as the timed run, which clamps the estimate to 0
                if cache == "miss":
                    obs.histogram("engine.compile_seconds").observe(
                        compile_s, method=m, kind=spec.kind)
                sp.set(nfe=out.nfe, wall_s=wall, compile_s=compile_s,
                       cache=cache, backend=decode_lib.backend(self.device))
        return out, wall

    def _run(self, spec, m: str, seed: int, rt, batch: int, N: int, cond,
             draws) -> tuple[SamplerOutput, float, str]:
        """Run one request; returns (out, steady wall, "hit" | "miss")."""
        ck = self._cache_key(m, batch, N, rt, cond)
        missed = ck not in self._warm
        warm_wall = 0.0
        if missed:
            self._sync()
            tc = time.perf_counter()
            # the warm-up repeats the timed run below; recording it would
            # count its steps, reveals and decodes twice
            with obs.suppressed():
                self._execute(spec, seed, rt, batch, N, cond, draws)
            warm_wall = time.perf_counter() - tc
            self._warm.add(ck)
        self._sync()
        t0 = time.perf_counter()
        out = self._execute(spec, seed, rt, batch, N, cond, draws)
        wall = time.perf_counter() - t0
        out.aux["compile_seconds"] = (max(0.0, warm_wall - wall)
                                      if missed else 0.0)
        # the JAX package's jit cache is the counterpart of the warm keys
        obs.counter("engine.jit_cache.misses" if missed
                    else "engine.jit_cache.hits").inc(method=m,
                                                      kind=spec.kind)
        return out, wall, ("miss" if missed else "hit")

    def plan_request(self, seed: int, N: int, method: str | None = None,
                     draws=None) -> CallSchedule:
        """The request's predetermined call schedule, known at admission.

        Drawing tau (and x_T) from the request's generator determines every
        network call it will make before sampling starts; the plan keeps
        the generator for the per-call draws, so a runner row replays
        ``generate(seed, 1, N, method=...)``.  ``draws`` replaces the
        random draws as in :meth:`generate`, with per-call (N, K) Gumbel
        slabs and (N,) uniforms; the serving path never passes it.
        """
        m = method or self.cfg.method
        spec = self.check_method(m)
        with obs.layer_span("engine.plan"), torch.inference_mode():
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return spec.schedule_fn(gen, self.runtime(), N, draws)

    def stepwise(self, rows: int, N: int, method: str | None = None,
                 prefix_len: int = 0) -> "StepwiseRunner":
        """A row-resumable runner: ``rows`` request slots of length ``N``,
        advanced one own-schedule step per batched call.  ``prefix_len >
        0`` makes it a conditional runner: every admitted request carries
        a prefix of exactly that length."""
        return StepwiseRunner(self, method or self.cfg.method, rows, N,
                              prefix_len=prefix_len)


class StepwiseRunner:
    """Fixed-shape rolling batch of row-resumable requests.

    ``rows`` slots share every network call; each occupied slot holds a
    request's :class:`CallSchedule` and a pointer into it.  Each
    :meth:`step` is ONE network call that advances *every* live row by one
    entry of its own schedule: rows sit at different diffusion times and
    draw their noise from their own generators, so each request's
    trajectory is its solo batch-of-one run whenever the denoiser is
    batch-shape-invariant.  Free slots are parked at a sentinel time
    outside every schedule (T + 1, or 2.0 in continuous time) and gated out
    in every row step; a slot is re-admittable as soon as its request
    completes.

    ``prefix_len > 0`` makes the runner conditional: a ``(rows,
    prefix_len)`` prefix buffer is fed to the denoiser as
    ``cond={"prefix_tokens": ...}``; free rows hold the noise pad token.
    Rows are never padded, which keeps solo parity.

    The buffers (x, revealed, tau, prefix) live on the engine's device.
    Completed rows are harvested inside :meth:`step` with one
    device-to-host copy, before any later call can touch the buffer, so
    results are exactly-once.  ``calls`` counts this runner's network
    calls; each also counts in ``engine.network_calls``.
    """

    def __init__(self, engine: GenerationEngine, method: str, rows: int,
                 N: int, prefix_len: int = 0):
        spec = engine.check_method(method)
        self.engine = engine
        self.method = method
        self.spec = spec
        self.rt = engine.runtime()
        self.rows = rows
        self.N = N
        self.prefix_len = prefix_len
        dev = engine.device
        if spec.continuous_time:
            # timestamps lie in (0, 1]; 2.0 is past every schedule
            self._t_dtype, self._t_free = np.float32, 2.0
            tau_dtype = torch.float32
        else:
            self._t_dtype, self._t_free = np.int32, self.rt.dist.T + 1
            tau_dtype = torch.int32
        with torch.inference_mode():
            self.x = torch.zeros((rows, N), dtype=torch.int32, device=dev)
            self.revealed = torch.zeros((rows, N), dtype=torch.bool,
                                        device=dev)
            self.tau = torch.zeros((rows, N), dtype=tau_dtype, device=dev)
            self.prefix = (torch.full((rows, prefix_len),
                                      engine.noise.pad_id, dtype=torch.int32,
                                      device=dev) if prefix_len else None)
        self._plans: list[CallSchedule | None] = [None] * rows
        self._ptr = [0] * rows
        self.calls = 0

    def free_rows(self) -> list[int]:
        return [i for i in range(self.rows) if self._plans[i] is None]

    def active_rows(self) -> list[int]:
        return [i for i in range(self.rows) if self._plans[i] is not None]

    def admit(self, row: int, plan: CallSchedule,
              prefix: np.ndarray | None = None) -> None:
        """Install a request's plan into a free slot (any step boundary)."""
        self.admit_many([(row, plan)], None if prefix is None else [prefix])

    def admit_many(self, pairs: list[tuple[int, CallSchedule]],
                   prefixes: list[np.ndarray] | None = None) -> None:
        """Install several plans with one scatter per buffer.

        ``tau`` is required by the tau-consuming methods (the DNDM family)
        and ignored by the baselines.  ``prefixes`` (aligned with
        ``pairs``) is required iff the runner has ``prefix_len > 0``.  A
        plan is admitted once: its generator has state.
        """
        if not pairs:
            return
        if bool(prefixes) != bool(self.prefix_len):
            raise ValueError(
                "conditional runner needs one prefix per admission"
                if self.prefix_len else
                "unconditional runner cannot admit prefixes")
        for row, plan in pairs:
            if self._plans[row] is not None:
                raise ValueError(f"row {row} is occupied")
            if plan.admitted:
                raise ValueError("plan already admitted; a plan's generator "
                                 "is consumed by its run")
        dev = self.engine.device
        with obs.layer_span("runner.admit"), torch.inference_mode():
            idx = to_device(np.array([row for row, _ in pairs]), dev)
            self.x.index_copy_(0, idx, torch.stack(
                [p.x0.reshape(self.N) for _, p in pairs]))
            self.revealed.index_fill_(0, idx, False)
            self.tau.index_copy_(0, idx, torch.stack([
                torch.zeros_like(self.tau[0]) if p.tau is None
                else p.tau.reshape(self.N).to(self.tau.dtype)
                for _, p in pairs]))
            if self.prefix_len:
                pre = np.stack([np.asarray(p, np.int32).reshape(
                    self.prefix_len) for p in prefixes])
                self.prefix.index_copy_(0, idx, to_device(pre, dev))
        for row, plan in pairs:
            plan.admitted = True
            self._plans[row] = plan
            self._ptr[row] = 0

    def step(self) -> dict[int, np.ndarray]:
        """One batched network call; returns the tokens of the rows that
        finished, by row.

        With telemetry on, every call is an ``engine.stepwise`` span whose
        ``request_ids`` attribute lists the trace identity of each row the
        call advanced (comma-joined): the per-call backbone of
        ``obs.timeline(request_id)``.
        """
        active = self.active_rows()
        if not active:
            return {}
        t_row = np.full((self.rows,), self._t_free, self._t_dtype)
        calls: list[tuple[CallSchedule, int] | None] = [None] * self.rows
        for i in active:
            plan = self._plans[i]
            t_row[i] = plan.times[self._ptr[i]]
            calls[i] = (plan, self._ptr[i])
        cond = (None if self.prefix is None
                else {"prefix_tokens": self.prefix})
        rids = (",".join(p.request_id for i in active
                         if (p := self._plans[i]).request_id is not None)
                if obs.enabled() else "")
        with obs.span("engine.stepwise", method=self.method,
                      call=self.calls, rows=len(active), request_ids=rids):
            with torch.inference_mode():
                state = self.spec.stepwise_step(
                    {"x": self.x, "revealed": self.revealed}, self.tau,
                    t_row, calls, cond, self.rt)
            self.x, self.revealed = state["x"], state["revealed"]
            finished = [i for i in active
                        if self._ptr[i] + 1 == len(self._plans[i].times)]
            if finished:
                # one device-to-host copy of the whole buffer
                with obs.layer_span("runner.harvest"):
                    host_x = self.x.cpu().numpy()
        self.calls += 1
        self.engine.network_calls += 1
        if obs.enabled():
            obs.counter("engine.stepwise_calls").inc(method=self.method)
        done: dict[int, np.ndarray] = {}
        for i in active:
            self._ptr[i] += 1
            if i in finished:
                done[i] = host_x[i].copy()
                self._plans[i] = None
        return done
