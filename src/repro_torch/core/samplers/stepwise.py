"""Call schedules as data + row-resumable sampler steps (the substrate of
continuous serving).

DNDM's structural property (Thm 3.6 / Alg. 2) is that a request's whole
schedule of network calls is known before sampling starts: drawing the
transition-time set tau at admission fixes the unique-time walk.  This
module makes that data:

* :class:`CallSchedule` — one request's predetermined calls (descending
  times, tau, x_T) and the request's own ``torch.Generator``, produced by
  a per-method ``schedule_fn(generator, rt, N, draws)`` registered on the
  sampler spec.  Every plan replays the solo sampler's ``loop.setup`` for
  a batch of one from the same generator, so ``engine.generate(seed, 1,
  N)`` starts from the same state.  The grid baselines (d3pm, rdm,
  mask_predict, ddim) have a data-independent times list but carry their
  own x_T and generator; the static DNDM variants carry the bucketized
  tau.
* batched **row steps** — advance every live row of a rolling batch by
  one entry of *its own* schedule, at its own diffusion time (the
  denoiser takes a per-row ``t_norm``), with its own noise: each call
  draws row i's slab from row i's generator in the solo step's order,
  the (N, K) Gumbel slab first, then, for ``rdm`` and ``ddim``, one (N,)
  uniform (``decode.row_gumbel_noise`` / ``decode.row_uniform``).

Bitwise parity with the solo path rests on three contracts:
``decode_tokens`` and ``fused_update`` choose the same tokens (the
kernels share ``csrc/row_select.cuh``'s pre-activation); an (N, K) draw
and a (1, N, K) draw from the same generator state give the same numbers
(held on both generators by ``tests/test_torch_continuous.py``); and
every per-row quantity (``t / T``, alphas, sigma, reveal and re-mask
counts) is computed on the host in numpy f32, as the solo samplers
compute their scalars, then reaches the device in one pinned,
asynchronous copy per call.

Free rows are parked at a sentinel time outside every schedule (``T + 1``
on a discrete grid, ``2.0`` in continuous time); every row step gates its
update on ``live`` (``1 <= t <= T``, or ``t <= 1.0``) so that a free row
passes through unchanged whatever the shared network call computed for
it.  A free row draws nothing and advances no generator.  Gathers at the
sentinel (``alphas[T + 1]``) are clamped explicitly; the gate discards
their values.

A plan is consumed once: its generator has state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import decode
from repro_torch.core.posterior import posterior
from repro_torch.core.samplers import loop
from repro_torch.core.samplers.d3pm import _softmax
from repro_torch.core.samplers.dndm import bucketize, quantile_grid


@dataclasses.dataclass
class CallSchedule:
    """One request's predetermined network-call schedule.

    ``times`` is the descending sequence of diffusion times at which the
    request calls the network: the unique values of its tau set
    (Algorithms 1, 3 and 4), the grid (the static and baseline methods),
    or its own timestamps (Algorithm 2).  ``steps_skipped`` counts the
    grid steps the schedule proves it never pays for (``T - |times|``; 0
    in continuous time, where the request is its own grid).  ``tau`` is
    None for the baselines, whose update never reads a transition set.

    ``generator`` is the request's own stream, on the engine's device.
    Injected draws (``draws=``, the tests' replay of the JAX package's
    streams) replace what they supply, as in ``engine.generate``:
    ``gumbels`` one (N, K) slab and ``uniforms`` one (N,) array per call.

    ``request_id`` is the serving-layer trace identity: the scheduler sets
    the id minted at ``submit()``, and every batched ``engine.stepwise``
    span lists the ids of the rows it advanced, so that one trace file
    rebuilds a request's calls (``obs.timeline``).  ``schedule_fn``
    implementations leave it None.
    """

    times: np.ndarray                      # descending call times
    T: int                                 # grid size (0 => continuous)
    x0: torch.Tensor                       # (N,) the request's x_T
    generator: torch.Generator | None
    tau: torch.Tensor | None = None        # (N,) transition times
    gumbels: list | None = None            # injected per-call slabs
    uniforms: list | None = None           # injected per-call uniforms
    admitted: bool = False                 # set by StepwiseRunner.admit
    request_id: str | None = None          # trace identity (scheduler-set)

    @property
    def nfe(self) -> int:
        return len(self.times)

    @property
    def steps_executed(self) -> int:
        return len(self.times)

    @property
    def steps_skipped(self) -> int:
        return max(self.T - len(self.times), 0) if self.T else 0


# ------------------------------------------------------------------
# schedule_fn per method family: (generator, rt, N, draws) -> CallSchedule
# ------------------------------------------------------------------

def _setup(generator, rt, N: int, draws, **kw):
    """``loop.setup`` for a batch of one: (tau row or None, x_T row,
    injected gumbels, injected uniforms)."""
    tau, x, gumbels, uniforms = loop.setup(generator, rt.noise, 1, N,
                                           device=rt.device, draws=draws,
                                           **kw)
    return (None if tau is None else tau.reshape(N), x.reshape(N),
            gumbels, uniforms)


def dndm_plan(generator, rt, N: int, draws=None) -> CallSchedule:
    """Algorithms 1, 3 and 4: the unique values of the request's tau."""
    tau, x, g, u = _setup(generator, rt, N, draws, dist=rt.dist,
                          order=rt.order, shared=rt.shared_tau)
    return CallSchedule(loop.unique_times(tau.cpu().numpy()), rt.dist.T, x,
                        generator, tau, g, u)


def static_grid_plan(generator, rt, N: int, draws=None) -> CallSchedule:
    """dndm_static / dndm_topk_static: the deduplicated quantile grid (a
    fixed NFE), the request's tau rounded up onto it as the solo sampler
    does."""
    from repro_torch.core.samplers.registry import resolved_budget
    grid = quantile_grid(rt.dist, resolved_budget(rt, N))
    tau, x, g, u = _setup(generator, rt, N, draws, dist=rt.dist,
                          order=rt.order, shared=rt.shared_tau)
    return CallSchedule(grid[::-1], rt.dist.T, x, generator,
                        bucketize(tau, grid), g, u)


def full_grid_plan(generator, rt, N: int, draws=None) -> CallSchedule:
    """The ancestral baselines (d3pm, rdm, rdm_k, mask_predict): every
    step of the grid, no transition set."""
    _, x, g, u = _setup(generator, rt, N, draws)
    return CallSchedule(np.arange(rt.steps, 0, -1), rt.steps, x, generator,
                        gumbels=g, uniforms=u)


def ddim_grid_plan(generator, rt, N: int, draws=None) -> CallSchedule:
    """The DDIM subsequence: ceil(T / stride) calls."""
    _, x, g, u = _setup(generator, rt, N, draws)
    return CallSchedule(np.arange(rt.steps, 0, -rt.ddim_stride), rt.steps,
                        x, generator, gumbels=g, uniforms=u)


def continuous_plan(generator, rt, N: int, draws=None) -> CallSchedule:
    """DNDM-C: N continuous timestamps, one call each (NFE = N)."""
    tau, x, g, u = _setup(generator, rt, N, draws, dist=rt.cdist,
                          order=rt.order, shared=rt.shared_tau,
                          continuous=True)
    return CallSchedule(np.sort(tau.cpu().numpy())[::-1], 0, x, generator,
                        tau, g, u)


# ------------------------------------------------------------------
# per-row inputs of one batched call
# ------------------------------------------------------------------

def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: to a CUDA device from pinned memory,
    asynchronously, so the host does not wait for the card (a copy from
    pageable memory would synchronise the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _columns(rt, *cols) -> torch.Tensor:
    """Per-row host values (each (B,), exact in f32) as one (len(cols),
    B) f32 tensor on the device, in one copy per call."""
    return to_device(np.stack(cols).astype(np.float32, copy=False),
                     rt.device)


def _live(t_row: np.ndarray, T: int) -> np.ndarray:
    """Row liveness on a discrete grid: the free-row sentinel T + 1 (and
    anything else outside [1, T]) never mutates its row."""
    return (t_row >= 1) & (t_row <= T)


def _gumbel(calls, shape, rt, always: bool = False):
    """The per-row Gumbel slab of this call (sample mode, or ``always``
    for D3PM's categorical draw), else None."""
    if not always and rt.cfg.x0_mode == "argmax":
        return None
    return decode.row_gumbel_noise(
        [None if c is None else
         (c[0].generator if c[0].gumbels is None else c[0].gumbels[c[1]])
         for c in calls], shape[1:], rt.device)


def _uniform(calls, n: int, rt) -> torch.Tensor:
    """The per-row (N,) uniforms of this call (RDM routing, DDIM jump)."""
    return decode.row_uniform(
        [None if c is None else
         (c[0].generator if c[0].uniforms is None else c[0].uniforms[c[1]])
         for c in calls], n, rt.device)


def _decode(logits, calls, rt):
    return decode.decode_tokens(logits, rt.noise, rt.cfg,
                                gumbel=_gumbel(calls, logits.shape, rt))


def _alphas(rt) -> np.ndarray:
    return np.asarray(rt.schedule.alphas, np.float32)


def _at(a: np.ndarray, t: np.ndarray) -> np.ndarray:
    """``a[t]`` with t clamped into range: the sentinel T + 1 gathers
    ``a[T]``, which the live gate discards."""
    return a[np.clip(t, 0, len(a) - 1)]


# ------------------------------------------------------------------
# batched row steps: advance every live row by one own-schedule entry.
# ``t_row`` (rows,) host array of each row's time (the sentinel for a
# free row); ``calls[i]`` = (plan, call index) of live row i, else None.
# ------------------------------------------------------------------

def _t_norm(t_row: np.ndarray, T: int) -> np.ndarray:
    """``t / T`` per row, divided in f32 as ``loop.t_norm`` does."""
    return t_row.astype(np.float32) / np.float32(T)


def _dndm_rows(x, tau, t_row, calls, cond, rt, version: int):
    """Token selection through ``decode_tokens`` (the same tokens as the
    solo path's ``fused_update``), then eq. (9) per row against its own
    tau: ``tau == t`` (version 1) or ``tau >= t`` (version 2)."""
    T = rt.dist.T
    c = _columns(rt, _t_norm(t_row, T), t_row, _live(t_row, T))
    logits = rt.denoise_fn(x, c[0], cond)
    x0_hat, _ = _decode(logits, calls, rt)
    t_col = c[1][:, None]
    sel = (tau == t_col) if version == 1 else (tau >= t_col)
    return torch.where(sel & (c[2][:, None] > 0), x0_hat, x)


def _dndm_topk_rows(x, revealed, tau, t_row, calls, cond, rt):
    """Algorithm 4, row-resumable: K_t per row from its own tau at its
    own time; a free row reveals nothing (K_t = 0)."""
    T = rt.dist.T
    c = _columns(rt, _t_norm(t_row, T), t_row, _live(t_row, T))
    logits = rt.denoise_fn(x, c[0], cond)
    x0_hat, score = _decode(logits, calls, rt)
    k_target = (tau >= c[1][:, None]).sum(-1) * (c[2] > 0)
    return loop.reveal_topk(x, x0_hat, score, revealed, k_target)


def _d3pm_rows(x, t_row, calls, cond, rt):
    """D3PM ancestral step, row-resumable: per-row (alpha_{t-1},
    alpha_t) and a per-row Gumbel-max categorical draw, the sample the
    solo step draws for a batch of one."""
    T = rt.steps
    alphas = _alphas(rt)
    c = _columns(rt, _t_norm(t_row, T), _at(alphas, t_row - 1),
                 _at(alphas, t_row), _live(t_row, T))
    logits = rt.denoise_fn(x, c[0], cond)
    mask = decode._logit_mask(rt.noise, x.device)
    temp = torch.full((), rt.cfg.temperature, dtype=torch.float32,
                      device=x.device)
    x0_probs = _softmax((logits + mask) / temp)
    p = posterior(x, x0_probs, c[1][:, None], c[2][:, None], rt.noise)
    g = _gumbel(calls, p.shape, rt, always=True)
    x_new = (g + torch.log(p + 1e-30)).argmax(-1).to(torch.int32)
    return torch.where(c[3][:, None] > 0, x_new, x)


def _rdm_rows(x, denoised, t_row, calls, cond, rt, topk: bool):
    """RDM / RDM-k step, row-resumable: per-row clean target
    ``round(N alpha_{t-1})`` (never shrinking), routed by the row's own
    uniforms (RDM) or scores (RDM-k)."""
    N, T = x.shape[1], rt.steps
    k_clean = np.round(np.float32(N) * _at(_alphas(rt), t_row - 1))
    live = _live(t_row, T)
    c = _columns(rt, _t_norm(t_row, T), k_clean, live)
    logits = rt.denoise_fn(x, c[0], cond)
    x0_hat, score = _decode(logits, calls, rt)
    if not topk:
        score = _uniform(calls, N, rt)
    k_target = torch.maximum(denoised.sum(-1), c[1]) * (c[2] > 0)
    return loop.reveal_topk(x, x0_hat, score, denoised, k_target)


def _mask_predict_rows(x, t_row, calls, cond, rt):
    """Mask-Predict round, row-resumable.  The solo loop's iteration i
    has t_norm (M - i) / M, so a row at grid time t (M..1) is at
    ``i = M - t`` and re-masks ``round(N (t - 1) / M)`` tokens."""
    N, M = x.shape[1], rt.steps
    n_mask = np.round((N * (t_row - 1)).astype(np.float32)
                      / np.float32(M))
    c = _columns(rt, _t_norm(t_row, M), n_mask, _live(t_row, M))
    logits = rt.denoise_fn(x, c[0], cond)
    x0_hat, score = _decode(logits, calls, rt)
    order = torch.argsort(score, dim=-1, stable=True)
    remask = torch.argsort(order, dim=-1, stable=True) < c[1][:, None]
    x_new = torch.where(remask, rt.noise.mask_id, x0_hat)
    return torch.where(c[2][:, None] > 0, x_new, x)


def _ddim_rows(x, t_row, calls, cond, rt):
    """Discrete-DDIM step, row-resumable: per-row sigma_t from the row's
    (t, t - stride) pair, and a keep-mask from the row's own uniforms."""
    N, T = x.shape[1], rt.steps
    alphas, one = _alphas(rt), np.float32(1.0)
    a_prev = _at(alphas, np.maximum(t_row - rt.ddim_stride, 0))
    sigma = (one - a_prev) / np.maximum(one - _at(alphas, t_row),
                                        np.float32(1e-9))
    c = _columns(rt, _t_norm(t_row, T), np.clip(sigma, 0, 1),
                 _live(t_row, T))
    logits = rt.denoise_fn(x, c[0], cond)
    x0_hat, _ = _decode(logits, calls, rt)
    # bernoulli(p) is uniform < p, as jax.random.bernoulli draws it
    keep = _uniform(calls, N, rt) < c[1][:, None]
    x_new = torch.where(keep, x, x0_hat)
    return torch.where(c[2][:, None] > 0, x_new, x)


def _dndm_c_rows(x, revealed, tau, t_row, calls, cond, rt, topk: bool):
    """Algorithm 2 step, row-resumable in continuous time: ``t_row`` is
    the row's timestamp, passed to the denoiser raw as the solo loop
    does.  It reveals the token owning the timestamp (``tau == t``), or
    the top-score unrevealed token for the top-k variant.  Timestamps
    are a.s. distinct, but f32 draws can tie: the plan then holds the
    time once per owner, and each call reveals the lowest-index
    unrevealed owner, the order of the solo sampler's stable sort."""
    c = _columns(rt, t_row, t_row <= 1.0)
    logits = rt.denoise_fn(x, c[0], cond)
    x0_hat, score = _decode(logits, calls, rt)
    if topk:
        pick = torch.where(revealed, -torch.inf, score).argmax(-1)
        upd = torch.arange(x.shape[1], device=x.device) == pick[:, None]
    else:
        upd = (tau == c[0][:, None]) & ~revealed
        upd = upd & (upd.cumsum(-1) == 1)
    upd = upd & (c[1][:, None] > 0)
    return torch.where(upd, x0_hat, x), revealed | upd


# ------------------------------------------------------------------
# stepwise_step wrappers: (state, tau, t_row, calls, cond, rt) -> state
# ------------------------------------------------------------------

def dndm_stepwise(version: int):
    """stepwise_step of dndm / dndm_static (version 1) and dndm2 (2)."""
    def step(state, tau, t_row, calls, cond, rt):
        return {"x": _dndm_rows(state["x"], tau, t_row, calls, cond, rt,
                                version),
                "revealed": state["revealed"]}
    return step


def dndm_topk_stepwise(state, tau, t_row, calls, cond, rt):
    x, revealed = _dndm_topk_rows(state["x"], state["revealed"], tau, t_row,
                                  calls, cond, rt)
    return {"x": x, "revealed": revealed}


def d3pm_stepwise(state, tau, t_row, calls, cond, rt):
    return {"x": _d3pm_rows(state["x"], t_row, calls, cond, rt),
            "revealed": state["revealed"]}


def rdm_stepwise(topk: bool):
    """stepwise_step of rdm (topk=False) and rdm_k (topk=True); the
    ``revealed`` buffer carries RDM's denoised set."""
    def step(state, tau, t_row, calls, cond, rt):
        x, denoised = _rdm_rows(state["x"], state["revealed"], t_row, calls,
                                cond, rt, topk)
        return {"x": x, "revealed": denoised}
    return step


def mask_predict_stepwise(state, tau, t_row, calls, cond, rt):
    return {"x": _mask_predict_rows(state["x"], t_row, calls, cond, rt),
            "revealed": state["revealed"]}


def ddim_stepwise(state, tau, t_row, calls, cond, rt):
    return {"x": _ddim_rows(state["x"], t_row, calls, cond, rt),
            "revealed": state["revealed"]}


def dndm_c_stepwise(topk: bool):
    """stepwise_step of dndm_c / dndm_c_topk (continuous time)."""
    def step(state, tau, t_row, calls, cond, rt):
        x, revealed = _dndm_c_rows(state["x"], state["revealed"], tau,
                                   t_row, calls, cond, rt, topk)
        return {"x": x, "revealed": revealed}
    return step
