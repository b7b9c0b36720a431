"""Sampler registry — method dispatch as data.

One :class:`SamplerSpec` per method describes how to run it (host loop
with data-dependent NFE, or a static grid with a known NFE), its
static-NFE rule, which engine knobs it honors and which noise kinds it
supports.  The serving engine, the scheduler and the launcher CLI
enumerate methods from here.

The 12 methods of the JAX package: the DNDM methods on the
``dndm_update`` kernel (``dndm``, ``dndm2``, ``dndm_static``), the
confidence-ranked ones on the ``decode_scores`` kernel (``dndm_topk*``,
``dndm_c*``, ``rdm*``, ``mask_predict``, ``ddim``) and ``d3pm``, which
decodes without a kernel.  Every method also exposes its call schedule
and a row-resumable step (``samplers/stepwise.py``), so the whole
registry serves through ``ContinuousScheduler``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core.samplers import (d3pm, ddim, dndm, dndm_continuous,
                                       dndm_topk, mask_predict, rdm,
                                       stepwise)
from repro_torch.core.samplers.base import SamplerConfig, SamplerOutput

BOTH = frozenset({"absorbing", "multinomial"})


@dataclasses.dataclass(frozen=True)
class SamplerRuntime:
    """Everything a sampler needs at call time, resolved by the engine."""

    denoise_fn: Any            # (x_t, t_norm, cond) -> logits
    noise: Any                 # NoiseDist
    schedule: Any              # discrete alpha schedule
    dist: Any                  # discrete transition-time law D_tau
    cfg: SamplerConfig
    steps: int
    nfe_budget: int            # 0 => default budget max(N // 2, 1)
    device: Any                # torch.device every tensor lives on
    order: str = "iid"
    shared_tau: bool = True
    ddim_stride: int = 1
    cdist: Any = None          # continuous D_tau (DNDM-C)


def resolved_budget(rt: SamplerRuntime, N: int) -> int:
    return rt.nfe_budget or max(N // 2, 1)


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """How one method runs.

    ``kind="host"`` — loop over the predetermined transition set; NFE is
    data-dependent.  ``kind="scan"`` — a static time grid, NFE fixed by
    the grid and known up front (``static_nfe``).
    ``run(generator, rt, batch, N, cond, draws)``.

    ``schedule_fn(generator, rt, N, draws) -> CallSchedule`` exposes the
    method's predetermined call schedule as data, known at admission.
    ``stepwise_step(state, tau, t_row, calls, cond, rt) -> state``
    advances each row of a rolling batch by one entry of its own schedule
    (``samplers/stepwise.py``); every method registers both, so every
    method serves continuously.  ``continuous_time`` marks the methods whose call
    times are timestamps in (0, 1] (the DNDM-C family): the stepwise
    runner then keeps f32 time and tau buffers and parks free rows at 2.0
    instead of T + 1.
    """

    name: str
    kind: str                                     # "host" | "scan"
    run: Callable[..., SamplerOutput]
    static_nfe: Callable[[SamplerRuntime, int], int] | None = None
    knobs: frozenset = frozenset()                # method-specific knobs
    noise_kinds: frozenset = BOTH
    description: str = ""
    schedule_fn: Callable[..., Any] | None = None
    stepwise_step: Callable[..., Any] | None = None
    continuous_time: bool = False


_REGISTRY: dict[str, SamplerSpec] = {}


def register(spec: SamplerSpec) -> SamplerSpec:
    if spec.kind not in ("host", "scan"):
        raise ValueError(f"{spec.name}: kind must be host|scan")
    if spec.kind == "scan" and spec.static_nfe is None:
        raise ValueError(f"{spec.name}: scan samplers need a static_nfe rule")
    if spec.schedule_fn is None or spec.stepwise_step is None:
        raise ValueError(f"{spec.name}: every sampler needs a schedule_fn "
                         "and a stepwise_step (continuous serving)")
    if spec.name in _REGISTRY:
        raise ValueError(f"sampler {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> SamplerSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown sampler {name!r}; available: "
                       f"{', '.join(names())}") from None


def names(noise_kind: str | None = None) -> tuple[str, ...]:
    """Registered method names, optionally only those supporting a noise
    kind."""
    ns = tuple(sorted(_REGISTRY))
    if noise_kind is None:
        return ns
    return tuple(n for n in ns if noise_kind in _REGISTRY[n].noise_kinds)


def specs() -> tuple[SamplerSpec, ...]:
    return tuple(_REGISTRY[n] for n in names())


def run(name: str, generator, rt: SamplerRuntime, batch: int, N: int,
        cond=None, draws=None) -> SamplerOutput:
    return get(name).run(generator, rt, batch, N, cond, draws)


def describe(name: str | None = None) -> str:
    """Human-readable method sheet (one line per spec) for CLIs."""
    lines = []
    for spec in ([get(name)] if name else specs()):
        noise = "/".join(sorted(spec.noise_kinds))
        knobs = ",".join(sorted(spec.knobs)) or "-"
        lines.append(f"{spec.name:<18} {spec.kind:<4} noise={noise:<23} "
                     f"knobs={knobs:<32} {spec.description}")
    return "\n".join(lines)


# ------------------------------------------------------------------
# Built-in methods
# ------------------------------------------------------------------

def _dndm(version: int):
    def run(generator, rt, batch, N, cond, draws=None):
        return dndm.sample(generator, rt.denoise_fn, rt.noise, rt.dist,
                           batch, N, cond=cond, cfg=rt.cfg, version=version,
                           order=rt.order, shared_tau=rt.shared_tau,
                           device=rt.device, draws=draws)
    return run


def _dndm_static(generator, rt, batch, N, cond, draws=None):
    return dndm.sample_static(generator, rt.denoise_fn, rt.noise, rt.dist,
                              batch, N, resolved_budget(rt, N), cond=cond,
                              cfg=rt.cfg, order=rt.order,
                              shared_tau=rt.shared_tau, device=rt.device,
                              draws=draws)


def _dndm_topk(generator, rt, batch, N, cond, draws=None):
    return dndm_topk.sample(generator, rt.denoise_fn, rt.noise, rt.dist,
                            batch, N, cond=cond, cfg=rt.cfg, order=rt.order,
                            shared_tau=rt.shared_tau, device=rt.device,
                            draws=draws)


def _dndm_topk_static(generator, rt, batch, N, cond, draws=None):
    return dndm_topk.sample_static(generator, rt.denoise_fn, rt.noise,
                                   rt.dist, batch, N, resolved_budget(rt, N),
                                   cond=cond, cfg=rt.cfg, order=rt.order,
                                   shared_tau=rt.shared_tau,
                                   device=rt.device, draws=draws)


def _dndm_c(topk: bool):
    def run(generator, rt, batch, N, cond, draws=None):
        return dndm_continuous.sample(generator, rt.denoise_fn, rt.noise,
                                      rt.cdist, batch, N, cond=cond,
                                      cfg=rt.cfg, topk=topk, order=rt.order,
                                      shared_tau=rt.shared_tau,
                                      device=rt.device, draws=draws)
    return run


def _d3pm(generator, rt, batch, N, cond, draws=None):
    return d3pm.sample(generator, rt.denoise_fn, rt.noise, rt.schedule,
                       batch, N, cond=cond, cfg=rt.cfg, device=rt.device,
                       draws=draws)


def _rdm(topk: bool):
    def run(generator, rt, batch, N, cond, draws=None):
        return rdm.sample(generator, rt.denoise_fn, rt.noise, rt.schedule,
                          batch, N, cond=cond, cfg=rt.cfg, topk=topk,
                          device=rt.device, draws=draws)
    return run


def _mask_predict(generator, rt, batch, N, cond, draws=None):
    return mask_predict.sample(generator, rt.denoise_fn, rt.noise, rt.steps,
                               batch, N, cond=cond, cfg=rt.cfg,
                               device=rt.device, draws=draws)


def _ddim(generator, rt, batch, N, cond, draws=None):
    return ddim.sample(generator, rt.denoise_fn, rt.noise, rt.schedule,
                       batch, N, stride=rt.ddim_stride, cond=cond,
                       cfg=rt.cfg, device=rt.device, draws=draws)


def _static_grid_nfe(rt: SamplerRuntime, N: int) -> int:
    """Actual NFE of the static-quantile variants: the deduped grid can
    be shorter than the requested budget (small T / concentrated D_tau)."""
    return len(dndm.quantile_grid(rt.dist, resolved_budget(rt, N)))


_TAU = frozenset({"order", "shared_tau", "beta"})

register(SamplerSpec(
    "dndm", "host", _dndm(1), knobs=_TAU,
    schedule_fn=stepwise.dndm_plan,
    stepwise_step=stepwise.dndm_stepwise(1),
    description="Algorithm 1: faithful host loop, NFE = |unique tau|"))
register(SamplerSpec(
    "dndm2", "host", _dndm(2), knobs=_TAU,
    schedule_fn=stepwise.dndm_plan,
    stepwise_step=stepwise.dndm_stepwise(2),
    description="Algorithm 3: keep refreshing revealed tokens (tau >= t)"))
register(SamplerSpec(
    "dndm_topk", "host", _dndm_topk, knobs=_TAU,
    schedule_fn=stepwise.dndm_plan,
    stepwise_step=stepwise.dndm_topk_stepwise,
    description="Algorithm 4: confidence-ranked reveal, same NFE as Alg 1"))
register(SamplerSpec(
    "dndm_static", "scan", _dndm_static, static_nfe=_static_grid_nfe,
    knobs=_TAU | {"nfe_budget"},
    schedule_fn=stepwise.static_grid_plan,
    stepwise_step=stepwise.dndm_stepwise(1),
    description="quantile-bucketized Alg 1: fixed NFE"))
register(SamplerSpec(
    "dndm_topk_static", "scan", _dndm_topk_static,
    static_nfe=_static_grid_nfe, knobs=_TAU | {"nfe_budget"},
    schedule_fn=stepwise.static_grid_plan,
    stepwise_step=stepwise.dndm_topk_stepwise,
    description="quantile-bucketized Alg 4: fixed NFE"))
register(SamplerSpec(
    "dndm_c", "scan", _dndm_c(False), static_nfe=lambda rt, N: N,
    knobs=_TAU, schedule_fn=stepwise.continuous_plan,
    stepwise_step=stepwise.dndm_c_stepwise(False), continuous_time=True,
    description="Algorithm 2: continuous time, NFE = N"))
register(SamplerSpec(
    "dndm_c_topk", "scan", _dndm_c(True), static_nfe=lambda rt, N: N,
    knobs=_TAU, schedule_fn=stepwise.continuous_plan,
    stepwise_step=stepwise.dndm_c_stepwise(True), continuous_time=True,
    description="Algorithm 2 + confidence-ranked reveal, NFE = N"))
register(SamplerSpec(
    "d3pm", "scan", _d3pm, static_nfe=lambda rt, N: rt.steps,
    knobs=frozenset({"steps"}), schedule_fn=stepwise.full_grid_plan,
    stepwise_step=stepwise.d3pm_stepwise,
    description="D3PM ancestral baseline, NFE = T"))
register(SamplerSpec(
    "rdm", "scan", _rdm(False), static_nfe=lambda rt, N: rt.steps,
    knobs=frozenset({"steps"}), schedule_fn=stepwise.full_grid_plan,
    stepwise_step=stepwise.rdm_stepwise(False),
    description="RDM baseline (uniform routing), NFE = T"))
register(SamplerSpec(
    "rdm_k", "scan", _rdm(True), static_nfe=lambda rt, N: rt.steps,
    knobs=frozenset({"steps"}), schedule_fn=stepwise.full_grid_plan,
    stepwise_step=stepwise.rdm_stepwise(True),
    description="RDM-k baseline (top-k routing), NFE = T"))
register(SamplerSpec(
    "mask_predict", "scan", _mask_predict,
    static_nfe=lambda rt, N: rt.steps, knobs=frozenset({"steps"}),
    noise_kinds=frozenset({"absorbing"}),
    schedule_fn=stepwise.full_grid_plan,
    stepwise_step=stepwise.mask_predict_stepwise,
    description="Mask-Predict iterative refinement, NFE = M"))
register(SamplerSpec(
    "ddim", "scan", _ddim,
    static_nfe=lambda rt, N: -(-rt.steps // rt.ddim_stride),
    knobs=frozenset({"steps", "ddim_stride"}),
    noise_kinds=frozenset({"multinomial"}),
    schedule_fn=stepwise.ddim_grid_plan,
    stepwise_step=stepwise.ddim_stepwise,
    description="discrete DDIM baseline, NFE = ceil(T / stride)"))
