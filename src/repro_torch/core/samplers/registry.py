"""Sampler registry — method dispatch as data.

One :class:`SamplerSpec` per method describes how to run it (host loop
with data-dependent NFE, or a static grid with a known NFE), which engine
knobs it honors and which noise kinds it supports.  The serving engine,
the scheduler and the launcher CLI enumerate methods from here.

This slice registers the DNDM methods on the ``dndm_update`` kernel:
``dndm`` (Algorithm 1), ``dndm2`` (Algorithm 3) and ``dndm_static``.
The confidence-ranked methods (``dndm_topk*``, ``dndm_c*``, ``rdm*``,
``mask_predict``, ``ddim``) and ``d3pm`` come with the ``decode_scores``
slice; call schedules and stepwise steps with continuous serving.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core.samplers import dndm
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


def resolved_budget(rt: SamplerRuntime, N: int) -> int:
    return rt.nfe_budget or max(N // 2, 1)


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """How one method runs.

    ``kind="host"`` — loop over the predetermined transition set; NFE is
    data-dependent.  ``kind="scan"`` — a static time grid, NFE fixed by
    the grid.  ``run(generator, rt, batch, N, cond, draws)``.
    """

    name: str
    kind: str                                     # "host" | "scan"
    run: Callable[..., SamplerOutput]
    knobs: frozenset = frozenset()                # method-specific knobs
    noise_kinds: frozenset = BOTH
    description: str = ""


_REGISTRY: dict[str, SamplerSpec] = {}


def register(spec: SamplerSpec) -> SamplerSpec:
    if spec.kind not in ("host", "scan"):
        raise ValueError(f"{spec.name}: kind must be host|scan")
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


def names() -> tuple[str, ...]:
    """Registered method names."""
    return tuple(sorted(_REGISTRY))


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


_TAU = frozenset({"order", "shared_tau", "beta"})

register(SamplerSpec(
    "dndm", "host", _dndm(1), knobs=_TAU,
    description="Algorithm 1: faithful host loop, NFE = |unique tau|"))
register(SamplerSpec(
    "dndm2", "host", _dndm(2), knobs=_TAU,
    description="Algorithm 3: keep refreshing revealed tokens (tau >= t)"))
register(SamplerSpec(
    "dndm_static", "scan", _dndm_static, knobs=_TAU | {"nfe_budget"},
    description="quantile-bucketized Alg 1: fixed NFE"))
