"""AdamW and learning-rate schedules, with the arithmetic of
``repro.training.optim``.

AdamW with decoupled weight decay and global-norm clipping, written out
(not ``torch.optim.AdamW``) so that every operation comes in the
reference's order: clip by ``min(1, clip / max(gnorm, 1e-9))``, the
moments, bias corrections at ``step + 1``, ``u = m_hat / (sqrt(v_hat) +
eps)``, then ``p - lr * (u + wd * p)``.  Parameters, gradients and
moments are dicts keyed by the port's parameter names; the update is in
place.  The step counter and the learning rate stay on the host, f32 as
in the reference, so an update makes the host wait for nothing.

Weight decay goes where the JAX package puts it: on every leaf of rank
2 or more *in the JAX tree*.  There each layer's leaves carry a leading
``n_super`` axis (``models/convert.py``), so a block's RMSNorm scales and
Mamba-2 vectors are decayed while ``ln_f.scale`` is not; :func:`jax_rank`
gives that rank from a port name.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Schedule = Callable[[int], torch.Tensor]


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> Schedule:
    """Linear warm-up to ``peak``, then a cosine down to ``floor * peak``;
    f32 (0-dim CPU tensor) of an integer step."""
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = peak * (floor + (1 - floor) * 0.5 *
                      (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant(lr: float) -> Schedule:
    # torch.tensor of a Python float: a fake tensor mode keeps its value
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def jax_rank(name: str, p: torch.Tensor) -> int:
    """The rank of parameter ``name`` in the JAX package's tree: a layer's
    leaves (``blocks.*``) are stacked there along ``n_super``."""
    return p.dim() + name.startswith("blocks.")


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0

    def init(self, params: dict) -> dict:
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "step": 0}

    @torch.no_grad()
    def update(self, grads: dict, state: dict,
               params: dict) -> tuple[dict, dict, dict]:
        """One step, in place on ``params`` and the moments.  Returns
        (params, new state, metrics {"lr", "grad_norm"})."""
        step = state["step"] + 1
        lr = self.schedule(step)
        grads = dict(grads)

        if self.clip_norm > 0:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads.values()))
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        else:
            gnorm = torch.zeros(())

        b1, b2 = self.b1, self.b2
        # f32 scalars, computed on the host and held as Python floats: an
        # f32 tensor times one rounds as times the reference's f32 array
        stepf = torch.tensor(step, dtype=torch.float32)
        mu_hat_scale = float(1.0 / (1 - torch.tensor(b1) ** stepf))
        nu_hat_scale = float(1.0 / (1 - torch.tensor(b2) ** stepf))
        lr_f = float(lr)
        mu, nu = state["mu"], state["nu"]
        for k, p in params.items():
            g = grads[k]
            m = mu[k].mul_(b1).add_((1 - b1) * g)
            v = nu[k].mul_(b2).add_((1 - b2) * torch.square(g))
            u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + self.eps)
            if jax_rank(k, p) >= 2:               # decay matrices only
                u = u + self.weight_decay * p
            p.sub_(lr_f * u)
        return params, {"mu": mu, "nu": nu, "step": step}, {
            "lr": lr, "grad_norm": gnorm}
