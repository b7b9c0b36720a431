"""The DNDM sampler's law and random stream, worked out again, and the
teacher-forced check of served tokens.

The program's contract (``repro_torch.core.samplers.loop`` and
``stepwise``): a scheduler draws each seed from a CPU
``torch.Generator`` seeded with its own seed, ``randint(0, 2**62)``; a
trajectory (a request in continuous mode, a batch in drain mode) draws
from a generator on the device seeded with that seed, in this order:
the transition times (``multinomial`` over D_tau, with replacement, one
(1, N) set when it is shared or the trajectory has one row), absorbing
x_T (no draw), then per network call one (rows, N, K) uniform slab for
the Gumbel-max decode, clamped at the smallest normal f32 and mapped by
-log(-log(u)).  Algorithm 1 calls the network at each distinct
transition time, descending, and at time t reveals the positions whose
tau equals t.

The check replays that from the seed alone: for each call it rebuilds
the input x_t from the served tokens (a position holds its served token
once its tau lies above t, [MASK] before), computes the reference's
logits (the configuration's reference, ``reference/model.py`` by
default), adds the mask and the call's Gumbel slab, and reads at each
position revealed at t the gap by which the served token's score lies
below the best score.  A sound program reads rounding; a wrong logit
that changes a choice, a wrong token or a position left unrevealed reads
a large gap.

A routed reference (one with ``forward_routed``) computes each call with
the expert choices the program made at it, the trajectory's call ``i``
with the routing of the program's call ``i``, and reads the choices'
``routing_shortfall`` (``routing.py``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dndmbench.reference import model
from dndmbench.reference.routing import is_routed

MASK_NEG = -1e9


def linear_transition_probs(T: int) -> np.ndarray:
    """P(tau = t) = alpha_{t-1} - alpha_t for alpha_t = 1 - t / T, t = 1..T
    (the linear schedule), clipped, made monotone and renormalised, in
    float64."""
    t = np.arange(T + 1, dtype=np.float64) / T
    a = np.clip(1.0 - t, 0.0, 1.0)
    a[0], a[T] = 1.0, 0.0
    a = np.minimum.accumulate(a)
    p = np.maximum(a[:-1] - a[1:], 0.0)
    return p / p.sum()


def scheduler_seeds(seed: int, n: int) -> list[int]:
    """The first ``n`` seeds a scheduler seeded with ``seed`` hands out."""
    g = torch.Generator().manual_seed(seed)
    return [int(torch.randint(0, 2 ** 62, (1,), generator=g))
            for _ in range(n)]


def draw_tau(gen: torch.Generator, probs: torch.Tensor, rows: int, N: int,
             shared: bool) -> torch.Tensor:
    """(rows, N) int64 transition times in 1..T."""
    n = N if shared or rows == 1 else rows * N
    tau = torch.multinomial(probs, n, replacement=True, generator=gen) + 1
    return tau.view(1 if n == N else rows, N).expand(rows, N)


def gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass
class Trajectory:
    """One seeded sampler run as the program served it: ``tokens`` (rows,
    N) on the host, ``nfe`` the calls the program reported; for a routed
    configuration ``routing``, per call the program made, its routed
    layers' (rows, N, K) expert ids."""
    seed: int
    tokens: np.ndarray
    nfe: int
    routing: list | None = None


@dataclasses.dataclass
class Readings:
    logit_err: float = 0.0           # the program's logits, widest error
    control_logit_err: float = 0.0   # the TF32 reference's, widest error
    calls: int = 0                   # network calls whose logits were read
    widest_gap: float = 0.0          # the program's served tokens
    control_gap: float = 0.0         # the tokens the control puts first
    tokens: int = 0                  # positions checked
    control_flips: int = 0           # where the control's choice differs
    nfe_wrong: int = 0               # trajectories whose NFE is not |tau|
    mask_left: int = 0               # served positions still [MASK]
    routing_shortfall: float = 0.0   # the program's expert choices
    control_routing_shortfall: float = 0.0   # the TF32 reference's


def logits_of(reference, kind: str, device, tree: dict, c: dict,
              x: torch.Tensor, tn: torch.Tensor, routing, r: Readings
              ) -> torch.Tensor:
    """``reference``'s logits in precision ``kind``; a routed reference's
    forced to ``routing`` (its layers' ids, None where the program left
    none: then its own choice, and an infinite shortfall), whose
    shortfall ``r.routing_shortfall`` takes."""
    with reference.precision(kind, device):
        if not is_routed(reference):
            return reference.forward(tree, c, x, tn)
        if routing is None:
            r.routing_shortfall = math.inf
            return reference.forward(tree, c, x, tn)
        logits, short = reference.forward_routed(tree, c, x, tn, routing)
    r.routing_shortfall = max(r.routing_shortfall, short)
    return logits


def nfe_of(seed: int, probs: torch.Tensor, rows: int, N: int, shared: bool,
           device) -> int:
    gen = torch.Generator(device=device).manual_seed(seed)
    return int(torch.unique(draw_tau(gen, probs, rows, N, shared)).numel())


def check(trajs: list[Trajectory], tree: dict, c: dict, *, T: int,
          shared: bool, device, block_rows: int, control: bool = False,
          readings: Readings | None = None,
          reference=model) -> Readings:
    """Replay ``trajs`` against ``reference`` (its ``forward`` under its
    ``precision``, or a routed one's ``forward_routed`` on the program's
    choices); returns the readings.  ``control`` also computes the TF32
    reference's logits (on the same choices) and reads the gap of the
    token it puts first."""
    r = readings or Readings()
    routed = is_routed(reference)
    K = c["vocab_size"]
    mask_id = K - 1
    probs = torch.as_tensor(linear_transition_probs(T), dtype=torch.float32,
                            device=device)
    mask = torch.zeros(K, dtype=torch.float32, device=device)
    mask[mask_id] = MASK_NEG
    # (x_t, t_norm, tokens, reveal, gumbel, routing) rows; a row's
    # routing is its layers' (N, K) ids
    pending: list = []

    def flush():
        if not pending:
            return
        x = torch.stack([p[0] for p in pending])
        tn = torch.stack([p[1] for p in pending])
        routing = None
        if routed and all(p[5] is not None for p in pending):
            routing = [torch.stack(layer) for layer in
                       zip(*[p[5] for p in pending])]
        logits = logits_of(reference, "float32", device, tree, c, x, tn,
                           routing, r)
        if control:
            low = logits_of(reference, "tf32", device, tree, c, x, tn,
                            routing, Readings())
        for i, (_, _, y, sel, g, _) in enumerate(pending):
            s = logits[i] + mask + g
            best = s.max(-1).values
            gap = best - s.gather(-1, y[:, None])[:, 0]
            r.widest_gap = max(r.widest_gap, float(gap[sel].max()))
            r.tokens += int(sel.sum())
            if control:
                ctok = (low[i] + mask + g).argmax(-1)
                cgap = (best - s.gather(-1, ctok[:, None])[:, 0])[sel]
                r.control_gap = max(r.control_gap, float(cgap.max()))
                r.control_flips += int((ctok != y)[sel].sum())
        pending.clear()

    for tr in trajs:
        rows, N = tr.tokens.shape
        y = torch.as_tensor(tr.tokens, dtype=torch.long, device=device)
        r.mask_left += int((y == mask_id).sum())
        gen = torch.Generator(device=device).manual_seed(tr.seed)
        tau = draw_tau(gen, probs, rows, N, shared)
        times = torch.unique(tau).flip(0).tolist()
        r.nfe_wrong += int(tr.nfe != len(times))
        for i, t in enumerate(times):
            g = gumbel(gen, (rows, N, K), device)
            x_t = torch.where(tau > t, y, mask_id)
            tn = torch.full((rows,), np.float32(t) / np.float32(T),
                            dtype=torch.float32, device=device)
            layers = (tr.routing[i] if routed and tr.routing is not None
                      and i < len(tr.routing) else None)
            for b in range(rows):
                pending.append((x_t[b], tn[b], y[b], tau[b] == t, g[b],
                                None if layers is None
                                else [ids[b] for ids in layers]))
            if len(pending) >= block_rows:
                flush()
    flush()
    return r


def check_logits(kept: list, tree: dict, c: dict, *, device,
                 control: bool = False,
                 readings: Readings | None = None,
                 reference=model) -> Readings:
    """The widest gap between the logits of the network calls the window
    made, ``kept`` as (x_t, t_norm, logits, routing) on the device, and
    ``reference``'s logits on the same inputs, a routed reference's
    forced to the call's routing; ``control`` also reads the TF32
    reference's widest gap from the float32 one, a routed reference's
    with the TF32 reference's own choices forced into the float32 one,
    and their shortfall."""
    r = readings or Readings()
    for x, tn, logits, routing in kept:
        ref = logits_of(reference, "float32", device, tree, c, x, tn,
                        routing, r)
        r.logit_err = max(r.logit_err, float((logits - ref).abs().max()))
        r.calls += 1
        if not control:
            continue
        if is_routed(reference):
            with reference.precision("tf32", device):
                low, chosen = reference.forward_chosen(tree, c, x, tn)
            with reference.precision("float32", device):
                ref, short = reference.forward_routed(tree, c, x, tn, chosen)
            r.control_routing_shortfall = max(r.control_routing_shortfall,
                                              short)
        else:
            with reference.precision("tf32", device):
                low = reference.forward(tree, c, x, tn)
        r.control_logit_err = max(r.control_logit_err,
                                  float((low - ref).abs().max()))
    return r
