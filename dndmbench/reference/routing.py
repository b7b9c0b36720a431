"""The expert choice of a routed reference, open to forcing.

A top-K router's choice flips where two experts' scores lie within
rounding of each other, and a flipped expert changes a token's output by
a whole expert's share.  So a routed configuration is judged with the
program's choice forced into the reference: each routed layer runs the
reference's own router, then computes with the program's experts, gated
by the reference's own scores at those experts; the choice itself is
held apart, by how far the program's experts fall below the reference's
own K-th best selection score (:func:`shortfall`).

A routed reference builds its forward on :class:`Route`: each routed
layer calls :meth:`Route.pick` with its selection scores and K.
"""
from __future__ import annotations

import math

import torch


def is_routed(reference) -> bool:
    """Whether ``reference`` forces the program's expert choices."""
    return hasattr(reference, "forward_routed")


def top_k(select: torch.Tensor, K: int) -> torch.Tensor:
    """(..., E) selection scores -> (..., K) expert ids, best first, ties
    to the lower id (the port's stable descending sort)."""
    return torch.sort(select, dim=-1, descending=True, stable=True
                      ).indices[..., :K]


def shortfall(select: torch.Tensor, ids: torch.Tensor, K: int) -> float:
    """The largest, over tokens, of the K-th best score of ``select``
    (..., E) less the score of a chosen expert of ``ids`` (..., K),
    floored at 0; ``inf`` where a token's ids repeat or fall outside
    0..E-1."""
    E = select.shape[-1]
    if ids.shape[-1] != K or bool(((ids < 0) | (ids >= E)).any()):
        return math.inf
    s = ids.sort(dim=-1).values
    if bool((s[..., 1:] == s[..., :-1]).any()):
        return math.inf
    kth = select.topk(K, dim=-1).values[..., -1:]
    return float((kth - select.gather(-1, ids)).clamp(min=0.0).max())


class Route:
    """The expert choice of one forward.  ``forced`` holds one (B, S, K)
    id tensor per routed layer, in the order the forward reaches them,
    or is None: each layer takes its own top K.  ``chosen`` gathers the
    ids each layer computed with; ``shortfall`` the largest shortfall of
    the forced ids, ``inf`` where they do not fit."""

    def __init__(self, forced: list | None = None):
        self.forced, self.chosen, self.shortfall = forced, [], 0.0

    def pick(self, select: torch.Tensor, K: int) -> torch.Tensor:
        """(B, S, E) selection scores of the next routed layer -> the
        (B, S, K) ids it computes with."""
        own = top_k(select, K)
        ids = own
        if self.forced is not None:
            n = len(self.chosen)
            f = self.forced[n] if n < len(self.forced) else None
            if f is None or tuple(f.shape) != tuple(own.shape):
                self.shortfall = math.inf
            else:
                f = f.to(device=select.device, dtype=torch.long)
                self.shortfall = max(self.shortfall, shortfall(select, f, K))
                if self.shortfall < math.inf:
                    ids = f
        self.chosen.append(ids)
        return ids

    def finish(self) -> float:
        """The shortfall of the whole forward: ``inf`` also where the
        forced layers are not the forward's routed layers in number."""
        if self.forced is not None and len(self.forced) != len(self.chosen):
            return math.inf
        return self.shortfall
