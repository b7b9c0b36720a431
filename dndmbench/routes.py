"""The program's expert choices, recorded in the window of a routed
configuration (one whose reference defines ``forward_routed``), so that
the reference can be forced to them.

While :func:`recording` is open, the port's ``MoE.route`` is wrapped:
while its :class:`Recording` is ``on``, each routed layer's (tokens, K)
expert ids are appended as an int32 copy on the device, with no
synchronisation; when it is off, the wrapper costs one flag test.
:meth:`Recording.take` hands over one network call's layers, in the
order the forward reached them.  The control, the reference in the
program's place, records its own choice through :func:`record`.
"""
from __future__ import annotations

import contextlib

import torch


class Recording:
    """The routed layers recorded since the last :meth:`take`."""

    def __init__(self):
        self.on = False
        self.layers: list[torch.Tensor] = []

    def take(self, B: int, S: int) -> list[torch.Tensor]:
        """The layers recorded for one network call of (B, S) tokens, as
        (B, S, K) ids, and an empty record."""
        out = [ids.view(B, S, ids.shape[-1]) for ids in self.layers]
        self.layers = []
        return out


_open: Recording | None = None


def record(expert_idx: torch.Tensor) -> None:
    """Append one routed layer's (..., K) expert ids to the open
    recording, if it is on."""
    if _open is not None and _open.on:
        _open.layers.append(expert_idx.reshape(-1, expert_idx.shape[-1])
                            .to(torch.int32, copy=True))


@contextlib.contextmanager
def recording():
    """Wrap the port's ``MoE.route`` for the block; yields the
    :class:`Recording`, off until its owner turns it on."""
    global _open
    from repro_torch.models import moe
    if _open is not None:
        raise RuntimeError("a routing recording is already open")
    route = moe.MoE.route

    def recorded(self, xg, C, w=None):
        h, state, aux = route(self, xg, C, w)
        record(state["expert_idx"])
        return h, state, aux
    moe.MoE.route = recorded
    _open = Recording()
    try:
        yield _open
    finally:
        moe.MoE.route = route
        _open = None
