"""Faults planted under the timed path, and the control, for the tests
and for ``calibrate.py --fault``.  Each takes a ``setattr(obj, name,
value)`` (pytest's ``monkeypatch.setattr``, or a plain one that the
caller undoes) and breaks one thing the check must catch."""
from __future__ import annotations

import torch

from dndmbench import harness, routes, weights
from dndmbench.reference.routing import is_routed


def state_unchanged(setattr_):
    """Every call returns its tokens as they came in."""
    from repro_torch.core import decode
    setattr_(decode, "fused_update", lambda logits, x, *a, **k: x)
    setattr_(decode, "decode_tokens", lambda logits, *a, **k: (
        torch.full(logits.shape[:2], logits.shape[-1] - 1,
                   dtype=torch.int32, device=logits.device),
        torch.zeros(logits.shape[:2], device=logits.device)))


def half_batch_left_out(setattr_):
    """The denoiser computes the first half of the rows; the rest get
    the mean of those."""
    from repro_torch.models import model
    forward = model.Model.forward

    def half(self, tokens, *a, **k):
        h = max(1, tokens.shape[0] // 2)
        out = forward(self, tokens[:h], *[x[:h] if torch.is_tensor(x)
                                          and x.dim() else x for x in a], **k)
        rest = out.mean(0, keepdim=True).expand(tokens.shape[0] - h,
                                                *out.shape[1:])
        return torch.cat([out, rest])
    setattr_(model.Model, "forward", half)


def token_altered(setattr_):
    """The decode kernels' chosen token is moved to the next id (never
    to [MASK]) where it is produced."""
    from repro_torch.kernels.decode_scores import ops as sops
    from repro_torch.kernels.dndm_update import ops as dops
    upd, scores = dops.dndm_update, sops.decode_scores

    def bad_update(logits, x, tau, t, **k):
        out = upd(logits, x, tau, t, **k)
        K = logits.shape[-1]
        return torch.where(tau == t, (out + 1) % (K - 1), out)

    def bad_scores(logits, **k):
        tok, s = scores(logits, **k)
        return (tok + 1) % (logits.shape[-1] - 1), s
    # the wrappers count launches on the module's function
    bad_update.launches, bad_scores.launches = 0, 0
    setattr_(dops, "dndm_update", bad_update)
    setattr_(sops, "decode_scores", bad_scores)


def finished_twice(setattr_):
    """Every request is recorded as finished a second time, as when a
    finished row is not freed and completes again."""
    from repro_torch.serving import scheduler

    def again(step):
        def wrapped(self, *a, **k):
            before = set(self.done)
            out = step(self, *a, **k)
            for rid in set(self.done) - before:
                self.done[rid] = self.done[rid]
            return out
        return wrapped
    setattr_(scheduler.ContinuousScheduler, "pump",
             again(scheduler.ContinuousScheduler.pump))
    setattr_(scheduler.BatchScheduler, "run",
             again(scheduler.BatchScheduler.run))


def router_sort(setattr_, sort):
    """The port's MoE router sorts its scores with ``sort(scores, K,
    **kw)`` in place of ``torch.sort``, K the layer's experts per
    token."""
    from repro_torch.models import moe
    route = moe.MoE.route

    class Torch:
        """``torch`` as the router's module sees it, but for ``sort``."""

        def __init__(self, K):
            self.sort = lambda x, **kw: sort(x, K, **kw)

        def __getattr__(self, name):
            return getattr(torch, name)

    def routed(self, *a, **k):
        moe.torch = Torch(self.cfg.experts_per_token)
        try:
            return route(self, *a, **k)
        finally:
            moe.torch = torch
    setattr_(moe.MoE, "route", routed)


def routing_swapped(setattr_):
    """At every routed layer, the first token goes to its (K+1)-th
    expert in place of its K-th, where the router chooses."""
    def swapped(x, K, **kw):
        v, i = torch.sort(x, **kw)
        if x.shape[-1] > K:
            order = torch.arange(x.shape[-1], device=x.device)
            order[[K - 1, K]] = order[[K, K - 1]]
            first = (0,) * (x.dim() - 1)
            v, i = v.clone(), i.clone()
            v[first], i[first] = v[first][order], i[first][order]
        return v, i
    router_sort(setattr_, swapped)


def control(setattr_, doc: dict, seed: int, device) -> None:
    """The control: the configuration's reference in the program's place,
    its products in TF32, on the run's weights; a routed reference
    records its own expert choices as the program's."""
    from repro_torch.models import model
    ref = harness.parts(doc).reference
    tree = weights.make(doc["model"], harness.subseed(seed, 0), device, ref)

    def denoise_fn(self, cond=None):
        def fn(x, t, c):
            with ref.precision("tf32", device):
                if not is_routed(ref):
                    return ref.forward(tree, doc["model"], x, t)
                logits, chosen = ref.forward_chosen(tree, doc["model"], x, t)
            for ids in chosen:
                routes.record(ids)
            return logits
        return fn
    setattr_(model.Model, "denoise_fn", denoise_fn)


FAULTS = {"state_unchanged": state_unchanged,
          "half_batch_left_out": half_batch_left_out,
          "token_altered": token_altered,
          "finished_twice": finished_twice}
# the faults only a routed configuration can have
ROUTED_FAULTS = {"routing_swapped": routing_swapped}
