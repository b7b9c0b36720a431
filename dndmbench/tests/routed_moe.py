"""A routed reference for the CPU tests, copied into a copy of the
benchmark as ``reference/moe_routed.py``: the plain forward of the port's
"moe" block, x + attn(norm(x)), then x + moe(norm(x)), where moe routes
each token to its top K experts by the router's softmax (ties to the
lower expert), weighs them by the gates renormalised over the K, and runs
every SwiGLU expert on every token.  Its choice goes through
``routing.Route``, so it defines ``forward_routed`` and
``forward_chosen``."""
import math

import torch

from dndmbench.reference import routing
from dndmbench.reference.model import (_slot, attention, expand, mlp, mm,
                                       precision, rmsnorm, time_embed)

__all__ = ["expand", "param_shapes", "forward", "forward_routed",
           "forward_chosen", "precision", "leaf_rule"]


def param_shapes(c):
    c = expand(c)
    d, V, hd = c["d_model"], c["vocab_size"], c["head_dim"]
    H, KV, ff, E = c["n_heads"], c["n_kv_heads"], c["d_ff"], c["n_experts"]
    out = {"embed": (V, d), "ln_f/scale": (d,), "head": (d, V),
           "time/w1": (d, d), "time/w2": (d, d)}
    leaves = {"ln1/scale": (d,), "attn/wq": (d, H * hd),
              "attn/wk": (d, KV * hd), "attn/wv": (d, KV * hd),
              "attn/wo": (H * hd, d), "ln2/scale": (d,),
              "moe/router": (d, E), "moe/gate": (E, d, ff),
              "moe/up": (E, d, ff), "moe/down": (E, ff, d)}
    for i, kind in enumerate(c["block_unit"]):
        if kind != "moe":
            raise ValueError(f"this reference has no block kind {kind!r}")
        out.update({f"unit/b{i}/{k}": (c["n_super"],) + v
                    for k, v in leaves.items()})
    return out


def leaf_rule(path, shape, c):
    """An expert's down projection joins the residual stream."""
    if path.endswith("moe/down"):
        return "normal", 1.0 / math.sqrt(shape[-2]) / math.sqrt(
            c["n_layers"]), 0.0
    return None


def moe(w, h, c, route):
    probs = torch.softmax(mm(h, w["router"]), dim=-1)
    ids = route.pick(probs, c["experts_per_token"])
    gates = probs.gather(-1, ids)
    gates = gates / gates.sum(-1, keepdim=True)
    share = torch.zeros_like(probs).scatter(-1, ids, gates)
    y = torch.zeros_like(h)
    for e in range(c["n_experts"]):
        expert = {k: w[k][e] for k in ("gate", "up", "down")}
        y = y + share[..., e:e + 1] * mlp(expert, h, c)
    return y


def _forward(tree, c, tokens, t, route):
    c = expand(c)
    unit = c["block_unit"]
    h = tree["embed"][tokens.long()]
    if c["time_conditioning"]:
        h = h + time_embed(tree["time"], t, c["d_model"])[:, None]
    for i in range(len(c["block_pattern"])):
        j, slot = divmod(i, len(unit))
        p = _slot(tree["unit"][f"b{slot}"], j)
        h = h + attention(p["attn"], rmsnorm(h, p["ln1"]["scale"],
                                             c["norm_eps"]), c)
        h = h + moe(p["moe"], rmsnorm(h, p["ln2"]["scale"], c["norm_eps"]),
                    c, route)
    h = rmsnorm(h, tree["ln_f"]["scale"], c["norm_eps"])
    return mm(h, tree["head"])


def forward(tree, c, tokens, t):
    return _forward(tree, c, tokens, t, routing.Route())


def forward_routed(tree, c, tokens, t, forced):
    route = routing.Route(forced)
    logits = _forward(tree, c, tokens, t, route)
    return logits, route.finish()


def forward_chosen(tree, c, tokens, t):
    route = routing.Route()
    return _forward(tree, c, tokens, t, route), route.chosen
