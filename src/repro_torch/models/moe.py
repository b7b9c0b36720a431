"""Mixture-of-Experts MLP with sort-based capacity dispatch, the port of
``repro/models/moe.py``'s single-device path.

Top-k routing (Mixtral: 8 experts top-2; Llama-4-Maverick: 128 top-1).
Tokens are dispatched to per-expert buffers of capacity
``C = ceil8(top_k * tokens / E * capacity_factor)`` by a stable sort on
expert id: the k-th assignment to an expert, in token order, takes slot
k of its buffer, and an assignment past C is dropped (its expert term is
zero; the residual path still carries the token).  Every dropped
assignment is written to one trash row, slot ``E * C``, which is sliced
away before the experts run: the duplicate writes there are harmless
only because nothing reads that row.

The expert FFNs are batched products over the stacked weights
(E, d, ff), plain ``torch.bmm`` in the model's dtype (f32 stays f32: the
port keeps TF32 off).  Routing ties break to the lower expert id, as
``jax.lax.top_k`` breaks them (``torch.topk`` does not promise an order),
so the top k come from a stable descending sort.

Nothing here makes the host wait for the device: expert counts come from
``scatter_add_`` (``torch.bincount`` would synchronise to size its
output), and every index stays on the device.

The combine scatters each kept assignment's gated output onto its token
with ``index_add_``, which runs on atomics on the card.  A token receives
at most ``experts_per_token`` addends onto zero; with K <= 2 the sum is
exact in either order (a + b == b + a), so the result does not depend on
the order the atomics land in.  Mixtral has K = 2 and Llama-4 K = 1; a
config with K > 2 would need an ordered sum to stay deterministic.

``moe_dispatch == "local"`` dispatches within each of
``moe_local_groups`` groups of tokens, batched over the group axis.
"shard_map" is the reference's ``_apply_shard_map``: under an ambient
mesh (``launch/mesh.py::use_mesh``) with a "model" axis, every rank runs
the dispatch on local tensors, its data shard of the tokens and its
shard of the expert weights, so that the sort, the FIFO rank and the
scatters never meet DTensor's propagation:

  * expert parallel when the experts divide the model axis (m): each
    model rank routes its 1/m slice of the tokens at ``capacity(cfg,
    T / m)``, one ``all_to_all_single`` over the model group sends the
    (E, C, d) buffer to the experts' ranks, the local E/m experts run at
    full ``d_ff``, the reverse all-to-all brings the outputs home, and an
    all-gather over the model group rebuilds the tokens;
  * tensor parallel otherwise: the local (E, d, ff/m) and (E, ff/m, d)
    shards, then one all-reduce (sum) over the model group.

Without an ambient mesh, without a "model" axis, with a batch that does
not divide the data axes or with ``d_ff % m != 0`` "shard_map" falls
through to the global dispatch, as the reference's does; expert-parallel
tokens per data shard that do not split over the model axis raise, where
the reference's equal slices fail in its gather.  A DTensor input that
reaches the global dispatch runs it replicated (``launch/spmd.py``).

Auxiliary losses: the load-balance loss, the router z-loss and the share
of dropped assignments, returned for the trainer to weight.  The sharded
dispatch sums their statistics (router probabilities, expert counts, the
squared logsumexps, kept assignments) over every rank that holds other
tokens before it forms them, so that they equal the global dispatch's;
the reference averages each shard's own terms over the data axes
instead, which differs for the load-balance loss, a product of two
means.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import AllReduce, is_sharded
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, truncated_normal


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert buffer rows for ``n_tokens`` tokens, rounded up to 8."""
    c = int(cfg.experts_per_token * n_tokens / cfg.n_experts
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


class MoE(nn.Module):
    """The MoE MLP.  Weights: ``router`` (d, E), ``gate`` (E, d, ff; SwiGLU
    only), ``up`` (E, d, ff) and ``down`` (E, ff, d), the JAX tree's
    names, so checkpoints load unchanged."""

    def __init__(self, generator, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
        dt = getattr(torch, cfg.dtype)
        # draw order of the JAX key split: router, gate, up, down
        self.router = dense_init(generator, d, E, dt, device, scale=0.1)
        if cfg.mlp_type == "swiglu":
            self.gate = truncated_normal(generator, (E, d, ff), d ** -0.5,
                                         dt, device)
        self.up = truncated_normal(generator, (E, d, ff), d ** -0.5, dt,
                                   device)
        self.down = truncated_normal(generator, (E, ff, d), ff ** -0.5, dt,
                                     device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """x: (B, S, d) -> (y, aux losses)."""
        cfg = self.cfg
        B, S, d = x.shape
        if cfg.moe_dispatch == "shard_map":
            mesh = self._dispatch_mesh(B)
            if mesh is not None:
                return _sharded_dispatch(self, x, mesh)
        return self._global(x)

    def _global(self, x: torch.Tensor, w: dict | None = None):
        """The global (or "local"-grouped) dispatch of whole tensors, with
        the weights ``w`` (the module's own by default)."""
        cfg = self.cfg
        B, S, d = x.shape
        T = B * S
        G = cfg.moe_local_groups
        groups = (G if cfg.moe_dispatch == "local" and G > 1 and T % G == 0
                  else 1)
        C = capacity(cfg, T // groups)
        h, state, aux = self.route(x.reshape(groups, T // groups, d), C, w)
        y = self.combine(self.expert_ffn(h, w), state)
        return y.reshape(B, S, d), aux

    def _dispatch_mesh(self, B: int):
        """The ambient mesh when the sharded dispatch applies to a batch
        of ``B``, else None (the reference's fall-through)."""
        mesh = mesh_lib.current_mesh()
        if mesh is None or "model" not in mesh_lib.axis_names(mesh):
            return None
        n_data = mesh_lib.axis_size(mesh, *mesh_lib.batch_axes(mesh))
        if B % n_data or self.cfg.d_ff % mesh_lib.axis_size(mesh, "model"):
            return None
        return mesh

    def weights(self) -> dict:
        """The expert weights by their JAX names."""
        names = ("router", "gate", "up", "down") if hasattr(self, "gate") \
            else ("router", "up", "down")
        return {k: getattr(self, k) for k in names}

    def route(self, xg: torch.Tensor, C: int, w: dict | None = None):
        """(G, T, d) tokens in G groups -> ((G, E, C, d) expert buffers,
        combine state, aux losses averaged over the groups).  ``w`` holds
        the weights to use (the module's own by default).

        The state holds, per group: ``expert_idx`` (T, K), each token's
        experts, best first; and, over the T*K assignments sorted by
        expert (stable, so in token order within an expert), ``st`` the
        token, ``sg`` the normalized gate, ``keep`` whether it fits the
        capacity and ``slot`` its buffer row (``E * C`` if dropped); and
        the statistics of the aux terms: ``probs`` (G, T, E), ``counts``
        (G, E) and ``lse2`` (G, T), the squared logsumexp of the router
        logits."""
        cfg = self.cfg
        G, T, d = xg.shape
        E, K = cfg.n_experts, cfg.experts_per_token
        dev = xg.device
        router = self.router if w is None else w["router"]

        logits = (xg @ router).float()                          # (G, T, E)
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        gate_vals, expert_idx = top_p[..., :K], top_e[..., :K]
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(
            min=1e-9)

        flat_e = expert_idx.reshape(G, T * K)
        order = torch.argsort(flat_e, dim=-1, stable=True)
        se = flat_e.gather(1, order)
        st = order // K                # assignment a belongs to token a // K
        sg = gate_vals.reshape(G, T * K).gather(1, order)
        counts = torch.zeros((G, E), dtype=torch.int64,
                             device=dev).scatter_add_(
            1, flat_e, torch.ones_like(flat_e))
        starts = counts.cumsum(-1) - counts
        rank = torch.arange(T * K, device=dev) - starts.gather(1, se)
        keep = rank < C
        slot = torch.where(keep, se * C + rank, E * C)

        g = torch.arange(G, device=dev)[:, None]
        rows = xg.reshape(G * T, d).index_select(0, (g * T + st).reshape(-1))
        buf = xg.new_zeros((G * (E * C + 1), d)).index_copy_(
            0, (g * (E * C + 1) + slot).reshape(-1), rows)
        h = buf.view(G, E * C + 1, d)[:, :E * C].reshape(G, E, C, d)

        me = probs.mean(1)                                       # (G, E)
        fe = counts.float() / (T * K)
        lse2 = torch.logsumexp(logits, -1) ** 2
        aux = {"load_balance": (E * (me * fe).sum(-1)).mean(0),
               "router_z": lse2.mean(-1).mean(0),
               "dropped_frac": (1.0 - keep.float().mean(-1)).mean(0)}
        state = {"expert_idx": expert_idx, "st": st, "sg": sg, "keep": keep,
                 "slot": slot, "probs": probs, "counts": counts,
                 "lse2": lse2}
        return h, state, aux

    def expert_ffn(self, h: torch.Tensor, w: dict | None = None
                   ) -> torch.Tensor:
        """(G, E, C, d) -> (G, E, C, d) through each expert's (Sw)iGLU FFN,
        one batched product per weight, over the experts (``w`` as in
        :meth:`route`; its E may be a shard's)."""
        w = self.weights() if w is None else w
        G, E, C, d = h.shape
        hb = h.transpose(0, 1).reshape(E, G * C, d)
        if self.cfg.mlp_type == "swiglu":
            a = F.silu(torch.bmm(hb, w["gate"])) * torch.bmm(hb, w["up"])
        else:
            a = F.gelu(torch.bmm(hb, w["up"]), approximate="tanh")
        return torch.bmm(a, w["down"]).view(E, G, C, d).transpose(0, 1)

    def combine(self, out: torch.Tensor, state: dict) -> torch.Tensor:
        """(G, E, C, d) expert outputs -> (G, T, d) gated token outputs."""
        G, E, C, d = out.shape
        EC = E * C
        st, slot = state["st"], state["slot"]
        T = state["expert_idx"].shape[1]
        g = torch.arange(G, device=out.device)[:, None]
        picked = out.reshape(G * EC, d).index_select(
            0, (g * EC + slot.clamp(max=EC - 1)).reshape(-1))
        gathered = torch.where(state["keep"].reshape(-1, 1), picked, 0.0)
        return out.new_zeros((G * T, d)).index_add_(
            0, (g * T + st).reshape(-1),
            gathered * state["sg"].reshape(-1, 1).to(out.dtype)).view(G, T, d)


# ------------------------------------------------------------------
# The sharded dispatch ("shard_map")
# ------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group``: chunk j of dim 0 goes to rank
    j, and chunk i of the output came from rank i.  It is its own
    transpose, so the backward sends the gradients the same way."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group), None


class _AllGather(torch.autograd.Function):
    """The ranks' (n, ...) tensors concatenated along dim 0.  The output is
    replicated, so its gradient is too: each rank keeps its own rows."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.rank, ctx.size = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(ctx.size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size)[ctx.rank], None


def _sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for a in axes:
        if mesh_lib.axis_size(mesh, a) > 1:
            x = AllReduce.apply(x, mesh.get_group(a))
    return x


def _local(t: torch.Tensor, mesh, shard: dict, grad: dict) -> torch.Tensor:
    """This rank's block of ``t`` under ``shard`` ({axis: tensor dim}; the
    other axes replicate).  A DTensor is redistributed there and its
    local block's gradient is declared ``grad`` ({axis: placement}; the
    other axes Partial, as a rank's rows add to the sum); a whole tensor,
    the same on every rank, is sliced."""
    names = mesh_lib.axis_names(mesh)
    if is_sharded(t):
        from torch.distributed.tensor import Partial, Replicate, Shard
        pl = [Shard(shard[a]) if a in shard else Replicate() for a in names]
        gp = [grad.get(a, Partial()) for a in names]
        return t.redistribute(mesh, pl).to_local(grad_placements=gp)
    for a in names:
        if a in shard and mesh_lib.axis_size(mesh, a) > 1:
            t = t.chunk(mesh_lib.axis_size(mesh, a), dim=shard[a])[
                mesh.get_local_rank(a)]
    return t


def _sharded_dispatch(moe: MoE, x: torch.Tensor, mesh):
    """The reference's ``_apply_shard_map`` (module docstring) on this
    rank's blocks; (y, aux) with ``x``'s type: a DTensor ``x`` (batch on
    the data axes) gives a DTensor ``y`` placed so and replicated aux
    terms, a whole ``x`` a whole ``y``."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = moe.cfg
    E, K = cfg.n_experts, cfg.experts_per_token
    names = mesh_lib.axis_names(mesh)
    dax = mesh_lib.batch_axes(mesh)
    m = mesh_lib.axis_size(mesh, "model")
    model_group = mesh.get_group("model")
    ep = E % m == 0 and E >= m
    data_shard = {a: 0 for a in dax}
    xl = _local(x, mesh, data_shard, {a: Shard(0) for a in dax})
    w_shard = ({"gate": 0, "up": 0, "down": 0} if ep
               else {"gate": 2, "up": 2, "down": 1})
    w = {k: _local(p, mesh, {} if k == "router" else {"model": w_shard[k]},
                   {} if k == "router" else {"model": Shard(w_shard[k])})
         for k, p in moe.weights().items()}
    Bl, S, d = xl.shape
    xt = xl.reshape(Bl * S, d)
    if ep:
        # activations are replicated over "model": each model rank routes
        # its 1/m of the tokens, and the experts' ranks receive them
        if xt.shape[0] % m:
            raise ValueError(f"{xt.shape[0]} tokens per data shard do not "
                             f"split over {m} model ranks")
        Tm = xt.shape[0] // m
        mi = mesh.get_local_rank("model")
        h, state, _ = moe.route(xt[mi * Tm:(mi + 1) * Tm][None],
                                capacity(cfg, Tm), w)
        C = h.shape[2]
        h = _AllToAll.apply(h[0], model_group)              # (E, C, d)
        h = h.view(m, E // m, C, d).transpose(0, 1).reshape(E // m, m * C,
                                                              d)
        out = moe.expert_ffn(h[None], w)[0]                 # (E/m, mC, d)
        out = out.view(E // m, m, C, d).transpose(0, 1).reshape(E, C, d)
        out = _AllToAll.apply(out, model_group)
        y = moe.combine(out[None], state)[0]
        y = _AllGather.apply(y, model_group)
        n_tok, model_share = Tm * m, 1.0
    else:
        h, state, _ = moe.route(xt[None], capacity(cfg, xt.shape[0]), w)
        y = moe.combine(moe.expert_ffn(h, w), state)[0]
        y = AllReduce.apply(y, model_group)                 # ff partials
        # every model rank routed the same tokens: each adds 1/m of them
        n_tok, model_share = xt.shape[0], 1.0 / m
    # the aux terms of every rank's tokens together, as the global
    # dispatch forms them
    T = n_tok * mesh_lib.axis_size(mesh, *dax)
    stats = torch.cat([state["probs"][0].sum(0), state["counts"][0].float(),
                       state["lse2"][0].sum()[None],
                       state["keep"][0].float().sum()[None]]) * model_share
    stats = _sum_over(stats, mesh, (*dax, "model"))
    me, fe = stats[:E] / T, stats[E:2 * E] / (T * K)
    aux = {"load_balance": E * (me * fe).sum(),
           "router_z": stats[2 * E] / T,
           "dropped_frac": 1.0 - stats[2 * E + 1] / (T * K)}
    y = y.view(Bl, S, d)
    if is_sharded(x):
        from torch.distributed.tensor import DTensor
        rep = [Replicate()] * len(names)
        y = DTensor.from_local(y, mesh, [Shard(0) if a in dax else Replicate()
                                         for a in names])
        aux = {k: DTensor.from_local(v, mesh, rep) for k, v in aux.items()}
        return y, aux
    for a in reversed(dax):                   # inner axis first
        if mesh_lib.axis_size(mesh, a) > 1:
            y = _AllGather.apply(y, mesh.get_group(a))
    return y, aux
