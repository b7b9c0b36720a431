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
``moe_local_groups`` groups of tokens, batched over the group axis;
"shard_map" runs the global dispatch, as the JAX package does without a
device mesh.  The sharded dispatch comes with the multi-device slice.

Auxiliary losses: the load-balance loss, the router z-loss and the share
of dropped assignments, returned for the trainer to weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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
        T = B * S
        G = cfg.moe_local_groups
        groups = (G if cfg.moe_dispatch == "local" and G > 1 and T % G == 0
                  else 1)
        C = capacity(cfg, T // groups)
        h, state, aux = self.route(x.reshape(groups, T // groups, d), C)
        y = self.combine(self.expert_ffn(h), state)
        return y.reshape(B, S, d), aux

    def route(self, xg: torch.Tensor, C: int):
        """(G, T, d) tokens in G groups -> ((G, E, C, d) expert buffers,
        combine state, aux losses averaged over the groups).

        The state holds, per group: ``expert_idx`` (T, K), each token's
        experts, best first; and, over the T*K assignments sorted by
        expert (stable, so in token order within an expert), ``st`` the
        token, ``sg`` the normalized gate, ``keep`` whether it fits the
        capacity and ``slot`` its buffer row (``E * C`` if dropped)."""
        cfg = self.cfg
        G, T, d = xg.shape
        E, K = cfg.n_experts, cfg.experts_per_token
        dev = xg.device

        logits = (xg @ self.router).float()                     # (G, T, E)
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
        aux = {"load_balance": (E * (me * fe).sum(-1)).mean(0),
               "router_z": (torch.logsumexp(logits, -1) ** 2).mean(-1)
               .mean(0),
               "dropped_frac": (1.0 - keep.float().mean(-1)).mean(0)}
        state = {"expert_idx": expert_idx, "st": st, "sg": sg, "keep": keep,
                 "slot": slot}
        return h, state, aux

    def expert_ffn(self, h: torch.Tensor) -> torch.Tensor:
        """(G, E, C, d) -> (G, E, C, d) through each expert's (Sw)iGLU FFN,
        one batched product per weight, over the experts."""
        G, E, C, d = h.shape
        hb = h.transpose(0, 1).reshape(E, G * C, d)
        if self.cfg.mlp_type == "swiglu":
            a = F.silu(torch.bmm(hb, self.gate)) * torch.bmm(hb, self.up)
        else:
            a = F.gelu(torch.bmm(hb, self.up), approximate="tanh")
        return torch.bmm(a, self.down).view(E, G, C, d).transpose(0, 1)

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
