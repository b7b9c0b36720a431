"""Top-level Model: embeddings, the layer stack, diffusion time
conditioning, frontend fusion, the LM head, and the samplers' denoiser
adapter.

Where the JAX package stacks each unit slot's weights along a leading
``n_super`` axis and runs a ``lax.scan``, the port holds one module per
layer in an ``nn.ModuleList`` (``blocks[j * len(unit) + i]`` is unit slot
``i`` of superblock ``j``; ``models/convert.py`` maps JAX checkpoints
onto it).  "shared_attn" blocks (Zamba) hold one weight set,
``self.shared``, run at every "shared_attn" site of the pattern; the
sites themselves are parameterless placeholders in ``blocks``, so every
parameter has exactly one name.  A config with a ``frontend`` (the
audio/vision stub, ``models/frontend.py``) takes precomputed embeddings
over its first ``frontend_tokens`` positions.  ``init_cache`` and
``decode_step`` run the stack causally one token at a time over a cache
per entry of ``blocks`` (a "shared_attn" site has its own cache and the
one shared weight set); the caches are updated in place.

Float32 products stay float32 on the card: the port relies on PyTorch's
default ``torch.backends.cuda.matmul.allow_tf32 == False``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import device as device_lib
from repro_torch.models import blocks, frontend
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RMSNorm, TimeEmbed, dense_init


class Model(nn.Module):
    """The denoiser network.  Weights are initialized from ``seed`` with
    a ``torch.Generator`` on ``device`` (``None`` means ``cuda``, which
    must exist), or loaded from a JAX checkpoint with
    :func:`repro_torch.models.convert.load_params`."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.unit, self.n_super = cfg.superblock()
        dev = device_lib.resolve(device)
        dt = getattr(torch, cfg.dtype)
        g = torch.Generator(device=dev).manual_seed(seed)
        self.embed = dense_init(g, cfg.vocab_size, cfg.d_model, dt, dev,
                                scale=cfg.vocab_size ** 0.5 * 0.02)
        self.ln_f = RMSNorm(cfg.d_model, dt, dev, cfg.norm_eps)
        self.head = (None if cfg.tie_embeddings else
                     dense_init(g, cfg.d_model, cfg.vocab_size, dt, dev))
        self.time = (TimeEmbed(g, cfg.d_model, dt, dev)
                     if cfg.time_conditioning else None)
        # draw order of the JAX init: embed, head, time, shared, the layers
        self.shared = (blocks.build("shared_attn", g, cfg, dev)
                       if "shared_attn" in self.unit else None)
        self.blocks = nn.ModuleList(
            nn.Identity() if kind == "shared_attn"
            else blocks.build(kind, g, cfg, dev)
            for kind in cfg.block_pattern)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor, t: torch.Tensor | None = None,
                frontend_embeds: torch.Tensor | None = None,
                causal: bool | None = None, return_aux: bool = False):
        """tokens: (B, S) int -> logits (B, S, V); with ``return_aux``,
        (logits, aux losses), the JAX ``Model.forward``'s pair.
        ``frontend_embeds`` (B, F, d) replace the first F positions after
        the time embedding.  The aux terms ``load_balance`` and
        ``router_z`` are f32 sums over the "moe" blocks (zeros without
        any)."""
        cfg = self.cfg
        if causal is None:
            causal = not cfg.bidirectional
        h = (_sharded_embedding(tokens, self.embed)
             if device_lib.is_sharded(self.embed)
             else F.embedding(tokens, self.embed))
        if t is not None and self.time is not None:
            h = h + self.time(t)[:, None]
        h = frontend.fuse(h, frontend_embeds)
        terms = []
        for kind, blk in zip(cfg.block_pattern, self.blocks):
            h, aux = self._block(kind, blk)(h, causal=causal)
            if aux is not None:
                terms.append(aux)
        h = self.ln_f(h)
        logits = h @ (self.embed.T if self.head is None else self.head)
        if not return_aux:
            return logits
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        return logits, {k: sum((a[k] for a in terms), zero)
                        for k in ("load_balance", "router_z")}

    def denoise_fn(self, cond: dict | None = None):
        """Wrap into the samplers' ``denoise_fn(x_t, t, cond)`` contract.

        ``cond`` may hold {"prefix_tokens": (B, P)} for conditional
        generation (the model is fed ``[prefix | x_t]`` with bidirectional
        attention and only the target segment's logits are returned) and
        {"frontend_embeds": (B, F, d)}.
        """
        def fn(x_t, t, cond_rt):
            c = cond_rt if cond_rt is not None else (cond or {})
            fe = c.get("frontend_embeds")
            prefix = c.get("prefix_tokens")
            if prefix is not None:
                full = torch.cat([prefix.to(x_t.dtype), x_t], dim=1)
                logits = self.forward(full, t, fe, causal=False)
                # contiguous: the decode kernel reads (B, N, K) densely
                return logits[:, prefix.shape[1]:].contiguous()
            return self.forward(x_t, t, fe, causal=False)
        return fn

    def init_cache(self, batch: int, max_seq: int, dtype=None) -> list:
        """One cache per entry of ``blocks``, in its order, for sequences of
        up to ``max_seq`` tokens (a windowed block's ring holds only its
        window and wraps).  Attention and Mamba-2 caches are in ``dtype``
        (the model's by default); xLSTM state is f32."""
        dt = dtype or getattr(torch, self.cfg.dtype)
        return [self._block(kind, blk).init_cache(batch, max_seq, dt)
                for kind, blk in zip(self.cfg.block_pattern, self.blocks)]

    def decode_step(self, token: torch.Tensor, cache: list,
                    pos: int) -> tuple[torch.Tensor, list]:
        """token: (B, 1) int at position ``pos`` (a Python int) -> (logits
        (B, 1, V), cache).  Causal, with no time embedding and no frontend,
        as the reference's ``decode_step``; ``cache`` is updated in place
        and returned."""
        h = F.embedding(token, self.embed)
        for kind, blk, c in zip(self.cfg.block_pattern, self.blocks, cache):
            h = self._block(kind, blk).decode(h, c, pos)
        h = self.ln_f(h)
        return h @ (self.embed.T if self.head is None else self.head), cache

    def _block(self, kind: str, blk: nn.Module) -> nn.Module:
        return self.shared if kind == "shared_attn" else blk

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def active_param_count(self) -> int:
        """MoE-aware: all but the inactive experts' share of the expert
        weights (for 6 * N_active * D)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.n_experts:
            return total
        moe_leaves = sum(p.numel() for kind, blk in zip(cfg.block_pattern,
                                                        self.blocks)
                         if kind == "moe"
                         for name, p in blk.moe.named_parameters()
                         if name != "router")
        inactive = moe_leaves * (1 - cfg.experts_per_token / cfg.n_experts)
        return int(total - inactive)


def _sharded_embedding(tokens, embed):
    """``F.embedding`` of DTensor ``tokens`` in a DTensor table whose rows
    (the vocab) may be sharded, vocab-parallel: each rank looks its tokens
    up in its own rows (zeros where a token lies outside them), and one
    sum over the axes that shard the rows completes them.  DTensor's own
    lookup leaves a masked partial sum whose backward it cannot always
    redistribute; this one is placed as the tokens are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = embed.device_mesh
    row_axes = [i for i, p in enumerate(embed.placements) if p == Shard(0)]
    if any(p != Shard(0) and not p.is_replicate() for p in embed.placements):
        raise ValueError(f"embedding placements {embed.placements}: only "
                         "the rows may be sharded")
    rows = embed.to_local(grad_placements=[
        p if i in row_axes else Partial()
        for i, p in enumerate(embed.placements)])
    lo = 0
    for i in row_axes:                    # nested shards, outer axis first
        lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    lo *= rows.shape[0]
    tok = tokens.redistribute(mesh, [
        Replicate() if i in row_axes else p
        for i, p in enumerate(tokens.placements)]).to_local()
    inside = (tok >= lo) & (tok < lo + rows.shape[0])
    h = F.embedding(torch.where(inside, tok - lo, 0), rows) * inside[
        ..., None].to(rows.dtype)
    h = DTensor.from_local(h, mesh, [
        Partial() if i in row_axes else p
        for i, p in enumerate(tokens.placements)])
    return h.redistribute(mesh, [Replicate() if i in row_axes else p
                                 for i, p in enumerate(tokens.placements)])
