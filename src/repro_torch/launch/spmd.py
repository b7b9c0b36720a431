"""The model's layers on DTensors: the sharded forms that
``launch/sharding.py::shard_module`` installs on a model it shards.

A sharded model's parameters are DTensors placed by ``sharding``'s rules,
and its activations DTensors placed as the batch.  Where DTensor's own
propagation of an op is wrong or missing, these forms work on each
rank's local block with explicit collectives, Megatron-style, as the
sharded MoE dispatch does (``models/moe.py``):

* attention: the projections run as DTensors; the attention itself on
  each rank's block of queries (batch, rows and heads as q is placed)
  against keys and values gathered along rows and heads (their gradients
  then sum over the ranks that gathered them).  A kv projection sharded
  over more ranks than it has heads is gathered first (a view cannot
  split a head between ranks).  A sharded cache is written and read
  block by block; where its slots are sharded (context parallelism), the
  softmax's max, sum and weighted values are reduced over those ranks;
* blocks: each branch's output is placed as the residual stream before
  the add, partial sums all-reduced with a replicated gradient
  (:func:`placed_as`); a mixer whose weights are all replicated (the
  default policy's) runs on each rank's rows as plain tensors, so that
  its recurrences pay no DTensor dispatch per op;
* MoE: "shard_map" runs the layer's own sharded dispatch; any other
  dispatch (or a fall-through) runs the global one replicated: every
  rank gathers all tokens and every expert weight and routes them all,
  which is what GSPMD makes of the reference's global dispatch when it
  cannot shard it;
* the model: the embedding looked up vocab-parallel.

:func:`install` swaps each module's class for its sharded subclass, so
the model's own modules keep their one plain path.  Each sharded form
defers to it where its input is not a DTensor.

A softmax completed over slot-sharding ranks takes each rank's partial
statistics from ``flash_decode_partials`` under ``attn_impl="pallas"``
(the kernel on CUDA tensors, its plain version on CPU and fake ones).
A rank's subset of query rows has no kernel (the flash kernel takes no
row offset): under "pallas" it runs on CPU and fake tensors only (the CPU
tests, the dry run), and raises on CUDA tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.device import AllReduce, is_sharded, local_block
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import mask_bias, repeat_kv
from repro_torch.kernels.flash_attention.ref import (decode_partials,
                                                    ring_bias)
from repro_torch.models.attention import (Attention, _blocked_attn,
                                          _einsum_attn, _inner, _plain)
from repro_torch.models.blocks import AttnBlock, MixerBlock
from repro_torch.models.model import Model
from repro_torch.models.moe import MoE


def _no_kernel(t: torch.Tensor, cfg, what: str) -> None:
    """Raise where ``attn_impl="pallas"`` would run a plain route on the
    card (module docstring)."""
    if cfg.attn_impl == "pallas" and t.device.type == "cuda":
        raise NotImplementedError(
            f"attn_impl='pallas' on CUDA tensors: {what}; no kernel covers "
            "this sharding yet, and the plain route does not stand in for "
            "it on the card")


def placed_as(t, like):
    """``t`` placed as ``like`` when both are DTensors, else ``t``: a
    block's output summed over the model axis before the residual add, as
    Megatron does.  Partial sums that ``like`` replicates are summed by
    :class:`~repro_torch.device.AllReduce` on the local blocks, so that
    the gradient stays replicated (DTensor's own redistribution hands it
    back as partial sums, which then gathers whole weights in the
    backward)."""
    if not (is_sharded(t) and is_sharded(like)) or \
            t.placements == like.placements:
        return t
    mesh = like.device_mesh
    pairs = list(zip(t.placements, like.placements))
    if all(p == q or (p.is_partial() and p.reduce_op == "sum"
                      and q.is_replicate()) for p, q in pairs):
        local = t.to_local(grad_placements=like.placements)
        for i, (p, _) in enumerate(pairs):
            if p.is_partial():
                local = AllReduce.apply(local, mesh.get_group(i))
        return DTensor.from_local(local, mesh, like.placements)
    return t.redistribute(mesh, like.placements)


# ------------------------------------------------------------------
# Attention
# ------------------------------------------------------------------

def local_attention(q, k, v, cfg, *, causal: bool, window: int, row0: int,
                    S: int):
    """Query rows ``row0 .. row0 + Sq`` of an S-position sequence against
    all S keys, on plain tensors (k and v with q's heads): the layer's
    route when the rows are all S, else the plain form with those rows
    of the mask (refused on the card under "pallas": the flash kernel
    takes no row offset)."""
    if q.shape[1] == S:
        return _inner(q, k, v, cfg, causal=causal, window=window)
    _no_kernel(q, cfg, f"the flash kernel attends all {S} query rows and "
               f"takes no row offset (this rank holds {q.shape[1]})")
    bias = mask_bias(S, causal, window, q.device)[row0:row0 + q.shape[1]]
    return (_blocked_attn(q, k, v, bias, cfg.attn_block_k)
            if cfg.attn_impl.startswith("blocked")
            else _einsum_attn(q, k, v, bias))


def _local_kv(t, q_placements, mesh):
    """This rank's block of a DTensor key or value for queries placed by
    ``q_placements``: the batch shard of the queries, every row and every
    head.  Its gradient sums over the ranks that gathered it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    batch = [isinstance(p, Shard) and p.dim == 0 for p in q_placements]
    pl = [Shard(0) if b else Replicate() for b in batch]
    grad = [Shard(0) if b else (Partial() if isinstance(p, Shard)
                                else Replicate())
            for b, p in zip(batch, q_placements)]
    return t.redistribute(mesh, pl).to_local(grad_placements=grad)


def slot_sharded_decode(q, k, v, groups, cfg, *, pos: int, window: int,
                        slot0: int, ring_len: int):
    """One query position q (B, 1, H, hd) over this rank's slots of a ring
    of ``ring_len``, k and v (B, L_local, KV, hd) holding slots ``slot0
    ..``, the softmax completed over the process groups ``groups`` that
    shard the slots -> (B, 1, H, hd) in q's dtype.  The rank's (m, l,
    acc) come from ``flash_decode_partials`` under "pallas" (the kernel
    on the card) and from its plain version otherwise; then the max is
    all-reduced, each rank rescales its sums to it, and l and acc are
    all-reduced."""
    import torch.distributed as dist
    kw = dict(pos=pos, window=window, ring_len=ring_len, slot0=slot0)
    m, l, acc = (flash_ops.flash_decode_partials(q, k, v, **kw)
                 if cfg.attn_impl == "pallas"
                 else decode_partials(q, k, v, **kw))
    M = m.clone()
    for g in groups:
        dist.all_reduce(M, op=dist.ReduceOp.MAX, group=g)
    f = torch.exp(m - M)       # 0 on a rank whose slots are all masked
    l = l * f
    acc = acc * f.unsqueeze(-1)
    for g in groups:
        dist.all_reduce(l, group=g)
        dist.all_reduce(acc, group=g)
    return (acc / l.clamp(min=1e-30).unsqueeze(-1)).to(q.dtype)


class ShardedAttention(Attention):
    """:class:`~repro_torch.models.attention.Attention` on DTensors
    (module docstring)."""

    def _split_heads(self, t, n: int):
        """A DTensor whose last dim is sharded over more ranks than it has
        heads (4 kv heads on a model axis of 16) is gathered along that
        dim first: a view cannot split a head between ranks (GSPMD
        reshards there too)."""
        if is_sharded(t):
            from torch.distributed.tensor import Replicate, Shard
            mesh = t.device_mesh
            last = t.dim() - 1
            pl = [Replicate() if isinstance(p, Shard) and p.dim == last
                  and n % mesh.size(i) else p
                  for i, p in enumerate(t.placements)]
            if pl != list(t.placements):
                t = t.redistribute(mesh, pl)
        return super()._split_heads(t, n)

    def _merge_heads(self, y):
        """A DTensor merges its local block and keeps its placements, so
        that the gradient coming back is redistributed to them (a view of
        a gradient sharded over more ranks than there are heads has no
        sharding rule)."""
        if not is_sharded(y):
            return super()._merge_heads(y)
        return DTensor.from_local(y.to_local().flatten(2), y.device_mesh,
                                  y.placements)

    def _attend(self, q, k, v, *, causal: bool, window: int):
        """Each rank's block of queries (batch, rows and heads as q is
        placed) against all keys of its batch shard; a DTensor placed as
        q."""
        if not is_sharded(q):
            return super()._attend(q, k, v, causal=causal, window=window)
        cfg = self.cfg
        mesh, qpl = q.device_mesh, q.placements
        shape, off = local_block(q)
        kl, vl = (repeat_kv(_local_kv(t, qpl, mesh), cfg.n_heads)[
            :, :, off[2]:off[2] + shape[2]] for t in (k, v))
        yl = local_attention(q.to_local(), kl, vl, cfg, causal=causal,
                             window=window, row0=off[1], S=q.shape[1])
        return DTensor.from_local(yl, mesh, qpl)

    def _decode_attend(self, q, k_new, v_new, cache: dict, pos: int,
                       window: int):
        """Over a DTensor cache (B, L, KV, hd) whose mesh dims shard its
        batch, slots or kv heads (``sharding.cache_spec``), on each
        rank's block: the new key and value go to the slot if this rank
        holds it, the queries take the cache's batch shard (and its kv
        heads' query groups), and where the slots are sharded the softmax
        is completed over those ranks.  A DTensor (B, 1, H, hd)."""
        if not is_sharded(cache["k"]):
            return super()._decode_attend(q, k_new, v_new, cache, pos,
                                          window)
        from torch.distributed.tensor import Replicate, Shard
        cfg = self.cfg
        ck, cv = cache["k"], cache["v"]
        mesh, cpl = ck.device_mesh, ck.placements
        L = ck.shape[1]
        shape, off = local_block(ck)
        kept = [p if isinstance(p, Shard) and p.dim in (0, 2)
                else Replicate() for p in cpl]
        kl, vl = ck.to_local(), cv.to_local()
        slot = pos % L - off[1]
        if 0 <= slot < shape[1]:
            kl[:, slot] = k_new.redistribute(mesh, kept).to_local()[:, 0]
            vl[:, slot] = v_new.redistribute(mesh, kept).to_local()[:, 0]
        ql = q.redistribute(mesh, kept).to_local()
        groups = [mesh.get_group(i) for i, p in enumerate(cpl)
                  if isinstance(p, Shard) and p.dim == 1]
        if groups:
            y = slot_sharded_decode(ql, kl, vl, groups, cfg, pos=pos,
                                    window=window, slot0=off[1], ring_len=L)
        elif cfg.attn_impl == "pallas":   # every slot here: the usual route
            y = flash_ops.flash_decode(ql, kl, vl, pos=pos, window=window)
        else:
            y = _plain(ql, kl, vl, ring_bias(pos, L, window, q.device)[None],
                       cfg)
        return DTensor.from_local(y, mesh, kept)


# ------------------------------------------------------------------
# Blocks
# ------------------------------------------------------------------

class ShardedAttnBlock(AttnBlock):
    """Each branch placed as the residual stream before the add."""

    @staticmethod
    def _add(x, y):
        return x + placed_as(y, x)


class ShardedMixerBlock(MixerBlock):
    """A mixer with all-replicated weights runs on each rank's rows as
    plain tensors (:func:`_local_call`); any other is placed as the
    residual stream before the add."""

    _add = staticmethod(ShardedAttnBlock._add)

    def forward(self, x, *, causal: bool):
        h = self.ln(x)
        if _replicated(self.mixer, h):
            return x + _local_call(self.mixer, "forward", h,
                                   bidirectional=not causal), None
        return self._add(x, self.mixer(h, bidirectional=not causal)), None

    def decode(self, x, cache: dict, pos: int):
        h = self.ln(x)
        if _replicated(self.mixer, h):
            local = {k: v.to_local() if is_sharded(v) else v
                     for k, v in cache.items()}
            return x + _local_call(self.mixer, "decode", h, local)
        return self._add(x, self.mixer.decode(h, cache))


def _replicated(module, x) -> bool:
    """Whether ``x`` is a DTensor sharded at most along its batch dim and
    every parameter of ``module`` a replicated DTensor (the default
    policy's mixers, ``ssm_tp=False``): then each rank runs the module on
    its own rows, as plain tensors."""
    from torch.distributed.tensor import Shard
    return (is_sharded(x)
            and all(not isinstance(p, Shard) or p.dim == 0
                    for p in x.placements)
            and all(is_sharded(w) and all(p.is_replicate()
                                          for p in w.placements)
                    for w in module.parameters()))


def _local_call(module, method: str, x, *args, **kwargs):
    """``module.method(x, *args)`` on this rank's rows of the DTensor ``x``
    with the local copies of its replicated weights, whose gradients sum
    over the ranks that hold other rows; the output placed as ``x``.
    The recurrences then run as plain tensor ops, not DTensor ones."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.nn.utils.stateless import _reparametrize_module
    grad = [Partial() if isinstance(p, Shard) else Replicate()
            for p in x.placements]
    weights = {n: w.to_local(grad_placements=grad)
               for n, w in module.named_parameters()}
    # torch.func.functional_call's own mechanism, for any method
    with _reparametrize_module(module, weights):
        y = getattr(module, method)(x.to_local(), *args, **kwargs)
    return DTensor.from_local(y, x.device_mesh, x.placements)


# ------------------------------------------------------------------
# MoE
# ------------------------------------------------------------------

class ShardedMoE(MoE):
    """A DTensor input that the sharded dispatch does not take runs the
    global dispatch replicated (:func:`_replicated_dispatch`)."""

    def forward(self, x):
        if is_sharded(x) and not (self.cfg.moe_dispatch == "shard_map"
                                  and self._dispatch_mesh(x.shape[0])
                                  is not None):
            return _replicated_dispatch(self, x)
        return super().forward(x)


def _replicated_dispatch(moe: MoE, x):
    """The global dispatch of a DTensor ``x`` on every rank: tokens and
    expert weights gathered whole, every rank computing the same output,
    which is then placed as ``x`` (module docstring)."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    w = {k: p.redistribute(mesh, rep).to_local() if is_sharded(p) else p
         for k, p in moe.weights().items()}
    y, aux = moe._global(x.redistribute(mesh, rep).to_local(), w)
    y = DTensor.from_local(y, mesh, rep).redistribute(mesh, x.placements)
    return y, {k: DTensor.from_local(v, mesh, rep) for k, v in aux.items()}


# ------------------------------------------------------------------
# The model
# ------------------------------------------------------------------

class ShardedModel(Model):
    """The embedding looked up vocab-parallel (:func:`_sharded_embedding`)
    in a DTensor table."""

    def _embed(self, tokens):
        if not is_sharded(self.embed):
            return super()._embed(tokens)
        return _sharded_embedding(tokens, self.embed)


def _sharded_embedding(tokens, embed):
    """``F.embedding`` of DTensor ``tokens`` in a DTensor table whose rows
    (the vocab) may be sharded, vocab-parallel: each rank looks its tokens
    up in its own rows (zeros where a token lies outside them), and one
    sum over the axes that shard the rows completes them.  DTensor's own
    lookup leaves a masked partial sum whose backward it cannot always
    redistribute; this one is placed as the tokens are."""
    from torch.distributed.tensor import Partial, Replicate, Shard
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


_FORMS = {Attention: ShardedAttention, AttnBlock: ShardedAttnBlock,
          MixerBlock: ShardedMixerBlock, MoE: ShardedMoE,
          Model: ShardedModel}


def install(model):
    """Swap every module of ``model`` that has a sharded form for it, in
    place (parameters, buffers and state dict unchanged); returns
    ``model``."""
    for mod in model.modules():
        form = _FORMS.get(type(mod))
        if form is not None:
            mod.__class__ = form
    return model
