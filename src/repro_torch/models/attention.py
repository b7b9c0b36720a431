"""Grouped-query attention with RoPE and sliding windows.

Three interchangeable inner implementations (``cfg.attn_impl``):
  einsum  — plain S^2 attention
  blocked — online softmax over KV chunks in plain PyTorch
  pallas  — the hand-written CUDA flash kernel
            (``repro_torch/kernels/flash_attention``) on CUDA tensors, its
            plain version on CPU tensors

Mask semantics: ``causal`` plus optional ``sliding_window`` (only the last
W positions visible), additive ``NEG = -1e9``.  The diffusion denoiser
runs with causal=False.

``decode_step`` attends one new token over a KV cache that is a ring
buffer of physical length L (the window for windowed blocks, else the
longest sequence): position ``pos`` goes to slot ``pos mod L``, and slot
i holds position ``pos - ((pos mod L - i) mod L)``; slots of a negative
position, or past the window, get ``NEG`` (``ref.ring_bias``).  "pallas"
decodes through the CUDA kernel ``flash_decode``, which builds that bias
itself.  The cache is updated in place; ``pos`` is a Python int.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import NEG
from repro_torch.kernels.flash_attention.ref import mask_bias as _mask_bias
from repro_torch.kernels.flash_attention.ref import repeat_kv as _repeat_kv
from repro_torch.kernels.flash_attention.ref import ring_bias
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rope_freqs

__all__ = ["Attention", "NEG"]


def _einsum_attn(q, k, v, bias):
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
    logits = logits + bias
    p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _blocked_attn(q, k, v, bias, block_k: int):
    """Online softmax over KV chunks; O(S * block_k) live scores."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    bk = min(block_k, Sk)
    m = torch.full((B, H, Sq), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, bk):
        kc, vc = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kc) / (hd ** 0.5)
        s = s.float() + bias[:, k0:k0 + bk]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p.to(q.dtype), vc).float()
        m = m_new
    l = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (acc / l).to(q.dtype)


def _plain(q, k, v, bias, cfg: ModelConfig):
    """The "einsum" and "blocked" routes: q (B,Sq,H,hd), k and v
    (B,Sk,KV,hd), bias (Sq, Sk) -> (B,Sq,H,hd)."""
    k = _repeat_kv(k, cfg.n_heads)
    v = _repeat_kv(v, cfg.n_heads)
    if cfg.attn_impl == "blocked":
        return _blocked_attn(q, k, v, bias, cfg.attn_block_k)
    if cfg.attn_impl == "einsum":
        return _einsum_attn(q, k, v, bias)
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def _inner(q, k, v, cfg: ModelConfig, *, causal: bool, window: int):
    """q: (B,S,H,hd); k, v: (B,S,KV,hd) -> (B,S,H,hd)."""
    if cfg.attn_impl == "pallas":
        # the kernel reads kv head h // (H / KV) itself
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window)
    return _plain(q, k, v, _mask_bias(q.shape[1], causal, window, q.device),
                  cfg)


class Attention(nn.Module):
    def __init__(self, generator, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd, dt = cfg.hd, getattr(torch, cfg.dtype)
        self.wq = dense_init(generator, cfg.d_model, cfg.n_heads * hd, dt,
                             device)
        self.wk = dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dt,
                             device)
        self.wv = dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dt,
                             device)
        self.wo = dense_init(generator, cfg.n_heads * hd, cfg.d_model, dt,
                             device, scale=1.0 / max(cfg.n_layers, 1) ** 0.5)

    def _qkv(self, x, positions):
        """q, k (RoPE at ``positions``, (S,)) and v of x (B, S, d)."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.hd
        q = (x @ self.wq).view(B, S, cfg.n_heads, hd)
        k = (x @ self.wk).view(B, S, cfg.n_kv_heads, hd)
        v = (x @ self.wv).view(B, S, cfg.n_kv_heads, hd)
        cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def forward(self, x: torch.Tensor, *, causal: bool,
                window: int = 0) -> torch.Tensor:
        """Full-sequence attention.  x: (B, S, d)."""
        B, S, _ = x.shape
        q, k, v = self._qkv(x, torch.arange(S, device=x.device))
        y = _inner(q, k, v, self.cfg, causal=causal, window=window)
        return y.reshape(B, S, self.cfg.n_heads * self.cfg.hd) @ self.wo

    def init_cache(self, batch: int, max_seq: int, window: int,
                   dtype) -> dict:
        """Zero k and v of (batch, L, KV, hd): L is the window for windowed
        blocks (at most ``max_seq``), else ``max_seq``."""
        L = min(max_seq, window) if window else max_seq
        shape = (batch, L, self.cfg.n_kv_heads, self.cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.wq.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.wq.device)}

    def decode_step(self, x: torch.Tensor, cache: dict, pos: int,
                    window: int = 0) -> torch.Tensor:
        """One token x (B, 1, d) at position ``pos``: its k and v go to
        slot ``pos mod L`` of the cache (in place), and q attends over the
        ring causally, within ``window`` if set.  Returns (B, 1, d)."""
        cfg = self.cfg
        B = x.shape[0]
        L = cache["k"].shape[1]
        # arange, not a tensor from a list: no host-to-device copy
        q, k_new, v_new = self._qkv(x, torch.arange(pos, pos + 1,
                                                     device=x.device))
        slot = pos % L
        cache["k"][:, slot] = k_new[:, 0]
        cache["v"][:, slot] = v_new[:, 0]
        if cfg.attn_impl == "pallas":
            y = flash_ops.flash_decode(q, cache["k"], cache["v"], pos=pos,
                                       window=window)
        else:
            bias = ring_bias(pos, L, window, x.device)[None]
            y = _plain(q, cache["k"], cache["v"], bias, cfg)
        return y.reshape(B, 1, cfg.n_heads * cfg.hd) @ self.wo
