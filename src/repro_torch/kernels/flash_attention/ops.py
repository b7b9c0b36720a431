"""Wrappers of the flash-attention kernels
(``repro_torch/csrc/flash_attention.cu``): ``flash_attention``
(self-attention over one length S) and ``flash_decode`` (one query row
per head over a ring-buffer KV cache, the decode form).

Takes the model's (B, S, heads, hd) layout through strides (no
transposes) and un-repeated kv heads (grouped-query attention reads kv
head h // (H / KV)); the mask is built in the kernel from ``causal`` and
``window``.  A CUDA tensor goes to the kernel, launched on the current
stream; a CPU tensor goes to the plain version in ``ref.py``.  The kernel
stages k and v with 16-byte copies, so on the card their rows must start
on 16-byte boundaries; a view that breaks this raises (there is no other
route).  Each raises where autograd would need a gradient through it
(``build.no_backward``): training attends through ``attn_impl``
"einsum" or "blocked".  ``flash_attention.launches`` and
``flash_decode.launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, hd) or v.shape != k.shape:
        raise ValueError(f"k, v must be ({B}, {S}, KV, {hd}); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv "
                         "heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v lie on different devices")
    if any(a.stride(-1) != 1 for a in (q, k, v)):
        raise ValueError("the head-dim axis of q, k, v must be contiguous")


def _check_aligned(k, v) -> None:
    """The kernel's 16-byte copies of k and v rows: each row must start on
    a 16-byte boundary."""
    for name, a in (("k", k), ("v", v)):
        size = a.element_size()
        if a.data_ptr() % 16 or any(st * size % 16
                                    for st in a.stride()[:3]):
            raise ValueError(f"{name} rows must start on 16-byte boundaries "
                             f"for the kernel's copies; got offset "
                             f"{a.data_ptr() % 16} and strides "
                             f"{a.stride()[:3]} of {size}-byte elements")


def flash_attention(q, k, v, *, causal: bool = False, window: int = 0):
    """q: (B,S,H,hd); k, v: (B,S,KV,hd).  Returns (B,S,H,hd) in q's
    dtype: softmax(q k^T / sqrt(hd) + bias) v, bias additive -1e9 where
    ``causal``/``window`` hide a key."""
    _check(q, k, v)
    build.no_backward("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check_aligned(k, v)
    lib = build.library().lib
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    B, S, H, hd = q.shape
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    strides = [st for a in (q, k, v, out) for st in a.stride()[:3]]
    build.launch("flash_attention", fn, q.get_device(), q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
                 k.shape[2], hd, *strides, int(causal), int(window),
                 1.0 / hd ** 0.5)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _check_decode(q, k, v, pos: int, window: int) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd); got {tuple(q.shape)}")
    if k.dim() != 4 or k.shape[0] != q.shape[0] or k.shape[1] == 0:
        raise ValueError(f"k, v must be ({q.shape[0]}, L, KV, "
                         f"{q.shape[3]}) with L > 0; got {tuple(k.shape)}")
    # the shared checks, with the cache's length as the kernel's S
    _check(q.expand(-1, k.shape[1], -1, -1), k, v)
    if isinstance(pos, bool) or not isinstance(pos, int) or pos < 0:
        raise ValueError(f"pos must be an int >= 0; got {pos!r}")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")


def flash_decode(q, k_cache, v_cache, *, pos: int, window: int = 0):
    """q: (B,1,H,hd), the query of position ``pos``; k_cache, v_cache:
    (B,L,KV,hd), a ring buffer (slot i holds position pos - ((pos mod L -
    i) mod L)).  Returns (B,1,H,hd) in q's dtype: softmax(q k^T / sqrt(hd)
    + bias) v, bias additive -1e9 where a slot holds a negative position
    or one ``window`` or more behind ``pos`` (``ref.ring_bias``; the
    kernel computes it from (pos, L, window))."""
    _check_decode(q, k_cache, v_cache, pos, window)
    build.no_backward("flash_decode", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, pos, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not "
                         f"{q.device}")
    _check_aligned(k_cache, v_cache)
    lib = build.library().lib
    fn = (lib.flash_decode_f32 if q.dtype == torch.float32
          else lib.flash_decode_bf16)
    B, _, H, hd = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    strides = ([q.stride(0), q.stride(2)]
               + [st for a in (k_cache, v_cache) for st in a.stride()[:3]]
               + [out.stride(0), out.stride(2)])
    build.launch("flash_decode", fn, q.get_device(), q.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), B,
                 L, H, KV, hd, *strides, pos, int(window), 1.0 / hd ** 0.5)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
