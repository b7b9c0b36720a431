"""Wrapper of the flash-attention kernel
(``repro_torch/csrc/flash_attention.cu``).

Takes the model's (B, S, heads, hd) layout through strides (no
transposes) and un-repeated kv heads (grouped-query attention reads kv
head h // (H / KV)); the mask is built in the kernel from ``causal`` and
``window``.  A CUDA tensor goes to the kernel, launched on the current
stream; a CPU tensor goes to the plain version in ``ref.py``.  The kernel
stages k and v with 16-byte copies, so on the card their rows must start
on 16-byte boundaries; a view that breaks this raises (there is no other
route).  ``flash_attention.launches`` counts kernel launches.
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
