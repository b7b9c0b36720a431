"""Wrappers of the flash-attention kernels
(``repro_torch/csrc/flash_attention.cu``): ``flash_attention``
(self-attention over one length S), ``flash_decode`` (one query row per
head over a ring-buffer KV cache, the decode form) and
``flash_decode_partials`` (the decode form's softmax statistics over a
share of a ring's slots, for ranks that shard them).

Takes the model's (B, S, heads, hd) layout through strides (no
transposes) and un-repeated kv heads (grouped-query attention reads kv
head h // (H / KV)); the mask is built in the kernel from ``causal`` and
``window``.  A CUDA tensor goes to the kernel, launched on the current
stream; a CPU tensor goes to the plain version in ``ref.py``.  The kernel
stages k and v with 16-byte copies, so on the card their rows must start
on 16-byte boundaries; a view that breaks this raises (there is no other
route).  Each raises where autograd would need a gradient through it
(``build.no_backward``): training attends through ``attn_impl``
"einsum" or "blocked".  ``flash_attention.launches``,
``flash_decode.launches`` and ``flash_decode_partials.launches`` count
calls that launched the kernel (the decode form's two passes count once).

The decode kernel splits the cache's slots into chunks, one pass-1 block
per (chunk, b, kv head) and a second pass that joins the chunks;
:func:`decode_chunk` chooses the split.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)
# The decode kernel's pass-1 block (csrc/flash_attention.cu: kDecTile,
# kDecStages, 32 x kDecWarps, kDecGroup): 64-slot tiles of k and v three
# deep in shared memory, 128 threads, up to 8 query heads; a chunk's
# least length; the H100's SMs and the shared memory an SM gives its
# blocks (228 KB, 1 KB of it reserved per block).  ptxas gives the f32
# instances 128-138 registers a thread and the bf16 ones 162-168, so at
# most 4 and 3 blocks fit an SM's 65,536 registers.
DECODE_TILE = 64
DECODE_STAGES = 3
DECODE_THREADS = 128
DECODE_GROUP = 8
DECODE_MIN_CHUNK = 256
SMS = 132
SM_SHARED_BYTES = 233472


def decode_blocks_per_sm(hd: int, itemsize: int) -> int:
    """Pass-1 blocks resident on one SM: the kernel's shared memory
    (DecodeShape in the source: the stages or, if larger, the P v join;
    q, p and the joins' scratch) against the SM's, capped by registers."""
    vec, g = 16 // itemsize, DECODE_GROUP
    stages = DECODE_STAGES * 2 * DECODE_TILE * (hd + vec) * itemsize
    join = DECODE_THREADS // (hd // vec) * g * hd * 4
    scratch = g * hd + DECODE_TILE * g + 2 * (DECODE_THREADS // 32) * g + g
    smem = max(stages, join) + 4 * scratch
    return max(1, min(4 if itemsize == 4 else 3,
                      SM_SHARED_BYTES // (smem + 1024)))


def decode_chunk(B: int, KV: int, L: int, hd: int, itemsize: int) -> int:
    """Slots per pass-1 block of the decode kernel over a cache of L
    slots: the B x KV (batch row, kv head) pairs' chunks fill the card's
    resident blocks (``decode_blocks_per_sm`` x SMS) once, in one wave,
    with each chunk a whole number of DECODE_TILE tiles and at least
    DECODE_MIN_CHUNK slots; the whole cache (one block per pair, one
    pass) where that is one chunk."""
    tiles = -(-L // DECODE_TILE)
    want = max(1, SMS * decode_blocks_per_sm(hd, itemsize) // max(1, B * KV))
    per = max(-(-tiles // want), DECODE_MIN_CHUNK // DECODE_TILE)
    return L if per >= tiles else per * DECODE_TILE


def decode_splits(B: int, KV: int, L: int, hd: int, itemsize: int) -> int:
    """The number of chunks :func:`decode_chunk` cuts L slots into (at
    head dim ``hd``, ``itemsize`` bytes an element)."""
    return -(-L // decode_chunk(B, KV, L, hd, itemsize))


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


def _check_slots(L: int, ring_len: int, slot0: int) -> None:
    for name, x in (("ring_len", ring_len), ("slot0", slot0)):
        if isinstance(x, bool) or not isinstance(x, int):
            raise ValueError(f"{name} must be an int; got {x!r}")
    if slot0 < 0 or ring_len < slot0 + L:
        raise ValueError(f"slots {slot0} .. {slot0 + L - 1} do not lie in a "
                         f"ring of {ring_len}")


def _decode_launch(name: str, fn, q, k, v, outs, pos: int, window: int,
                   slots: tuple = ()) -> None:
    """Launch the decode kernel's C entry point ``fn`` on CUDA tensors:
    ``outs`` the output pointers, ``slots`` (ring_len, slot0) for the
    partial form; allocates the chunks' workspace where there are several
    chunks."""
    B, _, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    chunk = decode_chunk(B, KV, L, hd, q.element_size())
    n = -(-L // chunk)
    ws = (torch.empty(B * H * n * (hd + 2), dtype=torch.float32,
                      device=q.device) if n > 1 else None)
    strides = ([q.stride(0), q.stride(2)]
               + [st for a in (k, v) for st in a.stride()[:3]])
    if not slots:                       # the output's (b, h) strides
        strides += [outs[0].stride(0), outs[0].stride(2)]
    build.launch(name, fn, q.get_device(), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), *(o.data_ptr() for o in outs),
                 None if ws is None else ws.data_ptr(), B, L, H, KV, hd,
                 *strides, pos, int(window), *slots, chunk, 1.0 / hd ** 0.5)


def flash_decode(q, k_cache, v_cache, *, pos: int, window: int = 0):
    """q: (B,1,H,hd), the query of position ``pos``; k_cache, v_cache:
    (B,L,KV,hd), a ring buffer (slot i holds position pos - ((pos mod L -
    i) mod L)).  Returns (B,1,H,hd) in q's dtype: softmax(q k^T / sqrt(hd)
    + bias) v, bias additive -1e9 where a slot holds a negative position
    or one ``window`` or more behind ``pos`` (``ref.ring_bias``; the
    kernel computes it from (pos, L, window)).  On the card a cache of
    several chunks (:func:`decode_chunk`) takes the kernel's two passes,
    a short one pass; either way ``flash_decode.launches`` counts one."""
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
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _decode_launch("flash_decode", fn, q, k_cache, v_cache, (out,), pos,
                   window)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_partials(q, k, v, *, pos: int, window: int, ring_len: int,
                          slot0: int):
    """The softmax statistics of ``flash_decode`` over a share of a ring's
    slots: k, v (B,L,KV,hd) hold slots ``slot0 .. slot0 + L - 1`` of a
    ring of ``ring_len`` slots (L and 0: the whole ring), q (B,1,H,hd)
    is the query of position ``pos``.  Returns (m, l, acc) in f32 and
    natural-log units: m = max s and l = sum exp(s - m), both (B,1,H),
    acc = sum exp(s - m) v, (B,1,H,hd), with s = q k^T / sqrt(hd) + the
    ring's bias over these slots (``ref.decode_partials``).  Ranks that
    shard the slots join theirs into the softmax (``ref.combine_partials``,
    or all-reduces in ``launch/spmd.py``).  On the card the kernel's pass
    1, and its pass 2 where the share is several chunks;
    ``flash_decode_partials.launches`` counts one per call."""
    _check_decode(q, k, v, pos, window)
    _check_slots(k.shape[1], ring_len, slot0)
    build.no_backward("flash_decode_partials", q, k, v)
    if q.device.type == "cpu":
        return ref.decode_partials(q, k, v, pos, window, ring_len, slot0)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_partials runs on cuda or cpu, not "
                         f"{q.device}")
    _check_aligned(k, v)
    lib = build.library().lib
    fn = (lib.flash_decode_partials_f32 if q.dtype == torch.float32
          else lib.flash_decode_partials_bf16)
    B, _, H, hd = q.shape
    m, l = (torch.empty((B, 1, H), dtype=torch.float32, device=q.device)
            for _ in range(2))
    acc = torch.empty((B, 1, H, hd), dtype=torch.float32, device=q.device)
    _decode_launch("flash_decode_partials", fn, q, k, v, (m, l, acc), pos,
                   window, (ring_len, slot0))
    flash_decode_partials.launches += 1
    return m, l, acc


flash_decode_partials.launches = 0
