"""Wrapper of the Mamba-2 SSD chunked-scan kernel
(``repro_torch/csrc/ssd_scan.cu``).

Takes the model's layouts through strides: x (B,S,H,P), dtv (B,S,H) and
Bm/Cm (B,S,N) may be views (the Mamba-2 block passes slices of one
projection), so nothing is transposed, copied or padded; the ragged tail
is handled in the kernel.  A CUDA tensor goes to the kernel: one C call
that launches its passes (chunk states and each chunk's C Bᵀ, the carry
across chunks when there are three or more, the output) on the current
stream, with f32 scratch for the states and C Bᵀ allocated here.  In f32
the kernel stages x, Bm and Cm by 16-byte copies, so their rows must
start on 16-byte boundaries; a view that breaks this raises (there is no
other route).  A CPU tensor goes to the plain version
``ref.ssd_chunked``.  It raises where autograd would need a gradient
through it (``build.no_backward``).  ``ssd_scan.launches`` counts
wrapper calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_DIM = 128                 # L = min(chunk, S), N and P each at most this
MAX_SMEM = 232448             # bytes of shared memory a block can use


def smem_bytes(L: int, N: int, P: int) -> int:
    """The larger shared memory of the kernel's two staged passes
    (``StateLayout`` or a C Bᵀ strip, and ``OutLayout`` in ssd_scan.cu):
    L, N and P padded to multiples of 16, rows padded so that fragment
    loads are free of bank conflicts, two heads' operands in the output
    pass."""
    Lp, Np, Pp = ((v + 15) // 16 * 16 for v in (L, N, P))
    pitch_a = lambda v: v + ((4 - v) & 7)  # noqa: E731
    pitch_b = lambda v: v + ((8 - v) & 31)  # noqa: E731
    state = max(Lp * (pitch_b(Np) + pitch_b(Pp)) + 3 * Lp,
                (Lp + 16) * pitch_a(Np))
    out = (Lp * pitch_a(Np) + Lp * pitch_a(Lp)
           + 2 * ((Lp + Np) * pitch_b(Pp) + 2 * Lp))
    return 4 * max(state, out)


def _check(x, dtv, A, Bm, Cm, chunk: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    if dtv.shape != (B, S, H):
        raise ValueError(f"dtv must be ({B}, {S}, {H}), got "
                         f"{tuple(dtv.shape)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm, Cm must be ({B}, {S}, N); got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if A.shape != (H,) or A.dtype != torch.float32:
        raise ValueError(f"A must be ({H},) f32, got {tuple(A.shape)} "
                         f"{A.dtype}")
    if x.dtype not in DTYPES or any(a.dtype != x.dtype
                                    for a in (dtv, Bm, Cm)):
        raise TypeError(f"x, dtv, Bm, Cm must share one dtype of {DTYPES}; "
                        f"got {x.dtype}, {dtv.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    if any(a.device != x.device for a in (dtv, A, Bm, Cm)):
        raise ValueError("ssd_scan inputs lie on different devices")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if any(a.stride(-1) != 1 for a in (x, Bm, Cm)):
        raise ValueError("the last axis of x, Bm and Cm must be contiguous")
    L, N = min(chunk, S), Bm.shape[-1]
    if max(L, N, P) > MAX_DIM or smem_bytes(L, N, P) > MAX_SMEM:
        raise ValueError(f"chunk {L}, state {N}, head dim {P}: each must be "
                         f"at most {MAX_DIM} and fit {MAX_SMEM} bytes of "
                         "shared memory")


def _check_cuda(x, Bm, Cm) -> None:
    """What the kernel's staging needs beyond the shapes: N and P multiples
    of 4 (the state scratch goes by 16-byte copies) and, in f32, rows of x,
    Bm and Cm that start on 16-byte boundaries."""
    P, N = x.shape[-1], Bm.shape[-1]
    if P % 4 or N % 4:
        raise ValueError(f"head dim {P} and state {N} must be multiples of "
                         "4 for the kernel")
    if x.dtype != torch.float32:
        return
    for name, a in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if a.data_ptr() % 16 or any(st % 4 for st in a.stride()[:-1]):
            raise ValueError(f"{name} rows must start on 16-byte boundaries "
                             f"for the kernel's copies; got offset "
                             f"{a.data_ptr() % 16} and strides "
                             f"{a.stride()} of 4-byte elements")


def ssd_scan(x, dtv, A, Bm, Cm, *, chunk: int = 128):
    """x: (B,S,H,P); dtv: (B,S,H); A: (H,) f32, negative; Bm/Cm: (B,S,N).
    Returns (y (B,S,H,P) in x's dtype, None), the signature of the JAX
    package's wrapper."""
    _check(x, dtv, A, Bm, Cm, chunk)
    build.no_backward("ssd_scan", x, dtv, A, Bm, Cm)
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dtv, A, Bm, Cm, chunk)[0], None
    return _launch(x, dtv, A, Bm, Cm, chunk)[0], None


def ssd_scan_passes(x, dtv, A, Bm, Cm, *, chunk: int = 128):
    """``ssd_scan``'s y with what each pass hands the next, so that every
    pass can be held against its plain version in ``ref.py``: (y, the
    states entering chunks 1 .. nc-1 (B, nc-1, H, N, P), each chunk's
    cs_L (B, nc-1, H) and C Bᵀ (B, nc, L, L)), f32 but y.  On the card
    these are views of the kernel's scratch, and C Bᵀ is written on and
    below the diagonal only; a CPU tensor gets the plain passes."""
    _check(x, dtv, A, Bm, Cm, chunk)
    build.no_backward("ssd_scan", x, dtv, A, Bm, Cm)
    if x.device.type == "cpu":
        return ref.ssd_passes(x, dtv, A, Bm, Cm, chunk)
    y, scratch = _launch(x, dtv, A, Bm, Cm, chunk)
    # the scratch's layout, as _launch carves it
    B, S, H, P = x.shape
    N, L = Bm.shape[-1], min(chunk, S)
    nc, Lp = -(-S // L), -(-L // 16) * 16
    n_states = B * max(nc - 1, 1) * H
    n, n_cs = n_states * N * P, -(-n_states // 4) * 4
    return (y, scratch[:n].view(B, -1, H, N, P)[:, :nc - 1],
            scratch[n:n + n_states].view(B, -1, H)[:, :nc - 1],
            scratch[n + n_cs:].view(B, nc, Lp, Lp)[:, :, :L, :L])


def _launch(x, dtv, A, Bm, Cm, chunk: int):
    """The kernel's one C call on checked inputs: y and the f32 scratch
    its passes filled."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    _check_cuda(x, Bm, Cm)
    lib = build.library().lib
    fn = lib.ssd_scan_f32 if x.dtype == torch.float32 else lib.ssd_scan_bf16
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    nc = -(-S // L)
    A = A.contiguous()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    # one f32 scratch: each chunk's state, then the state entering the
    # next chunk (B, nc - 1, H, N, P); cs_L (B, nc - 1, H), rounded up to
    # whole 16 bytes; each chunk's C Bᵀ (B, nc, Lp, Lp), L padded to 16
    n_states = B * max(nc - 1, 1) * H
    n_cs = -(-n_states // 4) * 4
    Lp = -(-L // 16) * 16
    scratch = torch.empty(n_states * N * P + n_cs + B * nc * Lp * Lp,
                          dtype=torch.float32, device=x.device)
    states = scratch.data_ptr()
    cs_last = states + 4 * n_states * N * P
    cb = cs_last + 4 * n_cs
    strides = (*x.stride()[:3], *dtv.stride(), *Bm.stride()[:2],
               *Cm.stride()[:2], *y.stride()[:3])
    build.launch("ssd_scan", fn, x.get_device(), x.data_ptr(),
                 dtv.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), states, cs_last, cb, B, S, H, P, N, L,
                 *strides)
    ssd_scan.launches += 1
    return y, scratch


ssd_scan.launches = 0
