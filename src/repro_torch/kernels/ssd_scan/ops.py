"""Wrapper of the Mamba-2 SSD chunked-scan kernel
(``repro_torch/csrc/ssd_scan.cu``).

Takes the model's layouts through strides: x (B,S,H,P), dtv (B,S,H) and
Bm/Cm (B,S,N) may be views (the Mamba-2 block passes slices of one
projection), so nothing is transposed, copied or padded; the ragged tail
is handled in the kernel.  A CUDA tensor goes to the kernel, launched on
the current stream; a CPU tensor goes to the plain version
``ref.ssd_chunked``.  ``ssd_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_DIM = 128                 # L = min(chunk, S), N and P each at most this
MAX_SMEM = 232448             # bytes of shared memory a block can use


def smem_bytes(L: int, N: int, P: int) -> int:
    """The kernel's shared memory (``Layout`` in ssd_scan.cu): x, Bᵀ, the
    state (rows padded to multiples of 4), C, M and three L-vectors."""
    r4 = lambda v: (v + 3) // 4 * 4  # noqa: E731
    return 4 * (L * r4(P) + N * r4(L) + N * r4(P) + L * N + L * L + 3 * L)


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


def ssd_scan(x, dtv, A, Bm, Cm, *, chunk: int = 128):
    """x: (B,S,H,P); dtv: (B,S,H); A: (H,) f32, negative; Bm/Cm: (B,S,N).
    Returns (y (B,S,H,P) in x's dtype, None), the signature of the JAX
    package's wrapper."""
    _check(x, dtv, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dtv, A, Bm, Cm, chunk)[0], None
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    lib = build.library().lib
    fn = lib.ssd_scan_f32 if x.dtype == torch.float32 else lib.ssd_scan_bf16
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    A = A.contiguous()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    strides = (*x.stride()[:3], *dtv.stride(), *Bm.stride()[:2],
               *Cm.stride()[:2], *y.stride()[:3])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dtv.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), B, S, H, P, N, min(chunk, S),
                *strides, stream)
    build.check(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, None


ssd_scan.launches = 0
