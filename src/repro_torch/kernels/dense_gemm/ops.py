"""Wrapper of the dense f32 GEMM on the tensor cores
(``repro_torch/csrc/dense_gemm.cu``): ``a @ b`` in 3xTF32.

``a`` (M, K) is the activations, rows contiguous (``a.stride(1) == 1``)
at any row stride; ``b`` (K, N) is a weight as the port stores it,
(d_in, d_out) row-major, or a transposed view of one (the tied head's
``embed.T``), each read through its strides, so nothing is copied or
padded: TMA fills zeros past M, N and K.  TMA reads rows that start on
16-byte boundaries at 16-byte strides, so on the card both start on
16-byte boundaries and their row strides are multiples of 4; so are K,
and N where ``b`` is row-major; every served operand is, and
``layers.dense`` gives others to PyTorch's product.  A CUDA tensor goes
to the kernel, launched on the current stream, with the output (and the
scratch of a split K, below) allocated here; a CPU tensor goes to the
plain version ``ref.dense_gemm``, which takes any strides.  It raises on
what neither takes, and where autograd would need a gradient through it
(``build.no_backward``).  ``dense_gemm.launches`` counts the kernel's
launches, ``dense_gemm.split_launches`` those of them whose K was split.

The K split (``split_k``).  The kernel is persistent: min(tiles x parts,
SMs) blocks, one an SM, each walking its 128 x 128 output tiles in turn.
Where the tiles leave many SMs idle in the last round of that walk
(zamba2's products at N = 2560: 160 tiles on 132 SMs, two rounds, the
second 21% full), K is cut into parts, each at least ``MIN_PART_STEPS``
steps of K, whose partial products a second pass sums in a fixed order.
The part count (up to ``MAX_PARTS``) is the one of least estimated time:
rounds of the walk times the K steps of a part, at ``STEP_US`` a
round-step, plus the sum pass's bytes at ``SUM_BYTES_PER_US``.  A fixed
rule of the shape: nothing is timed at start-up.  The two rates are an
H100's, a least-squares fit to chip_smoke.py --measure-dense-gemm's sweep
of every part count at every served shape (36 timings): 1.12 us a
round-step (text8's 8192 x 768 x 768, 3 rounds x 24 steps: 81 us by the
model, 86 measured), the sum pass at 1.9e6 bytes a us (28 us for
zamba2's 4-part 1024 x 5120 x 2560, 52 MB); with them the rule picks the
fastest count of that sweep at every served shape.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dense_gemm import ref

TILE_M = TILE_N = 128          # a block's output tile (dense_gemm.cu)
TILE_K = 32                    # K a pipeline stage covers
MAX_PARTS = 4
MIN_PART_STEPS = 8             # K steps (of TILE_K) a part runs at least
STEP_US = 1.12                 # a round of the walk through one K step
SUM_BYTES_PER_US = 1.9e6       # the sum pass's rate


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def split_k(M: int, N: int, K: int, sms: int) -> int:
    """The number of parts K is cut into for an (M, K) x (K, N) product on
    a card of ``sms`` SMs, a block an SM."""
    tiles = _cdiv(M, TILE_M) * _cdiv(N, TILE_N)
    steps = _cdiv(K, TILE_K)
    best, best_us = 1, None
    for parts in range(1, MAX_PARTS + 1):
        if parts > 1 and steps < parts * MIN_PART_STEPS:
            break
        us = _cdiv(tiles * parts, sms) * _cdiv(steps, parts) * STEP_US
        if parts > 1:
            us += (parts + 1) * M * N * 4 / SUM_BYTES_PER_US
        if best_us is None or us < best_us:
            best, best_us = parts, us
    return best


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def layout(a, b):
    """(a's row stride, B K-major, B's row stride) where the kernel takes
    a (..., K) and b (K, N) as they lie: both f32, b 2-D, K agreeing, on
    one device, a's rows at one stride (a 2-D, or contiguous), and the
    kernel's terms (above); else None.  The fast test of
    ``layers.dense``, which passes activations with their leading dims:
    it neither raises nor looks at the device's type, and reads each
    stride tuple once (every call to a tensor's methods costs the host)."""
    if a.dtype is not torch.float32 or b.dtype is not torch.float32:
        return None
    sa, sb, shape = a.stride(), b.stride(), a.shape
    K = shape[-1] if shape else 0
    if (len(sb) != 2 or len(sa) < 2 or b.shape[0] != K or K == 0 or K % 4
            or sa[-1] != 1):
        return None
    lda = sa[0] if len(sa) == 2 else K if a.is_contiguous() else 0
    N = b.shape[1]
    if (lda == 0 or lda % 4 or a.data_ptr() % 16 or b.data_ptr() % 16
            or a.get_device() != b.get_device()
            or max(a.numel() // K, N) >= 2 ** 31):
        return None
    if sb[1] == 1 and sb[0] % 4 == 0 and N % 4 == 0:
        return lda, False, sb[0]
    if sb[0] == 1 and sb[1] % 4 == 0:
        return lda, True, sb[1]
    return None


def _check(a, b) -> None:
    """Raise on what neither route takes.  A dim of one element may carry
    any stride."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want a (M, K) and b (K, N); got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a and b must be f32, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError("dense_gemm inputs lie on different devices")
    (K, N) = b.shape
    if a.stride(1) != 1 and K > 1:
        raise ValueError(f"the rows of a must be contiguous, got strides "
                         f"{a.stride()}")
    if max(*a.shape, N) >= 2 ** 31:
        raise ValueError(f"dims must be below 2**31, got {tuple(a.shape)} "
                         f"x {tuple(b.shape)}")
    if not (b.stride(1) == 1 or N == 1 or b.stride(0) == 1 or K == 1):
        raise ValueError(f"b must be row-major or a transposed row-major "
                         f"matrix, got strides {b.stride()}")


def dense_gemm(a, b):
    """a (M, K) f32 @ b (K, N) f32 -> (M, N) f32, contiguous."""
    build.no_backward("dense_gemm", a, b)
    lay = layout(a, b) if a.is_cuda and a.dim() == 2 else None
    if lay is not None:
        return run(a, b, *lay)
    _check(a, b)
    if a.device.type == "cpu":
        return ref.dense_gemm(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"dense_gemm runs on cuda or cpu, not {a.device}")
    raise ValueError(
        f"the kernel reads 16-byte aligned rows: a and b must start on "
        f"16-byte boundaries, with row strides and K multiples of 4, and N "
        f"too where b is row-major; got {tuple(a.shape)} x "
        f"{tuple(b.shape)}, strides {a.stride()} and {b.stride()}")


def run(a, b, lda: int, kmajor: bool, ldb: int):
    """The launch, unchecked: for a (..., K) and b whose ``layout`` is
    (lda, kmajor, ldb), on the card, with no gradient to record; the
    output is (..., N)."""
    shape, N = a.shape, b.shape[1]
    K = shape[-1]
    M = a.numel() // K
    out = torch.empty((*shape[:-1], N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    index = a.get_device()
    sms = _sms(index)
    parts = split_k(M, N, K, sms)
    work = (torch.empty((parts, M, N), dtype=torch.float32, device=a.device)
            if parts > 1 else None)
    build.launch("dense_gemm", build.library().lib.dense_gemm_f32, index,
                 a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 None if work is None else work.data_ptr(), M, N, K, lda,
                 ldb, int(kmajor), parts, sms)
    dense_gemm.launches += 1
    if parts > 1:
        dense_gemm.split_launches += 1
    return out


dense_gemm.launches = 0
dense_gemm.split_launches = 0
