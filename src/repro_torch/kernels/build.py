"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

The sources (and the headers beside them, ``*.cuh``) are compiled with
``nvcc`` for ``sm_90a`` (Hopper) at first use into one shared library
with a plain C interface, which is loaded with ``ctypes``.  The library
goes to ``build/`` at the root of the checkout, named by a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one
is loaded as it is.  Each source is its own ``nvcc -c`` process, all
started together, and the objects are linked once.

There is no fallback: a missing ``nvcc`` or a failed build raises.  The
build runs only when a kernel is launched on a CUDA tensor; importing
this module compiles nothing.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# No --use_fast_math: it would make the /temperature of dndm_update and
# decode_scores approximate and break their bitwise token contract with
# the plain versions, and turn decode_scores' expf/logf into __expf/__logf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_DNDM = [_P] * 6 + [_LL, _I, _I, _I, _F, _P]
_FLASH = [_P] * 4 + [_I] * 5 + [_LL] * 12 + [_I, _I, _F, _P]
_DECODE = [_P] * 5 + [_I] * 5 + [_LL] * 10 + [_I] * 3 + [_F, _P]
_PARTIALS = [_P] * 7 + [_I] * 5 + [_LL] * 8 + [_I] * 5 + [_F, _P]
_SCORES = [_P] * 5 + [_LL, _I, _F, _P]
_SSD = [_P] * 9 + [_I] * 6 + [_LL] * 13 + [_P]
_GEMM = [_P] * 4 + [_I] * 3 + [_LL] * 2 + [_I] * 3 + [_P]
ARGTYPES = {
    # logits, gumbel, mask, x, tau, out, rows, K, t, version,
    # temperature, stream
    "dndm_update_f32": _DNDM,
    "dndm_update_bf16": _DNDM,
    # q, k, v, o, B, S, H, KV, hd, 12 strides, causal, window, scale,
    # stream
    "flash_attention_f32": _FLASH,
    "flash_attention_bf16": _FLASH,
    # q, k, v, o, workspace, B, L, H, KV, hd, 10 strides (q and o: b, h;
    # k and v: b, s, h), pos, window, chunk, scale, stream
    "flash_decode_f32": _DECODE,
    "flash_decode_bf16": _DECODE,
    # q, k, v, m, l, acc, workspace, B, L, H, KV, hd, 8 strides (q: b, h;
    # k and v: b, s, h), pos, window, ring_len, slot0, chunk, scale, stream
    "flash_decode_partials_f32": _PARTIALS,
    "flash_decode_partials_bf16": _PARTIALS,
    # logits, gumbel, mask, tok, score, rows, K, temperature, stream
    "decode_scores_f32": _SCORES,
    "decode_scores_bf16": _SCORES,
    # x, dt, A, Bm, Cm, y, states, cs_last, cb, B, S, H, P, N, L,
    # 13 strides, stream
    "ssd_scan_f32": _SSD,
    "ssd_scan_bf16": _SSD,
    # A, B, C, work, M, N, K, lda, ldb, b_kmajor, parts, sms, stream
    "dense_gemm_f32": _GEMM,
}


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    built: bool             # False when an earlier build was loaded
    seconds: float          # wall seconds of the build (0.0 if loaded)
    log: str                # nvcc's output (ptxas registers, smem, spills)


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    the toolkit's conventional install location."""
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "repro_torch/csrc at first use; set CUDA_HOME to the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *sorted(CSRC.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(srcs: list[Path], out: Path) -> str:
    """nvcc -c for every source in parallel, then one link; returns the
    compiler output.  The library appears at ``out`` atomically."""
    cc = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([cc, *NVCC_FLAGS, "-c", str(s), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs, failed = [], []
        for s, p in zip(srcs, procs):
            text, _ = p.communicate()
            logs.append(f"== {s.name}\n{text}")
            if p.returncode:
                failed.append(s.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([cc, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, out)
    return log


@functools.cache
def library() -> Library:
    """Build (if needed) and load the kernels' shared library."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out = BUILD_DIR / f"repro_torch_kernels-{_digest(srcs)}.so"
    log_path = out.with_suffix(".log")
    built, seconds = False, 0.0
    if not out.exists():
        t0 = time.perf_counter()
        log = _compile(srcs, out)
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
        built = True
    log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(out))
    for name, args in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return Library(lib=lib, path=out, built=built, seconds=seconds, log=log)


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def inputs_agree(kernel: str, first: torch.Tensor, *others) -> None:
    """Raise unless every tensor of ``others`` (None entries skipped)
    lies on ``first``'s device and all are contiguous.  On CUDA the device
    is compared as ``is_cuda`` and the ``get_device()`` index, which costs
    the host less than building a ``torch.device`` per tensor; elsewhere
    as whole ``torch.device`` objects."""
    if first.is_cuda:
        index = first.get_device()
        for a in others:
            if a is not None and (not a.is_cuda or a.get_device() != index):
                raise ValueError(f"{kernel} inputs lie on different devices")
    else:
        device = first.device
        for a in others:
            if a is not None and a.device != device:
                raise ValueError(f"{kernel} inputs lie on different devices")
    if not first.is_contiguous():
        raise ValueError(f"{kernel} inputs must be contiguous")
    for a in others:
        if a is not None and not a.is_contiguous():
            raise ValueError(f"{kernel} inputs must be contiguous")


def no_backward(kernel: str, *tensors) -> None:
    """Raise when autograd records and one of ``tensors`` (None entries
    skipped) requires a gradient: no kernel of the port has a backward,
    and its output would silently cut the graph, on the card as on the
    CPU.  Serving runs under ``torch.inference_mode``, where grad mode is
    off, so the check ends at its first test there."""
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad
                                       for a in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: call it under torch.no_grad() or "
            "torch.inference_mode(), or differentiate the plain route "
            "(attn_impl 'einsum' or 'blocked')")


def launch(kernel: str, fn, device: int, *args) -> None:
    """Call the C entry point ``fn`` with ``args`` and, last, the raw
    handle of the current stream of CUDA device ``device`` (an index),
    with that device current during the call; raise if it returns a CUDA
    error.  The raw handle and an integer device check cost the host less
    than entering ``torch.cuda.device`` and building a
    ``torch.cuda.Stream`` for every launch, and the wrappers' host time
    paces the small kernels."""
    if device == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    check(rc, kernel)
