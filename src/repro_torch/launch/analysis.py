"""Compile-only analysis of the port: what one rank runs, counted while
the dry run traces it (``launch/dryrun.py``), analytic FLOPs, and the
three roofline terms (compute / memory / collective) of an NVIDIA H100.

The port of ``repro.launch.analysis``.  Where XLA hands the reference a
compiled program's cost analysis and HLO text, eager PyTorch has neither:
:class:`Recorder`, a dispatch mode, sees every aten op and collective
that one rank runs on its local tensors (fake ones in the dry run) and
counts

* FLOPs with ``torch.utils.flop_counter``'s formulas (matmuls, convs,
  attention ops; elementwise work counts nothing, as in FlopCounterMode);
* bytes, the stand-in for XLA's ``bytes accessed``: eager PyTorch
  launches one kernel per aten op, so each op that computes (not a view,
  not an allocation) reads its tensor inputs and writes its outputs once;
* collectives (``c10d`` and ``_c10d_functional`` ops): kind, result
  bytes and the ranks of the group;
* memory: the bytes of live storages, arguments included, and their
  peak.

DTensor ops pass through to their local ops and the collectives DTensor
issues, so the counts are one rank's (rank 0's).  The shape propagation
that DTensor runs on whole-size fake tensors is not counted: the
recorder finds it by the name of its frame, ``_propagate_tensor_meta*``
(a private name of ``torch.distributed.tensor._sharding_prop``), and
refuses to start if torch no longer has it.

Where the card runs one fused kernel and the CPU trace its plain version
(``ssd_scan`` at inference), :meth:`Recorder.fuse` keeps, beside the
bytes counted inside each call, the kernel's model less them: each
tensor argument read once, the output written once.

Hardware constants: NVIDIA H100 SXM data sheet, dense rates, 700 W: 989
TFLOP/s bf16 (tensor cores), 67 TFLOP/s f32 (CUDA cores; the port keeps
TF32 off), 3.35 TB/s HBM3; NVLink 450 GB/s each way between the 8 cards
of a host, and one 400 Gb/s NDR InfiniBand port, 50 GB/s, per card
across hosts.  A collective costs its result bytes over the slowest
link its group crosses.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card, each way, inside a host
IB_BW = 50e9                 # bytes/s per card across hosts (400 Gb/s)
CARDS_PER_HOST = 8

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# op name (without namespace and overload) -> the reference's HLO kind
_KIND = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "broadcast_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
}


def peak_flops(dtype: str) -> float:
    """The H100's dense peak for products in ``dtype``."""
    return PEAK_FLOPS[str(dtype).replace("torch.", "")]


def link_bw(ranks) -> float:
    """Bytes/s per card of a group: NVLink inside one host of 8 cards,
    InfiniBand once the group spans hosts."""
    return (NVLINK_BW if len({r // CARDS_PER_HOST for r in ranks}) <= 1
            else IB_BW)


# ------------------------------------------------------------------
# The recorder
# ------------------------------------------------------------------

def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (the tensor this rank holds), else ``t``."""
    return getattr(t, "_local_tensor", t)


def _group_ranks(func, args, kwargs) -> list[int]:
    """The ranks of a collective's group: its ``process_group`` argument
    (``c10d`` ops) or ``group_name`` (``_c10d_functional`` ops)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for i, a in enumerate(func._schema.arguments):
        if a.name not in ("process_group", "group_name"):
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        if isinstance(v, str):
            return dist.get_process_group_ranks(_resolve_process_group(v))
        if isinstance(v, torch.ScriptObject):
            v = torch._C._distributed_c10d.ProcessGroup.unbox(v)
        return dist.get_process_group_ranks(v)
    return []


def _check_shape_propagation_name() -> None:
    """Raise unless DTensor's sharding propagator still has the frame
    that :func:`_in_shape_propagation` looks for: without it every rank's
    counts would silently take in whole-size ops."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if not any(n.startswith("_propagate_tensor_meta")
               for n in vars(ShardingPropagator)):
        raise RuntimeError(
            "torch.distributed.tensor's ShardingPropagator has no "
            "_propagate_tensor_meta* method: the recorder cannot tell "
            "DTensor's whole-size shape propagation from a rank's ops")


def _in_shape_propagation() -> bool:
    """Whether DTensor's sharding propagation, which runs an op on
    whole-size fake tensors to learn its output's shape, is on the
    stack."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


_SKIP = {"empty", "empty_strided", "empty_like", "detach", "alias",
         "_local_scalar_dense", "device", "lift_fresh", "wait_tensor",
         "set_", "resize_"}


class Recorder(TorchDispatchMode):
    """Counts one rank's work while it is active (module docstring):
    ``flops``, ``bytes``, ``collectives`` (a list of {"kind", "bytes",
    "ranks"}), ``live`` and ``peak`` memory in bytes.  ``track`` adds
    tensors that exist before the run (parameters, optimizer state,
    inputs) to the live bytes, once per storage.  ``fused_bytes`` is what
    the card's fused kernels move less what ``bytes`` counted for their
    plain versions (:meth:`fuse`; negative where the plain version moves
    more)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        _check_shape_propagation_name()
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.fused_bytes = 0
        self.collectives: list[dict] = []
        self.live = 0
        self.peak = 0
        self._seen: dict[int, weakref.ref] = {}

    def _add(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage as live until it is freed; False if it
        already was."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen and self._seen[key]() is st:
            return False
        size = st.nbytes()

        def freed(_, key=key, size=size):
            self._seen.pop(key, None)
            self.live -= size
        self._seen[key] = weakref.ref(st, freed)
        self.live += size
        self.peak = max(self.peak, self.live)
        return True

    def track(self, tensors) -> int:
        """Count ``tensors`` (DTensors by their local blocks) as live;
        returns the bytes added."""
        before = self.live
        for t in _tensors(tensors):
            self._add(local(t))
        return self.live - before

    @contextlib.contextmanager
    def fuse(self, module, name: str):
        """While active, each call of ``module.name`` (a kernel's wrapper,
        which on CPU tensors runs its plain version) adds to
        ``fused_bytes`` the fused kernel's bytes (its tensor arguments
        read once, its output written once) less what ``bytes`` counted
        inside the call."""
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            before = self.bytes
            out = fn(*args, **kwargs)
            fused = sum(_nbytes(local(t))
                        for t in _tensors((args, kwargs, out)))
            self.fused_bytes += fused - (self.bytes - before)
            return out
        setattr(module, name, counted)
        try:
            yield self
        finally:
            setattr(module, name, fn)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # its local ops come back here
        out = func(*args, **kwargs)
        if _in_shape_propagation():
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in ("c10d", "_c10d_functional"):
            kind = _KIND.get(name)
            if kind is not None:
                res = _tensors(out) or _tensors(args[0])
                self.collectives.append({
                    "kind": kind, "bytes": sum(_nbytes(t) for t in res),
                    "ranks": _group_ranks(func, args, kwargs)})
            for t in _tensors(out):
                self._add(t)
            return out
        outs = _tensors(out)
        for t in outs:
            self._add(t)
        if name in _SKIP or func.is_view:
            return out
        fn = self._flops.get(func._overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        if not name.startswith(("zeros", "ones", "full", "scalar_tensor",
                                "arange")):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in outs)
        return out


def mfu(model_flops: float, seconds: float, n_chips: int = 1,
        dtype: str = "bfloat16") -> float:
    """Model FLOPs utilisation: the useful FLOPs of a step or call
    (:func:`model_flops`: 6 or 2 x active parameters x tokens, no
    recomputation, no redundant work) over what ``n_chips`` cards could
    do at ``dtype``'s peak in the measured ``seconds``."""
    return model_flops / (seconds * n_chips * peak_flops(dtype))


def collective_bytes(records: list[dict]) -> dict[str, int]:
    """Sum the result bytes of every recorded collective by the
    reference's HLO kinds (result bytes ~ data moved per card for
    all-reduce and all-gather; a documented proxy), plus their count."""
    out = {k: 0 for k in _COLLECTIVES}
    out["count"] = 0
    for r in records:
        if r["kind"] in out:
            out[r["kind"]] += r["bytes"]
            out["count"] += 1
    return out


def collective_seconds(records: list[dict]) -> float:
    """Each collective's result bytes over the slowest link of its
    group (:func:`link_bw`), summed."""
    return sum(r["bytes"] / link_bw(r["ranks"]) for r in records)


# ------------------------------------------------------------------
# Roofline
# ------------------------------------------------------------------

@dataclasses.dataclass
class RooflineTerms:
    """All times in seconds (per card, per step)."""

    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float                # per card (counted)
    hlo_bytes: float                # per card
    coll_bytes: float               # per card
    model_flops: float              # analytic, whole program
    scan_correction_flops: float    # flops the counters miss
    n_chips: int = 256

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs (remat/redundancy waste)."""
        tot = self.hlo_flops * self.n_chips
        return self.model_flops / tot if tot else float("nan")

    @property
    def bound_s(self) -> float:
        """The least time the step could take: the largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(cost: dict, coll: dict[str, int], n_chips: int,
             model_flops: float, scan_correction: float = 0.0,
             bytes_correction: float = 0.0, *, dtype: str = "bfloat16",
             collective_s: float | None = None) -> RooflineTerms:
    """cost: {"flops", "bytes accessed"} per card (the recorder's
    counts).  Corrections are whole-program and spread evenly over the
    cards.  The compute peak comes from ``dtype``.  ``collective_s``
    (:func:`collective_seconds` of the records, which know their groups)
    overrides the default, every collective byte over InfiniBand."""
    flops = float(cost.get("flops", 0.0)) + scan_correction / n_chips
    bytes_ = max(0.0, float(cost.get("bytes accessed", 0.0)) +
                 bytes_correction / n_chips)
    cbytes = float(sum(v for k, v in coll.items() if k != "count"))
    if collective_s is None:
        collective_s = cbytes / IB_BW
    return RooflineTerms(
        compute_s=flops / peak_flops(dtype),
        memory_s=bytes_ / HBM_BW,
        collective_s=collective_s,
        hlo_flops=flops, hlo_bytes=bytes_, coll_bytes=cbytes,
        model_flops=model_flops,
        scan_correction_flops=scan_correction,
        n_chips=n_chips,
    )


# ------------------------------------------------------------------
# Analytic model FLOPs
# ------------------------------------------------------------------

def param_counts(model) -> tuple[int, int]:
    """(total, active) parameter counts of ``model`` (built on the meta
    device or under a fake mode: no allocation).  The active count
    leaves out the inactive experts' share of every expert weight, the
    router's excepted, as the reference does."""
    total = sum(int(np.prod(p.shape)) for p in model.parameters())
    cfg = model.cfg
    active = total
    if cfg.n_experts:
        moe_params = sum(int(np.prod(p.shape))
                         for n, p in model.named_parameters()
                         if ".moe." in n and not n.endswith("router"))
        active = total - int(
            moe_params * (1 - cfg.experts_per_token / cfg.n_experts))
    return total, active


def model_flops(model, n_tokens: int, mode: str) -> float:
    """6*N_active*D for training, 2*N_active*D for inference passes."""
    _, active = param_counts(model)
    mult = 6.0 if mode == "train" else 2.0
    return mult * active * n_tokens


def scan_correction(cfg, batch: int, seq: int, mode: str) -> float:
    """The sLSTM recurrent matmul's FLOPs, which XLA's cost analysis
    costs once per scan in the reference.  Per step per layer: (B, nh,
    dh) x (nh, dh, 4dh) = B*d*4dh MACs.  The port's counter sees every
    step of its Python loop, so the dry run does not add this."""
    n_slstm = sum(1 for k in cfg.block_pattern if k == "slstm")
    if not n_slstm or mode == "decode":
        return 0.0
    nh = cfg.lstm_heads
    dh = cfg.d_model // nh
    per_step = 2.0 * batch * cfg.d_model * 4 * dh
    steps = seq * (2 if cfg.bidirectional else 1)
    fb = 3.0 if mode == "train" else 1.0       # fwd+bwd multiplier
    return n_slstm * per_step * steps * fb


def attention_blocks(cfg) -> int:
    """The attention sites of ``cfg``'s pattern."""
    return sum(1 for k in cfg.block_pattern
               if k in ("attn", "swa", "moe", "shared_attn"))


def flash_attn_correction(cfg, batch: int, seq: int,
                          mode: str) -> tuple[float, float]:
    """(flops_corr, bytes_corr) when ``attn_impl == "blocked"``, the
    reference's: XLA costs one KV block of its ``lax.scan``, so it adds
    the other blocks' FLOPs, and replaces the counted block's traffic
    with the fused kernel's model (Q, K, V read and O written once per
    layer).  Whole-program numbers; bytes_corr can be negative."""
    if cfg.attn_impl != "blocked" or mode == "decode":
        return 0.0, 0.0
    n_attn = attention_blocks(cfg)
    if not n_attn:
        return 0.0, 0.0
    B, S, H, hd = batch, seq, cfg.n_heads, cfg.hd
    nk = max(1, -(-S // cfg.attn_block_k))
    dirs = 2 if cfg.bidirectional else 1
    fb = 3.0 if mode == "train" else 1.0
    dt_bytes = 2 if "16" in cfg.dtype else 4

    full = 4.0 * B * H * S * S * hd            # QK^T + PV (fwd, one dir)
    counted = full / nk
    flops_corr = (full - counted) * n_attn * dirs * fb

    flash_bytes = 4.0 * B * S * H * hd * dt_bytes          # q,k,v,o once
    # the counted block's dominant traffic: logits written + re-read by
    # softmax + probs read by PV: ~3 x (B,H,S,S/nk) fp32
    counted_bytes = 3.0 * B * H * S * (S / nk) * 4.0
    bytes_corr = (flash_bytes - counted_bytes) * n_attn * dirs * fb
    return flops_corr, bytes_corr


def corrections(cfg, batch: int, seq: int, mode: str) -> dict:
    """The reference's analytic corrections for scan-hidden and
    kernel-fused compute."""
    f = scan_correction(cfg, batch, seq, mode)
    fa, ba = flash_attn_correction(cfg, batch, seq, mode)
    return {"flops": f + fa, "bytes": ba,
            "slstm_flops": f, "flash_flops": fa, "flash_bytes": ba}


def flash_attention_flops(B: int, S: int, H: int, hd: int) -> float:
    """The FLOPs of one self-attention over S positions: QK^T and PV,
    2 * S * S * hd each per (batch, head), as the counter counts the
    plain version's two products."""
    return 4.0 * B * H * S * S * hd


def ssd_scan_flops(B: int, S: int, H: int, P: int, N: int,
                   chunk: int) -> float:
    """The FLOPs of one chunked SSD scan, the products of its plain
    version (``kernels/ssd_scan/ref.py::ssd_chunked``) per chunk of L:
    C B^T (L x L x N), the intra-chunk outputs (L x L x H x P), the chunk
    states and the inter-chunk outputs (L x H x N x P each)."""
    L = min(chunk, S)
    nc = -(-S // L)
    return 2.0 * B * nc * L * (L * N + L * H * P + 2 * H * N * P)
