"""What the metric readers (``metrics/<name>.py``) share: each reader
declares its layer, unit, the end-to-end metric it moves and its cells,
and calls one of these on the run's ``harness.Context``.  A reader
whose source is absent in the run (no trace, no kernel of its name)
returns None."""
from __future__ import annotations

from dndmbench.harness import percentile
from dndmbench.work import (PEAKS, bound_seconds, decode_scores, dndm_update,
                            flash_attention, ssd_scan)


def latency(ctx, q: int):
    """The q-th percentile of due-to-completion seconds over the requests
    due in the window."""
    vals = [r["done"] - r["due"] for r in ctx.requests if "done" in r]
    return percentile(vals, q) if vals else None


def queue_wait(ctx, q: int):
    """The q-th percentile of due-to-admission seconds over the requests
    due in the window, on the harness's clock."""
    vals = [r["admit"] - r["due"] for r in ctx.requests if "admit" in r]
    return percentile(vals, q) if vals else None


def live_rows_per_call(ctx):
    """Open loop: request NFE completed in the window over the window's
    network calls; closed loop: the batch's rows."""
    if ctx.traffic["loop"] == "closed":
        return float(ctx.traffic["rows"])
    if not ctx.calls:
        return None
    return sum(r["nfe"] for r in ctx.completed_in_window) / ctx.calls


def ms_per_call(ctx):
    return 1e3 * ctx.window_s / ctx.calls if ctx.calls else None


def call_mfu(ctx):
    """The window's model operations (the configuration's work module,
    ``ctx.work``, at the live rows) over its seconds, as a share (%) of
    the f32 peak."""
    rows = live_rows_per_call(ctx)
    if not rows or not ctx.window_s:
        return None
    ops = ctx.work.flops(ctx.config, 1, ctx.traffic["N"]) * rows * ctx.calls
    return 100.0 * ops / ctx.window_s / PEAKS["flops_per_s"][ctx.config["dtype"]]


def host_ms_per_call(ctx):
    """The host's own time (outside CUDA runtime calls) per traced call."""
    t = ctx.trace
    if t is None or not t.calls or not t.runtime:
        return None
    return 1e3 * t.host_own_s() / t.calls


def idle_share(ctx):
    t = ctx.trace
    if t is None or not t.device_ops or not t.wall_s:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.wall_s)


def roofline(ctx, stems: tuple, count_stem: str, bound_s: float):
    """Launches (device operations whose name holds ``count_stem``) times
    one launch's bound over the device time of the operations whose names
    hold one of ``stems``, in %.  Each metric's file names its kernels."""
    t = ctx.trace
    if t is None:
        return None
    launches = len(t.kernels(count_stem))
    dev = t.device_seconds(*stems)
    if not launches or dev <= 0:
        return None
    return 100.0 * launches * bound_s / dev


def _itemsize(ctx) -> int:
    return {"float32": 4, "bfloat16": 2}[ctx.config["dtype"]]


def flash_bound(ctx) -> float:
    c, B, S = ctx.config, ctx.traffic["rows"], ctx.traffic["N"]
    return bound_seconds(
        flash_attention.flops(B, S, c["n_heads"], c["head_dim"]),
        flash_attention.nbytes(B, S, c["n_heads"], c["n_kv_heads"],
                               c["head_dim"], _itemsize(ctx)), c["dtype"])


def decode_bound(ctx, op: str) -> float:
    mod = {"dndm_update": dndm_update, "decode_scores": decode_scores}[op]
    rows = ctx.traffic["rows"] * ctx.traffic["N"]
    K = ctx.config["vocab_size"]
    return bound_seconds(mod.flops(rows, K),
                         mod.nbytes(rows, K, _itemsize(ctx)))


def ssd_bound(ctx) -> float | None:
    c, B, S = ctx.config, ctx.traffic["rows"], ctx.traffic["N"]
    if "d_inner" not in c:
        return None
    H = c["d_inner"] // c["ssm_head_dim"]
    return bound_seconds(
        ssd_scan.flops(B, S, H, c["ssm_head_dim"], c["ssm_state"],
                       c["ssd_chunk"]),
        ssd_scan.nbytes(B, S, H, c["ssm_head_dim"], c["ssm_state"],
                        _itemsize(ctx)), c["dtype"])
