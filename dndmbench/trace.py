"""Reading a ``torch.profiler`` trace of a bounded stretch of a run.

Only CUDA activity is recorded: the device's kernels, copies and fills,
and the host's CUDA runtime calls (``cuda*``, ``cu*``).  The
arithmetic is ``chip_smoke.py``'s ``profile_serving``: the host's own
time is the wall outside runtime calls; the device's busy time is the
union of its operations' intervals.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import torch

def union_ns(spans) -> int:
    """Total length of the union of (start, end) intervals."""
    total, reach = 0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


@dataclasses.dataclass
class Trace:
    """What the profiler saw over ``calls`` network calls in ``wall_s``
    seconds of host time."""
    device_ops: list          # (name, start_ns, dur_ns)
    runtime: list             # (name, start_ns, dur_ns)
    wall_s: float = 0.0
    calls: int = 0

    def kernels(self, *stems: str) -> list:
        return [op for op in self.device_ops
                if any(s in op[0] for s in stems)]

    def device_seconds(self, *stems: str) -> float:
        return sum(op[2] for op in self.kernels(*stems)) / 1e9

    def busy_s(self) -> float:
        return union_ns((s, s + d) for _, s, d in self.device_ops) / 1e9

    def host_own_s(self) -> float:
        return self.wall_s - union_ns(
            (s, s + d) for _, s, d in self.runtime) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device by what the host was doing: the runtime call
        that overlaps the gap most (else "host code"), and the operation
        that ended the gap."""
        per = collections.Counter()
        for name, _, dur in self.device_ops:
            per[_short(name)] += dur / 1e9
        gaps = collections.Counter()
        ops = sorted((s, s + d, n) for n, s, d in self.device_ops)
        calls = sorted((s, s + d, n) for n, s, d in self.runtime)
        reach, j = None, 0
        for start, end, name in ops:
            if reach is not None and start > reach:
                while j < len(calls) and calls[j][1] <= reach:
                    j += 1
                best, what, k = 0, "host code", j
                while k < len(calls) and calls[k][0] < start:
                    cs, ce, cn = calls[k]
                    ov = min(ce, start) - max(cs, reach)
                    if ov > best:
                        best, what = ov, cn
                    k += 1
                gaps[f"{what} before {_short(name)}"] += (start - reach) / 1e9
            reach = end if reach is None else max(reach, end)
        return {"device_ops": [[n, s] for n, s in per.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}


def _short(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for cut in ("<", "("):
        name = name.split(cut, 1)[0]
    return name.strip()[:96]


class Profiled:
    """``with Profiled(device) as tr: ...`` traces the block, with the
    device idle at both ends (synchronised); :meth:`collect`, called
    once the window has closed, reads the events into ``tr``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.trace = Trace([], [])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> Trace:
        from torch.profiler import ProfilerActivity, profile
        acts = ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                else [ProfilerActivity.CPU])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._sync()
        self._t0 = time.perf_counter()
        return self.trace

    def __exit__(self, *exc):
        self._sync()
        self.trace.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def collect(self) -> Trace:
        if self.device.type != "cuda":
            return self.trace
        for e in self._prof.profiler.kineto_results.events():
            row = (e.name(), e.start_ns(), e.duration_ns())
            if str(e.device_type()).endswith("CUDA"):
                self.trace.device_ops.append(row)
            elif e.name().startswith("cu"):
                self.trace.runtime.append(row)
        self._prof = None
        return self.trace
