"""Drain-mode request scheduler.

:class:`BatchScheduler` groups requests by method into fixed-shape
power-of-two batch buckets, and each batch runs a whole sampler
trajectory before the next starts.  Each batch's seed is drawn from a
``torch.Generator`` seeded with the scheduler's ``seed``, so a drain is
reproducible.  The continuous NFE-aware scheduler comes with a later
slice.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.serving.engine import GenerationEngine


@dataclasses.dataclass
class Request:
    rid: int
    length: int
    prefix: np.ndarray | None = None        # (P,) source tokens
    method: str | None = None               # resolved at submit time
    result: np.ndarray | None = None
    nfe: int = 0
    wall: float = 0.0                       # amortized share of batch_wall
    batch_wall: float = 0.0                 # wall-clock of the whole batch
    batch_size: int = 0                     # requests served in that batch
    compile_seconds: float = 0.0            # the batch's one-time warm-up
    # lifecycle timestamps (time.time()): queue latency = t_admit -
    # t_submit, service time = t_done - t_admit
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0
    # the batch's seed: engine.generate(seed, bucket, bucket_len, ...)
    # replays the batch this request was served in
    seed: int | None = None


class BatchScheduler:
    """Greedy fixed-bucket batching, grouped by sampler method.

    ``device`` (``None`` means ``cuda``, which must exist) must be the
    engine's device.
    """

    def __init__(self, engine: GenerationEngine, max_batch: int = 8,
                 bucket_len: int = 64, seed: int = 0, *, device=None):
        dev = device_lib.resolve(device)
        if dev != engine.device:
            raise ValueError(f"scheduler on {dev}, engine on {engine.device}")
        self.engine = engine
        self.max_batch = max_batch
        self.bucket_len = bucket_len
        self.queue: list[Request] = []
        self.done: dict[int, Request] = {}
        self._rid = 0
        self._seeds = torch.Generator().manual_seed(seed)

    def submit(self, length: int, prefix: np.ndarray | None = None,
               method: str | None = None) -> int:
        # normalize to a concrete method so explicit-default and default
        # requests share a batch, and fail fast on unknown or
        # incompatible methods
        method = method or self.engine.cfg.method
        self.engine.check_method(method)
        if length > self.bucket_len:
            raise ValueError(f"length {length} > bucket_len "
                             f"{self.bucket_len}")
        self._rid += 1
        req = Request(self._rid, length, prefix, method)
        req.t_submit = time.time()
        self.queue.append(req)
        return self._rid

    def batch_bucket(self, n: int) -> int:
        """Batch size serving a group of ``n`` requests: the next power of
        two, capped at ``max_batch``."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _buckets(self) -> list[list[Request]]:
        """Split the queue into per-method FIFO batches of up to
        ``max_batch`` (methods keep first-arrival order)."""
        groups: dict[str, list[Request]] = {}
        for r in self.queue:
            groups.setdefault(r.method, []).append(r)
        self.queue = []
        return [g[i:i + self.max_batch] for g in groups.values()
                for i in range(0, len(g), self.max_batch)]

    def run(self) -> dict[int, Request]:
        """Drain the queue; returns completed requests by id.

        Each request records its *amortized* wall share (``wall =
        batch_wall / batch_size``) plus the batch totals.
        """
        dev = self.engine.device
        for batch in self._buckets():
            # pad the batch dim to the bucket; padded rows are generated
            # and sliced off below
            B = self.batch_bucket(len(batch))
            N = self.bucket_len
            m = batch[0].method
            cond = None
            if batch[0].prefix is not None:
                # left-pad short prefixes with the noise pad token ([MASK]
                # for absorbing): a real vocab token would condition the
                # row on spurious content
                P = max(len(r.prefix) for r in batch)
                pre = np.full((B, P), self.engine.noise.pad_id, np.int32)
                for i, r in enumerate(batch):
                    pre[i, P - len(r.prefix):] = r.prefix
                cond = {"prefix_tokens": torch.as_tensor(pre, device=dev)}
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self._seeds))
            t_admit = time.time()
            out, wall = self.engine.generate(seed, B, N, cond=cond, method=m)
            toks = out.tokens.cpu().numpy()
            share = wall / len(batch)
            t_done = time.time()
            for i, r in enumerate(batch):
                r.result = toks[i, : r.length]
                r.nfe = out.nfe
                r.wall = share
                r.batch_wall = wall
                r.batch_size = len(batch)
                r.compile_seconds = out.aux["compile_seconds"]
                r.t_admit = t_admit
                r.t_done = t_done
                r.seed = seed
                self.done[r.rid] = r
        return self.done
