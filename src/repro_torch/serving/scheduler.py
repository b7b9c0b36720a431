"""Request schedulers: drain-mode batching and continuous NFE-aware
batching.

* :class:`BatchScheduler` — drain mode: requests are grouped by method
  into fixed-shape power-of-two batch buckets, and each batch runs a
  whole sampler trajectory before the next starts.  With independent
  per-request tau sets a batch walks the *union* of its rows' transition
  times.
* :class:`ContinuousScheduler` — continuous mode: ``submit()`` plans the
  request's call schedule at once (``engine.plan_request``), and a
  rolling :class:`~repro_torch.serving.engine.StepwiseRunner` admits
  requests into free rows at any step boundary.  Each batched call
  advances every live row by one entry of its own schedule, so no row
  pays for a step where it has no transition.

Seeds (a batch's in drain mode, a request's in continuous mode) are
drawn from a ``torch.Generator`` seeded with the scheduler's ``seed``, so
a run is reproducible.

Every request gets a trace identity at ``submit()``
(:func:`mint_request_id`); with ``repro_torch.obs`` enabled both
schedulers emit the JAX package's ``scheduler.*`` events, spans and
metrics under it, and score each completed request against the SLO
budgets (``obs.slo``), so ``obs.timeline(request_id)`` rebuilds a
request's submit → admission → per-call → completion history.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import obs
from repro_torch.obs import slo as slo_lib
from repro_torch.serving.engine import GenerationEngine, StepwiseRunner

# process-wide request-id mint: ids stay unique across scheduler
# instances so one trace file can hold several schedulers' requests
_next_request_id = itertools.count(1).__next__


def mint_request_id() -> str:
    return f"req-{_next_request_id():06d}"


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
    # drain mode: the batch's seed, engine.generate(seed, bucket,
    # bucket_len, ...) replays the batch this request was served in;
    # continuous mode: the request's own seed, engine.generate(seed, 1,
    # bucket_len, method=...) replays it solo
    seed: int | None = None
    # continuous mode: the predetermined call schedule (set at submit)
    plan: object | None = None
    steps_executed: int = 0
    steps_skipped: int = 0
    # trace identity, minted at submit(): every span and event of the
    # request carries it
    request_id: str = ""


def _check_device(engine: GenerationEngine, device) -> None:
    dev = device_lib.resolve(device)
    if dev != engine.device:
        raise ValueError(f"scheduler on {dev}, engine on {engine.device}")


def _draw_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen))


class BatchScheduler:
    """Greedy fixed-bucket batching, grouped by sampler method.

    ``device`` (``None`` means ``cuda``, which must exist) must be the
    engine's device.
    """

    def __init__(self, engine: GenerationEngine, max_batch: int = 8,
                 bucket_len: int = 64, seed: int = 0, *, device=None):
        _check_device(engine, device)
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
        req.request_id = mint_request_id()
        req.t_submit = time.time()
        if obs.enabled():
            obs.event("scheduler.submit", request_id=req.request_id,
                      method=method, length=length, mode="drain")
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
        pending = len(self.queue)
        for batch in self._buckets():
            if obs.enabled():
                obs.gauge("scheduler.queue_depth").set(pending)
            pending -= len(batch)
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
            seed = _draw_seed(self._seeds)
            t_admit = time.time()
            rids = ",".join(r.request_id for r in batch)
            with obs.span("scheduler.batch", method=m, requests=len(batch),
                          bucket=B, request_ids=rids) as sp:
                if obs.enabled():
                    for r in batch:
                        obs.event("scheduler.admit",
                                  request_id=r.request_id, method=m,
                                  mode="drain",
                                  queue_s=t_admit - r.t_submit)
                out, wall = self.engine.generate(seed, B, N, cond=cond,
                                                 method=m)
                if obs.enabled():
                    obs.counter("scheduler.batches").inc(method=m)
                    obs.counter("scheduler.requests").inc(len(batch),
                                                          method=m)
                    obs.counter("scheduler.padded_rows").inc(B - len(batch),
                                                             method=m)
                    obs.histogram("scheduler.occupancy").observe(
                        len(batch) / B, method=m)
                    obs.histogram("scheduler.batch_wall_seconds").observe(
                        wall, method=m)
                    sp.set(wall_s=wall, padded_rows=B - len(batch),
                           occupancy=len(batch) / B)
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
                if obs.enabled():
                    obs.histogram("scheduler.queue_latency_seconds").observe(
                        t_admit - r.t_submit, mode="drain")
                    obs.histogram("scheduler.service_seconds").observe(
                        t_done - t_admit, mode="drain")
                    obs.event("scheduler.complete",
                              request_id=r.request_id, method=r.method,
                              mode="drain", nfe=r.nfe,
                              service_s=t_done - t_admit)
                    slo_lib.observe_request(
                        r.method, latency_s=t_done - t_admit,
                        queue_s=t_admit - r.t_submit, nfe=r.nfe)
                self.done[r.rid] = r
        return self.done


class ContinuousScheduler:
    """Continuous NFE-aware batching over rolling stepwise batches.

    ``submit()`` plans the request at once (``engine.plan_request`` under
    the request's own seed), so the scheduler knows every network call the
    request will make before it is admitted.  A
    :class:`~repro_torch.serving.engine.StepwiseRunner` holds up to
    ``max_batch`` in-flight rows; :meth:`pump` admits queued requests into
    free rows at the current step boundary (no drain barrier) and makes
    one batched network call advancing every live row along its own
    schedule.  A request's ``steps_skipped`` (T - |unique tau|) counts the
    grid steps its schedule proved unnecessary, and ``total_calls`` (the
    aggregate NFE) is what the batched calls cost.

    Each request's tokens are its solo ``engine.generate(request.seed, 1,
    bucket_len, method=...)`` run whenever the denoiser is
    batch-shape-invariant (``samplers/stepwise.py`` has the contract).

    Requests are grouped by (method, prefix length): conditional requests
    get a conditional runner per exact prefix length, so prefixes are never
    padded.  Groups with work are served round-robin, one pump each in
    first-arrival order, so a steady stream of one group cannot starve
    another.  ``device`` (``None`` means ``cuda``, which must exist) must
    be the engine's device.
    """

    def __init__(self, engine: GenerationEngine, max_batch: int = 8,
                 bucket_len: int = 64, seed: int = 0, *, device=None):
        _check_device(engine, device)
        self.engine = engine
        self.max_batch = max_batch
        self.bucket_len = bucket_len
        self.queue: list[Request] = []
        self.done: dict[int, Request] = {}
        self._rid = 0
        self._seeds = torch.Generator().manual_seed(seed)
        # group = (method, prefix_len); 0 = unconditional
        self._runners: dict[tuple, StepwiseRunner] = {}
        self._rotation: list[tuple] = []    # groups in first-seen order
        self._rr = 0                        # round-robin cursor
        self._row_req: dict[tuple, Request] = {}  # (group, row) -> request
        self.total_calls = 0        # aggregate NFE: batched network calls

    def submit(self, length: int, prefix: np.ndarray | None = None,
               method: str | None = None) -> int:
        """Enqueue a request; its call schedule is drawn *now*."""
        if length > self.bucket_len:
            raise ValueError(f"length {length} > bucket_len "
                             f"{self.bucket_len}")
        method = method or self.engine.cfg.method
        self.engine.check_method(method)
        self._rid += 1
        if prefix is not None:
            prefix = np.asarray(prefix, np.int32).reshape(-1)
        r = Request(self._rid, length, prefix, method)
        r.request_id = mint_request_id()
        r.seed = _draw_seed(self._seeds)
        r.plan = self.engine.plan_request(r.seed, self.bucket_len, method)
        # the runner reads the id back to label every call the row rides
        r.plan.request_id = r.request_id
        r.t_submit = time.time()
        if obs.enabled():
            obs.event("scheduler.submit", request_id=r.request_id,
                      method=method, length=length, mode="continuous",
                      planned_nfe=r.plan.nfe)
        self.queue.append(r)
        return self._rid

    @staticmethod
    def _group(r: Request) -> tuple:
        return (r.method, 0 if r.prefix is None else len(r.prefix))

    def _runner(self, group: tuple) -> StepwiseRunner:
        if group not in self._runners:
            method, prefix_len = group
            self._runners[group] = self.engine.stepwise(
                self.max_batch, self.bucket_len, method,
                prefix_len=prefix_len)
        return self._runners[group]

    def _admit(self, group: tuple) -> None:
        """Move queued requests of ``group`` into its free rows, FIFO."""
        runner = self._runner(group)
        free = runner.free_rows()
        if not free:
            return
        midflight = bool(runner.active_rows())
        take: list[Request] = []
        rest: list[Request] = []
        for r in self.queue:
            if self._group(r) == group and len(take) < len(free):
                take.append(r)
            else:
                rest.append(r)
        self.queue = rest
        placed = list(zip(free, take))
        runner.admit_many(
            [(row, r.plan) for row, r in placed],
            [r.prefix for _, r in placed] if group[1] else None)
        t_admit = time.time()
        for row, r in placed:
            self._row_req[(group, row)] = r
            r.t_admit = t_admit
            if obs.enabled():
                obs.histogram("scheduler.queue_latency_seconds").observe(
                    r.t_admit - r.t_submit, mode="continuous")
                obs.event("scheduler.admit", request_id=r.request_id,
                          method=r.method, mode="continuous", row=row,
                          midflight=midflight,
                          queue_s=r.t_admit - r.t_submit)
                if midflight:
                    obs.counter("scheduler.admissions_midflight").inc(
                        method=r.method)

    def _next_group(self) -> tuple | None:
        """The next group with work (live rows or queued requests),
        round-robin from the cursor; new groups join the rotation in
        first-arrival order."""
        for r in self.queue:
            g = self._group(r)
            if g not in self._rotation:
                self._rotation.append(g)
        n = len(self._rotation)
        for off in range(n):
            g = self._rotation[(self._rr + off) % n]
            runner = self._runners.get(g)
            if ((runner is not None and runner.active_rows())
                    or any(self._group(r) == g for r in self.queue)):
                self._rr = (self._rr + off + 1) % n
                return g
        return None

    def pump(self) -> bool:
        """Serve ONE group: admit what fits, make one batched call.

        Returns True while work remains (queued or in flight).  Drive it
        from a serving loop interleaved with ``submit()``; :meth:`run`
        pumps to completion.
        """
        group = self._next_group()
        if group is None:
            return False
        with obs.span("scheduler.pump", method=group[0],
                      prefix_len=group[1]) as sp:
            self._admit(group)
            runner = self._runner(group)
            if obs.enabled():
                obs.gauge("scheduler.queue_depth").set(len(self.queue))
                obs.histogram("scheduler.occupancy").observe(
                    len(runner.active_rows()) / runner.rows,
                    method=group[0])
                sp.set(queue_depth=len(self.queue),
                       live_rows=len(runner.active_rows()))
            finished = runner.step()
            self.total_calls += 1
            t_done = time.time()
            for row, toks in finished.items():
                r = self._row_req.pop((group, row))
                r.result = toks[: r.length]
                r.nfe = r.plan.nfe
                r.steps_executed = r.plan.steps_executed
                r.steps_skipped = r.plan.steps_skipped
                r.t_done = t_done
                if obs.enabled():
                    obs.counter("scheduler.steps_skipped").inc(
                        r.steps_skipped, method=r.method)
                    obs.counter("scheduler.requests").inc(method=r.method)
                    obs.histogram("scheduler.service_seconds").observe(
                        t_done - r.t_admit, mode="continuous")
                    obs.event("scheduler.complete",
                              request_id=r.request_id, method=r.method,
                              mode="continuous", nfe=r.nfe,
                              steps_skipped=r.steps_skipped,
                              service_s=t_done - r.t_admit)
                    slo_lib.observe_request(
                        r.method, latency_s=t_done - r.t_admit,
                        queue_s=r.t_admit - r.t_submit, nfe=r.nfe)
                self.done[r.rid] = r
        return bool(self.queue or self._row_req)

    def run(self) -> dict[int, Request]:
        """Pump to completion; returns completed requests by id."""
        while self.pump():
            pass
        return self.done
