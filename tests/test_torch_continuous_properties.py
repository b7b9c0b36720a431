"""Hypothesis property test of the port's ``ContinuousScheduler``, the
counterpart of tests/test_scheduler_properties.py, on the CPU.

Random arrival orders, lengths, methods (with and without a prefix) and
pump interleavings must always give

  * exactly-once completion: every submitted id is in ``done`` once, with
    a result of its own length, and nothing is left queued or in flight;
  * the step accounting ``steps_executed + steps_skipped == T`` (``(N,
    0)`` in continuous time) and ``nfe == steps_executed``;
  * solo parity: each request's tokens are ``engine.generate(r.seed, 1,
    N, method=...)``'s.

The denoiser is integer-valued and elementwise per row, so a row's
trajectory does not depend on the batch around it and parity is exact.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.serving import ContinuousScheduler  # noqa: E402
from repro_torch.serving import EngineConfig, GenerationEngine  # noqa: E402

VOCAB, SEQ, STEPS, ROWS = 10, 8, 6, 3
METHODS = ("dndm", "dndm2", "dndm_topk", "dndm_static", "dndm_topk_static",
           "d3pm", "rdm", "rdm_k", "mask_predict", "dndm_c", "dndm_c_topk")
CONTINUOUS = ("dndm_c", "dndm_c_topk")


class _Cfg:
    vocab_size = VOCAB


class _IntModel:
    cfg = _Cfg()
    device = torch.device("cpu")

    def denoise_fn(self):
        def fn(x_t, t, cond):
            k = torch.arange(VOCAB, dtype=torch.int32)
            n = torch.arange(x_t.shape[1], dtype=torch.int32)
            tt = torch.round(t * STEPS).to(torch.int32)
            v = (x_t[..., None] * 3 + k * 7 + n[None, :, None] * 5
                 + tt[:, None, None]) % 7
            if cond is not None:
                v = v + (cond["prefix_tokens"].sum(-1) % 3)[:, None, None]
            return v.to(torch.float32)
        return fn


@pytest.fixture(scope="module")
def engine():
    return GenerationEngine(_IntModel(), EngineConfig(
        method="dndm", steps=STEPS, shared_tau=False, nfe_budget=3),
        device="cpu")


@given(
    requests=st.lists(
        st.tuples(st.integers(3, SEQ), st.sampled_from(METHODS),
                  st.sampled_from((0, 0, 2)),    # prefix length
                  st.integers(0, 2)),            # pumps after the submit
        min_size=1, max_size=7),
    seed=st.integers(0, 1_000),
)
@settings(max_examples=12, deadline=None)
def test_continuous_scheduler_invariants(engine, requests, seed):
    sched = ContinuousScheduler(engine, max_batch=ROWS, bucket_len=SEQ,
                                seed=seed, device="cpu")
    rids = []
    for i, (length, method, p_len, pumps) in enumerate(requests):
        prefix = (np.arange(i, i + p_len, dtype=np.int32) % (VOCAB - 1)
                  if p_len else None)
        rids.append(sched.submit(length, prefix=prefix, method=method))
        for _ in range(pumps):
            sched.pump()
    sched.run()

    assert sorted(sched.done) == sorted(rids)
    assert len(set(rids)) == len(rids)
    assert not sched.queue and not sched._row_req

    total_executed = 0
    for rid, (length, method, p_len, _) in zip(rids, requests):
        r = sched.done[rid]
        assert r.result is not None and r.result.shape == (length,)
        assert ((0 <= r.result) & (r.result < VOCAB)).all()
        assert r.steps_executed == len(r.plan.times)
        if method in CONTINUOUS:
            assert (r.steps_executed, r.steps_skipped) == (SEQ, 0)
        else:
            assert r.steps_executed + r.steps_skipped == STEPS
        assert r.nfe == r.steps_executed
        total_executed += r.steps_executed

        cond = (None if r.prefix is None else
                {"prefix_tokens": torch.as_tensor(r.prefix)[None]})
        solo, _ = engine.generate(r.seed, 1, SEQ, method=method, cond=cond)
        np.testing.assert_array_equal(
            solo.tokens[0, :length].numpy(), r.result,
            err_msg=f"rid {rid} ({method}) diverged from its solo replay")

    # batching only helps: a cohort's calls are the longest member's
    assert sched.total_calls <= total_executed


def test_dndm_c_tied_timestamps_match_the_solo_run(engine):
    """A DNDM-C plan whose f32 timestamps tie (scheduler seed 893: two
    tokens at 0.8226311) holds that time twice; the rolling row reveals
    one owner per call, lowest index first, as the solo sampler's stable
    sort does, so the tokens are the solo run's."""
    sched = ContinuousScheduler(engine, max_batch=ROWS, bucket_len=SEQ,
                                seed=893, device="cpu")
    rid = sched.submit(SEQ, method="dndm_c")
    sched.run()
    r = sched.done[rid]
    times = np.asarray(r.plan.times)
    assert len(np.unique(times)) < len(times)
    solo, _ = engine.generate(r.seed, 1, SEQ, method="dndm_c")
    np.testing.assert_array_equal(solo.tokens[0].numpy(), r.result)
