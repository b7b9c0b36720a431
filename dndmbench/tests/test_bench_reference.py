"""The plain reference against the port at tiny sizes on the CPU: the
forward of each block kind, the transition law, the schedulers' seeds,
and the SSD scan against its recurrence."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dndmbench import harness, weights
from dndmbench.reference import model as ref_model
from dndmbench.reference import sampler
from dndmbench.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("doc", [tiny.TEXT8, tiny.ZAMBA2],
                         ids=["text8", "zamba2"])
def test_reference_forward_matches_port(doc):
    """Attention, Mamba-2 with its scan, the shared block, MLP, norms,
    time embedding and head: the port's logits on the reference's
    weights within float32 rounding."""
    mix = tiny.serve_mix()
    engine = harness.build_program(doc, mix, 5, CPU)
    tree = weights.make(doc["model"], 5, CPU)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, doc["model"]["vocab_size"], (3, 32), generator=g,
                      dtype=torch.int32)
    t = torch.tensor([0.05, 0.5, 1.0])
    with torch.inference_mode():
        got = engine.denoise_fn(x, t, None)
    want = ref_model.forward(tree, doc["model"], x, t)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_weights_are_the_seeds():
    a = weights.make(tiny.ZAMBA2["model"], 9, CPU)
    b = weights.make(tiny.ZAMBA2["model"], 9, CPU)
    c = weights.make(tiny.ZAMBA2["model"], 10, CPU)
    assert torch.equal(a["unit"]["b0"]["mixer"]["in_proj"],
                       b["unit"]["b0"]["mixer"]["in_proj"])
    assert not torch.equal(a["head"], c["head"])
    A = -torch.exp(a["unit"]["b1"]["mixer"]["A_log"])
    assert bool(((A <= -1.0) & (A >= -16.0)).all())
    dt = torch.nn.functional.softplus(a["unit"]["b1"]["mixer"]["dt_bias"])
    assert bool(((dt > 0.99e-3) & (dt < 0.101)).all())


@pytest.mark.parametrize("T", [50, 1000])
def test_transition_law_is_the_ports(T):
    from repro_torch.core import schedules, transition
    want = transition.from_schedule(schedules.linear(T)).probs
    assert np.array_equal(sampler.linear_transition_probs(T), want)


def test_scheduler_seeds_are_the_ports():
    from repro_torch.serving.scheduler import ContinuousScheduler
    engine = harness.build_program(tiny.TEXT8, tiny.serve_mix(), 5, CPU)
    s = ContinuousScheduler(engine, max_batch=2, bucket_len=8, seed=77,
                            device=CPU)
    rids = [s.submit(8) for _ in range(5)]
    got = [r.seed for r in s.queue if r.rid in rids]
    assert got == sampler.scheduler_seeds(77, 5)


def test_ssd_quadratic_form_is_the_recurrence():
    """The reference's quadratic SSD against the sequential recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ, y_t = C_t h_t."""
    g = torch.Generator().manual_seed(3)
    B, S, H, P, N = 2, 13, 5, 3, 4
    x = torch.randn(B, S, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(B, S, H, generator=g, dtype=torch.float64) * 0.3
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 4 - 0.5
    Bm = torch.randn(B, S, N, generator=g, dtype=torch.float64)
    Cm = torch.randn(B, S, N, generator=g, dtype=torch.float64)
    got = ref_model.ssd(x, dt, A, Bm, Cm, heads_per_block=2)
    h = torch.zeros(B, H, N, P, dtype=torch.float64)
    want = torch.empty_like(x)
    for s in range(S):
        h = h * torch.exp(dt[:, s] * A)[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhnp", dt[:, s], Bm[:, s], x[:, s])
        want[:, s] = torch.einsum("bn,bhnp->bhp", Cm[:, s], h)
    assert torch.allclose(got, want, atol=1e-10)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    r = ref_model.round_tf32(x)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11
    with ref_model.precision("tf32", CPU):
        low = ref_model.mm(x[None], x[:, None])
    assert float(low) != float(x @ x)
