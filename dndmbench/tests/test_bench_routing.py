"""A routed configuration is judged with the program's expert choices
forced into the reference, and the choice is held apart by
``routing_shortfall``: a tie between two experts, which the program may
break either way, passes; a choice swapped for a worse one fails; the
control still fails.  A configuration without routed layers is judged as
before."""
from __future__ import annotations

import contextlib
import json
import math
import shutil
import time

import pytest
import torch
from repro_torch.models import convert

from dndmbench import faults, harness, routes, weights
from dndmbench.reference import model as ref_model
from dndmbench.reference import routing, sampler
from dndmbench.tests import routed_moe, tiny

CPU = torch.device("cpu")
SEED = 2 ** 33 + 41
REF, CONFIG, CELL = "moe_routed", "moe-routed-tiny", "moe-routed-batch"

# four experts, top 2: capacity_factor 2 gives every expert room for every
# token, so the port drops no assignment
MODEL = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
    mlp_type="swiglu", vocab_size=28, block_unit=["moe"], n_super=2,
    n_experts=4, experts_per_token=2, capacity_factor=2.0, sliding_window=0,
    rope_theta=10000.0, norm_eps=1e-5, bidirectional=True,
    time_conditioning=True, tie_embeddings=False, attn_impl="pallas",
    dtype="float32")

DOC = {"name": CONFIG, "reference": REF,
       "config_factory": "repro_torch.configs.mixtral_8x7b:get_config",
       "source": "https://arxiv.org/abs/2401.04088", "model": MODEL,
       "reduced": []}


def routed_mix() -> dict:
    mix = tiny.batch_mix()
    mix["limits"] = dict(mix["limits"], routing_shortfall=1e-5)
    return mix


@pytest.fixture
def routed(tmp_path):
    """A copy of the benchmark with the routed reference and its
    configuration; the spec with its cell; the resolved parts."""
    bench = tmp_path / "dndmbench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(routed_moe.__file__, bench / "reference" / f"{REF}.py")
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(DOC))
    spec = json.loads(json.dumps(harness.load_spec()))
    spec["configs"].append({"name": CONFIG, "source": DOC["source"],
                            "file": f"dndmbench/configs/{CONFIG}.json",
                            "reduced": [], "why": "a tiny routed MoE"})
    spec["workloads"].append({"name": CELL, "config": CONFIG,
                              "traffic": "closed-4x256-t50", "chips": 1,
                              "why": "a tiny routed MoE in batches"})
    spec["end_to_end"][1]["workloads"].append(CELL)
    doc = harness.config_doc(spec, CONFIG, tmp_path)
    return spec, bench, doc, harness.parts(doc, bench)


def run(spec, bench, doc, mix=None, seed=SEED):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(spec, CELL, doc, mix or routed_mix(), seed,
                                3.0, False, "cpu", time.perf_counter(),
                                bench)
    finally:
        torch.set_num_threads(threads)


def higher_first(x, K, **kw):
    """A descending sort that breaks ties to the higher expert."""
    E = x.shape[-1]
    v, i = torch.sort(x.flip(-1), **kw)
    return v, E - 1 - i


def test_the_shortfall_reads_the_choice():
    select = torch.tensor([[0.5, 0.3, 0.2, 0.0]])
    assert routing.shortfall(select, torch.tensor([[0, 1]]), 2) == 0.0
    assert routing.shortfall(select, torch.tensor([[1, 0]]), 2) == 0.0
    assert routing.shortfall(select, torch.tensor([[0, 2]]), 2) == \
        pytest.approx(0.1)
    assert routing.shortfall(select, torch.tensor([[3, 0]]), 2) == \
        pytest.approx(0.3)
    for bad in ([[0, 0]], [[0, 4]], [[-1, 0]]):
        assert routing.shortfall(select, torch.tensor(bad), 2) == math.inf
    assert routing.top_k(torch.tensor([[0.2, 0.4, 0.4, 0.1]]), 2).tolist() \
        == [[1, 2]]
    r = routing.Route([torch.tensor([[[0, 1]]])])
    r.pick(select[None], 2)
    assert r.finish() == 0.0
    r.pick(select[None], 2)
    assert r.finish() == math.inf


def test_a_planted_tie_is_forced(routed, monkeypatch):
    """Experts 0 and 1 share their router column and differ in their
    weights; the program breaks the tie to the higher expert, the
    reference to the lower.  Unforced, the logits part far beyond the
    limit; forced, they agree to rounding and nothing falls short."""
    spec, bench, doc, p = routed
    engine = harness.build_program(doc, routed_mix(), 5, CPU, p)
    tree = weights.make(MODEL, 5, CPU, p.reference)
    router = tree["unit"]["b0"]["moe"]["router"]
    router[..., 1] = router[..., 0]
    convert.load_params(engine.model, tree)
    faults.router_sort(monkeypatch.setattr, higher_first)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, MODEL["vocab_size"], (3, 32), generator=g,
                      dtype=torch.int32)
    t = torch.tensor([0.05, 0.5, 1.0])
    with routes.recording() as rec, torch.inference_mode():
        rec.on = True
        logits = engine.denoise_fn(x, t, None)
        layers = rec.take(*x.shape)
    assert len(layers) == 2 and layers[0].shape == (3, 32, 2)
    own = routing.top_k(torch.zeros(1, 4), 2)
    assert own.tolist() == [[0, 1]]
    # the program took expert 1 over 0 where the tie decided
    took_1 = (layers[0] == 1).any(-1) & ~(layers[0] == 0).any(-1)
    assert bool(took_1.any())
    limit = routed_mix()["limits"]["logit_err"]
    unforced = float((logits - p.reference.forward(tree, MODEL, x, t))
                     .abs().max())
    assert unforced > 100 * limit
    r = sampler.check_logits([(x, t, logits, layers)], tree, MODEL,
                             device=CPU, reference=p.reference)
    assert r.logit_err < 1e-5 * float(logits.abs().max())
    assert r.routing_shortfall == 0.0


def test_a_sound_routed_run_is_correct(routed):
    spec, bench, doc, p = routed
    r = run(spec, bench, doc)
    assert list(r["checks"]) == [
        "logit_err", "logit_calls_short", "widest_gap", "routing_shortfall",
        "tokens_checked_short", "nfe_wrong", "mask_left", "failed",
        "seed_wrong", "nfe_split", "done_twice"]
    assert r["correct"], r["checks"]
    assert r["checks"]["routing_shortfall"]["value"] == 0.0


def test_a_swapped_expert_fails_the_shortfall(routed, monkeypatch):
    """The first token of every routed layer goes to its third expert
    in place of its second: under forcing the logits still agree, and
    the choice fails."""
    spec, bench, doc, p = routed
    faults.routing_swapped(monkeypatch.setattr)
    c = run(spec, bench, doc)["checks"]
    assert c["routing_shortfall"]["value"] > c["routing_shortfall"]["limit"]
    assert c["logit_err"]["value"] <= c["logit_err"]["limit"], c
    assert c["widest_gap"]["value"] <= c["widest_gap"]["limit"], c


def test_the_routed_control_is_not_correct(routed, monkeypatch):
    spec, bench, doc, p = routed
    monkeypatch.setattr(harness, "parts", lambda d, b=bench: p)
    faults.control(monkeypatch.setattr, doc, SEED, CPU)
    r = run(spec, bench, doc)
    assert not r["correct"], r["checks"]
    c = r["checks"]["logit_err"]
    assert c["value"] > c["limit"], c
    assert r["checks"]["routing_shortfall"]["value"] < math.inf


def test_a_routed_configuration_needs_a_closed_loop(routed):
    spec, bench, doc, p = routed
    with pytest.raises(ValueError, match="closed-loop"):
        run(spec, bench, doc, tiny.serve_mix())


def test_nothing_is_recorded_without_routed_layers():
    """A recording left on through a denoiser without routed layers
    records nothing, and a plain configuration opens no recording."""
    engine = harness.build_program(tiny.TEXT8, tiny.batch_mix(), 5, CPU)
    x = torch.zeros(2, 16, dtype=torch.int32)
    with routes.recording() as rec, torch.inference_mode():
        rec.on = True
        engine.denoise_fn(x, torch.tensor([0.5, 0.5]), None)
        assert rec.take(*x.shape) == []
    assert isinstance(harness.routing_for(ref_model, tiny.batch_mix()),
                      contextlib.nullcontext)


# the checks on the inputs below before routing was forced, (value,
# limit) (the kept call was then (x, t, logits))
BEFORE = {
    name: {"logit_err": (err, 5e-4), "logit_calls_short": (0, 0),
           "widest_gap": (gap, 1e-3), "tokens_checked_short": (0, 0),
           "nfe_wrong": (2, 0), "mask_left": (3, 0), "failed": (0, 0),
           "seed_wrong": (0, 0), "nfe_split": (1, 0), "done_twice": (0, 0)}
    for name, err, gap in (("text8", 0.4999999403953552, 7.958929538726807),
                           ("zamba2", 0.5, 9.899299621582031))}


@pytest.mark.parametrize("doc", [tiny.TEXT8, tiny.ZAMBA2],
                         ids=["text8", "zamba2"])
def test_a_plain_configuration_is_judged_as_before(doc, request):
    """``judge`` gives a configuration without routed layers the same
    checks, in the same order, with the same values, as before routing
    was forced: a logit off by 0.5, served tokens drawn at random (a
    wide gap), wrong NFE, [MASK] left in a trajectory not replayed."""
    c = doc["model"]
    mix = tiny.batch_mix()
    tree = weights.make(c, 11, CPU)
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, c["vocab_size"], (2, 16), generator=g)
    t = torch.tensor([0.25, 0.75])
    logits = ref_model.forward(tree, c, x, t)
    logits[0, 3, 5] += 0.5
    trajs = [sampler.Trajectory(
        s, torch.randint(0, c["vocab_size"] - 1, (2, 16), generator=g)
        .numpy(), 3) for s in (7, 8)]
    trajs[1].tokens[1, :3] = c["vocab_size"] - 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        checks = harness.judge(mix, doc, 11, CPU, trajs[:1], trajs,
                               {"seed_wrong": 0, "nfe_split": 1,
                                "done_twice": 0}, 0,
                               [(x, t, logits, None)], ref_model)
    finally:
        torch.set_num_threads(threads)
    want = BEFORE[request.node.callspec.id]
    assert list(checks) == list(want)
    for k, (value, limit) in checks.items():
        assert limit == want[k][1], k
        assert value == pytest.approx(want[k][0], rel=1e-5), k
