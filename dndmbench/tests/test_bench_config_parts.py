"""A configuration file names its own reference, work count and port
config, so that an architecture joins the benchmark as new files: a
copy of the benchmark with a "moe" configuration, its reference and its
work module added, and no file that was there edited, builds the
program, runs, judges and reads ``call_mfu`` through them.  Where a
file names none, the defaults are the old code: the same weights, bit
for bit, and the same readings."""
from __future__ import annotations

import json
import shutil
import time

import pytest
import torch
from repro_torch.models import convert

from dndmbench import harness, readers, weights
from dndmbench.reference import model as ref_model
from dndmbench.reference import sampler
from dndmbench.tests import tiny
from dndmbench.work import call

CPU = torch.device("cpu")
SEED = 2 ** 33 + 29
REF, WORK, CONFIG, CELL = ("moe_top2_ref", "moe_top2_work", "moe-top2-tiny",
                           "moe-top2-batch")

# the port's "moe" block (attention, then the mixture of experts), which
# reference/model.py does not have
REFERENCE = '''"""Plain forward of the port's "moe" block: x + attn(norm(x)), then
x + moe(norm(x)), where moe routes each token to its top K experts by the
router's softmax (ties to the lower expert), weighs them by the gates
renormalised over the K, and runs every SwiGLU expert on every token."""
import math

import torch

from dndmbench.reference.model import (_slot, attention, expand, mlp, mm,
                                       precision, rmsnorm, time_embed)

__all__ = ["expand", "param_shapes", "forward", "precision", "leaf_rule"]


def param_shapes(c):
    c = expand(c)
    d, V, hd = c["d_model"], c["vocab_size"], c["head_dim"]
    H, KV, ff, E = c["n_heads"], c["n_kv_heads"], c["d_ff"], c["n_experts"]
    out = {"embed": (V, d), "ln_f/scale": (d,), "head": (d, V),
           "time/w1": (d, d), "time/w2": (d, d)}
    leaves = {"ln1/scale": (d,), "attn/wq": (d, H * hd),
              "attn/wk": (d, KV * hd), "attn/wv": (d, KV * hd),
              "attn/wo": (H * hd, d), "ln2/scale": (d,),
              "moe/router": (d, E), "moe/gate": (E, d, ff),
              "moe/up": (E, d, ff), "moe/down": (E, ff, d)}
    for i, kind in enumerate(c["block_unit"]):
        if kind != "moe":
            raise ValueError(f"this reference has no block kind {kind!r}")
        out.update({f"unit/b{i}/{k}": (c["n_super"],) + v
                    for k, v in leaves.items()})
    return out


def leaf_rule(path, shape, c):
    """An expert's down projection joins the residual stream."""
    if path.endswith("moe/down"):
        return "normal", 1.0 / math.sqrt(shape[-2]) / math.sqrt(
            c["n_layers"]), 0.0
    return None


def moe(w, h, c):
    probs = torch.softmax(mm(h, w["router"]), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = c["experts_per_token"]
    gates = top_p[..., :K] / top_p[..., :K].sum(-1, keepdim=True)
    share = torch.zeros_like(probs).scatter(-1, top_e[..., :K], gates)
    y = torch.zeros_like(h)
    for e in range(c["n_experts"]):
        expert = {k: w[k][e] for k in ("gate", "up", "down")}
        y = y + share[..., e:e + 1] * mlp(expert, h, c)
    return y


def forward(tree, c, tokens, t):
    c = expand(c)
    unit = c["block_unit"]
    h = tree["embed"][tokens.long()]
    if c["time_conditioning"]:
        h = h + time_embed(tree["time"], t, c["d_model"])[:, None]
    for i in range(len(c["block_pattern"])):
        j, slot = divmod(i, len(unit))
        p = _slot(tree["unit"][f"b{slot}"], j)
        h = h + attention(p["attn"], rmsnorm(h, p["ln1"]["scale"],
                                             c["norm_eps"]), c)
        h = h + moe(p["moe"], rmsnorm(h, p["ln2"]["scale"], c["norm_eps"]),
                    c)
    h = rmsnorm(h, tree["ln_f"]["scale"], c["norm_eps"])
    return mm(h, tree["head"])
'''

WORK_MODULE = '''"""Operations of one network call of a "moe" denoiser: 2 per weight
element per token for attention's projections, the router and the K
experts a token is routed to; attention's own products; the head; the
time MLP once per row."""
from dndmbench.work import flash_attention


def flops(c, rows, N):
    d, hd, ff = c["d_model"], c["head_dim"], c["d_ff"]
    H, KV = c["n_heads"], c["n_kv_heads"]
    layer = (d * hd * (2 * H + 2 * KV) + d * c["n_experts"]
             + c["experts_per_token"] * 3 * d * ff)
    L = len(c["block_pattern"])
    return (2 * (L * layer + d * c["vocab_size"]) * rows * N
            + 2 * 2 * d * d * rows
            + L * flash_attention.flops(rows, N, H, hd))
'''

# four experts, top 2: capacity_factor 2 gives every expert room for every
# token, so the port drops no assignment
MODEL = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
    mlp_type="swiglu", vocab_size=28, block_unit=["moe"], n_super=2,
    n_experts=4, experts_per_token=2, capacity_factor=2.0, sliding_window=0,
    rope_theta=10000.0, norm_eps=1e-5, bidirectional=True,
    time_conditioning=True, tie_embeddings=False, attn_impl="pallas",
    dtype="float32")

DOC = {"name": CONFIG, "reference": REF, "work": WORK,
       "config_factory": "repro_torch.configs.mixtral_8x7b:get_config",
       "source": "https://arxiv.org/abs/2401.04088", "model": MODEL,
       "reduced": []}


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def added(tmp_path):
    """A copy of the benchmark with the three new files, and its spec."""
    bench = tmp_path / "dndmbench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "reference" / f"{REF}.py").write_text(REFERENCE)
    (bench / "work" / f"{WORK}.py").write_text(WORK_MODULE)
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(DOC))
    spec = json.loads(json.dumps(harness.load_spec()))
    spec["configs"].append({"name": CONFIG, "source": DOC["source"],
                            "file": f"dndmbench/configs/{CONFIG}.json",
                            "reduced": [], "why": "a tiny MoE"})
    spec["workloads"].append({"name": CELL, "config": CONFIG,
                              "traffic": "closed-4x256-t50", "chips": 1,
                              "why": "a tiny MoE in batches"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "zamba2-batch" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return tmp_path, bench, spec


def test_the_new_architecture_is_new_files_only(added):
    root, bench, spec = added
    before, after = _files(harness.BENCH), _files(bench)
    assert {k: after[k] for k in before} == before
    assert sorted(str(k) for k in set(after) - set(before)) == sorted([
        f"configs/{CONFIG}.json", f"reference/{REF}.py", f"work/{WORK}.py"])
    # nothing the harness runs knows the new modules by name
    for path, text in before.items():
        if path.parts[0] != "tests":
            assert REF.encode() not in text and WORK.encode() not in text, \
                path
    doc = harness.config_doc(spec, CONFIG, root)
    p = harness.parts(doc, bench)
    assert p.reference.__file__ == str(bench / "reference" / f"{REF}.py")
    assert p.work.__file__ == str(bench / "work" / f"{WORK}.py")
    assert p.config.name == "mixtral-8x7b"
    assert (p.config.n_experts, p.config.block_pattern) == (4, ("moe", "moe"))
    with pytest.raises(ModuleNotFoundError):
        harness.parts(doc)
    with pytest.raises(ValueError, match="no block kind"):
        ref_model.param_shapes(MODEL)


def test_the_program_matches_the_named_reference(added):
    """Every parameter of the port's "moe" blocks is drawn (the loader
    takes only an exact match), and the port's logits on those weights
    are the named reference's within float32 rounding."""
    root, bench, spec = added
    doc = harness.config_doc(spec, CONFIG, root)
    p = harness.parts(doc, bench)
    engine = harness.build_program(doc, tiny.batch_mix(), 5, CPU, p)
    tree = weights.make(MODEL, 5, CPU, p.reference)
    down = tree["unit"]["b0"]["moe"]["down"]
    assert float(down.std()) == pytest.approx((64 * 2) ** -0.5, rel=0.1)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, MODEL["vocab_size"], (3, 32), generator=g,
                      dtype=torch.int32)
    t = torch.tensor([0.05, 0.5, 1.0])
    with torch.inference_mode():
        got = engine.denoise_fn(x, t, None)
    want = p.reference.forward(tree, MODEL, x, t)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_a_run_judges_through_the_named_parts(added):
    root, bench, spec = added
    doc = harness.config_doc(spec, CONFIG, root)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = harness.run_cell(spec, CELL, doc, tiny.batch_mix(), SEED, 3.0,
                             False, "cpu", time.perf_counter(), bench)
    finally:
        torch.set_num_threads(threads)
    assert set(r["checks"]) == {
        "logit_err", "logit_calls_short", "widest_gap", "tokens_checked_short",
        "nfe_wrong", "mask_left", "failed", "seed_wrong", "nfe_split",
        "done_twice"}
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "tokens_per_s"}


def test_call_mfu_reads_the_named_work_module(added):
    root, bench, spec = added
    doc = harness.config_doc(spec, CONFIG, root)
    p = harness.parts(doc, bench)
    mix = tiny.batch_mix()
    c = p.reference.expand(MODEL)
    ctx = harness.Context(CELL, c, mix, CPU, p.work, window_s=2.0, calls=40)
    want = 100 * p.work.flops(c, 1, mix["N"]) * mix["rows"] * 40 / 2.0 / 495e12
    assert readers.call_mfu(ctx) == pytest.approx(want, rel=1e-12)
    assert harness.metric_reader("call_mfu.batch", bench).read(ctx) == \
        readers.call_mfu(ctx)
    with pytest.raises(ValueError, match="no work count"):
        call.flops(c, 1, mix["N"])


@pytest.mark.parametrize("doc", [tiny.TEXT8, tiny.ZAMBA2],
                         ids=["text8", "zamba2"])
def test_the_default_parts_draw_the_old_weights(doc):
    """A file that names no reference draws with ``reference.model``:
    the same leaves, in the same order, bit for bit."""
    p = harness.parts(doc)
    assert (p.reference, p.work) == (ref_model, call)
    named = weights.make(doc["model"], 9, CPU, p.reference)
    old = weights.make(doc["model"], 9, CPU, ref_model)
    default = weights.make(doc["model"], 9, CPU)
    flat = [convert.flatten(t) for t in (named, old, default)]
    assert list(flat[0]) == list(flat[1]) == list(flat[2])
    for k in flat[1]:
        assert torch.equal(flat[0][k], flat[1][k]), k
        assert torch.equal(flat[2][k], flat[1][k]), k


@pytest.mark.parametrize("doc", [tiny.TEXT8, tiny.ZAMBA2],
                         ids=["text8", "zamba2"])
def test_the_default_reference_reads_alike(doc):
    """The check and the logits check, with the control, read the same
    through the resolved reference as through ``reference.model``
    named explicitly, and as with no reference passed."""
    c = doc["model"]
    tree = weights.make(c, 11, CPU)
    g = torch.Generator().manual_seed(4)
    trajs = [sampler.Trajectory(
        s, torch.randint(0, c["vocab_size"] - 1, (2, 16), generator=g)
        .numpy(), 3) for s in (7, 8)]
    x = torch.randint(0, c["vocab_size"], (2, 16), generator=g)
    kept = [(x, torch.tensor([0.25, 0.75]),
             torch.randn(2, 16, c["vocab_size"], generator=g), None)]
    readings = []
    for ref in (None, harness.parts(doc).reference, ref_model):
        kw = {} if ref is None else {"reference": ref}
        r = sampler.check_logits(kept, tree, c, device=CPU, control=True,
                                 **kw)
        readings.append(sampler.check(trajs, tree, c, T=10, shared=True,
                                      device=CPU, block_rows=4, control=True,
                                      readings=r, **kw))
    assert readings[0] == readings[1] == readings[2]
    assert readings[0].tokens == 64 and readings[0].control_logit_err > 0
