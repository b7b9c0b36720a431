"""``BENCHMARK.json`` resolves by name: every cell to its configuration
and traffic files, every metric to its reader, whose declarations agree
with the entry; and a file added with its entry is picked up without an
edit to any file that is there."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from dndmbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_shape_of_the_file():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "dndmbench/run.py"]
    assert SPEC["paths"] == ["dndmbench"]
    R = SPEC["run_seconds"]
    assert 1 <= R <= 51
    assert (2 + 14 * 24) * (R + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"]
             + METRICS]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in METRICS)


def test_configs_resolve():
    for c in SPEC["configs"]:
        assert c["file"].startswith("dndmbench/configs/")
        doc = harness.config_doc(SPEC, c["name"])
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
        # its reference, its work count and the port's config
        p = harness.parts(doc)
        for fn in ("expand", "param_shapes", "forward", "precision"):
            assert callable(getattr(p.reference, fn)), fn
        widths = p.reference.expand(doc["model"])
        assert p.config.block_pattern == tuple(widths["block_pattern"])
        assert p.config.n_layers == doc["model"]["n_layers"]
        assert p.work.flops(widths, 1, 8) > 0


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_and_reports_enough(cell):
    w = harness.cell_entry(SPEC, cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    harness.config_doc(SPEC, w["config"])
    mix = harness.traffic_doc(w["traffic"])
    assert mix["loop"] in ("open", "closed")
    e2e = [m["name"] for m in harness.metric_entries(SPEC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = harness.metric_entries(SPEC, cell, True)
    assert per and all(m["moves"] in e2e for m in per)


@pytest.mark.parametrize("entry", METRICS, ids=lambda m: m["name"])
def test_metric_reader_agrees_with_its_entry(entry):
    mod = harness.metric_reader(entry["name"])
    assert mod.UNIT == entry["unit"] and mod.SOURCE == entry["source"]
    if "layer" in entry:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
        assert mod.WORKLOADS == entry["workloads"]
        assert "\n" not in entry["layer"] and len(entry["layer"]) <= 200
    else:
        assert entry["source"] in ("host_clock", "device_trace")
        limit = 0.25
        assert 0.01 <= entry["bound"] <= limit
        assert sorted(mod.WORKLOADS) == sorted(entry.get("workloads",
                                                         CELLS))
    if entry["unit"] == "%":
        assert any(k in entry["name"] for k in ("_roofline", "mfu",
                                                "_share"))


def test_an_added_mix_and_metric_are_picked_up(tmp_path):
    bench = tmp_path / "dndmbench"
    shutil.copytree(harness.BENCH / "metrics", bench / "metrics")
    shutil.copytree(harness.BENCH / "traffic", bench / "traffic")
    (bench / "metrics" / "extra_count.py").write_text(
        'LAYER = "scheduler (serving/scheduler.py)"\nUNIT = "calls"\n'
        'MOVES = "tokens_per_s"\nSOURCE = "program_counter"\n'
        'WORKLOADS = ["text8-batch-64"]\n\n\ndef read(ctx):\n'
        '    return float(ctx.calls)\n')
    mix = harness.traffic_doc("closed-32x256-t1000")
    (bench / "traffic" / "closed-64x256-t1000.json").write_text(
        json.dumps(dict(mix, rows=64)))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "text8-batch-64",
                              "config": "dndm-text8",
                              "traffic": "closed-64x256-t1000", "chips": 1,
                              "why": "twice the rows"})
    spec["end_to_end"][1]["workloads"].append("text8-batch-64")
    spec["per_layer"].append({"name": "extra_count", "unit": "calls",
                              "better": "lower", "source": "program_counter",
                              "layer": "scheduler (serving/scheduler.py)",
                              "moves": "tokens_per_s",
                              "workloads": ["text8-batch-64"]})
    cell = harness.cell_entry(spec, "text8-batch-64")
    assert harness.traffic_doc(cell["traffic"], bench)["rows"] == 64
    names = [m["name"] for m in harness.metric_entries(spec,
                                                       "text8-batch-64",
                                                       True)]
    assert "extra_count" in names
    ctx = harness.Context("text8-batch-64", {}, mix, None, calls=7)
    assert harness.metric_reader("extra_count", bench).read(ctx) == 7.0
