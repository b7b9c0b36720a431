"""``BENCHMARK.json`` resolves by name: every cell to its configuration
and traffic files, every metric to its reader, whose declarations agree
with the entry; and a file added with its entry is picked up without an
edit to any file that is there."""
from __future__ import annotations

import json
import re
import shutil
import time

import pytest
import torch

from dndmbench import harness
from dndmbench.tests import tiny

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def check_shape(spec: dict) -> None:
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "dndmbench/run.py"]
    assert spec["paths"] == ["dndmbench"]
    R = spec["run_seconds"]
    assert 1 <= R <= 51
    assert (2 + 14 * 24) * (R + 60) + 24 * 180 + 1200 <= 43200
    metrics = spec["end_to_end"] + spec["per_layer"]
    cells = [w["name"] for w in spec["workloads"]]
    names = [x["name"] for x in spec["configs"] + spec["workloads"]
             + metrics]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(cells)) == len(cells)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)


def check_configs(spec: dict, root=harness.ROOT, bench=harness.BENCH):
    for c in spec["configs"]:
        assert c["file"].startswith("dndmbench/configs/")
        doc = harness.config_doc(spec, c["name"], root)
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in spec["workloads"])
        # its reference, its work count and the port's config
        p = harness.parts(doc, bench)
        for fn in ("expand", "param_shapes", "forward", "precision"):
            assert callable(getattr(p.reference, fn)), fn
        widths = p.reference.expand(doc["model"])
        assert p.config.block_pattern == tuple(widths["block_pattern"])
        assert p.config.n_layers == doc["model"]["n_layers"]
        assert p.work.flops(widths, 1, 8) > 0


def check_cell(spec: dict, cell: str, root=harness.ROOT,
               bench=harness.BENCH) -> None:
    w = harness.cell_entry(spec, cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    harness.config_doc(spec, w["config"], root)
    mix = harness.traffic_doc(w["traffic"], bench)
    assert mix["loop"] in ("open", "closed")
    e2e = [m["name"] for m in harness.metric_entries(spec, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = harness.metric_entries(spec, cell, True)
    assert per and all(m["moves"] in e2e for m in per)


def check_metric(spec: dict, entry: dict, bench=harness.BENCH) -> None:
    """The reader declares the entry's unit, source, layer and the metric
    it moves; the entry's cells (``BENCHMARK.json``'s list is the only
    one) are the spec's."""
    mod = harness.metric_reader(entry["name"], bench)
    assert mod.UNIT == entry["unit"] and mod.SOURCE == entry["source"]
    assert set(entry.get("workloads", [])) <= {
        w["name"] for w in spec["workloads"]}
    if "layer" in entry:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
        assert entry["workloads"]
        assert "\n" not in entry["layer"] and len(entry["layer"]) <= 200
    else:
        assert entry["source"] in ("host_clock", "device_trace")
        limit = 0.25
        assert 0.01 <= entry["bound"] <= limit
    if entry["unit"] == "%":
        assert any(k in entry["name"] for k in ("_roofline", "mfu",
                                                "_share"))


def check_all(spec: dict, root=harness.ROOT, bench=harness.BENCH) -> None:
    """Every discovery check of this file, on ``spec``."""
    check_shape(spec)
    check_configs(spec, root, bench)
    for w in spec["workloads"]:
        check_cell(spec, w["name"], root, bench)
    for m in spec["end_to_end"] + spec["per_layer"]:
        check_metric(spec, m, bench)


def test_shape_of_the_file():
    check_shape(SPEC)


def test_configs_resolve():
    check_configs(SPEC)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_and_reports_enough(cell):
    check_cell(SPEC, cell)


@pytest.mark.parametrize("entry", METRICS, ids=lambda m: m["name"])
def test_metric_reader_agrees_with_its_entry(entry):
    check_metric(SPEC, entry)


def test_an_added_mix_and_metric_are_picked_up(tmp_path):
    bench = tmp_path / "dndmbench"
    shutil.copytree(harness.BENCH / "metrics", bench / "metrics")
    shutil.copytree(harness.BENCH / "traffic", bench / "traffic")
    (bench / "metrics" / "extra_count.py").write_text(
        'LAYER = "scheduler (serving/scheduler.py)"\nUNIT = "calls"\n'
        'MOVES = "tokens_per_s"\nSOURCE = "program_counter"\n\n\n'
        'def read(ctx):\n'
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


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_joins_by_entries_alone(tmp_path):
    """A tiny configuration, its mix and a per-layer metric's reader,
    added to a copy of the benchmark as new files, join through entries
    appended to ``BENCHMARK.json``: every discovery check passes on that
    spec, a run reports ``setup_s``, ``tokens_per_s`` and, traced, the new
    metric, and no file that was there changed."""
    config, mix, metric, cell = ("text8-tiny", "closed-2x32-t20",
                                 "calls_per_batch", "text8-tiny-batch")
    bench = tmp_path / "dndmbench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    source = "https://arxiv.org/abs/2312.09193"
    (bench / "configs" / f"{config}.json").write_text(json.dumps(dict(
        tiny.TEXT8, name=config, source=source, reduced=[])))
    (bench / "traffic" / f"{mix}.json").write_text(
        json.dumps(tiny.batch_mix()))
    (bench / "metrics" / f"{metric}.py").write_text(
        '"""Network calls per batch of the window."""\n'
        'LAYER = "sampler (core/samplers/)"\nUNIT = "calls"\n'
        'MOVES = "tokens_per_s"\nSOURCE = "program_counter"\n\n\n'
        'def read(ctx):\n'
        '    return ctx.calls / len(ctx.batches) if ctx.batches else None\n')
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": config, "source": source,
                            "file": f"dndmbench/configs/{config}.json",
                            "reduced": [], "why": "a tiny text8 denoiser"})
    spec["workloads"].append({"name": cell, "config": config,
                              "traffic": mix, "chips": 1,
                              "why": "closed loop of 2 x 32 batches, T 20"})
    next(m for m in spec["end_to_end"]
         if m["name"] == "tokens_per_s")["workloads"].append(cell)
    spec["per_layer"].append({"name": metric, "unit": "calls",
                              "better": "lower", "source": "program_counter",
                              "layer": "sampler (core/samplers/)",
                              "moves": "tokens_per_s", "workloads": [cell]})
    check_all(spec, tmp_path, bench)
    doc = harness.config_doc(spec, config, tmp_path)
    traffic = harness.traffic_doc(mix, bench)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = [harness.run_cell(spec, cell, doc, traffic, 2 ** 33 + 5, 2.0,
                                 trace, "cpu", time.perf_counter(), bench)
                for trace in (False, True)]
    finally:
        torch.set_num_threads(threads)
    assert all(r["correct"] for r in runs), [r["checks"] for r in runs]
    assert set(runs[0]["metrics"]) == {"setup_s", "tokens_per_s"}
    assert set(runs[1]["metrics"]) == {metric}
    assert runs[1]["metrics"][metric]["value"] > 0
    before, after = _files(harness.BENCH), _files(bench)
    assert {k: after[k] for k in before} == before
    assert sorted(str(k) for k in set(after) - set(before)) == sorted([
        f"configs/{config}.json", f"traffic/{mix}.json",
        f"metrics/{metric}.py"])
