"""``correct`` comes out false for the control and for each fault a
serving cell can have, and true for a sound run: whole runs of the tiny
cells on the CPU, past the look for a card, with the timed path broken
underneath."""
from __future__ import annotations

import time

import pytest
import torch

from dndmbench import faults, harness
from dndmbench.tests import tiny

SPEC = harness.load_spec()
SEED = 2 ** 33 + 17
CELLS = {"serve": ("text8-serve", tiny.TEXT8, tiny.serve_mix),
         "batch": ("zamba2-batch", tiny.ZAMBA2, tiny.batch_mix)}


def run(kind: str) -> dict:
    """One run on one CPU thread (the test runner's workers share the
    cores), with a window that holds a tiny batch on a busy machine."""
    cell, doc, mix = CELLS[kind]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(SPEC, cell, doc, mix(), SEED, 3.0, False,
                                "cpu", time.perf_counter())
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("kind", CELLS)
def test_sound_run_is_correct(kind):
    r = run(kind)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("fault", [*faults.FAULTS, "control_tf32"])
@pytest.mark.parametrize("kind", CELLS)
def test_fault_is_not_correct(kind, fault, monkeypatch):
    if fault == "control_tf32":
        faults.control(monkeypatch.setattr, CELLS[kind][1], SEED,
                       torch.device("cpu"))
    else:
        faults.FAULTS[fault](monkeypatch.setattr)
    r = run(kind)
    assert not r["correct"], r["checks"]
    if fault == "control_tf32":
        c = r["checks"]["logit_err"]
        assert c["value"] > c["limit"], c
