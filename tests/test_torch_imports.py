"""The port stands alone: no module of ``repro_torch`` (its telemetry,
``repro_torch.obs``, included) and nothing that ``chip_smoke.py`` imports
pulls in ``jax`` or the JAX package ``repro``.  Run in a fresh
interpreter, since this test process imports both.  On the card, a
ranked serving with telemetry on gives the tokens of the run with it
off."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, runpy, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
runpy.run_path(sys.argv[1], run_name="chip_smoke_imports")  # no main()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE,
                          str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for m in ("repro_torch.kernels.dndm_update.ops",
              "repro_torch.kernels.decode_scores.ops",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.ssd_scan.ops",
              "repro_torch.models.mamba2", "repro_torch.models.moe",
              "repro_torch.models.xlstm",
              "repro_torch.models.frontend", "repro_torch.configs.shapes",
              "repro_torch.configs.mixtral_8x7b",
              "repro_torch.configs.llama4_maverick_400b",
              "repro_torch.configs.chameleon_34b",
              "repro_torch.configs.deepseek_7b",
              "repro_torch.configs.musicgen_large",
              "repro_torch.configs.phi3_mini_3p8b",
              "repro_torch.configs.starcoder2_3b",
              "repro_torch.configs.tinyllama_1p1b",
              "repro_torch.configs.xlstm_350m",
              "repro_torch.core.samplers.stepwise",
              "repro_torch.serving.engine", "repro_torch.serving.scheduler",
              "repro_torch.launch.serve", "repro_torch.launch.train",
              "repro_torch.launch.mesh", "repro_torch.launch.sharding",
              "repro_torch.models.convert",
              "repro_torch.data", "repro_torch.data.pipeline",
              "repro_torch.data.synthetic", "repro_torch.data.tokenizer",
              "repro_torch.core.forward", "repro_torch.core.losses",
              "repro_torch.training", "repro_torch.training.checkpoint",
              "repro_torch.training.optim", "repro_torch.training.trainer",
              "repro_torch.obs", "repro_torch.obs.metrics",
              "repro_torch.obs.sketch", "repro_torch.obs.tracing",
              "repro_torch.obs.slo", "repro_torch.obs.exporter",
              "repro_torch.obs.schema", "repro_torch.obs.regress"):
        assert m in res["modules"]


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """No CUDA device: non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.cuda
def test_telemetry_changes_no_ranked_tokens_on_the_card(tmp_path):
    """Reduced dndm-mt, 3 dndm_topk and 2 dndm_c_topk requests with source
    prefixes, drained on the card's kernels twice in one process: the
    trace validates, and tokens and NFE are bitwise those of the run with
    telemetry off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import repro_torch.configs as configs
    from repro_torch import obs
    from repro_torch.models.model import Model
    from repro_torch.obs import schema
    from repro_torch.serving import (BatchScheduler, EngineConfig,
                                     GenerationEngine)

    model = Model(configs.get("dndm-mt").reduced(attn_impl="pallas"),
                  device="cuda", seed=0)
    rng = np.random.default_rng(0)
    tape = [(m, rng.integers(0, model.cfg.vocab_size - 1, 6 + i % 2,
                             dtype=np.int32))
            for i, m in enumerate(["dndm_topk"] * 3 + ["dndm_c_topk"] * 2)]

    def serve():
        # a fresh engine each time: its cold keys are part of the trace
        engine = GenerationEngine(model, EngineConfig(
            method="dndm_topk", steps=50, shared_tau=False), device="cuda")
        sched = BatchScheduler(engine, max_batch=4, bucket_len=16, seed=1,
                               device="cuda")
        rids = [sched.submit(16, prefix=p, method=m) for m, p in tape]
        done = sched.run()
        return [(done[r].nfe, done[r].result) for r in rids]

    off = serve()
    path = tmp_path / "trace.jsonl"
    obs.enable()
    obs.set_sink(str(path))
    try:
        on = serve()
        obs.tracing.close_sink(final_metrics=True)
    finally:
        obs.tracing.close_sink()
        obs.disable()
        obs.reset()
        obs.tracing.clear()
    for (nfe_on, tok_on), (nfe_off, tok_off) in zip(on, off):
        assert nfe_on == nfe_off
        np.testing.assert_array_equal(tok_on, tok_off)
    with open(path) as f:
        records = schema.validate_trace_lines(f)
    schema.validate_trace_content(records)
    final = [r for r in records if r["kind"] == "metrics"][-1]["metrics"]
    calls = final["decode.backend_calls"]["series"]
    assert {s["labels"]["backend"] for s in calls} == {"kernel"}
    assert any(r.get("name") == "sampler.step" for r in records)
