"""The port stands alone: no module of ``repro_torch`` and nothing that
``chip_smoke.py`` imports pulls in ``jax`` or the JAX package ``repro``.
Run in a fresh interpreter, since this test process imports both."""
import json
import os
import subprocess
import sys
from pathlib import Path

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
              "repro_torch.models.mamba2",
              "repro_torch.core.samplers.stepwise",
              "repro_torch.serving.engine", "repro_torch.serving.scheduler",
              "repro_torch.launch.serve",
              "repro_torch.models.convert"):
        assert m in res["modules"]


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """No CUDA device: non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
