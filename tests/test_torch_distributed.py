"""The port's multi-device code in four CPU processes (gloo) on a (2, 2)
("data", "model") mesh, against the global dispatch, the single-device
port and the JAX package.

The ranks run ``tests/torch_dist_worker.py`` as subprocesses: they meet
through a file in the test's temporary directory (never a fixed port),
and the test waits for them with a timeout, so a hung collective fails
it instead of stalling the suite.  One run serves every test here:

* the MoE layer's "shard_map" dispatch, expert parallel (8 experts) and
  tensor parallel (3), top 2, capacity factor 16 (the cases of
  tests/test_models.py::test_moe_shard_map_paths_match_global): y on
  whole tensors and on DTensors against the global dispatch and the JAX
  ``moe.apply`` at atol = rtol = 1e-5; the aux terms and the gradients
  through the DTensors against the global dispatch's autograd;
* two train steps of a reduced dense config, a reduced mixtral (expert
  parallel, "shard_map", capacity factor 16), a reduced zamba2 and an
  xLSTM with DTensor parameters on the JAX package's draws, against the
  JAX step and the
  single-device port step at test_torch_training.py's f32 bar, and one
  step on the step's own generator against the single-device step on
  the same generator;
* ``launch/train.py --data-axis 2 --reduced --device cpu`` for 2 steps.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import repro.configs as jconfigs
from repro import data as jdata
from repro.core import noise as jnoise
from repro.core import schedules as jschedules
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro.models.model import Model as JModel
from repro.training import checkpoint as jckpt
from repro.training import optim as joptim
from repro.training import trainer as jtrainer

import repro_torch.configs as tconfigs
from repro_torch.core import noise as tnoise
from repro_torch.core import schedules as tschedules
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.model import Model as TModel
from repro_torch.models.moe import MoE
from repro_torch.training import optim as toptim
from repro_torch.training import trainer as ttrainer

WORLD = 4
TIMEOUT = 300                      # seconds for the ranks, all together
WORKER = pathlib.Path(__file__).with_name("torch_dist_worker.py")
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
RTOL, ATOL = 1e-5, 1e-6            # test_torch_training.py's f32 bar
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # ... and its bar for gradients
T = 50
TINY = dict(name="t", arch_type="x", n_layers=1, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=50, block_pattern=("moe",),
            ssm_state=16, ssm_head_dim=32, ssd_chunk=8, lstm_heads=2,
            sliding_window=8, experts_per_token=2, capacity_factor=16.0)
TRAIN = {
    "dense": ("dndm-text8", dict(n_layers=2, block_pattern=("attn",) * 2,
                                 d_model=64, d_ff=128)),
    "mixtral": ("mixtral-8x7b", dict(n_layers=2, block_pattern=("moe",) * 2,
                                     d_model=64, d_ff=128, vocab_size=28,
                                     capacity_factor=16.0,
                                     moe_dispatch="shard_map")),
    # the mixers, replicated under the default policy (ssm_tp=False): the
    # Mamba-2 causal conv and cumsum and the xLSTM loops on DTensors; the
    # xLSTM without the time embedding, as test_torch_training.py holds it
    "zamba2": ("zamba2-2.7b", dict(n_layers=4, block_pattern=(
        "mamba2", "shared_attn") * 2, d_model=64, d_ff=128, vocab_size=28)),
    "xlstm": ("xlstm-350m", dict(n_layers=2, block_pattern=("mlstm", "slstm"),
                                 d_model=64, vocab_size=28,
                                 time_conditioning=False)),
}


def _jax_draws(key, shape, jsch, jnz):
    """The draws of ``corrupt_for_training`` under ``key`` (see
    tests/test_torch_training.py)."""
    k_t, k_x = jax.random.split(key)
    t = jax.random.randint(k_t, shape[:1], 1, jsch.T + 1)
    k_keep, k_noise = jax.random.split(k_x)
    return {"t": np.array(t),
            "u": np.array(jax.random.uniform(k_keep, shape, jnp.float32)),
            "w": np.array(jnz.sample(k_noise, shape))}


def _moe_inputs():
    key = jax.random.PRNGKey(0)
    cases = []
    for n_experts in (8, 3):             # 8: expert parallel, 3: tensor
        cfg = dict(TINY, n_experts=n_experts)
        params = jmoe.init(key, JModelConfig(**cfg))
        x = jax.random.normal(jax.random.fold_in(key, 12), (4, 16, 64))
        r = jax.random.normal(jax.random.fold_in(key, 13), (4, 16, 64))
        cases.append({"cfg": cfg, "params": jax.tree.map(np.array, params),
                      "x": np.array(x), "r": np.array(r)})
    return cases


def _train_inputs():
    cases = []
    jsch, jnz = jschedules.linear(T), jnoise.absorbing(28)
    for name, (arch, kw) in TRAIN.items():
        jcfg = jconfigs.get(arch).reduced(**kw)
        params = JModel(jcfg).init(jax.random.PRNGKey(0))
        pipe = jdata.DataPipeline(jdata.DataConfig(
            task="unconditional", vocab=27, seq_len=16, batch=4, seed=1))
        batches = [b["x0"] for _, b in zip(range(2), pipe)]
        draws = [_jax_draws(jax.random.fold_in(jax.random.PRNGKey(9), s),
                            b.shape, jsch, jnz)
                 for s, b in enumerate(batches)]
        cases.append({"name": name, "arch": arch, "T": T,
                      "cfg": dataclasses.asdict(tconfigs.get(arch).reduced(
                          **kw)),
                      "params": jax.tree.map(np.array, params),
                      "batches": batches, "draws": draws,
                      "own_draws": name == "dense"})
    return cases


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the ranks once for every test of this file; returns (dir,
    inputs, the ranks' logs)."""
    out = tmp_path_factory.mktemp("gloo")
    inputs = {"moe": _moe_inputs(), "train": _train_inputs()}
    torch.save(inputs, out / "inputs.pt")
    env = {**os.environ, "WORLD_SIZE": str(WORLD), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), os.environ.get("PYTHONPATH", "")])}
    procs = []
    for r in range(WORLD):
        with open(out / f"log.{r}", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER),
                 "moe_layer,train_steps,launcher", str(out)],
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(out / f"log.{r}").read_text() for r in range(WORLD)]
    rcs = [p.returncode for p in procs]
    return out, inputs, logs, rcs


def _result(run, name, rank=0):
    out, _, logs, rcs = run
    path = out / f"{name}.{rank}.pt"
    assert path.exists(), f"rank exit codes {rcs}; rank 0's log:\n" + \
        logs[0][-4000:]
    return torch.load(path, weights_only=False)


def test_ranks_end_cleanly(run):
    _, _, logs, rcs = run
    assert rcs == [0] * WORLD, logs[0][-4000:]


# --------------------------------------------------------------- MoE

@pytest.mark.parametrize("case", [0, 1], ids=["expert_parallel",
                                              "tensor_parallel"])
def test_moe_shard_map_matches_global_and_jax(run, case):
    _, inputs, _, _ = run
    inp = inputs["moe"][case]
    got = _result(run, "moe_layer")[case]
    jcfg = JModelConfig(**inp["cfg"])
    want_jax, _ = jmoe.apply(inp["params"], jnp.asarray(inp["x"]), jcfg)
    layer = MoE(torch.Generator().manual_seed(0), TModelConfig(**inp["cfg"]),
                device="cpu")
    convert.load_tree(layer, inp["params"])
    for p in layer.parameters():
        p.requires_grad_(True)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y, aux = layer(x)
    for k in ("y_whole", "y"):
        np.testing.assert_allclose(got[k].numpy(), y.detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want_jax),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert got["y_placements"] == [str(Shard(0)), str(Replicate())]
    assert got["expert_placements"] == str(
        (Replicate(), Shard(0 if case == 0 else 2)))
    for k, v in aux.items():
        np.testing.assert_allclose(got["aux"][k], float(v.detach()), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    loss = ((y * torch.from_numpy(inp["r"])).sum()
            + 0.1 * aux["load_balance"] + 0.01 * aux["router_z"])
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(loss, [x, *layer.parameters()])
    for k, g in zip(["x", *names], grads):
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


# ---------------------------------------------------- the train step

ILL_CONDITIONED_SHARE = 1e-4


def _assert_params_close(got: dict, want: dict, lr_sum: float):
    """test_torch_training.py's bar for parameters after AdamW steps on
    two sums of the same gradients: every element within 2 x the sum of
    the learning rates, all but 1e-4 of them at the f32 bar."""
    g, w = convert.flatten(got), convert.flatten(want)
    assert sorted(g) == sorted(w)
    off = total = 0
    for k in w:
        a = np.asarray(g[k], np.float32)
        d = np.abs(a - np.asarray(w[k], np.float32))
        bar = ATOL + RTOL * np.abs(np.asarray(w[k], np.float32))
        assert (d <= bar + 2 * lr_sum).all(), k
        off += int((d > bar).sum())
        total += d.size
    assert off <= ILL_CONDITIONED_SHARE * total, (off, total)


def _assert_trees_close(got: dict, want: dict):
    g, w = convert.flatten(got), convert.flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k], np.float32),
                                   np.asarray(w[k], np.float32), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_steps(case):
    jcfg = jconfigs.get(case["arch"]).reduced(**TRAIN[case["name"]][1])
    jm = JModel(jcfg)
    jopt = joptim.AdamW(schedule=joptim.warmup_cosine(3e-4, 20, 100))
    jstep = jax.jit(jtrainer.make_train_step(
        jm, jschedules.linear(T), jnoise.absorbing(28), jopt))
    params = jax.tree.map(jnp.asarray, case["params"])
    state = {"params": params, "opt": jopt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    out = []
    for s, batch in enumerate(case["batches"]):
        key = jax.random.fold_in(jax.random.PRNGKey(9), s)
        state, met = jstep(state, {"x0": jnp.asarray(batch)}, key)
        out.append({"metrics": {k: float(v) for k, v in met.items()},
                    "params": _np(state["params"]),
                    "mu": _np(state["opt"]["mu"]),
                    "nu": _np(state["opt"]["nu"])})
    return out


def _port_steps(case, generator=None):
    cfg = TModelConfig(**case["cfg"])
    tm = TModel(cfg, device="cpu", seed=1)
    convert.load_params(tm, case["params"])
    opt = (toptim.AdamW(schedule=toptim.warmup_cosine(3e-4, 20, 100))
           if generator is None else OWN_DRAWS_OPT)
    step = ttrainer.make_train_step(tm, tschedules.linear(T),
                                    tnoise.absorbing(28), opt)
    state = ttrainer.init_state(tm, opt)
    out = []
    batches = case["batches"] if generator is None else case["batches"][:1]
    for batch, draws in zip(batches, case["draws"]):
        state, met = step(state, {"x0": torch.from_numpy(batch)}, generator,
                          draws=None if generator else [draws])

        def tree(named):            # a copy: the step updates in place
            return convert.to_jax_tree({k: v.detach().clone()
                                        for k, v in named.items()},
                                       tm.unit, tm.n_super)
        out.append({"metrics": {k: float(v) for k, v in met.items()},
                    "params": tree(state["params"]),
                    "mu": tree(state["opt"]["mu"]),
                    "nu": tree(state["opt"]["nu"])})
    return out


def _assert_steps_close(got, want):
    lr_sum = 0.0
    for g, w in zip(got, want, strict=True):
        for k in ("lr", "grad_norm", "loss", "ce", "load_balance"):
            np.testing.assert_allclose(g["metrics"][k], w["metrics"][k],
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        lr_sum += w["metrics"]["lr"]
        _assert_params_close(g["params"], w["params"], lr_sum)
        for part in ("mu", "nu"):
            _assert_trees_close(g[part], w[part])


@pytest.mark.parametrize("name", list(TRAIN))
def test_dtensor_train_steps_match_jax_and_one_device(run, name):
    _, inputs, _, _ = run
    case = next(c for c in inputs["train"] if c["name"] == name)
    got = _result(run, "train_steps")[name]
    _assert_steps_close(got["steps"], _jax_steps(case))
    _assert_steps_close(got["steps"], _port_steps(case))
    pl = got["placements"]

    def on_model(dim):
        return [str(Replicate()), str(Shard(dim))]
    whole = [str(Replicate())] * 2
    assert pl["embed"] == on_model(0)
    assert pl["ln_f.scale"] == whole
    want = {"dense": {"blocks.0.attn.wq": on_model(1),
                      "blocks.1.mlp.down": on_model(0)},
            "mixtral": {"blocks.0.moe.up": on_model(0),
                        "blocks.0.moe.router": whole},
            "zamba2": {"shared.attn.wo": on_model(0),
                       "blocks.2.mixer.in_proj": whole},
            "xlstm": {"blocks.0.mixer.wq": whole,
                      "blocks.1.mixer.r": whole}}[name]
    assert {k: pl[k] for k in want} == want


# the own-draws step's optimizer: at eps 1e-3 a parameter whose gradient
# is within the f32 rounding of zero moves by ~lr * |g| / eps, not by
# ~lr either way (u = g / (|g| + eps)), so every element is held at the
# f32 bar; the JAX-draws steps hold the default eps 1e-8 as
# test_torch_training.py does
OWN_DRAWS_OPT = toptim.AdamW(schedule=toptim.constant(1e-3), eps=1e-3)


def test_dtensor_step_draws_as_the_single_device_step(run):
    """The sharded step draws the whole batch's t, u and w from its
    generator, as one device does, and keeps its block: loss, accuracy
    and the updated parameters equal the single-device step's on the
    same generator."""
    _, inputs, _, _ = run
    case = next(c for c in inputs["train"] if c["own_draws"])
    got = _result(run, "train_steps")[case["name"]]["own_draws"]
    want = _port_steps(case, torch.Generator().manual_seed(5))
    assert got["metrics"]["masked_acc"] == want[0]["metrics"]["masked_acc"]
    _assert_steps_close([got], want)


def test_train_cli_with_a_data_axis(run):
    out, _, logs, _ = run
    _result(run, "launcher")
    lines = [ln for log in logs for ln in log.splitlines()
             if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["0", "1"]   # rank 0 only
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)
    cfg = jconfigs.get("dndm-text8").reduced()
    shapes = convert.flatten(jax.eval_shape(JModel(cfg).init,
                                            jax.random.PRNGKey(0)))
    back = convert.flatten(jckpt.load(str(out / "ckpt")))
    assert {k: v.shape for k, v in back.items()} == {
        k: v.shape for k, v in shapes.items()}
