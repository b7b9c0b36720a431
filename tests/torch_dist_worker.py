"""One rank of the port's multi-process CPU runs
(tests/test_torch_distributed.py).  The test starts it as

    python tests/torch_dist_worker.py SCENARIO DIR

in WORLD_SIZE processes, each with its RANK; the ranks meet through a
file in DIR (no port), read their inputs from DIR/inputs.pt and each
writes DIR/SCENARIO.RANK.pt.  It imports nothing of the JAX package.
"""
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.core import noise as tnoise
from repro_torch.core import schedules as tschedules
from repro_torch.device import full
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.moe import MoE
from repro_torch.training import optim as toptim
from repro_torch.training import trainer as ttrainer


def _mesh():
    return tmesh.make_mesh((2, 2), ("data", "model"), "cpu")


def moe_layer(inputs, out_dir):
    """The MoE layer's "shard_map" dispatch on whole tensors, and on
    DTensor weights and tokens with the gradients of (y * r).sum() +
    0.1 load_balance + 0.01 router_z."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = _mesh()
    res = []
    for case in inputs["moe"]:
        cfg = ModelConfig(**case["cfg"]).replace(moe_dispatch="shard_map")
        layer = MoE(torch.Generator().manual_seed(0), cfg, device="cpu")
        convert.load_tree(layer, case["params"])
        x = torch.from_numpy(case["x"])
        with tmesh.use_mesh(mesh), torch.no_grad():
            y_whole, _ = layer(x)
        for name, p in list(layer.named_parameters()):
            spec = tsharding.param_spec(f"unit/b0/moe/{name}",
                                        (1, *p.shape), mesh,
                                        tsharding.ShardingPolicy(), cfg)[1:]
            layer.register_parameter(name, torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh,
                                  tsharding.placements(spec, mesh),
                                  src_data_rank=None)))
        rows = [Shard(0), Replicate()]
        xd = distribute_tensor(x, mesh, rows,
                               src_data_rank=None).requires_grad_(True)
        r = distribute_tensor(torch.from_numpy(case["r"]), mesh, rows,
                              src_data_rank=None)
        with tmesh.use_mesh(mesh):
            y, aux = layer(xd)
        loss = ((y * r).sum() + 0.1 * aux["load_balance"]
                + 0.01 * aux["router_z"])
        names = [n for n, _ in layer.named_parameters()]
        grads = torch.autograd.grad(loss, [xd, *layer.parameters()])
        res.append({
            "y_whole": y_whole, "y": y.full_tensor().detach(),
            "y_placements": [str(p) for p in y.placements],
            "aux": {k: float(v.full_tensor().detach())
                    for k, v in aux.items()},
            "grads": dict(zip(["x", *names],
                              [g.full_tensor() for g in grads])),
            "expert_placements": str(layer.up.placements)})
    return res


def _snapshot(model, state, metrics):
    def tree(named):
        return convert.to_jax_tree({k: full(v).detach().clone()
                                    for k, v in named.items()},
                                   model.unit, model.n_super)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": tree(state["params"]),
            "mu": tree(state["opt"]["mu"]), "nu": tree(state["opt"]["nu"])}


def train_steps(inputs, out_dir):
    """Two DTensor train steps per config on the JAX package's draws, and
    one on the step's own generator."""
    mesh = _mesh()
    policy = tsharding.ShardingPolicy()
    res = {}
    for case in inputs["train"]:
        cfg = ModelConfig(**case["cfg"])
        model = Model(cfg, device="cpu", seed=1)
        convert.load_params(model, case["params"])
        tsharding.shard_module(model, mesh, policy)
        placed = {k: [str(p) for p in v.placements]
                  for k, v in model.named_parameters()}
        opt = toptim.AdamW(schedule=toptim.warmup_cosine(3e-4, 20, 100))
        step = ttrainer.make_train_step(model, tschedules.linear(case["T"]),
                                        tnoise.absorbing(28), opt)
        state = ttrainer.init_state(model, opt)
        steps = []
        for batch, draws in zip(case["batches"], case["draws"]):
            with tmesh.use_mesh(mesh):
                state, metrics = step(state, tsharding.shard_batch(
                    {"x0": torch.from_numpy(batch)}, mesh, policy), None,
                    draws=[draws])
            steps.append(_snapshot(model, state, metrics))
        res[case["name"]] = {"steps": steps, "placements": placed}
        if case.get("own_draws"):
            model = Model(cfg, device="cpu", seed=1)
            convert.load_params(model, case["params"])
            tsharding.shard_module(model, mesh, policy)
            opt = toptim.AdamW(schedule=toptim.constant(1e-3), eps=1e-3)
            step = ttrainer.make_train_step(
                model, tschedules.linear(case["T"]), tnoise.absorbing(28),
                opt)
            state = ttrainer.init_state(model, opt)
            with tmesh.use_mesh(mesh):
                state, metrics = step(state, tsharding.shard_batch(
                    {"x0": torch.from_numpy(case["batches"][0])}, mesh,
                    policy), torch.Generator().manual_seed(5))
            res[case["name"]]["own_draws"] = _snapshot(model, state, metrics)
    return res


def decode(inputs, out_dir):
    """``Model.decode_step`` of a sharded model over caches placed by
    ``shard_cache`` (a batch that divides the data axis: batch on "data";
    a batch of 1: the slots on "data", whose softmax completes over the
    ranks, under attn_impl="pallas" from ``flash_decode_partials``; kv
    heads on "model"), token by token, and the same model whole on every
    rank; logits of every position, the sharded ones gathered whole."""
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = _mesh()
    policy = tsharding.ShardingPolicy()
    res = {}
    for case in inputs["decode"]:
        cfg = ModelConfig(**case["cfg"])
        whole = Model(cfg, device="cpu", seed=3)
        sharded = Model(cfg, device="cpu", seed=3)
        tsharding.shard_module(sharded, mesh, policy)
        tok = torch.from_numpy(case["tokens"])
        B, S = tok.shape
        cw = whole.init_cache(B, S)
        cs = tsharding.shard_cache(sharded.init_cache(B, S), mesh, B, policy)
        want, got = [], []
        with torch.no_grad(), tmesh.use_mesh(mesh), implicit_replication():
            for i in range(S):
                want.append(whole.decode_step(tok[:, i:i + 1], cw, i)[0])
                t = tsharding.shard_batch({"t": tok[:, i:i + 1]}, mesh,
                                          policy)["t"]
                got.append(full(sharded.decode_step(t, cs, i)[0]))
        res[case["name"]] = {
            "want": torch.stack(want), "got": torch.stack(got),
            "cache_placements": [str(v.placements) for c in cs
                                 for v in c.values()]}
    return res


def launcher(inputs, out_dir):
    """``launch/train.py --data-axis 2`` on the group this process made."""
    ttrain.main(["--data-axis", "2", "--reduced", "--device", "cpu",
                 "--steps", "2", "--batch", "4", "--seq", "16",
                 "--ckpt", os.path.join(out_dir, "ckpt")])
    return {}


SCENARIOS = {"moe_layer": moe_layer, "train_steps": train_steps,
             "launcher": launcher, "decode": decode}


def main():
    names, out_dir = sys.argv[1].split(","), sys.argv[2]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
        rank=rank, world_size=world)
    try:
        path = os.path.join(out_dir, "inputs.pt")
        inputs = (torch.load(path, weights_only=False)
                  if os.path.exists(path) else {})
        for name in names:
            torch.save(SCENARIOS[name](inputs, out_dir),
                       os.path.join(out_dir, f"{name}.{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
