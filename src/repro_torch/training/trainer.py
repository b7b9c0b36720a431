"""Training loop: the diffusion-denoiser objective and AdamW, the port of
``repro.training.trainer``.

``make_train_step`` builds the train step that the launcher, ``Trainer``
and the tests use.  Conditional batches carry a clean source prefix; only
target positions are corrupted and scored (the paper's MT setup with a
decoder-only early-fusion twist).

The state is ``{"params", "opt": {"mu", "nu", "step"}, "step"}``, as in
the JAX package, with ``params`` the model's own parameters by name
(``dict(model.named_parameters())``): a step updates them in place, so
the model holds the trained weights.  The port builds its parameters
without gradients (serving runs under ``torch.inference_mode``);
``init_state`` turns them on for the model it trains.  Gradients flow
through plain PyTorch only: the kernel wrappers raise when asked for
one, so train with ``attn_impl`` "einsum" or "blocked" (a Mamba-2 block
scans through its plain chunked form while autograd records).

Under a mesh the same step trains a model whose parameters are DTensors
(``launch/sharding.py::shard_module``), on tokens placed by
``tokens_spec``: the gradients come back as DTensors, DTensor sums the
data-parallel partials, and AdamW's moments take the parameters'
placements.  The step's draws are drawn whole, for the global batch,
from the same generator on every rank, then placed as the tokens are,
so the sharded step sees exactly the single-device step's draws.  The
forward mixes DTensors with the plain tensors it builds (positions,
masks, constants) under ``implicit_replication``, which takes a plain
tensor as replicated.  ``loss`` and the other metrics come back whole.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import torch

from repro_torch.core import forward
from repro_torch.core.losses import weighted_ce
from repro_torch.core.noise import NoiseDist
from repro_torch.core.schedules import Schedule
from repro_torch.device import full, is_sharded, take_rows
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.training.optim import AdamW


def make_train_step(model: Model, schedule: Schedule, noise: NoiseDist,
                    optimizer: AdamW, *, continuous_time: bool = False,
                    lambda_weighting: bool = True,
                    microbatches: int = 1) -> Callable:
    """Returns step(state, batch, generator, draws=None) -> (state,
    metrics).

    batch: {"x0": (B, N) int, optional "src": (B, P) int, optional
    "frontend_embeds": (B, F, d)}, on the model's device.
    ``microbatches > 1`` is gradient accumulation: the batch is split
    along dim 0, and gradients and metrics are averaged.  The
    corruption draws come from ``generator``, microbatch after
    microbatch, or are replayed: ``draws`` holds one {"t", "u", "w"} per
    microbatch (``core/forward.py``).
    """
    cfg = model.cfg

    def loss_fn(batch, generator, draws):
        x0 = batch["x0"]
        if draws is None and is_sharded(x0):
            draws = _placed_draws(generator, x0, schedule, noise,
                                  continuous_time)
        if continuous_time:
            x_t, t, alpha_t = forward.corrupt_continuous(
                generator, x0, schedule, noise, draws=draws)
            t_norm = t
        else:
            x_t, t, alpha_t = forward.corrupt_for_training(
                generator, x0, schedule, noise, draws=draws)
            t_norm = t.float() / schedule.T

        src = batch.get("src")
        inp = x_t if src is None else torch.cat([src.to(x_t.dtype), x_t],
                                                dim=1)
        logits, aux = model(inp, t_norm, batch.get("frontend_embeds"),
                            causal=False, return_aux=True)
        if src is not None:
            logits = logits[:, src.shape[1]:]
        if is_sharded(logits):
            # the gold logit's torch.gather in losses._ce has no sharding
            # rule that holds on vocab-sharded logits: place them as the
            # tokens are (the vocab whole on every rank) before the loss
            logits = logits.redistribute(x0.device_mesh, x0.placements)

        ce_loss, acc, _ = weighted_ce(logits, x0, x_t, alpha_t, noise,
                                      lambda_weighting)
        loss = (ce_loss + cfg.load_balance_weight * aux["load_balance"]
                + cfg.router_z_weight * aux["router_z"])
        return loss, {"loss": loss.detach(), "ce": ce_loss.detach(),
                      "masked_acc": acc,
                      "load_balance": aux["load_balance"].detach()}

    def step(state, batch, generator, draws=None):
        params = state["params"]
        if any(is_sharded(p) for p in params.values()):
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                state, metrics = run(state, batch, generator, draws)
            return state, {k: full(v) for k, v in metrics.items()}
        return run(state, batch, generator, draws)

    def run(state, batch, generator, draws):
        params = state["params"]
        leaves = list(params.values())
        B = batch["x0"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} "
                             "microbatches")
        mb = B // microbatches
        grads = metrics = None
        for i in range(microbatches):
            sub = batch if microbatches == 1 else {
                k: take_rows(v, i * mb, mb) for k, v in batch.items()}
            loss, m_i = loss_fn(sub, generator,
                                None if draws is None else draws[i])
            g_i = torch.autograd.grad(loss, leaves)
            if grads is None:
                grads, metrics = list(g_i), m_i
            else:
                grads = [a + b for a, b in zip(grads, g_i)]
                metrics = {k: metrics[k] + m_i[k] for k in metrics}
        if microbatches > 1:
            grads = [g / microbatches for g in grads]
            metrics = {k: m / microbatches for k, m in metrics.items()}
        params, opt, opt_metrics = optimizer.update(
            dict(zip(params, grads)), state["opt"], params)
        metrics.update(opt_metrics)
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return step


def _placed_draws(generator, x0, schedule, noise, continuous: bool) -> dict:
    """The whole batch's corruption draws, from ``generator`` as the
    single-device step draws them, then placed as the DTensor ``x0`` is
    (a draw of fewer dims replicates where ``x0`` shards a dim it lacks).
    Every rank draws the same values and keeps its own block."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    draws = forward.training_draws(generator, tuple(x0.shape), schedule,
                                   noise, continuous=continuous,
                                   device=x0.device)
    out = {}
    for k, v in draws.items():
        pl = [Replicate() if isinstance(p, Shard) and p.dim >= v.dim()
              else p for p in x0.placements]
        out[k] = distribute_tensor(v, x0.device_mesh, pl, src_data_rank=None)
    return out


def init_state(model: Model, optimizer: AdamW) -> dict:
    """The train state of ``model``'s own parameters, with gradients
    turned on for them."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


@dataclasses.dataclass
class Trainer:
    """Single-device training driver with metrics and checkpointing."""

    model: Model
    schedule: Schedule
    noise: NoiseDist
    optimizer: AdamW
    continuous_time: bool = False
    log_every: int = 20
    ckpt_path: str | None = None
    ckpt_every: int = 0

    def run(self, data: Iterator[dict], steps: int, seed: int = 0,
            state: dict | None = None,
            verbose: bool = True) -> tuple[dict, list]:
        """Train for ``steps`` batches of ``data`` (numpy batches); the
        corruption draws come from a generator seeded with ``seed``.
        Returns (state, the logged metrics)."""
        step_fn = make_train_step(
            self.model, self.schedule, self.noise, self.optimizer,
            continuous_time=self.continuous_time)
        dev = self.model.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        if state is None:
            state = init_state(self.model, self.optimizer)
        history = []
        t0 = time.time()
        for i, batch in enumerate(data):
            if i >= steps:
                break
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            state, metrics = step_fn(state, batch, gen)
            if i % self.log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i
                m["wall"] = time.time() - t0
                history.append(m)
                if verbose:
                    print(f"step {i:5d} loss {m['loss']:.4f} "
                          f"acc {m['masked_acc']:.3f} "
                          f"lr {m['lr']:.2e} ({m['wall']:.1f}s)")
            if (self.ckpt_path and self.ckpt_every and
                    i and i % self.ckpt_every == 0):
                convert.save_checkpoint(self.model, self.ckpt_path)
        if self.ckpt_path:
            convert.save_checkpoint(self.model, self.ckpt_path)
        return state, history
