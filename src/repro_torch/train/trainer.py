"""Training loop: the train step (microbatch accumulation in float32, remat,
bf16), checkpoint/restart, failure recovery, as the reference's
``repro/train/trainer.py``.

``make_train_step`` returns one function
    state = {"params", "opt", "step"} → (state, metrics)
PyTorch runs it eagerly, one step at a time: gradients come from
``torch.autograd.grad`` of ``Model.loss_fn``; with microbatches they are
summed into float32 zeros and divided by the count (the reference's
``lax.scan`` over microbatches), so ``.grad`` never accumulates in the
parameters' bf16.  The optimizer updates the parameters in place; "step"
and the optimizer's count are 0-d int32 tensors on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import torch

from . import optimizer as opt_lib
from . import schedule as sched_lib
from .checkpoint import CheckpointManager
from .tree import leaves, unflatten
from ..models.model import Model


@dataclasses.dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 20
    total_steps: int = 1000
    microbatches: int = 1
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100
    log_every: int = 10
    seed: int = 0


def init_state(model: Model, gen: torch.Generator | int, optimizer: opt_lib.Optimizer):
    """Random parameters from ``gen`` (a generator on the model's device, or
    its seed), requiring grad, with the optimizer's initial state."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=model.device).manual_seed(int(gen))
    params = model.init(gen)
    for p in leaves(params):
        p.requires_grad_(True)
    return {
        "params": params,
        "opt": optimizer.init(params, period=len(model.cfg.pattern)),
        "step": torch.zeros((), dtype=torch.int32),
    }


def _grads(model: Model, params: dict, batch: dict):
    loss, metrics = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves(params))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: Model, optimizer: opt_lib.Optimizer,
                    lr_fn: Callable, microbatches: int = 1,
                    donate: bool = True) -> Callable:
    """``donate`` is accepted and ignored: it asks XLA to reuse the input
    state's buffers, and here the optimizer updates the parameters in place
    whatever it says."""
    period = len(model.cfg.pattern)

    def train_step(state, batch):
        params = state["params"]
        if microbatches > 1:
            def reshape(x):
                b = x.shape[0]
                assert b % microbatches == 0
                return x.reshape(microbatches, b // microbatches, *x.shape[1:])
            micro = {k: reshape(v) for k, v in batch.items()}
            loss_sum = None
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves(params)]
            for i in range(microbatches):
                loss, metrics, g = _grads(model, params, {k: v[i] for k, v in micro.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                loss_sum = loss if loss_sum is None else loss_sum + loss
            loss = loss_sum / microbatches
            grads = [g / microbatches for g in grads]
        else:
            loss, metrics, grads = _grads(model, params, batch)
        grads = unflatten(params, list(grads))

        lr = lr_fn(state["step"])
        gn = opt_lib.global_norm(grads)
        new_params, new_opt = optimizer.update(grads, state["opt"], params, lr, period=period)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        metrics = dict(metrics)
        metrics.update(loss=loss, lr=lr, grad_norm=gn)
        return new_state, metrics

    return train_step


class Trainer:
    """Loop with checkpoint/restart and step-level failure recovery."""

    def __init__(self, model: Model, tc: TrainConfig):
        self.model = model
        self.tc = tc
        self.optimizer = opt_lib.get_optimizer(model.cfg.optimizer)
        self.lr_fn = sched_lib.warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)
        self.train_step = make_train_step(model, self.optimizer, self.lr_fn,
                                          tc.microbatches)
        self.ckpt = CheckpointManager(tc.checkpoint_dir) if tc.checkpoint_dir else None
        self.history: list[dict] = []

    def init_or_restore(self) -> tuple[Any, dict]:
        gen = torch.Generator(device=self.model.device).manual_seed(self.tc.seed)
        state = init_state(self.model, gen, self.optimizer)
        extra = {"cursor": 0}
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, extra = self.ckpt.restore(state)
        return state, extra

    def fit(self, batches: Iterator[dict], steps: int | None = None,
            state: Any = None, cursor: int = 0) -> Any:
        if state is None:
            state, extra = self.init_or_restore()
            cursor = extra.get("cursor", 0)
        steps = steps if steps is not None else self.tc.total_steps
        t0 = time.monotonic()
        consumed = 0
        for batch in batches:
            consumed += 1
            if consumed <= cursor:
                continue  # deterministic resume: skip already-trained batches
            state, metrics = self.train_step(state, batch)
            step = int(state["step"])
            if step % self.tc.log_every == 0 or step == 1:
                rec = {k: float(v) for k, v in metrics.items()}
                rec["step"] = step
                rec["wall_s"] = time.monotonic() - t0
                self.history.append(rec)
            if (self.ckpt is not None and self.tc.checkpoint_every
                    and step % self.tc.checkpoint_every == 0):
                self.ckpt.save(step, state, extra={"cursor": consumed})
            if step >= steps:
                break
        if self.ckpt is not None:
            self.ckpt.save(int(state["step"]), state,
                           extra={"cursor": consumed}, blocking=True)
        return state
