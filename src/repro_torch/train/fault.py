"""Fault tolerance policies, as the reference's ``repro/train/fault.py``:

  * ``run_with_recovery`` — step-loop supervisor: on failure, restores the
    latest atomic checkpoint and resumes at the recorded data cursor (exactly-
    once batch semantics).  Failures are injected in tests via ``FailurePlan``.
  * ``StragglerPolicy`` — prefetch-depth recommendation given observed step
    time jitter; the data pipeline's opportunistic scheduler consumes it (a
    straggling input shard must never stall the step loop).
  * ``elastic_remesh`` — the largest valid mesh for the surviving device
    count, keeping the model axis (``launch/mesh.make_local_mesh``'s
    devices: the ranks of this process's group).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np

from .trainer import Trainer


@dataclasses.dataclass
class FailurePlan:
    """Deterministic failure injection for tests: fail at these step numbers."""
    fail_at_steps: tuple = ()
    exc: type = RuntimeError
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise self.exc(f"injected failure at step {step}")


def run_with_recovery(trainer: Trainer, batch_source: Callable[[], Iterator[dict]],
                      steps: int, max_restarts: int = 3,
                      failure_plan: FailurePlan | None = None) -> Any:
    """Supervise the training loop; restart from checkpoint on failure."""
    assert trainer.ckpt is not None, "recovery requires a checkpoint dir"
    restarts = 0
    while True:
        try:
            state, extra = trainer.init_or_restore()
            cursor = extra.get("cursor", 0)

            def guarded(batches):
                for i, b in enumerate(batches):
                    if failure_plan is not None:
                        failure_plan.maybe_fail(i + 1)
                    yield b

            return trainer.fit(guarded(batch_source()), steps=steps,
                               state=state, cursor=cursor)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            # a real fleet would also re-admit replacement hosts here
            time.sleep(0.01)


@dataclasses.dataclass
class StragglerPolicy:
    """Prefetch-depth control: keep enough batches in flight that a shard
    straggling by k standard deviations never stalls the step."""
    target_sigma: float = 3.0
    min_depth: int = 2
    max_depth: int = 16

    def recommend_depth(self, step_times_s: list[float]) -> int:
        if len(step_times_s) < 4:
            return self.min_depth
        arr = np.asarray(step_times_s[-64:])
        mean, std = float(arr.mean()), float(arr.std())
        if mean <= 0:
            return self.min_depth
        depth = int(np.ceil(1 + self.target_sigma * std / mean))
        return int(np.clip(depth, self.min_depth, self.max_depth))


def elastic_remesh(n_devices: int, axes: tuple[str, ...] = ("data", "model"),
                   model_parallel: int | None = None, device=None):
    """Build the largest valid mesh for the surviving device count.

    Keeps the model axis fixed (TP degree is an architecture property) and
    shrinks the data axis — the standard elastic-DP policy.  The devices are
    the ranks of this process's group (a one-rank group is opened where none
    is: NCCL on CUDA, unless ``device="cpu"``: gloo), the first of them
    taken."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from ..launch.mesh import open_local_group
    import torch.distributed as dist
    dev = open_local_group(device)
    ranks = list(range(dist.get_world_size()))[:n_devices]
    mp = model_parallel or 1
    dp = max(1, len(ranks) // mp)
    shape = (dp, mp) if len(axes) == 2 else (1, dp, mp)
    n = int(np.prod(shape))
    if n > len(ranks):
        raise ValueError(f"elastic_remesh: {n} devices wanted for {shape}, "
                         f"{len(ranks)} survive")
    return DeviceMesh(dev.type, torch.tensor(ranks[:n]).reshape(shape), mesh_dim_names=axes)
