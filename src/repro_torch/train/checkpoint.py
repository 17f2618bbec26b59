"""Asynchronous, atomic checkpointing (fault-tolerance substrate), with the
reference's format and behaviour (``repro/train/checkpoint.py``):

  * **atomic commit** — writes land in ``step_N.tmp/`` (``arrays.npz`` and
    an fsync'd ``meta.json``), then an atomic rename to ``step_N/``; a crash
    mid-write never corrupts the latest checkpoint;
  * **async** — ``save()`` copies the tensors to the host (the one sync),
    then hands serialization to a background thread; one save in flight at
    a time, and its error is raised on the next ``wait()``;
  * **logical arrays** — each leaf is saved whole under its key path
    (parts joined by ``/``, list items as ``#i``), bf16 widened to float32
    (npz has no bf16; lossless); ``restore`` narrows back to the template's
    dtype on the template's device;
  * **data cursor** — the pipeline position is stored with the weights, so a
    restart resumes mid-epoch without repeating or skipping batches;
  * old checkpoints are garbage-collected down to ``keep``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from .tree import leaves_with_paths, path_name, unflatten


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:         # npz has no bf16; widen lossless
        t = t.float()
    return t.cpu().numpy()


def _flatten(tree) -> dict[str, np.ndarray]:
    return {path_name(path): _host(leaf) for path, leaf in leaves_with_paths(tree)}


def _structure(tree) -> str:
    """The tree's shape without its leaves: dict keys and list lengths."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot to host, then serialize+commit in the background."""
        self.wait()  # one in-flight save at a time
        structure = _structure(state)
        flat = _flatten(state)   # device→host sync happens here, on purpose

        def work():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                meta = {
                    "step": step,
                    "treedef": structure,
                    "keys": sorted(flat.keys()),
                    "extra": extra or {},
                    "time": time.time(),
                }
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)          # atomic commit
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    def restore(self, template: Any, step: int | None = None) -> tuple[Any, dict]:
        """Restore into the structure of ``template``: each leaf in the
        template leaf's dtype, on its device, requiring grad as it does."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        arrays = np.load(os.path.join(path, "arrays.npz"))
        out = []
        for p, tmpl in leaves_with_paths(template):
            key = path_name(p)
            arr = arrays[key]
            assert arr.shape == tuple(tmpl.shape), (key, arr.shape, tmpl.shape)
            t = torch.from_numpy(arr).to(device=tmpl.device, dtype=tmpl.dtype)
            out.append(t.requires_grad_(tmpl.requires_grad))
        return unflatten(template, out), meta.get("extra", {})

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)


__all__ = ["CheckpointManager"]
