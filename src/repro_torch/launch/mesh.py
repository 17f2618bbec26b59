"""Device meshes, as the reference's ``repro/launch/mesh.py``, on torch's
``DeviceMesh``.

Functions only, never module-level meshes: importing this module opens no
process group and sets no environment variable.

* ``make_production_mesh`` is the reference's 16 x 16 ("data", "model") pod,
  or 2 x 16 x 16 ("pod", "data", "model"), over an *abstract* world: torch's
  fake process-group backend at rank 0, opened by ``abstract_world(n)``.  A
  collective on it moves nothing; on meta tensors it only gives its result's
  shape.  It serves the dry-run alone (``launch/dryrun.py``).
* ``make_local_mesh`` is (n, 1) over what this process drives.  Under
  torch.distributed a process drives one device, so n is the world size of
  the process group: 1 unless one is already open, in which case it is used.
  Where none is open it opens a one-rank group on a ``HashStore`` (no
  socket): NCCL on CUDA (the default), gloo with ``device="cpu"``.

``dp_axes`` and ``axis_size`` take a ``DeviceMesh`` or any object with the
reference's ``.shape`` (a name -> size mapping) and ``.axis_names``, as the
tests' duck-typed meshes.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..core.dtypes import resolve_device


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_sizes(mesh) -> dict[str, int]:
    """name -> size of every mesh axis, in mesh order."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh ("pod" folds into DP)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def axis_size(mesh, axes) -> int:
    sizes = mesh_sizes(mesh)
    size = 1
    for a in ([axes] if isinstance(axes, str) else axes):
        size *= sizes[a]
    return size


def device_count(mesh) -> int:
    n = 1
    for s in mesh_sizes(mesh).values():
        n *= s
    return n


# =============================================================================
# the abstract world (dry-run)
# =============================================================================
def _fake_store():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


@contextlib.contextmanager
def abstract_world(n: int):
    """A process group of ``n`` ranks on torch's fake backend, this process
    rank 0, destroyed on exit.  Refuses to stack on an open group."""
    if dist.is_initialized():
        raise RuntimeError("abstract_world: a process group is already open in this process")
    dist.init_process_group("fake", store=_fake_store(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 devices a pod; 2 pods = 512, multi-pod.  Needs an open
    world of that size (``abstract_world``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


# =============================================================================
# the local mesh (what this process drives)
# =============================================================================
def open_local_group(device=None) -> torch.device:
    """Open a one-rank process group for ``device`` (CUDA unless "cpu") when
    none is open; returns the device the mesh spans."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dev
    store = dist.HashStore()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=dev)
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    return dev


def make_local_mesh(device=None):
    """(n, 1) ("data", "model") over this process's group (see the module's
    docstring); opens a one-rank group where none is open."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = open_local_group(device)
    return init_device_mesh(dev.type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))


def close_local_group() -> None:
    """Destroy the process group ``make_local_mesh`` opened (if any)."""
    if dist.is_initialized():
        dist.destroy_process_group()
