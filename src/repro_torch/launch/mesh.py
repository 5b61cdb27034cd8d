"""Meshes of the launch layer (counterpart of ``repro.launch.mesh``).

Single pod: 16x16 = 256 devices, axes ("data", "model").
Multi-pod:  2x16x16 = 512 devices, axes ("pod", "data", "model"): the "pod"
axis is pure data parallelism across pods; parameters are replicated
across pods and the gradient all-reduce crosses the pod axis.

A ``DeviceMesh`` needs a default process group, so each mesh is a context
manager that creates the group on entry and destroys it on exit; entering
one while a group exists raises.  The production meshes sit on a fake
process group (``torch.testing._internal.distributed.fake_pg``): no
device, no process and no network behind its 256 or 512 ranks, for the
dry run's placements.  The host mesh is a real one-process group on an
in-process store.  Importing this module touches no state.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_host_mesh"]


@contextlib.contextmanager
def _default_group(backend: str, store, world_size: int) -> Iterator[None]:
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; a mesh makes its own")
    dist.init_process_group(backend, store=store, rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False) -> Iterator[DeviceMesh]:
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with "pod", on a
    fake process group of 256 or 512 ranks (this process is rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    with _default_group("fake", FakeStore(), 512 if multi_pod else 256):
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def make_host_mesh(device: str = "cuda") -> Iterator[DeviceMesh]:
    """A (1, n) ("data", "model") mesh over this process's n = 1 device:
    the card (NCCL) or, with ``device="cpu"``, the CPU (gloo), on a
    one-process group over an in-process store."""
    backend = "nccl" if device == "cuda" else "gloo"
    with _default_group(backend, dist.HashStore(), 1):
        yield init_device_mesh(device, (1, dist.get_world_size()),
                               mesh_dim_names=("data", "model"))
