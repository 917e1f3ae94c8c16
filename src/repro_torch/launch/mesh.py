"""Device meshes for the dry run (PyTorch port of ``repro.launch.mesh``).

Functions, not module constants, so importing this module touches no
process group.  The production meshes keep the reference's shapes, so the
dry run's cells correspond to its one to one: single pod 16 x 16 (``data,
model``), multi-pod 2 x 16 x 16 with a leading ``pod`` axis.  The
reference's are 256 and 512 TPU chips; here they are ranks of a
``DeviceMesh`` over torch's ``fake`` process group, which runs no
collective and needs no devices.  A ``cuda`` mesh still needs a CUDA build
of torch (the card's machine); a ``cpu`` mesh runs anywhere.  Build the
mesh before entering ``FakeTensorMode``.

A mesh of one rank is a ``OneRank``: no process group, and the dry run
runs plain fake tensors on it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclass(frozen=True)
class OneRank:
    """A mesh of one rank: every axis of size 1, no process group."""
    device_type: str = "cuda"
    mesh_dim_names: tuple = ("data", "model")

    @property
    def shape(self) -> tuple:
        return (1,) * len(self.mesh_dim_names)

    def size(self) -> int:
        return 1


def fake_world(n: int) -> None:
    """Make the default process group torch's ``fake`` one of at least
    ``n`` ranks (this process is rank 0).  A smaller fake group is
    replaced, which leaves every mesh made over it unusable (DTensor's
    caches name its groups): make the largest first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() >= n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_mesh(shape: tuple, axes: tuple, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0..n-1 of a
    fake process group of at least that many ranks (``OneRank`` for one
    rank), so that meshes of several sizes live in one process."""
    n = math.prod(shape)
    if n == 1:
        return OneRank(device, tuple(axes))
    fake_world(n)
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A small ``data x model`` mesh (tests)."""
    return make_mesh((data, model), ("data", "model"), device)


def mesh_size(mesh) -> int:
    return math.prod(mesh.shape)
