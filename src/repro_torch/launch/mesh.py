"""Process meshes — the counterpart of ``repro/launch/mesh.py``.

JAX runs one controller over many devices; PyTorch runs one process a rank.
So the port's mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the process group, with the reference's axis names:
``("data", "model")``, or ``("pod", "data", "model")``.  Each rank holds the
local shards of its tensors and runs explicit collectives over the mesh's
axes (``distributed.collectives``).  The sharding resolver reads only a
mesh's axis names and shape (``distributed.sharding.axis_sizes``).

A process with no process group has one device: :func:`make_host_mesh`
then returns a :class:`LocalMesh` of shape (1, 1), which reads like a
``DeviceMesh`` of one rank and runs no collective.

The process group comes from the caller (``train.py`` starts it from
``torch.distributed.run``'s environment); these functions never start one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives

__all__ = ["LocalMesh", "make_host_mesh", "make_production_mesh", "world_size"]


class LocalMesh:
    """The mesh of a process alone: the axis names and shape a one-rank
    ``DeviceMesh`` would have, this process at coordinate 0 of every axis."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int]):
        if any(s != 1 for s in shape):
            raise ValueError(f"LocalMesh holds one device, got shape {tuple(shape)}")
        self.mesh_dim_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        self.ndim = len(self.shape)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_coordinate(self):
        return [0] * self.ndim

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}=1" for n in self.mesh_dim_names)
        return f"LocalMesh(({dims}))"


world_size = collectives.world_size


def _too_small(what: str, counts: str, need: int, n: int) -> ValueError:
    return ValueError(
        f"{what}: requested {counts} = {need} ranks, but only {n} rank(s) are in the "
        f"process group — the mesh size must not exceed the rank count. Start one "
        f"process a rank with `python -m torch.distributed.run --nproc-per-node {need} "
        f"...` (on the CPU, or with --dist-backend gloo ranks may share a GPU).")


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    need = 1
    for s in shape:
        need *= s
    # the mesh's groups take the process group's backend; gloo's take CUDA
    # tensors too, so its device type matters only to DTensor, which the
    # port does not use
    device_type = "cuda" if collectives.backend() == "nccl" else "cpu"
    mesh = DeviceMesh(device_type, torch.arange(need).reshape(shape), mesh_dim_names=names)
    # every rank of the group takes part in flattening the mesh's axis sets
    collectives.register_mesh(mesh)
    return mesh


def make_host_mesh(data: int = 1, model: int = 1):
    """``(data, model)`` mesh over the FIRST ``data * model`` ranks of the
    process group; leftover ranks idle, as leftover devices do in the
    reference.  Every rank of the group must call it (making a mesh is a
    collective).

    Raises ``ValueError`` with the counts when ``data * model`` exceeds the
    world size.  A one-rank mesh is a :class:`LocalMesh`.
    """
    if data < 1 or model < 1:
        raise ValueError(f"make_host_mesh: axis sizes must be >= 1, "
                         f"got data={data} model={model}")
    n, need = world_size(), data * model
    if need > n:
        raise _too_small("make_host_mesh", f"(data={data}) x (model={model})", need, n)
    if need == 1 or n == 1:
        return LocalMesh(("data", "model"), (data, model))
    return _device_mesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``(data, model)`` for one pod; (2, 16, 16) ``(pod, data,
    model)`` for the two-pod config.  The pod axis is pure data
    parallelism.  Raises ``ValueError`` with the counts on a smaller world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, n = 1, world_size()
    for s in shape:
        need *= s
    if need > n:
        counts = " x ".join(f"({a}={s})" for a, s in zip(names, shape))
        raise _too_small("make_production_mesh", counts, need, n)
    return _device_mesh(shape, names)
