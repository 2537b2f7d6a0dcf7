"""The collectives of the sharded path — the one module that calls
``torch.distributed``.

JAX's sharded step leaves its collectives to XLA, and the reference reads
their bytes from the compiled HLO (``repro.analysis.hlo.sync_bytes``).  The
port runs them explicitly, one process a rank, so it knows each one as it
happens: :func:`all_reduce`, :func:`all_gather` and :func:`reduce_scatter`
over a tuple of mesh axes, and :func:`all_to_all` over one, each append a
:class:`Collective` — the op in the HLO's class names (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``), the dtype on the wire,
the bytes of the operand this rank sends in (the HLO's operand accounting)
and the param path it serves (``activation`` for an activation, ``loss`` /
``grad_norm`` for a metric, ``moe/...`` for a MoE layer's exchanges) — to
every :func:`recording` open.  :func:`broadcast_object` sends a host value
(a scheduling clock, an export's decisions) from the mesh's first rank to
the others on the control device, recorded as a ``broadcast`` of its
pickled bytes under its own path; it is no sync class of the reference's,
so the cost counts leave it out.  ``analysis/cost.py`` and the train CLI read
those records; the tests check by path that no collective serves a frozen
leaf.

Axes of size 1 are skipped: a collective over them moves nothing and is
not run.  A collective over one axis runs over the ``DeviceMesh``'s own
group of that axis; one over several axes over the group of a sub-mesh
flattened from them, which :func:`register_mesh` makes when the mesh is
made (making a group is a collective of the whole process group).  The
ranks of a flattened group are ordered by their coordinates on its axes,
the first axis major, so a gather over ``("pod", "data")`` puts its blocks
in the order a ``PartitionSpec`` entry ``("pod", "data")`` splits a dim.

Under gloo, CUDA tensors go to the collective as they are (gloo stages
them through host memory itself; all_to_all's too, on the card's torch
2.11); the bytes are counted the same.  :func:`all_to_all` is
differentiable (its backward is the reverse exchange, recorded under the
same path); a failed exchange raises, and no other backend or path is
tried.  Under NCCL every tensor must lie on the current CUDA device, the
control flags of :func:`any_rank` too (:func:`control_device`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import pickle
import warnings
from typing import Any
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Collective", "recording", "register_mesh", "all_reduce", "all_gather",
           "reduce_scatter", "all_to_all", "broadcast_object", "axes_size", "coordinate",
           "by_op", "by_op_dtype", "by_op_path", "process_rank",
           "any_rank", "control_device", "init_process_group", "destroy_process_group",
           "world_size", "backend", "mesh_size", "CLASSES"]

# the reference's sync classes (repro/analysis/hlo.py SYNC_COLLECTIVES)
CLASSES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective this rank took part in."""

    op: str  # "all-reduce" | "all-gather" | "reduce-scatter" | "all-to-all" | "broadcast"
    dtype: str  # the dtype on the wire, e.g. "bfloat16", "int8" ("object": pickled)
    bytes: int  # bytes of the operand this rank sends in
    path: str  # the param path it serves, or "activation" / "loss" / "grad_norm"
    axes: Tuple[str, ...] = ()


_SINKS: List[List[Collective]] = []


@contextlib.contextmanager
def recording():
    """Collect every collective run while open (nestable)."""
    sink: List[Collective] = []
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def by_op(log: Sequence[Collective]) -> Dict[str, int]:
    """Bytes by op class, as ``hlo.sync_bytes`` reports them."""
    out: Dict[str, int] = {}
    for c in log:
        out[c.op] = out.get(c.op, 0) + c.bytes
    return out


def by_op_dtype(log: Sequence[Collective]) -> Dict[str, int]:
    """Bytes by ``"<op> <dtype>"``."""
    out: Dict[str, int] = {}
    for c in log:
        key = f"{c.op} {c.dtype}"
        out[key] = out.get(key, 0) + c.bytes
    return out


def by_op_path(log: Sequence[Collective]) -> Dict[str, int]:
    """Bytes by ``"<op> <path>"``."""
    out: Dict[str, int] = {}
    for c in log:
        key = f"{c.op} {c.path}"
        out[key] = out.get(key, 0) + c.bytes
    return out


def _note(op: str, t: torch.Tensor, path: str, axes) -> None:
    _record(Collective(op, str(t.dtype).replace("torch.", ""), t.numel() * t.element_size(),
                       path, tuple(axes)))


def _record(rec: Collective) -> None:
    for sink in _SINKS:
        sink.append(rec)


# --------------------------------------------------------------------------
# mesh sub-groups
# --------------------------------------------------------------------------

# id(mesh) -> (mesh, {two or more live axes in mesh order: their flattened sub-mesh})
_FLAT: Dict[int, Tuple[object, Dict[Tuple[str, ...], object]]] = {}


def init_process_group(backend: str, init_method: str, rank: int, world: int):
    """Start this process's group (``backend`` exactly; never another on
    failure); returns the default group."""
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return dist.group.WORLD


def destroy_process_group() -> None:
    _FLAT.clear()
    dist.destroy_process_group()


def world_size() -> int:
    """The ranks of the process group, or 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> str:
    return dist.get_backend()


def mesh_size(mesh) -> int:
    return axes_size(mesh, _names(mesh))


def process_rank() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def control_device(backend: str) -> torch.device:
    """Where a tensor that carries only a control decision goes for a
    collective under ``backend``: NCCL takes CUDA tensors alone (the
    current device), gloo CPU ones."""
    return torch.device("cuda") if backend == "nccl" else torch.device("cpu")


def any_rank(flag: bool, mesh) -> bool:
    """Whether ``flag`` holds on any rank of ``mesh`` (a control decision
    its ranks must share; not recorded)."""
    live = _live(mesh, _names(mesh))
    if not live:
        return flag
    group = _group(mesh, live)
    t = torch.tensor([int(flag)], dtype=torch.int32,
                     device=control_device(dist.get_backend(group)))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(_names(mesh), (int(s) for s in mesh.shape)))


def register_mesh(mesh) -> None:
    """Flatten every set of two or more of ``mesh``'s axes of size > 1 into a
    sub-mesh, on every rank of the process group, in one order (the group
    of one axis is the mesh's own)."""
    live = _live(mesh, _names(mesh))
    flat = {axes: mesh[axes]._flatten("_".join(axes))
            for k in range(2, len(live) + 1) for axes in itertools.combinations(live, k)}
    _FLAT[id(mesh)] = (mesh, flat)


def axes_size(mesh, axes: Sequence[str]) -> int:
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def coordinate(mesh, axes: Sequence[str]) -> int:
    """This rank's block index along ``axes`` (first axis major)."""
    sizes = _sizes(mesh)
    coord = dict(zip(_names(mesh), mesh.get_coordinate()))
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + int(coord[a])
    return idx


def _live(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    """``axes`` without those of size 1, in mesh order."""
    sizes = _sizes(mesh)
    keep = {a for a in axes if sizes[a] > 1}
    return tuple(a for a in _names(mesh) if a in keep)


def _group(mesh, axes: Tuple[str, ...]):
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return _FLAT[id(mesh)][1][axes].get_group()


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str], *, path: str) -> torch.Tensor:
    """Sum ``t`` over the ranks that differ on ``axes``, in place; returns ``t``."""
    live = _live(mesh, axes)
    if not live:
        return t
    _note("all-reduce", t, path, live)
    dist.all_reduce(t, group=_group(mesh, live))
    return t


def all_gather(t: torch.Tensor, mesh, axes: Sequence[str], dim: int, *,
               path: str) -> torch.Tensor:
    """Concatenate the blocks of ``t`` along ``dim`` over ``axes`` (first
    axis major, as a spec entry splits a dim)."""
    live = _live(mesh, axes)
    if not live:
        return t
    if tuple(a for a in axes if a in live) != live:
        raise ValueError(f"all_gather over {tuple(axes)}: axes must be in mesh order "
                         f"{_names(mesh)}")
    n = axes_size(mesh, live)
    t = t.contiguous()
    _note("all-gather", t, path, live)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=_group(mesh, live))
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, mesh, axes: Sequence[str], dim: int, *,
                   path: str) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over ``axes``."""
    live = _live(mesh, axes)
    if not live:
        return t
    n = axes_size(mesh, live)
    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _note("reduce-scatter", moved, path, live)
    with warnings.catch_warnings():
        # newer torch renames it reduce_scatter_single; the card's has only this name
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, moved, group=_group(mesh, live))
    return out.movedim(0, dim)


class _AllToAll(torch.autograd.Function):
    """The exchange of equal dim-0 chunks over one axis; its backward is
    the same exchange of the gradient (chunk i went to rank i, so rank i's
    gradient of it comes back from rank i)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, path):
        ctx.mesh, ctx.axis, ctx.path = mesh, axis, path
        return _exchange(t, mesh, axis, path)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh, ctx.axis, ctx.path), None, None, None


def _exchange(t: torch.Tensor, mesh, axis: str, path: str) -> torch.Tensor:
    n = axes_size(mesh, (axis,))
    if t.shape[0] % n:
        raise ValueError(f"all_to_all over {axis!r} ({n} ranks): dim 0 of {tuple(t.shape)} "
                         f"does not split into {n} equal chunks")
    t = t.contiguous()
    out = torch.empty_like(t)
    _note("all-to-all", t, path, (axis,))
    dist.all_to_all_single(out, t, group=_group(mesh, (axis,)))
    return out


def all_to_all(t: torch.Tensor, mesh, axis: str, *, path: str) -> torch.Tensor:
    """Exchange equal chunks of ``t``'s dim 0 over mesh ``axis`` (the
    reference's ``lax.all_to_all(split_axis=0, concat_axis=0)``): chunk i
    goes to the rank at coordinate i on ``axis``, and chunk i of the result
    came from it.  Differentiable: the backward runs the same exchange on
    the gradient, recorded under the same ``path``.  On an axis of size 1
    ``t`` comes back."""
    if not _live(mesh, (axis,)):
        return t
    return _AllToAll.apply(t, mesh, axis, path)


def broadcast_object(obj: Any, mesh, *, path: str) -> Any:
    """The value ``obj`` holds on the mesh's first rank (coordinate 0 on
    every axis), on every rank of ``mesh``: a picklable host value sent on
    the control device.  Every rank of the mesh calls it at the same point;
    the others' ``obj`` is ignored.  Recorded as a ``broadcast`` of the
    pickled bytes under ``path``.  On a one-rank mesh ``obj`` comes back."""
    live = _live(mesh, _names(mesh))
    if not live:
        return obj
    group = _group(mesh, live)
    src = dist.get_global_rank(group, 0)
    box = [obj if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src, group=group,
                               device=control_device(dist.get_backend(group)))
    _record(Collective("broadcast", "object", len(pickle.dumps(box[0])), path, live))
    return box[0]
