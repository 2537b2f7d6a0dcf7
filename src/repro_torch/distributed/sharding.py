"""Logical-axis sharding rules with divisibility-aware fallbacks — the
counterpart of ``repro/distributed/sharding.py``.

Model code names tensor dims by *logical* axes; an active rule table maps
each logical axis to mesh axes, skipping candidates whose mesh axes are
missing, already used by an earlier dim, or do not divide the dim.  The
rule tables and the param-path patterns are the reference's, copied:

* ``PARAM_RULES``           FSDP on: weights sharded over ("data", "model");
* ``PARAM_RULES_NO_FSDP``   TP only (weights replicated across data, LRD
                            factors' rank dim still storage-sharded);
* ``FROZEN_PARAM_RULES``    the FROZEN partition of a sequentially frozen
                            train state: no ``data``/``pod`` axis anywhere,
                            so a frozen factor enters no collective;
* ``ACT_RULES`` / ``ACT_RULES_SP`` for activations.

A placement is a *spec*: a tuple with one entry per tensor dim, each
``None``, a mesh axis name or a tuple of them — a ``PartitionSpec``'s
entries, compared leaf for leaf with the reference's.  The resolver reads
only a mesh's axis names and shape (:func:`axis_sizes`: a ``DeviceMesh``,
``launch.mesh.LocalMesh``, or any object with ``axis_names`` and
``devices.shape``, as a JAX mesh has), so placements resolve with no
process group.  :class:`NamedSharding` pairs a mesh with a spec and knows a
rank's local block; the port's state holds those local blocks as plain
tensors (``launch.steps``).

:func:`axis_rules` also carries what the reference's context leaves to
XLA: ``rows``, the mesh axes the activations' rows (the batch) are split
over on this rank — the port's activations are local, so the kernel
dispatch (``kernels.ops``) is told rather than resolving them from a
global shape; ``manual``, the axes whose gradient sync an enclosing region
owns (``distributed.compression``); and ``leaves``, each param's path and
whether the tensor the forward consumes holds this rank's columns over
``model`` (:func:`leaf_path`, :func:`leaf_split`).

:func:`shard` is an annotation: the port's activations are already local,
so inside a context it checks the rank of the tensor against its axes and
returns it; outside one it warns once, as the reference's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
import warnings
from typing import Any, Dict, FrozenSet, Optional, Sequence, Tuple, Union

import torch

__all__ = ["ACT_RULES", "ACT_RULES_SP", "FROZEN_PARAM_RULES", "PARAM_RULES",
           "PARAM_RULES_NO_FSDP", "NamedSharding", "axis_rules", "axis_sizes",
           "current_manual_axes", "current_mesh", "current_row_axes", "leaf_path", "leaf_split",
           "mesh_size", "named_shardings", "paged_pool_shardings", "paged_pool_specs",
           "param_specs", "place_at_paths", "shard", "spec_axes"]

AxisCandidate = Union[None, str, Tuple[str, ...]]
RuleTable = Dict[str, Tuple[AxisCandidate, ...]]
Spec = Tuple[Any, ...]

# --------------------------------------------------------------------------
# Rule tables (the reference's)
# --------------------------------------------------------------------------

PARAM_RULES: RuleTable = {
    "embed": (("data",), None),
    "mlp": ("model", None),
    "heads": ("model", None),
    "kv_heads": ("model", None),
    "vocab": ("model", None),
    "expert": ("model", None),
    # an LRD factor has one ordinary dim, so its rank dim takes whichever
    # mesh axis the sibling dim did not (storage sharding; gathered for use)
    "rank": (("data",), ("model",), None),
    "conv": (None,),
}

PARAM_RULES_NO_FSDP: RuleTable = dict(PARAM_RULES, embed=(None,))

# the frozen partition: no storage sharding of the rank dim, output dims
# keep the TP ``model`` sharding the forward consumes locally
FROZEN_PARAM_RULES: RuleTable = dict(PARAM_RULES_NO_FSDP, rank=(None,), conv=(None,))

ACT_RULES: RuleTable = {
    "batch": (("pod", "data"), "data", None),
    "seq": (None,),
    "embed": (None,),
    "heads": ("model", None),
    "kv_heads": ("model", None),
    "mlp": ("model", None),
    "vocab": ("model", None),
    "expert": ("model", None),
    "kv_seq": (None,),
    "frames": (None,),
}

ACT_RULES_SP: RuleTable = dict(
    ACT_RULES, kv_seq=("model", None), kv_heads=(None,), heads=("model", None)
)

# --------------------------------------------------------------------------
# Meshes
# --------------------------------------------------------------------------


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` / ``LocalMesh``
    (``mesh_dim_names``, ``shape``) or a JAX-like mesh (``axis_names``,
    ``devices.shape``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    return dict(zip(mesh.axis_names, (int(s) for s in mesh.devices.shape)))


def mesh_size(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n


# --------------------------------------------------------------------------
# Context
# --------------------------------------------------------------------------

class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.act_rules: Optional[RuleTable] = None
        self.param_rules: Optional[RuleTable] = None
        self.manual_axes: FrozenSet[str] = frozenset()
        self.rows: Tuple[str, ...] = ()
        self.leaves: Dict[int, Tuple[str, bool]] = {}


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, *, act: RuleTable = ACT_RULES, params: RuleTable = PARAM_RULES,
               manual: FrozenSet[str] = frozenset(), rows: Optional[Sequence[str]] = None,
               leaves: Optional[Dict[str, Tuple[torch.Tensor, bool]]] = None):
    """Activate ``mesh`` and the rule tables for :func:`shard` /
    :func:`param_specs`.

    ``rows`` names the mesh axes the activations' rows are split over in
    the enclosed work (default: the enclosing context's); ``manual`` the
    axes whose gradient sync an enclosing region owns (the kernel dispatch
    leaves them out of its own collectives); ``leaves`` maps each param
    path to the tensor the forward consumes and whether its columns are
    split over ``model`` (default: the enclosing context's), which the
    kernel dispatch reads through :func:`leaf_path` / :func:`leaf_split`."""
    prev = _state()
    _set_state((mesh, act, params, frozenset(manual),
                prev[4] if rows is None else tuple(rows),
                prev[5] if leaves is None else
                {_storage(t): (path, split) for path, (t, split) in leaves.items()}))
    try:
        yield
    finally:
        _set_state(prev)


def _state():
    return (_CTX.mesh, _CTX.act_rules, _CTX.param_rules, _CTX.manual_axes, _CTX.rows,
            _CTX.leaves)


def _set_state(state) -> None:
    (_CTX.mesh, _CTX.act_rules, _CTX.param_rules, _CTX.manual_axes, _CTX.rows,
     _CTX.leaves) = state


def bind_context(fn):
    """``fn`` run under the context active at this call, on whatever thread
    calls it: an activation checkpoint's recompute runs on autograd's device
    thread for a CUDA backward, where the forward's :func:`axis_rules` is
    not active (the context is thread-local)."""
    state = _state()

    def bound(*args, **kwargs):
        prev = _state()
        _set_state(state)
        try:
            return fn(*args, **kwargs)
        finally:
            _set_state(prev)

    return bound


def current_mesh():
    """The mesh of the innermost active :func:`axis_rules` context."""
    return _CTX.mesh


def current_manual_axes() -> FrozenSet[str]:
    """Mesh axes whose sync an enclosing region owns."""
    return _CTX.manual_axes


def current_row_axes() -> Tuple[str, ...]:
    """Mesh axes the activations' rows are split over."""
    return _CTX.rows


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def leaf_path(t: torch.Tensor) -> str:
    """The param path of the leaf whose storage ``t`` views (a layer's slice
    of a stacked leaf views its storage), or ``"param"`` for one not registered."""
    return _CTX.leaves.get(_storage(t), ("param", False))[0]


def leaf_split(t: torch.Tensor) -> bool:
    """Whether the leaf ``t`` views holds this rank's block of columns over
    ``model`` (False for a leaf not registered: it is whole)."""
    return _CTX.leaves.get(_storage(t), ("", False))[1]


# --------------------------------------------------------------------------
# Resolution
# --------------------------------------------------------------------------

def _resolve_spec(shape: Sequence[int], axes: Sequence[Optional[str]], rules: RuleTable,
                  mesh) -> Spec:
    """Map logical axes to a spec honoring divisibility and axis reuse."""
    used: set = set()
    parts = []
    sizes = axis_sizes(mesh)
    for dim, ax in zip(shape, axes):
        chosen = None
        for cand in rules.get(ax, (None,)) if ax else (None,):
            if cand is None:
                break
            names = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(n not in sizes or n in used for n in names):
                continue
            total = 1
            for n in names:
                total *= sizes[n]
            if dim % total == 0:
                chosen = names
                break
        if chosen:
            used.update(chosen)
            parts.append(chosen[0] if len(chosen) == 1 else tuple(chosen))
        else:
            parts.append(None)
    return tuple(parts)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


_warned_no_rules = False


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Annotate activation ``x`` with logical axes.

    The port's activations are local blocks already, so this moves
    nothing: inside an :func:`axis_rules` context it checks that ``axes``
    names every dim of ``x`` and returns ``x``.  Outside any context it
    returns ``x`` too, and the first such call in a process warns, as the
    reference's does, so a launch-layer bug (a sharded step built without
    its context) surfaces."""
    if _CTX.mesh is None or _CTX.act_rules is None:
        global _warned_no_rules
        if not _warned_no_rules:
            _warned_no_rules = True
            warnings.warn(
                "repro_torch.distributed.sharding.shard() called outside an "
                "axis_rules(mesh, ...) context: sharding annotations are "
                "no-ops and the step runs unsharded. Wrap the step in "
                "`with axis_rules(mesh): ...` (done by launch/steps step "
                "builders). This warning is emitted once per process.",
                UserWarning, stacklevel=2)
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"shard: {len(axes)} axes for rank-{x.ndim} tensor {tuple(x.shape)}")
    return x


# --------------------------------------------------------------------------
# Parameter specs (path-based; the reference's patterns)
# --------------------------------------------------------------------------

_PARAM_PATTERNS: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embedding$", ("vocab", "embed")),
    (r"(unembed|lm_head|head)/kernel$", ("embed", "vocab")),
    (r"(unembed|lm_head|head)/u$", ("embed", "rank")),
    (r"(unembed|lm_head|head)/v$", ("rank", "vocab")),
    (r"wq/kernel$", ("embed", "heads")),
    (r"wq/u$", ("embed", "rank")),
    (r"wq/v$", ("rank", "heads")),
    (r"(wk|wv)/kernel$", ("embed", "kv_heads")),
    (r"(wk|wv)/u$", ("embed", "rank")),
    (r"(wk|wv)/v$", ("rank", "kv_heads")),
    (r"wo/kernel$", ("heads", "embed")),
    (r"wo/u$", ("heads", "rank")),
    (r"wo/v$", ("rank", "embed")),
    (r"(gate|up|wi|in_proj)/kernel$", ("embed", "mlp")),
    (r"(gate|up|wi|in_proj)/u$", ("embed", "rank")),
    (r"(gate|up|wi|in_proj)/v$", ("rank", "mlp")),
    (r"(down|out_proj)/kernel$", ("mlp", "embed")),
    (r"(down|out_proj)/u$", ("mlp", "rank")),
    (r"(down|out_proj)/v$", ("rank", "embed")),
    (r"(q_down|kv_down)/kernel$", ("embed", "rank")),
    (r"(q_up|kv_up)/kernel$", ("rank", "heads")),
    (r"(q_up|kv_up)/u$", (None, "rank")),
    (r"(q_up|kv_up)/v$", ("rank", "heads")),
    (r"router/kernel$", ("embed", None)),
    (r"conv1d/kernel$", (None, "mlp")),
    (r"wq/bias$", ("heads",)),
    (r"(wk|wv)/bias$", ("kv_heads",)),
    (r"(gate|up|wi|in_proj)/bias$", ("mlp",)),
    (r"(down|out_proj|wo)/bias$", ("embed",)),
    (r"(cross_wk|cross_wv)/kernel$", ("embed", "kv_heads")),
)

# int8 export artifacts store a factor as ``<name>_q`` (int8, same shape)
# and ``<name>_scale`` ((..., 1, S)): both resolve through the float leaf's
# pattern, and the scale's size-1 dims fall through divisibility to None
_INT8_EXPORT_LEAF = re.compile(r"(/(?:u|v|kernel))_(?:q|scale)$")


def _logical_axes_for(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    path = _INT8_EXPORT_LEAF.sub(r"\1", path)
    base: Optional[Tuple[Optional[str], ...]] = None
    for pattern, axes in _PARAM_PATTERNS:
        if re.search(pattern, path):
            base = axes
            break
    if base is None:
        base = (None,) * min(ndim, 2)
    extra = ndim - len(base)
    lead: Tuple[Optional[str], ...] = ()
    if extra > 0:
        # leading dims: expert stacks get the expert axis, layer stacks None
        if "experts" in path:
            lead = (None,) * (extra - 1) + ("expert",)
        else:
            lead = (None,) * extra
    return lead + base


def param_specs(params: Any, mesh=None, rules: Optional[RuleTable] = None) -> Any:
    """Spec tree of a param tree (of tensors, meta tensors or anything with a
    ``shape``); ``None`` holes map to ``None``."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.param_rules or PARAM_RULES
    if mesh is None:
        raise ValueError("param_specs needs a mesh (pass one or use axis_rules)")

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in tree.items()}
        if tree is None:
            return None
        shape = tuple(tree.shape)
        return _resolve_spec(shape, _logical_axes_for(path, len(shape)), rules, mesh)

    return walk(params, "")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where each rank's block of a tensor lies."""

    mesh: Any
    spec: Spec

    def _blocks(self):
        sizes = axis_sizes(self.mesh)
        for entry in self.spec:
            n = 1
            for a in spec_axes(entry):
                n *= sizes[a]
            yield entry, n

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one rank's block of a tensor of ``shape``."""
        out = list(shape)
        for d, (_, n) in enumerate(self._blocks()):
            out[d] //= n
        return tuple(out)

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a view; no copy)."""
        from repro_torch.distributed import collectives

        out = full
        for d, (entry, n) in enumerate(self._blocks()):
            if n > 1:
                size = full.shape[d] // n
                i = collectives.coordinate(self.mesh, spec_axes(entry))
                out = out.narrow(d, i * size, size)
        return out

    def coords(self) -> Tuple[int, ...]:
        """This rank's block index along each dim."""
        from repro_torch.distributed import collectives

        return tuple(collectives.coordinate(self.mesh, spec_axes(e)) if n > 1 else 0
                     for e, n in self._blocks())


def named_shardings(params: Any, mesh=None, rules: Optional[RuleTable] = None) -> Any:
    """:class:`NamedSharding` tree of a param tree (``param_specs`` + mesh);
    ``None`` holes pass through."""
    mesh = mesh or _CTX.mesh

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        return None if s is None else NamedSharding(mesh, s)

    return walk(param_specs(params, mesh, rules))


def place_at_paths(tree: Any, mesh, rules: RuleTable, paths: Sequence[str]) -> Any:
    """This rank's block, under its rule-resolved spec, of each WHOLE leaf
    under one of the subtree ``paths``; every other leaf passes through.

    The re-placement step of in-training rank adaptation
    (``launch.steps.repartition_state``): a truncated factor group's leaves
    are whole fresh tensors, and specs resolve against their current
    (truncated) shapes, so divisibility fallbacks re-apply at the new
    ranks."""
    specs = param_specs(tree, mesh, rules)
    prefixes = tuple(paths)

    def covered(path: str) -> bool:
        return any(path == p or path.startswith(p + "/") for p in prefixes)

    def walk(t, s, path):
        if isinstance(t, dict):
            return {k: walk(v, s[k], f"{path}/{k}" if path else k) for k, v in t.items()}
        if t is None or s is None or not covered(path):
            return t
        return NamedSharding(mesh, s).block(t).contiguous()

    return walk(tree, specs, "")


def paged_pool_specs(cache: Any, mesh) -> Any:
    """Spec tree for a paged serving cache: pool leaves (L, num_blocks,
    block_size, KV, hd) and their int8 scale siblings shard the KV-head dim
    over ``model`` when it divides; everything else (the page tables) is
    replicated.  Axes of size 1 are pruned and trailing ``None`` entries
    dropped, as the reference's are.  Resolve it on the WHOLE cache's
    shapes (a batch-1 prefill cache (L, 1, P, KV, hd) resolves the same
    way): :func:`paged_pool_shardings` gives each rank's block."""
    sizes = axis_sizes(mesh)

    def prune(spec: Spec) -> Spec:
        parts = []
        for p in spec:
            names = tuple(n for n in spec_axes(p) if sizes.get(n, 1) > 1)
            parts.append(None if not names else names[0] if len(names) == 1 else names)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if name in ("k", "v", "k_scale", "v_scale") and len(tree.shape) == 5:
            axes = (None, None, None, "kv_heads", None)
            return prune(_resolve_spec(tuple(tree.shape), axes, ACT_RULES, mesh))
        return ()

    return walk(cache, "")


def paged_pool_shardings(cache: Any, mesh) -> Any:
    """:class:`NamedSharding` tree of a WHOLE paged cache (tensors or meta
    tensors): where each rank's pool block lies.  A rank holds the KV heads
    of its ``model`` coordinate when the head count divides, else all of
    them (the reference's divisibility fallback), and the whole page
    tables.  ``serving.paged_cache.init_paged_cache`` allocates the blocks
    and ``insert_prefill_paged`` cuts a whole prefill's k/v to them."""

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        return NamedSharding(mesh, s)

    return walk(paged_pool_specs(cache, mesh))
