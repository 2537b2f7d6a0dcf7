"""Sequential freezing of decomposed layers — paper §2.2, Algorithm 2.

The counterpart of ``repro/core/freezing.py``.  Every decomposed layer
contributes factor *groups*:

    SVD:    group 0 = {u},        group 1 = {v}
    Tucker: group 0 = {first, last},  group 1 = {core}

Phase p (= epoch % 2) freezes group ``p`` and trains the complement; regular
(non-sequential) freezing is phase 0 forever; phase -1 freezes nothing.
Non-decomposed params are always trainable.

``partition(params, phase)`` splits a nested-dict param tree into a
``(trainable, frozen)`` pair.  Both keep the full nested-dict structure,
with ``None`` at the complementary positions; ``merge`` fills each hole
from the other tree.  No leaf is copied.  The train step gives only the
trainable partition ``requires_grad``, and the optimizer state exists only
for it (``launch.steps``).  :func:`apply_freeze` is the older full-tree
form (frozen leaves detached), and :func:`factor_rank_axis` names the axis
that in-training rank adaptation (``core.rank_adapt``) slices.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Tuple

__all__ = ["FreezeMode", "factor_group", "factor_rank_axis", "freeze_mask", "apply_freeze",
           "partition", "merge", "check_partition", "partition_moments", "merge_moments",
           "phase_for_epoch", "frozen_group_for_phase", "groups_to_replace",
           "phase_of_partition", "trainable_fraction", "tree_map", "tree_leaves"]

# Leaf names of decomposed factors -> group id (see module docstring).
_SVD_GROUPS = {"u": 0, "v": 1}
_TUCKER_GROUPS = {"first": 0, "last": 0, "core": 1}
# The rank axis of an SVD factor leaf: u is (..., C, r), v is (..., r, S).
_SVD_RANK_AXES = {"u": -1, "v": -2}


class FreezeMode(str, enum.Enum):
    NONE = "none"  # all params trainable (vanilla LRD)
    REGULAR = "regular"  # phase fixed to 0 for the whole run (paper §2.2 para 1)
    SEQUENTIAL = "sequential"  # phase = epoch % 2 (Algorithm 2)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (tuples and lists kept);
    ``None`` holes stay ``None`` and ``fn`` never sees them.  ``rest`` trees
    share ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves of nested dicts / tuples / lists in insertion order, holes skipped."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def factor_group(leaf_name: str) -> int | None:
    """Group id of a decomposed-factor leaf, or None for ordinary params."""
    if leaf_name in _SVD_GROUPS:
        return _SVD_GROUPS[leaf_name]
    return _TUCKER_GROUPS.get(leaf_name)


def factor_rank_axis(leaf_name: str) -> int | None:
    """Rank axis of an SVD factor leaf (``u`` -> -1, ``v`` -> -2), or None
    for every other param (bias, Tucker factors, ordinary kernels)."""
    return _SVD_RANK_AXES.get(leaf_name)


def phase_for_epoch(epoch: int, mode: FreezeMode | str, epochs_per_phase: int = 1) -> int:
    """Algorithm-2 phase at ``epoch``; the frozen group swaps every
    ``epochs_per_phase`` epochs (the paper uses 1)."""
    mode = FreezeMode(mode)
    if mode == FreezeMode.NONE:
        return -1  # sentinel: no freezing
    if mode == FreezeMode.REGULAR:
        return 0
    return (int(epoch) // max(int(epochs_per_phase), 1)) % 2


def frozen_group_for_phase(phase: int) -> int | None:
    """Factor group frozen at ``phase`` (None when nothing is frozen): the
    ``KernelPolicy.freeze_group`` whose gradient kernel is not launched."""
    return phase if phase in (0, 1) else None


def groups_to_replace(old_phase: int, new_phase: int) -> frozenset:
    """Factor groups whose partition membership changes between phases."""
    old = {old_phase} if old_phase in (0, 1) else set()
    new = {new_phase} if new_phase in (0, 1) else set()
    return frozenset(old ^ new)


def phase_of_partition(trainable: Any, frozen: Any) -> int:
    """The phase a ``(trainable, frozen)`` partition was built for: the
    group that populates the frozen tree, -1 when nothing is frozen."""

    def walk(tree):
        if isinstance(tree, dict):
            for name, sub in tree.items():
                if isinstance(sub, dict):
                    g = walk(sub)
                    if g is not None:
                        return g
                elif sub is not None:
                    g = factor_group(name)
                    if g is not None:
                        return g
        return None

    g = walk(frozen)
    return -1 if g is None else g


def freeze_mask(params: Any, phase: int) -> Any:
    """Tree of bools, True = trainable at this phase (matched by leaf name)."""

    def walk(tree):
        if isinstance(tree, dict):
            out = {}
            for name, sub in tree.items():
                if isinstance(sub, dict):
                    out[name] = walk(sub)
                else:
                    g = factor_group(name)
                    out[name] = True if (phase < 0 or g is None) else (g != phase)
            return out
        return True

    return walk(params)


def apply_freeze(params: Any, mask: Any) -> Any:
    """Frozen leaves (``mask`` False) detached from autograd, the others as
    they are: the full-tree form of freezing.  The train step uses
    :func:`partition` instead, so frozen leaves never enter the backward."""
    return tree_map(lambda p, m: p if m else p.detach(), params, mask)


def partition(params: Any, phase: int) -> Tuple[Any, Any]:
    """Split ``params`` into ``(trainable, frozen)`` for ``phase``; both keep
    the full structure with ``None`` holes.  ``phase == -1`` puts everything
    in the trainable partition."""
    mask = freeze_mask(params, phase)

    def split(m, p, keep_trainable):
        if isinstance(m, dict):
            return {k: split(m[k], p[k], keep_trainable) for k in m}
        return p if (m == keep_trainable) else None

    return split(mask, params, True), split(mask, params, False)


def merge(trainable: Any, frozen: Any) -> Any:
    """Inverse of :func:`partition`: fill each ``None`` hole in one tree
    with the leaf from the other."""
    if isinstance(trainable, dict) or isinstance(frozen, dict):
        tr = trainable if isinstance(trainable, dict) else {}
        fr = frozen if isinstance(frozen, dict) else {}
        keys = list(tr) + [k for k in fr if k not in tr]
        return {k: merge(tr.get(k), fr.get(k)) for k in keys}
    return frozen if trainable is None else trainable


def merge_moments(moments: Tuple[Any, Any], parked: Tuple[Any, Any]):
    """Merge active ``(mu, nu)`` moment slices with their parked
    complements.  ``nu`` is ``()`` for SGD and passes through."""
    mu, nu = moments
    return merge(mu, parked[0]), (nu if nu == () else merge(nu, parked[1]))


def partition_moments(moments: Tuple[Any, Any], phase: int):
    """Split full ``(mu, nu)`` moment trees into (active, parked) slice
    pairs for ``phase``."""
    mu, nu = moments
    mu_a, mu_p = partition(mu, phase)
    if nu == ():
        return (mu_a, ()), (mu_p, ())
    nu_a, nu_p = partition(nu, phase)
    return (mu_a, nu_a), (mu_p, nu_p)


def check_partition(trainable: Any, frozen: Any, phase: int) -> None:
    """Raise if ``(trainable, frozen)`` was not produced for ``phase``: a
    state partitioned for another phase would train the wrong group."""

    def walk(tr, fr, path=""):
        if isinstance(tr, dict) or isinstance(fr, dict):
            tr_d = tr if isinstance(tr, dict) else {}
            fr_d = fr if isinstance(fr, dict) else {}
            for k in set(tr_d) | set(fr_d):
                walk(tr_d.get(k), fr_d.get(k), f"{path}/{k}")
            return
        g = factor_group(path.rsplit("/", 1)[-1])
        should_freeze = phase >= 0 and g == phase
        if should_freeze and fr is None:
            raise ValueError(f"partition/phase mismatch: {path} should be frozen at "
                             f"phase {phase} but sits in the trainable partition")
        if not should_freeze and tr is None:
            raise ValueError(f"partition/phase mismatch: {path} should be trainable at "
                             f"phase {phase} but sits in the frozen partition")

    walk(trainable, frozen)


def trainable_fraction(mask: Any, params: Any) -> float:
    """Fraction of parameters trainable under ``mask`` (diagnostics, tests)."""
    sizes = [p.numel() for p in tree_leaves(params)]
    live = sum(n for n, m in zip(sizes, tree_leaves(mask)) if m)
    return live / max(sum(sizes), 1)
