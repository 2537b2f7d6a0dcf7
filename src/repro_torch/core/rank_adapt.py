"""In-training rank adaptation at freezing-phase boundaries — the
counterpart of ``repro/core/rank_adapt.py``.

Ranks are fixed when the network is decomposed (Algorithm 1), and
sequential freezing (Algorithm 2) rewrites the train state at every phase
swap (``launch.steps.repartition_state``).  This module lets the ranks
shrink at those swaps.  A :class:`RankSchedule` names the policy:

* ``"decay"`` — every boundary multiplies each group's live rank by
  ``decay``, snaps it to the tile with ``rank_opt.quantize_rank`` (ranks
  below one tile pass through) and clamps it to ``min_rank``.  The whole
  trajectory follows from the initial ranks (:func:`decay_rank_maps`).
* ``"energy"`` — per group, the smallest rank whose singular values of the
  live product ``U @ V`` keep ``energy_threshold`` of the squared singular
  mass (``svd.product_singular_values``); a stacked group takes the max
  over its layers, so one shared rank survives.

Truncation reuses ``svd.truncate_factors`` (the QR-reduced Eckart–Young
truncation) on the MERGED param tree, so both factors of a group change,
and :func:`slice_moments` cuts the live and the parked optimizer moments
to the new rank.  The kept moment slices are the old moments in the old
coordinates, as in the JAX package (a heuristic; zeroing them would forget
the group's curvature).  Sliced leaves are copies, so a truncated device
leaf owns its storage and the untruncated one is freed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import freezing, rank_opt, svd
from repro_torch.core.decompose import iter_factor_groups, map_factor_groups

__all__ = ["RankSchedule", "schedule_from_config", "live_rank_map", "plan_rank_map",
           "truncate_params", "slice_tree", "slice_moments", "decay_rank_maps"]


@dataclasses.dataclass(frozen=True)
class RankSchedule:
    """Per-boundary rank-shrinkage policy (see module docstring).

    ``start_boundary`` gates the first Algorithm-2 swap that truncates
    (boundary 1 = the first swap); earlier swaps only rotate the partition.
    ``tile``/``quantize_mode`` feed ``rank_opt.quantize_rank``.
    """

    policy: str = "none"  # "none" | "decay" | "energy"
    decay: float = 0.75  # per-boundary multiplicative target (decay policy)
    energy_threshold: float = 0.98  # kept squared singular mass (energy)
    min_rank: int = 2  # never truncate below this
    tile: int = 128  # tile for quantize_rank
    quantize_mode: str = "floor"
    start_boundary: int = 1

    def __post_init__(self):
        if self.policy not in ("none", "decay", "energy"):
            raise ValueError(f"unknown rank-schedule policy {self.policy!r}")
        if self.policy == "decay" and not (0.0 < self.decay < 1.0):
            raise ValueError(f"decay must be in (0, 1), got {self.decay}")
        if self.policy == "energy" and not (0.0 < self.energy_threshold <= 1.0):
            raise ValueError(f"energy_threshold must be in (0, 1], got {self.energy_threshold}")
        if self.min_rank < 1:
            raise ValueError(f"min_rank must be >= 1, got {self.min_rank}")

    @property
    def active(self) -> bool:
        return self.policy != "none"


def schedule_from_config(lrd) -> RankSchedule:
    """The schedule of an ``LRDConfig`` (``lrd.rank_schedule`` etc.)."""
    return RankSchedule(policy=lrd.rank_schedule, decay=lrd.rank_decay,
                        energy_threshold=lrd.rank_energy_threshold, min_rank=lrd.rank_min,
                        tile=lrd.rank_schedule_tile, start_boundary=lrd.rank_schedule_start)


def live_rank_map(params: Any) -> Dict[str, int]:
    """``{group_path: current rank}`` for every SVD factor group (the
    trailing dim of ``u``): the map a checkpoint's manifest keeps."""
    return {path: int(g["u"].shape[-1]) for path, g in iter_factor_groups(params)}


def _quantized(schedule: RankSchedule, target: int, current: int) -> int:
    t = rank_opt.quantize_rank(max(int(target), 1), tile=schedule.tile,
                               mode=schedule.quantize_mode)
    return min(max(schedule.min_rank, t), current)


def _decay_target(schedule: RankSchedule, rank: int) -> int:
    return _quantized(schedule, math.floor(rank * schedule.decay), rank)


def _energy_target(schedule: RankSchedule, u: torch.Tensor, v: torch.Tensor) -> int:
    rank = int(u.shape[-1])
    s = svd.product_singular_values(u, v).double().cpu()
    s2 = s.reshape(-1, s.shape[-1]) ** 2  # (stack, r)
    frac = torch.cumsum(s2, dim=-1) / torch.clamp(s2.sum(dim=-1, keepdim=True), min=1e-30)
    # the smallest r' keeping >= threshold of the mass, max over stacked
    # layers; a row that never reaches the threshold (roundoff near 1.0)
    # keeps its full rank
    hit = frac >= schedule.energy_threshold
    per_row = torch.where(hit.any(dim=-1), hit.int().argmax(dim=-1) + 1,
                          torch.full_like(hit[:, 0], rank, dtype=torch.long))
    return _quantized(schedule, int(per_row.max()), rank)


def plan_rank_map(params: Any, schedule: RankSchedule,
                  boundary: Optional[int] = None) -> Dict[str, int]:
    """``{group_path: new_rank}`` for the groups the schedule truncates now.

    Only strictly shrinking entries appear; an inactive schedule or a
    boundary before ``start_boundary`` plans nothing.  Targets are relative
    to the LIVE ranks, so the plan composes across resumes.
    """
    if not schedule.active:
        return {}
    if boundary is not None and boundary < schedule.start_boundary:
        return {}
    plan: Dict[str, int] = {}
    for path, g in iter_factor_groups(params):
        rank = int(g["u"].shape[-1])
        if schedule.policy == "decay":
            target = _decay_target(schedule, rank)
        else:
            target = _energy_target(schedule, g["u"], g["v"])
        if target < rank:
            plan[path] = target
    return plan


def truncate_params(params: Any, rank_map: Dict[str, int], *,
                    balance: str = "balanced") -> Any:
    """Eckart–Young-truncate every planned factor group to its new rank.

    ``svd.truncate_factors`` rewrites the (u, v) pair jointly, on the
    factors' device, so BOTH factors are fresh tensors: the caller
    re-partitions both.
    """

    def rewrite(path, group):
        rank = rank_map.get(path)
        if rank is None or rank >= group["u"].shape[-1]:
            return group
        out = dict(group)
        out["u"], out["v"] = svd.truncate_factors(group["u"], group["v"], int(rank),
                                                  balance=balance)
        return out

    return map_factor_groups(params, rewrite)


def slice_tree(tree: Any, rank_map: Dict[str, int]) -> Any:
    """Cut the rank dims of a params-shaped tree (optimizer moments, live on
    the device or parked on the CPU) to the map's ranks.

    The rank axis per factor leaf comes from ``freezing.factor_rank_axis``
    (u: last, v: second-to-last); ``bias`` and non-factor leaves pass
    through, as do ``None`` partition holes.  A cut leaf is a contiguous
    copy, not a view of the untruncated storage.
    """

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in t.items()}
        if t is None:
            return None
        parent, _, name = path.rpartition("/")
        rank = rank_map.get(parent)
        axis = freezing.factor_rank_axis(name)
        if rank is None or axis is None:
            return t
        cut = t[..., :int(rank)] if axis == -1 else t[..., :int(rank), :]
        return cut.clone(memory_format=torch.contiguous_format)

    return walk(tree, "")


def slice_moments(moments: Tuple[Any, Any],
                  rank_map: Dict[str, int]) -> Tuple[Any, Any]:
    """Cut full ``(mu, nu)`` moment trees to the new ranks (``nu`` is ``()``
    for SGD and passes through)."""
    mu, nu = moments
    return slice_tree(mu, rank_map), (nu if nu == () else slice_tree(nu, rank_map))


def decay_rank_maps(params: Any, schedule: RankSchedule,
                    boundaries: int) -> List[Dict[str, int]]:
    """The decay policy's full rank map after each of the first
    ``boundaries`` phase swaps, from the shapes alone.  The energy policy
    reads trained spectra and has no such trajectory."""
    current = live_rank_map(params)
    maps: List[Dict[str, int]] = []
    for b in range(1, boundaries + 1):
        if schedule.active and b >= schedule.start_boundary:
            current = {p: _decay_target(schedule, r) for p, r in current.items()}
        maps.append(dict(current))
    return maps
