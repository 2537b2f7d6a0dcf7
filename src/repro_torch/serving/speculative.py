"""Self-speculative decoding from rank-truncated drafts — the counterpart of
``repro/serving/speculative.py``.

The draft is the served model with its LRD factors truncated further by
Eckart–Young (``core.svd.truncate_factors``): no second checkpoint.  This
module derives it and holds the host-side acceptance rule; the scheduler
(``serving/scheduler.py``) runs both:

* **draft**: k one-token decode steps with the draft params, writing draft
  KV into the same paged cache the full model uses;
* **verify**: one chunked full-model forward over the pending token and the
  k draft tokens, overwriting the draft KV with the full model's;
* **accept**: the longest prefix of draft tokens that match the full
  model's greedy choices, plus the full model's own next token, so every
  emitted token is the one plain greedy decode would emit.  The rejected
  tail's KV is masked by the live length and overwritten later.

Draft ranks come from Algorithm 1's sweep (``core.rank_opt.optimize_rank``,
on the v5e model's tile as in the reference): ``fraction`` of the sweep's
rank, snapped to the tile.  Groups already at or below their target rank
are shared with the full model by identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import rank_opt, svd
from repro_torch.core.decompose import iter_factor_groups, map_factor_groups

__all__ = ["DraftReport", "draft_rank_map", "make_draft_params", "accept_lengths"]


@dataclasses.dataclass
class DraftReport:
    """Per-group outcome of the draft derivation."""

    #: path -> (full rank, draft rank); equal means the group is shared.
    layers: Dict[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)

    @property
    def truncated(self) -> int:
        return sum(1 for r, d in self.layers.values() if d < r)

    @property
    def shared(self) -> int:
        return sum(1 for r, d in self.layers.values() if d >= r)

    def summary(self) -> str:
        return (f"draft: {len(self.layers)} factor groups — "
                f"{self.truncated} truncated, {self.shared} shared "
                f"with the full model")


def draft_rank_map(params: Any, *, rank: Optional[int] = None, fraction: float = 0.5,
                   backend: str = "analytic-tpu",
                   hw: rank_opt.HardwareModel = rank_opt.TPU_V5E,
                   probe_tokens: int = 8, quantize_mode: str = "floor") -> Dict[str, int]:
    """Target draft ranks for every SVD factor group of ``params`` (only
    the factors' shapes are read, so a tree on the meta device will do).

    ``rank`` clamps every group to ``min(rank, live_rank)``.  Without it,
    each distinct (C, S, r) geometry runs the Algorithm-1 sweep once and
    takes ``fraction`` of its rank, snapped to ``hw``'s tile.
    """
    out: Dict[str, int] = {}
    cache: Dict[Tuple[int, int, int], int] = {}
    for path, group in iter_factor_groups(params):
        u = group["u"]
        c, r_live = int(u.shape[-2]), int(u.shape[-1])
        s = int(group["v"].shape[-1])
        if rank is not None:
            out[path] = max(1, min(int(rank), r_live))
            continue
        key = (c, s, r_live)
        if key not in cache:
            alpha = svd.svd_compression_ratio(c, s, r_live)
            dec = rank_opt.optimize_rank(c, s, alpha=alpha, m=probe_tokens,
                                         backend=backend, hw=hw)
            target = max(1, int(dec.rank * fraction))
            target = rank_opt.quantize_rank(target, tile=hw.mxu_tile, mode=quantize_mode)
            cache[key] = max(1, min(target, r_live))
        out[path] = cache[key]
    return out


def make_draft_params(params: Any, rank_map: Dict[str, int]) -> Tuple[Any, DraftReport]:
    """The draft param tree: each factor group truncated to ``rank_map``'s
    target (the QR-reduced Eckart–Young optimum, right for fine-tuned
    factors too).  Everything else — embeddings, norms, merged dense
    kernels, int8 export leaves — and every group already at or below its
    target is the full model's own tensor, not a copy."""
    report = DraftReport()

    def rewrite(path: str, group: Dict[str, Any]) -> Dict[str, Any]:
        u, v = group["u"], group["v"]
        r_live = int(u.shape[-1])
        target = rank_map.get(path, r_live)
        report.layers[path] = (r_live, min(target, r_live))
        if target >= r_live:
            return group  # shared: the full model's tensors
        u2, v2 = svd.truncate_factors(u, v, target)
        return dict(group, u=u2.contiguous(), v=v2.contiguous())

    return map_factor_groups(params, rewrite), report


def accept_lengths(chunk: np.ndarray, verify: np.ndarray) -> np.ndarray:
    """Per-row accepted-prefix lengths.

    ``chunk`` (B, k+1): the pending token t0 and draft tokens t1..tk.
    ``verify`` (B, k+1): the full model's greedy next token after each
    chunk position.  Row b accepts the longest n with t_{j+1} ==
    verify[b, j] for j < n; it then emits t1..tn and verify[b, n].
    """
    chunk = np.asarray(chunk)
    verify = np.asarray(verify)
    match = chunk[:, 1:] == verify[:, :-1]  # (B, k)
    if match.shape[1] == 0:
        return np.zeros((chunk.shape[0],), np.int64)
    return np.where(match.all(axis=1), match.shape[1], np.argmin(match, axis=1))
