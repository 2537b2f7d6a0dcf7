"""Serve-time export: Algorithm 1 applied to a trained param tree — the
counterpart of ``repro/serving/export.py``.

``export_for_serving`` walks every SVD factor group of the tree
(``core.decompose.map_factor_groups``) and re-runs Algorithm 1 per layer
geometry:

* sweep ``t(r)`` over ``[R_min, r_train]`` (``core.rank_opt.optimize_rank``)
  and pick the rank under the largest step-time cliff, snapped to the tile
  (``quantize_rank``);
* truncate the trained factors to that rank with the QR-reduced
  Eckart-Young truncation (``core.svd.truncate_factors``);
* apply the Algorithm-1 guard: when even the optimized rank is no faster
  than the dense layer, merge ``U @ V`` back into a dense ``kernel``
  (``core.decompose.merge_factor_group``).

``quantize_factors="int8"`` then stores every rewritten group as int8
values with per-output-column float32 scales (``u_q``/``u_scale``,
``v_q``/``v_scale``; merged groups as ``kernel_q``/``kernel_scale``), which
``models.common.linear`` consumes through K7 and K6.

Backends mirror ``core.rank_opt``: ``analytic-tpu`` (the v5e roofline
model; its times are the model's) or ``measured`` (float32 probes timed on
the device that holds the group's factors, which is the device the engine
serves from).  Sweeps run at stride 1, ranks snap down to the v5e model's
tile (``quantize_rank(mode="floor")``), as the JAX export's defaults do.
The exported tree is a plain param tree: it round-trips through
``checkpoint/store.py`` and drops into ``ServeEngine`` like any other.

Under a serving mesh of more than one rank (``mesh=``) every rank exports
its whole tree, and the ``measured`` backend times its probes on the
mesh's first rank alone and broadcasts each sweep's decision
(``collectives.broadcast_object``, path ``serve/export``), so every rank
builds the same tree; the ``analytic`` backend's decisions are the same
everywhere already.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import rank_opt, svd
from repro_torch.core.decompose import map_factor_groups, merge_factor_group
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import mesh_size
from repro_torch.kernels.int8_matmul import quantize_colwise

__all__ = ["LayerExport", "ExportReport", "export_for_serving"]


@dataclasses.dataclass
class LayerExport:
    """Algorithm-1 outcome for one served layer (or stacked layer group)."""

    path: str
    shape: Tuple[int, int]  # (C, S)
    rank_train: int
    rank_serve: int  # == rank_train when no truncation won
    merged: bool  # Algorithm-1 guard: True -> served dense
    original_time: float
    decomposed_time: float
    quantized: bool = False  # int8 factor/kernel quantization applied


@dataclasses.dataclass
class ExportReport:
    backend: str
    layers: Dict[str, LayerExport] = dataclasses.field(default_factory=dict)
    # (C, S, r_train) -> the sweep's RankDecision (searched ranks and times)
    decisions: Dict[Tuple[int, int, int], rank_opt.RankDecision] = dataclasses.field(
        default_factory=dict)

    def summary(self) -> str:
        n = len(self.layers)
        merged = sum(1 for l in self.layers.values() if l.merged)
        trunc = sum(1 for l in self.layers.values()
                    if not l.merged and l.rank_serve < l.rank_train)
        return (f"export[{self.backend}]: {n} factor groups — {merged} "
                f"merged dense (guard), {trunc} rank-truncated, "
                f"{n - merged - trunc} kept")


def _quantize_group(group: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(group)
    if "kernel" in out:
        out["kernel_q"], out["kernel_scale"] = quantize_colwise(out.pop("kernel"))
    else:
        out["u_q"], out["u_scale"] = quantize_colwise(out.pop("u"))
        out["v_q"], out["v_scale"] = quantize_colwise(out.pop("v"))
    return out


def export_for_serving(params: Any, *, backend: str = "analytic-tpu",
                       probe_tokens: int = 256, quantize_factors: Optional[str] = None,
                       mesh: Any = None) -> Tuple[Any, ExportReport]:
    """Rank-quantize a trained param tree for serving; returns
    ``(new_params, report)``.

    ``probe_tokens`` should approximate the serve step's token batch
    (num_slots for decode); the measured backend times its probes on the
    device of each group's ``u`` leaf.  Only pure ``{u, v[, bias]}`` groups
    are rewritten, and groups stacked over more than one dim (expert
    stacks) truncate but never merge.  With a ``mesh`` of more than one
    rank every rank calls it on the same whole tree, and the measured
    sweeps run on the mesh's first rank only (see the module notes).
    """
    if quantize_factors not in (None, "int8"):
        raise ValueError(f"quantize_factors must be None or 'int8', got {quantize_factors!r}")
    report = ExportReport(backend=backend)
    sharded = mesh if mesh is not None and mesh_size(mesh) > 1 else None

    def decide(c: int, s: int, r_train: int, device: torch.device) -> rank_opt.RankDecision:
        key = (c, s, r_train)  # one sweep per distinct geometry
        if key not in report.decisions:
            shared = backend == "measured" and sharded is not None
            dec = None
            if not shared or collectives.coordinate(sharded, sharded.mesh_dim_names) == 0:
                time_fn = (rank_opt.measured_linear_time_fn(c, s, m=probe_tokens, device=device)
                           if backend == "measured" else None)
                dec = rank_opt.optimize_rank(
                    c, s, alpha=svd.svd_compression_ratio(c, s, r_train), m=probe_tokens,
                    backend=backend, time_fn=time_fn)
            if shared:  # the first rank's sweep, on every rank
                dec = collectives.broadcast_object(dec, sharded, path="serve/export")
            report.decisions[key] = dec
        return report.decisions[key]

    def rewrite(path: str, group: Dict[str, Any]) -> Dict[str, Any]:
        u, v = group["u"], group["v"]
        c, r_train, s = int(u.shape[-2]), int(u.shape[-1]), int(v.shape[-1])
        dec = decide(c, s, r_train, u.device)
        r_serve = rank_opt.quantize_rank(dec.rank, tile=rank_opt.TPU_V5E.mxu_tile)
        r_serve = max(1, min(r_serve, r_train))
        merged = u.dim() <= 3 and not dec.use_decomposed
        report.layers[path] = LayerExport(
            path=path, shape=(c, s), rank_train=r_train, rank_serve=r_serve,
            merged=merged, original_time=dec.original_time,
            decomposed_time=dec.decomposed_time,
            quantized=quantize_factors is not None)
        if merged:  # Algorithm-1 guard: serve dense
            out = merge_factor_group(group)
        elif not dec.use_decomposed or r_serve >= r_train:
            out = group
        else:
            out = dict(group)
            out["u"], out["v"] = svd.truncate_factors(u, v, r_serve)
        if quantize_factors == "int8":
            out = _quantize_group(out)
        return out

    return map_factor_groups(params, rewrite), report
