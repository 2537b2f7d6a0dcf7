"""Roofline report over the port's dry-run cells — the counterpart of
``repro/analysis/report.py``.

Reads ``runs/dryrun_torch/*.json`` (``launch/dryrun.py``), whose
``step_cost`` is the counted step (there is no HLO file), and renders the
reference's table against ``roofline.H100_SPECS``.  The reference's
adjusted memory term drops convert-only fusions (XLA:CPU materialises
float32 copies of bf16 dot operands); the port's drops the bytes of its
dtype casts (``aten._to_copy``), which in the port are the float32
widening around its library products.

    PYTHONPATH=src python -m repro_torch.analysis.report [--dir runs/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.analysis.cost import StepCost
from repro_torch.analysis.roofline import (H100_SPECS, ChipSpecs,
                                           model_flops_per_device, roofline_terms)
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import DEFAULT_OUT, MESH_TAG

__all__ = ["analyze_cell", "build_report", "to_markdown", "main"]

# the bytes the adjusted memory term drops: dtype casts
CAST_OP = "_to_copy"


def analyze_cell(rec: dict, *, specs: ChipSpecs = H100_SPECS) -> dict:
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    devices = rec["devices"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        kind = "train"
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        kind = "infer"
    else:  # decode: one new token per sequence
        tokens = shape.global_batch
        kind = "infer"
    mf = model_flops_per_device(cfg.active_params(), tokens, devices, kind=kind)
    cost = StepCost.from_json(rec["step_cost"])
    rl = roofline_terms(cost, model_flops=mf, specs=specs)
    casts = cost.bytes_by_op.get(CAST_OP, 0.0)
    mem_adj = (cost.bytes - casts) / specs.hbm_bw
    step_adj = max(rl.compute_s, mem_adj, rl.collective_s)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "variant": rec["variant"],
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
        "memory_adj_s": mem_adj,
        "collective_s": rl.collective_s,
        "dominant": rl.dominant,
        "model_flops_per_dev": mf,
        "hlo_flops_per_dev": rl.hlo_flops,
        "useful_ratio": rl.useful_ratio,
        "roofline_fraction": rl.roofline_fraction,
        "roofline_fraction_adj": (mf / specs.peak_flops) / step_adj if step_adj else 0.0,
        "step_lower_bound_s": rl.step_s,
        "collective_breakdown": rl.collective_breakdown,
        "memory_per_device_gib": rec["memory_per_device"]["argument_bytes"] / 2 ** 30
        + rec["memory_per_device"]["temp_bytes"] / 2 ** 30,
    }


_IMPROVE_HINTS = {
    "compute": "cut non-useful FLOPs (float32 widening of library products, remat "
               "recompute, masked attention blocks)",
    "memory": "shrink per-step HBM traffic (fuse elementwise work, bf16 products with "
              "float32 accumulation, larger microbatch compute density)",
    "collective": "reshard to cut gathers (queue 1 item 8)",
}


def build_report(dir_: Path, out_json: Path | None = None, *,
                 specs: ChipSpecs = H100_SPECS):
    rows = []
    for jf in sorted(dir_.glob(f"*__{MESH_TAG}__*.json")):
        rec = json.loads(jf.read_text())
        if rec.get("status") != "ok" or "step_cost" not in rec:
            continue
        rows.append(analyze_cell(rec, specs=specs))
    if out_json:
        out_json.parent.mkdir(parents=True, exist_ok=True)
        out_json.write_text(json.dumps(rows, indent=1))
    return rows


def to_markdown(rows) -> str:
    hdr = ("| arch | shape | variant | compute_s | memory_s | coll_s | "
           "dominant | MODEL/HLO | frac | frac(adj) | GiB/dev | next lever |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["variant"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['variant']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} | {r['collective_s']:.3e} "
            f"| **{r['dominant']}** | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} | {r['roofline_fraction_adj']:.3f} "
            f"| {r['memory_per_device_gib']:.1f} "
            f"| {_IMPROVE_HINTS[r['dominant']]} |")
    return hdr + "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(DEFAULT_OUT))
    ap.add_argument("--json", default="runs/roofline_torch.json")
    args = ap.parse_args(argv)
    rows = build_report(Path(args.dir), Path(args.json))
    print(to_markdown(rows))
    print(f"\n{len(rows)} cells analyzed ({H100_SPECS.name}) -> {args.json}")
    return rows


if __name__ == "__main__":
    main()
