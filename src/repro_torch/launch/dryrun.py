"""Dry-run on the meta device: build one (arch x shape) cell of the port
with no allocation and no kernel launch, run its step on meta tensors, and
record its memory and cost — the counterpart of ``repro/launch/dryrun.py``
on one device.

The reference lowers and compiles each cell for a forced 512-device host
platform and reads XLA's memory and cost analyses and the post-SPMD HLO.
The port has no compiler and no mesh yet (queue 1 item 8), so a cell here
is the step itself, run eagerly on ``torch.device("meta")``:

* argument and output bytes are the meta trees' (``steps.abstract_state``,
  ``abstract_params``, ``abstract_cache``, ``batch_specs``); the alias
  bytes are the outputs that are arguments updated in place (the train
  step's donated state, the decode step's cache);
* temp bytes are the peak of the bytes the step allocated and held at
  once, tracked by storage while it runs (``cost.StepCost.peak_bytes``);
* the cost is ``analysis.cost``'s count of the same run: every aten op,
  and each hand-written kernel priced at its shapes (the wrappers price a
  call on meta instead of launching it), stored in the cell as
  ``step_cost``: there is no HLO file.

Each shape's choices are the reference's with one data-parallel way:
remat ``sqrt`` for training, microbatches auto-sized to keep the remat
stash near 2 GiB, AdamW over 5e9 params (SGD with momentum below), bf16
moments and accumulators over 100e9.  The kernels are on (the port's
main path).  ``--multi-pod``, ``--fsdp`` and ``--grad-compression int8``
are refused: they are queue 1 item 8.  One cell per process keeps runs
apart; ``--all`` runs every cell in a subprocess with a JSON resume cache.

    python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
    python -m repro_torch.launch.dryrun --all [--out runs/dryrun_torch]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

__all__ = ["DEFAULT_OUT", "MESH_TAG", "build_cell", "train_fn", "cell", "measure_cell",
           "rank_adaptation_trajectory", "run_cell", "all_cells", "orchestrate", "main"]

DEFAULT_OUT = Path("runs/dryrun_torch")
# the cells' mesh: one device (the reference's are "singlepod" / "multipod")
MESH_TAG = "1gpu"
ITEM_8 = "ROADMAP queue 1 item 8, distributed"


def _refuse(multi_pod: bool, fsdp: bool, grad_compression: str) -> None:
    for flag, asked in (("--multi-pod", multi_pod), ("--fsdp", fsdp),
                        ("--grad-compression int8", grad_compression != "none")):
        if asked:
            raise SystemExit(f"dryrun: {flag} needs a mesh of devices, which the port does "
                             f"not have yet ({ITEM_8})")


def build_cell(arch: str, shape, *, lrd: bool = True,
               freeze: bool = True, remat: str = "sqrt", microbatches: int = 0,
               capacity_factor: float = 0.0, attn_blocks: str = "", kv_int8: bool = False,
               rank_schedule: str = "none", rank_decay: float = 0.75,
               rank_quantize: bool = True, phase: Optional[int] = None,
               multi_pod: bool = False, fsdp: bool = False,
               grad_compression: str = "none"):
    """``(fn, args, run, donate)`` of one cell: ``fn(*args)`` is its step
    on meta stand-ins, ``donate`` the positions of the arguments it updates
    in place.  ``shape`` is a ``SHAPES`` name or a ``ShapeConfig``;
    ``phase`` the train step's freezing phase (default: 0 with ``freeze``,
    else -1)."""
    from repro_torch.configs import SHAPES, get_config, skip_reason
    from repro_torch.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig

    _refuse(multi_pod, fsdp, grad_compression)
    if isinstance(shape, str):
        reason = skip_reason(arch, shape)
        if reason:
            raise SystemExit(f"SKIP: {reason}")
        shape = SHAPES[shape]
    cfg = get_config(arch)
    if capacity_factor:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    if attn_blocks:
        bq, bkv = (int(x) for x in attn_blocks.split(","))
        cfg = dataclasses.replace(cfg, attention_block_q=bq, attention_block_kv=bkv)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if microbatches == 0:  # auto: keep the remat stash (L * tokens * d) near 2 GiB
        microbatches = 1
        if shape.kind == "train":
            stash = cfg.num_layers * shape.global_batch * shape.seq_len * cfg.d_model * 2
            while (stash / microbatches > 2 * 2 ** 30
                   and shape.global_batch % (microbatches * 2) == 0):
                microbatches *= 2
    big = cfg.num_params() > 100e9
    run = RunConfig(
        model=cfg, shape=shape,
        lrd=LRDConfig(enabled=lrd, alpha=2.0, rank_quantize=rank_quantize,
                      freeze_mode="sequential" if freeze else "none",
                      use_pallas_kernel=True, rank_schedule=rank_schedule,
                      rank_decay=rank_decay),
        dist=DistConfig(fsdp=False, remat=remat if shape.kind == "train" else "none",
                        microbatches=microbatches,
                        accum_dtype="bfloat16" if big else "float32"),
        optim=OptimConfig(name="adamw" if cfg.num_params() > 5e9 else "sgdm",
                          state_dtype="bfloat16" if big else "float32"))
    fn, args, donate = cell(run, phase)
    return fn, args, run, donate


def train_fn(run, phase: int, device="meta"):
    """The cell's train step at ``phase`` on ``device``: the train CLI's
    (donated state), so a count on meta and one on the card run the same
    step."""
    from repro_torch.launch import steps

    return functools.partial(steps.build_train_step(run, device=device, donate=True),
                             phase=phase)


def cell(run, phase: Optional[int] = None):
    """``(fn, args, donate)`` of ``run``'s step on meta stand-ins (train at
    ``phase``, default: 0 with sequential freezing, else -1; prefill; or
    one decode step against the fixed-batch cache)."""
    from repro_torch.launch import steps

    shape = run.shape
    if shape.kind == "train":
        if phase is None:
            phase = 0 if run.lrd.enabled and run.lrd.freeze_mode == "sequential" else -1
        return (train_fn(run, phase),
                (steps.abstract_state(run, phase=phase), steps.batch_specs(run)), (0,))
    if shape.kind == "prefill":
        return steps.build_prefill_step(run), (steps.abstract_params(run),
                                               steps.batch_specs(run)), ()
    b = shape.global_batch
    token = torch.empty((b, 1), dtype=torch.int32, device=steps.META)
    pos = torch.empty((), dtype=torch.int32, device=steps.META)
    return (steps.build_serve_step(run),
            (steps.abstract_params(run), steps.abstract_cache(run), token, pos), (1,))


def _leaves(tree):
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def rank_adaptation_trajectory(run, boundaries: int) -> list:
    """Per-boundary structural bytes of an in-training rank schedule: the
    live trainable, frozen and optimizer stand-in bytes of the meta state
    after each phase swap, under the decay trajectory
    (``rank_adapt.decay_rank_maps``; the energy policy has no analytic
    trajectory and is priced with the same decay estimate)."""
    from repro_torch.core import rank_adapt
    from repro_torch.launch import steps

    schedule = rank_adapt.schedule_from_config(run.lrd)
    params = steps.abstract_params(run)
    maps = [None] + rank_adapt.decay_rank_maps(params, schedule, boundaries)
    rows = []
    for b, rmap in enumerate(maps):
        phase = b % 2  # sequential alternation starts at phase 0
        a = steps.abstract_state(run, phase=phase, rank_map=rmap)
        opt_bytes = _tree_bytes(a.opt.mu) + _tree_bytes(a.opt.nu)
        rmap_now = rmap if rmap is not None else rank_adapt.live_rank_map(params)
        rows.append({
            "boundary": b,
            "phase": phase,
            "total_rank": int(sum(rmap_now.values())),
            "trainable_param_bytes": _tree_bytes(a.trainable),
            "frozen_param_bytes": _tree_bytes(a.frozen),
            "opt_bytes": opt_bytes,
            "trainable_partition_bytes": _tree_bytes(a.trainable) + opt_bytes,
        })
    return rows


def measure_cell(fn, args, donate=()) -> dict:
    """Memory and cost of one run of ``fn(*args)``: ``memory_per_device``,
    ``cost_analysis_per_device`` and the :class:`cost.StepCost`."""
    from repro_torch.analysis.cost import counting

    ins = {id(t.untyped_storage()) for i in donate for t in _leaves(args[i])}
    with counting() as cost:
        out = fn(*args)
    outs = _leaves(out)
    arg_bytes, out_bytes = _tree_bytes(args), _tree_bytes(outs)
    return {
        "memory_per_device": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": cost.peak_bytes,
            "alias_bytes": sum(t.numel() * t.element_size() for t in outs
                               if id(t.untyped_storage()) in ins),
            "total_bytes": arg_bytes + cost.peak_bytes + out_bytes,
        },
        "cost_analysis_per_device": {
            "flops": float(cost.flops),
            "bytes_accessed": float(cost.bytes),
            "transcendentals": float(cost.transcendental_elems),
        },
        "step_cost": cost.to_json(),
    }


def run_cell(arch: str, shape_name: str, *, lrd: bool = True, freeze: bool = True,
             out_dir: Path = DEFAULT_OUT, tag: str = "", rank_boundaries: int = 4,
             **build_kw) -> dict:
    """Build, run and record one cell; writes ``<out_dir>/<stem>.json``
    with the reference's schema (``seconds.lower`` is the meta run, there
    being nothing to lower, and ``compile`` 0)."""
    t0 = time.time()
    fn, args, run, donate = build_cell(arch, shape_name, lrd=lrd, freeze=freeze, **build_kw)
    t_build = time.time() - t0
    t0 = time.time()
    measured = measure_cell(fn, args, donate)
    t_run = time.time() - t0
    variant = ("lrd" if lrd else "dense") + (tag and f"-{tag}" or "")
    result = {
        "arch": arch, "shape": shape_name, "mesh": MESH_TAG, "variant": variant,
        "devices": 1,
        "status": "ok",
        "seconds": {"build": round(t_build, 2), "lower": round(t_run, 2), "compile": 0.0},
        **measured,
        # one device: no collectives (queue 1 item 8)
        "collective_bytes_per_device": {},
    }
    if run.lrd.rank_schedule != "none" and run.shape.kind == "train" and rank_boundaries > 0:
        result["rank_adaptation"] = rank_adaptation_trajectory(run, rank_boundaries)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{arch}__{shape_name}__{MESH_TAG}__{variant}"
    (out_dir / f"{stem}.json").write_text(json.dumps(result, indent=1))
    return result


def all_cells():
    from repro_torch.configs import SHAPES, skip_reason
    from repro_torch.configs.archs import ARCHS
    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape, skip_reason(arch, shape)


def orchestrate(out_dir: Path, *, lrd: bool = True, force: bool = False,
                timeout_s: int = 2400):
    """Run every cell in a subprocess of its own, with a resume cache."""
    import subprocess

    results = []
    for arch, shape, reason in all_cells():
        variant = "lrd" if lrd else "dense"
        stem = f"{arch}__{shape}__{MESH_TAG}__{variant}"
        cache = out_dir / f"{stem}.json"
        if reason:
            out_dir.mkdir(parents=True, exist_ok=True)
            rec = {"arch": arch, "shape": shape, "mesh": MESH_TAG, "variant": variant,
                   "status": "skip", "reason": reason}
            cache.write_text(json.dumps(rec, indent=1))
            results.append(rec)
            continue
        if cache.exists() and not force:
            rec = json.loads(cache.read_text())
            if rec.get("status") == "ok":
                results.append(rec)
                print(f"[cache] {stem}")
                continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", str(out_dir)]
        if not lrd:
            cmd.append("--dense")
        print(f"[run  ] {stem} ...", flush=True)
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s)
        dt = time.time() - t0
        if proc.returncode != 0:
            rec = {"arch": arch, "shape": shape, "mesh": MESH_TAG, "variant": variant,
                   "status": "fail", "stderr": proc.stderr[-4000:], "seconds": round(dt, 1)}
            cache.write_text(json.dumps(rec, indent=1))
            print(f"[FAIL ] {stem} ({dt:.0f}s)\n{proc.stderr[-1500:]}")
        else:
            rec = json.loads(cache.read_text())
            print(f"[ok   ] {stem} ({dt:.0f}s)")
        results.append(rec)
    ok = sum(1 for r in results if r["status"] == "ok")
    skip = sum(1 for r in results if r["status"] == "skip")
    fail = sum(1 for r in results if r["status"] == "fail")
    print(f"\ndry-run complete: {ok} ok, {skip} skip, {fail} fail / {len(results)} cells")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true", help=f"refused ({ITEM_8})")
    ap.add_argument("--dense", action="store_true", help="disable LRD (baseline)")
    ap.add_argument("--no-freeze", action="store_true")
    ap.add_argument("--fsdp", action="store_true", help=f"refused ({ITEM_8})")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="accepted: one device holds every param")
    ap.add_argument("--remat", default="sqrt", choices=["none", "full", "dots", "sqrt"])
    ap.add_argument("--microbatches", type=int, default=0, help="0 = auto")
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8"],
                    help=f"int8 is refused ({ITEM_8})")
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--attn-blocks", default="", help="bq,bkv override")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--rank-schedule", default="none", choices=["none", "decay", "energy"],
                    help="price an in-training rank schedule (per-boundary shrinking-bytes "
                         "trajectory in the cell JSON)")
    ap.add_argument("--rank-decay", type=float, default=0.75)
    ap.add_argument("--rank-boundaries", type=int, default=4,
                    help="phase swaps to price in the trajectory")
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    _refuse(args.multi_pod, args.fsdp, args.grad_compression)
    out = Path(args.out)
    if args.all:
        orchestrate(out, lrd=not args.dense, force=args.force)
        return None
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    try:
        res = run_cell(args.arch, args.shape, lrd=not args.dense, freeze=not args.no_freeze,
                       out_dir=out, tag=args.tag, remat=args.remat,
                       microbatches=args.microbatches, capacity_factor=args.capacity_factor,
                       attn_blocks=args.attn_blocks, kv_int8=args.kv_int8,
                       rank_schedule=args.rank_schedule, rank_decay=args.rank_decay,
                       rank_boundaries=args.rank_boundaries)
    except SystemExit as e:
        print(e)
        return None
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    mem = res["memory_per_device"]
    print(json.dumps({k: v for k, v in res.items() if k != "step_cost"}, indent=1))
    print(f"\n{res['arch']} {res['shape']} {res['mesh']} [{res['variant']}]: "
          f"per-device {mem['total_bytes'] / 2 ** 30:.2f} GiB "
          f"(args {mem['argument_bytes'] / 2 ** 30:.2f} + temp "
          f"{mem['temp_bytes'] / 2 ** 30:.2f}), "
          f"flops/dev {res['cost_analysis_per_device']['flops']:.3e}")
    return res


if __name__ == "__main__":
    main()
