"""Training CLI: sequential freezing (Algorithm 2) on one device.

The PyTorch counterpart of ``repro.launch.train`` with the same flags plus
``--device {cuda,cpu}`` (default ``cuda``; raises without a GPU).
``--use-pallas`` turns the hand-written CUDA kernels on (the flag keeps the
JAX name): every factorised projection then runs K1/K5 forward and K2-K4
backward, with the frozen factor's gradient kernel never launched.  With
``--lrd`` the ranks come from Algorithm 1 (``core.rank_opt``, the
analytic backend, as in the JAX CLI) unless ``--no-rank-opt`` asks for the
Eq.-5 ranks; Algorithm 1's guard keeps a layer dense when its
decomposition would be no faster.

The loop trains on the synthetic LM stream (``data.synthetic``), swaps the
freezing phase every ``--epochs-per-phase`` epochs of ``--steps-per-epoch``
steps (``steps.repartition_state`` rotates the optimizer moments, parking
the frozen group's on the CPU), saves in the JAX package's checkpoint
format every ``--save-every`` steps and on SIGTERM, and resumes from the
newest complete checkpoint in ``--ckpt-dir/<model name>``, whichever
package wrote it.  ``--rank-schedule decay|energy`` shrinks the ranks at
every phase swap (``core.rank_adapt``; a ``[rank-adapt]`` line names the
groups, ``old->new``); the checkpoint keeps the rank map, and a resume
continues at the saved ranks.  Flags of features this port does not have
yet are rejected, not ignored.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --lrd --no-rank-opt --use-pallas --freeze sequential --steps 6 \\
      --steps-per-epoch 2 --global-batch 8 --seq-len 256 [--rank-schedule decay]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, pack_phased_state, unpack_phased_state
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro_torch.core import rank_adapt
from repro_torch.core.freezing import tree_map
from repro_torch.data import LMBatchIterator
from repro_torch.launch import steps as steps_mod
from repro_torch.optim.optimizers import OptState

__all__ = ["StragglerMonitor", "build_run", "main"]

# flag -> (its value when off, the ROADMAP item that brings it)
_UNPORTED_FLAGS = {
    "mesh": ("host", "ROADMAP queue 1 item 8, distributed"),
    "fsdp": (False, "ROADMAP queue 1 item 8, distributed"),
    "grad_compression": ("none", "ROADMAP queue 1 item 8, distributed"),
    "remat": ("none", "ROADMAP queue 1 item 11, activation checkpointing"),
    "obs": (False, "ROADMAP queue 1 item 9, telemetry"),
    "obs_dir": ("", "ROADMAP queue 1 item 9, telemetry"),
    "log_format": ("text", "ROADMAP queue 1 item 9, telemetry"),
    "obs_step_every": (1, "ROADMAP queue 1 item 9, telemetry"),
    "profile_steps": ("", "ROADMAP queue 1 item 9, telemetry"),
    "pallas_interpret": (False, "the CUDA kernels have no interpret mode; "
                                "--device cpu runs their plain versions (ROADMAP, "
                                "port conventions)"),
}


class StragglerMonitor:
    """Flags steps slower than twice the median of the last 32 step times."""

    FACTOR = 2.0
    WINDOW = 32

    def __init__(self):
        self.times: list = []
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        self.times = (self.times + [dt])[-self.WINDOW:]
        if len(self.times) < 8:
            return False
        if dt > self.FACTOR * float(np.median(self.times)):
            self.flagged += 1
            return True
        return False


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--steps-per-epoch", type=int, default=25)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lrd", action="store_true")
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--no-rank-opt", action="store_true")
    ap.add_argument("--lrd-min-dim", type=int, default=128)
    ap.add_argument("--freeze", default="none", choices=["none", "regular", "sequential"])
    ap.add_argument("--epochs-per-phase", type=int, default=1,
                    help="Algorithm-2 alternation cadence (sequential)")
    ap.add_argument("--rank-schedule", default="none", choices=["none", "decay", "energy"],
                    help="in-training rank adaptation at phase boundaries "
                         "(needs --freeze sequential)")
    ap.add_argument("--rank-decay", type=float, default=0.75,
                    help="per-boundary rank multiplier (decay policy)")
    ap.add_argument("--rank-energy", type=float, default=0.98,
                    help="kept singular-value mass (energy policy)")
    ap.add_argument("--rank-min", type=int, default=2,
                    help="scheduled ranks never drop below this")
    ap.add_argument("--use-pallas", action="store_true",
                    help="hand-written CUDA kernels, forward and backward")
    ap.add_argument("--optimizer", default="sgdm", choices=["sgdm", "adamw"])
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="runs/train_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    # the JAX CLI's flags for features not ported yet: rejected when set
    ap.add_argument("--pallas-interpret", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots", "sqrt"])
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8"])
    ap.add_argument("--mesh", default="host", choices=["host", "production"])
    ap.add_argument("--mesh-data", type=int, default=0)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--obs", action="store_true")
    ap.add_argument("--obs-dir", default="")
    ap.add_argument("--log-format", default="text", choices=["text", "jsonl"])
    ap.add_argument("--obs-step-every", type=int, default=1)
    ap.add_argument("--profile-steps", default="")
    return ap


def build_run(args) -> RunConfig:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    return RunConfig(
        model=cfg,
        shape=ShapeConfig("custom", args.seq_len, args.global_batch, "train"),
        lrd=LRDConfig(enabled=args.lrd, alpha=args.alpha, rank_quantize=not args.no_rank_opt,
                      freeze_mode=args.freeze, min_dim=args.lrd_min_dim,
                      epochs_per_phase=args.epochs_per_phase,
                      use_pallas_kernel=args.use_pallas, rank_schedule=args.rank_schedule,
                      rank_decay=args.rank_decay, rank_energy_threshold=args.rank_energy,
                      rank_min=args.rank_min),
        dist=DistConfig(fsdp=False, remat="none", microbatches=args.microbatches),
        optim=OptimConfig(name=args.optimizer, lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps),
        seed=args.seed,
    )


def main(argv=None, *, on_step=None):
    """Run the CLI; returns ``(state, losses)``.

    ``on_step(step, phase, metrics)``, if given, is called after every step
    with the step's float ``loss``, ``grad_norm`` and ``step_time_s``, the
    state's ``trainable_bytes`` / ``frozen_bytes`` / ``opt_bytes``
    (``steps.partition_bytes``) and its ``rank_map``."""
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, (off, item) in _UNPORTED_FLAGS.items():
        if getattr(args, flag) != off:
            ap.error(f"--{flag.replace('_', '-')} is not ported to the PyTorch package "
                     f"yet ({item})")
    if args.mesh_data > 1 or args.mesh_model > 1:
        ap.error("--mesh-data/--mesh-model > 1: the PyTorch package trains on one "
                 "device (ROADMAP queue 1 item 8, distributed)")
    run = build_run(args)
    if run.model.family != "dense" or run.model.use_mla or run.model.use_mtp:
        ap.error(f"--arch {args.arch} ({run.model.family}) is not ported yet "
                 f"(ROADMAP queue 1 item 7, other model families)")
    device = steps_mod.resolve_device(args.device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[device] {where}")

    params, plan = steps_mod.init_params(run, device)
    if run.lrd.enabled:
        print(plan.summary())
    schedule = rank_adapt.schedule_from_config(run.lrd)
    if schedule.active and run.lrd.freeze_mode != "sequential":
        print("[rank-adapt] --rank-schedule set but freezing is not sequential: no phase "
              "boundaries, schedule never fires")

    def phase_at(step: int) -> int:
        return steps_mod.run_phase(run, step // args.steps_per_epoch)

    cur_phase = phase_at(0)
    state, parked = steps_mod.make_train_state(run.optim, params, cur_phase)
    # the state holds the leaves; keeping the init tree too would keep every
    # leaf an update or a rank truncation replaces in memory
    del params
    data = LMBatchIterator(run.model.vocab_size, run.shape.seq_len, run.shape.global_batch,
                           seed=args.seed + 17)
    mesh_info = {"axes": ["data", "model"], "shape": [1, 1]}
    ckpt = CheckpointManager(Path(args.ckpt_dir) / run.model.name, keep=3,
                             save_every=args.save_every)
    ckpt.install_sigterm_handler()
    start_step = 0
    restored = ckpt.restore() if ckpt.latest_step() is not None else None
    if restored is not None:
        saved, start_step, extra = restored
        cur_phase = int(extra.get("phase", -1))
        (tr, fr, (step_t, mu, nu)), parked_h = unpack_phased_state(
            saved, cur_phase, expect_rank_map=extra.get("rank_map"))
        to_dev = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
        state = steps_mod.TrainState(to_dev(tr), to_dev(fr),
                                     OptState(step_t.to(device), to_dev(mu), to_dev(nu)))
        parked = parked_h
        data.load_state_dict(extra["data"])
        print(f"[resume] from step {start_step} (phase {cur_phase}, saved on mesh "
              f"{extra.get('mesh', {}).get('shape', '?')} -> restored onto {where})")

    train_step = steps_mod.build_train_step(run, device)
    monitor = StragglerMonitor()
    it = iter(data)
    losses = []
    tokens_per_step = run.shape.global_batch * run.shape.seq_len
    # both change only at a phase swap
    cur_ranks = rank_adapt.live_rank_map(state.params)
    part_bytes = steps_mod.partition_bytes(state)
    for step in range(start_step, args.steps):
        epoch = step // args.steps_per_epoch
        phase = phase_at(step)
        if phase != cur_phase:
            # Algorithm-2 phase swap: repartition and rotate the moments; an
            # active rank schedule truncates the groups it plans at this swap
            boundary = epoch // max(args.epochs_per_phase, 1)
            state, parked = steps_mod.repartition_state(
                run.optim, state, parked, phase,
                schedule=schedule if schedule.active else None, boundary=boundary)
            cur_phase = phase
            print(f"[phase] epoch {epoch}: now training group {1 - phase}, group "
                  f"{phase} frozen out of the step")
            ranks_before, cur_ranks = cur_ranks, rank_adapt.live_rank_map(state.params)
            part_bytes = steps_mod.partition_bytes(state)
            shrunk = {p: f"{ranks_before[p]}->{r}" for p, r in cur_ranks.items()
                      if r != ranks_before[p]}
            if shrunk:
                print(f"[rank-adapt] boundary truncated {len(shrunk)} group(s): {shrunk}")
        batch = next(it)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, phase=phase)
        loss = float(metrics["loss"])  # synchronises with the device
        dt = time.perf_counter() - t0
        gnorm = float(metrics["grad_norm"])
        losses.append(loss)
        if on_step is not None:
            on_step(step, phase, {"loss": loss, "grad_norm": gnorm, "step_time_s": dt,
                                  **part_bytes, "rank_map": dict(cur_ranks)})
        if monitor.observe(dt):
            print(f"[straggler] step {step}: {dt * 1e3:.0f}ms "
                  f"(median {float(np.median(monitor.times)) * 1e3:.0f}ms)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} epoch {epoch:3d} phase {phase:2d} loss {loss:.4f} "
                  f"gnorm {gnorm:.3f} {dt * 1e3:.0f}ms ({tokens_per_step / dt:.0f} tok/s)")
        if ckpt.due(step + 1) and ckpt.maybe_save(
                step + 1, pack_phased_state(state, parked),
                extra={"data": data.state_dict(), "phase": phase, "mesh": mesh_info,
                       "rank_map": rank_adapt.live_rank_map(state.params)}):
            if ckpt.preempted:
                print(f"[preempt] checkpointed at step {step + 1}, exiting")
                ckpt.close()
                return state, losses
    ckpt.close()
    if losses:
        print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return state, losses


if __name__ == "__main__":
    main()
