"""Training CLI: sequential freezing (Algorithm 2), on one device or
sharded over the ranks of a process group.

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
continues at the saved ranks.

Sharded training, as the JAX CLI's flags ask: ``--mesh host`` (default)
builds a ``(data, model)`` mesh of ``--mesh-data`` (0 = world size //
``--mesh-model``) x ``--mesh-model`` ranks (``launch.mesh``), ``--mesh
production`` the (16, 16) one; ``--fsdp`` takes the FSDP param rules and
``--grad-compression int8`` the int8 data-parallel sync.  One process a
rank: the process group comes from ``torch.distributed.run``'s environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``--dist-init`` is the
rendezvous, ``env://`` by default), over ``--dist-backend`` (``nccl``;
``gloo`` lets ranks share a GPU, as the one-card machine needs: no backend
is ever switched on failure).  Rank r runs on ``cuda:(LOCAL_RANK % device
count)``.  With no such environment the world is one rank, and a mesh
larger than that fails with ``make_host_mesh``'s message.  Each rank draws
the same global batch and trains on its block (``steps.build_train_step(...,
mesh=)``); only rank 0 prints, writes telemetry and saves.  A checkpoint is
whole (mesh-agnostic: each save gathers the state) and records its source
mesh; a resume places it under the current mesh
(``steps.packed_state_shardings``), whatever mesh wrote it.  The sharded
path trains the dense and MoE families (expert parallelism over
``model``), on ``--microbatches`` of the global batch (a batch that does
not divide into them is refused); MTP, MLA and the int8 sync of a MoE model
are refused (``steps.check_sharded_family``, the step's builder).  ``--remat full|dots|sqrt`` checkpoints
the layer stacks' activations (``models.lm``, ``models.encdec``).  ``--arch``
takes the dense and MoE families (``olmoe-1b-7b``; ``deepseek-v3-671b``,
MLA with its MTP loss, the MTP layer's factors frozen and trained with the
rest), the SSM family
(``xlstm-350m``), the hybrid family (``zamba2-1.2b``), the enc-dec family
(``seamless-m4t-medium``), whose batches also carry stub frontend frames
(:func:`stub_frames`; the JAX CLI's carry none, so its enc-dec step
fails), and the VLM family (``llama-3.2-vision-90b``), whose batches carry
stub vision embeddings (:func:`stub_vision_embeddings`; the JAX CLI's carry
none, so its cross layers train as causal self-attention over the text);
flags of features this port does not have yet are rejected, not ignored.

Telemetry, as in the JAX CLI: every console line but the device, plan and
``done`` lines goes through an ``obs.EventLog`` mirror (``[resume]``,
``[phase]``, ``[rank-adapt]``, ``[straggler]``, the step line every
``--log-every`` steps, ``[profile]``).  ``--obs`` also writes those events
and ``run_start`` / ``run_end`` to ``events.jsonl`` in ``--obs-dir`` (the
checkpoint directory by default), a ``train_step`` record every
``--obs-step-every`` steps with the partition bytes (this rank's), the rank
map and ``sync_bytes_per_step``, the bytes of the step's collectives
(``distributed.collectives``; 0 on one device); ``--log-format jsonl``
mirrors the events themselves.  ``--profile-steps START:STOP`` runs a
``torch.profiler`` window (CUDA activity on the card) over those steps and
exports its Chrome trace to ``<obs dir>/profile/trace.json``.  The port
compiles no executable; on a mesh of more than one rank the first step of
each phase emits ``phase_compile`` with that step's sync bytes and
collectives by class, as the reference's compile does.

  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \\
      --device cpu --dist-backend gloo --mesh-data 2 --mesh-model 2 --smoke --lrd \\
      --lrd-min-dim 16 --no-rank-opt --freeze sequential --steps 4 --steps-per-epoch 2 \\
      --global-batch 8 --seq-len 16

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --lrd --no-rank-opt --use-pallas --freeze sequential --steps 6 \\
      --steps-per-epoch 2 --global-batch 8 --seq-len 256 [--rank-schedule decay]
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --lrd \\
      --no-rank-opt --use-pallas --freeze sequential --remat full
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b --lrd \\
      --no-rank-opt --use-pallas --freeze sequential --steps 6 --steps-per-epoch 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch seamless-m4t-medium --lrd \\
      --use-pallas --freeze sequential --steps 6 --steps-per-epoch 2 \\
      --global-batch 8 --seq-len 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama-3.2-vision-90b --smoke \\
      --device cpu --lrd --lrd-min-dim 16 --no-rank-opt --use-pallas --freeze sequential \\
      --steps 3 --steps-per-epoch 1 --global-batch 2 --seq-len 16
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --lrd \\
      --lrd-min-dim 16 --no-rank-opt --freeze sequential --steps 6 --steps-per-epoch 2 \\
      --global-batch 2 --seq-len 16 --obs --obs-dir runs/obs --profile-steps 2:3
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, pack_phased_state, unpack_phased_state
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import (DistConfig, LRDConfig, ObsConfig, OptimConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.core import rank_adapt
from repro_torch.core.freezing import tree_map
from repro_torch.data import LMBatchIterator
from repro_torch.distributed import collectives
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.obs import EventLog
from repro_torch.optim.optimizers import OptState

__all__ = ["StragglerMonitor", "stub_frames", "stub_vision_embeddings", "build_run", "main"]

# flag -> (its value when off, why it is refused)
_UNPORTED_FLAGS = {
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
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots", "sqrt"],
                    help="activation checkpointing of the layer stacks")
    ap.add_argument("--ckpt-dir", default="runs/train_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs", action="store_true",
                    help="write schema-versioned telemetry JSONL (events.jsonl in --obs-dir)")
    ap.add_argument("--obs-dir", default="",
                    help="telemetry directory (default: the run's checkpoint directory)")
    ap.add_argument("--log-format", default="text", choices=["text", "jsonl"],
                    help="console mirror: legacy text lines (default) or the raw JSONL events")
    ap.add_argument("--obs-step-every", type=int, default=1,
                    help="emit a train_step record every N steps")
    ap.add_argument("--profile-steps", default="",
                    help="START:STOP — torch.profiler trace window over these steps (saved "
                         "under the obs dir)")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8"])
    ap.add_argument("--mesh", default="host", choices=["host", "production"])
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="host-mesh data-parallel ways (0 = world size // --mesh-model)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="host-mesh model-parallel (TP) ways")
    ap.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                    help="process-group backend of a multi-rank run (gloo: ranks may "
                         "share a GPU, and the CPU)")
    ap.add_argument("--dist-init", default="env://",
                    help="process-group rendezvous of a multi-rank run (RANK and "
                         "WORLD_SIZE come from the environment)")
    # the JAX CLI's flags for features not ported: rejected when set
    ap.add_argument("--pallas-interpret", action="store_true")
    return ap


def _parse_profile_steps(spec: str):
    """``"START:STOP"`` -> (start, stop) step indices, or (-1, -1)."""
    if not spec:
        return -1, -1
    try:
        a, b = spec.split(":")
        start, stop = int(a), int(b)
    except ValueError:
        raise SystemExit(f"--profile-steps expects START:STOP, got {spec!r}")
    if start < 0 or stop <= start:
        raise SystemExit(f"--profile-steps needs 0 <= START < STOP, got {spec!r}")
    return start, stop


def stub_frames(run: RunConfig, seed: int, step: int) -> np.ndarray:
    """The stub audio frontend's frames of one step of an encoder-decoder
    run: (global_batch, encoder_frames, d_model) float32 draws of
    ``normal(0, 0.1)`` from a generator seeded with ``(seed, step)``, so a
    resumed run sees the same frames.  The JAX CLI's batches carry no
    frames, and its encoder-decoder step fails for want of them."""
    cfg = run.model
    rng = np.random.default_rng((seed, step))
    return rng.normal(0, 0.1, (run.shape.global_batch, cfg.encoder_frames,
                               cfg.d_model)).astype(np.float32)


def stub_vision_embeddings(run: RunConfig, seed: int, step: int) -> np.ndarray:
    """The stub vision encoder's output for one step of a VLM run:
    (global_batch, num_image_tokens, d_model) float32 draws of ``0.1 *
    standard_normal`` from a generator seeded with ``(seed, step)``, so a
    resumed run sees the same embeddings.  A departure by design: the JAX
    CLI's batches carry no vision embeddings, so its ``lm_apply`` gets None
    and every cross layer trains as causal self-attention over the text
    with its gate unused; the port's cross blocks attend to these, as the
    reference's serve path and its ``build_train_step`` do when a batch
    carries them."""
    cfg = run.model
    rng = np.random.default_rng((seed, step))
    shape = (run.shape.global_batch, cfg.num_image_tokens, cfg.d_model)
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.1)


def build_run(args) -> RunConfig:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    prof_start, prof_stop = _parse_profile_steps(args.profile_steps)
    return RunConfig(
        model=cfg,
        shape=ShapeConfig("custom", args.seq_len, args.global_batch, "train"),
        lrd=LRDConfig(enabled=args.lrd, alpha=args.alpha, rank_quantize=not args.no_rank_opt,
                      freeze_mode=args.freeze, min_dim=args.lrd_min_dim,
                      epochs_per_phase=args.epochs_per_phase,
                      use_pallas_kernel=args.use_pallas, rank_schedule=args.rank_schedule,
                      rank_decay=args.rank_decay, rank_energy_threshold=args.rank_energy,
                      rank_min=args.rank_min),
        dist=DistConfig(fsdp=args.fsdp, remat=args.remat, microbatches=args.microbatches,
                        grad_compression=args.grad_compression),
        optim=OptimConfig(name=args.optimizer, lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps),
        obs=ObsConfig(enabled=args.obs, run_dir=args.obs_dir, log_format=args.log_format,
                      step_every=args.obs_step_every, profile_start=prof_start,
                      profile_stop=prof_stop),
        seed=args.seed,
    )


class _ProfileWindow:
    """``--profile-steps``: a ``torch.profiler`` session over steps
    ``[start, stop)``, CUDA activity included on the card, whose Chrome
    trace is exported to ``<trace_dir>/trace.json`` when it ends.  A
    profiler that fails to start raises (the reference prints and trains
    on untraced)."""

    def __init__(self, start: int, stop: int, trace_dir: Path, device: torch.device):
        self.start, self.stop, self.trace_dir = start, stop, trace_dir
        self.device = device
        self._prof = None

    def before(self, step: int) -> None:
        if step == self.start and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()

    def end(self, obs: EventLog, stop_step: int) -> None:
        """Stop an open window and emit its ``profile_window``."""
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.trace_dir / "trace.json"))
        self._prof = None
        obs.emit("profile_window", start_step=self.start, stop_step=stop_step,
                 trace_dir=str(self.trace_dir))

    def after(self, obs: EventLog, step: int) -> None:
        if step + 1 >= self.stop:
            self.end(obs, step + 1)


def _start_group(args, ap):
    """The process group of a multi-rank run (``torch.distributed.run``'s
    environment), or None for one rank."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    if args.dist_backend == "nccl" and args.device != "cuda":
        ap.error("--dist-backend nccl needs --device cuda; use --dist-backend gloo on the CPU")
    return collectives.init_process_group(args.dist_backend, args.dist_init,
                                          int(os.environ["RANK"]), world)


def _device(args):
    """``cuda:(LOCAL_RANK % device count)``, set as the current device, or the CPU."""
    device = steps_mod.resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def main(argv=None, *, on_step=None):
    """Run the CLI; returns ``(state, losses)`` (on a rank outside the mesh,
    ``(None, [])``).

    ``on_step(step, phase, metrics)``, if given, is called after every step
    with the step's float ``loss``, ``grad_norm`` and ``step_time_s``, the
    state's ``trainable_bytes`` / ``frozen_bytes`` / ``opt_bytes``
    (``steps.partition_bytes``: this rank's), its ``rank_map`` and the
    step's ``sync_bytes`` and ``collectives`` (``distributed.collectives``
    records)."""
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, (off, item) in _UNPORTED_FLAGS.items():
        if getattr(args, flag) != off:
            ap.error(f"--{flag.replace('_', '-')} is not ported to the PyTorch package "
                     f"yet ({item})")
    run = build_run(args)
    if run.model.family not in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"):
        ap.error(f"--arch {args.arch} ({run.model.family}) is not trained: the port trains "
                 f"the dense, MoE, SSM, hybrid, enc-dec and VLM families")
    group = _start_group(args, ap)
    try:
        return _train(args, ap, run, on_step)
    finally:
        if group is not None:
            collectives.destroy_process_group()


def _train(args, ap, run, on_step):
    device = _device(args)
    try:
        if args.mesh == "production":
            mesh = mesh_mod.make_production_mesh()
        else:
            world = mesh_mod.world_size()
            mesh = mesh_mod.make_host_mesh(args.mesh_data or max(world // args.mesh_model, 1),
                                           args.mesh_model)
        sharded = collectives.mesh_size(mesh) > 1
        if sharded:
            steps_mod.check_sharded_family(run)
    except ValueError as e:
        ap.error(str(e))
    lead = collectives.process_rank() == 0
    if mesh.get_coordinate() is None or not (sharded or lead):
        return None, []  # a rank past the mesh idles, as a leftover device does
    say = print if lead else (lambda *a, **k: None)
    mesh_info = {"axes": list(mesh.mesh_dim_names), "shape": [int(n) for n in mesh.shape]}
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"[device] {where}")
    if sharded:
        say(f"[mesh] {dict(zip(mesh_info['axes'], mesh_info['shape']))} "
            f"({collectives.mesh_size(mesh)} device(s)), {args.dist_backend}")

    # telemetry: one events.jsonl a run with --obs, written by rank 0; the
    # console mirror prints the legacy lines either way, so --obs changes no
    # console line
    obs_dir = Path(run.obs.run_dir) if run.obs.run_dir else Path(args.ckpt_dir) / run.model.name
    if run.obs.enabled and lead:
        obs_dir.mkdir(parents=True, exist_ok=True)
    obs = EventLog(obs_dir / "events.jsonl" if run.obs.enabled and lead else None,
                   mirror=say, fmt=run.obs.log_format)

    params, plan = steps_mod.init_params(run, device)
    if run.lrd.enabled:
        say(plan.summary())
    schedule = rank_adapt.schedule_from_config(run.lrd)
    if schedule.active and run.lrd.freeze_mode != "sequential":
        say("[rank-adapt] --rank-schedule set but freezing is not sequential: no phase "
            "boundaries, schedule never fires")

    def phase_at(step: int) -> int:
        return steps_mod.run_phase(run, step // args.steps_per_epoch)

    def whole_params(state):
        return state.shapes if state.shapes is not None else state.params

    cur_phase = phase_at(0)
    if sharded:
        # each leaf this rank's block: trainable per the param rules, frozen
        # replicated over the data axes, moments over the trainable partition
        state, parked = steps_mod.make_sharded_train_state(run, params, cur_phase, mesh)
    else:
        state, parked = steps_mod.make_train_state(run.optim, params, cur_phase)
    # the state holds the leaves; keeping the init tree too would keep every
    # leaf an update or a rank truncation replaces in memory
    del params
    data = LMBatchIterator(run.model.vocab_size, run.shape.seq_len, run.shape.global_batch,
                           seed=args.seed + 17)
    ckpt = CheckpointManager(Path(args.ckpt_dir) / run.model.name, keep=3,
                             save_every=args.save_every)
    ckpt.install_sigterm_handler()
    start_step = 0
    restored = ckpt.restore() if ckpt.latest_step() is not None else None
    if restored is not None:
        saved, start_step, extra = restored
        cur_phase = int(extra.get("phase", -1))
        shapes = None
        if sharded:
            # elastic: the whole (mesh-agnostic) checkpoint placed under the
            # current mesh; parked moments stay whole on the CPU
            shapes = steps_mod.meta_like(saved["params"])
            saved = steps_mod.place_packed(
                saved, steps_mod.packed_state_shardings(run, mesh, cur_phase,
                                                        extra.get("rank_map")), device)
        (tr, fr, (step_t, mu, nu)), parked_h = unpack_phased_state(
            saved, cur_phase, expect_rank_map=None if sharded else extra.get("rank_map"))
        to_dev = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
        state = steps_mod.TrainState(to_dev(tr), to_dev(fr),
                                     OptState(step_t.to(device), to_dev(mu), to_dev(nu)), shapes)
        if sharded and extra.get("rank_map"):
            got = rank_adapt.live_rank_map(shapes)
            if got != {k: int(r) for k, r in extra["rank_map"].items()}:
                raise ValueError(f"restored factor ranks {got} disagree with the manifest's "
                                 f"{extra['rank_map']}")
        parked = parked_h
        data.load_state_dict(extra["data"])
        obs.emit("resume", step=start_step, phase=cur_phase,
                 src_mesh=extra.get("mesh", {}).get("shape", "?"), mesh=mesh_info["shape"],
                 device=where)

    obs.emit("run_start", _mirror=False, kind="train", arch=run.model.name, steps=args.steps,
             steps_per_epoch=args.steps_per_epoch, start_step=start_step, mesh=mesh_info,
             freeze_mode=run.lrd.freeze_mode, rank_schedule=run.lrd.rank_schedule,
             device=where)
    # the state is donated, as the reference's CLI donates it: the update is
    # written into its tensors, so no second copy of params and moments
    train_step = steps_mod.build_train_step(run, device, donate=True,
                                            mesh=mesh if sharded else None)
    monitor = StragglerMonitor()
    it = iter(data)
    losses = []
    tokens_per_step = run.shape.global_batch * run.shape.seq_len
    # both change only at a phase swap
    cur_ranks = rank_adapt.live_rank_map(whole_params(state))
    part_bytes = steps_mod.partition_bytes(state)
    # phases whose first step's collectives were reported (the port's
    # counterpart of the reference's one compile a phase)
    reported = set()
    window = _ProfileWindow(run.obs.profile_start, run.obs.profile_stop, obs_dir / "profile",
                            device)
    for step in range(start_step, args.steps):
        epoch = step // args.steps_per_epoch
        phase = phase_at(step)
        if phase != cur_phase:
            # Algorithm-2 phase swap: repartition and rotate the moments; an
            # active rank schedule truncates the groups it plans at this swap
            boundary = epoch // max(args.epochs_per_phase, 1)
            with obs.span("phase_swap", epoch=epoch, phase=phase, boundary=boundary):
                state, parked = steps_mod.repartition_state(
                    run.optim, state, parked, phase, mesh=mesh if sharded else None, run=run,
                    schedule=schedule if schedule.active else None, boundary=boundary)
            cur_phase = phase
            ranks_before, cur_ranks = cur_ranks, rank_adapt.live_rank_map(whole_params(state))
            part_bytes = steps_mod.partition_bytes(state)
            if cur_ranks != ranks_before:
                reported.clear()
                shrunk = {p: f"{ranks_before[p]}->{r}" for p, r in cur_ranks.items()
                          if r != ranks_before[p]}
                obs.emit("rank_adapt", epoch=epoch, boundary=boundary, shrunk=shrunk,
                         rank_map=cur_ranks)
        window.before(step)
        batch = next(it)
        if run.model.family == "encdec":
            batch["frames"] = stub_frames(run, args.seed, step)
        elif run.model.family == "vlm":
            batch["vision_embeddings"] = stub_vision_embeddings(run, args.seed, step)
        t0 = time.perf_counter()
        with collectives.recording() as log:
            state, metrics = train_step(state, batch, phase=phase)
            loss = float(metrics["loss"])  # synchronises with the device
        dt = time.perf_counter() - t0
        gnorm = float(metrics["grad_norm"])
        sync = sum(c.bytes for c in log if c.op in collectives.CLASSES)
        per = collectives.by_op(log)
        losses.append(loss)
        window.after(obs, step)
        if sharded and step == start_step:
            steps_mod.check_state_placement(run, mesh, state)
        if sharded and phase not in reported:
            reported.add(phase)
            obs.emit("phase_compile", _mirror=False, phase=phase, sync_bytes_per_step=sync,
                     collectives=per)
        if on_step is not None:
            on_step(step, phase, {"loss": loss, "grad_norm": gnorm, "step_time_s": dt,
                                  **part_bytes, "rank_map": dict(cur_ranks),
                                  "sync_bytes": sync, "collectives": list(log)})
        if monitor.observe(dt):
            obs.emit("straggler", step=step, step_time_s=dt,
                     median_s=float(np.median(monitor.times)))
        record = run.obs.enabled and step % max(run.obs.step_every, 1) == 0
        mirror = step % args.log_every == 0 or step == args.steps - 1
        if record or mirror:
            obs.emit("train_step", _mirror=mirror, step=step, epoch=epoch, phase=phase,
                     loss=loss, grad_norm=gnorm, step_time_s=dt,
                     tokens_per_s=tokens_per_step / dt, total_rank=sum(cur_ranks.values()),
                     rank_map=cur_ranks, sync_bytes_per_step=sync, **part_bytes)
        # every rank takes the save decision, since a sharded save gathers
        due = ckpt.due(step + 1)
        if sharded:
            due = collectives.any_rank(due, mesh)
        if due:
            whole, parked_w = (steps_mod.gather_state(state, parked, run, mesh) if sharded
                               else (state, parked))
            if lead:
                ckpt.maybe_save(step + 1, pack_phased_state(whole, parked_w),
                                extra={"data": data.state_dict(), "phase": phase,
                                       "mesh": mesh_info,
                                       "rank_map": rank_adapt.live_rank_map(whole.params)},
                                force=True)
            del whole, parked_w
            if collectives.any_rank(ckpt.preempted, mesh) if sharded else ckpt.preempted:
                say(f"[preempt] checkpointed at step {step + 1}, exiting")
                window.end(obs, step + 1)
                obs.emit("run_end", _mirror=False, kind="train", reason="preempt",
                         final_step=step + 1)
                obs.close()
                ckpt.close()
                return state, losses
    window.end(obs, args.steps)
    ckpt.close()
    if losses:
        say(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    obs.emit("run_end", _mirror=False, kind="train", reason="complete", final_step=args.steps,
             final_loss=losses[-1] if losses else 0.0)
    obs.close()
    return state, losses


if __name__ == "__main__":
    main()
