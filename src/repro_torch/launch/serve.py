"""Serving CLI: continuous batching over a synthetic Poisson trace.

The PyTorch counterpart of ``repro.launch.serve`` with the same flags plus
``--device {cuda,cpu}`` (default ``cuda``; raises without a GPU).  It
replays ``--requests`` requests with exponential inter-arrival times at
``--rate`` req/s (random prompt lengths) through ``ServeEngine`` and prints
throughput and latency percentiles.  ``--export {analytic,measured}`` serves
the rank-quantized Algorithm-1 artifact (``serving/export.py``) and
``--export-int8`` stores its groups as int8.  With ``--lrd`` on CUDA every
factorised projection runs through the hand-written kernels (K1/K5, or K7
and K6 for the int8 artifact).  ``--arch`` takes the dense and MoE
families (``olmoe-1b-7b``, whose experts run ``torch.bmm`` as in the
reference; an int8 export of its expert groups is refused;
``deepseek-v3-671b``, MLA and MTP, served by the scheduler on its slot
layout, where the prefix cache is off as in the reference), and the SSM
(``xlstm-350m``), hybrid (``zamba2-1.2b``), enc-dec
(``seamless-m4t-medium``) and VLM (``llama-3.2-vision-90b``) families,
which serve on the fixed-batch path as the JAX CLI serves them: ``--slots``
rows of random ``--prompt-len`` prompts from ``--seed``, ``--max-new``
tokens each, a VLM's vision embeddings drawn after the prompts
(:func:`vlm_extras`), from the int8 export too (K7 at every rank up to
4096, K6 for a merged group).  ``--obs`` writes the reference's telemetry
(``events.jsonl`` in ``--obs-dir``: ``run_start``, the scheduler's
per-request and per-step events, ``run_end`` with ``latency_stats()``;
the fixed-batch families open the log and emit nothing, as in the
reference), and ``--log-format jsonl`` mirrors every event to the console
(``python -m repro_torch.obs`` validates a trace,
``python -m repro_torch.analysis.obs_report`` reads it).  Flags of
features this port does not have yet are rejected, not ignored.

TP-sharded serving: ``--mesh-model N`` serves over a ``(1, N)`` mesh, one
process a rank, started by ``torch.distributed.run`` (its environment's
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; ``env://`` rendezvous) over
``--dist-backend`` (``nccl``, or ``gloo``, which lets ranks share one GPU or
run on the CPU; no backend is switched on failure).  Every rank makes the
same params from ``--seed`` (the engine checks them by a digest) and
serves the same trace; only rank 0 prints, and emits the ``obs`` events.
The dense and MoE families (a MoE model's experts split over ``model``:
expert parallelism); MLA is refused under a mesh, as is ``--mesh-data`` >
1 (ROADMAP queue 1 item 8).

  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.serve --smoke --device cpu --dist-backend gloo --lrd \\
      --mesh-model 2 --slots 4 --requests 8 --prompt-len 16 --max-new 8

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --lrd \\
      --slots 8 --requests 16 --rate 1000 --prompt-len 128 --max-new 32 \\
      [--export measured --export-int8]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --lrd \\
      --slots 8 --requests 16 --rate 1000 --prompt-len 128 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --lrd \\
      --slots 8 --prompt-len 512 --max-new 32 [--export analytic --export-int8]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium --lrd \\
      --slots 8 --prompt-len 256 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-90b --smoke \\
      --device cpu --lrd --slots 2 --prompt-len 8 --max-new 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b --smoke \\
      --device cpu --lrd --slots 4 --requests 8 --prompt-len 12 --max-new 6 [--spec-k 2]
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --lrd \\
      --obs --obs-dir runs/serve_obs [--log-format jsonl]
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro_torch.distributed import collectives
from repro_torch.launch import steps as steps_mod
from repro_torch.obs import EventLog
from repro_torch.serving import ServeConfig, ServeEngine

__all__ = ["poisson_trace", "shared_prefix_trace", "serve_run", "encdec_extras",
           "vlm_extras", "fixed_batch_serve", "main"]

# the families that serve on the fixed-batch path only, as in the reference
FIXED_BATCH = ("ssm", "hybrid", "encdec", "vlm")


def poisson_trace(n: int, rate: float, prompt_len: int, vocab: int, seed: int = 0):
    """n requests: exponential inter-arrivals at ``rate``/s, random prompts
    of 1/4..1x ``prompt_len`` tokens (the JAX CLI's trace, same seed ->
    same trace)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), n))
    lens = rng.integers(max(prompt_len // 4, 1), prompt_len + 1, n)
    return [{"prompt": rng.integers(0, vocab, int(l), dtype=np.int32),
             "arrival": float(t)} for t, l in zip(arrivals, lens)]


def shared_prefix_trace(n: int, rate: float, prefix_len: int, suffix_len: int,
                        vocab: int, seed: int = 0):
    """n requests sharing one ``prefix_len``-token system prompt, each with
    a random 1..``suffix_len`` tail: the radix prefix cache's workload (the
    JAX CLI's, same seed -> same trace)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), n))
    prefix = rng.integers(0, vocab, prefix_len, dtype=np.int32)
    return [{"prompt": np.concatenate([prefix, rng.integers(0, vocab, int(s), dtype=np.int32)]),
             "arrival": float(t)}
            for t, s in zip(arrivals, rng.integers(1, suffix_len + 1, n))]


# flag -> (its value when off, what brings it)
_UNPORTED_FLAGS = {
    "mesh_data": (1, "ROADMAP queue 1 item 8, distributed"),
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate, requests/second")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0,
                    help="serving window (default prompt_len + max_new)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged pool size; 0 = fully provisioned")
    ap.add_argument("--lrd", action="store_true")
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--export", choices=("none", "analytic", "measured"), default="none",
                    help="serve the rank-quantized Algorithm-1 artifact")
    ap.add_argument("--export-int8", action="store_true",
                    help="int8-quantize the export artifact (requires --export)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prompt-prefix cache over the paged block pool")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens per step (0 = plain decode)")
    ap.add_argument("--spec-rank", type=int, default=0,
                    help="explicit draft rank (clamped per layer); 0 = Algorithm-1 "
                         "sweep scaled by --spec-fraction")
    ap.add_argument("--spec-fraction", type=float, default=0.5,
                    help="draft rank as a fraction of the sweep's rank (with "
                         "--spec-rank 0)")
    ap.add_argument("--obs", action="store_true",
                    help="write per-request/per-step telemetry JSONL (events.jsonl in "
                         "--obs-dir)")
    ap.add_argument("--obs-dir", default="runs/serve_obs",
                    help="telemetry directory for --obs")
    ap.add_argument("--log-format", default="text", choices=["text", "jsonl"],
                    help="with jsonl, mirror every event to the console")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data axis of the serving mesh (only 1 is ported)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model (tensor-parallel) axis of the serving mesh: one process a "
                         "rank under torch.distributed.run")
    ap.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                    help="process-group backend of a multi-rank run (gloo lets ranks share "
                         "a GPU or run on the CPU)")
    return ap


def serve_run(cfg, *, max_len: int, slots: int, lrd: bool, device: torch.device,
              seed: int) -> RunConfig:
    """The run the CLI serves ``cfg`` with: ``slots`` rows of ``max_len``
    positions, LRD at Eq.-5 ranks under ``lrd`` (its kernels on where the
    device is CUDA), the given parameter seed."""
    return RunConfig(model=cfg, shape=ShapeConfig("serve", max_len, slots, "decode"),
                     lrd=LRDConfig(enabled=lrd, min_dim=16, rank_quantize=False,
                                   use_pallas_kernel=lrd and device.type == "cuda"),
                     dist=DistConfig(fsdp=False, remat="none"), seed=seed)


def encdec_extras(run: RunConfig, rng: np.random.Generator, rows: int,
                  device: torch.device):
    """An encoder-decoder model's ``generate`` extras: stub frontend frames
    ``rng.normal(0, 0.1, (rows, encoder_frames, d_model))`` in the compute
    dtype, as the JAX CLI draws them.  The JAX CLI hands its engine their
    encoding alone, which its prefill cannot run without the frames; the
    port hands it the frames, which its prefill encodes (its decode steps
    read the cross k/v from the cache and need no memory)."""
    cfg = run.model
    frames = torch.from_numpy(rng.normal(0, 0.1, (rows, cfg.encoder_frames, cfg.d_model)))
    return {"frames": frames.to(device=device, dtype=cfg.cdtype)}


def vlm_extras(run: RunConfig, rng: np.random.Generator, rows: int, device: torch.device):
    """A VLM's ``generate`` extras: stub vision embeddings
    ``rng.normal(0, 0.1, (rows, num_image_tokens, d_model))`` in the compute
    dtype, drawn as the JAX CLI draws them."""
    cfg = run.model
    emb = torch.from_numpy(rng.normal(0, 0.1, (rows, cfg.num_image_tokens, cfg.d_model)))
    return {"vision_embeddings": emb.to(device=device, dtype=cfg.cdtype)}


_EXTRAS = {"encdec": encdec_extras, "vlm": vlm_extras}


def fixed_batch_serve(args, run: RunConfig, params, config: ServeConfig,
                      device: torch.device):
    """The SSM, hybrid, enc-dec and VLM families' serve (the JAX CLI's
    fixed-batch fallback): ``--slots`` random prompts of ``--prompt-len``
    tokens from ``--seed`` (an enc-dec model's frames or a VLM's vision
    embeddings drawn after them, :func:`encdec_extras`, :func:`vlm_extras`)
    through ``ServeEngine.generate`` (``config.num_slots`` 0); returns
    ``(engine, tokens (slots, max_new))``."""
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, run.model.vocab_size, size=(args.slots, args.prompt_len),
                           dtype=np.int32)
    draw = _EXTRAS.get(run.model.family)
    extras = draw(run, rng, args.slots, device) if draw else None
    engine = ServeEngine(run, params, config=config, device=device)
    if engine.export_report is not None:
        print(engine.export_report.summary())
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=args.max_new, extras=extras,
                          eos_id=args.eos_id if args.eos_id >= 0 else None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"generated {out.shape} tokens in {dt:.2f}s ({out.size / dt:.1f} tok/s on "
          f"{where}; fixed-batch path)")
    print("sample:", out[0][:16].tolist())
    return engine, out


def main(argv=None):
    """Run the CLI; returns ``(engine, results)``: request results from the
    scheduler, or the token matrix of the fixed-batch path (SSM, hybrid,
    enc-dec and VLM families)."""
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, (off, item) in _UNPORTED_FLAGS.items():
        if getattr(args, flag) != off:
            ap.error(f"--{flag.replace('_', '-')} is not ported to the PyTorch "
                     f"package yet ({item})")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family not in ("dense", "moe") + FIXED_BATCH:
        ap.error(f"--arch {args.arch} ({cfg.family}) is not served: the port serves the "
                 f"dense, MoE, SSM, hybrid, enc-dec and VLM families")
    stateful = cfg.family in FIXED_BATCH
    if stateful and (args.spec_k or args.prefix_cache):
        ap.error(f"--arch {args.arch} ({cfg.family}) serves on the fixed-batch path, which "
                 f"has no speculative decoding or prefix cache (as in the reference; ROADMAP "
                 f"queue 1 item 7, other model families)")
    if args.mesh_model > 1 and (stateful or cfg.use_mla):
        ap.error(f"--mesh-model {args.mesh_model}: --arch {args.arch} ({cfg.family}"
                 f"{', MLA' if cfg.use_mla else ''}) is not served sharded yet; the dense and "
                 f"MoE families are (ROADMAP queue 1 item 8, distributed)")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and args.dist_backend == "nccl" and args.device != "cuda":
        ap.error("--dist-backend nccl needs --device cuda; use --dist-backend gloo on the CPU")
    if args.mesh_model > world:
        ap.error(f"--mesh-model {args.mesh_model} needs as many ranks, {world} started: run "
                 f"under `python -m torch.distributed.run --nproc-per-node "
                 f"{args.mesh_model} ...`")
    group = (collectives.init_process_group(args.dist_backend, "env://",
                                            int(os.environ["RANK"]), world)
             if world > 1 else None)
    try:
        return _serve(args, ap, cfg, stateful)
    finally:
        if group is not None:
            collectives.destroy_process_group()


def _device(args) -> torch.device:
    """``cuda:(LOCAL_RANK % device count)``, set as the current device, or the CPU."""
    device = steps_mod.resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def _serve(args, ap, cfg, stateful: bool):
    from repro_torch.launch.mesh import make_host_mesh

    device = _device(args)
    try:
        mesh = make_host_mesh(1, args.mesh_model)
    except ValueError as e:
        ap.error(str(e))
    lead = collectives.process_rank() == 0
    if mesh.get_coordinate() is None or not (args.mesh_model > 1 or lead):
        return None, []  # a rank past the mesh idles, as a leftover device does
    print_ = print if lead else (lambda *a, **k: None)
    max_len = args.max_len or (args.prompt_len + args.max_new)
    try:
        config = ServeConfig.from_args(args, max_len=max_len, **(
            dict(num_slots=0, speculative_k=0, prefix_cache=False) if stateful else {}))
    except ValueError as e:
        ap.error(str(e))
    # the JAX CLI's log: events.jsonl with --obs, a console mirror of every
    # event with --log-format jsonl (serving events have no text lines)
    obs = None
    if lead and (args.obs or args.log_format == "jsonl"):
        path = None
        if args.obs:
            Path(args.obs_dir).mkdir(parents=True, exist_ok=True)
            path = Path(args.obs_dir) / "events.jsonl"
        obs = EventLog(path, mirror=print if args.log_format == "jsonl" else None,
                       fmt=args.log_format)
    run = serve_run(cfg, max_len=max_len, slots=args.slots, lrd=args.lrd, device=device,
                    seed=args.seed)
    params, plan = steps_mod.init_params(run, device)
    if plan.layers:
        print_(plan.summary())
    if stateful:
        # the reference's fixed-batch path emits no event into its log
        try:
            return fixed_batch_serve(args, run, params, config, device)
        finally:
            if obs is not None:
                obs.close()

    engine = ServeEngine(run, params, config=config, device=device, obs=obs, mesh=mesh)
    if engine.export_report is not None:
        print_(engine.export_report.summary())
    if engine.sharded:
        print_(f"mesh: data=1 model={args.mesh_model} ({collectives.mesh_size(mesh)} "
               f"devices)")
    if args.spec_k and engine.scheduler and engine.draft_report:
        print_(engine.draft_report.summary())
    trace = poisson_trace(args.requests, args.rate, args.prompt_len,
                          cfg.vocab_size, args.seed)
    for r in trace:
        r["max_new"] = args.max_new
        if args.eos_id >= 0:
            r["eos_id"] = args.eos_id
    if obs is not None:
        obs.emit("run_start", _mirror=False, kind="serve", arch=cfg.name, slots=args.slots,
                 requests=args.requests, rate=args.rate)
    t0 = time.perf_counter()
    outs = engine.serve(trace)
    dt = time.perf_counter() - t0
    stats = engine.scheduler.latency_stats()
    if obs is not None:
        obs.emit("run_end", _mirror=False, kind="serve", **stats)
        obs.close()
    fwd = engine.scheduler.forward_stats
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print_(f"{len(outs)} requests, {int(stats['generated_tokens'])} tokens in "
           f"{dt:.2f}s ({stats['tok_per_s']:.1f} tok/s on {where}; layout "
           f"{engine.scheduler.layout}, {fwd['prefill']} prefill + "
           f"{fwd['decode']} decode forwards)")
    print_(f"latency p50 {stats['p50_latency_s'] * 1e3:.0f}ms  "
           f"p95 {stats['p95_latency_s'] * 1e3:.0f}ms  "
           f"p99 {stats['p99_latency_s'] * 1e3:.0f}ms  "
           f"first-token p50 {stats['p50_first_token_s'] * 1e3:.0f}ms  "
           f"queue-wait p50 {stats['p50_queue_wait_s'] * 1e3:.0f}ms  "
           f"preemptions {int(stats['preemptions'])}")
    if args.spec_k:
        print_(f"speculative: k={args.spec_k}, {int(stats['spec_steps'])} steps, "
              f"{int(stats['drafted_tokens'])} drafted / "
              f"{int(stats['accepted_tokens'])} accepted "
              f"(acceptance {stats['acceptance_rate']:.2f}; {fwd['draft']} draft + "
              f"{fwd['verify']} verify forwards)")
    if config.prefix_cache:
        print_(f"prefix cache: {int(stats['prefix_hits'])}/"
              f"{int(stats['prefix_lookups'])} hits, "
              f"{int(stats['prefix_hit_tokens'])} prompt tokens reused "
              f"({int(stats['prefill_tokens'])} prefilled; {fwd['extend']} extend + "
              f"{fwd['prefill']} prefill forwards)")
    print_("sample:", outs[0][:16].tolist())
    return engine, outs


if __name__ == "__main__":
    main()
