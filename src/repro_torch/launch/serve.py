"""Serving CLI: continuous batching over a synthetic Poisson trace.

The PyTorch counterpart of ``repro.launch.serve`` with the same flags plus
``--device {cuda,cpu}`` (default ``cuda``; raises without a GPU).  It
replays ``--requests`` requests with exponential inter-arrival times at
``--rate`` req/s (random prompt lengths) through ``ServeEngine`` and prints
throughput and latency percentiles.  ``--export {analytic,measured}`` serves
the rank-quantized Algorithm-1 artifact (``serving/export.py``) and
``--export-int8`` stores its groups as int8.  With ``--lrd`` on CUDA every
factorised projection runs through the hand-written kernels (K1/K5, or K7
and K6 for the int8 artifact).  Flags of features this port does not have
yet are rejected, not ignored.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --lrd \\
      --slots 8 --requests 16 --rate 1000 --prompt-len 128 --max-new 32 \\
      [--export measured --export-int8]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.serving import ServeConfig, ServeEngine

__all__ = ["poisson_trace", "serve_run", "main"]


def poisson_trace(n: int, rate: float, prompt_len: int, vocab: int, seed: int = 0):
    """n requests: exponential inter-arrivals at ``rate``/s, random prompts
    of 1/4..1x ``prompt_len`` tokens (the JAX CLI's trace, same seed ->
    same trace)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), n))
    lens = rng.integers(max(prompt_len // 4, 1), prompt_len + 1, n)
    return [{"prompt": rng.integers(0, vocab, int(l), dtype=np.int32),
             "arrival": float(t)} for t, l in zip(arrivals, lens)]


# flag -> (its value when off, what brings it)
_UNPORTED_FLAGS = {
    "mesh_data": (1, "ROADMAP queue 1, distributed"),
    "mesh_model": (1, "ROADMAP queue 1, distributed"),
    "prefix_cache": (False, "ROADMAP queue 1, serving features"),
    "spec_k": (0, "ROADMAP queue 1, serving features"),
    "spec_rank": (0, "ROADMAP queue 1, serving features"),
    "spec_fraction": (0.5, "ROADMAP queue 1, serving features"),
    "obs": (False, "ROADMAP queue 1, telemetry"),
    "log_format": ("text", "ROADMAP queue 1, telemetry"),
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
    # the JAX CLI's flags for features not ported yet: rejected when set
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--spec-rank", type=int, default=0)
    ap.add_argument("--spec-fraction", type=float, default=0.5)
    ap.add_argument("--obs", action="store_true")
    ap.add_argument("--obs-dir", default="runs/serve_obs")
    ap.add_argument("--log-format", default="text", choices=["text", "jsonl"])
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


def main(argv=None):
    """Run the CLI; returns ``(engine, results)``."""
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, (off, item) in _UNPORTED_FLAGS.items():
        if getattr(args, flag) != off:
            ap.error(f"--{flag.replace('_', '-')} is not ported to the PyTorch "
                     f"package yet ({item})")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family != "dense" or cfg.use_mla:
        ap.error(f"--arch {args.arch} ({cfg.family}) is not ported yet "
                 f"(ROADMAP queue 1, other model families)")
    device = steps_mod.resolve_device(args.device)
    max_len = args.max_len or (args.prompt_len + args.max_new)
    try:
        config = ServeConfig.from_args(args, max_len=max_len)
    except ValueError as e:
        ap.error(str(e))
    run = serve_run(cfg, max_len=max_len, slots=args.slots, lrd=args.lrd, device=device,
                    seed=args.seed)
    params, plan = steps_mod.init_params(run, device)
    if plan.layers:
        print(plan.summary())

    engine = ServeEngine(run, params, config=config, device=device)
    if engine.export_report is not None:
        print(engine.export_report.summary())
    trace = poisson_trace(args.requests, args.rate, args.prompt_len,
                          cfg.vocab_size, args.seed)
    for r in trace:
        r["max_new"] = args.max_new
        if args.eos_id >= 0:
            r["eos_id"] = args.eos_id
    t0 = time.perf_counter()
    outs = engine.serve(trace)
    dt = time.perf_counter() - t0
    stats = engine.scheduler.latency_stats()
    fwd = engine.scheduler.forward_stats
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{len(outs)} requests, {int(stats['generated_tokens'])} tokens in "
          f"{dt:.2f}s ({stats['tok_per_s']:.1f} tok/s on {where}; layout "
          f"{engine.scheduler.layout}, {fwd['prefill']} prefill + "
          f"{fwd['decode']} decode forwards)")
    print(f"latency p50 {stats['p50_latency_s'] * 1e3:.0f}ms  "
          f"p95 {stats['p95_latency_s'] * 1e3:.0f}ms  "
          f"p99 {stats['p99_latency_s'] * 1e3:.0f}ms  "
          f"first-token p50 {stats['p50_first_token_s'] * 1e3:.0f}ms  "
          f"queue-wait p50 {stats['p50_queue_wait_s'] * 1e3:.0f}ms  "
          f"preemptions {int(stats['preemptions'])}")
    print("sample:", outs[0][:16].tolist())
    return engine, outs


if __name__ == "__main__":
    main()
