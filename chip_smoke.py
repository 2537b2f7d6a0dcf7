"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out results.json] [--only kernels]

Phases, in order; any failure exits nonzero:

1. device   — require CUDA, print the card's name and power limit, set the
              float32/TF32/bf16-reduction flags of every comparison below;
2. build    — compile the hand-written kernels from ``src/repro_torch``;
3. kernels  — each kernel at the main path's shapes against its plain
              version (``kernels/ref.py``) on the same inputs, timed with
              CUDA events beside its plain version and one library call;
4. serve    — ``repro_torch.launch.serve.main`` on full-width smollm-360m
              with LRD (16 requests through 8 slots), with the kernels'
              launch counters zeroed before and read after;
5. parity   — one full-width prefill through the kernels against the same
              prefill through the plain versions;
6. profile  — where a full-width decode step's time goes (wall time,
              device time by kernel, the device's idle share).

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is ``nvidia-smi``'s name and power limit, and the
``{"kernels": [...]}`` line comes before that.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
# Relative tolerances (max |kernel - plain| / max |plain|) of the bf16
# kernels.  K1 rounds t and y at the same points as its plain version, so
# they differ only where float32 sums taken in another order flip a bf16
# rounding: a flip of y costs at most one bf16 ulp of max |y| (2**-7
# relative), a flip of t one ulp of t carried through V (about 2**-8 / sqrt(r)
# relative), so 1e-2 holds both.  K5 also keeps g and u in float32 where the
# plain version rounds each branch to bf16 (two more 2**-9 roundings,
# carried through silu(g) * u).
KERNEL_RTOL = {"lowrank_matmul": 1e-2, "lowrank_gated_ffn": 2e-2}
# Bound on the full-width prefill's last-position logits, kernels vs plain,
# relative to max |logit|: the per-call differences above, carried through
# 32 residual layers.
PATH_RTOL = 5e-2
SERVE_ARGV = ["--arch", "smollm-360m", "--lrd", "--slots", "8", "--requests", "16",
              "--rate", "1000", "--prompt-len", "128", "--max-new", "32",
              "--block-size", "16"]
PREFILL_M, DECODE_M = 128, 8  # --prompt-len, --slots


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn()`` over ``iters`` launches, each after
    an L2 flush (the serving path reads every layer's factors cold).  The
    flush also gives the host time to enqueue ``fn`` before the start
    event, so host overhead stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def rel_err(got: torch.Tensor, want: torch.Tensor):
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"tf32 off, bf16 reduced-precision reduction off, float32 matmul 'highest'")
    return smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    dt = time.perf_counter() - t0
    log(f"[build] {', '.join(sorted(libs))} in {dt:.1f}s -> {build.build_dir()}")
    for name in build.SOURCES:
        for line in (build.build_dir() / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return dt


def kernel_shapes():
    """(name, dims) of every kernel call on the main path, at both M."""
    k1 = [("wq/wo", 960, 240, 960), ("wk/wv", 960, 120, 320), ("down", 2560, 349, 960)]
    out = []
    for m in (DECODE_M, PREFILL_M):
        for _, c, r, s in k1:
            out.append(("lowrank_matmul", dict(M=m, C=c, r=r, S=s)))
        out.append(("lowrank_gated_ffn", dict(M=m, C=960, r=349, F=2560)))
    return out


def kernel_case(name, d, gen):
    """Inputs, kernel, plain version, library call, bytes and flops."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    m, c, r = d["M"], d["C"], d["r"]
    x = rnd(m, c)
    if name == "lowrank_matmul":
        s = d["S"]
        u, v = rnd(c, r, scale=c ** -0.5), rnd(r, s, scale=r ** -0.5)
        args = (x, u, v)
        return dict(args=args, kernel=lambda: lowrank_matmul(*args),
                    plain=lambda: ref.lowrank_matmul_ref(*args),
                    library=lambda: torch.matmul(torch.matmul(x, u), v),
                    bytes=2 * (m * c + c * r + r * s + m * s),
                    flops=2 * m * c * r + 2 * m * r * s)
    f = d["F"]
    gu, gv = rnd(c, r, scale=c ** -0.5), rnd(r, f, scale=r ** -0.5)
    uu, uv = rnd(c, r, scale=c ** -0.5), rnd(r, f, scale=r ** -0.5)
    args = (x, gu, gv, uu, uv)
    return dict(args=args, kernel=lambda: lowrank_gated_ffn(*args),
                plain=lambda: ref.lowrank_gated_ffn_ref(*args),
                library=lambda: F.silu(torch.matmul(torch.matmul(x, gu), gv))
                * torch.matmul(torch.matmul(x, uu), uv),
                bytes=2 * (m * c + 2 * c * r + 2 * r * f + m * f),
                flops=2 * 2 * (m * c * r + m * r * f))


def phase_kernels(iters: int = 50):
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    rows = []
    for name, d in kernel_shapes():
        case = kernel_case(name, d, gen)
        got = case["kernel"]()
        want = case["plain"]()
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        if not math.isfinite(err) or rel > KERNEL_RTOL[name]:
            raise AssertionError(f"{name} {d}: max_abs_err {err:.3e} = {rel:.3e} of "
                                 f"max |plain| > {KERNEL_RTOL[name]}")
        ms = cuda_time_ms(case["kernel"], iters, flush)
        plain_ms = cuda_time_ms(case["plain"], iters, flush)
        lib_ms = cuda_time_ms(case["library"], iters, flush)
        t_bytes = case["bytes"] / HBM_BYTES_PER_S * 1e3
        t_flops = case["flops"] / BF16_FLOPS_PER_S * 1e3
        rows.append(dict(name=name, shape=d, max_abs_err=err, rel_err=rel,
                         rtol=KERNEL_RTOL[name], ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=max(t_bytes, t_flops),
                         bound_by="bytes" if t_bytes >= t_flops else "operations"))
        log(f"[kernels] {name} {d}: err {err:.3e} (rel {rel:.2e}), kernel "
            f"{ms * 1e3:.1f}us, plain {plain_ms * 1e3:.1f}us, library "
            f"{lib_ms * 1e3:.1f}us, bound {rows[-1]['bound_ms'] * 1e3:.2f}us "
            f"({rows[-1]['bound_by']})")
    zero_counts()  # launches made to compare and time are not the main path's
    return rows


def zero_counts():
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul

    for fn in (lowrank_matmul, lowrank_gated_ffn):
        fn.launches = 0
        fn.launches_by_shape.clear()


def shape_key(name, d):
    """The wrapper's ``launches_by_shape`` key of a kernel row's shape."""
    if name == "lowrank_matmul":
        return d["M"], d["C"], d["r"], d["S"]
    return d["M"], d["C"], d["r"], d["r"], d["F"]


def phase_serve():
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul
    from repro_torch.launch import serve

    zero_counts()
    t0 = time.perf_counter()
    engine, outs = serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k5 = lowrank_matmul.launches, lowrank_gated_ffn.launches
    by_shape = {"lowrank_matmul": dict(lowrank_matmul.launches_by_shape),
                "lowrank_gated_ffn": dict(lowrank_gated_ffn.launches_by_shape)}
    sched = engine.scheduler
    fwd = sched.forward_stats
    n_fwd = fwd["prefill"] + fwd["decode"]
    n_layers = engine.run.model.num_layers
    if len(outs) != 16 or any(len(o) != 32 for o in outs):
        raise AssertionError(f"serve: want 16 requests x 32 tokens, got "
                             f"{[len(o) for o in outs]}")
    if fwd["nonfinite"]:
        raise AssertionError(f"serve: {fwd['nonfinite']} forwards with non-finite logits")
    if n_fwd == 0 or k1 != 5 * n_layers * n_fwd or k5 != n_layers * n_fwd:
        raise AssertionError(f"serve: {n_fwd} forwards but {k1} K1 / {k5} K5 launches "
                             f"(want {5 * n_layers} / {n_layers} per forward)")
    stats = sched.latency_stats()
    log(f"[serve] {len(outs)} requests, {int(stats['generated_tokens'])} tokens, "
        f"{stats['tok_per_s']:.1f} tok/s on {torch.cuda.get_device_name(0)}; "
        f"{fwd['prefill']} prefill + {fwd['decode']} decode forwards; "
        f"{k1} K1 + {k5} K5 launches = {k1 // n_fwd} + {k5 // n_fwd} per forward; "
        f"{dt:.1f}s incl. init")
    return engine, by_shape, dict(fwd=dict(fwd), k1=k1, k5=k5, stats=stats, wall_s=dt,
                                  n_layers=n_layers)


def phase_profile(engine, steps: int = 5):
    """Where a full-width decode step's time goes: wall time per step (host
    clock around synchronised steps), device time per step by kernel
    (``torch.profiler``), and the device's idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as steps_mod

    sched = engine.scheduler
    step = steps_mod.build_serve_step(engine.run)
    # all slots at position 0 of the sink block: the step's fixed shapes
    tokens = torch.zeros((sched.num_slots, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros((sched.num_slots,), dtype=torch.int32, device="cuda")
    step(engine.params, sched.cache, tokens, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(engine.params, sched.cache, tokens, pos)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(engine.params, sched.cache, tokens, pos)
        torch.cuda.synchronize()
    # device-side events only (kernels, memcpy, memset; one stream, so they
    # do not overlap): the CPU ops that launched them carry the same time
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / steps / 1e3
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(wall_ms=wall_ms, device_ms=device_ms if device_ms else None,
               idle_share=(1 - device_ms / wall_ms) if device_ms else None,
               top=[dict(name=k[:80], ms=v) for k, v in top])
    shown = ", ".join(f"{k[:40]} {v * 1e3:.0f}us" for k, v in top[:5])
    log(f"[profile] decode step (8 slots, 32 layers): wall {wall_ms:.2f} ms, device "
        + (f"{device_ms:.2f} ms, idle {out['idle_share']:.1%}; top: {shown}"
           if device_ms else "time not measured (profiler saw no device events)"))
    return out


def phase_parity(engine):
    import dataclasses

    from repro_torch.launch import steps

    run = engine.run
    plain_run = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, use_pallas_kernel=False))
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, run.model.vocab_size, (1, PREFILL_M), generator=gen,
                           device="cuda", dtype=torch.int32)
    last = torch.tensor([PREFILL_M - 1], device="cuda")
    got, _ = steps.build_slot_prefill_step(run)(engine.params, {"tokens": tokens}, last)
    want, _ = steps.build_slot_prefill_step(plain_run)(engine.params, {"tokens": tokens}, last)
    err, rel = rel_err(got, want)
    if not torch.isfinite(got).all() or rel > PATH_RTOL:
        raise AssertionError(f"parity: last-position logits differ by {err:.3e} "
                             f"({rel:.3e} of max |logit|) > {PATH_RTOL}")
    # greedy agreement of a short decode: 8 tokens each way through a fresh
    # one-slot engine
    from repro_torch.serving import ServeConfig, ServeEngine

    prompt = tokens[0, :64].cpu().numpy()
    toks = []
    for r in (run, plain_run):
        eng = ServeEngine(r, engine.params, device="cuda",
                          config=ServeConfig(num_slots=1, max_len=80, prefill_len=64))
        toks.append(eng.generate(prompt[None], max_new=8)[0].tolist())
    agree = sum(a == b for a, b in zip(*toks))
    log(f"[parity] prefill last-position logits: max_abs_diff {err:.3e} "
        f"({rel:.3e} of max |logit| {want.abs().max().item():.3f}; bound {PATH_RTOL}); "
        f"greedy decode agreement {agree}/8 (kernels {toks[0]} vs plain {toks[1]})")
    return dict(max_abs_diff=err, rel=rel, agree=agree)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="also write every result as JSON here")
    ap.add_argument("--only", choices=("kernels",), default=None,
                    help="stop after the kernel phase (a first check of a build)")
    args = ap.parse_args(argv)

    smi = phase_device()
    build_s = phase_build()
    rows = phase_kernels()
    result = dict(smi=smi, build_s=build_s, kernels=rows)
    if args.only is None:
        engine, by_shape, served = phase_serve()
        result["serve"] = served
        result["parity"] = phase_parity(engine)
        result["profile"] = phase_profile(engine)
        for row in rows:
            row["launches"] = by_shape[row["name"]].get(
                shape_key(row["name"], row["shape"]), 0)
            if not row["launches"]:
                raise AssertionError(f"serve: {row['name']} {row['shape']} never launched")
        for name, counts in by_shape.items():
            unchecked = set(counts) - {shape_key(r["name"], r["shape"])
                                       for r in rows if r["name"] == name}
            if unchecked:
                raise AssertionError(f"serve: {name} launched at shapes the kernel "
                                     f"phase did not check: {sorted(unchecked)}")
    else:
        for row in rows:
            row["launches"] = 0
    src = {"lowrank_matmul": ("src/repro_torch/kernels/csrc/lowrank_matmul.cu",
                              "src/repro/kernels/lowrank_matmul.py:107"),
           "lowrank_gated_ffn": ("src/repro_torch/kernels/csrc/lowrank_ffn.cu",
                                 "src/repro/kernels/lowrank_ffn.py:52")}
    line = {"kernels": [dict(name=r["name"], shape=r["shape"], route="cuda",
                             source=src[r["name"]][0], replaces=src[r["name"]][1],
                             launches=r["launches"], max_abs_err=r["max_abs_err"],
                             ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                             bound_by=r["bound_by"], library_ms=r["library_ms"])
                        for r in rows]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    if args.only:
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
