"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out results.json] [--only kernels]

Phases, in order; any failure exits nonzero:

1. device   — require CUDA, print the card's name and power limit, set the
              float32/TF32/bf16-reduction flags of every comparison below;
2. build    — compile the hand-written kernels from ``src/repro_torch``;
3. kernels  — each kernel at every shape the serve and train paths launch
              it at, against its plain version (``kernels/ref.py``) on the
              same inputs, timed with CUDA events beside its plain version
              and one library call;
4. serve    — ``repro_torch.launch.serve.main`` on full-width smollm-360m
              with LRD (16 requests through 8 slots), with the kernels'
              launch counters zeroed before and read after;
5. parity   — one full-width prefill through the kernels against the same
              prefill through the plain versions;
6. profile  — where a full-width decode step's time goes (wall time,
              device time by kernel, the device's idle share);
7. train    — ``repro_torch.launch.train.main`` on full-width smollm-360m
              with LRD and sequential freezing, 6 steps of 8 x 256 tokens
              (phases 0,0,1,1,0,0), with the launch counters zeroed before
              and read after every step: exactly 224 K1, 32 K5 and 224 K2 a
              step, 224 K3 at phase 1 and none at phase 0, 224 K4 at phase 0
              and none at phase 1;
8. grads    — one full-width train step's loss and gradients at phases -1,
              0 and 1 through the kernels against the same step through the
              plain versions;
9. train profile — wall time, device time and idle share of one train
              step per phase, with tokens/s.

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
# K2-K4 round dt (or t) and their output at the same points as their plain
# versions, and split sums over M only add float32 partials in a fixed
# order, so K1's reasoning and bound hold for them.
KERNEL_RTOL = {"lowrank_matmul": 1e-2, "lowrank_gated_ffn": 2e-2, "lowrank_matmul_dx": 1e-2,
               "lowrank_matmul_du": 1e-2, "lowrank_matmul_dv": 1e-2}
# Bound on the full-width prefill's last-position logits, kernels vs plain,
# relative to max |logit|: the per-call differences above, carried through
# 32 residual layers.
PATH_RTOL = 5e-2
SERVE_ARGV = ["--arch", "smollm-360m", "--lrd", "--slots", "8", "--requests", "16",
              "--rate", "1000", "--prompt-len", "128", "--max-new", "32",
              "--block-size", "16"]
PREFILL_M, DECODE_M = 128, 8  # --prompt-len, --slots
TRAIN_ARGV = ["--arch", "smollm-360m", "--lrd", "--no-rank-opt", "--use-pallas",
              "--freeze", "sequential", "--steps", "6", "--steps-per-epoch", "2",
              "--global-batch", "8", "--seq-len", "256", "--save-every", "1000",
              "--log-every", "1"]
TRAIN_M = 8 * 256  # --global-batch x --seq-len
# launches a train step makes at full width (32 layers): K1 on the 5 plain
# factorised projections forward and the 2 FFN branches recomputed
# backward; K5 once a layer; K2 on all 7 factor pairs; K3 (dU) and K4 (dV)
# on the 7 pairs unless their factor is frozen (u at phase 0, v at phase 1)
TRAIN_LAUNCHES = {"lowrank_matmul": 224, "lowrank_gated_ffn": 32, "lowrank_matmul_dx": 224,
                  "lowrank_matmul_du": {0: 0, 1: 224}, "lowrank_matmul_dv": {0: 224, 1: 0}}
# Bound on each trainable leaf's gradient, kernels vs plain, relative to
# that leaf's max |grad|: the forward differs by up to PATH_RTOL at the
# logits (K5's float32 branches against the plain version's bf16 ones,
# and bf16 rounding flips, through 32 layers), and a gradient is a
# forward activation times a backward cotangent, each carrying that
# difference, so twice PATH_RTOL.  The mean loss over 2048 tokens averages
# the per-token differences: LOSS_RTOL.
GRAD_RTOL = 2 * PATH_RTOL
LOSS_RTOL = 1e-2


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


# (C, r, S) of the factorised projections of full-width smollm-360m with
# LRD at Eq.-5 ranks; gate/up run as K5 forward and as K1 in the FFN
# backward's recompute
PROJ = {"wq/wo": (960, 240, 960), "wk/wv": (960, 120, 320), "gate/up": (960, 349, 2560),
        "down": (2560, 349, 960)}
BWD = ("lowrank_matmul_dx", "lowrank_matmul_du", "lowrank_matmul_dv")


def kernel_shapes():
    """(name, dims) of every kernel call on the serve and train paths."""
    out = []
    for m in (DECODE_M, PREFILL_M):
        for proj in ("wq/wo", "wk/wv", "down"):
            c, r, s = PROJ[proj]
            out.append(("lowrank_matmul", dict(M=m, C=c, r=r, S=s)))
        out.append(("lowrank_gated_ffn", dict(M=m, C=960, r=349, F=2560)))
    for c, r, s in PROJ.values():
        out.append(("lowrank_matmul", dict(M=TRAIN_M, C=c, r=r, S=s)))
    out.append(("lowrank_gated_ffn", dict(M=TRAIN_M, C=960, r=349, F=2560)))
    for name in BWD:
        for c, r, s in PROJ.values():
            out.append((name, dict(M=TRAIN_M, C=c, r=r, S=s)))
    return out


def kernel_case(name, d, gen):
    """Inputs, kernel, plain version, library call, bytes and flops."""
    from repro_torch.kernels import lowrank_bwd as kb
    from repro_torch.kernels import ref
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    m, c, r = d["M"], d["C"], d["r"]
    x = rnd(m, c)
    if name == "lowrank_gated_ffn":
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
    s = d["S"]
    u, v = rnd(c, r, scale=c ** -0.5), rnd(r, s, scale=r ** -0.5)
    # every kernel here reads (or writes) x-, U-, V- and y-sized operands
    # once, and does two rank-r products
    bytes_ = 2 * (m * c + c * r + r * s + m * s)
    flops = 2 * m * c * r + 2 * m * r * s
    if name == "lowrank_matmul":
        return dict(kernel=lambda: lowrank_matmul(x, u, v),
                    plain=lambda: ref.lowrank_matmul_ref(x, u, v),
                    library=lambda: torch.matmul(torch.matmul(x, u), v),
                    bytes=bytes_, flops=flops)
    dy = rnd(m, s)
    if name == "lowrank_matmul_dx":
        return dict(kernel=lambda: kb.lowrank_matmul_dx(dy, u, v),
                    plain=lambda: ref.lowrank_matmul_dx_ref(dy, u, v),
                    library=lambda: torch.matmul(torch.matmul(dy, v.T), u.T),
                    bytes=bytes_, flops=flops)
    if name == "lowrank_matmul_du":
        return dict(kernel=lambda: kb.lowrank_matmul_du(x, dy, v),
                    plain=lambda: ref.lowrank_matmul_du_ref(x, dy, v),
                    library=lambda: torch.matmul(x.T, torch.matmul(dy, v.T)),
                    bytes=bytes_, flops=flops)
    return dict(kernel=lambda: kb.lowrank_matmul_dv(x, u, dy),
                plain=lambda: ref.lowrank_matmul_dv_ref(x, u, dy),
                library=lambda: torch.matmul(torch.matmul(x, u).T, dy),
                bytes=bytes_, flops=flops)


def phase_kernels(iters: int = 50):
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


def wrappers():
    """name -> kernel wrapper (each carries ``launches`` and
    ``launches_by_shape``)."""
    from repro_torch.kernels import lowrank_bwd as kb
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul

    return {"lowrank_matmul": lowrank_matmul, "lowrank_gated_ffn": lowrank_gated_ffn,
            "lowrank_matmul_dx": kb.lowrank_matmul_dx,
            "lowrank_matmul_du": kb.lowrank_matmul_du,
            "lowrank_matmul_dv": kb.lowrank_matmul_dv}


def zero_counts():
    for fn in wrappers().values():
        fn.launches = 0
        fn.launches_by_shape.clear()


def counts_by_shape():
    return {name: dict(fn.launches_by_shape) for name, fn in wrappers().items()}


def shape_key(name, d):
    """The wrapper's ``launches_by_shape`` key of a kernel row's shape."""
    if name == "lowrank_gated_ffn":
        return d["M"], d["C"], d["r"], d["r"], d["F"]
    return d["M"], d["C"], d["r"], d["S"]


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
    by_shape = counts_by_shape()
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


def _train_run():
    from repro_torch.launch import train

    return train.build_run(train._parser().parse_args(TRAIN_ARGV))


def _train_batch(run, seed: int):
    from repro_torch.data import LMBatchIterator

    batch = next(iter(LMBatchIterator(run.model.vocab_size, run.shape.seq_len,
                                      run.shape.global_batch, seed=seed)))
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def phase_train():
    """The training CLI at full width, launches counted per step."""
    import tempfile

    from repro_torch.launch import train

    per_step, prev = [], {}

    def on_step(step, phase, metrics):
        now = {name: fn.launches for name, fn in wrappers().items()}
        per_step.append(dict(step=step, phase=phase, **metrics,
                             launches={k: n - prev.get(k, 0) for k, n in now.items()}))
        prev.update(now)

    zero_counts()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.perf_counter()
        state, losses = train.main(TRAIN_ARGV + ["--ckpt-dir", ckpt_dir], on_step=on_step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    by_shape = counts_by_shape()
    phases = [r["phase"] for r in per_step]
    if phases != [0, 0, 1, 1, 0, 0]:
        raise AssertionError(f"train: phases {phases}, want [0, 0, 1, 1, 0, 0]")
    for r in per_step:
        want = {k: (v[r["phase"]] if isinstance(v, dict) else v)
                for k, v in TRAIN_LAUNCHES.items()}
        if r["launches"] != want:
            raise AssertionError(f"train: step {r['step']} (phase {r['phase']}) launched "
                                 f"{r['launches']}, want {want}")
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"train: step {r['step']} loss {r['loss']} grad norm "
                                 f"{r['grad_norm']}")
        log(f"[train] step {r['step']} phase {r['phase']}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms; launches "
            + ", ".join(f"{k.replace('lowrank_', '')} {n}" for k, n in r["launches"].items()))
    log(f"[train] 6 steps of {TRAIN_M} tokens on {torch.cuda.get_device_name(0)}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {dt:.1f}s incl. init")
    return state.params, by_shape, dict(steps=per_step, wall_s=dt)


def _grad_paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _grad_paths(v, f"{path}/{k}")
    elif tree is not None:
        yield path, tree


def phase_grads(params):
    """One train step's loss and gradients through the kernels against the
    same step through the plain versions, at phases -1, 0 and 1."""
    import dataclasses

    from repro_torch.core import freezing
    from repro_torch.launch import steps

    run = _train_run()
    plain = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, use_pallas_kernel=False))
    batch = _train_batch(run, seed=99)
    out = {}
    for phase in (-1, 0, 1):
        trainable, frozen = freezing.partition(params, phase)
        lk, gk = steps._value_and_grad(trainable, frozen, batch, run, phase)
        lp, gp = steps._value_and_grad(trainable, frozen, batch, plain, phase)
        loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
        worst, n = (0.0, ""), 0
        for (path, a), (_, b) in zip(_grad_paths(gk), _grad_paths(gp)):
            diff = (a.float() - b.float()).abs().max().item()
            rel = diff / max(b.float().abs().max().item(), 1e-30)
            if not (math.isfinite(diff) and torch.isfinite(a).all()):
                raise AssertionError(f"grads: phase {phase} {path} not finite")
            worst, n = max(worst, (rel, path)), n + 1
        log(f"[grads] phase {phase}: loss kernels {lk.item():.5f} vs plain {lp.item():.5f} "
            f"(rel {loss_rel:.2e}, bound {LOSS_RTOL}); {n} trainable leaves, worst "
            f"max |dgrad| / max |grad| {worst[0]:.2e} at {worst[1]} (bound {GRAD_RTOL})")
        if loss_rel > LOSS_RTOL or worst[0] > GRAD_RTOL:
            raise AssertionError(f"grads: phase {phase} loss rel {loss_rel:.3e}, worst leaf "
                                 f"{worst[1]} rel {worst[0]:.3e}")
        out[phase] = dict(loss_kernels=lk.item(), loss_plain=lp.item(), loss_rel=loss_rel,
                          leaves=n, worst_rel=worst[0], worst_leaf=worst[1])
    return out


def phase_train_profile(params, steps_n: int = 2):
    """Wall time (host clock around synchronised steps), device time
    (``torch.profiler``, device-side events only) and idle share of a
    full-width train step at each freezing phase, with tokens/s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    run = _train_run()
    batch = _train_batch(run, seed=98)
    out = {}
    for phase in (-1, 0, 1):
        state, _ = steps.make_train_state(run.optim, params, phase)
        step = steps.build_train_step(run, "cuda")
        state, _ = step(state, batch, phase=phase)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps_n):
            state, _ = step(state, batch, phase=phase)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps_n * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps_n):
                state, _ = step(state, batch, phase=phase)
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                ms = ev.time_range.elapsed_us() / steps_n / 1e3
                by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
        device_ms = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[phase] = dict(wall_ms=wall_ms, tok_per_s=TRAIN_M / wall_ms * 1e3,
                          device_ms=device_ms if device_ms else None,
                          idle_share=(1 - device_ms / wall_ms) if device_ms else None,
                          top=[dict(name=k[:80], ms=v) for k, v in top])
        shown = ", ".join(f"{k[:40]} {v:.2f}ms" for k, v in top[:6])
        log(f"[train profile] phase {phase} step ({TRAIN_M} tokens, 32 layers): wall "
            f"{wall_ms:.1f} ms ({TRAIN_M / wall_ms * 1e3:.0f} tok/s), device "
            + (f"{device_ms:.1f} ms, idle {out[phase]['idle_share']:.1%}; top: {shown}"
               if device_ms else "time not measured (profiler saw no device events)"))
        del state
    return out


def check_launched_shapes(path: str, rows, by_shape) -> None:
    """Fail if ``path`` launched a kernel at a shape the kernel phase did
    not check."""
    for name, counts in by_shape.items():
        unchecked = set(counts) - {shape_key(r["name"], r["shape"])
                                   for r in rows if r["name"] == name}
        if unchecked:
            raise AssertionError(f"{path}: {name} launched at shapes the kernel phase "
                                 f"did not check: {sorted(unchecked)}")


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
        engine, serve_shapes, served = phase_serve()
        result["serve"] = served
        result["parity"] = phase_parity(engine)
        result["profile"] = phase_profile(engine)
        del engine
        params, train_shapes, result["train"] = phase_train()
        result["grads"] = phase_grads(params)
        result["train_profile"] = phase_train_profile(params)
        check_launched_shapes("serve", rows, serve_shapes)
        check_launched_shapes("train", rows, train_shapes)
        for row in rows:
            key = shape_key(row["name"], row["shape"])
            row["launches"] = (serve_shapes[row["name"]].get(key, 0)
                               + train_shapes[row["name"]].get(key, 0))
            if not row["launches"]:
                raise AssertionError(f"{row['name']} {row['shape']} never launched on "
                                     f"the serve or train path")
    else:
        for row in rows:
            row["launches"] = 0
    bwd_cu = "src/repro_torch/kernels/csrc/lowrank_bwd.cu"
    src = {"lowrank_matmul": ("src/repro_torch/kernels/csrc/lowrank_matmul.cu",
                              "src/repro/kernels/lowrank_matmul.py:107"),
           "lowrank_gated_ffn": ("src/repro_torch/kernels/csrc/lowrank_ffn.cu",
                                 "src/repro/kernels/lowrank_ffn.py:52"),
           "lowrank_matmul_dx": (bwd_cu, "src/repro/kernels/lowrank_bwd.py:116"),
           "lowrank_matmul_du": (bwd_cu, "src/repro/kernels/lowrank_bwd.py:215"),
           "lowrank_matmul_dv": (bwd_cu, "src/repro/kernels/lowrank_bwd.py:298")}
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
