"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out results.json] [--only kernels]

Phases, in order; any failure exits nonzero:

1. device   — require CUDA, print the card's name and power limit, set the
              float32/TF32/bf16-reduction flags of every comparison below;
2. build    — compile the hand-written kernels from ``src/repro_torch``;
3. kernels  — each kernel at every shape the serve, flash serve and
              train paths launch it at, against its plain version
              (``kernels/ref.py``) on the same inputs, timed with CUDA
              events beside its plain version and one library call; K1-K5
              rows also print their TFLOP/s and share of the bound (K1 and
              K5 run their large-M design from ``LARGE_M`` rows), and K2, K3
              and K4 must give the same bits on a second call (K2 splits
              nothing; K3/K4's split sum over M is added in a fixed order);
4. serve    — ``repro_torch.launch.serve.main`` on full-width smollm-360m
              with LRD (16 requests through 8 slots), with the kernels'
              launch counters zeroed before and read after;
5. parity   — one full-width prefill through the kernels against the same
              prefill through the plain versions;
6. profile  — where a full-width decode step's time goes (wall time,
              device time by kernel, the device's idle share);
6b. decompose — dense full-width smollm-360m (seeded, no LRD) through
              ``core.decompose.apply_lrd`` at Eq.-5 and at Algorithm-1
              ranks, each timed (the paper's decomposition time, Table 2):
              the plan equal to the init-time ``Decomposer`` plan, layer 0
              of each projection's ``u @ v`` against a float64 truncated
              SVD on the CPU, ``randomized_svd`` against ``svd_decompose``
              on one (960, 2560) slice; then the Eq.-5 tree served (8
              requests, 8 slots, K1/K5 launches exact) and held against
              the plain path as in phase 5;
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
              step per phase, with tokens/s and K1, K5, K2, K3 and K4
              device ms apart;
9b. rank-adapt train — phase 7 with ``--rank-schedule decay``: the ranks
              shrink at each phase swap (240/120/349 -> 128/90/256 ->
              96/67/128), launches counted per step by name and by shape,
              the partition bytes and ``torch.cuda.memory_allocated()``
              falling at each boundary to what the rank map implies; a
              train step profiled as in phase 9 at each shrunk rank map;
              then one ``--rank-schedule energy`` boundary and its rank map;
10. export serve — the serve CLI with ``--export analytic --export-int8``
              and then ``--export measured --export-int8`` (the rank-quantized
              int8 artifact): the export report (ranks per geometry, merged
              groups; the measured backend's t(r) sweep on this card), and
              exactly 7 x 32 = 224 int8 launches a forward, K7 for every kept
              factor pair and K6 for every group the guard merged, all
              through the serving entries that quantize x in the kernel
              (``int8_linear`` / ``int8_lowrank_linear``), none through the
              int8-operand entries;
11. int8 parity — the int8 trees' last-position prefill logits and greedy
              tokens through K6/K7 against the same run through their plain
              versions, and the gap of native int8 decode to the bf16 round
              trip of the same tree;
12. int8 profile — a decode step of each int8 export, as in phase 6, with
              its device launches, K6 / K7 ms and torch quantizer ops (none)
              a step; then the device launches of one ``ops.int8_apply`` and
              one ``ops.int8_lowrank_apply`` call (at most 3 each);
13. Algorithm-1 train — the training CLI without ``--no-rank-opt`` (ranks
              239/80/256/256), launches counted per step, and a train step
              profiled at phases -1 and 1 as in phase 9;
14. int8 kernels — K6 and K7 at every shape phases 10 launched them at
              (bitwise / 1e-6 against their plain versions), timed as in
              phase 3 beside one library call: the serving entries (beside
              the torch quantizer, ``torch._int_mm`` and the scaling) and
              the int8-operand entries at the same shapes (beside
              ``torch._int_mm``), which no main path launches;
15. flash serve — ``ServeEngine.serve`` on full-width smollm-360m with LRD
              and ``attention_impl="flash"``: 16 Poisson requests of up to
              2016 tokens, every prefill padded to 2016, 32 new tokens each
              in a 2048-token window, through 8 slots; exactly 32 K8
              launches a prefill forward and none a decode forward, K1 and
              K5 as in phase 4;
16. flash parity — one 2016-token prefill's last-position logits, flash
              against the model's default (``"blockwise"``, which falls to
              dense attention at 2016 tokens), and for three prompts 8
              greedy tokens through K8, through K8's plain version on the
              card and blockwise, each pair's logits held together while
              its histories agree;
17. flash prefill profile — wall time, device time by kernel (K8's share,
              K1 and K5 ms) and idle share of one 2016-token prefill, flash
              and blockwise;
18. flash kernels — K8 at every shape phase 15 launched it at, and at
              ragged, non-causal, batched and head-dim-128 shapes, against
              its plain version, timed as in phase 3 beside
              ``F.scaled_dot_product_attention``;
19. designs — both K1/K5 designs (decode and large-M) at M in
              DESIGN_SWEEP_M and on both sides of each wrapper's LARGE_M,
              for every train-path geometry, against the plain version and
              timed: where the threshold comes from.  Reported beside the
              flash extras, not in the kernels line (no main path launches
              the other design);
20. conv decompose — the paper's Table 2: ``apply_lrd`` of dense
              ResNet-50/101/152 (1000 classes, float32, seeded) at the
              ladder's LRD (Eq. 5) and RankOpt (Algorithm 1) policies, timed;
              the plan equal to the init-time ``Decomposer``'s, Tucker / SVD /
              kept-dense counts, each stage's 3x3 r1 (Eq. 5: 38, 77, 154,
              309), and one 3x3 conv a stage's Tucker-2 error against a
              float64 HOSVD on the CPU;
21. resnet parity — ResNet-50 at 224 x 224, batch 4, card against the
              port's CPU run: dense and Eq.-5 logits, and a train step's loss
              and gradients at phases -1 and 0 (no gradient on u, first,
              last at phase 0);
22. table1 — ResNet-50, 224 x 224, batch 64, float32, over org / lrd /
              rankopt / freeze / combined (and phase 1 of freeze and
              combined): train and inference images/s from the median of 10
              steps, wall and device time, idle share;
23. sequential — 6 steps of ResNet-50 combined at batch 64, phases
              0,0,1,1,0,0, on ``SyntheticClassification(img=224)``: finite
              losses, no gradient on each step's frozen group;
24. table4 — ViT-B/16 (224 x 224, batch 64, 10 classes, float32) with the
              ViT policy over the same ladder.

Phases 20-24 run with TF32 off and the port's seeded init, through plain
PyTorch (cuDNN convs, ``torch.matmul``): the JAX package computes them
outside any Pallas kernel, so no hand-written kernel is on their path.

Phase 3 also holds K1-K5 at the Algorithm-1 training shapes and at the
decay schedule's ranks; the energy boundary's ranks are decided on the
card, and the shapes it launched that phase 3 did not check are checked
and timed after it.  ``--only kernels`` runs phases 1-3, the K6-K8 checks
and phase 19; ``--only conv`` runs phases 1 and 20-24.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the
line before it is ``nvidia-smi``'s name and power limit, and the
``{"kernels": [...]}`` line comes before that.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
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
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
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
# K8 is held row by row (``row_rel_err``): the largest over query rows of
# max |kernel - plain| / max |plain| in that row, since in causal attention
# max |plain| over the whole output is row 0's (= v_0) and later rows,
# averaging over many keys, are several times smaller.  K8 rounds p to
# bf16 relative to the running max of each 64-key tile, where its plain
# version takes one max over all keys: each p's rounding moves by up to
# 2**-9 relative, with random signs over the keys, so the float32 outputs
# before their one bf16 rounding differ by well under a bf16 ulp, and the
# rounded ones by at most one ulp of an element: up to 2**-7 = 7.8e-3 of
# the row's max, where that max is a power of two.  1e-2 holds that and
# fails a row a few percent off.
# K6 sums int8 products exactly in int32, so it must equal its plain version
# bit for bit (0).  Every step of K7 is an exact integer sum or one IEEE
# float32 operation in the plain version's order, so it should too; 1e-6
# of max |plain| leaves room for nothing more than a last-bit difference.
# Their serving entries add the quantizer and the scales, each step one IEEE
# float32 operation in the plain version's order: the same bounds.
KERNEL_RTOL = {"lowrank_matmul": 1e-2, "lowrank_gated_ffn": 2e-2, "lowrank_matmul_dx": 1e-2,
               "lowrank_matmul_du": 1e-2, "lowrank_matmul_dv": 1e-2, "int8_matmul": 0.0,
               "int8_lowrank_matmul": 1e-6, "int8_linear": 0.0, "int8_lowrank_linear": 1e-6,
               "flash_attention": 1e-2}
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
# in-training rank adaptation on the same run: decay 0.75 at each phase
# swap (steps 2 and 4), and one energy boundary (step 2 of 3)
DECAY_ARGV = TRAIN_ARGV + ["--rank-schedule", "decay"]
ENERGY_ARGV = TRAIN_ARGV + ["--rank-schedule", "energy", "--steps", "3"]
# bound on u @ v of apply_lrd's bf16 factors against a float64 truncated
# SVD of the same bf16 weight, relative to max |W_r|: rounding u and v to
# bf16 (2**-9 relative each) moves an entry of the product by about 2**-9
# of its size, with random signs over r terms, so the largest error over
# the matrix is about 2.5e-3 of its max (a CPU run at these shapes)
DECOMP_RTOL = 1e-2
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
# The int8 export: the serve CLI's flags, the int8 launches a forward and
# layer (7 projections), and the bound on the int8 trees' prefill logits,
# kernels vs plain versions, relative to max |logit| (K6 and K7 match their
# plain versions bit for bit, so the logits should too)
EXPORTS = ("analytic", "measured")
INT8_PER_LAYER = 7
INT8_PATH_RTOL = 1e-3
# The training CLI at Algorithm-1 ranks (no --no-rank-opt): two steps, one
# at phase 0 and one at phase 1, and the ranks JAX's RankResolver builds
ALG1_ARGV = ["--arch", "smollm-360m", "--lrd", "--use-pallas", "--freeze", "sequential",
             "--steps", "2", "--steps-per-epoch", "1", "--global-batch", "8",
             "--seq-len", "256", "--save-every", "1000", "--log-every", "1"]
ALG1_RANKS = {"wq": 239, "wo": 239, "wk": 80, "wv": 80, "gate": 256, "up": 256, "down": 256}
# The long-prompt flash serve: prompts of up to 2016 tokens, each padded to
# 2016, and 32 new tokens fill SmolLM's 2048-token context
# (max_position_embeddings); 8 slots, 16 requests at 1000 req/s, 16-position
# blocks, the pool fully provisioned
FLASH_PROMPT, FLASH_MAX_LEN, FLASH_NEW = 2016, 2048, 32
# prompt seeds of the flash parity phase's greedy runs
FLASH_PARITY_SEEDS = (1, 4, 5)
FLASH_SERVE_SHAPE = dict(B=1, Sq=FLASH_PROMPT, Sk=FLASH_PROMPT, H=15, KV=5, D=64, causal=True)
# K8 beyond the serve's shape: ragged Sq = Sk, Sq < Sk without the causal
# mask, two batch rows, and D 128 with g = 8 (qwen2-72b's 64 / 8 heads)
FLASH_EXTRA = [dict(FLASH_SERVE_SHAPE, Sq=1, Sk=1), dict(FLASH_SERVE_SHAPE, Sq=17, Sk=17),
               dict(FLASH_SERVE_SHAPE, Sq=500, causal=False), dict(FLASH_SERVE_SHAPE, B=2),
               dict(B=1, Sq=512, Sk=512, H=64, KV=8, D=128, causal=True)]


def log(msg: str) -> None:
    print(msg, flush=True)


# device clock cycles the timing loop holds the card after each flush
# (about 0.5 ms at the H100's 1.98 GHz boost clock)
HOLD_CYCLES = 1_000_000


def cuda_time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn()`` over ``iters`` launches, each after
    an L2 flush (the serving path reads every layer's factors cold).  A
    sleep kernel after the flush gives the host time to enqueue all of
    ``fn`` before the start event is reached, however slow the host, so
    host overhead stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
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


def row_rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, the largest over rows of the last axis of max
    |got - want| / max |want| in that row)."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(dim=-1).clamp_min(1e-30)
    return diff.max().item(), (diff.amax(dim=-1) / scale).max().item()


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
# the same at the Algorithm-1 ranks of the training CLI
PROJ_ALG1 = {"wq/wo": (960, 239, 960), "wk/wv": (960, 80, 320), "gate/up": (960, 256, 2560),
             "down": (2560, 256, 960)}
# the Eq.-5 train run's ranks after each boundary of --rank-schedule decay
# (JAX's _decay_target: floor(0.75 r), floored to the 128 tile, ranks under
# one tile kept)
PROJ_DECAY = ({"wq/wo": (960, 128, 960), "wk/wv": (960, 90, 320), "gate/up": (960, 256, 2560),
               "down": (2560, 256, 960)},
              {"wq/wo": (960, 96, 960), "wk/wv": (960, 67, 320), "gate/up": (960, 128, 2560),
               "down": (2560, 128, 960)})
# (C, S) of each factorised projection of smollm-360m, by its path's leaf
GEOM = {"wq": (960, 960), "wo": (960, 960), "wk": (960, 320), "wv": (960, 320),
        "gate": (960, 2560), "up": (960, 2560), "down": (2560, 960)}
BWD = ("lowrank_matmul_dx", "lowrank_matmul_du", "lowrank_matmul_dv")
LOWRANK_FWD = ("lowrank_matmul", "lowrank_gated_ffn")
# kernels that must give the same bits on every call (no atomics; K3/K4's
# split sums are added in a fixed order)
REPEATABLE = ("lowrank_matmul_dx", "lowrank_matmul_du", "lowrank_matmul_dv")
# the M at which both K1/K5 designs are timed, to place LARGE_M; the
# threshold's two sides are added from the wrappers' constants
DESIGN_SWEEP_M = (128, 256, 512, 2016)


def kernel_shapes():
    """(name, dims) of every K1-K5 call on the serve, flash serve and train
    paths."""
    out = []
    for m in (DECODE_M, PREFILL_M, FLASH_PROMPT):
        for proj in ("wq/wo", "wk/wv", "down"):
            c, r, s = PROJ[proj]
            out.append(("lowrank_matmul", dict(M=m, C=c, r=r, S=s)))
        out.append(("lowrank_gated_ffn", dict(M=m, C=960, r=349, F=2560)))
    # the decay run trains at its first shrunk map in phase 1 (no K4) and
    # at its second in phase 0 (no K3)
    for proj, bwd in ((PROJ, BWD), (PROJ_ALG1, BWD),
                      (PROJ_DECAY[0], ("lowrank_matmul_dx", "lowrank_matmul_du")),
                      (PROJ_DECAY[1], ("lowrank_matmul_dx", "lowrank_matmul_dv"))):
        for c, r, s in proj.values():
            out.append(("lowrank_matmul", dict(M=TRAIN_M, C=c, r=r, S=s)))
        c, r, f = proj["gate/up"]
        out.append(("lowrank_gated_ffn", dict(M=TRAIN_M, C=c, r=r, F=f)))
        for name in bwd:
            for c, r, s in proj.values():
                out.append((name, dict(M=TRAIN_M, C=c, r=r, S=s)))
    unique = []  # a shape two rank sets share is checked once
    for name, d in out:
        if (name, d) not in unique:
            unique.append((name, d))
    return unique


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


def _pad(a, rows: int, cols: int):
    """``a`` zero-padded to at least ``rows`` rows and ``cols`` columns."""
    return F.pad(a, (0, max(0, cols - a.shape[1]), 0, max(0, rows - a.shape[0])))


# the int8 kernels' serving entries and their int8-operand twins
INT8_FUSED = {"int8_linear": "int8_matmul", "int8_lowrank_linear": "int8_lowrank_matmul"}


def int8_kernel_case(name, d, gen):
    """Inputs, kernel, plain version, library call, bytes and int8 operations
    of K6 (``int8_matmul``, serving entry ``int8_linear``) or K7
    (``int8_lowrank_matmul``, ``int8_lowrank_linear``) at ``d``.

    The library yardstick is ``torch._int_mm``, whose CUDA path wants more
    than 16 rows and a depth and width that are multiples of 8: its operands
    are zero-padded to that once, outside the timing (zero rows and ranks
    add nothing), and the result is sliced back.  For a serving entry the
    yardstick also quantizes x with the torch quantizer (into the padded
    buffer) and applies the scales, as the port did before its kernels
    took them in."""
    from repro_torch.kernels import int8_matmul as k8
    from repro_torch.kernels import ref

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)

    def scales(n):
        return (torch.rand((1, n), generator=gen, device="cuda") + 0.5) * 1e-2

    def up8(n):
        return -(-n // 8) * 8

    m, c, s = d["M"], d["C"], d["S"]
    fused = name in INT8_FUSED
    if fused:  # x as the serve path hands it over: bf16 activations
        x = torch.randn((m, c), generator=gen, device="cuda").to(torch.bfloat16)
        xp = torch.zeros((max(32, m), up8(c)), dtype=torch.int8, device="cuda")
    else:
        x = i8(m, c)
        xp = _pad(x, 32, up8(c))
    xbytes, ybytes = (2 * m * c, 2 * m * s) if fused else (m * c, 4 * m * s)

    def x_q():  # the yardstick's quantizer: torch ops into the padded buffer
        q, xs = ref.quantize_rowwise(x)
        xp[:m, :c].copy_(q)
        return xs

    if name in ("int8_matmul", "int8_linear"):
        w = i8(c, s)
        wp = _pad(w, up8(c), up8(s))
        if not fused:
            return dict(kernel=lambda: k8.int8_matmul(x, w),
                        plain=lambda: ref.int8_matmul_ref(x, w),
                        library=lambda: torch._int_mm(xp, wp)[:m, :s],
                        bytes=xbytes + c * s + ybytes, ops=2 * m * c * s)
        ws = scales(s)

        def library():
            xs = x_q()
            return (torch._int_mm(xp, wp)[:m, :s].float() * xs * ws).to(x.dtype)

        return dict(kernel=lambda: k8.int8_linear(x, w, ws),
                    plain=lambda: ref.int8_linear_ref(x, w, ws), library=library,
                    bytes=xbytes + c * s + 4 * s + ybytes, ops=2 * m * c * s)
    r = d["r"]
    u, us, v, vs = i8(c, r), scales(r), i8(r, s), scales(s)
    up_, usp, vp = _pad(u, up8(c), up8(r)), _pad(us, 1, up8(r)), _pad(v, up8(r), up8(s))
    vsp = _pad(vs, 1, up8(s))

    def lowrank():  # the same algebra around two library products
        t = torch._int_mm(xp, up_).float() * usp
        ts = torch.clamp(torch.amax(torch.abs(t), dim=1, keepdim=True), min=1e-8) / 127.0
        tq = torch.clamp(torch.round(t / ts), -127, 127).to(torch.int8)
        return (torch._int_mm(tq, vp).float() * ts * vsp)[:m, :s]

    def library():
        xs = x_q()
        return (lowrank() * xs).to(x.dtype)

    args = (x, u, us, v, vs)
    kernel = k8.int8_lowrank_linear if fused else k8.int8_lowrank_matmul
    plain = ref.int8_lowrank_linear_ref if fused else ref.int8_lowrank_matmul_ref
    return dict(kernel=lambda: kernel(*args), plain=lambda: plain(*args),
                library=library if fused else lowrank,
                bytes=xbytes + c * r + 4 * r + r * s + 4 * s + ybytes,
                ops=2 * m * c * r + 2 * m * r * s)


def check_and_time(name, d, case, iters, flush, peak):
    """Hold a kernel against its plain version, then time kernel, plain
    version and library call; returns the kernel's row."""
    got = case["kernel"]()
    want = case["plain"]()
    torch.cuda.synchronize()
    err, rel = case.get("err", rel_err)(got, want)
    _, rel_all = rel_err(got, want)
    rtol = KERNEL_RTOL[name]
    if not math.isfinite(err) or rel > rtol or (rtol == 0 and not torch.equal(got, want)):
        raise AssertionError(f"{name} {d}: max_abs_err {err:.3e}, relative error {rel:.3e} "
                             f"> {rtol}")
    if name in REPEATABLE and not torch.equal(case["kernel"](), got):
        raise AssertionError(f"{name} {d}: a second call on the same inputs gave other bits")
    ms = cuda_time_ms(case["kernel"], iters, flush)
    plain_ms = cuda_time_ms(case["plain"], iters, flush)
    try:
        lib_ms = cuda_time_ms(case["library"], iters, flush)
    except RuntimeError as e:  # a shape the library call does not take
        log(f"[kernels] {name} {d}: library call not timed ({str(e).splitlines()[0]})")
        lib_ms = None
    t_bytes = case["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = case["ops"] / peak * 1e3
    row = dict(name=name, shape=d, max_abs_err=err, rel_err=rel, rel_err_of_max=rel_all,
               rtol=rtol, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               tflops=case["ops"] / ms * 1e-9)
    row["bound_share"] = row["bound_ms"] / ms
    log(f"[kernels] {name} {d}: err {err:.3e} (rel {rel:.2e}"
        + (f" by row, {rel_all:.2e} of max |plain|" if "err" in case else "") + "), kernel "
        f"{ms * 1e3:.1f}us, plain {plain_ms * 1e3:.1f}us, library "
        + (f"{lib_ms * 1e3:.1f}us" if lib_ms is not None else "n/a")
        + f", bound {row['bound_ms'] * 1e3:.2f}us ({row['bound_by']})"
        + (f"; {row['tflops']:.1f} TFLOP/s, {row['bound_share']:.1%} of the bound"
           if name in LOWRANK_FWD + BWD else "")
        + ("; bitwise repeatable" if name in REPEATABLE else ""))
    return row


def _flush_buffer():
    return torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2


def phase_kernels(shapes=None, iters: int = 50):
    """K1-K5 at ``shapes`` ((name, dims) pairs; every main-path shape known
    before the run by default)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = _flush_buffer()
    rows = []
    for name, d in kernel_shapes() if shapes is None else shapes:
        case = kernel_case(name, d, gen)
        case["ops"] = case.pop("flops")
        rows.append(check_and_time(name, d, case, iters, flush, BF16_FLOPS_PER_S))
    zero_counts()  # launches made to compare and time are not the main path's
    return rows


def phase_designs(iters: int = 30):
    """Both K1/K5 designs (decode and large-M, through the wrappers'
    ``_launch``) against the plain version and timed, at DESIGN_SWEEP_M and
    on both sides of each wrapper's LARGE_M, for every K1 geometry of the
    train paths and K5 at both rank sets.  Reported beside ``flash_extra``,
    not in the kernels line: no main path launches these shapes."""
    from repro_torch.kernels import lowrank_ffn as k5m
    from repro_torch.kernels import lowrank_matmul as k1m
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = _flush_buffer()

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    geoms = sorted(set(PROJ.values()) | set(PROJ_ALG1.values()))
    out = []
    for name, lm, cases in (("lowrank_matmul", k1m.LARGE_M, geoms),
                            ("lowrank_gated_ffn", k5m.LARGE_M,
                             sorted({PROJ["gate/up"], PROJ_ALG1["gate/up"]}))):
        for m in sorted(set(DESIGN_SWEEP_M) | {lm - 1, lm}):
            for c, r, s_ in cases:
                x = rnd(m, c)
                if name == "lowrank_matmul":
                    u, v = rnd(c, r, scale=c ** -0.5), rnd(r, s_, scale=r ** -0.5)
                    args, mod, plain = (x, u, v), k1m, ref.lowrank_matmul_ref
                else:
                    args = (x, rnd(c, r, scale=c ** -0.5), rnd(r, s_, scale=r ** -0.5),
                            rnd(c, r, scale=c ** -0.5), rnd(r, s_, scale=r ** -0.5))
                    mod, plain = k5m, ref.lowrank_gated_ffn_ref
                want = plain(*args)
                row = dict(name=name, M=m, C=c, r=r, S=s_, large_m=lm)
                for design in ("decode", "large"):
                    fn = (lambda large=design == "large": mod._launch(*args, large=large))
                    got = fn()
                    torch.cuda.synchronize()
                    err, rel = rel_err(got, want)
                    if not math.isfinite(err) or rel > KERNEL_RTOL[name]:
                        raise AssertionError(f"designs: {name} {design} at M {m}, ({c}, {r}, "
                                             f"{s_}): relative error {rel:.3e} > "
                                             f"{KERNEL_RTOL[name]}")
                    row[design] = dict(max_abs_err=err, rel_err=rel,
                                       ms=cuda_time_ms(fn, iters, flush))
                log(f"[designs] {name} M {m} ({c}, {r}, {s_}): decode "
                    f"{row['decode']['ms'] * 1e3:.1f}us (rel {row['decode']['rel_err']:.1e}), "
                    f"large {row['large']['ms'] * 1e3:.1f}us (rel "
                    f"{row['large']['rel_err']:.1e}); the wrapper takes "
                    f"{'large' if m >= lm else 'decode'} (LARGE_M {lm})")
                out.append(row)
    zero_counts()
    return out


def lowrank_device_ms(by_name):
    """(K1 ms, K5 ms) of a profile's device time by kernel name, both designs."""
    k1 = sum(ms for n, ms in by_name.items()
             if "lowrank_matmul_kernel" in n or "lowrank_matmul_large_kernel" in n)
    k5 = sum(ms for n, ms in by_name.items()
             if "lowrank_ffn_kernel" in n or "lowrank_ffn_large_kernel" in n)
    return k1, k5


def bwd_device_ms(by_name):
    """(K2 ms, K3 ms, K4 ms) of a profile's device time by kernel name:
    K2's launches are named ``bwd::k2_*``, K3's ``bwd::k3_*`` and K4's
    ``bwd::k4_*`` (csrc/lowrank_bwd.cu)."""
    return tuple(sum(ms for n, ms in by_name.items() if key in n)
                 for key in ("bwd::k2_", "bwd::k3_", "bwd::k4_"))


def phase_int8_kernels(shapes, iters: int = 50):
    """K6 and K7 at every (M, C[, r], S) the export serve runs launched:
    the serving entry there, then its int8-operand twin at the same shape."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = _flush_buffer()
    rows = []
    for fused, key in shapes:
        for name in (fused, INT8_FUSED[fused]):
            d = (dict(M=key[0], C=key[1], S=key[2]) if name in ("int8_matmul", "int8_linear")
                 else dict(M=key[0], C=key[1], r=key[2], S=key[3]))
            rows.append(check_and_time(name, d, int8_kernel_case(name, d, gen), iters, flush,
                                       INT8_OPS_PER_S))
    zero_counts()
    return rows


def int8_device_ms(by_name):
    """(K6 ms, K7 ms) of a profile's device time by kernel name: K6 is
    ``i8::k6_kernel``, K7 ``i8::k7_rank_kernel`` and ``i8::k7_out_kernel``
    (csrc/int8_matmul.cu)."""
    return tuple(sum(ms for n, ms in by_name.items() if any(k in n for k in keys))
                 for keys in (("i8::k6_kernel",), ("i8::k7_rank_kernel", "i8::k7_out_kernel")))


def phase_int8_launches():
    """The device launches of one ``ops.int8_apply`` and one
    ``ops.int8_lowrank_apply`` call at decode (M = 8, bf16 x) on random int8
    leaves of the wq / wo geometry (C 960, S 960, r 128): the distinct
    device operations (kernels, memsets, copies) the profiler sees over 20
    calls, at most 3 each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((DECODE_M, 960), generator=gen, device="cuda").to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (960, 960), generator=gen, device="cuda",
                        dtype=torch.int32).to(torch.int8)
    ws = (torch.rand((1, 960), generator=gen, device="cuda") + 0.5) * 1e-2
    u_q, us, v_q, vs = w_q[:, :128].contiguous(), ws[:, :128].contiguous(), w_q[:128], ws
    calls = {"int8_apply": lambda: ops.int8_apply(x, w_q, ws, use_kernel=True),
             "int8_lowrank_apply": lambda: ops.int8_lowrank_apply(x, u_q, us, v_q, vs,
                                                                  use_kernel=True)}
    out, reps = {}, 20
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # the distinct device operations a call runs (the profiler can drop
        # some of a run's events, so they are not counted one by one); any
        # other kernel, memset or copy would show here
        names = sorted({ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA})
        out[name] = dict(launches=len(names), kernels=names)
        if not names or len(names) > 3:
            raise AssertionError(f"int8 launches: ops.{name} runs {len(names)} distinct device "
                                 f"operations a call, want 1 to 3: {names}")
    zero_counts()
    log(f"[int8 launches] one decode call (M {DECODE_M}, bf16 x): ops.int8_apply "
        f"{out['int8_apply']['launches']} device launches a call (parent: ~16), "
        f"ops.int8_lowrank_apply {out['int8_lowrank_apply']['launches']} (parent: ~13): "
        + "; ".join(f"{k}: {', '.join(n[:48] for n in v['kernels'])}" for k, v in out.items()))
    return out


def wrappers():
    """name -> kernel wrapper (each carries ``launches`` and
    ``launches_by_shape``)."""
    from repro_torch.kernels import lowrank_bwd as kb
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels import int8_matmul as k8
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul

    return {"lowrank_matmul": lowrank_matmul, "lowrank_gated_ffn": lowrank_gated_ffn,
            "lowrank_matmul_dx": kb.lowrank_matmul_dx,
            "lowrank_matmul_du": kb.lowrank_matmul_du,
            "lowrank_matmul_dv": kb.lowrank_matmul_dv,
            "int8_matmul": k8.int8_matmul, "int8_lowrank_matmul": k8.int8_lowrank_matmul,
            "int8_linear": k8.int8_linear, "int8_lowrank_linear": k8.int8_lowrank_linear,
            "flash_attention": flash_attention}


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
    if name in ("int8_matmul", "int8_linear"):
        return d["M"], d["C"], d["S"]
    if name == "flash_attention":
        return d["B"], d["Sq"], d["Sk"], d["H"], d["KV"], d["D"], d["causal"]
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


def device_ms_by_kernel(prof, steps: int):
    """Device time per call by kernel name, from the profiler's device-side
    events only (kernels, memcpy, memset; the CPU ops that launched them
    carry the same time).  Each event counts only the time after the
    events that started before it ended: a kernel launched as a
    programmatic dependent (K3/K4's later launches) starts while the one
    before it runs and waits, and that overlap is counted once, so the sum
    is the time the device was busy."""
    from torch.autograd import DeviceType

    evs = sorted(((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA))
    by_name, busy_until = {}, float("-inf")
    for start, end, name in evs:
        ms = max(0.0, end - max(start, busy_until)) / steps / 1e3
        busy_until = max(busy_until, end)
        by_name[name] = by_name.get(name, 0.0) + ms
    return by_name


def phase_profile(engine, steps: int = 5, label: str = "decode step", int8: bool = False):
    """Where a full-width decode step's time goes: wall time per step (host
    clock around synchronised steps), device time per step by kernel
    (``torch.profiler``), and the device's idle share of the step; for an
    int8 tree also its device launches, K6 / K7 ms and torch quantizer ops
    a step (none may run)."""
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
    by_name = device_ms_by_kernel(prof, steps)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(wall_ms=wall_ms, device_ms=device_ms if device_ms else None,
               idle_share=(1 - device_ms / wall_ms) if device_ms else None,
               top=[dict(name=k[:80], ms=v) for k, v in top])
    shown = ", ".join(f"{k[:40]} {v * 1e3:.0f}us" for k, v in top[:5])
    extra = ""
    if int8:
        from torch.autograd import DeviceType

        out["device_launches"] = sum(1 for ev in prof.events()
                                     if ev.device_type == DeviceType.CUDA) / steps
        # the torch quantizer's mark: no other op of a decode step rounds
        out["quantizer_ops"] = sum(1 for ev in prof.events()
                                   if ev.device_type == DeviceType.CPU
                                   and ev.name == "aten::round") / steps
        out["k6_ms"], out["k7_ms"] = int8_device_ms(by_name)
        extra = (f"; {out['device_launches']:.0f} device launches a step, K6 "
                 f"{out['k6_ms']:.2f} ms, K7 {out['k7_ms']:.2f} ms, torch quantizer ops "
                 f"(aten::round) {out['quantizer_ops']:.0f}")
        if out["quantizer_ops"]:
            raise AssertionError(f"{label}: {out['quantizer_ops']} torch quantizer ops a step")
    log(f"[profile] {label} (8 slots, 32 layers): wall {wall_ms:.2f} ms, device "
        + (f"{device_ms:.2f} ms, idle {out['idle_share']:.1%}; top: {shown}"
           if device_ms else "time not measured (profiler saw no device events)") + extra)
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


def _at(tree, path: str):
    """The subtree of ``tree`` at a '/'-joined path."""
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _shape_tree(tree):
    from repro_torch.core.freezing import tree_map

    return tree_map(lambda t: (tuple(t.shape), t.dtype), tree)


def phase_decompose():
    """Dense full-width smollm-360m from a seeded generator through
    ``apply_lrd`` at Eq.-5 and Algorithm-1 ranks (timed, checked against the
    init-time plan and a float64 SVD), ``randomized_svd`` against
    ``svd_decompose`` on one slice, then the Eq.-5 tree served through the
    kernels with K1/K5 launches counted."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import svd
    from repro_torch.core.decompose import apply_lrd, iter_factor_groups
    from repro_torch.core.freezing import tree_leaves
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul
    from repro_torch.launch import serve, steps
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServeEngine

    run = serve.serve_run(get_config("smollm-360m"), max_len=PREFILL_M + 32, slots=DECODE_M,
                          lrd=True, device=torch.device("cuda"), seed=0)
    dense_run = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, enabled=False))
    dense, dense_plan = steps.init_params(dense_run, "cuda")
    n_dense = sum(t.numel() for t in tree_leaves(dense))
    if dense_plan.layers or any(t.dtype != torch.bfloat16 for t in tree_leaves(dense)):
        raise AssertionError("decompose: the dense init is not a bf16 tree without LRD")
    torch.linalg.svd(torch.ones((64, 64), device="cuda"))  # cuSOLVER's set-up, untimed
    torch.cuda.synchronize()
    exact = {}  # path -> float64 SVD of layer 0 (CPU)
    out, trees = dict(dense_params=n_dense), {}
    for name, quantize in (("eq5", False), ("alg1", True)):
        r_run = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, rank_quantize=quantize))
        dec = steps.make_decomposer(r_run, device="meta")
        layout = lm.lm_init(r_run.model, dec)  # the init-time plan and shapes, no data
        t0 = time.perf_counter()
        tree, plan = apply_lrd(dense, dec.policy)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        # the init names the stacked layers "layers", the tree keeps them under "stack"
        want = {p.replace("layers/", "stack/", 1):
                dataclasses.replace(lp, path=p.replace("layers/", "stack/", 1))
                for p, lp in dec.plan.layers.items()}
        if plan.layers != want or _shape_tree(tree) != _shape_tree(layout):
            raise AssertionError(f"decompose ({name}): plan or layout differs from the "
                                 f"init-time Decomposer's: {plan.to_json()}")
        errs = {}
        for path, g in iter_factor_groups(tree):
            if path not in exact:
                w64 = _at(dense, path)["kernel"][0].double().cpu()
                exact[path] = (w64, torch.linalg.svd(w64, full_matrices=False))
            w64, (u64, s64, vh64) = exact[path]
            r = g["u"].shape[-1]
            w_r = (u64[:, :r] * s64[:r]) @ vh64[:r]
            got = (g["u"][0].double() @ g["v"][0].double()).cpu()
            _, rel = rel_err(got, w_r)
            errs[path.rsplit("/", 1)[-1]] = dict(
                rank=r, rel_err=rel,
                eq3=((torch.sum((w64 - w_r) ** 2) / torch.sum(w64 ** 2)) ** 0.5).item())
            if not math.isfinite(rel) or rel > DECOMP_RTOL:
                raise AssertionError(f"decompose ({name}): {path} layer 0 u @ v is {rel:.3e} "
                                     f"of max |W_r| off the float64 truncated SVD "
                                     f"(bound {DECOMP_RTOL})")
        out[name] = dict(seconds=secs, summary=plan.summary(), layers=errs)
        log(f"[decompose] apply_lrd ({name}, {plan.summary()}) on dense smollm-360m "
            f"({n_dense / 1e6:.1f} M params, bf16, 32 layers): {secs:.2f} s on "
            f"{torch.cuda.get_device_name(0)}; layer 0 u @ v against a float64 truncated SVD "
            f"(max |diff| / max |W_r|, bound {DECOMP_RTOL}; Eq. 3 ||W - W_r|| / ||W||): "
            + ", ".join(f"{k} r {e['rank']} {e['rel_err']:.2e} ({e['eq3']:.3f})"
                        for k, e in errs.items()))
        trees[name] = tree
    # randomized against exact SVD on one (960, 2560) slice at its Eq.-5 rank
    w = _at(dense, "stack/ffn/gate")["kernel"][0]
    r = trees["eq5"]["stack"]["ffn"]["gate"]["u"].shape[-1]
    cmp = {}
    for fn in (svd.svd_decompose, svd.randomized_svd):
        fn(w, r)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, v = fn(w, r)
        torch.cuda.synchronize()
        cmp[fn.__name__] = dict(ms=(time.perf_counter() - t0) * 1e3,
                                err=(svd.reconstruction_error(w, u, v)
                                     / torch.sum(w.float() ** 2)).item())
    if not cmp["svd_decompose"]["err"] <= cmp["randomized_svd"]["err"]:
        raise AssertionError(f"decompose: the exact truncated SVD's error exceeds the "
                             f"randomized one's (Eckart-Young): {cmp}")
    out["svd_vs_randomized"] = dict(shape=[960, 2560], rank=r, **cmp)
    log(f"[decompose] (960, 2560) slice at r {r}: svd_decompose "
        f"{cmp['svd_decompose']['ms']:.1f} ms, ||W - UV||^2 / ||W||^2 "
        f"{cmp['svd_decompose']['err']:.4f}; randomized_svd {cmp['randomized_svd']['ms']:.1f} ms, "
        f"{cmp['randomized_svd']['err']:.4f}")
    del trees["alg1"], exact
    # serve the Eq.-5 tree
    engine = ServeEngine(run, trees.pop("eq5"), device="cuda",
                         config=ServeConfig(num_slots=DECODE_M, max_len=PREFILL_M + 32,
                                            prefill_len=PREFILL_M, block_size=16))
    trace = serve.poisson_trace(8, 1000.0, PREFILL_M, run.model.vocab_size, seed=3)
    for req in trace:
        req["max_new"] = 16
    zero_counts()
    t0 = time.perf_counter()
    outs = engine.serve(trace)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers().items()}
    by_shape = counts_by_shape()
    fwd = engine.scheduler.forward_stats
    n_fwd, n_layers = fwd["prefill"] + fwd["decode"], run.model.num_layers
    want = {"lowrank_matmul": 5 * n_layers * n_fwd, "lowrank_gated_ffn": n_layers * n_fwd}
    got = {k: n for k, n in counts.items() if n or k in want}
    if len(outs) != 8 or any(len(o) != 16 for o in outs) or fwd["nonfinite"] or got != want:
        raise AssertionError(f"decompose serve: {[len(o) for o in outs]} tokens, "
                             f"{fwd['nonfinite']} non-finite forwards, launches {got}, want {want}")
    log(f"[decompose] served the Eq.-5 tree: 8 requests x 16 tokens, {fwd['prefill']} prefill "
        f"+ {fwd['decode']} decode forwards, {lowrank_matmul.launches} K1 + "
        f"{lowrank_gated_ffn.launches} K5 launches = {5 * n_layers} + {n_layers} per forward; "
        f"{dt:.1f}s")
    out["serve"] = dict(fwd=dict(fwd), counts=got, wall_s=dt)
    return engine, by_shape, out


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
    state, per_step, by_shape, dt = _counted_train(TRAIN_ARGV)
    phases = [r["phase"] for r in per_step]
    if phases != [0, 0, 1, 1, 0, 0]:
        raise AssertionError(f"train: phases {phases}, want [0, 0, 1, 1, 0, 0]")
    for r in per_step:
        _check_step("train", r, _leaf_ranks(PROJ))
        log(f"[train] step {r['step']} phase {r['phase']}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms; launches "
            + ", ".join(f"{k.replace('lowrank_', '')} {n}" for k, n in r["launches"].items()
                        if n))
    log(f"[train] 6 steps of {TRAIN_M} tokens on {torch.cuda.get_device_name(0)}: loss "
        f"{per_step[0]['loss']:.4f} -> {per_step[-1]['loss']:.4f}; {dt:.1f}s incl. init")
    return state.params, by_shape, dict(steps=_without_shapes(per_step), wall_s=dt)


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


def phase_train_profile(params, steps_n: int = 2, run=None, phases=(-1, 0, 1),
                        label: str = "train profile"):
    """Wall time (host clock around synchronised steps), device time
    (``torch.profiler``, device-side events only) and idle share of a
    full-width train step at each freezing phase, with tokens/s."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    run = run or _train_run()
    batch = _train_batch(run, seed=98)
    out = {}
    for phase in phases:
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
        by_name = device_ms_by_kernel(prof, steps_n)
        device_ms = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        k1_ms, k5_ms = lowrank_device_ms(by_name)
        k2_ms, k3_ms, k4_ms = bwd_device_ms(by_name)
        out[phase] = dict(wall_ms=wall_ms, tok_per_s=TRAIN_M / wall_ms * 1e3,
                          device_ms=device_ms if device_ms else None,
                          idle_share=(1 - device_ms / wall_ms) if device_ms else None,
                          k1_ms=k1_ms, k5_ms=k5_ms, k2_ms=k2_ms, k3_ms=k3_ms, k4_ms=k4_ms,
                          top=[dict(name=k[:80], ms=v) for k, v in top])
        shown = ", ".join(f"{k[:40]} {v:.2f}ms" for k, v in top[:6])
        log(f"[{label}] phase {phase} step ({TRAIN_M} tokens, 32 layers): wall "
            f"{wall_ms:.1f} ms ({TRAIN_M / wall_ms * 1e3:.0f} tok/s), device "
            + (f"{device_ms:.1f} ms, idle {out[phase]['idle_share']:.1%}; K1 {k1_ms:.2f} ms, "
               f"K5 {k5_ms:.2f} ms, K2 {k2_ms:.2f} ms, K3 {k3_ms:.2f} ms, K4 {k4_ms:.2f} ms; "
               f"top: {shown}"
               if device_ms else "time not measured (profiler saw no device events)"))
        del state
    return out


# --------------------------------------------------------------------------
# In-training rank adaptation
# --------------------------------------------------------------------------

# memory_allocated after two steps at the same ranks and phase differs by
# up to 3.0 MiB on the H100 (the allocator's 512-byte rounding of each
# tensor, library workspaces); an untruncated tree of factors or moments
# left alive is at least 54 MiB (the frozen u at 96/67/128)
MEM_SLACK = 8 << 20


def _leaf_ranks(proj):
    """{projection leaf: rank} of a PROJ-style table."""
    pairs = {"wq": "wq/wo", "wo": "wq/wo", "wk": "wk/wv", "wv": "wk/wv", "gate": "gate/up",
             "up": "gate/up", "down": "down"}
    return {leaf: proj[key][1] for leaf, key in pairs.items()}


def _by_leaf(rank_map):
    return {path.rsplit("/", 1)[-1]: r for path, r in rank_map.items()}


def _expected_keys(ranks):
    """Each K1-K5 wrapper's ``launches_by_shape`` keys in a train step at
    ``ranks`` ({leaf: rank}): K1, K2, K3 and K4 on every factor pair, K5 on
    the gate/up pair."""
    pairs = {(TRAIN_M, c, ranks[leaf], s_) for leaf, (c, s_) in GEOM.items()}
    return {"lowrank_matmul": pairs, "lowrank_matmul_dx": pairs, "lowrank_matmul_du": pairs,
            "lowrank_matmul_dv": pairs,
            "lowrank_gated_ffn": {(TRAIN_M, 960, ranks["gate"], ranks["up"], 2560)}}


def _factor_bytes(rank_map, phase, n_layers):
    """(param bytes, optimizer bytes) of the factor pairs at ``rank_map``:
    bf16 (L, C, r) and (L, r, S) factors, and sgdm's one float32 moment for
    the trainable factor (v at phase 0, u at phase 1)."""
    params = opt = 0
    for path, r in rank_map.items():
        c, s_ = GEOM[path.rsplit("/", 1)[-1]]
        params += 2 * n_layers * r * (c + s_)
        opt += 4 * n_layers * r * (s_ if phase == 0 else c)
    return params, opt


def _counted_train(argv):
    """``train.main(argv)`` with each step's metrics, its launches by kernel
    and the shapes each kernel launched at, and
    ``torch.cuda.memory_allocated()`` after it."""
    import tempfile

    from repro_torch.launch import train

    per_step, prev, prev_shape = [], {}, {}

    def on_step(step, phase, metrics):
        now = {name: fn.launches for name, fn in wrappers().items()}
        shapes = counts_by_shape()
        gc.collect()  # tensors in reference cycles count until collected
        per_step.append(dict(
            step=step, phase=phase, **metrics, mem=torch.cuda.memory_allocated(),
            launches={k: n - prev.get(k, 0) for k, n in now.items()},
            shapes={k: {key for key, n in by.items() if n > prev_shape.get(k, {}).get(key, 0)}
                    for k, by in shapes.items()}))
        prev.update(now)
        prev_shape.update(shapes)

    zero_counts()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.perf_counter()
        state, _ = train.main(argv + ["--ckpt-dir", ckpt_dir], on_step=on_step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return state, per_step, counts_by_shape(), dt


def _without_shapes(per_step):
    return [{k: v for k, v in r.items() if k != "shapes"} for r in per_step]


def _check_step(path: str, r, ranks):
    """A counted train step at ``ranks``: TRAIN_LAUNCHES by name, the
    expected shapes, finite loss and grad norm."""
    want = {k: (v[r["phase"]] if isinstance(v, dict) else v) for k, v in TRAIN_LAUNCHES.items()}
    got = {k: n for k, n in r["launches"].items() if n or k in want}
    shapes = {k: keys for k, keys in _expected_keys(ranks).items() if want[k]}
    seen = {k: keys for k, keys in r["shapes"].items() if keys}
    if got != want or seen != shapes:
        raise AssertionError(f"{path}: step {r['step']} (phase {r['phase']}) launched {got} at "
                             f"{seen}, want {want} at {shapes}")
    if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
        raise AssertionError(f"{path}: step {r['step']} loss {r['loss']} grad norm "
                             f"{r['grad_norm']}")


def phase_rank_adapt_train():
    """The training CLI with ``--rank-schedule decay`` (6 steps, swaps at
    steps 2 and 4), then one ``--rank-schedule energy`` boundary (3 steps)."""
    state, per_step, by_shape, dt = _counted_train(DECAY_ARGV)
    n_layers = 32
    if [r["phase"] for r in per_step] != [0, 0, 1, 1, 0, 0]:
        raise AssertionError(f"rank adapt: phases {[r['phase'] for r in per_step]}")
    want_ranks = [_leaf_ranks(p) for p in (PROJ, PROJ, PROJ_DECAY[0], PROJ_DECAY[0],
                                           PROJ_DECAY[1], PROJ_DECAY[1])]
    step0 = per_step[0]
    fp, fo = _factor_bytes(step0["rank_map"], step0["phase"], n_layers)
    base = (step0["trainable_bytes"] + step0["frozen_bytes"] - fp, step0["opt_bytes"] - fo)
    for r, want in zip(per_step, want_ranks):
        ranks = _by_leaf(r["rank_map"])
        if ranks != want:
            raise AssertionError(f"rank adapt: step {r['step']} ranks {ranks}, want {want}")
        _check_step("rank adapt", r, ranks)
        fp, fo = _factor_bytes(r["rank_map"], r["phase"], n_layers)
        r["implied_bytes"] = (base[0] + fp, base[1] + fo)
        if (r["trainable_bytes"] + r["frozen_bytes"], r["opt_bytes"]) != r["implied_bytes"]:
            raise AssertionError(f"rank adapt: step {r['step']} params + opt bytes "
                                 f"{r['trainable_bytes'] + r['frozen_bytes']} + {r['opt_bytes']}, "
                                 f"the rank map implies {r['implied_bytes']}")
        log(f"[rank adapt] step {r['step']} phase {r['phase']} ranks wq/wo {ranks['wq']}, wk/wv "
            f"{ranks['wk']}, gate/up {ranks['gate']}, down {ranks['down']}: loss {r['loss']:.4f}, "
            f"grad norm {r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms; trainable "
            f"{r['trainable_bytes'] / 2 ** 20:.1f} MiB, frozen {r['frozen_bytes'] / 2 ** 20:.1f} MiB, "
            f"opt {r['opt_bytes'] / 2 ** 20:.1f} MiB, memory_allocated {r['mem'] / 2 ** 20:.1f} MiB; "
            f"launches " + ", ".join(f"{k.replace('lowrank_', '')} {n}"
                                     for k, n in r["launches"].items() if n))
    drops = []
    for b in (2, 4):
        before, after = per_step[b - 1], per_step[b]
        total = lambda r: r["trainable_bytes"] + r["frozen_bytes"] + r["opt_bytes"]  # noqa: E731
        d_bytes, d_mem = total(after) - total(before), after["mem"] - before["mem"]
        drops.append(dict(step=b, bytes=d_bytes, memory_allocated=d_mem))
        if not (d_bytes < 0 and d_mem < 0 and abs(d_mem - d_bytes) <= MEM_SLACK):
            raise AssertionError(f"rank adapt: boundary at step {b}: partition bytes moved by "
                                 f"{d_bytes}, memory_allocated by {d_mem} (slack {MEM_SLACK})")
        log(f"[rank adapt] boundary at step {b}: params + opt bytes {d_bytes / 2 ** 20:+.2f} MiB, "
            f"torch.cuda.memory_allocated {d_mem / 2 ** 20:+.2f} MiB")
    log(f"[rank adapt] 6 steps of {TRAIN_M} tokens with --rank-schedule decay: {dt:.1f}s "
        f"incl. init")
    e_state, e_steps, e_by_shape, e_dt = _counted_train(ENERGY_ARGV)
    if [r["phase"] for r in e_steps] != [0, 0, 1]:
        raise AssertionError(f"rank energy: phases {[r['phase'] for r in e_steps]}")
    start = _leaf_ranks(PROJ)
    for r in e_steps:
        ranks = _by_leaf(r["rank_map"])
        if any(ranks[k] > start[k] for k in start) or (r["step"] < 2 and ranks != start):
            raise AssertionError(f"rank energy: step {r['step']} ranks {ranks}")
        _check_step("rank energy", r, ranks)
    energy = _by_leaf(e_steps[-1]["rank_map"])
    log(f"[rank energy] --rank-schedule energy (0.98 of the squared singular mass, spectra "
        f"read on the card) after 2 steps: " + ", ".join(f"{k} {start[k]}->{energy[k]}"
                                                         for k in start)
        + f"; step 2 loss {e_steps[-1]['loss']:.4f}; {e_dt:.1f}s incl. init")
    return state.params, by_shape, e_by_shape, dict(
        steps=_without_shapes(per_step), drops=drops, wall_s=dt,
        energy_steps=_without_shapes(e_steps), energy_ranks=energy)


def phase_rank_map_profiles(params, final):
    """Train steps profiled as in phase 9 at the decay schedule's two shrunk
    rank maps: ``params`` (Eq.-5 ranks) truncated to the first, and the
    decay run's final params (the second)."""
    from repro_torch.core import rank_adapt

    first = {p: _leaf_ranks(PROJ_DECAY[0])[p.rsplit("/", 1)[-1]]
             for p in rank_adapt.live_rank_map(params)}
    out = {}
    for label, p in (("map 1", rank_adapt.truncate_params(params, first)), ("map 2", final)):
        ranks = _by_leaf(rank_adapt.live_rank_map(p))
        out[label] = dict(ranks=ranks, profile=phase_train_profile(
            p, label=f"rank {label} train profile ({ranks['wq']}/{ranks['wk']}/{ranks['gate']})"))
    return out


def shape_dims(name, key):
    """Inverse of :func:`shape_key` for K1-K5."""
    if name == "lowrank_gated_ffn":
        m, c, r, _, f = key
        return dict(M=m, C=c, r=r, F=f)
    m, c, r, s_ = key
    return dict(M=m, C=c, r=r, S=s_)


# --------------------------------------------------------------------------
# The Algorithm-1 int8 export (K6, K7) and Algorithm-1 training
# --------------------------------------------------------------------------

# K6/K7 shapes checked by ``--only kernels`` (no serve run to read them
# from): the analytic export's K7 shapes and every geometry as K6 (serving
# entries; phase 14 adds the int8-operand twins)
INT8_DEFAULT_SHAPES = (
    [("int8_lowrank_linear", (m, c, r, s)) for m in (DECODE_M, PREFILL_M)
     for c, r, s in ((960, 128, 960), (960, 119, 320), (960, 256, 2560), (2560, 256, 960))]
    + [("int8_linear", (m, c, s)) for m in (DECODE_M, PREFILL_M)
       for c, s in ((960, 960), (960, 320), (960, 2560), (2560, 960))])


def _geometries(report):
    """(C, S) -> [(path, LayerExport)] of an export report, in path order."""
    out = {}
    for path, lay in sorted(report.layers.items()):
        out.setdefault(tuple(lay.shape), []).append((path, lay))
    return out


def phase_export_serve(kind: str):
    """The serve CLI on the int8 artifact of the ``kind`` export, launches
    counted: every forward makes 224 int8 launches, K7 for each kept factor
    pair and K6 for each merged group, and no K1/K5."""
    from repro_torch.launch import serve

    zero_counts()
    t0 = time.perf_counter()
    engine, outs = serve.main(SERVE_ARGV + ["--export", kind, "--export-int8"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers().items()}
    by_shape = counts_by_shape()
    report = engine.export_report
    sched = engine.scheduler
    fwd = sched.forward_stats
    n_fwd = fwd["prefill"] + fwd["decode"]
    n_layers = engine.run.model.num_layers
    if len(outs) != 16 or any(len(o) != 32 for o in outs):
        raise AssertionError(f"export serve ({kind}): want 16 requests x 32 tokens, got "
                             f"{[len(o) for o in outs]}")
    if fwd["nonfinite"]:
        raise AssertionError(f"export serve ({kind}): {fwd['nonfinite']} forwards with "
                             f"non-finite logits")
    merged = sorted(p for p, lay in report.layers.items() if lay.merged)
    kept = len(report.layers) - len(merged)
    per_layer_merged = sum(1 for p in merged if p.startswith("stack/"))
    k6, k7 = counts["int8_linear"], counts["int8_lowrank_linear"]
    # nothing else: no K1/K5 and no int8-operand entry (x is quantized in the kernels)
    others = {k: n for k, n in counts.items() if n and k not in INT8_FUSED}
    want_k6 = n_layers * per_layer_merged * n_fwd
    per_forward = INT8_PER_LAYER * n_layers
    if (n_fwd == 0 or others or k6 + k7 != per_forward * n_fwd or k6 != want_k6
            or len(report.layers) != INT8_PER_LAYER):
        raise AssertionError(f"export serve ({kind}): {n_fwd} forwards, {len(report.layers)} "
                             f"groups ({len(merged)} merged) but {k6} K6 + {k7} K7 launches "
                             f"(want {want_k6} K6 and {per_forward} a forward in all) and "
                             f"other kernels {others}")
    if kind == "analytic" and k6:
        raise AssertionError(f"export serve (analytic): {k6} K6 launches, want 0")
    log(f"[export {kind}] {report.summary()}")
    for (c, s_), groups in _geometries(report).items():
        lay = groups[0][1]
        log(f"[export {kind}]   (C {c}, S {s_}): {', '.join(p.split('/')[-1] for p, _ in groups)}"
            f" r_train {lay.rank_train} -> r_serve {lay.rank_serve}, "
            f"{'merged dense (K6)' if lay.merged else 'factorised (K7)'}; t_dense "
            f"{lay.original_time * 1e6:.2f}us, t_decomposed {lay.decomposed_time * 1e6:.2f}us"
            f" ({'v5e roofline model, not this card' if kind == 'analytic' else 'this card'})")
    if kind == "measured":
        for (c, s_, r), dec in sorted(report.decisions.items()):
            sweep = " ".join(f"{r_}:{t * 1e6:.1f}" for r_, t in zip(dec.searched, dec.times))
            log(f"[export measured] t(r) us at m {DECODE_M}, (C {c}, S {s_}), dense "
                f"{dec.original_time * 1e6:.1f}: {sweep}")
        log(f"[export measured] the guard merged {len(merged)} of {INT8_PER_LAYER} groups"
            + (f": {', '.join(p.split('/')[-1] for p in merged)}" if merged else
               " — K6 is reached only by the kernel phase in this run"))
    stats = sched.latency_stats()
    log(f"[export {kind}] {len(outs)} requests, {int(stats['generated_tokens'])} tokens, "
        f"{stats['tok_per_s']:.1f} tok/s; {fwd['prefill']} prefill + {fwd['decode']} decode "
        f"forwards; {k6} K6 + {k7} K7 launches = {k6 // n_fwd} + {k7 // n_fwd} per forward; "
        f"{dt:.1f}s incl. init and export")
    decisions = {f"{c}x{s_}@{r}": dict(rank=d.rank, use_decomposed=d.use_decomposed,
                                       searched=list(d.searched), times=list(d.times),
                                       original_time=d.original_time)
                 for (c, s_, r), d in report.decisions.items()}
    return engine, by_shape, dict(fwd=dict(fwd), k6=k6, k7=k7, stats=stats, wall_s=dt,
                                  merged=merged, kept=kept, decisions=decisions,
                                  layers={p: dict(shape=list(l.shape), rank_train=l.rank_train,
                                                  rank_serve=l.rank_serve, merged=l.merged)
                                          for p, l in report.layers.items()})


@contextlib.contextmanager
def plain_versions(**swaps):
    """Route the dispatchers' calls of the named kernel wrappers (names in
    ``kernels.ops``) to the given plain versions, on the card's tensors, for
    a reference run to hold the kernels against."""
    from repro_torch.kernels import ops

    saved = {name: getattr(ops, name) for name in swaps}
    for name, fn in swaps.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def plain_int8():
    from repro_torch.kernels import ref

    return plain_versions(int8_linear=ref.int8_linear_ref,
                          int8_lowrank_linear=ref.int8_lowrank_linear_ref)


def phase_int8_parity(engine, kind: str):
    """The int8 tree's last-position prefill logits and an 8-token greedy
    decode through K6/K7 against the same through their plain versions, and
    the gap of native int8 decode to the bf16 round trip of the tree."""
    import dataclasses

    from repro_torch.launch import steps
    from repro_torch.serving import ServeConfig, ServeEngine

    run = engine.run
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, run.model.vocab_size, (1, PREFILL_M), generator=gen,
                           device="cuda", dtype=torch.int32)
    last = torch.tensor([PREFILL_M - 1], device="cuda")
    batch = {"tokens": tokens}
    got, _ = steps.build_slot_prefill_step(run)(engine.params, batch, last)
    with plain_int8():
        want, _ = steps.build_slot_prefill_step(run)(engine.params, batch, last)
    bf16_run = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, int8_decode="bf16"))
    bf16, _ = steps.build_slot_prefill_step(bf16_run)(engine.params, batch, last)
    err, rel = rel_err(got, want)
    gap, gap_rel = rel_err(got, bf16)
    if not torch.isfinite(got).all() or rel > INT8_PATH_RTOL:
        raise AssertionError(f"int8 parity ({kind}): last-position logits differ by "
                             f"{err:.3e} ({rel:.3e} of max |logit|) > {INT8_PATH_RTOL}")
    prompt = tokens[0, :64].cpu().numpy()
    toks = []
    for plain in (False, True):
        eng = ServeEngine(run, engine.params, device="cuda",
                          config=ServeConfig(num_slots=1, max_len=80, prefill_len=64))
        with plain_int8() if plain else contextlib.nullcontext():
            toks.append(eng.generate(prompt[None], max_new=8)[0].tolist())
    if toks[0] != toks[1]:
        raise AssertionError(f"int8 parity ({kind}): greedy tokens differ: kernels "
                             f"{toks[0]} vs plain {toks[1]}")
    log(f"[int8 parity {kind}] prefill last-position logits, kernels vs plain: max_abs_diff "
        f"{err:.3e} ({rel:.3e} of max |logit| {want.abs().max().item():.3f}; bound "
        f"{INT8_PATH_RTOL}); greedy 8/8 identical {toks[0]}; native int8 vs bf16 round trip "
        f"of the same tree: max_abs_diff {gap:.3e} ({gap_rel:.3e} of max |logit|)")
    return dict(max_abs_diff=err, rel=rel, greedy=toks[0], bf16_gap=gap, bf16_gap_rel=gap_rel)


def phase_alg1_train():
    """The training CLI at Algorithm-1 ranks: the plan, then two steps
    (phases 0 and 1) with the launches counted per step."""
    from repro_torch.launch import steps, train

    run = train.build_run(train._parser().parse_args(ALG1_ARGV))
    _, plan = steps.init_params(run, "cuda")
    ranks = {p.split("/")[-1]: (lp.rank, lp.eq5_rank, lp.use_decomposed)
             for p, lp in plan.layers.items()}
    log(f"[alg1 train] {plan.summary()}; rank (Eq.-5 rank) per projection: "
        + ", ".join(f"{k} {r} ({e}){'' if d else ' dense'}" for k, (r, e, d) in ranks.items()))
    if {k: r for k, (r, _, d) in ranks.items() if d} != ALG1_RANKS:
        raise AssertionError(f"alg1 train: plan {ranks}, want {ALG1_RANKS}")
    state, per_step, by_shape, dt = _counted_train(ALG1_ARGV)
    if [r["phase"] for r in per_step] != [0, 1]:
        raise AssertionError(f"alg1 train: phases {[r['phase'] for r in per_step]}, want [0, 1]")
    for r in per_step:
        _check_step("alg1 train", r, _leaf_ranks(PROJ_ALG1))
        log(f"[alg1 train] step {r['step']} phase {r['phase']}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms; launches "
            + ", ".join(f"{k.replace('lowrank_', '')} {n}" for k, n in r["launches"].items()
                        if n))
    log(f"[alg1 train] 2 steps of {TRAIN_M} tokens: {dt:.1f}s incl. init")
    return state.params, run, by_shape, dict(steps=_without_shapes(per_step), wall_s=dt,
                                             ranks={k: list(v) for k, v in ranks.items()})


# --------------------------------------------------------------------------
# Flash attention (K8): the long-prompt flash serve
# --------------------------------------------------------------------------

def flash_kernel_case(d, gen):
    """Inputs, K8, its plain version, the library call, bytes and flops at
    ``d``, with q pre-scaled by D**-0.5 and multiplied back by sqrt(D) as
    on the model path.  Bytes: q and o over H heads, k and v over KV heads;
    flops: both products over the keys each query sees."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    b, sq, sk, h, kv, dh, causal = (d[k] for k in ("B", "Sq", "Sk", "H", "KV", "D", "causal"))

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    q, k, v = rnd(b, sq, h, dh, scale=dh ** -0.5), rnd(b, sk, kv, dh), rnd(b, sk, kv, dh)
    q_scale = dh ** 0.5
    # the library call takes (B, heads, S, D); the same function with K8's
    # q multiplier folded into its scale
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_scale = float(torch.tensor(q_scale, dtype=torch.bfloat16)) * dh ** -0.5
    visible = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return dict(kernel=lambda: flash_attention(q, k, v, causal=causal, q_scale=q_scale),
                plain=lambda: ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                          q_scale=q_scale),
                library=lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=lib_scale, enable_gqa=True),
                bytes=2 * (2 * b * sq * h * dh + 2 * b * sk * kv * dh),
                ops=4 * b * h * dh * visible, err=row_rel_err)


def phase_flash_kernels(shapes, iters: int = 50):
    """K8 at each shape against its plain version, timed beside it and
    ``F.scaled_dot_product_attention`` (a yardstick the port never calls)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = _flush_buffer()
    rows = [check_and_time("flash_attention", d, flash_kernel_case(d, gen), iters, flush,
                           BF16_FLOPS_PER_S) for d in shapes]
    zero_counts()
    return rows


def phase_flash_serve():
    """``ServeEngine.serve`` of a Poisson trace of long prompts with
    ``attention_impl="flash"``; K8 launches counted per prefill and decode
    forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve, steps
    from repro_torch.serving import ServeConfig, ServeEngine

    run = _with_impl(serve.serve_run(get_config("smollm-360m"), max_len=FLASH_MAX_LEN, slots=8,
                                     lrd=True, device=torch.device("cuda"), seed=0), "flash")
    params, _ = steps.init_params(run, "cuda")
    engine = ServeEngine(run, params, device="cuda",
                         config=ServeConfig(num_slots=8, max_len=FLASH_MAX_LEN,
                                            prefill_len=FLASH_PROMPT, block_size=16))
    sched = engine.scheduler
    k8_per = {"prefill": [], "decode": []}

    def counted(kind, step):
        def call(*args, **kw):
            before = flash_attention.launches
            out = step(*args, **kw)
            k8_per[kind].append(flash_attention.launches - before)
            return out
        return call

    sched._prefill = counted("prefill", sched._prefill)
    sched._decode = counted("decode", sched._decode)
    trace = serve.poisson_trace(16, 1000.0, FLASH_PROMPT, run.model.vocab_size, seed=0)
    for r in trace:
        r["max_new"] = FLASH_NEW
    zero_counts()
    t0 = time.perf_counter()
    outs = engine.serve(trace)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers().items()}
    by_shape = counts_by_shape()
    fwd = sched.forward_stats
    n_fwd = fwd["prefill"] + fwd["decode"]
    n_layers = run.model.num_layers
    if len(outs) != 16 or any(len(o) != FLASH_NEW for o in outs):
        raise AssertionError(f"flash serve: want 16 requests x {FLASH_NEW} tokens, got "
                             f"{[len(o) for o in outs]}")
    if fwd["nonfinite"]:
        raise AssertionError(f"flash serve: {fwd['nonfinite']} forwards with non-finite logits")
    want = {"lowrank_matmul": 5 * n_layers * n_fwd, "lowrank_gated_ffn": n_layers * n_fwd,
            "flash_attention": n_layers * fwd["prefill"]}
    got = {k: n for k, n in counts.items() if n or k in want}
    if (n_fwd == 0 or got != want or len(k8_per["prefill"]) != fwd["prefill"]
            or set(k8_per["prefill"]) != {n_layers} or set(k8_per["decode"]) != {0}):
        raise AssertionError(f"flash serve: {fwd['prefill']} prefill + {fwd['decode']} decode "
                             f"forwards launched {got}, want {want}; K8 per prefill "
                             f"{sorted(set(k8_per['prefill']))}, per decode "
                             f"{sorted(set(k8_per['decode']))} (want {n_layers} and 0)")
    if set(by_shape["flash_attention"]) != {shape_key("flash_attention", FLASH_SERVE_SHAPE)}:
        raise AssertionError(f"flash serve: K8 shapes {sorted(by_shape['flash_attention'])}")
    stats = sched.latency_stats()
    log(f"[flash serve] {len(outs)} requests (prompts {min(len(r['prompt']) for r in trace)}-"
        f"{max(len(r['prompt']) for r in trace)} tokens, padded to {FLASH_PROMPT}), "
        f"{int(stats['generated_tokens'])} tokens, {stats['tok_per_s']:.1f} tok/s on "
        f"{torch.cuda.get_device_name(0)}; {fwd['prefill']} prefill + {fwd['decode']} decode "
        f"forwards; K8 {n_layers} per prefill, 0 per decode forward; {counts['lowrank_matmul']} "
        f"K1 + {counts['lowrank_gated_ffn']} K5 = {5 * n_layers} + {n_layers} per forward; "
        f"latency p50 {stats['p50_latency_s'] * 1e3:.0f} ms, p95 "
        f"{stats['p95_latency_s'] * 1e3:.0f} ms, first-token p50 "
        f"{stats['p50_first_token_s'] * 1e3:.0f} ms; {dt:.1f}s")
    return engine, by_shape, dict(fwd=dict(fwd), counts=counts, stats=stats, wall_s=dt)


def _long_prompt(run, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, run.model.vocab_size, (1, FLASH_PROMPT), generator=gen,
                         device="cuda", dtype=torch.int32)


def _with_impl(run, impl: str):
    import dataclasses

    return dataclasses.replace(run, model=dataclasses.replace(run.model, attention_impl=impl))


def _greedy_with_logits(run, params, prompt, n: int):
    """n greedy tokens of ``prompt`` (1, L) through a fresh one-slot engine,
    with the logits each token was picked from (the prefill's last position,
    then each decode step's)."""
    from repro_torch.serving import ServeConfig, ServeEngine

    eng = ServeEngine(run, params, device="cuda",
                      config=ServeConfig(num_slots=1, max_len=FLASH_MAX_LEN,
                                         prefill_len=FLASH_PROMPT))
    sched, seen = eng.scheduler, []

    def keep(step, pick):
        def call(*args, **kw):
            out = step(*args, **kw)
            seen.append(pick(out).float().reshape(-1).clone())
            return out
        return call

    sched._prefill = keep(sched._prefill, lambda out: out[0])
    sched._decode = keep(sched._decode, lambda out: out[0][:, -1])
    return eng.generate(prompt, max_new=n)[0].tolist(), seen


def _held_while_agreeing(a_toks, a_logits, b_toks, b_logits, what: str):
    """Hold two greedy runs' logits within PATH_RTOL while their token
    histories agree; returns the steps agreed, the worst step's relative
    difference and the first parting step (None if all agree) with b's
    top-2 gap there: a perturbation within the bound can flip the argmax
    only where that gap is below twice the perturbation."""
    agree, worst, flip = 0, 0.0, None
    for i, (a, b) in enumerate(zip(a_toks, b_toks)):
        e_i, r_i = rel_err(a_logits[i], b_logits[i])
        worst = max(worst, r_i)
        if not torch.isfinite(a_logits[i]).all() or r_i > PATH_RTOL:
            raise AssertionError(f"flash parity: {what} greedy step {i} logits on the same "
                                 f"history differ by {e_i:.3e} ({r_i:.3e} of max |logit|) "
                                 f"> {PATH_RTOL}")
        if a != b:
            top2 = torch.topk(b_logits[i], 2).values
            flip = dict(step=i, gap=(top2[0] - top2[1]).item(), max_abs_diff=e_i)
            break
        agree += 1
    return dict(agree=agree, worst_step_rel=worst, flip=flip)


def phase_flash_parity(engine):
    """One 2016-token prefill through K8 against the model's default
    attention (the port's torch code, not K8's plain version), and 8 greedy
    tokens through a one-slot engine for each of FLASH_PARITY_SEEDS' prompts
    three ways: through K8, through the same flash path with K8 swapped for
    its plain version on the card (a second witness: the TPU kernel's
    arithmetic without the kernel), and blockwise.  Each pair's logits must
    agree within PATH_RTOL while their token histories agree; where the
    tokens part, the step and the reference's top-2 gap are reported (random
    weights make near-ties common)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps

    run = engine.run
    base = _with_impl(run, "blockwise")
    tokens = _long_prompt(run, seed=FLASH_PARITY_SEEDS[0])
    last = torch.tensor([FLASH_PROMPT - 1], device="cuda")
    got, _ = steps.build_slot_prefill_step(run)(engine.params, {"tokens": tokens}, last)
    want, _ = steps.build_slot_prefill_step(base)(engine.params, {"tokens": tokens}, last)
    err, rel = rel_err(got, want)
    if not torch.isfinite(got).all() or rel > PATH_RTOL:
        raise AssertionError(f"flash parity: last-position logits differ by {err:.3e} "
                             f"({rel:.3e} of max |logit|) > {PATH_RTOL}")
    log(f"[flash parity] {FLASH_PROMPT}-token prefill, last-position logits flash vs "
        f"blockwise: max_abs_diff {err:.3e} ({rel:.3e} of max |logit| "
        f"{want.abs().max().item():.3f}; bound {PATH_RTOL})")
    out = dict(max_abs_diff=err, rel=rel, seeds={})
    for seed in FLASH_PARITY_SEEDS:
        prompt = _long_prompt(run, seed=seed).cpu().numpy()
        ft, fl = _greedy_with_logits(run, engine.params, prompt, 8)
        before = flash_attention.launches
        with plain_versions(flash_attention=ref.flash_attention_fwd_ref):
            pt, pl = _greedy_with_logits(run, engine.params, prompt, 8)
        if flash_attention.launches != before:
            raise AssertionError("flash parity: the plain-version run launched K8")
        bt, bl = _greedy_with_logits(base, engine.params, prompt, 8)
        if {len(fl), len(pl), len(bl)} != {8}:
            raise AssertionError(f"flash parity: {len(fl)} / {len(pl)} / {len(bl)} forwards "
                                 f"for 8 tokens")
        pairs = {"K8 vs blockwise": (ft, fl, bt, bl), "plain vs blockwise": (pt, pl, bt, bl),
                 "K8 vs plain": (ft, fl, pt, pl)}
        res = {what: _held_while_agreeing(*args, what) for what, args in pairs.items()}
        out["seeds"][seed] = dict(res, greedy=ft, greedy_plain=pt, greedy_blockwise=bt)
        log(f"[flash parity] prompt seed {seed}: " + "; ".join(
            f"{what} {r['agree']}/8 agree, logits within {r['worst_step_rel']:.3e} of max "
            f"|logit| on the same history"
            + (f", part at step {r['flip']['step']} (top-2 gap {r['flip']['gap']:.3e}, "
               f"max_abs_diff {r['flip']['max_abs_diff']:.3e})" if r["flip"] else "")
            for what, r in res.items()) + f" (K8 {ft}, plain {pt}, blockwise {bt})")
    return out


def phase_prefill_profile(engine, steps_n: int = 3):
    """Wall time, device time by kernel and idle share of one full-width
    2016-token prefill, flash (K8) and blockwise."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    tokens = _long_prompt(engine.run, seed=2)
    batch, last = {"tokens": tokens}, torch.tensor([FLASH_PROMPT - 1], device="cuda")
    out = {}
    for impl in ("flash", "blockwise"):
        step = steps.build_slot_prefill_step(_with_impl(engine.run, impl))
        step(engine.params, batch, last)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps_n):
            step(engine.params, batch, last)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps_n * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps_n):
                step(engine.params, batch, last)
            torch.cuda.synchronize()
        by_name = device_ms_by_kernel(prof, steps_n)
        device_ms = sum(by_name.values())
        k8_ms = sum(ms for name, ms in by_name.items() if "flash_wgmma_kernel" in name)
        k1_ms, k5_ms = lowrank_device_ms(by_name)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[impl] = dict(wall_ms=wall_ms, device_ms=device_ms if device_ms else None,
                         idle_share=(1 - device_ms / wall_ms) if device_ms else None,
                         k8_ms=k8_ms, k8_share=k8_ms / device_ms if device_ms else None,
                         k1_ms=k1_ms, k5_ms=k5_ms,
                         top=[dict(name=k[:80], ms=v) for k, v in top])
        shown = ", ".join(f"{k[:40]} {v:.2f}ms" for k, v in top[:6])
        log(f"[prefill profile] {impl}, {FLASH_PROMPT} tokens, {engine.run.model.num_layers} "
            f"layers: wall {wall_ms:.2f} ms, "
            + (f"device {device_ms:.2f} ms, idle {out[impl]['idle_share']:.1%}, K8 "
               f"{k8_ms:.2f} ms ({out[impl]['k8_share']:.1%} of device), K1 {k1_ms:.2f} ms, "
               f"K5 {k5_ms:.2f} ms; top: {shown}"
               if device_ms else "device time not measured (profiler saw no device events)"))
    return out


# --------------------------------------------------------------------------
# The paper's conv and ViT path (Tables 1, 2 and 4)
# --------------------------------------------------------------------------

RESNETS = ("resnet50", "resnet101", "resnet152")
RESNET_CLASSES, IMG = 1000, 224
STAGE_C = (64, 128, 256, 512)
# Eq.-5 r1 of each stage's 3x3 conv (C = S = 64, 128, 256, 512) at alpha 2
STAGE_R1 = (38, 77, 154, 309)
# |the card's float32 Tucker-2 error - a float64 HOSVD's| / ||W||^2 of one
# 3x3 conv a stage: float32 Gram matrices, eigh and sums differ from float64
# by ~4e-8 of ||W||^2 on the CPU at these shapes, while keeping a wrong
# direction at the cut moves the error by ~1e-3
TUCKER_ERR_TOL = 1e-5
# ResNet-50 at 224 x 224, batch 4, the card against the port's own CPU run,
# both float32 (TF32 off): cuDNN's algorithms (implicit GEMM, Winograd, FFT)
# round otherwise than oneDNN's, by ~1e-5 of a conv's output at most, and
# 53 convs carry it; logits relative to max |logit|, the mean loss relative.
# Gradients: each trainable leaf by ||diff|| / ||grad||.  At random init a
# leaf's gradient sums B x H x W products that nearly cancel, which
# amplifies the per-op float32 differences (each conv's output and
# gradients within ~2e-5 of float64 on the H100; test_torch_conv_gpu.py
# holds them to 1e-4 of the CPU's, TF32 on around the call) to a few 1e-3
# of a leaf's largest entry (the stem kernel's, H100); 1e-2 of its norm
# fails a wrong or missing gradient
RESNET_LOGITS_RTOL = 1e-3
RESNET_LOSS_RTOL = 1e-4
RESNET_GRAD_RTOL = 1e-2
PARITY_B = 4
# the Table-1 and Table-4 ladders: batch, timed steps (median), warm-up
# steps (cuDNN's autotuning included), profiled steps
LADDER_B, LADDER_STEPS, LADDER_WARM, PROFILE_STEPS = 64, 10, 3, 3
# SGD step sizes of benchmarks/table1_resnet_throughput.py and table4_vit.py
RESNET_LR, VIT_LR = 1e-3, 3e-3
# ViT-B/16: vit_init's defaults (10 classes)
VIT_B16 = dict(num_layers=12, d=768, heads=12, d_ff=3072, patch=16, img=224,
               num_classes=10)
SEQ_PHASES = (0, 0, 1, 1, 0, 0)
# the ladder's methods also trained at phase 1 (their other frozen group)
PHASE1_METHODS = ("freeze", "combined")


# the benchmarks' method ladder (benchmarks/common.py:18-27): method ->
# (tree: dense, or decomposed by the lrd or rankopt policy of
# ``_ladder_policies``; freezing phase)
LADDER = {"org": ("org", -1), "lrd": ("lrd", -1), "rankopt": ("rankopt", -1),
          "freeze": ("lrd", 0), "combined": ("rankopt", 0)}


def _ladder_policies(base):
    """The ladder's policies at alpha 2: Eq.-5 ranks (lrd) and Algorithm 1
    (rankopt)."""
    return {"lrd": base.with_alpha(2.0).with_quantize(False).with_min_dim(32),
            "rankopt": base.with_alpha(2.0).with_quantize(True).with_min_dim(32)}


def _vit_policy():
    """The ViT policy of benchmarks/table4_vit.py:19-26: the FFN FC layers
    and the patch embedding, SVD."""
    from repro_torch.core.policy import DecompositionPolicy, Rule

    return DecompositionPolicy(name="vit-ffn", rules=(
        Rule(r"(norm|bias|pos_emb|cls|head)", "none"),
        Rule(r"(wi|down|patch_embed)", "svd", min_dim=32),
        Rule(r".*", "none")))


def _live(params):
    """Copies of ``params`` that autograd differentiates."""
    from repro_torch.core.freezing import tree_map

    return tree_map(lambda t: t.detach().clone().requires_grad_(), params)


def _cls_step(live, apply, phase: int, lr: float):
    """The benchmarks' classification train step
    (benchmarks/table1_resnet_throughput.py:25-36, table4_vit.py:30-39) on
    the ``_live`` tree: cross-entropy of ``apply(params, x)``; at phase >= 0
    ``apply_freeze`` detaches the frozen factor group, so autograd computes
    no gradient for it (cuDNN is never asked for a frozen conv's weight
    gradient); SGD ``p - lr g`` in place on the rest.  ``step(x, y)``
    returns (loss, {path: grad or None})."""
    from repro_torch.core import freezing
    from repro_torch.models.common import cross_entropy
    from repro_torch.models.resnet import fp32_convs

    view = freezing.apply_freeze(live, freezing.freeze_mask(live, phase)) if phase >= 0 else live
    leaves = dict(_grad_paths(live))

    def step(x, y):
        with fp32_convs():  # a conv's backward reads the flag when it runs
            loss = cross_entropy(apply(view, x), y)
            loss.backward()
        grads = {path: t.grad for path, t in leaves.items()}
        got = [t for t in leaves.values() if t.grad is not None]
        with torch.no_grad():
            torch._foreach_add_(got, [t.grad for t in got], alpha=-lr)
        for t in got:
            t.grad = None
        return loss.detach(), grads

    return step


def _frozen_paths(tree, phase: int):
    from repro_torch.core.freezing import freeze_mask

    return {path for path, keep in _grad_paths(freeze_mask(tree, phase)) if not keep}


def _check_frozen(label: str, tree, phase: int, grads) -> int:
    """Every leaf of the frozen group without a gradient and every other
    leaf with one; returns the number of frozen leaves."""
    frozen = _frozen_paths(tree, phase)
    for path, g in grads.items():
        if (g is None) != (path in frozen):
            raise AssertionError(f"{label}: phase {phase} {path} "
                                 + ("frozen but has a gradient" if g is not None
                                    else "trainable but has no gradient"))
    return len(frozen)


def _hosvd64_error(w, r1: int, r2: int) -> float:
    """||W - HOSVD(W)||^2 in float64 (numpy) of a (C, S, k, k) weight."""
    import numpy as np

    c, s = w.shape[:2]
    m0, m1 = w.reshape(c, -1), np.moveaxis(w, 1, 0).reshape(s, -1)
    u = np.linalg.eigh(m0 @ m0.T)[1][:, ::-1][:, :r1]
    v = np.linalg.eigh(m1 @ m1.T)[1][:, ::-1][:, :r2]
    core = np.einsum("cskl,cp,sq->pqkl", w, u, v, optimize=True)
    rec = np.einsum("cp,pqkl,sq->cskl", u, core, v, optimize=True)
    return float(np.sum((w - rec) ** 2))


def _init_path(path: str) -> str:
    """The init-time plan's name of a ResNet tree path (``s1b0/conv3x3`` ->
    ``stage1/block0/conv3x3``)."""
    head, _, rest = path.partition("/")
    if head[0] == "s" and "b" in head and rest:
        si, bi = head[1:].split("b")
        return f"stage{si}/block{bi}/{rest}"
    return path


def _seeded(seed: int, device="cuda"):
    return torch.Generator(device=device).manual_seed(seed)


def phase_conv_decompose():
    """Paper Table 2: ``apply_lrd`` of dense ResNet-50/101/152 (1000
    classes, float32, seeded) under ``RESNET_DEFAULT`` at the ladder's LRD
    (Eq. 5) and RankOpt (Algorithm 1) policies, timed on the card; the plan
    equal to the init-time ``Decomposer``'s, layer counts, each stage's 3x3
    r1, and ResNet-50's Tucker-2 error on one 3x3 conv a stage against a
    float64 HOSVD on the CPU.  Returns (results, ResNet-50's dense tree,
    its decomposed trees by method)."""
    import dataclasses

    from repro_torch.core import tucker
    from repro_torch.core.decompose import Decomposer, apply_lrd
    from repro_torch.core.freezing import tree_leaves
    from repro_torch.core.policy import NO_LRD, RESNET_DEFAULT
    from repro_torch.models import resnet

    policies = _ladder_policies(RESNET_DEFAULT)
    eq5_r1 = tuple(tucker.tucker_rank_for_compression(c, c, 3, 2.0)[0] for c in STAGE_C)
    if eq5_r1 != STAGE_R1:
        raise AssertionError(f"conv decompose: Eq.-5 r1 {eq5_r1}, expected {STAGE_R1}")
    torch.linalg.svd(torch.ones((64, 64), device="cuda"))  # cuSOLVER's set-up, untimed
    torch.linalg.eigh(torch.eye(64, device="cuda"))
    torch.cuda.synchronize()
    out, dense50, trees50 = {}, None, {}
    for variant in RESNETS:
        dense = resnet.resnet_init(variant, RESNET_CLASSES,
                                   Decomposer(NO_LRD, dtype=torch.float32, device="cuda",
                                              generator=_seeded(0)))
        n_params = sum(t.numel() for t in tree_leaves(dense))
        out[variant] = dict(params=n_params)
        for name, policy in policies.items():
            layout = Decomposer(policy, dtype=torch.float32, device="meta")
            resnet.resnet_init(variant, RESNET_CLASSES, layout)  # the init-time plan, no data
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree, plan = apply_lrd(dense, policy)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            renamed = {_init_path(p): dataclasses.replace(lp, path=_init_path(p))
                       for p, lp in plan.layers.items()}
            if renamed != layout.plan.layers:
                raise AssertionError(f"conv decompose: {variant} {name} plan differs from the "
                                     f"init-time Decomposer's")
            kept = [lp for lp in plan.layers.values() if lp.use_decomposed]
            counts = {m: sum(lp.method == m for lp in kept) for m in ("tucker", "svd")}
            stage = [plan.layers[f"s{si}b0/conv3x3"] for si in range(4)]
            if tuple(lp.eq5_rank for lp in stage) != STAGE_R1:
                raise AssertionError(f"conv decompose: {variant} {name} stage r1 "
                                     f"{[lp.eq5_rank for lp in stage]}, expected {STAGE_R1}")
            n_tree = sum(t.numel() for t in tree_leaves(tree))
            out[variant][name] = dict(seconds=secs, **counts,
                                      dense_kept=len(plan.layers) - len(kept),
                                      stage_r1=[lp.rank for lp in stage], params=n_tree)
            log(f"[conv decompose] {variant} ({n_params / 1e6:.1f} M params, float32) "
                f"apply_lrd at {name} ({'Algorithm 1' if name == 'rankopt' else 'Eq. 5'}): "
                f"{secs:.3f} s; {counts['tucker']} Tucker, {counts['svd']} SVD, "
                f"{len(plan.layers) - len(kept)} kept dense by the guard; stage 3x3 r1 "
                f"{[lp.rank for lp in stage]} (Eq. 5: {list(STAGE_R1)}); "
                f"{n_tree / 1e6:.1f} M params after")
            if variant == "resnet50":
                trees50[name] = tree
            del tree
        if variant == "resnet50":
            dense50 = dense
        del dense
    errs = []
    for si, c in enumerate(STAGE_C):
        g = trees50["lrd"][f"s{si}b0"]["conv3x3"]
        w = dense50[f"s{si}b0"]["conv3x3"]["kernel"].permute(2, 3, 0, 1)  # (C, S, k, k)
        r1, r2 = g["first"].shape[1], g["last"].shape[0]
        card = tucker.tucker_reconstruction_error(w, g["first"], g["core"].permute(2, 3, 0, 1),
                                                  g["last"]).item()
        ref = _hosvd64_error(w.double().cpu().numpy(), r1, r2)
        norm = torch.sum(w.double() ** 2).item()
        diff = abs(card - ref) / norm
        errs.append(dict(c=c, r1=r1, err=card / norm, err64=ref / norm, diff=diff))
        if not diff <= TUCKER_ERR_TOL:
            raise AssertionError(f"conv decompose: stage {si} 3x3 Tucker-2 error {card / norm:.6f} "
                                 f"of ||W||^2 against float64 {ref / norm:.6f} (bound "
                                 f"{TUCKER_ERR_TOL})")
    out["tucker_error"] = errs
    log("[conv decompose] resnet50 one 3x3 a stage, ||W - first.core.last||^2 / ||W||^2 on the "
        f"card against a float64 HOSVD on the CPU (bound {TUCKER_ERR_TOL} on the difference): "
        + ", ".join(f"C {e['c']} r1 {e['r1']}: {e['err']:.6f} vs {e['err64']:.6f} "
                    f"({e['diff']:.1e})" for e in errs))
    return out, dense50, trees50


def phase_resnet_parity(dense, eq5):
    """ResNet-50 at 224 x 224, batch 4, on the card against the port's own
    CPU run: logits of the dense and Eq.-5 trees; one train step of the
    Eq.-5 tree at phases -1 and 0 (loss, every trainable leaf's gradient,
    no gradient on group 0: u, first, last)."""
    import functools

    from repro_torch.core.freezing import tree_map
    from repro_torch.models import resnet

    apply = functools.partial(resnet.resnet_apply, variant="resnet50")
    x = torch.randn((PARITY_B, IMG, IMG, 3), generator=_seeded(11, "cpu"))
    y = torch.randint(0, RESNET_CLASSES, (PARITY_B,), generator=_seeded(12, "cpu"))
    out = {}
    for name, tree in (("dense", dense), ("eq5", eq5)):
        host = tree_map(lambda t: t.cpu(), tree)
        with torch.no_grad():
            got = apply(tree, x.cuda()).cpu()
            want = apply(host, x)
        diff, rel = rel_err(got, want)
        out[name] = dict(max_abs=diff, rel=rel, max_logit=want.abs().max().item())
        log(f"[resnet parity] resnet50 {name} logits ({IMG} x {IMG}, batch {PARITY_B}): card vs "
            f"CPU max |diff| {diff:.3e}, {rel:.2e} of max |logit| (bound {RESNET_LOGITS_RTOL})")
        if not rel <= RESNET_LOGITS_RTOL:
            raise AssertionError(f"resnet parity: {name} logits {rel:.3e} of max |logit| apart")
    host = tree_map(lambda t: t.cpu(), eq5)
    for phase in (-1, 0):
        loss_c, grads_c = _cls_step(_live(eq5), apply, phase, RESNET_LR)(x.cuda(), y.cuda())
        loss_h, grads_h = _cls_step(_live(host), apply, phase, RESNET_LR)(x, y)
        n_frozen = _check_frozen("resnet parity (card)", eq5, phase, grads_c)
        _check_frozen("resnet parity (CPU)", eq5, phase, grads_h)
        loss_rel = abs(loss_c.item() - loss_h.item()) / abs(loss_h.item())
        worst, worst_path, worst_max = 0.0, "", 0.0  # by norm; the largest entry's too
        for path, g in grads_c.items():
            if g is None:
                continue
            want = grads_h[path].double()
            diff = g.cpu().double() - want
            rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
            worst_max = max(worst_max, (diff.abs().max() / want.abs().max()).item())
            if not rel <= worst:
                worst, worst_path = rel, path
        out[f"phase{phase}"] = dict(loss_card=loss_c.item(), loss_cpu=loss_h.item(),
                                    loss_rel=loss_rel, worst_grad_rel=worst,
                                    worst_leaf=worst_path, worst_grad_max_rel=worst_max,
                                    frozen_leaves=n_frozen)
        log(f"[resnet parity] eq5 train step phase {phase}: loss card {loss_c.item():.6f} vs "
            f"CPU {loss_h.item():.6f} ({loss_rel:.1e}, bound {RESNET_LOSS_RTOL}); worst leaf "
            f"grad ||diff|| / ||grad|| {worst:.2e} ({worst_path}, bound {RESNET_GRAD_RTOL}; "
            f"largest entry's max |diff| / max |grad| {worst_max:.2e}); {n_frozen} frozen "
            f"leaves without a gradient")
        if not (loss_rel <= RESNET_LOSS_RTOL and worst <= RESNET_GRAD_RTOL):
            raise AssertionError(f"resnet parity: phase {phase} loss {loss_rel:.3e} or "
                                 f"{worst_path} grad {worst:.3e} apart")
    return out


# device kernels of cuDNN's convs and cuBLAS / CUTLASS GEMMs, by name; the
# rest of a conv or ViT step is torch's elementwise and reduction kernels
# (folded BN, ReLU, residual adds, softmax, norms, the SGD update)
LIBRARY_KERNELS = ("cudnn", "xmma", "gemm", "cutlass", "wgrad", "dgrad", "fprop", "winograd",
                   "convolve")


def _measure(fn):
    """``fn()`` as one step: the median host time over LADDER_STEPS
    synchronised steps after LADDER_WARM, the device time per step
    (``torch.profiler``, device-side events) over PROFILE_STEPS, its part in
    convs and GEMMs (``LIBRARY_KERNELS``), and the device's idle share of
    the median step."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(LADDER_WARM):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(LADDER_STEPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall_ms = sorted(times)[len(times) // 2] * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            fn()
        torch.cuda.synchronize()
    by_name = device_ms_by_kernel(prof, PROFILE_STEPS)
    device_ms = sum(by_name.values())
    if not device_ms:
        raise AssertionError("the profiler saw no device events")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    library_ms = sum(ms for name, ms in by_name.items()
                     if any(key in name.lower() for key in LIBRARY_KERNELS))
    return dict(wall_ms=wall_ms, device_ms=device_ms, idle_share=1 - device_ms / wall_ms,
                conv_gemm_ms=library_ms, top=[dict(name=k[:80], ms=v) for k, v in top])


def phase_ladder(label: str, trees, apply, x, y, lr: float):
    """One table's method ladder (``LADDER``): each method's tree (``trees``
    by org / lrd / rankopt) trained at its phase (``_cls_step``) and run
    forward (no grad), each ``_measure``d; images/s from the median step.
    PHASE1_METHODS are also trained at phase 1.  cuDNN picks its
    algorithms by timing them (``cudnn.benchmark``), as a user training a
    conv net would set it."""
    from repro_torch.models.resnet import fp32_convs

    b = x.shape[0]
    methods = [(m, tree_name, phase) for m, (tree_name, phase) in LADDER.items()]
    methods += [(f"{m} (phase 1)", LADDER[m][0], 1) for m in PHASE1_METHODS]
    rows, base = [], None
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        for method, tree_name, phase in methods:
            params = trees[tree_name]
            step = _cls_step(_live(params), apply, phase, lr)
            train = _measure(lambda: step(x, y))
            row = dict(method=method, tree=tree_name, phase=phase, train=train,
                       train_img_s=b / train["wall_ms"] * 1e3)
            if phase != 1:
                def infer():
                    with torch.no_grad(), fp32_convs():
                        apply(params, x)
                row["infer"] = _measure(infer)
                row["infer_img_s"] = b / row["infer"]["wall_ms"] * 1e3
            if base is None:
                base = row
            row["train_vs_org"] = row["train_img_s"] / base["train_img_s"] - 1
            if "infer" in row:
                row["infer_vs_org"] = row["infer_img_s"] / base["infer_img_s"] - 1
            rows.append(row)
            t, i = row["train"], row.get("infer")
            log(f"[{label}] {method:<19} tree {tree_name:<7} phase {phase:>2}: train "
                f"{row['train_img_s']:7.1f} img/s ({row['train_vs_org']:+.1%}; wall "
                f"{t['wall_ms']:.2f} ms, device {t['device_ms']:.2f} ms of which convs and "
                f"GEMMs {t['conv_gemm_ms']:.2f}, idle {t['idle_share']:.1%})"
                + (f"; inference {row['infer_img_s']:7.1f} img/s ({row['infer_vs_org']:+.1%}; "
                   f"wall {i['wall_ms']:.2f} ms, device {i['device_ms']:.2f} ms of which convs "
                   f"and GEMMs {i['conv_gemm_ms']:.2f}, idle {i['idle_share']:.1%})"
                   if i else "")
                + "; train top: " + ", ".join(f"{k['name'][:40]} {k['ms']:.2f}ms"
                                            for k in t["top"][:3]))
            del step
    finally:
        torch.backends.cudnn.benchmark = prev
    return rows


def _resnet_macs(tree, variant: str, img: int):
    """(multiply-adds, activation elements written) an image by the convs
    of a ResNet tree as ``conv_apply`` computes them (a Tucker triple's
    first factor at the input's resolution, an SVD pair after the
    subsampling); the fc is left out."""
    from repro_torch.models.resnet import STAGES

    macs = act = 0

    def conv(p, h, stride):
        nonlocal macs, act
        out = -(-h // stride)
        if "kernel" in p:
            kh, kw, c, s = p["kernel"].shape
            macs, act = macs + out * out * kh * kw * c * s, act + out * out * s
        elif "first" in p:
            (c, r1), (kh, kw, _, r2), s = p["first"].shape, p["core"].shape, p["last"].shape[1]
            macs += h * h * c * r1 + out * out * (kh * kw * r1 * r2 + r2 * s)
            act += h * h * r1 + out * out * (r2 + s)
        else:
            (c, r), s = p["u"].shape, p["v"].shape[1]
            macs, act = macs + out * out * r * (c + s), act + out * out * (r + s)
        return out

    h = -(-conv(tree["conv_stem"], img, 2) // 2)  # the stem, then the 3x3/2 max-pool
    for si, blocks in enumerate(STAGES[variant]):
        for bi in range(blocks):
            p, stride = tree[f"s{si}b{bi}"], (2 if bi == 0 and si > 0 else 1)
            conv(p["conv1x1_a"], h, 1)
            out = conv(p["conv3x3"], h, stride)
            conv(p["conv1x1_b"], out, 1)
            if "shortcut" in p:
                conv(p["shortcut"], h, stride)
            h = out
    return macs, act


def _vit_macs(tree, img: int, patch: int):
    """(multiply-adds an image, the FFNs' share) of a ViT tree: every
    projection (dense or SVD pair), the attention products, the head."""
    n = (img // patch) ** 2 + 1

    def proj(p):
        if "kernel" in p:
            return p["kernel"].shape[-2] * p["kernel"].shape[-1]
        return p["u"].shape[-1] * (p["u"].shape[-2] + p["v"].shape[-1])

    blocks = tree["blocks"]
    n_layers, d = blocks["norm1"]["scale"].shape
    ffn = n * (proj(blocks["wi"]) + proj(blocks["down"]))
    attn = n * (sum(proj(blocks[k]) for k in ("wq", "wk", "wv", "wo")) + 2 * n * d)
    macs = (n - 1) * proj(tree["patch_embed"]) + n_layers * (ffn + attn) + proj(tree["head"])
    return macs, n_layers * ffn / macs


def phase_table1(dense, trees):
    """Paper Table 1: ResNet-50 (224 x 224, batch 64, 1000 classes,
    float32) over org / lrd / rankopt / freeze / combined, on the trees of
    ``phase_conv_decompose``."""
    import functools

    from repro_torch.models import resnet

    counts = {k: _resnet_macs(t, "resnet50", IMG) for k, t in dict(org=dense, **trees).items()}
    (m0, a0) = counts["org"]
    log(f"[table1 resnet50] convs a {IMG} x {IMG} image: " + ", ".join(
        f"{k} {m / 1e9:.3f} GMAC ({m / m0:.3f}x), activations {a / a0:.2f}x"
        for k, (m, a) in counts.items()))
    x = torch.randn((LADDER_B, IMG, IMG, 3), generator=_seeded(21), device="cuda")
    y = torch.randint(0, RESNET_CLASSES, (LADDER_B,), generator=_seeded(22), device="cuda")
    return phase_ladder("table1 resnet50", dict(org=dense, **trees),
                        functools.partial(resnet.resnet_apply, variant="resnet50"), x, y,
                        RESNET_LR)


def phase_table4():
    """Paper Table 4: ViT-B/16 (12 layers, d 768, 12 heads, d_ff 3072, patch
    16, 224 x 224, 10 classes, float32) at batch 64, the ViT policy, over the
    same ladder."""
    import functools

    from repro_torch.core.decompose import Decomposer, apply_lrd
    from repro_torch.core.freezing import tree_leaves
    from repro_torch.core.policy import NO_LRD
    from repro_torch.models import vit

    cfg = dict(VIT_B16)
    dense = vit.vit_init(Decomposer(NO_LRD, dtype=torch.float32, device="cuda",
                                    generator=_seeded(1)), **cfg)
    trees = dict(org=dense)
    for name, policy in _ladder_policies(_vit_policy()).items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trees[name], plan = apply_lrd(dense, policy)
        torch.cuda.synchronize()
        log(f"[table4 vit-b/16] apply_lrd at {name}: {time.perf_counter() - t0:.3f} s, "
            f"{plan.summary()}, ranks "
            + ", ".join(f"{p} {lp.rank}" for p, lp in plan.layers.items()))
    log("[table4 vit-b/16] params: " + ", ".join(
        f"{k} {sum(t.numel() for t in tree_leaves(v)) / 1e6:.1f} M" for k, v in trees.items()))
    counts = {k: _vit_macs(t, cfg["img"], cfg["patch"]) for k, t in trees.items()}
    log(f"[table4 vit-b/16] an image: " + ", ".join(
        f"{k} {m / 1e9:.3f} GMAC ({m / counts['org'][0]:.3f}x, FFNs {share:.0%})"
        for k, (m, share) in counts.items()))
    x = torch.randn((LADDER_B, cfg["img"], cfg["img"], 3), generator=_seeded(31), device="cuda")
    y = torch.randint(0, cfg["num_classes"], (LADDER_B,), generator=_seeded(32), device="cuda")
    return phase_ladder("table4 vit-b/16", trees,
                        functools.partial(vit.vit_apply, heads=cfg["heads"],
                                          patch=cfg["patch"]), x, y, VIT_LR)


def phase_sequential(tree):
    """Algorithm 2 on ResNet-50 combined: 6 steps at batch 64, phases
    0,0,1,1,0,0, on ``SyntheticClassification(img=224)``: finite losses, and
    at each step no gradient on the frozen group."""
    import functools

    from repro_torch.data import SyntheticClassification
    from repro_torch.models import resnet

    apply = functools.partial(resnet.resnet_apply, variant="resnet50")
    data = SyntheticClassification(img=IMG, batch=LADDER_B)
    live = _live(tree)
    losses, frozen = [], []
    t0 = time.perf_counter()
    for i, phase in enumerate(SEQ_PHASES):
        xb, yb = data.next_batch()
        loss, grads = _cls_step(live, apply, phase, RESNET_LR)(
            torch.from_numpy(xb).cuda(), torch.from_numpy(yb).cuda())
        frozen.append(_check_frozen(f"sequential step {i}", live, phase, grads))
        losses.append(loss.item())
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"sequential: step {i} loss {losses[-1]}")
    torch.cuda.synchronize()
    log(f"[sequential] resnet50 combined, batch {LADDER_B}, phases {list(SEQ_PHASES)}: losses "
        + ", ".join(f"{l:.4f}" for l in losses) + f"; frozen leaves without a gradient per "
        f"step {frozen}; {time.perf_counter() - t0:.1f} s incl. data")
    return dict(phases=list(SEQ_PHASES), losses=losses, frozen_leaves=frozen)


def phase_conv():
    """The conv and ViT phases, in order; returns their results."""
    out = {}
    out["conv_decompose"], dense50, trees50 = phase_conv_decompose()
    out["resnet_parity"] = phase_resnet_parity(dense50, trees50["lrd"])
    out["table1"] = phase_table1(dense50, trees50)
    out["sequential"] = phase_sequential(trees50["rankopt"])
    del dense50, trees50
    out["table4"] = phase_table4()
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
    ap.add_argument("--only", choices=("kernels", "conv"), default=None,
                    help="kernels: stop after the kernel phase (a first check of a build); "
                         "conv: run only the conv and ViT phases")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    smi = phase_device()
    if args.only == "conv":
        result = dict(smi=smi, **phase_conv())
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1, default=str))
        log(f"[run] {time.perf_counter() - t_start:.1f} s")
        print(smi, flush=True)
        return 0
    build_s = phase_build()
    rows = phase_kernels()
    result = dict(smi=smi, build_s=build_s, kernels=rows)
    if args.only is None:
        paths = {}  # main path -> launches by kernel and shape
        engine, paths["serve"], result["serve"] = phase_serve()
        result["parity"] = phase_parity(engine)
        result["profile"] = phase_profile(engine)
        del engine
        engine, paths["decompose serve"], result["decompose"] = phase_decompose()
        result["decompose"]["parity"] = phase_parity(engine)
        del engine
        for kind in EXPORTS:
            engine, paths[f"export {kind}"], result[f"export_{kind}"] = phase_export_serve(kind)
            result[f"int8_parity_{kind}"] = phase_int8_parity(engine, kind)
            result[f"int8_profile_{kind}"] = phase_profile(
                engine, label=f"int8 {kind} export decode step", int8=True)
            del engine
        result["int8_launches"] = phase_int8_launches()
        params, paths["train"], result["train"] = phase_train()
        result["grads"] = phase_grads(params)
        result["train_profile"] = phase_train_profile(params)
        final, paths["rank decay"], paths["rank energy"], result["rank_adapt"] = \
            phase_rank_adapt_train()
        result["rank_adapt_profile"] = phase_rank_map_profiles(params, final)
        del params, final
        # the energy boundary's ranks are the card's: check what it launched
        checked = {(r["name"], shape_key(r["name"], r["shape"])) for r in rows}
        rows += phase_kernels([(name, shape_dims(name, key))
                               for name, keys in sorted(paths["rank energy"].items())
                               for key in sorted(keys) if (name, key) not in checked])
        params, alg1_run, paths["alg1 train"], result["alg1_train"] = phase_alg1_train()
        result["alg1_train_profile"] = phase_train_profile(
            params, run=alg1_run, phases=(-1, 1), label="alg1 train profile")
        del params
        int8_shapes = sorted({(name, key) for by in paths.values() for name in INT8_FUSED
                              for key in by[name]})
        if not any(name == "int8_linear" for name, _ in int8_shapes):
            # the measured export kept every group factorised on this card
            int8_shapes += [sk for sk in INT8_DEFAULT_SHAPES if sk[0] == "int8_linear"]
        rows += phase_int8_kernels(int8_shapes)
        engine, paths["flash serve"], result["flash_serve"] = phase_flash_serve()
        result["flash_parity"] = phase_flash_parity(engine)
        result["prefill_profile"] = phase_prefill_profile(engine)
        del engine
        launched = [dict(zip(("B", "Sq", "Sk", "H", "KV", "D", "causal"), key))
                    for key in sorted(paths["flash serve"]["flash_attention"])]
        rows += phase_flash_kernels(launched)
        # checked, not in the kernels line: no main path launches them
        result["flash_extra"] = phase_flash_kernels([d for d in FLASH_EXTRA
                                                     if d not in launched])
        result["designs"] = phase_designs()
        # the paper's conv and ViT path: no hand-written kernel runs on it
        result.update(phase_conv())
        for path, by in paths.items():
            check_launched_shapes(path, rows, by)
        for row in rows:
            key = shape_key(row["name"], row["shape"])
            row["launches"] = sum(by[row["name"]].get(key, 0) for by in paths.values())
            # the int8-operand entries are the TPU kernels' contract, which
            # no main path calls since the serving entries quantize x inside
            if (not row["launches"] and row["name"] not in INT8_FUSED.values()
                    and row["name"] != "int8_linear"):
                raise AssertionError(f"{row['name']} {row['shape']} never launched on "
                                     f"a main path")
        if not any(r["launches"] for r in rows if r["name"] == "int8_linear"):
            log("[kernels] int8_linear (K6) was launched on no main path in this run: the "
                "measured export merged no group on this card")
    else:
        rows += phase_int8_kernels(INT8_DEFAULT_SHAPES)
        rows += phase_flash_kernels([FLASH_SERVE_SHAPE] + FLASH_EXTRA)
        result["designs"] = phase_designs()
        for row in rows:
            row["launches"] = 0
    bwd_cu = "src/repro_torch/kernels/csrc/lowrank_bwd.cu"
    int8_cu = "src/repro_torch/kernels/csrc/int8_matmul.cu"
    src = {"lowrank_matmul": ("src/repro_torch/kernels/csrc/lowrank_matmul.cu",
                              "src/repro/kernels/lowrank_matmul.py:107"),
           "lowrank_gated_ffn": ("src/repro_torch/kernels/csrc/lowrank_ffn.cu",
                                 "src/repro/kernels/lowrank_ffn.py:52"),
           "lowrank_matmul_dx": (bwd_cu, "src/repro/kernels/lowrank_bwd.py:116"),
           "lowrank_matmul_du": (bwd_cu, "src/repro/kernels/lowrank_bwd.py:215"),
           "lowrank_matmul_dv": (bwd_cu, "src/repro/kernels/lowrank_bwd.py:298"),
           "int8_matmul": (int8_cu, "src/repro/kernels/int8_matmul.py:86"),
           "int8_lowrank_matmul": (int8_cu, "src/repro/kernels/int8_matmul.py:142"),
           "int8_linear": (int8_cu, "src/repro/kernels/int8_matmul.py:86"),
           "int8_lowrank_linear": (int8_cu, "src/repro/kernels/int8_matmul.py:142"),
           "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:81")}
    line = {"kernels": [dict(name=r["name"], shape=r["shape"], route="cuda",
                             source=src[r["name"]][0], replaces=src[r["name"]][1],
                             launches=r["launches"], max_abs_err=r["max_abs_err"],
                             ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                             bound_by=r["bound_by"], library_ms=r["library_ms"])
                        for r in rows]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    log(f"[run] {time.perf_counter() - t_start:.1f} s")
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
