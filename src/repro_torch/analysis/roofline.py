"""Roofline terms and the kernels' cost models — the counterpart of
``repro/analysis/roofline.py``, with an H100 model beside the reference's
v5e one.

    compute_s    = sum over dtypes of FLOPs_of_dtype / peak_of_dtype
    memory_s     = bytes / HBM bandwidth
    collective_s = collective bytes / interconnect bandwidth

All inputs are per device.  ``TPU_V5E_SPECS`` is kept only so that tests
can hold this arithmetic against the reference's: its float32 peak is its
bf16 peak, because the reference prices every product at the bf16 peak.
``H100_SPECS`` is NVIDIA's data sheet for the SXM part (dense rates, 700
W).  The port widens its dense products to float32 with TF32 off, so a
float32 FLOP is priced at the float32 peak (67 TFLOP/s), 15x the bf16 one.

Three models live here:

* the reference's block-triple model (:func:`kernel_vmem_bytes`,
  :func:`kernel_candidate_time`, :func:`prune_candidates`), unchanged and
  kept for parity: the port's kernels take no block triples;
* :func:`kernel_cost`, the FLOPs and bytes of one call of a hand-written
  kernel (each input read once, each output written once), which
  ``chip_smoke.py`` bounds every kernel row by and
  ``analysis/cost.py`` prices every launch with;
* :func:`choice_time` / :func:`prune_choices`, the port's analytic model
  of each op's candidates (a design, a launch plan, a split count or a
  grid: ``kernels/autotune.py``), which orders the candidates the
  autotuner measures.  A candidate whose shared memory passes the
  per-block limit is dropped, by the wrappers' own ``decode_out_smem``,
  ``large_smem`` and ``dx_smem``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.kernels import flash_attention as k8
from repro_torch.kernels import lowrank_bwd as kb
from repro_torch.kernels import lowrank_matmul as k1

__all__ = ["ChipSpecs", "TPU_V5E_SPECS", "H100_SPECS", "dtype_bytes", "kernel_vmem_bytes",
           "kernel_candidate_time", "prune_candidates", "kernel_cost", "choice_time",
           "prune_choices", "Roofline", "model_flops_per_device", "compute_seconds",
           "roofline_terms"]


@dataclasses.dataclass(frozen=True)
class ChipSpecs:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12  # bf16
    hbm_bw: float = 819e9  # B/s
    ici_bw: float = 50e9  # B/s per link (conservative single-link)
    hbm_bytes: float = 16 * 2 ** 30
    vmem_bytes: float = 16 * 2 ** 20  # on-chip bytes a kernel's working set may hold
    int8_flops: float = 394e12  # int8 MXU peak (2x bf16 on v5e)
    f32_flops: float = 197e12  # the reference prices float32 at the bf16 peak
    sms: int = 1  # cores a kernel's grid spreads over

    def peak(self, dtype: str) -> float:
        """Peak FLOP/s of products in ``dtype`` (a dtype name)."""
        if dtype_bytes(dtype) == 1:
            return self.int8_flops
        if "float32" in dtype or "float64" in dtype:
            return self.f32_flops
        return self.peak_flops


TPU_V5E_SPECS = ChipSpecs()

# NVIDIA H100 SXM (data sheet, dense, 700 W): 989 TFLOP/s bf16, 1979 TOP/s
# int8, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of 80 GB
# HBM3, NVLink 450 GB/s a direction, 132 SMs; the on-chip budget is the
# shared memory one block may hold (kSmemMax, csrc/common.cuh)
H100_SPECS = ChipSpecs(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
                       hbm_bytes=80e9, vmem_bytes=k1.SMEM_MAX, int8_flops=1979e12,
                       f32_flops=67e12, sms=132)


def dtype_bytes(dtype) -> int:
    """Operand bytes per element, from the dtype's name (a string, a numpy
    or a torch dtype)."""
    name = getattr(dtype, "name", None) or str(dtype)
    if "int8" in name or "uint8" in name or "fp8" in name:
        return 1
    if "bfloat16" in name or "float16" in name:
        return 2
    if "64" in name:
        return 8
    return 4


# --------------------------------------------------------------------------
# The reference's block-triple model (parity only)
# --------------------------------------------------------------------------

def kernel_vmem_bytes(op: str, block_m: int, block_k: int, block_n: int,
                      r: int, dtype, *, double_buffered: bool = True) -> int:
    """Steady-state VMEM footprint of one Pallas launch config (the
    reference's arithmetic)."""
    eb = dtype_bytes(dtype)
    mult = 2 if double_buffered else 1
    f32 = 4
    if op == "lowrank_fwd":
        stream = (block_m * block_k + block_k * r + r * block_n
                  + block_m * block_n) * eb
        scratch = block_m * r * f32
    elif op == "lowrank_dx":
        stream = (block_m * block_n + block_k * r + r * block_n
                  + block_m * block_k) * eb
        scratch = block_m * r * f32
    elif op == "lowrank_du":
        stream = (block_m * block_k + block_m * block_n + r * block_n
                  + block_k * r) * eb
        scratch = (block_m * r + block_k * r) * f32
    elif op == "lowrank_dv":
        stream = (block_m * block_k + block_k * r + block_m * block_n
                  + r * block_n) * eb
        scratch = (block_m * r + r * block_n) * f32
    elif op == "lowrank_ffn":
        stream = (block_m * block_k + 2 * (block_k * r + r * block_n)
                  + block_m * block_n) * eb
        scratch = 2 * block_m * r * f32
    elif op == "flash":
        stream = (block_m * r + 2 * block_k * r + block_m * r) * eb
        scratch = (2 * block_m + block_m * r) * f32
    else:
        raise ValueError(f"unknown op {op!r}")
    return stream * mult + scratch


def kernel_candidate_time(op: str, m: int, c: int, r: int, s: int,
                          block_m: int, block_k: int, block_n: int,
                          dtype, *, specs: ChipSpecs = TPU_V5E_SPECS) -> float:
    """Predicted seconds of one Pallas launch config: max(compute, memory)
    with grid-aware HBM traffic (the reference's arithmetic)."""
    eb = dtype_bytes(dtype)
    peak = specs.int8_flops if eb == 1 else specs.peak_flops
    gm, gk, gn = -(-m // block_m), -(-c // block_k), -(-s // block_n)
    if op in ("lowrank_fwd", "lowrank_ffn"):
        branches = 2 if op == "lowrank_ffn" else 1
        flops = 2.0 * m * c * r * branches + 2.0 * m * r * s * branches
        mem = (m * c * gn + branches * (c * r * gm + r * s * gm) + m * s) * eb
    elif op == "lowrank_dx":
        flops = 2.0 * m * s * r + 2.0 * m * r * c
        mem = (m * s * gk + r * s * gm + c * r * gm + m * c) * eb
    elif op == "lowrank_du":
        flops = 2.0 * m * s * r * gk + 2.0 * m * c * r
        mem = (m * s * gk + r * s * gk + m * c * 1 + c * r) * eb
    elif op == "lowrank_dv":
        flops = 2.0 * m * c * r * gn + 2.0 * m * r * s
        mem = (m * c * gn + c * r * gn + m * s * 1 + r * s) * eb
    elif op == "flash":
        flops = 4.0 * m * s * r
        mem = (m * r * 1 + 2 * s * r * gm + m * r) * eb
    else:
        raise ValueError(f"unknown op {op!r}")
    return max(flops / peak, mem / specs.hbm_bw)


def prune_candidates(op: str, m: int, c: int, r: int, s: int, dtype,
                     candidates: List[Tuple[int, int, int]],
                     *, specs: ChipSpecs = TPU_V5E_SPECS,
                     double_buffered: bool = True,
                     ) -> List[Tuple[int, int, int]]:
    """VMEM-fit pruning, survivors ordered by predicted time (the
    reference's arithmetic)."""
    fit = [cand for cand in candidates
           if kernel_vmem_bytes(op, *cand, r=r, dtype=dtype,
                                double_buffered=double_buffered)
           <= specs.vmem_bytes]
    return sorted(fit, key=lambda cand: kernel_candidate_time(
        op, m, c, r, s, *cand, dtype, specs=specs))


# --------------------------------------------------------------------------
# The hand-written kernels' work: FLOPs and bytes of one call
# --------------------------------------------------------------------------

# int8 ops: their operands are int8, their scales float32
INT8_OPS = ("int8_matmul", "int8_linear", "int8_lowrank_matmul", "int8_lowrank_linear")


def kernel_cost(op: str, dims: Dict, dtype="bfloat16") -> Tuple[int, int]:
    """(operations, bytes) of one call of kernel ``op`` (a wrapper's name)
    at ``dims``: K1-K4 ``M, C, r, S``; K5 ``M, C, F`` and ``r`` (or ``rg``
    and ``ru``); K6 ``M, C, S``; K7 ``M, C, r, S``; K8 ``B, Sq, Sk, H, KV,
    D`` (``Dv``, default D) and ``causal``.  Each input is read once and
    each output written once; ``dtype`` is the activations' (K1-K5 and K8's
    operands, the int8 serving entries' x and y).  Operations are in the
    kernel's own type: bf16 FLOPs, or int8 operations for K6 and K7."""
    eb = dtype_bytes(dtype)
    if op == "flash_attention":
        b, sq, sk, h, kv = (dims[k] for k in ("B", "Sq", "Sk", "H", "KV"))
        dh = dims["D"]
        dv = dims.get("Dv", dh)
        # under causal, query i sees keys 0..i
        visible = sum(min(i + 1, sk) for i in range(sq)) if dims["causal"] else sq * sk
        return (2 * b * h * (dh + dv) * visible,
                eb * (b * sq * h * (dh + dv) + b * sk * kv * (dh + dv)))
    m, c = dims["M"], dims["C"]
    if op in INT8_OPS:
        s = dims["S"]
        fused = op in ("int8_linear", "int8_lowrank_linear")
        # a serving entry takes x in its own dtype and writes y in it; the
        # int8-operand entry takes int8 x and writes float32 y
        xbytes, ybytes = (eb * m * c, eb * m * s) if fused else (m * c, 4 * m * s)
        if op in ("int8_matmul", "int8_linear"):
            return 2 * m * c * s, xbytes + c * s + (4 * s if fused else 0) + ybytes
        r = dims["r"]
        return (2 * m * c * r + 2 * m * r * s,
                xbytes + c * r + 4 * r + r * s + 4 * s + ybytes)
    if op == "lowrank_gated_ffn":
        f = dims["F"]
        rs = dims.get("rg", dims.get("r")) + dims.get("ru", dims.get("r"))
        return 2 * (m * c * rs + m * rs * f), eb * (m * c + c * rs + rs * f + m * f)
    if op not in ("lowrank_matmul", "lowrank_matmul_dx", "lowrank_matmul_du",
                  "lowrank_matmul_dv"):
        raise ValueError(f"unknown kernel {op!r}")
    # every low-rank kernel reads (or writes) x-, U-, V- and y-sized
    # operands once, and does two rank-r products
    r, s = dims["r"], dims["S"]
    return 2 * m * c * r + 2 * m * r * s, eb * (m * c + c * r + r * s + m * s)


# --------------------------------------------------------------------------
# The port's candidate model (kernels/autotune.py)
# --------------------------------------------------------------------------

# device time of one launch the model charges beside its work
LAUNCH_S = 3e-6


def _term(flops: float, nbytes: float, ctas: int, specs: ChipSpecs) -> float:
    """max(compute, memory) of work spread over ``ctas`` CTAs, one an SM:
    a grid short of a wave gets its share of the card's rates."""
    share = min(1.0, max(ctas, 1) / specs.sms)
    return max(flops / (specs.peak_flops * share), nbytes / (specs.hbm_bw * share))


def _per_sm(flops: float, nbytes: float, specs: ChipSpecs) -> float:
    """Seconds one SM takes for ``flops`` and ``nbytes`` at its share of
    the card's rates."""
    return max(flops * specs.sms / specs.peak_flops, nbytes * specs.sms / specs.hbm_bw)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _lowrank_fwd_time(m, c, r, s, nb, choice, specs) -> float:
    if choice.design == "large":
        ctas = min(specs.sms, 4 * _cdiv(m, 64))
        flops = 2.0 * nb * (m * c * r + m * r * s)
        nbytes = 2.0 * (m * c + nb * (c * r + r * s) + m * s + 2 * nb * m * r)
        return LAUNCH_S + _term(flops, nbytes, ctas, specs)
    cs, _, _, w1, w2 = choice.plan
    blocks = _cdiv(m, 128)
    tiles = nb * _cdiv(r, w1)
    cols = _cdiv(s, w2)
    # phase 1: x is read once per rank tile, U once, t written once
    t1 = _term(2.0 * nb * m * c * r, 2.0 * (m * c * tiles + nb * c * r + nb * m * r),
               cs * tiles * blocks, specs)
    # phase 2: V is read once per row block, t once per column tile
    t2 = _term(2.0 * nb * m * r * s, 2.0 * (nb * r * s * blocks + nb * m * r * cols + m * s),
               cols * blocks, specs)
    return 2 * LAUNCH_S + t1 + t2


def _rank_phase(m, depth, r, specs) -> float:
    """The backward kernels' phase 1: the rank-r intermediate of M rows
    over ``depth``, on 64 x 128 tiles."""
    return LAUNCH_S + _term(2.0 * m * depth * r, 2.0 * (m * depth + depth * r + m * r),
                            _cdiv(m, 64) * _cdiv(r, 128), specs)


def _dx_time(m, c, r, s, choice, specs) -> float:
    g, groups = choice.plan
    blocks, tiles = _cdiv(m, kb.DX_ROWS), _cdiv(c, kb.DX_COLS)
    # the busiest CTA's tiles: its row blocks times its column tiles
    rounds = _cdiv(blocks, groups) * _cdiv(tiles, g)
    tile = _per_sm(2.0 * kb.DX_ROWS * kb.DX_COLS * r,
                   2.0 * (kb.DX_COLS * r + kb.DX_ROWS * kb.DX_COLS), specs)
    dt_load = _per_sm(0.0, 2.0 * kb.DX_ROWS * r, specs) * _cdiv(blocks, groups)
    return _rank_phase(m, s, r, specs) + LAUNCH_S + rounds * tile + dt_load


def _dudv_time(m, rows, cols, depth, r, choice, specs) -> float:
    (splits,) = choice.plan
    tiles = _cdiv(rows, kb.TILE_ROWS) * _cdiv(cols, kb.TILE_COLS)
    boxes = _cdiv(m, kb.BOX_M)
    waves = _cdiv(tiles * splits, specs.sms)
    box = _per_sm(2.0 * kb.TILE_ROWS * kb.TILE_COLS * kb.BOX_M,
                  2.0 * kb.BOX_M * (kb.TILE_ROWS + kb.TILE_COLS), specs)
    t = _rank_phase(m, depth, r, specs) + LAUNCH_S + waves * _cdiv(boxes, splits) * box
    if splits > 1:  # the reduce launch reads every float32 partial
        t += LAUNCH_S + _term(0.0, 4.0 * splits * rows * cols + 2.0 * rows * cols, tiles, specs)
    return t


def _flash_time(b, sq, sk, h, kv, d, causal, choice, specs) -> float:
    (grid,) = choice.plan
    units = k8.flash_units(b, sq, sk, h, kv, causal)
    # the busiest CTA's kv tiles, walking the snake over a grid of `grid`
    load = max(sum(units[p][4] for p in mine) for mine in k8.flash_plan(len(units), grid))
    tile = _per_sm(4.0 * k8.UNIT_ROWS * k8.KV_TILE * d, 2.0 * 2 * k8.KV_TILE * d, specs)
    return LAUNCH_S + load * tile


def choice_time(op: str, m: int, c: int, r: int, s: int, choice, *,
                specs: ChipSpecs = H100_SPECS) -> float:
    """Predicted seconds of one call of ``op`` (the reference's op names)
    at (M, C, r, S) under ``choice`` (``autotune.Choice``): the work of
    each launch over the share of the card its grid covers, or, for a
    persistent grid, the busiest CTA's rounds.  For ``flash``, M is Sq, C
    the heads of one batch row, r the head dim and S is Sk (causal)."""
    if op in ("lowrank_fwd", "lowrank_ffn"):
        return _lowrank_fwd_time(m, c, r, s, 2 if op == "lowrank_ffn" else 1, choice, specs)
    if op == "lowrank_dx":
        return _dx_time(m, c, r, s, choice, specs)
    if op == "lowrank_du":
        return _dudv_time(m, c, r, s, r, choice, specs)
    if op == "lowrank_dv":
        return _dudv_time(m, r, s, c, r, choice, specs)
    if op == "flash":
        return _flash_time(1, m, s, c, c, r, True, choice, specs)
    raise ValueError(f"unknown op {op!r}")


def _fits(op: str, m: int, r: int, choice, specs: ChipSpecs) -> bool:
    """Whether the candidate's shared memory fits one block (the
    wrappers' own sizes; a decode CTA at its fewest rows, 16)."""
    if op in ("lowrank_fwd", "lowrank_ffn"):
        nb = 2 if op == "lowrank_ffn" else 1
        if choice.design == "large":
            nbytes, slots, _ = k1.large_smem(r, nb)
            return slots >= 1 and nbytes <= specs.vmem_bytes
        return k1.decode_out_smem(16, r, choice.plan[4], nb) <= specs.vmem_bytes
    if op == "lowrank_dx":
        nbytes, slots, _ = kb.dx_smem(r)
        return slots >= 1 and nbytes <= specs.vmem_bytes
    return True


def prune_choices(op: str, m: int, c: int, r: int, s: int, choices: List, *,
                  specs: ChipSpecs = H100_SPECS) -> List:
    """The candidates whose shared memory fits, ordered by predicted time
    (best first), so a measurement budget of k times the k best."""
    fit = [ch for ch in choices if _fits(op, m, r, ch, specs)]
    return sorted(fit, key=lambda ch: choice_time(op, m, c, r, s, ch, specs=specs))


# --------------------------------------------------------------------------
# Step roofline
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    useful_ratio: float
    collective_breakdown: Dict[str, float]
    specs: ChipSpecs = TPU_V5E_SPECS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap step-time lower bound = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful compute at the bf16 peak of the specs it was given, over
        the ideal step time: 1.0 means every cycle on model FLOPs."""
        ideal = self.model_flops / self.specs.peak_flops
        return ideal / self.step_s if self.step_s > 0 else 0.0


def model_flops_per_device(num_params_active: float, tokens_global: int,
                           devices: int, *, kind: str = "train") -> float:
    """6*N*D for train (fwd 2ND + bwd 4ND), 2*N*D for inference."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * num_params_active * tokens_global / devices


def compute_seconds(cost, specs: ChipSpecs) -> float:
    """Each dtype's FLOPs at its own peak; FLOPs no dtype claims at the
    bf16 peak."""
    by = getattr(cost, "flops_by_dtype", {}) or {}
    rest = cost.flops - sum(by.values())
    return sum(f / specs.peak(dt) for dt, f in by.items()) + rest / specs.peak_flops


def roofline_terms(cost, *, model_flops: float,
                   specs: ChipSpecs = TPU_V5E_SPECS) -> Roofline:
    """The step's three terms from a ``cost.StepCost`` (or any cost with
    ``flops``, ``bytes`` and ``collective_bytes``)."""
    return Roofline(
        compute_s=compute_seconds(cost, specs),
        memory_s=cost.bytes / specs.hbm_bw,
        collective_s=cost.total_collective_bytes / specs.ici_bw,
        model_flops=model_flops,
        hlo_flops=cost.flops,
        useful_ratio=(model_flops / cost.flops) if cost.flops else 0.0,
        collective_breakdown=dict(cost.collective_bytes),
        specs=specs,
    )
