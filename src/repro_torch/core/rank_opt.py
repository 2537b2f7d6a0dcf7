"""Rank optimization — paper §2.1, Algorithm 1 ("rank quantization"), as in
``repro/core/rank_opt.py``.

Given the Eq.-5 rank ``R`` for the desired compression ratio ``alpha`` and the
Eq.-6 lower bound ``R_min`` (rank at ratio ``alpha+1``), sweep ``t(r)`` for
``r in [R_min, R]`` and pick the rank just below the largest step-time cliff:

    R_opt = argmax_{r} [ t(r+1) - t(r) ]        (forward difference)

then keep the decomposed layer only if ``t(R_opt) < T_original`` (the
paper's per-layer fallback to the undecomposed layer).

Two ``t(r)`` backends, as in the JAX package:

* ``measured``      — :func:`measured_linear_time_fn` times a real
                      ``(x @ u) @ v`` against ``x @ w`` on a given device
                      (CUDA events on a GPU, the host clock on the CPU): the
                      paper's own platform-agnostic method.
* ``analytic-tpu``  — the deterministic TPU v5e roofline model with MXU tile
                      quantization, copied exactly so that both packages
                      decide the same ranks.  Its "times" are the model's,
                      not a measurement of any card.

:func:`optimize_rank_tucker` is Algorithm 1 for a (C, S, k, k) conv under
the analytic model, sweeping r1 of the Tucker-2 triple.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import svd, tucker

__all__ = ["TPU_V5E", "HardwareModel", "RankDecision", "analytic_layer_time",
           "optimize_rank", "optimize_rank_tucker", "quantize_rank",
           "measured_linear_time_fn"]


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Roofline constants + tile quantization for the analytic backend."""

    name: str = "tpu-v5e"
    peak_flops: float = 197e12  # bf16 MXU peak, per chip
    hbm_bw: float = 819e9  # bytes/s
    mxu_tile: int = 128  # systolic array edge -> matmul dim granularity
    bytes_per_elem: int = 2  # bf16

    def matmul_time(self, m: int, k: int, n: int, *, fused_operands: int = 0) -> float:
        """max(compute, memory) time of an (m,k)x(k,n) matmul; the
        ``fused_operands`` elements kept on chip are not HBM traffic."""
        tile = self.mxu_tile
        mq = -(-m // tile) * tile
        kq = -(-k // tile) * tile
        nq = -(-n // tile) * tile
        compute = 2.0 * mq * kq * nq / self.peak_flops
        traffic = (m * k + k * n + m * n - fused_operands) * self.bytes_per_elem
        return max(compute, traffic / self.hbm_bw)


TPU_V5E = HardwareModel()


def quantize_rank(rank: int, *, tile: int = 128, mode: str = "floor") -> int:
    """Snap a rank to the hardware tile (the 'rank quantization' of the title).

    ``floor`` keeps compression >= requested; ``nearest`` minimizes the rank
    perturbation.  Ranks below one tile are left unchanged.
    """
    if rank <= tile:
        return rank
    if mode == "floor":
        return (rank // tile) * tile
    if mode == "nearest":
        return max(tile, int(round(rank / tile)) * tile)
    raise ValueError(f"unknown quantize mode {mode!r}")


@dataclasses.dataclass(frozen=True)
class RankDecision:
    """Outcome of Algorithm 1 for one layer."""

    rank: int  # chosen rank (Eq.-5 rank if optimization rejected)
    use_decomposed: bool  # False -> keep the original layer (Algorithm 1 guard)
    original_time: float
    decomposed_time: float
    searched: Sequence[int] = ()
    times: Sequence[float] = ()

    @property
    def speedup(self) -> float:
        return self.original_time / max(self.decomposed_time, 1e-30)


def analytic_layer_time(m: int, c: int, s: int, rank: Optional[int], *,
                        hw: HardwareModel = TPU_V5E, kernel_fused: bool = True) -> float:
    """Analytic time of a (decomposed) linear layer on ``hw``.

    ``rank=None`` -> the original dense layer ``(m,c)x(c,s)``; otherwise two
    chained matmuls through the rank bottleneck, whose (m, r) intermediate
    never reaches HBM with ``kernel_fused``.
    """
    if rank is None:
        return hw.matmul_time(m, c, s)
    inter = m * rank if kernel_fused else 0
    return hw.matmul_time(m, c, rank, fused_operands=inter) + hw.matmul_time(
        m, rank, s, fused_operands=inter)


def optimize_rank(c: int, s: int, *, alpha: float = 2.0, m: int = 4096,
                  backend: str = "analytic-tpu", hw: HardwareModel = TPU_V5E,
                  time_fn: Optional[Callable[[Optional[int]], float]] = None,
                  stride: int = 1, kernel_fused: bool = True) -> RankDecision:
    """Algorithm 1 for an SVD-decomposable (C, S) linear layer.

    ``m`` is the probe batch (tokens); ``backend`` is "analytic-tpu" or
    "measured" (which needs ``time_fn``: rank, or None for the original
    layer, -> seconds); ``stride`` > 1 sweeps coarsely and then refines at
    stride 1 inside the bracket of the largest cliff.
    """
    r_hi = svd.svd_rank_for_compression(c, s, alpha)
    r_lo = svd.svd_rank_for_compression(c, s, alpha + 1.0)
    if backend == "analytic-tpu":
        probe = lambda r: analytic_layer_time(m, c, s, r, hw=hw,  # noqa: E731
                                              kernel_fused=kernel_fused)
    elif backend == "measured":
        if time_fn is None:
            raise ValueError("measured backend requires time_fn")
        probe = time_fn
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return _sweep(probe, r_lo, r_hi, stride)


def _sweep(probe: Callable[[Optional[int]], float], r_lo: int, r_hi: int,
           stride: int) -> RankDecision:
    """Algorithm 1's sweep of ``probe`` (rank, or None for the original
    layer, -> seconds) over ``[r_lo, r_hi]``."""
    ranks = list(range(r_lo, r_hi + 1, stride))
    if ranks[-1] != r_hi:
        ranks.append(r_hi)
    times = [probe(r) for r in ranks]
    t_orig = probe(None)

    if len(ranks) >= 2:
        diffs = np.diff(times)  # diffs[i] = t(ranks[i+1]) - t(ranks[i])
        # rank just below the largest cliff; ties -> largest rank (accuracy)
        best = int(np.flatnonzero(diffs == diffs.max())[-1])
        r_opt = ranks[best]
        t_opt = times[best]
        if stride > 1 and best + 1 < len(ranks):
            # refine at stride 1 inside (ranks[best], ranks[best+1]) so the
            # rank sits directly under the cliff
            for r in range(ranks[best] + 1, ranks[best + 1]):
                t = probe(r)
                if t <= t_opt * (1 + 1e-9):
                    r_opt, t_opt = r, t
    else:
        r_opt, t_opt = ranks[0], times[0]

    return RankDecision(
        rank=r_opt,
        use_decomposed=bool(t_opt < t_orig),
        original_time=float(t_orig),
        decomposed_time=float(t_opt),
        searched=tuple(ranks),
        times=tuple(float(t) for t in times),
    )


def optimize_rank_tucker(c: int, s: int, k: int, *, alpha: float = 2.0,
                         beta: float = 1.0, m: int = 4096, hw: HardwareModel = TPU_V5E,
                         time_fn: Optional[Callable[[Optional[int]], float]] = None,
                         stride: int = 1) -> RankDecision:
    """Algorithm 1 for a Tucker-decomposable (C, S, k, k) conv layer.

    The sweep variable is r1 (r2 = beta*r1, paper §2.1).  The analytic model
    treats the kxk core conv as a matmul with contraction c*k*k (im2col view).
    """
    (r_hi, _) = tucker.tucker_rank_for_compression(c, s, k, alpha, beta=beta)
    (r_lo, _) = tucker.tucker_min_rank(c, s, k, alpha, beta=beta)

    def analytic(r: Optional[int]) -> float:
        if r is None:
            return hw.matmul_time(m, c * k * k, s)
        r2 = max(1, int(beta * r))
        return (hw.matmul_time(m, c, r) + hw.matmul_time(m, r * k * k, r2)
                + hw.matmul_time(m, r2, s))

    return _sweep(time_fn if time_fn is not None else analytic, r_lo, r_hi, stride)


def measured_linear_time_fn(c: int, s: int, *, device, m: int = 1024, dtype=None,
                            iters: int = 5):
    """Build a ``time_fn`` that times a real (decomposed) linear layer on
    ``device``: the paper's own probe (warm up, then the median of
    ``iters`` runs).  ``device`` has no default: the probe must run on the
    machine whose ranks it decides.

    On a GPU each run is timed with CUDA events around the one or two
    ``torch.matmul`` calls; on the CPU with the host clock.  The operands
    are zeros, as in the JAX probe (the time does not depend on them), in
    ``dtype`` (default float32, as in JAX).
    """
    dev = torch.device(device)
    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((m, c), generator=gen, dtype=torch.float32, device=dev).to(dtype)

    def time_fn(rank: Optional[int]) -> float:
        if rank is None:
            args = (torch.zeros((c, s), dtype=dtype, device=dev),)
            f = lambda w: x @ w  # noqa: E731
        else:
            args = (torch.zeros((c, rank), dtype=dtype, device=dev),
                    torch.zeros((rank, s), dtype=dtype, device=dev))
            f = lambda u, v: (x @ u) @ v  # noqa: E731
        f(*args)  # warm up
        ts = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                f(*args)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) * 1e-3)
        else:
            for _ in range(iters):
                t0 = time.perf_counter()
                f(*args)
                ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    return time_fn
