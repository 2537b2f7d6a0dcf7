"""K5: fused low-rank SwiGLU first half ``silu((x Ug) Vg) * ((x Uu) Vu)``.

The CUDA C++ kernel is ``csrc/lowrank_ffn.cu``, in two designs chosen by M
alone (:data:`LARGE_M`); the decode design is K1's with both
branches, its plan ``decode_plan(..., nb=2)``.  Same contract as
:mod:`repro_torch.kernels.lowrank_matmul`: CPU tensors take the plain
version, CUDA tensors the kernel or an error; ``lowrank_gated_ffn.launches``
counts kernel launches and ``lowrank_gated_ffn.launches_by_shape`` counts them
by ``(M, C, rg, ru, F)``.  The kernel keeps both branches in float32 up to
the gated product; the plain version rounds each branch to x's dtype first
(the unfused model path), so in bf16 the two differ by that rounding.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.lowrank_matmul import (RANK_CEILING, RANK_MAX, check_cuda_operands,
                                                decode_plan, decode_rt, large_scratch, priced,
                                                raise_on_error, sm_count)

__all__ = ["lowrank_gated_ffn", "LARGE_M", "FFN_RANK_MAX"]

# The largest rank of either branch (kRMax in csrc/common.cuh, K1's): past
# 512 both designs walk both branches' ranks in pieces and apply silu(g) * u
# to the whole float32 sums.
FFN_RANK_MAX = RANK_MAX

# M from which K5 takes the large-M design, from the H100's timings of both
# designs (chip_smoke.py's designs phase, PERF.md section 6): at Eq.-5 and
# Algorithm-1 ranks the decode design is ahead, or within a few percent, up
# to 383 rows, and behind from 384
LARGE_M = 384


def lowrank_gated_ffn(x: torch.Tensor, gu: torch.Tensor, gv: torch.Tensor,
                      uu: torch.Tensor, uv: torch.Tensor, *, large: Optional[bool] = None,
                      plan: Optional[tuple] = None) -> torch.Tensor:
    """x (M, C); gate gu (C, rg), gv (rg, F); up uu (C, ru), uv (ru, F) -> (M, F).
    ``large`` and ``plan`` as for K1 (defaults: ``LARGE_M``, ``decode_plan``)."""
    if x.device.type == "cpu":
        return ref.lowrank_gated_ffn_ref(x, gu, gv, uu, uv)
    if any(t.dim() != 2 for t in (x, gu, gv, uu, uv)):
        raise ValueError("lowrank_gated_ffn: every operand must be 2-D")
    m, c = x.shape
    rg, f = gv.shape
    ru = uv.shape[0]
    if gu.shape != (c, rg) or uu.shape != (c, ru) or uv.shape != (ru, f):
        raise ValueError(
            f"lowrank_gated_ffn: shapes x {tuple(x.shape)}, gu {tuple(gu.shape)}, "
            f"gv {tuple(gv.shape)}, uu {tuple(uu.shape)}, uv {tuple(uv.shape)} "
            f"do not chain")
    if not (1 <= rg <= FFN_RANK_MAX and 1 <= ru <= FFN_RANK_MAX):
        raise ValueError(f"lowrank_gated_ffn: ranks ({rg}, {ru}) outside [1, {FFN_RANK_MAX}] "
                         f"({RANK_CEILING})")
    check_cuda_operands("lowrank_gated_ffn", (x, gu, gv, uu, uv))
    if x.device.type == "meta":
        return priced(lowrank_gated_ffn, (m, c, rg, ru, f), (m, f), x)
    return _launch(x, gu, gv, uu, uv, large=m >= LARGE_M if large is None else large,
                   plan=plan)


def _launch(x: torch.Tensor, gu: torch.Tensor, gv: torch.Tensor, uu: torch.Tensor,
            uv: torch.Tensor, *, large: bool, plan: tuple | None = None) -> torch.Tensor:
    """Launch one design on checked CUDA operands (``chip_smoke.py`` times
    both designs through it on either side of LARGE_M, and the decode
    design under other plans)."""
    m, c = x.shape
    rg, f = gv.shape
    ru = uv.shape[0]
    y = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if y.numel() > 2 ** 31 - 1:
        raise ValueError(f"lowrank_gated_ffn: output ({m}, {f}) exceeds int32 indexing")
    if m == 0 or f == 0:
        return y
    lib = build.load("lowrank_ffn")
    ptrs = [t.data_ptr() for t in (x, gu, gv, uu, uv, y)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if large:
        scratch = large_scratch(lib.repro_lowrank_ffn_large_scratch, x.device, m, c, rg, ru)
        fn = lib.repro_lowrank_ffn_large
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        code = fn(*ptrs, scratch.data_ptr(), m, c, rg, ru, f, stream)
    else:
        t = torch.empty(2 * m * decode_rt(max(rg, ru)), dtype=x.dtype, device=x.device)
        fn = lib.repro_lowrank_ffn
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan = plan or decode_plan(c, max(rg, ru), f, sm_count(x.device.index), nb=2)
        code = fn(*ptrs, t.data_ptr(), m, c, rg, ru, f, *plan, stream)
    raise_on_error("lowrank_ffn", lib, code)
    lowrank_gated_ffn.launches += 1
    lowrank_gated_ffn.launches_by_shape[(m, c, rg, ru, f)] += 1
    return y


lowrank_gated_ffn.launches = 0
lowrank_gated_ffn.launches_by_shape = Counter()
lowrank_gated_ffn.priced_by_shape = Counter()
