"""K5: fused low-rank SwiGLU first half ``silu((x Ug) Vg) * ((x Uu) Vu)``.

The CUDA C++ kernel is ``csrc/lowrank_ffn.cu``.  Same contract as
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

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.lowrank_matmul import (RANK_MAX, check_cuda_operands,
                                                raise_on_error)

__all__ = ["lowrank_gated_ffn"]


def lowrank_gated_ffn(x: torch.Tensor, gu: torch.Tensor, gv: torch.Tensor,
                      uu: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """x (M, C); gate gu (C, rg), gv (rg, F); up uu (C, ru), uv (ru, F) -> (M, F)."""
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
    if not (1 <= rg <= RANK_MAX and 1 <= ru <= RANK_MAX):
        raise ValueError(f"lowrank_gated_ffn: ranks ({rg}, {ru}) outside [1, {RANK_MAX}]")
    check_cuda_operands("lowrank_gated_ffn", (x, gu, gv, uu, uv))
    y = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if y.numel() > 2 ** 31 - 1:
        raise ValueError(f"lowrank_gated_ffn: output ({m}, {f}) exceeds int32 indexing")
    if m == 0 or f == 0:
        return y
    lib = build.load("lowrank_ffn")
    fn = lib.repro_lowrank_ffn
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), gu.data_ptr(), gv.data_ptr(), uu.data_ptr(),
              uv.data_ptr(), y.data_ptr(), m, c, rg, ru, f,
              torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("lowrank_ffn", lib, code)
    lowrank_gated_ffn.launches += 1
    lowrank_gated_ffn.launches_by_shape[(m, c, rg, ru, f)] += 1
    return y


lowrank_gated_ffn.launches = 0
lowrank_gated_ffn.launches_by_shape = Counter()
