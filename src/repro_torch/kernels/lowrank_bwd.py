"""K2-K4: the backward of the low-rank matmul ``y = (x @ U) @ V``.

The CUDA C++ kernels are ``csrc/lowrank_bwd.cu`` (its source note says
which TPU kernels they replace, what bounds them and how the design
answers that).  Same contract as :mod:`repro_torch.kernels.lowrank_matmul`:
CPU tensors take the plain versions (``kernels/ref.py``), CUDA tensors the
kernel or an error, never a fallback.  Each wrapper keeps ``launches``
(one per call that launched its kernel) and ``launches_by_shape`` keyed by
``(M, C, r, S)``.  All three run on ``wgmma`` fed by TMA and form the
rank-r intermediate once per call (phase 1):

* :func:`lowrank_matmul_dx` — ``dx = (dy Vᵀ) Uᵀ`` (K2): phase 2 on a
  persistent grid of at most one wave, each CTA holding a 128-row block of
  ``dy Vᵀ`` in shared memory and walking its share of that block's output
  column tiles (:func:`dx_plan`, :func:`dx_tiles`); no split, so nothing to
  reduce and the same bits every call;
* :func:`lowrank_matmul_du` — ``dU = xᵀ (dy Vᵀ)`` (K3) and
  :func:`lowrank_matmul_dv` — ``dV = (x U)ᵀ dy`` (K4): the sum over M on
  64 x 128 output tiles, split over M by :func:`split_plan` and summed in
  split order by a last launch (the same bits every call).

Each wrapper allocates the output and one scratch, sized by the library
for the operands at hand (the intermediate, K3/K4's float32 partials of
the split sum, and padded copies of operands TMA cannot read).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.lowrank_matmul import (RANK_MAX, check_cuda_operands,
                                                raise_on_error)

__all__ = ["lowrank_matmul_dx", "lowrank_matmul_du", "lowrank_matmul_dv"]

# csrc/lowrank_bwd.cu's K3/K4 tiling: output rows (kTBM) and columns
# (kTBN) per CTA, and rows of M per stage (kTBK: one TMA box deep)
TILE_ROWS, TILE_COLS, BOX_M = 64, 128, 128
# K2's phase 2 (csrc/lowrank_bwd.cu's k2_dx_kernel): rows of dx a row
# block (kXBM) and columns a tile (kXBN)
DX_ROWS, DX_COLS = 128, 128


def dx_plan(m: int, c: int, sms: int) -> tuple:
    """(g, groups) of K2's phase 2 on ``sms`` SMs: g CTAs share each
    ``DX_ROWS``-row block of dx, as many as it has 128-column tiles or as
    fill one wave beside the other blocks, and ``groups`` of them walk the
    row blocks; the grid, g x groups, is at most one wave."""
    blocks, tiles = -(-m // DX_ROWS), -(-c // DX_COLS)
    g = max(1, min(tiles, sms // blocks))
    return g, min(blocks, max(1, sms // g))


def dx_tiles(m: int, c: int, g: int, groups: int) -> list:
    """The (row block, column tile) pairs each CTA of K2's phase 2 computes,
    in its order, as the kernel walks them: CTA i takes column tiles
    i % g, i % g + g, ... of row blocks i // g, i // g + groups, ..."""
    blocks, tiles = -(-m // DX_ROWS), -(-c // DX_COLS)
    return [[(rb, tc) for rb in range(i // g, blocks, groups) for tc in range(i % g, tiles, g)]
            for i in range(g * groups)]


def split_plan(m: int, rows: int, cols: int, sms: int) -> int:
    """Ways to split the sum over M of a (rows, cols) dU or dV: as many as
    fill one wave of ``sms`` CTAs beside the output's 64 x 128 tiles, each
    at least one ``BOX_M``-row box deep; 1 when the tiles alone fill it."""
    tiles = -(-rows // TILE_ROWS) * -(-cols // TILE_COLS)
    return max(1, min(sms // tiles, -(-m // BOX_M)))


def split_rows(m: int, splits: int) -> list:
    """The [start, stop) rows of M each split sums, in split order, as the
    kernel cuts them: whole boxes, ``z * boxes // splits`` onwards."""
    boxes = -(-m // BOX_M)
    return [(BOX_M * (z * boxes // splits), min(m, BOX_M * ((z + 1) * boxes // splits)))
            for z in range(splits)]


def _check(op: str, m: int, c: int, r: int, s: int, tensors) -> None:
    if not 1 <= r <= RANK_MAX:
        raise ValueError(f"{op}: rank {r} outside [1, {RANK_MAX}]")
    check_cuda_operands(op, tensors)
    if max(m * c, m * s, m * (r + 8), c * r, r * s) > 2 ** 31 - 1:
        raise ValueError(f"{op}: shape (M {m}, C {c}, r {r}, S {s}) exceeds int32 indexing")


def _shapes(op: str, **named) -> None:
    if any(t.dim() != 2 for t in named.values()):
        raise ValueError(f"{op}: every operand must be 2-D, got "
                         + ", ".join(f"{k} {tuple(t.shape)}" for k, t in named.items()))


def _launch(name: str, ptrs, ints, like: torch.Tensor) -> None:
    """Call ``name`` of the built library with device pointers ``ptrs``,
    int arguments ``ints`` and the current stream; raise on its error."""
    lib = build.load("lowrank_bwd")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(*(t.data_ptr() for t in ptrs), *ints,
              torch.cuda.current_stream(like.device).cuda_stream)
    raise_on_error("lowrank_bwd", lib, code)


def _sms(like: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(like.device).multi_processor_count


def bwd_scratch(op: str, operands, dims, plan) -> torch.Tensor:
    """The scratch of one K2 (``op`` "dx"), K3 ("du") or K4 ("dv") call on
    these operands (the rank-r intermediate, K3/K4's float32 partials of a
    sum split ``plan`` ways, padded copies of operands TMA cannot read),
    sized by the library."""
    fn = getattr(build.load("lowrank_bwd"), f"repro_lowrank_{op}_scratch")
    extra = () if op == "dx" else (plan,)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (4 + len(extra))
    fn.restype = ctypes.c_longlong
    size = fn(*(t.data_ptr() for t in operands), *dims, *extra)
    return torch.empty(size, dtype=torch.uint8, device=operands[0].device)


def _launch_bwd(op: str, operands, out: torch.Tensor, dims, plan,
                scratch: Optional[torch.Tensor] = None) -> None:
    """Launch K2, K3 or K4 on checked operands (dx: dy, u, v; du: x, dy, v;
    dv: x, u, dy) into ``out``; ``plan`` is K2's :func:`dx_plan` or
    K3/K4's :func:`split_plan`; ``scratch`` defaults to a fresh one of
    :func:`bwd_scratch` (a caller may hand the same one to every call)."""
    if scratch is None:
        scratch = bwd_scratch(op, operands, dims, plan)
    extra = tuple(plan) if op == "dx" else (plan,)
    _launch(f"repro_lowrank_{op}", (*operands, scratch, out), (*dims, *extra), operands[0])


def lowrank_matmul_dx(dy: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """dy (M, S), u (C, r), v (r, S) -> dx (M, C) in dy's dtype."""
    if dy.device.type == "cpu":
        return ref.lowrank_matmul_dx_ref(dy, u, v)
    _shapes("lowrank_matmul_dx", dy=dy, u=u, v=v)
    m, s = dy.shape
    c, r = u.shape
    if v.shape != (r, s):
        raise ValueError(f"lowrank_matmul_dx: shapes dy {tuple(dy.shape)}, u "
                         f"{tuple(u.shape)}, v {tuple(v.shape)} do not chain")
    _check("lowrank_matmul_dx", m, c, r, s, (dy, u, v))
    dx = torch.empty((m, c), dtype=dy.dtype, device=dy.device)
    if m == 0 or c == 0:
        return dx
    _launch_bwd("dx", (dy, u, v), dx, (m, c, r, s), dx_plan(m, c, _sms(dy)))
    lowrank_matmul_dx.launches += 1
    lowrank_matmul_dx.launches_by_shape[(m, c, r, s)] += 1
    return dx


def lowrank_matmul_du(x: torch.Tensor, dy: torch.Tensor, v: torch.Tensor, *,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (M, C), dy (M, S), v (r, S) -> dU (C, r) in ``out_dtype`` (the
    primal u's dtype; default v's)."""
    if x.device.type == "cpu":
        return ref.lowrank_matmul_du_ref(x, dy, v, out_dtype=out_dtype)
    _shapes("lowrank_matmul_du", x=x, dy=dy, v=v)
    m, c = x.shape
    r, s = v.shape
    if dy.shape != (m, s):
        raise ValueError(f"lowrank_matmul_du: shapes x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, v {tuple(v.shape)} do not chain")
    if (out_dtype or v.dtype) != torch.bfloat16:
        raise TypeError(f"lowrank_matmul_du: the CUDA kernel writes bfloat16, asked "
                        f"for {out_dtype}")
    _check("lowrank_matmul_du", m, c, r, s, (x, dy, v))
    if m == 0:
        return torch.zeros((c, r), dtype=torch.bfloat16, device=x.device)
    du = torch.empty((c, r), dtype=torch.bfloat16, device=x.device)
    if c == 0:
        return du
    _launch_bwd("du", (x, dy, v), du, (m, c, r, s), split_plan(m, c, r, _sms(x)))
    lowrank_matmul_du.launches += 1
    lowrank_matmul_du.launches_by_shape[(m, c, r, s)] += 1
    return du


def lowrank_matmul_dv(x: torch.Tensor, u: torch.Tensor, dy: torch.Tensor, *,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (M, C), u (C, r), dy (M, S) -> dV (r, S) in ``out_dtype`` (the
    primal v's dtype; default u's)."""
    if x.device.type == "cpu":
        return ref.lowrank_matmul_dv_ref(x, u, dy, out_dtype=out_dtype)
    _shapes("lowrank_matmul_dv", x=x, u=u, dy=dy)
    m, c = x.shape
    r = u.shape[1]
    s = dy.shape[1]
    if u.shape[0] != c or dy.shape[0] != m:
        raise ValueError(f"lowrank_matmul_dv: shapes x {tuple(x.shape)}, u "
                         f"{tuple(u.shape)}, dy {tuple(dy.shape)} do not chain")
    if (out_dtype or u.dtype) != torch.bfloat16:
        raise TypeError(f"lowrank_matmul_dv: the CUDA kernel writes bfloat16, asked "
                        f"for {out_dtype}")
    _check("lowrank_matmul_dv", m, c, r, s, (x, u, dy))
    if m == 0:
        return torch.zeros((r, s), dtype=torch.bfloat16, device=x.device)
    dv = torch.empty((r, s), dtype=torch.bfloat16, device=x.device)
    if s == 0:
        return dv
    _launch_bwd("dv", (x, u, dy), dv, (m, c, r, s), split_plan(m, r, s, _sms(x)))
    lowrank_matmul_dv.launches += 1
    lowrank_matmul_dv.launches_by_shape[(m, c, r, s)] += 1
    return dv


for _f in (lowrank_matmul_dx, lowrank_matmul_du, lowrank_matmul_dv):
    _f.launches = 0
    _f.launches_by_shape = Counter()
