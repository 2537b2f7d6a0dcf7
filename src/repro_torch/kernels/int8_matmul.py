"""K6 and K7: int8 x int8 -> int32 serving matmuls on the H100.

The serve-time export (``serving/export.py``, ``quantize_factors="int8"``)
stores each group as int8 values with per-output-column float32 scales.
These kernels consume them natively.  Each has two entries, one CUDA body
with a template flag (``csrc/int8_matmul.cu``; its source note says what
bounds them and how the design answers that):

* the TPU kernels' contract (``repro/kernels/int8_matmul.py``), x already
  quantized: :func:`int8_matmul` (K6), ``y_i32 = x_q (M, C) @ w_q (C, S)``
  with exact int32 accumulation, and :func:`int8_lowrank_matmul` (K7),
  ``t = (x_q @ u_q) * u_scale``, each row of t requantized to int8 on chip,
  ``y = (tq @ v_q) * ts * v_scale`` in float32, in x_q's units;
* the serving entries, which quantize x per row inside the kernel (the
  dynamic symmetric scale of :func:`quantize_rowwise`) and apply every
  scale there, returning the layer's output in x's dtype:
  :func:`int8_linear` (K6, one launch) and :func:`int8_lowrank_linear`
  (K7: its rank product once a call, then a programmatic dependent launch
  that requantizes and multiplies by v).  ``kernels.ops`` calls these.

The launch plans (:func:`k6_plan`, :func:`k7_plan`: how a cluster of CTAs
splits C, and how wide each CTA's column tile is) are computed here and
passed to the kernel, which checks them.  Each wrapper takes CPU tensors
through its plain version (``kernels/ref.py``) and CUDA tensors through its
kernel, and raises on anything the kernel does not take; it never falls
back.  ``<wrapper>.launches`` counts calls that launched the kernel and
``<wrapper>.launches_by_shape`` counts them by ``(M, C, S)`` (K6) or
``(M, C, r, S)`` (K7).  :func:`quantize_rowwise` and
:func:`quantize_colwise` are the JAX module's quantizers, as torch ops.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.lowrank_matmul import RANK_CEILING, RANK_MAX, raise_on_error, sm_count
from repro_torch.kernels.ref import quantize_colwise, quantize_rowwise

__all__ = ["int8_matmul", "int8_lowrank_matmul", "int8_linear", "int8_lowrank_linear",
           "k6_plan", "k7_plan", "quantize_rowwise", "quantize_colwise"]

_INT32_MAX = 2 ** 31 - 1
# csrc/int8_matmul.cu: rows of x a CTA (kBM), rows of B a chunk (kKC),
# columns of a B tile (kW), the largest cluster (kClusterMax), the most
# chunks a CTA's slab of x may hold (kPerMax), and the ranks of a piece of
# K7's requantization (kPiece)
ROWS, CHUNK, TILE, CLUSTER_MAX, PER_MAX, PIECE = 16, 128, 32, 8, 80, 512
# the deepest product whose int32 sum cannot wrap: C * 127**2 < 2**31
DEPTH_MAX = _INT32_MAX // 127 ** 2
PER_SOFT = 4  # chunks a K6 CTA takes where the cluster split allows
_XTYPE = {torch.float32: 1, torch.bfloat16: 2}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k6_plan(m: int, c: int, s: int, sms: int) -> tuple:
    """(cs, per) of K6 on ``sms`` SMs: clusters of ``cs`` CTAs split C, each
    CTA a slab of ``per`` 128-row chunks, beside ``cdiv(s, 32)`` column
    tiles and ``cdiv(m, 16)`` row blocks.  C is split until the grid holds
    about four CTAs an SM (at most 8 a cluster), and so that a CTA takes at
    most ``PER_SOFT`` chunks where a cluster allows (each chunk adds a slab
    of x to quantize before the product starts)."""
    chunks = _cdiv(c, CHUNK)
    base = _cdiv(s, TILE) * _cdiv(m, ROWS)
    cs = min(CLUSTER_MAX, chunks, max(4 * sms // base, _cdiv(chunks, PER_SOFT)))
    cs = max(1, cs, _cdiv(chunks, PER_MAX))
    per = _cdiv(chunks, cs)
    cs = _cdiv(chunks, per)  # every CTA has a chunk
    if cs > CLUSTER_MAX:
        raise ValueError(f"int8 K6: depth {c} exceeds what a cluster's slabs of x hold")
    return cs, per


def k7_plan(m: int, c: int, r: int, s: int, sms: int) -> tuple:
    """((w1, cs, per), w2) of K7 on ``sms`` SMs.  Phase 1 (t = x_q u_q):
    clusters of ``cs`` CTAs split C as far as a cluster goes, each CTA
    ``per`` chunks, and r is cut into tiles of ``w1`` columns, narrow
    enough that the tiles and the split fill the card at M = 8.  Phase 2:
    tiles of ``w2`` columns of S, narrow enough for one wave.  Both widths
    are 32 or at most 16 (:func:`_tile_width`)."""
    chunks, blocks = _cdiv(c, CHUNK), _cdiv(m, ROWS)
    per = _cdiv(chunks, CLUSTER_MAX)
    if per > PER_MAX:
        raise ValueError(f"int8 K7: depth {c} exceeds what a cluster's slabs of x hold")
    cs = _cdiv(chunks, per)
    return (_tile_width(r, _cdiv(sms, cs * blocks)), cs, per), _tile_width(s, _cdiv(sms, blocks))


def _tile_width(n: int, tiles: int) -> int:
    """The widest tile that cuts n columns into at least ``tiles`` tiles:
    32, or at most 16 (a TMA box of 32 columns starts at the 16-byte
    boundary at or before the tile, csrc tma_ok)."""
    w = max(1, min(TILE, n // tiles))
    return w if w == TILE else min(w, 16)


def _check(op: str, named) -> None:
    """Raise unless every ``(tensor, dtypes)`` is a contiguous tensor of one
    of those dtypes on the current CUDA device."""
    dev = named[0][0].device
    for t, dtypes in named:
        if t.device != dev:
            raise ValueError(f"{op}: operands on {t.device} and {dev}")
        if t.dtype not in dtypes:
            want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{op}: operand of shape {tuple(t.shape)} is {t.dtype}, "
                            f"the CUDA kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: operand of shape {tuple(t.shape)} is not contiguous")
        if t.numel() > _INT32_MAX:
            raise ValueError(f"{op}: operand with {t.numel()} elements exceeds int32 indexing")
    if dev.type != "meta" and dev.index != torch.cuda.current_device():
        raise ValueError(f"{op}: operands on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _check_depth(op: str, c: int) -> None:
    """Refuse a depth whose exact int32 sum could wrap (|sum| <= C * 127**2)."""
    if c > DEPTH_MAX:
        raise ValueError(f"{op}: depth {c} exceeds {DEPTH_MAX}, past which C * 127**2 "
                         f"reaches 2**31 and the int32 sum could wrap")


def _shapes_k6(op: str, x, w_q, w_scale=None) -> tuple:
    if x.dim() != 2 or w_q.dim() != 2 or w_q.shape[0] != x.shape[1]:
        raise ValueError(f"{op}: want x (M,C), w_q (C,S); got {tuple(x.shape)}, "
                         f"{tuple(w_q.shape)}")
    m, c = x.shape
    _check_depth(op, c)
    s = w_q.shape[1]
    if w_scale is not None and tuple(w_scale.shape) != (1, s):
        raise ValueError(f"{op}: want w_scale (1, {s}); got {tuple(w_scale.shape)}")
    return m, c, s


def _shapes_k7(op: str, x, u_q, u_scale, v_q, v_scale) -> tuple:
    if (x.dim() != 2 or u_q.dim() != 2 or v_q.dim() != 2
            or u_q.shape[0] != x.shape[1] or v_q.shape[0] != u_q.shape[1]):
        raise ValueError(f"{op}: want x (M,C), u_q (C,r), v_q (r,S); got "
                         f"{tuple(x.shape)}, {tuple(u_q.shape)}, {tuple(v_q.shape)}")
    m, c = x.shape
    r, s = v_q.shape
    if tuple(u_scale.shape) != (1, r) or tuple(v_scale.shape) != (1, s):
        raise ValueError(f"{op}: want u_scale (1, {r}) and v_scale (1, {s}); "
                         f"got {tuple(u_scale.shape)}, {tuple(v_scale.shape)}")
    if not 1 <= r <= RANK_MAX:
        raise ValueError(f"{op}: rank {r} outside [1, {RANK_MAX}] ({RANK_CEILING})")
    _check_depth(op, c)
    return m, c, r, s


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _k6(op: str, xtype: int, x, w_q, w_scale, y) -> None:
    m, c = x.shape
    s = w_q.shape[1]
    cs, per = k6_plan(m, c, s, sm_count(x.device.index))
    lib = build.load("int8_matmul")
    fn = lib.repro_int8_matmul
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = fn(xtype, x.data_ptr(), w_q.data_ptr(),
              w_scale.data_ptr() if w_scale is not None else None, y.data_ptr(), m, c, s, cs,
              per, _stream(x))
    raise_on_error(op, lib, code)


def k7_scratch(m: int, r: int, device) -> torch.Tensor:
    """K7's scratch: t (M, r) int32, then the serving entry's x scales (M)
    float32.  Each call writes all of it before reading it."""
    return torch.empty(m * r + m, dtype=torch.int32, device=device)


def _k7(op: str, xtype: int, x, u_q, u_scale, v_q, v_scale, y, scratch) -> None:
    m, c = x.shape
    r, s = v_q.shape
    (w1, cs, per), w2 = k7_plan(m, c, r, s, sm_count(x.device.index))
    lib = build.load("int8_matmul")
    fn = lib.repro_int8_lowrank_matmul
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = fn(xtype, x.data_ptr(), u_q.data_ptr(), u_scale.data_ptr(), v_q.data_ptr(),
              v_scale.data_ptr(), y.data_ptr(), scratch.data_ptr(),
              scratch.data_ptr() + 4 * m * r, m, c, r, s, w1, cs, per, w2, _stream(x))
    raise_on_error(op, lib, code)


def _output(op: str, m: int, s: int, dtype, device) -> torch.Tensor:
    if m * s > _INT32_MAX:
        raise ValueError(f"{op}: output ({m}, {s}) exceeds int32 indexing")
    return torch.empty((m, s), dtype=dtype, device=device)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact x_q (M, C) @ w_q (C, S), int8 -> int32 (M, S)."""
    if x_q.device.type == "cpu":
        return ref.int8_matmul_ref(x_q, w_q)
    m, c, s = _shapes_k6("int8_matmul", x_q, w_q)
    _check("int8_matmul", [(x_q, (torch.int8,)), (w_q, (torch.int8,))])
    y = _output("int8_matmul", m, s, torch.int32, x_q.device)
    if m == 0 or s == 0:
        return y
    if y.device.type == "meta":  # priced, not launched (lowrank_matmul.priced)
        int8_matmul.priced_by_shape[(m, c, s)] += 1
        return y
    _k6("int8_matmul", 0, x_q, w_q, None, y)
    int8_matmul.launches += 1
    int8_matmul.launches_by_shape[(m, c, s)] += 1
    return y


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """x (M, C) @ dequant(w_q) with x quantized per row to int8 first:
    ``(int32(x_q @ w_q) * x_scale) * w_scale`` in x's dtype (bf16 or float32),
    w_q (C, S) int8, w_scale (1, S) float32.  One launch on CUDA tensors."""
    if x.device.type == "cpu":
        return ref.int8_linear_ref(x, w_q, w_scale)
    m, c, s = _shapes_k6("int8_linear", x, w_q, w_scale)
    _check("int8_linear", [(x, tuple(_XTYPE)), (w_q, (torch.int8,)),
                           (w_scale, (torch.float32,))])
    y = _output("int8_linear", m, s, x.dtype, x.device)
    if m == 0 or s == 0:
        return y
    if y.device.type == "meta":  # priced, not launched (lowrank_matmul.priced)
        int8_linear.priced_by_shape[(m, c, s)] += 1
        return y
    _k6("int8_linear", _XTYPE[x.dtype], x, w_q, w_scale, y)
    int8_linear.launches += 1
    int8_linear.launches_by_shape[(m, c, s)] += 1
    return y


def int8_lowrank_matmul(x_q: torch.Tensor, u_q: torch.Tensor, u_scale: torch.Tensor,
                        v_q: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
    """((x_q @ u_q) * u_scale, requantized per row) @ v_q * v_scale.

    x_q (M, C) int8; u_q (C, r) int8 with u_scale (1, r) float32; v_q (r, S)
    int8 with v_scale (1, S) float32 -> float32 (M, S) in x_q's units."""
    if x_q.device.type == "cpu":
        return ref.int8_lowrank_matmul_ref(x_q, u_q, u_scale, v_q, v_scale)
    m, c, r, s = _shapes_k7("int8_lowrank_matmul", x_q, u_q, u_scale, v_q, v_scale)
    _check("int8_lowrank_matmul", [(x_q, (torch.int8,)), (u_q, (torch.int8,)),
                                   (u_scale, (torch.float32,)), (v_q, (torch.int8,)),
                                   (v_scale, (torch.float32,))])
    y = _output("int8_lowrank_matmul", m, s, torch.float32, x_q.device)
    if m == 0 or s == 0:
        return y
    if y.device.type == "meta":  # priced, not launched (lowrank_matmul.priced)
        int8_lowrank_matmul.priced_by_shape[(m, c, r, s)] += 1
        return y
    _k7("int8_lowrank_matmul", 0, x_q, u_q, u_scale, v_q, v_scale, y,
        k7_scratch(m, r, x_q.device))
    int8_lowrank_matmul.launches += 1
    int8_lowrank_matmul.launches_by_shape[(m, c, r, s)] += 1
    return y


def int8_lowrank_linear(x: torch.Tensor, u_q: torch.Tensor, u_scale: torch.Tensor,
                        v_q: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
    """:func:`int8_lowrank_matmul` of x quantized per row to int8 inside the
    kernel, times the x scales, in x's dtype (bf16 or float32).  Two
    launches on CUDA tensors (the second a programmatic dependent)."""
    if x.device.type == "cpu":
        return ref.int8_lowrank_linear_ref(x, u_q, u_scale, v_q, v_scale)
    m, c, r, s = _shapes_k7("int8_lowrank_linear", x, u_q, u_scale, v_q, v_scale)
    _check("int8_lowrank_linear", [(x, tuple(_XTYPE)), (u_q, (torch.int8,)),
                                   (u_scale, (torch.float32,)), (v_q, (torch.int8,)),
                                   (v_scale, (torch.float32,))])
    y = _output("int8_lowrank_linear", m, s, x.dtype, x.device)
    if m == 0 or s == 0:
        return y
    if y.device.type == "meta":  # priced, not launched (lowrank_matmul.priced)
        int8_lowrank_linear.priced_by_shape[(m, c, r, s)] += 1
        return y
    _k7("int8_lowrank_linear", _XTYPE[x.dtype], x, u_q, u_scale, v_q, v_scale, y,
        k7_scratch(m, r, x.device))
    int8_lowrank_linear.launches += 1
    int8_lowrank_linear.launches_by_shape[(m, c, r, s)] += 1
    return y


for _fn in (int8_matmul, int8_linear, int8_lowrank_matmul, int8_lowrank_linear):
    _fn.launches = 0
    _fn.launches_by_shape = Counter()
    _fn.priced_by_shape = Counter()
