"""K6 and K7: int8 x int8 -> int32 decode matmuls on the H100.

The serve-time export (``serving/export.py``, ``quantize_factors="int8"``)
stores each group as int8 values with per-output-column float32 scales.
These kernels consume them natively, as ``repro/kernels/int8_matmul.py``
does on the TPU:

* :func:`int8_matmul` (K6): ``y_i32 = x_q (M, C) @ w_q (C, S)`` with exact
  int32 accumulation; the caller applies the scales over the (M, S) output.
* :func:`int8_lowrank_matmul` (K7): ``t = (x_q @ u_q) * u_scale``, each row
  of t requantized to int8 on chip, ``y = (tq @ v_q) * ts * v_scale`` in
  float32, in x_q's units (the caller folds in the per-row x scales).

The CUDA C++ kernels are ``csrc/int8_matmul.cu`` (its source note says what
bounds them and how the design answers that).  Each wrapper takes CPU
tensors through its plain version (``ref.int8_matmul_ref``,
``ref.int8_lowrank_matmul_ref``) and CUDA tensors through its kernel, and
raises on anything the kernel does not take; it never falls back.
``<wrapper>.launches`` counts kernel launches and
``<wrapper>.launches_by_shape`` counts them by ``(M, C, S)`` (K6) or
``(M, C, r, S)`` (K7).  :func:`quantize_rowwise` and
:func:`quantize_colwise` are the JAX module's quantizers, as torch ops.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.lowrank_matmul import RANK_MAX, raise_on_error

__all__ = ["int8_matmul", "int8_lowrank_matmul", "quantize_rowwise", "quantize_colwise"]

_INT32_MAX = 2 ** 31 - 1


def quantize_rowwise(x: torch.Tensor):
    """Dynamic per-row symmetric int8: (values int8, scales float32 (..., 1))."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(ref.over_127(amax), min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_colwise(w: torch.Tensor):
    """Static per-output-column symmetric int8 for weights and factors:
    (values int8, scales float32 (..., 1, S))."""
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)
    scale = torch.clamp(ref.over_127(amax), min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _check(op: str, named) -> None:
    """Raise unless every ``(tensor, dtype)`` is a contiguous tensor of that
    dtype on the current CUDA device."""
    dev = named[0][0].device
    for t, dtype in named:
        if t.device != dev:
            raise ValueError(f"{op}: operands on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: operand of shape {tuple(t.shape)} is {t.dtype}, "
                            f"the CUDA kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: operand of shape {tuple(t.shape)} is not contiguous")
        if t.numel() > _INT32_MAX:
            raise ValueError(f"{op}: operand with {t.numel()} elements exceeds int32 indexing")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{op}: operands on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact x_q (M, C) @ w_q (C, S), int8 -> int32 (M, S)."""
    if x_q.device.type == "cpu":
        return ref.int8_matmul_ref(x_q, w_q)
    if x_q.dim() != 2 or w_q.dim() != 2 or w_q.shape[0] != x_q.shape[1]:
        raise ValueError(f"int8_matmul: want x_q (M,C), w_q (C,S); got "
                         f"{tuple(x_q.shape)}, {tuple(w_q.shape)}")
    _check("int8_matmul", [(x_q, torch.int8), (w_q, torch.int8)])
    m, c = x_q.shape
    s = w_q.shape[1]
    y = torch.empty((m, s), dtype=torch.int32, device=x_q.device)
    if y.numel() > _INT32_MAX:
        raise ValueError(f"int8_matmul: output ({m}, {s}) exceeds int32 indexing")
    if m == 0 or s == 0:
        return y
    lib = build.load("int8_matmul")
    fn = lib.repro_int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(x_q.data_ptr(), w_q.data_ptr(), y.data_ptr(), m, c, s,
              torch.cuda.current_stream(x_q.device).cuda_stream)
    raise_on_error("int8_matmul", lib, code)
    int8_matmul.launches += 1
    int8_matmul.launches_by_shape[(m, c, s)] += 1
    return y


int8_matmul.launches = 0
int8_matmul.launches_by_shape = Counter()


def int8_lowrank_matmul(x_q: torch.Tensor, u_q: torch.Tensor, u_scale: torch.Tensor,
                        v_q: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
    """((x_q @ u_q) * u_scale, requantized per row) @ v_q * v_scale.

    x_q (M, C) int8; u_q (C, r) int8 with u_scale (1, r) float32; v_q (r, S)
    int8 with v_scale (1, S) float32 -> float32 (M, S) in x_q's units."""
    if x_q.device.type == "cpu":
        return ref.int8_lowrank_matmul_ref(x_q, u_q, u_scale, v_q, v_scale)
    if (x_q.dim() != 2 or u_q.dim() != 2 or v_q.dim() != 2
            or u_q.shape[0] != x_q.shape[1] or v_q.shape[0] != u_q.shape[1]):
        raise ValueError(f"int8_lowrank_matmul: want x_q (M,C), u_q (C,r), v_q (r,S); got "
                         f"{tuple(x_q.shape)}, {tuple(u_q.shape)}, {tuple(v_q.shape)}")
    m, c = x_q.shape
    r, s = v_q.shape
    if tuple(u_scale.shape) != (1, r) or tuple(v_scale.shape) != (1, s):
        raise ValueError(f"int8_lowrank_matmul: want u_scale (1, {r}) and v_scale (1, {s}); "
                         f"got {tuple(u_scale.shape)}, {tuple(v_scale.shape)}")
    if not 1 <= r <= RANK_MAX:
        raise ValueError(f"int8_lowrank_matmul: rank {r} outside [1, {RANK_MAX}]")
    _check("int8_lowrank_matmul", [(x_q, torch.int8), (u_q, torch.int8),
                                   (u_scale, torch.float32), (v_q, torch.int8),
                                   (v_scale, torch.float32)])
    y = torch.empty((m, s), dtype=torch.float32, device=x_q.device)
    if y.numel() > _INT32_MAX:
        raise ValueError(f"int8_lowrank_matmul: output ({m}, {s}) exceeds int32 indexing")
    if m == 0 or s == 0:
        return y
    lib = build.load("int8_matmul")
    fn = lib.repro_int8_lowrank_matmul
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(x_q.data_ptr(), u_q.data_ptr(), u_scale.data_ptr(), v_q.data_ptr(),
              v_scale.data_ptr(), y.data_ptr(), m, c, r, s,
              torch.cuda.current_stream(x_q.device).cuda_stream)
    raise_on_error("int8_lowrank_matmul", lib, code)
    int8_lowrank_matmul.launches += 1
    int8_lowrank_matmul.launches_by_shape[(m, c, r, s)] += 1
    return y


int8_lowrank_matmul.launches = 0
int8_lowrank_matmul.launches_by_shape = Counter()
