"""K1: fused low-rank matmul ``y = (x @ U) @ V`` on the H100.

The CUDA C++ kernel is ``csrc/lowrank_matmul.cu`` (its source note says
which TPU kernel it replaces, what bounds it and how the design answers
that).  It has two designs, chosen by M alone: below :data:`LARGE_M` the
decode design (16-row tiles, an 8-CTA cluster splitting x·U over C), from
it the large-M design (``wgmma`` fed by TMA, one rank product per 64-row
block shared by a group of 4 CTAs through L2, one wave of such groups in a
cooperative launch, no clusters).  :func:`lowrank_matmul` takes CPU
tensors through the plain version
(``ref.lowrank_matmul_ref``) and CUDA tensors through the kernel, and
raises on anything the kernel does not take; it never falls back.
``lowrank_matmul.launches`` counts kernel launches, and
``lowrank_matmul.launches_by_shape`` counts them by ``(M, C, r, S)``.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Sequence

import torch

from repro_torch.kernels import build, ref

__all__ = ["lowrank_matmul", "RANK_MAX", "LARGE_M", "check_cuda_operands"]

RANK_MAX = 512  # kRMax in csrc/common.cuh
# M from which K1 takes the large-M design, from the H100's timings of both
# designs at M in {128, 256, 512, 2016} (chip_smoke.py's designs phase,
# PERF.md section 5): summed over a prefill layer's K1 calls the decode
# design is ahead at 128 (117 against 122 us) and behind from 256 (166
# against 124 us)
LARGE_M = 256
_INT32_MAX = 2 ** 31 - 1


def check_cuda_operands(op: str, tensors: Sequence[torch.Tensor]) -> None:
    """Raise unless every operand is a contiguous bf16 tensor on the current
    CUDA device.  An operand that requires grad is refused under grad mode:
    the kernel's result would carry no gradient (the autograd Functions in
    ``ops`` call the wrappers with grad mode off)."""
    dev = tensors[0].device
    for t in tensors:
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{op}: operand of shape {tuple(t.shape)} requires grad; "
                             f"call it through kernels.ops, whose autograd Function "
                             f"runs the backward kernels")
        if t.device != dev:
            raise ValueError(f"{op}: operands on {t.device} and {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{op}: the CUDA kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: operand of shape {tuple(t.shape)} is not contiguous")
        if t.numel() > _INT32_MAX:
            raise ValueError(f"{op}: operand with {t.numel()} elements exceeds int32 indexing")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{op}: operands on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def raise_on_error(op: str, lib: ctypes.CDLL, code: int) -> None:
    if code:
        msg = getattr(lib, f"repro_{op}_error")(code).decode()
        raise RuntimeError(f"{op}: kernel launch failed with CUDA error {code} ({msg})")


def large_scratch(size_fn, device: torch.device, *dims: int) -> torch.Tensor:
    """The large-M design's global scratch (the row blocks' t and their
    ready flags), sized by the library's ``*_large_scratch`` function."""
    size_fn.argtypes = [ctypes.c_int] * len(dims)
    size_fn.restype = ctypes.c_longlong
    return torch.empty(size_fn(*dims), dtype=torch.uint8, device=device)


def lowrank_matmul(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x (M, C) @ u (C, r) @ v (r, S) -> (M, S) in x's dtype."""
    if x.device.type == "cpu":
        return ref.lowrank_matmul_ref(x, u, v)
    if x.dim() != 2 or u.dim() != 2 or v.dim() != 2:
        raise ValueError(f"lowrank_matmul: want x (M,C), u (C,r), v (r,S); got "
                         f"{tuple(x.shape)}, {tuple(u.shape)}, {tuple(v.shape)}")
    m, c = x.shape
    r, s = v.shape
    if u.shape != (c, r):
        raise ValueError(f"lowrank_matmul: u {tuple(u.shape)} does not match "
                         f"x {tuple(x.shape)} and v {tuple(v.shape)}")
    if not 1 <= r <= RANK_MAX:
        raise ValueError(f"lowrank_matmul: rank {r} outside [1, {RANK_MAX}]")
    check_cuda_operands("lowrank_matmul", (x, u, v))
    return _launch(x, u, v, large=m >= LARGE_M)


def _launch(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *, large: bool) -> torch.Tensor:
    """Launch one design on checked CUDA operands (``chip_smoke.py`` times
    both designs through it on either side of LARGE_M)."""
    m, c = x.shape
    r, s = v.shape
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if y.numel() > _INT32_MAX:
        raise ValueError(f"lowrank_matmul: output ({m}, {s}) exceeds int32 indexing")
    if m == 0 or s == 0:
        return y
    lib = build.load("lowrank_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if large:
        scratch = large_scratch(lib.repro_lowrank_matmul_large_scratch, x.device, m, c, r)
        fn = lib.repro_lowrank_matmul_large
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        code = fn(x.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                  m, c, r, s, stream)
    else:
        fn = lib.repro_lowrank_matmul
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        code = fn(x.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr(), m, c, r, s, stream)
    raise_on_error("lowrank_matmul", lib, code)
    lowrank_matmul.launches += 1
    lowrank_matmul.launches_by_shape[(m, c, r, s)] += 1
    return y


lowrank_matmul.launches = 0
lowrank_matmul.launches_by_shape = Counter()
