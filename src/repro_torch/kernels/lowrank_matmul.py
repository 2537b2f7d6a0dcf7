"""K1: fused low-rank matmul ``y = (x @ U) @ V`` on the H100.

The CUDA C++ kernel is ``csrc/lowrank_matmul.cu`` (its source note says
which TPU kernel it replaces, what bounds it and how the design answers
that).  It has two designs, chosen by M against :func:`large_m` (a small
table by depth and rank, :data:`LARGE_M` its default): below it the
decode design (two launches over the whole card: the rank kernel forms
``t = x U`` once for all rows, clusters of CTAs splitting C, into an L2
scratch; the out kernel, a programmatic dependent, multiplies it by V's
column tiles), from it the large-M design (``wgmma`` fed by TMA, one rank
product per 64-row block shared by a group of 4 CTAs through L2, one wave of
such groups in a cooperative launch, no clusters).  :func:`decode_plan` is
the decode design's launch plan, which the kernel checks.
:func:`lowrank_matmul` takes CPU tensors through the plain version
(``ref.lowrank_matmul_ref``) and CUDA tensors through the kernel, and
raises on anything the kernel does not take; it never falls back.
``lowrank_matmul.launches`` counts kernel launches, and
``lowrank_matmul.launches_by_shape`` counts them by ``(M, C, r, S)``.

On the meta device (``launch/dryrun.py``) every wrapper of the port checks
its operands as on CUDA and then prices the call instead of launching it:
:func:`priced` counts it in ``<wrapper>.priced_by_shape`` (keyed as
``launches_by_shape``) and returns an empty result of the right shape and
dtype.  Nothing is computed, so this is not a fallback, and the launch
counters are not touched.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build, ref

__all__ = ["lowrank_matmul", "RANK_MAX", "RANK_CEILING", "LARGE_M",
           "large_m", "check_cuda_operands", "decode_plan", "decode_rt", "decode_kp",
           "decode_out_smem", "large_smem", "sm_count", "priced"]

# The largest rank K1, K2-K4, K5 and K7 take (kRMax in csrc/common.cuh):
# K1 and K5 walk a rank past 512 in pieces (decode design) or passes with t
# streamed through the ring (large-M design), K2 streams dt, K7 requantizes
# in pieces of 512.  4096 covers every shipped config's Eq.-5 rank
# (qwen2-72b's FFN, 3207, the largest).  RANK_CEILING is what a refusal
# names.
RANK_MAX = 4096
RANK_CEILING = "ROADMAP queue 1 item 13, the kernels' rank ranges"
# The M from which K1 takes the large-M design, from the H100's timings of
# both designs (chip_smoke.py's designs phase, PERF.md section 6).  The
# decode design's time grows with each 128-row block and the large-M
# design's does not, and where they cross depends on the factors' shape: no
# one M serves every geometry, nor one M a rank (at r = 256 and 349 the
# C = 960, S = 2560 factors cross near 256 rows, the C = 2560, S = 960 ones
# near 320).  So a small table, read in order (large_m): C >= 2048 from
# LARGE_M_WIDE_C rows, r <= 128 from LARGE_M_LOW_RANK, else from LARGE_M.
LARGE_M = 256
LARGE_M_WIDE_C = 320
LARGE_M_LOW_RANK = 288
_INT32_MAX = 2 ** 31 - 1
# the decode design's limits (csrc/common.cuh): the largest cluster
# (kDClusterMax), rows of C in a CTA's piece (kDKcMax), the widest tile of r
# in phase 1 (kDW1Max) and of S in phase 2 (kDW2Max), the most rank rows a
# phase-2 piece holds (kDKpMax)
CLUSTER_MAX, KC_MAX, W1_MAX, W2_MAX, KP_MAX = 8, 512, 64, 64, 512
SMEM_MAX = 232448  # kSmemMax: the most shared memory a block may use


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_plan(c: int, r: int, s: int, sms: int, nb: int = 1) -> tuple:
    """``(cs, kc, per, w1, w2)`` of the decode design on ``sms`` SMs, for
    ``nb`` branches of rank at most ``r`` (K1 one, K5 two).  Phase 1:
    clusters of ``cs`` CTAs split C (4, or more where a CTA's piece would
    pass KC_MAX rows), each CTA ``per`` pieces of ``kc`` rows (a multiple of
    16); the rank is cut into tiles of ``w1`` columns (a multiple of 8), the
    narrowest for which every tile's cluster of every branch makes at most
    two thirds of a wave.  Phase 2: tiles of ``w2`` columns of S, 16 or the
    narrowest multiple of 8 that makes at most two CTAs an SM.  No M: the
    order in which a row's products are summed is the plan's, so a row has
    the same bits at every M."""
    cs = max(1, min(CLUSTER_MAX, _cdiv(c, 16), max(4, _cdiv(c, KC_MAX))))
    per = _cdiv(_cdiv(c, cs), KC_MAX)
    kc = _cdiv(_cdiv(c, cs * per), 16) * 16
    cs = _cdiv(c, kc * per)  # every CTA has rows of C
    w1 = 8
    while w1 < W1_MAX and cs * nb * _cdiv(r, w1) > 2 * sms // 3:
        w1 += 8
    w2 = 16
    while w2 < W2_MAX and _cdiv(s, w2) > 2 * sms:
        w2 += 8
    return cs, kc, per, w1, w2


def large_m(c: int, r: int) -> int:
    """The M from which K1 at depth ``c`` and rank ``r`` takes the large-M
    design (the table above)."""
    if c >= 2048:
        return LARGE_M_WIDE_C
    return LARGE_M_LOW_RANK if r <= 128 else LARGE_M


def decode_rt(r: int) -> int:
    """Row pitch of the decode design's t scratch (csrc launch_decode): the
    rank r (the larger branch's for K5) rounded up to 8."""
    return _cdiv(r, 8) * 8


def decode_kp(r: int) -> int:
    """Rank rows of one piece of the decode design's phase 2 (csrc
    decode_kp): the rank rounded up to 16 when that is at most KP_MAX, else
    the fewest equal pieces of at most KP_MAX rows, rounded up to 16.  A
    function of r alone, so a row's sum runs in one order at every M."""
    kext = _cdiv(r, 16) * 16
    return _cdiv(_cdiv(kext, _cdiv(kext, KP_MAX)), 16) * 16


def _tile_ld(w: int) -> int:
    return w + 16 if (w // 8) % 2 else w + 8


def _align128(n: int) -> int:
    return _cdiv(n, 128) * 128


def decode_out_smem(rows: int, r: int, w2: int, nb: int = 1) -> int:
    """Shared-memory bytes of the decode design's phase 2 at ``rows`` rows a
    CTA, tiles of ``w2`` columns and rank ``r`` (csrc out_smem): V and t of
    one piece, and the float32 sums carried between pieces when there are
    several."""
    kext, kp = _cdiv(r, 16) * 16, decode_kp(r)
    end = _align128(2 * nb * kp * _tile_ld(w2)) + 2 * nb * rows * _tile_ld(kp)
    return _align128(end) + 4 * nb * rows * w2 if kp < kext else end


def large_smem(r: int, nb: int = 1) -> tuple:
    """``(bytes, ring slots, t streamed)`` of the large-M design's shared
    memory at rank ``r`` (the larger branch's) for ``nb`` branches (csrc
    large_layout): t of the row block resident up to a padded rank of 512,
    else streamed through the ring beside each V tile."""
    kc2 = 128 // nb
    rp = _cdiv(r, kc2) * kc2
    stream = rp > 512
    ring_off = (0 if stream else nb * 64 * rp * 2) + 2 * 64 * 64 * 2
    bars = (2 * 8 + 2) * 8
    vbytes, tbytes = 2 * kc2 * 128, (kc2 // 64) * 64 * 128
    slot = max(64 * 128 + 2 * 64 * 128, nb * (vbytes + (tbytes if stream else 0)))
    slots = min((SMEM_MAX - 1024 - ring_off - bars) // slot, 8)
    return 1024 + ring_off + slots * slot + bars, slots, stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_cuda_operands(op: str, tensors: Sequence[torch.Tensor]) -> None:
    """Raise unless every operand is a contiguous bf16 tensor on the current
    CUDA device (or all on the meta device).  An operand that requires grad
    is refused under grad mode: the kernel's result would carry no gradient
    (the autograd Functions in ``ops`` call the wrappers with grad mode
    off)."""
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
    if dev.type != "meta" and dev.index != torch.cuda.current_device():
        raise ValueError(f"{op}: operands on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def priced(wrapper, key: tuple, shape: tuple, like: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The meta device's stand-in for one launch of ``wrapper`` at ``key``:
    count it in ``wrapper.priced_by_shape`` and return an empty (meta)
    result of ``shape`` in ``dtype`` (default ``like``'s).  An empty
    result launches nothing on CUDA, so it is not priced either."""
    if all(shape):
        wrapper.priced_by_shape[key] += 1
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


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


def lowrank_matmul(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                   large: Optional[bool] = None, plan: Optional[tuple] = None) -> torch.Tensor:
    """x (M, C) @ u (C, r) @ v (r, S) -> (M, S) in x's dtype.  ``large``
    picks the design (default: from ``large_m``) and ``plan`` the decode
    design's plan (default: ``decode_plan``); the autotuner's choices come
    in through them."""
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
        raise ValueError(f"lowrank_matmul: rank {r} outside [1, {RANK_MAX}] ({RANK_CEILING})")
    check_cuda_operands("lowrank_matmul", (x, u, v))
    if x.device.type == "meta":
        return priced(lowrank_matmul, (m, c, r, s), (m, s), x)
    return _launch(x, u, v, large=m >= large_m(c, r) if large is None else large, plan=plan)


def _launch(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *, large: bool,
            plan: tuple | None = None) -> torch.Tensor:
    """Launch one design on checked CUDA operands (``chip_smoke.py`` times
    both designs through it on either side of LARGE_M, and the decode
    design under other plans)."""
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
        t = torch.empty(m * decode_rt(r), dtype=x.dtype, device=x.device)
        fn = lib.repro_lowrank_matmul
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        code = fn(x.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr(), t.data_ptr(),
                  m, c, r, s, *(plan or decode_plan(c, r, s, sm_count(x.device.index))), stream)
    raise_on_error("lowrank_matmul", lib, code)
    lowrank_matmul.launches += 1
    lowrank_matmul.launches_by_shape[(m, c, r, s)] += 1
    return y


lowrank_matmul.launches = 0
lowrank_matmul.launches_by_shape = Counter()
lowrank_matmul.priced_by_shape = Counter()
