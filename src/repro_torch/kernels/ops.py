"""Dispatch between the hand-written kernels and their plain versions.

``lowrank_apply`` and ``lowrank_ffn_apply`` are the entry points every
factorised projection of the models goes through (the counterparts of
``repro/kernels/ops.py``).  They reshape ``(..., C)`` to ``(M, C)`` and run
one ``torch.autograd.Function`` each, whose forward is K1 or K5 and whose
backward mirrors the JAX custom VJPs ``_lr_bwd`` / ``_ffn_bwd``: K2 for dx,
K3 for dU, K4 for dV (the FFN backward recomputes both branches with K1
first).  Every call, forward or backward, dispatches on its own:

* the plain version (``kernels/ref.py``) when the tensors lie on the CPU
  (reason ``platform``) or the policy is off (reason ``disabled``);
* otherwise the CUDA kernel, which raises on anything it does not take.
  There is no shape-based fallback: the kernels take any M, C, r, S.

Sequential freezing (Algorithm 2): ``freeze_group`` names the factor group
frozen this phase (0 = u, 1 = v).  The frozen factor's gradient is never
computed — its kernel is not launched and its plain version not run — and
the same holds for any factor autograd does not ask a gradient of.

:func:`flash_attention_apply` is the prefill attention core of
``attention_impl="flash"`` (the counterpart of ``_flash_path`` in
``repro/models/attention.py``): K8 on CUDA tensors, its plain version on
CPU tensors (reason ``platform``).  Like ``_flash_path`` it does not read
the policy: the model config alone selects it.  It is forward only.

int8-exported groups (``serving/export.py``) go through
:func:`int8_apply` (K6) and :func:`int8_lowrank_apply` (K7), whose
kernels take x itself and quantize it per row inside (the serving entries
``int8_linear`` / ``int8_lowrank_linear``; the JAX dispatchers quantize
with jnp ops outside their kernels, to the same bits):

* kernel requested, CUDA tensors: the kernel, one launch for K6 and two
  for K7, no torch op around them.  There is no shape fallback and no
  mesh branch;
* kernel requested, CPU tensors (reason ``platform``): the kernel's plain
  version (``quantize_rowwise``, the exact int8 product and the scales),
  i.e. the activation-quantized algebra, which is what JAX computes in
  interpret mode.  This is the one place where the port's CPU path
  differs from JAX's un-interpreted CPU path (the weight-only formula
  below);
* policy off (reason ``disabled``, any device): JAX's own policy-off
  formula, the weight-only ``x @ (w_q.float() * w_scale)``.

Every plain-version decision is recorded as a :class:`Fallback` (``op``
``lowrank_fwd``, ``lowrank_ffn``, ``lowrank_dx``, ``lowrank_du``,
``lowrank_dv``, ``int8_dense``, ``int8_lowrank`` or ``flash_attention``);
:func:`capture_fallbacks` collects them while open, so a caller can show
which path a run took.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import List, Optional, Tuple, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.int8_matmul import int8_linear, int8_lowrank_linear
from repro_torch.kernels.lowrank_bwd import (lowrank_matmul_du, lowrank_matmul_dv,
                                             lowrank_matmul_dx)
from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
from repro_torch.kernels.lowrank_matmul import lowrank_matmul

__all__ = ["KernelPolicy", "as_policy", "lowrank_apply", "lowrank_ffn_apply",
           "int8_apply", "int8_lowrank_apply", "flash_attention_apply", "Fallback",
           "capture_fallbacks"]

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Fallback:
    """One dispatcher decision to run the plain version instead of the kernel."""

    op: str
    reason: str  # "platform" (CPU tensors) | "disabled" (policy off)
    shape: Tuple[int, ...] = ()


_FALLBACK_SINKS: List[List[Fallback]] = []


@contextlib.contextmanager
def capture_fallbacks():
    """Collect every dispatcher fallback taken while open (nestable)."""
    sink: List[Fallback] = []
    _FALLBACK_SINKS.append(sink)
    try:
        yield sink
    finally:
        _FALLBACK_SINKS.remove(sink)


def _note_fallback(op: str, reason: str, shape: Tuple[int, ...]) -> None:
    fb = Fallback(op, reason, tuple(int(d) for d in shape))
    for sink in _FALLBACK_SINKS:
        sink.append(fb)
    _log.debug("plain path: op=%s reason=%s shape=%s", op, reason, fb.shape)


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Kernel dispatch choices, threaded through every model function.

    ``use_kernel`` turns the CUDA kernels on for CUDA tensors.
    ``freeze_group`` is the factor group frozen this phase (0 = u, 1 = v,
    None = nothing; ``core.freezing.frozen_group_for_phase``): its gradient
    kernel is not launched.  ``int8_decode`` is how int8-exported groups
    are consumed: ``"native"`` (K6/K7 through :func:`int8_apply` /
    :func:`int8_lowrank_apply`) or ``"bf16"`` (dequantize every weight and
    run bf16 products, the serving baseline; ``models.common``).
    """

    use_kernel: bool = False
    freeze_group: Optional[int] = None
    int8_decode: str = "native"

    def __bool__(self) -> bool:
        return self.use_kernel


def as_policy(policy: Union[bool, KernelPolicy, None]) -> KernelPolicy:
    """Normalise a bool or policy argument."""
    if isinstance(policy, KernelPolicy):
        return policy
    return KernelPolicy(use_kernel=bool(policy))


def _plain_reason(x: torch.Tensor, use_kernel: bool):
    if not use_kernel:
        return "disabled"
    if x.device.type == "cpu":
        return "platform"
    return None


def _dispatch(op: str, kernel, plain, use_kernel: bool, shape, *args, **kw):
    """``kernel(*args)`` for CUDA tensors with the policy on, else
    ``plain(*args)``, recorded as a fallback of ``op`` at ``shape``."""
    reason = _plain_reason(args[0], use_kernel)
    if reason is None:
        return kernel(*args, **kw)
    _note_fallback(op, reason, shape)
    return plain(*args, **kw)


def _fwd(x, u, v, use_kernel: bool) -> torch.Tensor:
    return _dispatch("lowrank_fwd", lowrank_matmul, ref.lowrank_matmul_ref, use_kernel,
                     (x.shape[0], u.shape[0], v.shape[1]), x, u, v)


def _dx(dy, u, v, use_kernel: bool) -> torch.Tensor:
    return _dispatch("lowrank_dx", lowrank_matmul_dx, ref.lowrank_matmul_dx_ref, use_kernel,
                     (dy.shape[0], u.shape[0], v.shape[1]), dy, u, v)


def _du(x, dy, v, out_dtype, use_kernel: bool) -> torch.Tensor:
    return _dispatch("lowrank_du", lowrank_matmul_du, ref.lowrank_matmul_du_ref, use_kernel,
                     (x.shape[0], x.shape[1], v.shape[1]), x, dy, v, out_dtype=out_dtype)


def _dv(x, u, dy, out_dtype, use_kernel: bool) -> torch.Tensor:
    return _dispatch("lowrank_dv", lowrank_matmul_dv, ref.lowrank_matmul_dv_ref, use_kernel,
                     (x.shape[0], x.shape[1], dy.shape[1]), x, u, dy, out_dtype=out_dtype)


class _LowrankMatmul(torch.autograd.Function):
    """y = (x u) v on (M, C) x; backward = ``_lr_bwd`` (K2, K3, K4)."""

    @staticmethod
    def forward(ctx, x, u, v, use_kernel: bool, freeze_group: Optional[int]):
        ctx.use_kernel, ctx.freeze_group = use_kernel, freeze_group
        ctx.save_for_backward(x, u, v)
        return _fwd(x.contiguous(), u, v, use_kernel)

    @staticmethod
    def backward(ctx, dy):
        x, u, v = ctx.saved_tensors
        use, fg = ctx.use_kernel, ctx.freeze_group
        x, dy = x.contiguous(), dy.contiguous()
        dx = _dx(dy, u, v, use) if ctx.needs_input_grad[0] else None
        du = (_du(x, dy, v, u.dtype, use)
              if ctx.needs_input_grad[1] and fg != 0 else None)
        dv = (_dv(x, u, dy, v.dtype, use)
              if ctx.needs_input_grad[2] and fg != 1 else None)
        return dx, du, dv, None, None


class _LowrankGatedFFN(torch.autograd.Function):
    """silu((x gu) gv) * ((x uu) uv) on (M, C) x; backward = ``_ffn_bwd``:
    both branches recomputed (K1), the SiLU-derivative epilogue in float32,
    then K2 and K3/K4 per branch."""

    @staticmethod
    def forward(ctx, x, gu, gv, uu, uv, use_kernel: bool, freeze_group: Optional[int]):
        ctx.use_kernel, ctx.freeze_group = use_kernel, freeze_group
        ctx.save_for_backward(x, gu, gv, uu, uv)
        return _dispatch("lowrank_ffn", lowrank_gated_ffn, ref.lowrank_gated_ffn_ref,
                         use_kernel, (x.shape[0], x.shape[1], gv.shape[1]),
                         x.contiguous(), gu, gv, uu, uv)

    @staticmethod
    def backward(ctx, dy):
        x, gu, gv, uu, uv = ctx.saved_tensors
        use, fg = ctx.use_kernel, ctx.freeze_group
        need = ctx.needs_input_grad
        x, dy = x.contiguous(), dy.contiguous()
        # recompute the branch pre-activations: cheaper in HBM bytes than
        # keeping two (M, F) tensors from the forward
        gf = _fwd(x, gu, gv, use).float()
        upf = _fwd(x, uu, uv, use).float()
        dyf = dy.float()
        sg = torch.sigmoid(gf)
        # d silu(g)/dg = sigmoid(g) * (1 + g * (1 - sigmoid(g)))
        dg = (dyf * upf * (sg * (1.0 + gf * (1.0 - sg)))).to(x.dtype)
        dup = (dyf * (gf * sg)).to(x.dtype)
        dx = _dx(dg, gu, gv, use) + _dx(dup, uu, uv, use) if need[0] else None
        dgu = _du(x, dg, gv, gu.dtype, use) if need[1] and fg != 0 else None
        dgv = _dv(x, gu, dg, gv.dtype, use) if need[2] and fg != 1 else None
        duu = _du(x, dup, uv, uu.dtype, use) if need[3] and fg != 0 else None
        duv = _dv(x, uu, dup, uv.dtype, use) if need[4] and fg != 1 else None
        return dx, dgu, dgv, duu, duv, None, None


def lowrank_apply(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                  use_kernel: bool = False,
                  freeze_group: Optional[int] = None) -> torch.Tensor:
    """y = (x @ u) @ v for x (..., C)."""
    c, s = u.shape[0], v.shape[1]
    lead = x.shape[:-1]
    y = _LowrankMatmul.apply(x.reshape(math.prod(lead), c), u, v, use_kernel,
                             freeze_group)
    return y.reshape(*lead, s)


def lowrank_ffn_apply(x: torch.Tensor, gu: torch.Tensor, gv: torch.Tensor,
                      uu: torch.Tensor, uv: torch.Tensor, *,
                      use_kernel: bool = False,
                      freeze_group: Optional[int] = None) -> torch.Tensor:
    """silu((x gu) gv) * ((x uu) uv) for x (..., C)."""
    c, f = gu.shape[0], gv.shape[1]
    lead = x.shape[:-1]
    y = _LowrankGatedFFN.apply(x.reshape(math.prod(lead), c), gu, gv, uu, uv,
                               use_kernel, freeze_group)
    return y.reshape(*lead, f)


# --------------------------------------------------------------------------
# int8 decode dispatchers (the serving export's int8 artifact)
# --------------------------------------------------------------------------

def int8_apply(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
               use_kernel: bool = False) -> torch.Tensor:
    """y = x @ dequant(w_q) for per-output-column int8 dense weights, in
    x's dtype: x (..., C), w_q (C, S) int8, w_scale (1, S) float32."""
    c, s = w_q.shape
    lead = x.shape[:-1]
    m = math.prod(lead)
    ws = w_scale.reshape(1, s).float()
    reason = _plain_reason(x, use_kernel)
    if reason == "disabled":
        _note_fallback("int8_dense", reason, (m, c, s))
        y = torch.matmul(x.reshape(m, c).float(), w_q.float() * ws)
        return y.to(x.dtype).reshape(*lead, s)
    if reason is not None:
        _note_fallback("int8_dense", reason, (m, c, s))
    y = int8_linear(x.reshape(m, c).contiguous(), w_q, ws)  # the plain version on the CPU
    return y.reshape(*lead, s)


def int8_lowrank_apply(x: torch.Tensor, u_q: torch.Tensor, u_scale: torch.Tensor,
                       v_q: torch.Tensor, v_scale: torch.Tensor, *,
                       use_kernel: bool = False) -> torch.Tensor:
    """y = (x @ dequant(u_q)) @ dequant(v_q) for int8 factor pairs, in x's
    dtype.  The kernel path quantizes x per row and requantizes the rank-r
    intermediate per row on chip; the per-row x scales factor out of that
    requantization and are applied in the kernel's epilogue."""
    c, r = u_q.shape
    s = v_q.shape[1]
    lead = x.shape[:-1]
    m = math.prod(lead)
    us = u_scale.reshape(1, r).float()
    vs = v_scale.reshape(1, s).float()
    reason = _plain_reason(x, use_kernel)
    if reason == "disabled":
        _note_fallback("int8_lowrank", reason, (m, c, s))
        t = torch.matmul(x.reshape(m, c).float(), u_q.float() * us)
        y = torch.matmul(t, v_q.float() * vs)
        return y.to(x.dtype).reshape(*lead, s)
    if reason is not None:
        _note_fallback("int8_lowrank", reason, (m, c, s))
    y = int8_lowrank_linear(x.reshape(m, c).contiguous(), u_q, us.contiguous(), v_q,
                            vs.contiguous())  # the plain version on the CPU
    return y.reshape(*lead, s)


# --------------------------------------------------------------------------
# Flash attention (prefill, attention_impl="flash")
# --------------------------------------------------------------------------

def flash_attention_apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool, q_scale: float = 1.0) -> torch.Tensor:
    """Flash attention of q (B, Sq, H, D) against k/v (B, Sk, KV, D): K8 for
    CUDA tensors (or an error), its plain version for CPU tensors.  Forward
    only: raises under grad mode if an input requires grad."""
    out = flash_attention(q, k, v, causal=causal, q_scale=q_scale)
    if q.device.type == "cpu":
        _note_fallback("flash_attention", "platform", (q.shape[0], q.shape[1], k.shape[1],
                                                       q.shape[2], k.shape[2], q.shape[3]))
    return out
