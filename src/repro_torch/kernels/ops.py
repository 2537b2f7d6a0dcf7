"""Dispatch between the hand-written kernels and their plain versions.

``lowrank_apply`` and ``lowrank_ffn_apply`` are the entry points every
factorised projection of the models goes through (the counterparts of
``repro/kernels/ops.py``).  They reshape ``(..., C)`` to ``(M, C)`` and:

* take the plain version (``kernels/ref.py``) when the tensors lie on the
  CPU (reason ``platform``) or the policy is off (reason ``disabled``);
* otherwise launch the CUDA kernel, which raises on anything it does not
  take.  There is no shape-based fallback: the kernels take any M, C, r, S.

Every plain-version decision is recorded as a :class:`Fallback`;
:func:`capture_fallbacks` collects them while open, so a caller can show
which path a run took.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import List, Tuple, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
from repro_torch.kernels.lowrank_matmul import lowrank_matmul

__all__ = ["KernelPolicy", "as_policy", "lowrank_apply", "lowrank_ffn_apply",
           "Fallback", "capture_fallbacks"]

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
    ``int8_decode`` is carried for the int8-export serving slice (K6/K7),
    which this slice does not run.
    """

    use_kernel: bool = False
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


def lowrank_apply(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                  use_kernel: bool = False) -> torch.Tensor:
    """y = (x @ u) @ v for x (..., C)."""
    c = u.shape[0]
    s = v.shape[1]
    lead = x.shape[:-1]
    m = math.prod(lead)
    x2 = x.reshape(m, c)
    reason = _plain_reason(x, use_kernel)
    if reason is None:
        y = lowrank_matmul(x2.contiguous(), u, v)
    else:
        _note_fallback("lowrank_fwd", reason, (m, c, s))
        y = ref.lowrank_matmul_ref(x2, u, v)
    return y.reshape(*lead, s)


def lowrank_ffn_apply(x: torch.Tensor, gu: torch.Tensor, gv: torch.Tensor,
                      uu: torch.Tensor, uv: torch.Tensor, *,
                      use_kernel: bool = False) -> torch.Tensor:
    """silu((x gu) gv) * ((x uu) uv) for x (..., C)."""
    c = gu.shape[0]
    f = gv.shape[1]
    lead = x.shape[:-1]
    m = math.prod(lead)
    x2 = x.reshape(m, c)
    reason = _plain_reason(x, use_kernel)
    if reason is None:
        y = lowrank_gated_ffn(x2.contiguous(), gu, gv, uu, uv)
    else:
        _note_fallback("lowrank_ffn", reason, (m, c, f))
        y = ref.lowrank_gated_ffn_ref(x2, gu, gv, uu, uv)
    return y.reshape(*lead, f)
