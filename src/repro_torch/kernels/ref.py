"""Plain PyTorch versions of the hand-written kernels.

They keep the JAX oracles' rounding points (``repro/kernels/ref.py``): both
products accumulate in float32, and the rank-r intermediate ``t`` is
rounded to x's dtype before the second product.  The operands are widened
to float32 explicitly, so the result does not depend on the backend's
reduced-precision settings.  The CPU path of the dispatcher runs these, and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["lowrank_matmul_ref", "lowrank_gated_ffn_ref"]


def lowrank_matmul_ref(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = (x @ U) @ V with float32 accumulation — the decomposed linear."""
    t = torch.matmul(x.float(), u.float()).to(x.dtype)
    return torch.matmul(t.float(), v.float()).to(x.dtype)


def lowrank_gated_ffn_ref(x: torch.Tensor, gu: torch.Tensor, gv: torch.Tensor,
                          uu: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """silu((x Ug) Vg) * ((x Uu) Vu) — the low-rank SwiGLU first half.

    Each branch is rounded to x's dtype before the float32 epilogue, as the
    unfused model path does (the fused kernel keeps both in float32)."""
    g = lowrank_matmul_ref(x, gu, gv)
    up = lowrank_matmul_ref(x, uu, uv)
    return (F.silu(g.float()) * up.float()).to(x.dtype)
