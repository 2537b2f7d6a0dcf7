"""SVD rank arithmetic and factor truncation (paper Eqs. 1 and 5), as in
``repro/core/svd.py``.

The rank formulas serve the init-time decomposer and Algorithm 1
(``core/rank_opt.py``); :func:`truncate_factors` serves the serve-time
export (``serving/export.py``), and :func:`product_singular_values` is the
spectrum that rank adaptation reads (JAX's ``core/rank_adapt.py``; ROADMAP
queue 1 item 4).  Both reduce ``U V`` to an r x r problem with one
QR per factor, in float32, and never form the C x S product.  Stacked
factors ``(..., C, r)`` / ``(..., r, S)`` are handled by
``torch.linalg``'s batching over the leading dims.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["max_rank", "svd_rank_for_compression", "svd_compression_ratio",
           "truncate_factors", "product_singular_values"]


def max_rank(c: int, s: int) -> int:
    """Full rank R = min(C, S) of a C x S matrix (paper Eq. 1)."""
    return min(c, s)


def svd_rank_for_compression(c: int, s: int, alpha: float) -> int:
    """Rank r such that the factorized layer has ~``1/alpha`` the parameters.

    Params before: C*S. After: r*(C+S).
    """
    if alpha <= 0:
        raise ValueError(f"compression ratio must be positive, got {alpha}")
    r = int(np.floor(c * s / (alpha * (c + s))))
    return max(1, min(r, max_rank(c, s)))


def svd_compression_ratio(c: int, s: int, r: int) -> float:
    """Actual compression ratio alpha achieved by rank ``r``."""
    return (c * s) / (r * (c + s))


def _core(u: torch.Tensor, v: torch.Tensor):
    """``U V = Q_u (R_u R_vᵀ) Q_vᵀ`` in float32: (Q_u, R_u R_vᵀ, Q_v)."""
    qu, ru = torch.linalg.qr(u.float())  # (.., C, r) (.., r, r)
    qv, rv = torch.linalg.qr(v.float().transpose(-1, -2))  # (.., S, r) (.., r, r)
    return qu, ru @ rv.transpose(-1, -2), qv


def truncate_factors(u: torch.Tensor, v: torch.Tensor,
                     rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimal rank-``rank`` re-truncation of an existing factor pair.

    Fine-tuned factors are no longer in SVD form, so serve-time rank
    quantization cannot simply drop trailing columns.  QR on each factor
    reduces the problem to an r x r SVD, giving the Eckart-Young-optimal
    rank-``rank`` approximation of the product in O(r²(C+S) + r³), split
    balanced (``U' = U sqrt(Σ)``, ``V' = sqrt(Σ) Vᵀ``, JAX's default).
    Accepts stacked (..., C, r) / (..., r, S) factors; returns the factors'
    dtypes.
    """
    if rank >= u.shape[-1]:
        return u, v
    if u.dim() < 2:
        raise ValueError(f"truncate_factors expects >= 2-D factors, got {tuple(u.shape)}")
    qu, core, qv = _core(u, v)
    um, sm, vtm = torch.linalg.svd(core, full_matrices=False)
    root = torch.sqrt(sm[..., :rank])
    u2 = (qu @ um[..., :, :rank]) * root[..., None, :]
    v2 = root[..., :, None] * (vtm[..., :rank, :] @ qv.transpose(-1, -2))
    return u2.to(u.dtype), v2.to(v.dtype)


def product_singular_values(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Singular values of ``U @ V`` through the same QR reduction as
    :func:`truncate_factors`, never forming ``U V``.  Stacked factors give
    per-stack spectra ``(..., r)``, float32."""
    if u.dim() < 2:
        raise ValueError(
            f"product_singular_values expects >= 2-D factors, got {tuple(u.shape)}")
    _, core, _ = _core(u, v)
    return torch.linalg.svdvals(core)
