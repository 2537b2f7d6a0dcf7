"""SVD low-rank decomposition (paper Eqs. 1-3 and 5), as in
``repro/core/svd.py``.

A dense weight ``W in R^{C x S}`` (``y = x @ W``) is factorised into
``W' = U' @ V'`` with ``U' = U sqrt(Sigma)`` and ``V' = sqrt(Sigma) V^T``
(the balanced split; ``balance`` folds Sigma into one side instead).
:func:`svd_decompose` takes ``(C, S)`` or stacked ``(L, C, S)`` weights,
one factorisation per layer at one shared rank; :func:`randomized_svd` is
the Halko-style sketch ``core.decompose.apply_lrd`` uses for large 2-D
weights.  Both run the SVD in float32 and return the input's dtype.

The rank formulas serve the init-time decomposer and Algorithm 1
(``core/rank_opt.py``); :func:`truncate_factors` serves the serve-time
export (``serving/export.py``) and in-training rank adaptation
(``core/rank_adapt.py``), whose energy policy reads
:func:`product_singular_values`.  Both reduce ``U V`` to an r x r problem
with one QR per factor, in float32, and never form the C x S product.
Stacked factors ``(..., C, r)`` / ``(..., r, S)`` are handled by
``torch.linalg``'s batching over the leading dims.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["max_rank", "svd_rank_for_compression", "svd_compression_ratio",
           "svd_decompose", "randomized_svd", "truncate_factors",
           "product_singular_values", "reconstruction_error"]


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


def _split_factors(u: torch.Tensor, sigma: torch.Tensor, vt: torch.Tensor, balance: str):
    """``(U, Sigma, V^T)`` (any leading stack dims) -> the factor pair, each
    contiguous (cuSOLVER hands U back column-major, and the kernels take
    row-major operands)."""
    if balance == "balanced":
        root = torch.sqrt(sigma)
        u, vt = u * root[..., None, :], root[..., :, None] * vt
    elif balance == "left":  # W = (U Sigma) @ V^T
        u = u * sigma[..., None, :]
    elif balance == "right":  # W = U @ (Sigma V^T)
        vt = sigma[..., :, None] * vt
    else:
        raise ValueError(f"unknown balance mode {balance!r}")
    return u.contiguous(), vt.contiguous()


def svd_decompose(w: torch.Tensor, rank: int, *,
                  balance: str = "balanced") -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncated-SVD factorisation ``W ~= U @ V`` (paper Eq. 2).

    Accepts ``(C, S)`` or stacked ``(L, C, S)`` weights; returns factors with
    the input dtype (the SVD itself runs in float32).  Singular vectors are
    unique up to sign: another LAPACK or cuSOLVER may flip a column of U
    together with the row of V it pairs with, which leaves ``U @ V`` as is.
    """
    if w.dim() not in (2, 3):
        raise ValueError(f"svd_decompose expects 2-D or 3-D weights, got {tuple(w.shape)}")
    u, s, vt = torch.linalg.svd(w.float(), full_matrices=False)
    uf, vf = _split_factors(u[..., :rank], s[..., :rank], vt[..., :rank, :], balance)
    return uf.to(w.dtype), vf.to(w.dtype)


def _sketch(s: int, k: int, seed: int, device) -> torch.Tensor:
    """The Gaussian test matrix ``omega`` (S, k) of :func:`randomized_svd`,
    drawn on the CPU from ``seed`` and moved to ``device``, so every device
    sketches with the same matrix."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((s, k), generator=gen, dtype=torch.float32).to(device)


def randomized_svd(w: torch.Tensor, rank: int, *, oversample: int = 16, n_iter: int = 2,
                   seed: int = 0,
                   balance: str = "balanced") -> Tuple[torch.Tensor, torch.Tensor]:
    """Halko-style randomized truncated SVD of a 2-D weight.

    Cost O(C*S*(r+p)) instead of O(C*S*min(C,S)): the decomposition of a
    large projection matrix, where an exact SVD would dominate the
    decomposition time (paper Table 2).
    """
    c, s = w.shape
    k = min(rank + oversample, min(c, s))
    wf = w.float()
    y = wf @ _sketch(s, k, seed, wf.device)
    for _ in range(n_iter):  # power iterations sharpen the spectrum estimate
        y = wf @ (wf.T @ y)
    q, _ = torch.linalg.qr(y)
    ub, sb, vtb = torch.linalg.svd(q.T @ wf, full_matrices=False)  # (k, S)
    uf, vf = _split_factors(q @ ub[:, :rank], sb[:rank], vtb[:rank, :], balance)
    return uf.to(w.dtype), vf.to(w.dtype)


def _core(u: torch.Tensor, v: torch.Tensor):
    """``U V = Q_u (R_u R_vᵀ) Q_vᵀ`` in float32: (Q_u, R_u R_vᵀ, Q_v)."""
    qu, ru = torch.linalg.qr(u.float())  # (.., C, r) (.., r, r)
    qv, rv = torch.linalg.qr(v.float().transpose(-1, -2))  # (.., S, r) (.., r, r)
    return qu, ru @ rv.transpose(-1, -2), qv


def truncate_factors(u: torch.Tensor, v: torch.Tensor, rank: int, *,
                     balance: str = "balanced") -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimal rank-``rank`` re-truncation of an existing factor pair.

    Fine-tuned factors are no longer in SVD form, so serve-time rank
    quantization cannot simply drop trailing columns.  QR on each factor
    reduces the problem to an r x r SVD, giving the Eckart-Young-optimal
    rank-``rank`` approximation of the product in O(r²(C+S) + r³), split
    as ``balance`` says.  Accepts stacked (..., C, r) / (..., r, S)
    factors; returns fresh tensors in the factors' dtypes.
    """
    if rank >= u.shape[-1]:
        return u, v
    if u.dim() < 2:
        raise ValueError(f"truncate_factors expects >= 2-D factors, got {tuple(u.shape)}")
    qu, core, qv = _core(u, v)
    um, sm, vtm = torch.linalg.svd(core, full_matrices=False)
    u2, v2 = _split_factors(qu @ um[..., :, :rank], sm[..., :rank],
                            vtm[..., :rank, :] @ qv.transpose(-1, -2), balance)
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


def reconstruction_error(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Squared Frobenius reconstruction error ``||W - U V||^2`` (paper Eq. 3),
    in float32."""
    d = w.float() - u.float() @ v.float()
    return torch.sum(d * d)
