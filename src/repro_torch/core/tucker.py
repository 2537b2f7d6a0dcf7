"""Tucker-2 decomposition of k x k convolution kernels (paper Eq. 4), as in
``repro/core/tucker.py``.

A conv weight ``W in R^{C x S x k x k}`` (in-channels, out-channels, spatial)
is decomposed into three convolutions:

    1x1 conv  U^T : C  -> r1          (first factor, frozen group 0)
    kxk conv  core: r1 -> r2          (core tensor,   trainable group)
    1x1 conv  V   : r2 -> S           (last factor,   frozen group 0)

computed via HOSVD: U = leading eigenvectors of the mode-0 unfolding's Gram
matrix, V = those of the mode-1 unfolding's, core = W x0 U^T x1 V^T, all in
float32.  Eigenvectors are unique only up to sign (and ``torch.linalg.eigh``
may pick other signs than JAX's), so compare reconstructions
``first . core . last``, not the factors one by one.

Rank formulas follow paper Eqs. 5-6 with ``r2 = beta * r1``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "tucker_rank_for_compression",
    "tucker_min_rank",
    "tucker_compression_ratio",
    "tucker2_decompose",
    "tucker_reconstruction_error",
]


def tucker_rank_for_compression(
    c: int, s: int, k: int, alpha: float, *, beta: float = 1.0
) -> Tuple[int, int]:
    """Paper Eq. 5: (r1, r2) achieving compression ratio ``alpha``.

    Solves  beta*k^2*r1^2 + (C + beta*S)*r1 - C*S*k^2/alpha = 0  for r1 >= 0.
    """
    if alpha <= 0:
        raise ValueError(f"compression ratio must be positive, got {alpha}")
    a = (c + beta * s) / (beta * k * k)
    r1 = (-a + np.sqrt(a * a + 4.0 * c * s / (beta * alpha))) / 2.0
    r1 = int(np.floor(r1))
    r1 = max(1, min(r1, c))
    r2 = max(1, min(int(np.floor(beta * r1)), s))
    return r1, r2


def tucker_min_rank(
    c: int, s: int, k: int, alpha: float, *, beta: float = 1.0
) -> Tuple[int, int]:
    """Paper Eq. 6: R_min = rank at the next integer compression ratio."""
    return tucker_rank_for_compression(c, s, k, alpha + 1.0, beta=beta)


def tucker_compression_ratio(c: int, s: int, k: int, r1: int, r2: int) -> float:
    """Actual compression ratio of the Tucker-2 triple vs. the original conv."""
    original = c * s * k * k
    decomposed = c * r1 + r1 * r2 * k * k + r2 * s
    return original / decomposed


def _leading_eigvecs(unfolding: torch.Tensor, rank: int) -> torch.Tensor:
    # Eigenvectors of the Gram matrix == left singular vectors of the unfolding.
    gram = unfolding @ unfolding.T
    _, vecs = torch.linalg.eigh(gram)  # ascending order
    return vecs.flip(-1)[:, :rank]


def tucker2_decompose(
    w: torch.Tensor, r1: int, r2: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """HOSVD Tucker-2 of ``W (C, S, k, k)`` -> (first, core, last).

    Returns, in ``w``'s dtype and on its device,
      first: (C, r1)        use as 1x1 conv C->r1 (i.e. x @ first)
      core:  (r1, r2, k, k) use as kxk conv r1->r2
      last:  (r2, S)        use as 1x1 conv r2->S
    """
    if w.dim() != 4:
        raise ValueError(f"tucker2_decompose expects (C,S,k,k), got {tuple(w.shape)}")
    c, s, kh, kw = w.shape
    wf = w.float()
    mode0 = wf.reshape(c, s * kh * kw)  # unfold along input channels
    mode1 = wf.movedim(1, 0).reshape(s, c * kh * kw)  # along output channels
    u = _leading_eigvecs(mode0, r1)  # (C, r1)
    v = _leading_eigvecs(mode1, r2)  # (S, r2)
    core = torch.einsum("cskl,cp,sq->pqkl", wf, u, v)  # (r1, r2, k, k)
    return (u.contiguous().to(w.dtype), core.contiguous().to(w.dtype),
            v.T.contiguous().to(w.dtype))


def tucker_reconstruction_error(
    w: torch.Tensor, first: torch.Tensor, core: torch.Tensor, last: torch.Tensor
) -> torch.Tensor:
    """||W - reconstruction||^2 for the Tucker-2 triple, in float32."""
    approx = torch.einsum("cp,pqkl,qs->cskl", first.float(), core.float(), last.float())
    d = w.float() - approx
    return torch.sum(d * d)
