"""SVD rank arithmetic (paper Eqs. 1 and 5), as in ``repro/core/svd.py``.

Only the rank formulas the init-time decomposer needs are here; the SVD
routines themselves come with the training slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["max_rank", "svd_rank_for_compression"]


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
