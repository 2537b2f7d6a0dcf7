"""numpy <-> torch conversion of param trees, batches and paged caches.

The parity tests make weights once (in JAX), turn them into numpy, and hand
the same numbers to both packages through this module; the two packages
never initialise weights for a comparison on their own.  Trees are nested
dicts (lists/tuples are kept) of arrays.  bfloat16 numpy arrays (the
``ml_dtypes`` type JAX hands out) are reinterpreted bit for bit;
:func:`to_numpy` returns bfloat16 tensors as float32, which is exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["from_numpy", "to_numpy", "params_from_jax", "params_to_numpy",
           "batch_from_numpy", "cache_from_jax", "cache_to_numpy"]


def _leaf_to_torch(a: Any, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, copy=True).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def from_numpy(tree: Any, device="cpu") -> Any:
    """Tree of arrays (numpy, or anything ``np.asarray`` takes) -> tensors."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    return _leaf_to_torch(tree, device)


def to_numpy(tree: Any) -> Any:
    """Tree of tensors -> numpy arrays on the host (bfloat16 -> float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if tree is None:
        return None
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


params_from_jax = from_numpy
params_to_numpy = to_numpy
batch_from_numpy = from_numpy
cache_from_jax = from_numpy
cache_to_numpy = to_numpy
