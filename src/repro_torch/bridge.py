"""numpy <-> torch conversion of param trees, batches and paged caches.

The parity tests make weights once (in JAX), turn them into numpy, and hand
the same numbers to both packages through this module; the two packages
never initialise weights for a comparison on their own.  Trees are nested
dicts of arrays; lists, tuples and ``NamedTuple``s (an optimizer or train
state) keep their type, and ``None`` holes stay holes.  bfloat16 numpy arrays (the
``ml_dtypes`` type JAX hands out) are reinterpreted bit for bit;
:func:`to_numpy` returns bfloat16 tensors as float32, which is exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["from_numpy", "to_numpy", "params_from_jax", "params_to_numpy",
           "batch_from_numpy", "cache_from_jax", "cache_to_numpy",
           "train_state_from_jax", "train_state_to_numpy"]


def _leaf_to_torch(a: Any, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, copy=True).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def _rebuild(tree, items):
    """A list, tuple or NamedTuple of ``tree``'s type holding ``items``."""
    if hasattr(tree, "_fields"):  # NamedTuple: fields are positional arguments
        return type(tree)(*items)
    return type(tree)(items)


def from_numpy(tree: Any, device="cpu") -> Any:
    """Tree of arrays (numpy, or anything ``np.asarray`` takes) -> tensors."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [from_numpy(v, device) for v in tree])
    if tree is None:
        return None
    return _leaf_to_torch(tree, device)


def to_numpy(tree: Any) -> Any:
    """Tree of tensors -> numpy arrays on the host (bfloat16 -> float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [to_numpy(v) for v in tree])
    if tree is None:
        return None
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def train_state_from_jax(state: Any, parked: Any, device="cpu"):
    """A JAX ``(TrainState, parked)`` pair (``launch.steps.make_train_state``;
    numpy or JAX leaves) -> the port's ``(TrainState, parked)``: the live
    state on ``device``, the parked moments on the CPU."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.optimizers import OptState

    trainable, frozen, opt = state
    step, mu, nu = opt
    live = TrainState(from_numpy(trainable, device), from_numpy(frozen, device),
                      OptState(from_numpy(step, device), from_numpy(mu, device),
                               from_numpy(nu, device)))
    return live, tuple(from_numpy(t, "cpu") for t in parked)


def train_state_to_numpy(state: Any, parked: Any):
    """The port's ``(TrainState, parked)`` -> the same pair with numpy
    leaves (bfloat16 -> float32)."""
    return to_numpy(state), tuple(to_numpy(t) for t in parked)


params_from_jax = from_numpy
params_to_numpy = to_numpy
batch_from_numpy = from_numpy
cache_from_jax = from_numpy
cache_to_numpy = to_numpy
