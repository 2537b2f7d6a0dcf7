"""int8 gradient sync for data parallelism — the counterpart of
``repro/distributed/compression.py``.

``value_and_grad_compressed`` computes the loss and grads with ONE
data-parallel axis *manual* (``pod`` when the mesh has one, else ``data``):
each rank differentiates the mean loss of its own batch rows, with that
axis left out of every collective inside (``sharding.axis_rules(manual=)``;
the kernel dispatch leaves it out of its mapping, and with no other axis to
map it runs the plain versions, as the reference's dispatch takes its jnp
path there), and the grads are then averaged over the axis explicitly in
**int8** with per-tensor scales (:func:`_quantize_pmean`: the wire carries
int8, 4x fewer bytes than float32, 2x fewer than bf16).

``params`` is the TRAINABLE partition of the train state, so the int8 sync
covers exactly the trainable leaves: a frozen factor is differentiated,
quantized and synced never.  Each rank quantizes to ``[-127 // n, 127 //
n]``, so the int8 sum over ``n`` ranks cannot wrap.

Compression runs when the manual axis is ``pod``, or is the mesh's only
axis of size > 1 (pure data parallelism).  On a mesh with a ``model`` axis
> 1 and no pod axis it warns once, with the reference's text, and the sync
stays uncompressed — what the reference does.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.freezing import tree_leaves, tree_map
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shmod

__all__ = ["manual_axis", "value_and_grad_compressed"]

_warned_tp_fallback = False


def _quantize_pmean(g: torch.Tensor, mesh, axis: str, n: int, *, path: str) -> torch.Tensor:
    """int8 mean of ``g`` over ``axis`` (``n`` ranks), per-tensor scales;
    float32 out, as the reference's.  int32 and 0-d leaves take a plain
    mean."""
    if g.dtype == torch.int32 or g.ndim == 0:
        return collectives.all_reduce(g.clone(), mesh, (axis,), path=path) / n
    limit = max(127 // max(n, 1), 1)
    amax = g.abs().max().float() + 1e-12
    scale = (amax / limit).reshape(())
    # round half to even (torch.round, as jnp.round), then clip
    q = torch.clamp(torch.round(g.float() / scale), -limit, limit).to(torch.int8)
    q_sum = collectives.all_reduce(q, mesh, (axis,), path=path)  # int8 on the wire
    scale_mean = collectives.all_reduce(scale.clone(), mesh, (axis,), path=path) / n
    return q_sum.float() * scale_mean / n


def manual_axis(mesh, mode: str) -> Optional[str]:
    """The axis the int8 sync runs over, or None (compression off, no
    data-parallel axis > 1, or a ``model`` axis > 1 without a pod axis:
    warned once)."""
    sizes = shmod.axis_sizes(mesh)
    axis = next((a for a in ("pod", "data") if sizes.get(a, 1) > 1), None)
    if mode == "none" or axis is None:
        return None
    if axis == "data" and any(s > 1 for a, s in sizes.items() if a != "data"):
        global _warned_tp_fallback
        if not _warned_tp_fallback:
            _warned_tp_fallback = True
            warnings.warn(
                "grad_compression='int8' requested on a mesh with a >1 "
                "model axis: the explicit int8 data-axis sync only "
                "supports pure-DP meshes; falling back to the implicit "
                "(uncompressed) gradient all-reduce. Use a (N,1) mesh or "
                "a pod mesh for int8 sync. Warned once per process.",
                UserWarning, stacklevel=3)
        return None
    return axis


def value_and_grad_compressed(value_and_grad: Callable, params: Any, batch: Any, mesh,
                              axis: str, paths: Any) -> Tuple[torch.Tensor, Any]:
    """``(loss, grads)`` averaged over the manual ``axis`` (from
    :func:`manual_axis`), the grads in int8 on the wire.

    ``value_and_grad(params, batch)`` differentiates this rank's loss
    inside a context that makes ``axis`` manual and splits the rows over
    the remaining batch axes; ``paths`` is a tree of the leaves' param
    paths, which the collectives record.  The loss is averaged in float32.
    """
    n = shmod.axis_sizes(mesh)[axis]
    act = dict(shmod._CTX.act_rules or shmod.ACT_RULES)
    act["batch"] = ("data", None) if axis == "pod" else (None,)
    prm = shmod._CTX.param_rules or shmod.PARAM_RULES
    rows = tuple(a for a in shmod.current_row_axes() if a != axis)
    with shmod.axis_rules(mesh, act=act, params=prm, manual=frozenset({axis}), rows=rows):
        loss, grads = value_and_grad(params, batch)
    it = iter(tree_leaves(paths))
    grads = tree_map(lambda g: _quantize_pmean(g, mesh, axis, n, path=next(it)), grads)
    loss = collectives.all_reduce(loss.detach().float().clone(), mesh, (axis,),
                                  path="loss") / n
    return loss, grads
