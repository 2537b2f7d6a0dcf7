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

Under an active multi-device mesh (``distributed.sharding.axis_rules``,
the sharded train step) the two entry points run the counterpart of the
reference's full-manual ``shard_map`` dispatch on this rank's LOCAL
tensors: x holds this rank's rows (split over the context's ``rows``
axes), u is whole, and v holds this rank's block of columns over
``model`` when the step registered it so (``sharding.axis_rules(leaves=)``
names each leaf's path and whether its columns are split).  K1 or K5 runs
on the local block and the output columns are all-gathered over ``model``
before they leave the dispatch (the rest of the model runs replicated over
``model``).  The backward launches K2 on the local dy columns and
all-reduces dx over ``model``; K3 (dU) only when ``freeze_group != 0``,
then an all-reduce over the row axes and ``model``; K4 (dV) only when
``freeze_group != 1``, then an all-reduce over the row axes.  A frozen
factor gets no gradient: no kernel and no collective
(``distributed.collectives`` records each collective with the path of the
leaf it serves).  With neither rows to split nor columns (the rows are
whole, or an enclosing int8 region owns their sync) there is nothing to
map: the unsharded dispatch above runs on the local tensors, kernels
included, and runs no collective.  The reference takes its jnp path there
(reason ``mesh-no-mapping``) because XLA cannot partition a
``pallas_call`` inside a manual ``shard_map``; here every tensor is
already this rank's block, so that reason does not hold.  The kernels
take any local shape, so the reference's ``mesh-indivisible-local``
cannot arise either.  K8 is not on the sharded path.

K6 and K7 under such a mesh (the sharded serving steps) take the same
argument: where the step registered ``w_q`` or ``v_q`` as split, it and
its scale hold this rank's columns over ``model`` while x, ``u_q`` and
``u_scale`` are whole, so the kernel runs on the local block and its
output columns are all-gathered over ``model`` (path ``activation``), as
for K1.  x is quantized per row, and K7's rank-r intermediate requantized
per row, before any column is split, and every sum is an exact int32 one:
each column comes out bit for bit as the unsharded kernel's.  The
reference's dispatchers take their jnp path under a mesh, since XLA
cannot partition a ``pallas_call``; here every tensor is already this
rank's block, so the kernel launches.

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
  for K7, no torch op around them (under a multi-device mesh, on the local
  column block, then the gather above).  There is no shape fallback;
* kernel requested, CPU tensors (reason ``platform``): the kernel's plain
  version (``quantize_rowwise``, the exact int8 product and the scales),
  i.e. the activation-quantized algebra, which is what JAX computes in
  interpret mode.  This is the one place where the port's CPU path
  differs from JAX's un-interpreted CPU path (the weight-only formula
  below);
* policy off (reason ``disabled``, any device): JAX's own policy-off
  formula, the weight-only ``x @ (w_q.float() * w_scale)``.

With ``KernelPolicy.autotune`` (``lrd.pallas_autotune``) each kernel call
on CUDA (or meta) tensors consults the active tuning table
(``kernels/autotune.py``) for its design, plan, split or grid: each
distinct call key is resolved once (one ``autotune_lookups{op, result}``
count) and cached, so a lookup on the decode path is one dict hit.  A
miss, or a bucketed hit the wrapper cannot take at the call's M, keeps the
hand-set choice.  With it off, nothing is looked up.

On meta tensors (``launch/dryrun.py``) the policy's kernel path reaches the
wrappers, which check the operands and price the call
(``lowrank_matmul.priced``) instead of launching it.

Every plain-version decision is recorded as a :class:`Fallback` (``op``
``lowrank_fwd``, ``lowrank_ffn``, ``lowrank_dx``, ``lowrank_du``,
``lowrank_dv``, ``int8_dense``, ``int8_lowrank`` or ``flash_attention``);
:func:`capture_fallbacks` collects them while open, so a caller can show
which path a run took, and each also increments the
``kernel_fallbacks{op, reason}`` counter of the default metrics registry
(``repro_torch.obs``), as the reference's dispatchers do.  A CUDA tensor
never takes the plain path, so on the card that counter holds no
``platform`` count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as _shmod
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.int8_matmul import int8_linear, int8_lowrank_linear
from repro_torch.kernels.lowrank_bwd import (lowrank_matmul_du, lowrank_matmul_dv,
                                             lowrank_matmul_dx)
from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
from repro_torch.kernels.lowrank_matmul import lowrank_matmul
from repro_torch.obs import registry as obs_registry

__all__ = ["KernelPolicy", "as_policy", "kernel_available", "lowrank_apply",
           "lowrank_ffn_apply", "int8_apply", "int8_lowrank_apply", "flash_attention_apply",
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
    obs_registry.default_registry().counter(
        "kernel_fallbacks", "dispatcher took the plain version").inc(op=op, reason=reason)
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
    ``autotune`` consults the active tuning table for each kernel call's
    design, plan, split or grid.
    """

    use_kernel: bool = False
    freeze_group: Optional[int] = None
    int8_decode: str = "native"
    autotune: bool = False

    def __bool__(self) -> bool:
        return self.use_kernel


def as_policy(policy: Union[bool, KernelPolicy, None]) -> KernelPolicy:
    """Normalise a bool or policy argument."""
    if isinstance(policy, KernelPolicy):
        return policy
    return KernelPolicy(use_kernel=bool(policy))


def kernel_available() -> bool:
    """Whether the kernels can run here: a CUDA card of compute capability
    (9, 0), the H100's (they are built for ``sm_90a``)."""
    return torch.cuda.is_available() and torch.cuda.get_device_capability() == (9, 0)


# resolved tuning-table choices by call key, for one table generation
_RESOLVED: Dict[tuple, object] = {}
_RESOLVED_FOR: list = [None, -1]


def _tuned(op: str, m: int, c: int, r: int, s: int, dtype, freeze_group: Optional[int]):
    """The active table's choice for a kernel call, or None (no table, a
    miss, or a hit the wrapper cannot take at M): resolved once a key."""
    from repro_torch.kernels import autotune  # deferred: autotune measures through ops

    table = autotune.get_table()
    if table is None:
        return None
    if _RESOLVED_FOR != [table, table.generation]:
        _RESOLVED.clear()
        _RESOLVED_FOR[:] = [table, table.generation]
    key = (op, m, c, r, s, dtype, freeze_group)
    if key not in _RESOLVED:
        e = table.lookup(op, m, c, r, s, dtype, freeze_phase=freeze_group)
        _RESOLVED[key] = (e.choice if e is not None and autotune.takes(m, c, e.choice)
                          else None)
    return _RESOLVED[key]


def _plain_reason(x: torch.Tensor, use_kernel: bool):
    if not use_kernel:
        return "disabled"
    if x.device.type == "cpu":
        return "platform"
    return None


def _dispatch(op: str, kernel, plain, use_kernel, shape, *args, choice=None, tune=None,
              **kw):
    """``kernel(*args)`` for CUDA (or meta) tensors with the policy on, else
    ``plain(*args)``, recorded as a fallback of ``op`` at ``shape``.  The
    kernel takes ``choice`` (an ``autotune.Choice``), else with ``tune`` =
    (M, C, r, S, freeze_group) the active table's, else its hand-set one."""
    reason = _plain_reason(args[0], use_kernel)
    if reason is None:
        if choice is None and tune is not None:
            choice = _tuned(op, *tune[:4], str(args[0].dtype).replace("torch.", ""), tune[4])
        return kernel(*args, **kw, **(choice.kwargs() if choice is not None else {}))
    _note_fallback(op, reason, shape)
    return plain(*args, **kw)


def _fwd(x, u, v, use_kernel, choice=None, tune=False, fg=None) -> torch.Tensor:
    m, c, r, s = x.shape[0], u.shape[0], u.shape[1], v.shape[1]
    return _dispatch("lowrank_fwd", lowrank_matmul, ref.lowrank_matmul_ref, use_kernel,
                     (m, c, s), x, u, v, choice=choice, tune=(m, c, r, s, fg) if tune else None)


def _ffn(x, gu, gv, uu, uv, use_kernel, choice=None, tune=False, fg=None) -> torch.Tensor:
    m, c, r, f = x.shape[0], x.shape[1], gu.shape[1], gv.shape[1]
    return _dispatch("lowrank_ffn", lowrank_gated_ffn, ref.lowrank_gated_ffn_ref, use_kernel,
                     (m, c, f), x, gu, gv, uu, uv, choice=choice,
                     tune=(m, c, r, f, fg) if tune else None)


def _dx(dy, u, v, use_kernel, choice=None, tune=False, fg=None) -> torch.Tensor:
    m, c, r, s = dy.shape[0], u.shape[0], u.shape[1], v.shape[1]
    return _dispatch("lowrank_dx", lowrank_matmul_dx, ref.lowrank_matmul_dx_ref, use_kernel,
                     (m, c, s), dy, u, v, choice=choice, tune=(m, c, r, s, fg) if tune else None)


def _du(x, dy, v, out_dtype, use_kernel, choice=None, tune=False, fg=None) -> torch.Tensor:
    m, c, r, s = x.shape[0], x.shape[1], v.shape[0], v.shape[1]
    return _dispatch("lowrank_du", lowrank_matmul_du, ref.lowrank_matmul_du_ref, use_kernel,
                     (m, c, s), x, dy, v, out_dtype=out_dtype, choice=choice,
                     tune=(m, c, r, s, fg) if tune else None)


def _dv(x, u, dy, out_dtype, use_kernel, choice=None, tune=False, fg=None) -> torch.Tensor:
    m, c, r, s = x.shape[0], x.shape[1], u.shape[1], dy.shape[1]
    return _dispatch("lowrank_dv", lowrank_matmul_dv, ref.lowrank_matmul_dv_ref, use_kernel,
                     (m, c, s), x, u, dy, out_dtype=out_dtype, choice=choice,
                     tune=(m, c, r, s, fg) if tune else None)


class _LowrankMatmul(torch.autograd.Function):
    """y = (x u) v on (M, C) x; backward = ``_lr_bwd`` (K2, K3, K4)."""

    @staticmethod
    def forward(ctx, x, u, v, use_kernel: bool, freeze_group: Optional[int], tune: bool):
        ctx.use_kernel, ctx.freeze_group, ctx.tune = use_kernel, freeze_group, tune
        ctx.save_for_backward(x, u, v)
        return _fwd(x.contiguous(), u, v, use_kernel, tune=tune, fg=freeze_group)

    @staticmethod
    def backward(ctx, dy):
        x, u, v = ctx.saved_tensors
        kw = dict(use_kernel=ctx.use_kernel, tune=ctx.tune, fg=ctx.freeze_group)
        fg = ctx.freeze_group
        x, dy = x.contiguous(), dy.contiguous()
        dx = _dx(dy, u, v, **kw) if ctx.needs_input_grad[0] else None
        du = (_du(x, dy, v, u.dtype, **kw)
              if ctx.needs_input_grad[1] and fg != 0 else None)
        dv = (_dv(x, u, dy, v.dtype, **kw)
              if ctx.needs_input_grad[2] and fg != 1 else None)
        return dx, du, dv, None, None, None


class _LowrankGatedFFN(torch.autograd.Function):
    """silu((x gu) gv) * ((x uu) uv) on (M, C) x; backward = ``_ffn_bwd``:
    both branches recomputed (K1), the SiLU-derivative epilogue in float32,
    then K2 and K3/K4 per branch."""

    @staticmethod
    def forward(ctx, x, gu, gv, uu, uv, use_kernel: bool, freeze_group: Optional[int],
                tune: bool):
        ctx.use_kernel, ctx.freeze_group, ctx.tune = use_kernel, freeze_group, tune
        ctx.save_for_backward(x, gu, gv, uu, uv)
        return _ffn(x.contiguous(), gu, gv, uu, uv, use_kernel, tune=tune, fg=freeze_group)

    @staticmethod
    def backward(ctx, dy):
        x, gu, gv, uu, uv = ctx.saved_tensors
        kw = dict(use_kernel=ctx.use_kernel, tune=ctx.tune, fg=ctx.freeze_group)
        fg = ctx.freeze_group
        need = ctx.needs_input_grad
        x, dy = x.contiguous(), dy.contiguous()
        # recompute the branch pre-activations: cheaper in HBM bytes than
        # keeping two (M, F) tensors from the forward
        gf = _fwd(x, gu, gv, **kw).float()
        upf = _fwd(x, uu, uv, **kw).float()
        dyf = dy.float()
        sg = torch.sigmoid(gf)
        # d silu(g)/dg = sigmoid(g) * (1 + g * (1 - sigmoid(g)))
        dg = (dyf * upf * (sg * (1.0 + gf * (1.0 - sg)))).to(x.dtype)
        dup = (dyf * (gf * sg)).to(x.dtype)
        dx = _dx(dg, gu, gv, **kw) + _dx(dup, uu, uv, **kw) if need[0] else None
        dgu = _du(x, dg, gv, gu.dtype, **kw) if need[1] and fg != 0 else None
        dgv = _dv(x, gu, dg, gv.dtype, **kw) if need[2] and fg != 1 else None
        duu = _du(x, dup, uv, uu.dtype, **kw) if need[3] and fg != 0 else None
        duv = _dv(x, uu, dup, uv.dtype, **kw) if need[4] and fg != 1 else None
        return dx, dgu, dgv, duu, duv, None, None, None


# --------------------------------------------------------------------------
# the sharded dispatch (a multi-device mesh; see the module notes)
# --------------------------------------------------------------------------

def _multi_device_mesh() -> bool:
    mesh = _shmod.current_mesh()
    return mesh is not None and _shmod.mesh_size(mesh) > 1


def _sharded_ctx(*vs: torch.Tensor):
    """(mesh, row axes, model axis or None) of a call whose second factors
    are ``vs``, or None when there is nothing to map."""
    mesh = _shmod.current_mesh()
    sizes = _shmod.axis_sizes(mesh)
    manual = _shmod.current_manual_axes()
    rows = tuple(a for a in _shmod.current_row_axes() if a not in manual and sizes[a] > 1)
    split = {_shmod.leaf_split(v) for v in vs}
    if len(split) != 1:
        raise ValueError("lowrank_ffn_apply: gate and up v split unlike over model")
    model_axis = "model" if split.pop() else None
    if not rows and model_axis is None:
        return None
    return mesh, rows, model_axis


def _local_cols(dy: torch.Tensor, mesh, model_axis, s_local: int) -> torch.Tensor:
    """This rank's block of ``dy``'s columns over ``model_axis``."""
    if model_axis is None:
        return dy.contiguous()
    i = collectives.coordinate(mesh, (model_axis,))
    return dy.narrow(1, i * s_local, s_local).contiguous()


def _gather_cols(y: torch.Tensor, mesh, model_axis) -> torch.Tensor:
    if model_axis is None:
        return y
    return collectives.all_gather(y, mesh, (model_axis,), 1, path="activation")


class _ShardedLowrank(torch.autograd.Function):
    """``_LowrankMatmul`` on this rank's block: x (M_local, C) rows, u (C, r)
    whole, v (r, S_local) columns; out (M_local, S) after the gather."""

    @staticmethod
    def forward(ctx, x, u, v, use_kernel: bool, freeze_group: Optional[int], tune: bool,
                mesh, rows, model_axis):
        ctx.use_kernel, ctx.freeze_group, ctx.tune = use_kernel, freeze_group, tune
        ctx.mesh, ctx.rows, ctx.model_axis = mesh, rows, model_axis
        # read here: the backward may run on autograd's device thread, which
        # does not see this thread's sharding context
        ctx.paths = (_shmod.leaf_path(u), _shmod.leaf_path(v))
        ctx.save_for_backward(x, u, v)
        y = _fwd(x.contiguous(), u, v, use_kernel, tune=tune, fg=freeze_group)
        return _gather_cols(y, mesh, model_axis)

    @staticmethod
    def backward(ctx, dy):
        x, u, v = ctx.saved_tensors
        kw = dict(use_kernel=ctx.use_kernel, tune=ctx.tune, fg=ctx.freeze_group)
        fg, mesh, rows, model = ctx.freeze_group, ctx.mesh, ctx.rows, ctx.model_axis
        models = (model,) if model else ()
        x, dy = x.contiguous(), _local_cols(dy, mesh, model, v.shape[1])
        dx = du = dv = None
        if ctx.needs_input_grad[0]:
            dx = collectives.all_reduce(_dx(dy, u, v, **kw), mesh, models, path="activation")
        if ctx.needs_input_grad[1] and fg != 0:
            du = collectives.all_reduce(_du(x, dy, v, u.dtype, **kw), mesh, rows + models,
                                        path=ctx.paths[0])
        if ctx.needs_input_grad[2] and fg != 1:
            dv = collectives.all_reduce(_dv(x, u, dy, v.dtype, **kw), mesh, rows,
                                        path=ctx.paths[1])
        return dx, du, dv, None, None, None, None, None, None


class _ShardedGatedFFN(torch.autograd.Function):
    """``_LowrankGatedFFN`` on this rank's block: gv/uv hold the local
    columns of F; out (M_local, F) after the gather."""

    @staticmethod
    def forward(ctx, x, gu, gv, uu, uv, use_kernel: bool, freeze_group: Optional[int],
                tune: bool, mesh, rows, model_axis):
        ctx.use_kernel, ctx.freeze_group, ctx.tune = use_kernel, freeze_group, tune
        ctx.mesh, ctx.rows, ctx.model_axis = mesh, rows, model_axis
        ctx.paths = tuple(_shmod.leaf_path(t) for t in (gu, gv, uu, uv))
        ctx.save_for_backward(x, gu, gv, uu, uv)
        y = _ffn(x.contiguous(), gu, gv, uu, uv, use_kernel, tune=tune, fg=freeze_group)
        return _gather_cols(y, mesh, model_axis)

    @staticmethod
    def backward(ctx, dy):
        x, gu, gv, uu, uv = ctx.saved_tensors
        kw = dict(use_kernel=ctx.use_kernel, tune=ctx.tune, fg=ctx.freeze_group)
        fg, mesh, rows, model = ctx.freeze_group, ctx.mesh, ctx.rows, ctx.model_axis
        models = (model,) if model else ()
        need = ctx.needs_input_grad
        x, dy = x.contiguous(), _local_cols(dy, mesh, model, gv.shape[1])
        # the branch pre-activations recomputed on the local columns
        gf = _fwd(x, gu, gv, **kw).float()
        upf = _fwd(x, uu, uv, **kw).float()
        dyf = dy.float()
        sg = torch.sigmoid(gf)
        dg = (dyf * upf * (sg * (1.0 + gf * (1.0 - sg)))).to(x.dtype)
        dup = (dyf * (gf * sg)).to(x.dtype)
        dx = dgu = dgv = duu = duv = None
        if need[0]:
            dx = collectives.all_reduce(_dx(dg, gu, gv, **kw) + _dx(dup, uu, uv, **kw), mesh,
                                        models, path="activation")

        def reduced(g, i, axes):
            return collectives.all_reduce(g, mesh, axes, path=ctx.paths[i])

        if fg != 0:
            if need[1]:
                dgu = reduced(_du(x, dg, gv, gu.dtype, **kw), 0, rows + models)
            if need[3]:
                duu = reduced(_du(x, dup, uv, uu.dtype, **kw), 2, rows + models)
        if fg != 1:
            if need[2]:
                dgv = reduced(_dv(x, gu, dg, gv.dtype, **kw), 1, rows)
            if need[4]:
                duv = reduced(_dv(x, uu, dup, uv.dtype, **kw), 3, rows)
        return dx, dgu, dgv, duu, duv, None, None, None, None, None, None


def lowrank_apply(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                  use_kernel: bool = False, freeze_group: Optional[int] = None,
                  autotune: bool = False) -> torch.Tensor:
    """y = (x @ u) @ v for x (..., C)."""
    c = u.shape[0]
    lead = x.shape[:-1]
    x2 = x.reshape(math.prod(lead), c)
    if _multi_device_mesh():
        sctx = _sharded_ctx(v)
        if sctx is not None:
            y = _ShardedLowrank.apply(x2, u, v, use_kernel, freeze_group, autotune, *sctx)
            return y.reshape(*lead, y.shape[1])
    y = _LowrankMatmul.apply(x2, u, v, use_kernel, freeze_group, autotune)
    return y.reshape(*lead, v.shape[1])


def lowrank_ffn_apply(x: torch.Tensor, gu: torch.Tensor, gv: torch.Tensor,
                      uu: torch.Tensor, uv: torch.Tensor, *,
                      use_kernel: bool = False, freeze_group: Optional[int] = None,
                      autotune: bool = False) -> torch.Tensor:
    """silu((x gu) gv) * ((x uu) uv) for x (..., C)."""
    c, f = gu.shape[0], gv.shape[1]
    lead = x.shape[:-1]
    x2 = x.reshape(math.prod(lead), c)
    if _multi_device_mesh():
        sctx = _sharded_ctx(gv, uv)
        if sctx is not None:
            y = _ShardedGatedFFN.apply(x2, gu, gv, uu, uv, use_kernel, freeze_group,
                                       autotune, *sctx)
            return y.reshape(*lead, y.shape[1])
    y = _LowrankGatedFFN.apply(x2, gu, gv, uu, uv, use_kernel, freeze_group, autotune)
    return y.reshape(*lead, f)


# --------------------------------------------------------------------------
# int8 decode dispatchers (the serving export's int8 artifact)
# --------------------------------------------------------------------------

def _split_cols(w: torch.Tensor):
    """(mesh, "model") when ``w`` holds this rank's columns over ``model``
    under a multi-device mesh (the serving step registered it split), else
    (None, None): the output columns to gather."""
    if _multi_device_mesh() and _shmod.leaf_split(w):
        return _shmod.current_mesh(), "model"
    return None, None


def int8_apply(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
               use_kernel: bool = False) -> torch.Tensor:
    """y = x @ dequant(w_q) for per-output-column int8 dense weights, in
    x's dtype: x (..., C), w_q (C, S) int8, w_scale (1, S) float32 (under a
    mesh, w_q and w_scale this rank's S columns when split)."""
    c, s = w_q.shape
    lead = x.shape[:-1]
    m = math.prod(lead)
    ws = w_scale.reshape(1, s).float()
    mesh, model_axis = _split_cols(w_q)
    reason = _plain_reason(x, use_kernel)
    if reason is not None:
        _note_fallback("int8_dense", reason, (m, c, s))
    if reason == "disabled":
        y = torch.matmul(x.reshape(m, c).float(), w_q.float() * ws).to(x.dtype)
    else:  # the kernel, or its plain version on the CPU
        y = int8_linear(x.reshape(m, c).contiguous(), w_q, ws)
    y = _gather_cols(y, mesh, model_axis)
    return y.reshape(*lead, y.shape[1])


def int8_lowrank_apply(x: torch.Tensor, u_q: torch.Tensor, u_scale: torch.Tensor,
                       v_q: torch.Tensor, v_scale: torch.Tensor, *,
                       use_kernel: bool = False) -> torch.Tensor:
    """y = (x @ dequant(u_q)) @ dequant(v_q) for int8 factor pairs, in x's
    dtype.  The kernel path quantizes x per row and requantizes the rank-r
    intermediate per row on chip; the per-row x scales factor out of that
    requantization and are applied in the kernel's epilogue.  Under a mesh
    v_q and v_scale hold this rank's S columns when split; u_q is whole."""
    c, r = u_q.shape
    s = v_q.shape[1]
    lead = x.shape[:-1]
    m = math.prod(lead)
    us = u_scale.reshape(1, r).float()
    vs = v_scale.reshape(1, s).float()
    mesh, model_axis = _split_cols(v_q)
    reason = _plain_reason(x, use_kernel)
    if reason is not None:
        _note_fallback("int8_lowrank", reason, (m, c, s))
    if reason == "disabled":
        t = torch.matmul(x.reshape(m, c).float(), u_q.float() * us)
        y = torch.matmul(t, v_q.float() * vs).to(x.dtype)
    else:  # the kernel, or its plain version on the CPU
        y = int8_lowrank_linear(x.reshape(m, c).contiguous(), u_q, us.contiguous(), v_q,
                                vs.contiguous())
    y = _gather_cols(y, mesh, model_axis)
    return y.reshape(*lead, y.shape[1])


# --------------------------------------------------------------------------
# Flash attention (prefill, attention_impl="flash")
# --------------------------------------------------------------------------

def flash_attention_apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool, q_scale: float = 1.0,
                          autotune: bool = False) -> torch.Tensor:
    """Flash attention of q (B, Sq, H, D) against k (B, Sk, KV, D) and v (B,
    Sk, KV, Dv): K8 for CUDA tensors (or an error), its plain version for CPU
    tensors.  Forward only: raises under grad mode if an input requires
    grad.  With ``autotune`` the grid is the active table's (key: M = Sq, C
    = B * H, r = D, S = Sk)."""
    choice = None
    if autotune and q.device.type != "cpu":
        b, sq, h, d = q.shape
        choice = _tuned("flash", sq, b * h, d, k.shape[1],
                        str(q.dtype).replace("torch.", ""), None)
    return _flash(q, k, v, causal=causal, q_scale=q_scale, choice=choice)


def _flash(q, k, v, *, causal: bool, q_scale: float, choice=None) -> torch.Tensor:
    out = flash_attention(q, k, v, causal=causal, q_scale=q_scale,
                          **(choice.kwargs() if choice is not None else {}))
    if q.device.type == "cpu":
        _note_fallback("flash_attention", "platform", (q.shape[0], q.shape[1], k.shape[1],
                                                       q.shape[2], k.shape[2], q.shape[3]))
    return out
