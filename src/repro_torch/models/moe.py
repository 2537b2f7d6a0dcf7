"""Mixture-of-Experts on one device — the counterpart of
``repro/models/moe.py``.

Three dispatch semantics, chosen by ``cfg.moe_impl``:

* ``"ep"``     — the reference's expert-parallel path at ``ep_size = 1``
                 (``_moe_ep_local``), which is what every JAX entry point
                 runs: the train, prefill and serve steps enter
                 ``axis_rules(mesh)`` (the serving engine on a 1 x 1 host
                 mesh), so ``moe_apply`` never takes its no-mesh fallback
                 there.  The port has no mesh, so ``"ep"`` means these
                 one-device semantics; JAX's no-mesh fallback (``dense`` or
                 ``gshard`` by token count) is reached only by bare calls
                 outside a step, and is not mirrored.
* ``"gshard"`` — one capacity-bounded dispatch, positions by a cumulative
                 sum over tokens.
* ``"dense"``  — every expert on every token (the smoke configs' path).

The ``ep`` capacity rule, at one device: the (token, slot) pairs in flat
``t * k + j`` order all fit stage 1 (``cap1 = int(1.25 t k)``); stage 2
keeps a pair only if its rank among the pairs routed to the same expert is
under ``cap2 = max(1, int(cap1 / E * 1.25))``.  A dropped pair contributes
zero.  At an 8-slot decode step of a 64-expert top-8 model ``cap2 = 1``.
Every row the call is given is routed, padding and idle decode lanes
included, and takes capacity, as in the reference.

The experts' products are ``einsum`` outside any Pallas kernel in the
reference, so here they are ``torch.bmm`` over the expert axis, float32
accumulation and one rounding to the activations' dtype after each product
(:func:`bmm32`).  The router runs in float32.  Dispatch buffers are filled
by one scatter and read back by one gather, with no host sync; a token's k
weighted contributions are summed in slot order in the activations' dtype
(no atomics: a second call, as activation checkpointing makes, gives the
same bits).  An int8-exported expert group raises: the reference's
``_expert_ffn`` reads only ``kernel`` or ``u``/``v``.

Under a mesh of more than one rank (``distributed.sharding.axis_rules``,
one process a rank; x holds this rank's rows over the batch axes and is
replicated over ``model``) ``"ep"`` is the reference's ``_moe_ep`` at
``ep = model`` size: rank m on ``model`` takes sequence positions
``[m s/ep, (m+1) s/ep)`` of its rows, routes them, sends each (token,
slot) pair to the rank holding its expert (``dest = id // (E / ep)``) in
stage-1 slots of a cumulative count over pairs (``cap1 = int(t k / ep *
1.25)``, overflow dropped), exchanges x and the +1 local expert ids with
:func:`~repro_torch.distributed.collectives.all_to_all`, regroups what it
received by local expert in received order (``cap2 = int(ep cap1 / (E /
ep) * 1.25)``), runs its ``E / ep`` experts, gathers each slot back (0 for
an empty or dropped one), exchanges back and sums ``y[tok] += contrib *
w`` in pair order; y is all-gathered over ``model`` along the sequence.
The cut and the gather are an autograd pair (:class:`_Cut`,
:class:`_Gather`), so x's gradient comes back whole on every ``model``
rank; the router, replicated but fed only this rank's positions, has its
gradient summed over ``model`` (:class:`_SumGrad`); aux is averaged over
the live mesh axes.  Where the reference falls back to ``_moe_gshard``
(``s % ep`` or ``E % ep``; a decode step's s = 1) the port runs gshard on
every row of the batch axes (gathered, then cut back) with the rank's
experts only, their ``(E, cap, d)`` outputs all-gathered over ``model``
before the combine; ``"dense"`` runs the rank's experts on every token and
gathers their outputs the same way.  Expert leaves whose leading dim is E
are cut to the rank's block; leaves of ``E / ep`` are that block already.
:func:`moe_ep_plain` runs the ranks' local functions in turn, the exchange
done by indexing: the plain version the tests and ``chip_smoke.py`` hold
the exchange against.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.models.common import Params, dot32, ffn, ffn_init, wide

__all__ = ["moe_init", "moe_apply", "bmm32", "ep_capacity", "ep_send_capacity",
           "gshard_capacity", "moe_ep_plain", "ep_exchange_bytes"]


def moe_init(dec, path: str, cfg: ModelConfig, stack: Tuple[int, ...] = ()) -> Params:
    """Router (float32), experts (dense or factorised, stacked over E) and
    the optional shared expert, drawn in the reference's order."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p: Params = {
        "router": {"kernel": dec.normal(stack + (d, e)) * (d ** -0.5)},
        "experts": {
            "gate": dec.linear(f"{path}/experts/gate", d, f, stack=stack + (e,)),
            "up": dec.linear(f"{path}/experts/up", d, f, stack=stack + (e,)),
            "down": dec.linear(f"{path}/experts/down", f, d, stack=stack + (e,)),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = ffn_init(dec, f"{path}/shared", d, f * cfg.num_shared_experts,
                               "swiglu", cfg.pdtype, stack=stack)
    return p


def _router(p: Params, xf: torch.Tensor, cfg: ModelConfig):
    """Softmax router with top-k: (weights (t, k), ids (t, k), aux).

    The load-balance term is the reference's expression as written: its
    ``ce`` is a mean over a 1-D vector, so it equals 1/E and ``aux`` is the
    sum of the mean probabilities, 1 up to rounding."""
    logits = dot32(xf, p["router"]["kernel"])
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    topw = topw / torch.clamp(torch.sum(topw, dim=-1, keepdim=True), min=1e-9)
    e = cfg.num_experts
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(F.one_hot(topi[:, 0], e).to(probs.dtype), dim=0)
                    / max(xf.shape[0], 1), dim=0)
    aux = e * torch.sum(me * ce)
    return topw, topi, aux


class _Bmm32(torch.autograd.Function):
    """a @ b batched, float32 accumulation, rounded to a's dtype; saves the
    operands in their own dtype (not their float32 copies)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(wide(a), wide(b)).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(wide(g), wide(b).transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(wide(a).transpose(1, 2), wide(g)).to(b.dtype)
        return ga, gb


def bmm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, C, a) @ (E, a, b) -> (E, C, b) in a's dtype (the reference's
    ``einsum(..., preferred_element_type=float32).astype(t.dtype)``)."""
    return _Bmm32.apply(a, b)


def _expert_ffn(experts: Params, x_e: torch.Tensor) -> torch.Tensor:
    """x_e (E, C, d) -> (E, C, d): per-expert SwiGLU, dense (E, d, f) or
    factorised (E, d, r) + (E, r, f) weights."""

    def mat(p, t):
        if "kernel" in p:
            return bmm32(t, p["kernel"])
        if "u" not in p:
            raise ValueError(f"expert group with leaves {sorted(p)}: the reference's "
                             f"_expert_ffn reads only 'kernel' or 'u'/'v', so an int8 "
                             f"export of expert groups cannot be served")
        return bmm32(bmm32(t, p["u"]), p["v"])

    g = mat(experts["gate"], x_e)
    u = mat(experts["up"], x_e)
    h = (F.silu(g.float()) * u.float()).to(x_e.dtype)
    return mat(experts["down"], h)


def _scatter_rows(src: torch.Tensor, slot: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(n_slots, d) buffer with ``src[i]`` at row ``slot[i]``; rows no pair
    lands on are zero, and a slot of ``n_slots`` (a dropped pair) lands on
    a spare row that is cut off."""
    buf = src.new_zeros((n_slots + 1, src.shape[-1])).index_put((slot,), src)
    return buf[:n_slots]


def _gather_rows(rows: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``rows[slot]``, zero where ``slot`` is ``len(rows)`` (dropped)."""
    return torch.cat([rows, rows.new_zeros((1, rows.shape[-1]))])[slot]


def _dispatch_combine(experts: Params, xf: torch.Tensor, slot: torch.Tensor,
                      e: int, cap: int, ffn_fn=None) -> torch.Tensor:
    """Run the experts on (E, cap, d) buffers and read each (token, slot)
    pair's output back: ``slot`` (t, k) holds the pair's buffer row
    ``expert * cap + position``, or ``E * cap`` for a dropped pair.  Returns
    the (t, k, d) outputs, zero for dropped pairs.  ``ffn_fn`` (default
    :func:`_expert_ffn` on ``experts``) maps the (E, cap, d) buffer to the
    experts' outputs."""
    t, k = slot.shape
    d = xf.shape[-1]
    n_slots = e * cap
    flat = slot.reshape(t * k)
    # a token's row once per slot; dropped pairs all land on one spare row
    pairs = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = _scatter_rows(pairs, flat, n_slots).reshape(e, cap, d)
    ex_out = _expert_ffn(experts, buf) if ffn_fn is None else ffn_fn(buf)
    return _gather_rows(ex_out.reshape(n_slots, d), flat).reshape(t, k, d)


def ep_send_capacity(t: int, cfg: ModelConfig, ep: int = 1) -> int:
    """Stage-1 capacity (send slots a destination rank) of the ``ep`` path
    for ``t`` local tokens over ``ep`` ranks: the reference's ``cap1``."""
    return max(1, int(t * cfg.num_experts_per_tok / ep * cfg.capacity_factor))


def ep_capacity(t: int, cfg: ModelConfig, ep: int = 1) -> int:
    """Stage-2 capacity (slots a local expert) of the ``ep`` path for ``t``
    local tokens over ``ep`` ranks: the reference's ``cap2``."""
    rt = ep * ep_send_capacity(t, cfg, ep)
    return max(1, int(rt / (cfg.num_experts // ep) * cfg.capacity_factor))


def ep_exchange_bytes(t: int, d: int, cfg: ModelConfig, ep: int, itemsize: int) -> dict:
    """Bytes one rank sends into each all_to_all of one EP layer's forward
    over ``ep`` ranks for ``t`` local tokens: x (``moe/dispatch``), the
    int32 expert ids (``moe/dispatch_ids``) and the experts' outputs back
    (``moe/combine``); a backward sends the x and output exchanges once
    more each."""
    slots = ep * ep_send_capacity(t, cfg, ep)
    return {"moe/dispatch": slots * d * itemsize, "moe/dispatch_ids": slots * 4,
            "moe/combine": slots * d * itemsize}


def gshard_capacity(t: int, cfg: ModelConfig) -> int:
    return max(1, int(t * cfg.num_experts_per_tok / cfg.num_experts * cfg.capacity_factor))


def _moe_ep(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """The reference's ``_moe_ep_local`` at ``ep_size = 1``: every pair fits
    stage 1 in pair order, so there is no send buffer and no exchange."""
    b, s, d = x.shape
    t = b * s
    send_x, send_e, state, aux = _ep_send(x.reshape(t, d), p["router"]["kernel"], cfg, 1)
    y2 = _ep_experts(send_x, send_e, p["experts"], cfg, 1, ep_capacity(t, cfg))
    return _ep_combine(y2, state, x.dtype).reshape(b, s, d), aux


def _moe_gshard(p: Params, x: torch.Tensor, cfg: ModelConfig, ffn_fn=None):
    b, s, d = x.shape
    t, e = b * s, cfg.num_experts
    xf = x.reshape(t, d)
    topw, topi, aux = _router(p, xf, cfg)
    cap = gshard_capacity(t, cfg)
    mask = torch.sum(F.one_hot(topi, e), dim=1)  # (t, e) 0/1
    pos = torch.gather(torch.cumsum(mask, dim=0) - 1, 1, topi)  # (t, k)
    slot = torch.where(pos < cap, topi * cap + pos, torch.full_like(topi, e * cap))
    out = _dispatch_combine(p["experts"], xf, slot, e, cap, ffn_fn)
    # the combine einsum: weights in x's dtype, float32 sum, one rounding
    y = torch.sum(wide(topw.to(x.dtype))[..., None] * wide(out), dim=1).to(x.dtype)
    return y.reshape(b, s, d), aux


def _moe_dense(p: Params, x: torch.Tensor, cfg: ModelConfig, ffn_fn=None):
    b, s, d = x.shape
    t, e = b * s, cfg.num_experts
    xf = x.reshape(t, d)
    topw, topi, aux = _router(p, xf, cfg)
    gate = torch.zeros((t, e), dtype=topw.dtype, device=x.device).scatter(1, topi, topw)
    x_all = xf[None].expand(e, t, d)
    y_all = _expert_ffn(p["experts"], x_all) if ffn_fn is None else ffn_fn(x_all)  # (e, t, d)
    y = torch.einsum("te,etd->td", wide(gate.to(x.dtype)), wide(y_all)).to(x.dtype)
    return y.reshape(b, s, d), aux


# --------------------------------------------------------------------------
# under a mesh of more than one rank (one process a rank)
# --------------------------------------------------------------------------

class _Cut(torch.autograd.Function):
    """This rank's block along ``dim`` over ``model`` of a tensor replicated
    over it; the backward gathers the blocks' gradients, so the gradient
    is whole on every ``model`` rank, as the replicated tensor's must be."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = collectives.axes_size(mesh, ("model",))
        size = t.shape[dim] // n
        return t.narrow(dim, collectives.coordinate(mesh, ("model",)) * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return collectives.all_gather(g, ctx.mesh, ("model",), ctx.dim,
                                      path="activation"), None, None


class _Gather(torch.autograd.Function):
    """The blocks along ``dim`` over ``model`` gathered whole on every
    rank; the backward takes this rank's block of the (replicated)
    gradient."""

    @staticmethod
    def forward(ctx, t, mesh, dim, path):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, t.shape[dim]
        return collectives.all_gather(t, mesh, ("model",), dim, path=path)

    @staticmethod
    def backward(ctx, g):
        i = collectives.coordinate(ctx.mesh, ("model",))
        return g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(), None, None, None


class _RowGather(torch.autograd.Function):
    """Every row of the batch axes ``rows`` gathered on each rank; the
    backward sums the ranks' gradients and keeps this rank's rows (each
    data rank's gradient is its share of the loss's)."""

    @staticmethod
    def forward(ctx, t, mesh, rows):
        ctx.mesh, ctx.rows = mesh, rows
        return collectives.all_gather(t, mesh, rows, 0, path="activation")

    @staticmethod
    def backward(ctx, g):
        return collectives.reduce_scatter(g.contiguous(), ctx.mesh, ctx.rows, 0,
                                          path="activation"), None, None


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``model`` (a
    replicated param that each ``model`` rank feeds only its own tokens)."""

    @staticmethod
    def forward(ctx, t, mesh, path):
        ctx.mesh, ctx.path = mesh, path
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g.clone(), ctx.mesh, ("model",), path=ctx.path), None, None


class _MeanOver(torch.autograd.Function):
    """The mean of a scalar over ``axes`` (``lax.pmean``).  The backward
    hands each rank the upstream weight over the ranks it stands for: a
    data rank's upstream is its share of the loss's (summed over data by
    the step's sync), a ``model`` rank's the whole (replicated), so the
    gradient is ``g * n_rows / n``."""

    @staticmethod
    def forward(ctx, t, mesh, axes, rows):
        n = collectives.axes_size(mesh, axes)
        ctx.scale = collectives.axes_size(mesh, rows) / n
        return collectives.all_reduce(t.clone(), mesh, axes, path="moe/aux") / n

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None, None


def _local_experts(experts: Params, mesh, ep: int, e: int) -> Params:
    """The rank's ``E / ep`` experts: leaves of E along their leading
    (expert) dim are cut to the rank's block (a view), leaves of ``E / ep``
    are that block already."""
    i = collectives.coordinate(mesh, ("model",))

    def cut(t):
        if t.shape[0] == e // ep:
            return t
        if t.shape[0] != e:
            raise ValueError(f"expert leaf of shape {tuple(t.shape)}: the leading dim must "
                             f"be E = {e} or E / model = {e // ep}")
        return t.narrow(0, i * (e // ep), e // ep)

    return {g: {k: cut(v) for k, v in grp.items()} for g, grp in experts.items()}


def _ep_send(xf: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig, ep: int):
    """Stage 1 of ``_moe_ep_local``: route the local tokens and scatter the
    (token, slot) pairs into per-destination send slots.  Returns the send
    buffers (ep, cap1, d) and (ep, cap1) (+1 local expert ids, 0 empty),
    the combine's state and aux."""
    t, d = xf.shape
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    e_local = e // ep
    topw, topi, aux = _router({"router": {"kernel": router_w}}, xf, cfg)
    fe, fw = topi.reshape(t * k), topw.reshape(t * k)
    # xf[tok] for tok = repeat(arange(t), k): each token's row once a slot
    pairs = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    dest = fe // e_local
    ids = (fe % e_local + 1).to(torch.int32)[:, None]
    if ep == 1:  # cap1 >= t k: the slots are the pairs, in order
        return pairs[None], ids.reshape(1, -1), (None, fw, t, k), aux
    cap1 = ep_send_capacity(t, cfg, ep)
    pos1 = torch.gather(torch.cumsum(F.one_hot(dest, ep), dim=0) - 1, 1, dest[:, None])[:, 0]
    slot1 = torch.where(pos1 < cap1, dest * cap1 + pos1, torch.full_like(dest, ep * cap1))
    send_x = _scatter_rows(pairs, slot1, ep * cap1).reshape(ep, cap1, d)
    send_e = _scatter_rows(ids, slot1, ep * cap1).reshape(ep, cap1)
    return send_x, send_e, (slot1, fw, t, k), aux


def _ep_experts(recv_x: torch.Tensor, recv_e: torch.Tensor, experts: Params,
                cfg: ModelConfig, ep: int, cap2: int) -> torch.Tensor:
    """Stage 2 of ``_moe_ep_local``: regroup what was received by local
    expert in received order (source rank, then slot) into ``cap2`` slots
    an expert (:func:`ep_capacity`), run the rank's experts and read each
    slot's output back (0 for an empty or dropped one): (ep, cap1, d)."""
    _, cap1, d = recv_x.shape
    e_local = cfg.num_experts // ep
    rt = ep * cap1
    fe2 = recv_e.reshape(rt).long() - 1
    valid = fe2 >= 0
    fe2c = torch.where(valid, fe2, torch.zeros_like(fe2))
    oh2 = F.one_hot(fe2c, e_local) * valid[:, None]
    pos2 = torch.gather(torch.cumsum(oh2, dim=0) - 1, 1, fe2c[:, None])[:, 0]
    slot2 = torch.where(valid & (pos2 < cap2), fe2c * cap2 + pos2,
                        torch.full_like(fe2c, e_local * cap2))
    ex_in = _scatter_rows(recv_x.reshape(rt, d), slot2, e_local * cap2)
    ex_out = _expert_ffn(experts, ex_in.reshape(e_local, cap2, d))
    return _gather_rows(ex_out.reshape(e_local * cap2, d), slot2).reshape(ep, cap1, d)


def _ep_combine(back: torch.Tensor, state, dtype) -> torch.Tensor:
    """Reverse stage 1: each pair's output from the returned slots, times
    its weight, summed over the token's pairs in pair order: (t, d)."""
    slot1, fw, t, k = state
    d = back.shape[-1]
    rows = back.reshape(-1, d)
    contrib = (rows if slot1 is None else _gather_rows(rows, slot1)) * fw.to(dtype)[:, None]
    contrib = contrib.reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def moe_ep_plain(p: Params, x: torch.Tensor, cfg: ModelConfig, data: int = 1,
                 model: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``ep`` path of a ``(data, model)`` mesh in one process: ``x`` is
    the GLOBAL batch (B, S, d) and ``p`` the whole layer; each rank's local
    function runs in turn on its block (rows over ``data``, positions over
    ``model``), the all_to_alls done by indexing.  Returns (y (B, S, d),
    aux averaged over the ranks), differentiable.  The plain version the
    tests and ``chip_smoke.py`` hold :func:`moe_apply` under a mesh
    against; shapes must divide (no fallback)."""
    b, s, d = x.shape
    ep, e = model, cfg.num_experts
    bl, sl = b // data, s // ep
    if b % data or s % ep or e % ep:
        raise ValueError(f"moe_ep_plain: ({b}, {s}) rows / positions and {e} experts must "
                         f"divide over ({data}, {model})")
    rows_out, auxes = [], []
    for di in range(data):
        xr = x[di * bl:(di + 1) * bl]
        sends = [_ep_send(xr[:, m * sl:(m + 1) * sl].reshape(bl * sl, d),
                          p["router"]["kernel"], cfg, ep) for m in range(ep)]
        outs = []
        for m in range(ep):
            recv_x = torch.stack([sends[j][0][m] for j in range(ep)])
            recv_e = torch.stack([sends[j][1][m] for j in range(ep)])
            experts = {g: {k: v[m * (e // ep):(m + 1) * (e // ep)] for k, v in grp.items()}
                       for g, grp in p["experts"].items()}
            outs.append(_ep_experts(recv_x, recv_e, experts, cfg, ep,
                                    ep_capacity(bl * sl, cfg, ep)))
        ys = [_ep_combine(torch.stack([outs[j][m] for j in range(ep)]), sends[m][2], x.dtype)
              for m in range(ep)]
        rows_out.append(torch.cat([y.reshape(bl, sl, d) for y in ys], dim=1))
        auxes.extend(snd[3] for snd in sends)
    aux = auxes[0]
    for a in auxes[1:]:
        aux = aux + a
    y = torch.cat(rows_out, dim=0)
    if "shared" in p:
        y = y + ffn(p["shared"], x)
    return y, aux / len(auxes)


def _mesh_of_call():
    """(mesh, model size, live row axes, axes to average aux over) of a call
    under a multi-rank mesh, or None."""
    mesh = shd.current_mesh()
    if mesh is None or shd.mesh_size(mesh) == 1:
        return None
    sizes = shd.axis_sizes(mesh)
    manual = shd.current_manual_axes()
    rows = tuple(a for a in shd.current_row_axes() if sizes.get(a, 1) > 1 and a not in manual)
    live = tuple(a for a in ("pod", "data", "model")
                 if sizes.get(a, 1) > 1 and a not in manual
                 and (a == "model" or a in rows))
    return mesh, sizes.get("model", 1), rows, live


def _moe_sharded(p: Params, x: torch.Tensor, cfg: ModelConfig, call):
    """``moe_apply``'s dispatch under a multi-rank mesh (module notes)."""
    mesh, ep, rows, live = call
    impl = cfg.moe_impl
    b, s, d = x.shape
    e = cfg.num_experts
    if ep == 1:
        # tokens stay on their rank: the one-device rule on local rows
        y, aux = _IMPLS[impl](p, x, cfg)
        return y, (_MeanOver.apply(aux, mesh, rows, rows) if rows else aux)
    if impl == "ep" and not (s % ep or e % ep):
        return _moe_ep_mesh(p, x, cfg, mesh, ep, rows, live)
    # gshard (the reference's fallback) or dense: the rank's experts (every
    # expert where E does not divide), their outputs gathered over model
    ffn_fn = None
    if not e % ep:
        experts = _local_experts(p["experts"], mesh, ep, e)

        def ffn_fn(buf):
            out = _expert_ffn(experts, _Cut.apply(buf, mesh, 0))
            return _Gather.apply(out, mesh, 0, "moe/expert_out")

    if impl == "dense":  # row-local; aux is a mean over the rows
        y, aux = _moe_dense(p, x, cfg, ffn_fn)
        return y, (_MeanOver.apply(aux, mesh, rows, rows) if rows else aux)
    # gshard's capacity and positions span every row of the batch axes
    y, aux = _moe_gshard(p, _RowGather.apply(x, mesh, rows) if rows else x, cfg, ffn_fn)
    if rows:  # back to this rank's rows
        y = y.narrow(0, collectives.coordinate(mesh, rows) * b, b)
    return y, aux


def _moe_ep_mesh(p: Params, x: torch.Tensor, cfg: ModelConfig, mesh, ep: int, rows, live):
    b, s, d = x.shape
    e = cfg.num_experts
    router_w = _SumGrad.apply(p["router"]["kernel"], mesh,
                              shd.leaf_path(p["router"]["kernel"]))
    xs = _Cut.apply(x, mesh, 1)  # this rank's positions of its rows
    send_x, send_e, state, aux = _ep_send(xs.reshape(b * (s // ep), d), router_w, cfg, ep)
    recv_x = collectives.all_to_all(send_x, mesh, "model", path="moe/dispatch")
    recv_e = collectives.all_to_all(send_e, mesh, "model", path="moe/dispatch_ids")
    y2 = _ep_experts(recv_x, recv_e, _local_experts(p["experts"], mesh, ep, e), cfg, ep,
                     ep_capacity(b * (s // ep), cfg, ep))
    back = collectives.all_to_all(y2, mesh, "model", path="moe/combine")
    y = _ep_combine(back, state, x.dtype).reshape(b, s // ep, d)
    return _Gather.apply(y, mesh, 1, "activation"), _MeanOver.apply(aux, mesh, live, rows)


_IMPLS = {"ep": _moe_ep, "gshard": _moe_gshard, "dense": _moe_dense}


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              policy=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, d) in x's dtype, aux float32) under ``cfg.moe_impl``; under
    a multi-rank mesh x is this rank's rows and y its rows (module notes)."""
    if cfg.moe_impl not in _IMPLS:
        raise ValueError(f"moe_impl={cfg.moe_impl!r}: the port runs 'ep', 'gshard' or "
                         f"'dense'")
    call = _mesh_of_call()
    if call is None:
        y, aux = _IMPLS[cfg.moe_impl](p, x, cfg)
    else:
        y, aux = _moe_sharded(p, x, cfg, call)
    if "shared" in p:
        y = y + ffn(p["shared"], x, policy=policy)
    return y, aux
