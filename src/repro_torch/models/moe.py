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
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Params, dot32, ffn, ffn_init, wide

__all__ = ["moe_init", "moe_apply", "bmm32", "ep_capacity", "gshard_capacity"]


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


def _dispatch_combine(experts: Params, xf: torch.Tensor, slot: torch.Tensor,
                      e: int, cap: int) -> torch.Tensor:
    """Run the experts on (E, cap, d) buffers and read each (token, slot)
    pair's output back: ``slot`` (t, k) holds the pair's buffer row
    ``expert * cap + position``, or ``E * cap`` for a dropped pair.  Returns
    the (t, k, d) outputs, zero for dropped pairs."""
    t, k = slot.shape
    d = xf.shape[-1]
    n_slots = e * cap
    flat = slot.reshape(t * k)
    # a token's row once per slot; dropped pairs all land on one spare row
    pairs = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xf.new_zeros((n_slots + 1, d)).index_put((flat,), pairs)
    ex_out = _expert_ffn(experts, buf[:n_slots].reshape(e, cap, d))
    rows = torch.cat([ex_out.reshape(n_slots, d), ex_out.new_zeros((1, d))])
    return rows[flat].reshape(t, k, d)


def ep_capacity(t: int, cfg: ModelConfig) -> int:
    """Stage-2 capacity of the one-device ``ep`` path for ``t`` tokens."""
    cap1 = max(1, int(t * cfg.num_experts_per_tok * cfg.capacity_factor))
    return max(1, int(cap1 / cfg.num_experts * cfg.capacity_factor))


def gshard_capacity(t: int, cfg: ModelConfig) -> int:
    return max(1, int(t * cfg.num_experts_per_tok / cfg.num_experts * cfg.capacity_factor))


def _moe_ep(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, d = x.shape
    t, k, e = b * s, cfg.num_experts_per_tok, cfg.num_experts
    xf = x.reshape(t, d)
    topw, topi, aux = _router(p, xf, cfg)
    cap2 = ep_capacity(t, cfg)
    fe = topi.reshape(t * k)
    # rank of each pair among the pairs routed to its expert, flat order
    pos = torch.gather(torch.cumsum(F.one_hot(fe, e), dim=0) - 1, 1, fe[:, None])[:, 0]
    slot = torch.where(pos < cap2, fe * cap2 + pos, torch.full_like(fe, e * cap2))
    out = _dispatch_combine(p["experts"], xf, slot.reshape(t, k), e, cap2)
    contrib = out * topw.to(x.dtype)[..., None]
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y.reshape(b, s, d), aux


def _moe_gshard(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, d = x.shape
    t, e = b * s, cfg.num_experts
    xf = x.reshape(t, d)
    topw, topi, aux = _router(p, xf, cfg)
    cap = gshard_capacity(t, cfg)
    mask = torch.sum(F.one_hot(topi, e), dim=1)  # (t, e) 0/1
    pos = torch.gather(torch.cumsum(mask, dim=0) - 1, 1, topi)  # (t, k)
    slot = torch.where(pos < cap, topi * cap + pos, torch.full_like(topi, e * cap))
    out = _dispatch_combine(p["experts"], xf, slot, e, cap)
    # the combine einsum: weights in x's dtype, float32 sum, one rounding
    y = torch.sum(wide(topw.to(x.dtype))[..., None] * wide(out), dim=1).to(x.dtype)
    return y.reshape(b, s, d), aux


def _moe_dense(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, d = x.shape
    t, e = b * s, cfg.num_experts
    xf = x.reshape(t, d)
    topw, topi, aux = _router(p, xf, cfg)
    gate = torch.zeros((t, e), dtype=topw.dtype, device=x.device).scatter(1, topi, topw)
    y_all = _expert_ffn(p["experts"], xf[None].expand(e, t, d))  # (e, t, d)
    y = torch.einsum("te,etd->td", wide(gate.to(x.dtype)), wide(y_all)).to(x.dtype)
    return y.reshape(b, s, d), aux


_IMPLS = {"ep": _moe_ep, "gshard": _moe_gshard, "dense": _moe_dense}


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              policy=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, d) in x's dtype, aux float32) under ``cfg.moe_impl``."""
    if cfg.moe_impl not in _IMPLS:
        raise ValueError(f"moe_impl={cfg.moe_impl!r}: the port runs 'ep' (one device), "
                         f"'gshard' or 'dense'")
    y, aux = _IMPLS[cfg.moe_impl](p, x, cfg)
    if "shared" in p:
        y = y + ffn(p["shared"], x, policy=policy)
    return y, aux
