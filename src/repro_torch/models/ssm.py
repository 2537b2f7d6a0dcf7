"""State-space blocks: Mamba2 (the zamba2 hybrid) and mLSTM (xLSTM) — the
counterpart of ``repro/models/ssm.py``.

Mamba2 runs the chunked SSD form for train and prefill (quadratic within a
chunk, linear across chunks) and an O(1) recurrent update for decode.
mLSTM runs the stabilised exponential-gating matrix-memory recurrence as a
loop over positions, for train and decode alike, as the reference's step
scan does.  Every in/out projection goes through ``common.linear``, so a
factorised one runs K1 (and K2-K4 in its backward) on CUDA tensors.

One departure by design (ROADMAP queue 3): the intra-chunk decay of
:func:`_ssd_chunked` is ``exp(where(tri, diff, -inf))`` where the reference
writes ``where(tri, exp(diff), 0)``.  The forward is the same (the same
exponentials below the diagonal, ``exp(-inf) = 0`` above it), but above the
diagonal ``diff`` sums ``-dt A > 0`` over up to a whole chunk: at the full
config's 256-token chunk it passes 88 and ``exp`` overflows, and the
reference's gradient there is ``0 * inf = NaN``.  The port's stays finite.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Params, linear, rmsnorm, rmsnorm_init

__all__ = ["conv1d_init", "conv1d_apply", "conv1d_step", "mamba2_init", "mamba2_apply",
           "mamba2_init_state", "xbc_tail", "mlstm_init", "mlstm_apply", "mlstm_init_state"]


def _stacked(t: torch.Tensor, stack: Tuple[int, ...]) -> torch.Tensor:
    """``t`` repeated over the stack dims (one copy per layer, as the
    reference's ``broadcast_to`` of one draw)."""
    return t.expand(stack + tuple(t.shape)).clone() if stack else t


# --------------------------------------------------------------------------
# depthwise causal conv1d
# --------------------------------------------------------------------------

def conv1d_init(dec, width: int, channels: int, dtype) -> Params:
    return {"kernel": (dec.normal((width, channels)) * width ** -0.5).to(dtype)}


def conv1d_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv in float32, x: (B, S, C) -> x's dtype: output
    s sums taps k of the left-padded input at s + k."""
    w = p["kernel"].float()  # (W, C)
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, width - 1, 0))
    y = xp[:, 0:s] * w[0]
    for k in range(1, width):
        y = y + xp[:, k:k + s] * w[k]
    return y.to(x.dtype)


def conv1d_step(p: Params, conv_state: torch.Tensor, x_t: torch.Tensor):
    """conv_state: (B, W-1, C); x_t: (B, 1, C) -> (y_t, new_state)."""
    w = p["kernel"].float()
    window = torch.cat([conv_state, x_t], dim=1)  # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window.float(), w)[:, None]
    return y.to(x_t.dtype), window[:, 1:]


# --------------------------------------------------------------------------
# Mamba2
# --------------------------------------------------------------------------

def mamba2_init(dec, path: str, cfg: ModelConfig, stack: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    nh = di // cfg.ssm_head_dim
    conv_dim = di + 2 * cfg.ssm_state  # one B/C group
    proj_out = 2 * di + 2 * cfg.ssm_state + nh
    f32 = dict(dtype=torch.float32, device=dec.device)
    return {
        "norm": rmsnorm_init(d, cfg.pdtype, dec.device, stack),
        "in_proj": dec.linear(f"{path}/in_proj", d, proj_out, stack=stack),
        "conv1d": {"kernel": _stacked(
            conv1d_init(dec, cfg.ssm_conv_width, conv_dim, cfg.pdtype)["kernel"], stack)},
        "out_proj": dec.linear(f"{path}/out_proj", di, d, stack=stack),
        "A_log": torch.zeros(stack + (nh,), **f32),
        "D": torch.ones(stack + (nh,), **f32),
        "dt_bias": torch.zeros(stack + (nh,), **f32),
        "gate_norm": rmsnorm_init(di, cfg.pdtype, dec.device, stack),
    }


def _ssd_chunked(x, dt, A_log, B, C, D, chunk: int,
                 init_state: Optional[torch.Tensor] = None):
    """Chunked SSD.  x: (b, s, h, p), dt: (b, s, h), B, C: (b, s, h, N).

    Returns (y (b, s, h, p) in x's dtype, final_state (b, h, N, p) float32).
    The intra-chunk products run with heads before the chunk positions,
    (b, c, h, i, j), the same sums as the reference's (b, c, i, j, h).
    """
    b, s, h, pdim = x.shape
    n = B.shape[-1]
    nc = s // chunk
    A = -torch.exp(A_log.float())  # (h,)
    dA = dt.float() * A  # (b, s, h)

    xr = x.reshape(b, nc, chunk, h, pdim).float()
    dtr = dt.reshape(b, nc, chunk, h).float()
    Br = B.reshape(b, nc, chunk, h, n).float()
    Cr = C.reshape(b, nc, chunk, h, n).float()
    a_cs = torch.cumsum(dA.reshape(b, nc, chunk, h), dim=2)  # (b, nc, q, h)
    a_tot = a_cs[:, :, -1]  # (b, nc, h)

    # intra-chunk (quadratic within a chunk); the decay's upper triangle is
    # exp(-inf) = 0 with a zero gradient (module note)
    acs = a_cs.transpose(2, 3)  # (b, nc, h, q)
    diff = acs[..., :, None] - acs[..., None, :]  # (b, nc, h, i, j)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    L = torch.exp(diff.masked_fill(~tri, float("-inf")))
    G = torch.einsum("bcihn,bcjhn->bchij", Cr, Br)
    M = G * L * dtr.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M, xr)

    # local chunk states
    decay = torch.exp(a_tot[:, :, None, :] - a_cs)  # (b, nc, q, h)
    s_loc = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", decay * dtr, Br, xr)

    # inter-chunk recurrence: the state entering each chunk
    sp = (init_state.float() if init_state is not None
          else torch.zeros((b, h, n, pdim), dtype=torch.float32, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(sp)
        sp = torch.exp(a_tot[:, c])[..., None, None] * sp + s_loc[:, c]
    s_prev = torch.stack(prev, dim=1)  # (b, nc, h, n, p)

    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Cr * torch.exp(a_cs)[..., None], s_prev)
    y = (y_intra + y_inter).reshape(b, s, h, pdim)
    y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), sp


def _pick_chunk(s: int, chunk: int) -> int:
    c = min(chunk, s)
    while s % c:
        c -= 1
    return max(c, 1)


def _mamba2_project(p, x, cfg, policy):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    nh = di // cfg.ssm_head_dim
    n = cfg.ssm_state
    zxbcdt = linear(p["in_proj"], x, policy=policy)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt, di, nh, n


def _mamba2_split_xbc(xbc, di, n, nh, hd):
    x_in = xbc[..., :di]
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    b, s = x_in.shape[0], x_in.shape[1]
    xh = x_in.reshape(b, s, nh, hd)
    Bh = B[:, :, None, :].expand(b, s, nh, n)
    Ch = C[:, :, None, :].expand(b, s, nh, n)
    return xh, Bh, Ch


def mamba2_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 mode: str = "full", state: Optional[Params] = None,
                 policy=False, keep_state: bool = True) -> Tuple[torch.Tensor, Params]:
    """x: (B, S, d).  ``mode="full"``: chunked SSD, returns the final SSM
    state and the conv inputs that seed decode; ``"decode"`` (S == 1): the
    recurrence on ``state``.  ``keep_state=False`` (a train step) returns
    no state and skips ``xbc_tail``'s extra in_proj product, which the
    reference's train step computes and XLA drops unused."""
    hd = cfg.ssm_head_dim
    h_in = rmsnorm(p["norm"], x, cfg.norm_eps)
    z, xbc, dt_raw, di, nh, n = _mamba2_project(p, h_in, cfg, policy)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())

    if mode == "full":
        xbc = F.silu(conv1d_apply(p["conv1d"], xbc).float()).to(x.dtype)
        xh, Bh, Ch = _mamba2_split_xbc(xbc, di, n, nh, hd)
        chunk = _pick_chunk(x.shape[1], cfg.ssm_chunk)
        y, s_fin = _ssd_chunked(xh, dt, p["A_log"], Bh, Ch, p["D"], chunk,
                                init_state=state.get("ssm") if state else None)
        new_state = ({"ssm": s_fin.to(x.dtype), "conv": xbc_tail(p, h_in, cfg, di, n, policy)}
                     if keep_state else None)
    else:
        if state is None:
            raise ValueError("mamba2 decode needs a state")
        y_c, conv_state = conv1d_step(p["conv1d"], state["conv"], xbc)
        xbc_t = F.silu(y_c.float()).to(x.dtype)
        xh, Bh, Ch = _mamba2_split_xbc(xbc_t, di, n, nh, hd)
        A = -torch.exp(p["A_log"].float())
        dA = torch.exp(dt[:, 0] * A)  # (B, nh)
        ssm = state["ssm"].float()  # (B, nh, N, hd)
        upd = torch.einsum("bh,bhn,bhp->bhnp", dt[:, 0], Bh[:, 0].float(), xh[:, 0].float())
        ssm = dA[..., None, None] * ssm + upd
        y = torch.einsum("bhn,bhnp->bhp", Ch[:, 0].float(), ssm)
        y = y + p["D"].float()[None, :, None] * xh[:, 0].float()
        y = y[:, None].to(x.dtype)
        new_state = {"ssm": ssm.to(x.dtype), "conv": conv_state}

    b, s = x.shape[0], x.shape[1]
    y = y.reshape(b, s, di)
    y = rmsnorm(p["gate_norm"], y, cfg.norm_eps) * F.silu(z.float()).to(x.dtype)
    return linear(p["out_proj"], y, policy=policy), new_state


def xbc_tail(p, h_in, cfg, di, n, policy):
    """The last (W-1) conv inputs after a full pass: the decode conv state."""
    zxbcdt = linear(p["in_proj"], h_in[:, -(cfg.ssm_conv_width - 1):], policy=policy)
    return zxbcdt[..., di:di + di + 2 * n]


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype, device) -> Params:
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    conv_dim = di + 2 * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, nh, cfg.ssm_state, cfg.ssm_head_dim), dtype=dtype,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
    }


# --------------------------------------------------------------------------
# mLSTM (xLSTM)
# --------------------------------------------------------------------------

def mlstm_init(dec, path: str, cfg: ModelConfig, stack: Tuple[int, ...] = ()) -> Params:
    d, nh = cfg.d_model, cfg.xlstm_heads
    return {
        "norm": rmsnorm_init(d, cfg.pdtype, dec.device, stack),
        "wq": dec.linear(f"{path}/wq", d, d, stack=stack),
        "wk": dec.linear(f"{path}/wk", d, d, stack=stack),
        "wv": dec.linear(f"{path}/wv", d, d, stack=stack),
        "wi": dec.linear(f"{path}/wi_gate", d, nh, stack=stack),
        "wf": dec.linear(f"{path}/wf_gate", d, nh, stack=stack),
        "wog": dec.linear(f"{path}/wo_gate", d, d, stack=stack),
        "wo": dec.linear(f"{path}/wo", d, d, stack=stack),
        "out_norm": rmsnorm_init(d, cfg.pdtype, dec.device, stack),
    }


def _mlstm_gates(ig, fg, m0):
    """The stabiliser and gate sequences of the step recurrence over all
    positions: (fe, ie, exp(-m_new), m_final), each (b, s, nh) but the last.
    ``m_new = max(log_f + m, i)`` runs position by position on (b, nh);
    ``fe = exp(log_f + m - m_new)``, ``ie = exp(i - m_new)`` and
    ``exp(-m_new)`` then come elementwise over every position at once, the
    same values the reference's step forms one position at a time."""
    log_f = F.logsigmoid(fg)
    m_prev, m = [], m0
    for t in range(ig.shape[1]):
        m_prev.append(m)
        m = torch.maximum(log_f[:, t] + m, ig[:, t])
    m_prev = torch.stack(m_prev, dim=1)
    m_new = torch.cat([m_prev[:, 1:], m[:, None]], dim=1)
    return (torch.exp(log_f + m_prev - m_new), torch.exp(ig - m_new), torch.exp(-m_new), m)


def _mlstm_step(carry, t_in):
    """One position of the matrix memory: (cm, nrm) and the gates of the
    position (from :func:`_mlstm_gates`) -> new (cm, nrm) and h."""
    cm, nrm = carry  # (b, nh, pv, pk), (b, nh, pk)
    qt, kt, vt, fe, ie, floor = t_in
    cm = fe[..., None, None] * cm + ie[..., None, None] * (vt[..., :, None] * kt[..., None, :])
    nrm = fe[..., None] * nrm + ie[..., None] * kt
    num = torch.einsum("bhvk,bhk->bhv", cm, qt)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", nrm, qt)), floor)
    return (cm, nrm), num / den[..., None]


def mlstm_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str = "full", state: Optional[Params] = None,
                policy=False) -> Tuple[torch.Tensor, Params]:
    """The mLSTM block over x (B, S, d) from ``state`` (zeros when None):
    one recurrence step a position, in every mode."""
    del mode  # the step recurrence serves train, prefill and decode alike
    b, s, d = x.shape
    nh = cfg.xlstm_heads
    hd = d // nh
    h_in = rmsnorm(p["norm"], x, cfg.norm_eps)
    q = linear(p["wq"], h_in, policy=policy).reshape(b, s, nh, hd)
    k = linear(p["wk"], h_in, policy=policy).reshape(b, s, nh, hd) * (hd ** -0.5)
    v = linear(p["wv"], h_in, policy=policy).reshape(b, s, nh, hd)
    ig = linear(p["wi"], h_in, policy=policy).float()  # (b, s, nh)
    fg = linear(p["wf"], h_in, policy=policy).float()

    if state is not None:
        carry = (state["c"].float(), state["n"].float(), state["m"].float())
    else:
        carry = (torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device),
                 torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device),
                 torch.full((b, nh), -1e30, dtype=torch.float32, device=x.device))
    qf, kf, vf = q.float(), k.float(), v.float()
    fe, ie, floor, m = _mlstm_gates(ig, fg, carry[2])
    carry, hs = carry[:2], []
    for t in range(s):
        carry, ht = _mlstm_step(carry, (qf[:, t], kf[:, t], vf[:, t], fe[:, t], ie[:, t],
                                        floor[:, t]))
        hs.append(ht)
    cm, nrm = carry
    h = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)

    og = torch.sigmoid(linear(p["wog"], h_in, policy=policy).float())
    h = rmsnorm(p["out_norm"], h, cfg.norm_eps) * og.to(x.dtype)
    out = linear(p["wo"], h, policy=policy)
    return out, {"c": cm.to(x.dtype), "n": nrm.to(x.dtype), "m": m}


def mlstm_init_state(cfg: ModelConfig, batch: int, dtype, device) -> Params:
    """Zero memory and normaliser in ``dtype``; the stabiliser ``m`` is
    float32 whatever ``dtype`` is."""
    nh = cfg.xlstm_heads
    hd = cfg.d_model // nh
    return {
        "c": torch.zeros((batch, nh, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros((batch, nh, hd), dtype=dtype, device=device),
        "m": torch.full((batch, nh), -1e30, dtype=torch.float32, device=device),
    }
