"""Plain PyTorch versions of the hand-written kernels.

They keep the JAX oracles' and TPU kernels' rounding points
(``repro/kernels/ref.py``, ``repro/kernels/lowrank_bwd.py``): every
product accumulates in float32, and the rank-r intermediate (``t = x U``
forward and in dV, ``dt = dy Vᵀ`` in dx and dU) is rounded to the
activation's dtype before the second product.  The operands are widened to
float32 explicitly, so the result does not depend on the backend's
reduced-precision settings.  The CPU path of the dispatcher runs these, and
``chip_smoke.py`` holds each kernel against them on the card.

:func:`flash_attention_fwd_ref` is the plain version of K8 with K8's
signature and arithmetic (``repro/kernels/flash_attention.py``).

The int8 versions (K6, K7) compute their int8 x int8 products exactly:
the operands go through float64, where every product and every partial sum
of up to 2**53 is exact (|sum| <= 2560 * 127**2 < 2**31 here), because
``torch.matmul`` has no int32 product on CUDA.  Their serving entries'
versions (:func:`int8_linear_ref`, :func:`int8_lowrank_linear_ref`) are
the JAX dispatchers' algebra: :func:`quantize_rowwise` on x, the int8
product, then the scales, each one float32 operation in that order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["lowrank_matmul_ref", "lowrank_gated_ffn_ref", "lowrank_matmul_dx_ref",
           "lowrank_matmul_du_ref", "lowrank_matmul_dv_ref", "int8_matmul_ref",
           "int8_lowrank_matmul_ref", "int8_linear_ref", "int8_lowrank_linear_ref",
           "quantize_rowwise", "quantize_colwise", "over_127", "flash_attention_fwd_ref"]


def lowrank_matmul_ref(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = (x @ U) @ V with float32 accumulation — the decomposed linear."""
    t = torch.matmul(x.float(), u.float()).to(x.dtype)
    return torch.matmul(t.float(), v.float()).to(x.dtype)


def lowrank_gated_ffn_ref(x: torch.Tensor, gu: torch.Tensor, gv: torch.Tensor,
                          uu: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """silu((x Ug) Vg) * ((x Uu) Vu) — the low-rank SwiGLU first half.

    Each branch is rounded to x's dtype before the float32 epilogue, as the
    unfused model path does (the fused kernel keeps both in float32)."""
    g = lowrank_matmul_ref(x, gu, gv)
    up = lowrank_matmul_ref(x, uu, uv)
    return (F.silu(g.float()) * up.float()).to(x.dtype)


def lowrank_matmul_dx_ref(dy: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """dx = (dy @ Vᵀ) @ Uᵀ: dy (M, S), u (C, r), v (r, S) -> (M, C) in dy's
    dtype, with dt rounded to dy's dtype (lowrank_bwd.py:75)."""
    dt = torch.matmul(dy.float(), v.float().T).to(dy.dtype)
    return torch.matmul(dt.float(), u.float().T).to(dy.dtype)


def lowrank_matmul_du_ref(x: torch.Tensor, dy: torch.Tensor, v: torch.Tensor, *,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dU = xᵀ @ (dy @ Vᵀ): x (M, C), dy (M, S), v (r, S) -> (C, r), with dt
    rounded to x's dtype (lowrank_bwd.py:203); ``out_dtype`` is the primal
    u's dtype (default v's)."""
    dt = torch.matmul(dy.float(), v.float().T).to(x.dtype)
    return torch.matmul(x.float().T, dt.float()).to(out_dtype or v.dtype)


def lowrank_matmul_dv_ref(x: torch.Tensor, u: torch.Tensor, dy: torch.Tensor, *,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dV = (x @ U)ᵀ @ dy: x (M, C), u (C, r), dy (M, S) -> (r, S), with t
    rounded to x's dtype (lowrank_bwd.py:286); ``out_dtype`` is the primal
    v's dtype (default u's)."""
    t = torch.matmul(x.float(), u.float()).to(x.dtype)
    return torch.matmul(t.float().T, dy.float()).to(out_dtype or u.dtype)


def over_127(a: torch.Tensor) -> torch.Tensor:
    """a / 127 as one IEEE division on every device: on CUDA, PyTorch turns
    a division by a Python scalar into a multiplication by its reciprocal,
    which can differ by one ulp from the TPU kernel's and the CUDA kernel's
    division."""
    return a / a.new_full((), 127.0)


def quantize_rowwise(x: torch.Tensor):
    """Dynamic per-row symmetric int8: (values int8, scales float32 (..., 1))."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(over_127(amax), min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_colwise(w: torch.Tensor):
    """Static per-output-column symmetric int8 for weights and factors:
    (values int8, scales float32 (..., 1, S))."""
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)
    scale = torch.clamp(over_127(amax), min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact x_q (M, C) @ w_q (C, S) for int8 operands -> int32 (M, S)."""
    return torch.matmul(x_q.double(), w_q.double()).to(torch.int32)


def int8_lowrank_matmul_ref(x_q: torch.Tensor, u_q: torch.Tensor, u_scale: torch.Tensor,
                            v_q: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
    """The fused int8 low-rank product, step by step as the TPU kernel
    (int8_matmul.py ``_lowrank_kernel``) takes it: t = int32(x_q u_q) *
    u_scale; each row of t requantized to int8 by its max |t| (floored at
    1e-8) / 127, rounding half to even; y = int32(tq v_q); out = (y * ts) *
    v_scale.  x_q (M, C), u_q (C, r), u_scale (1, r), v_q (r, S), v_scale
    (1, S) -> float32 (M, S) in x_q's units."""
    t = int8_matmul_ref(x_q, u_q).float() * u_scale.float()
    tmax = torch.clamp(torch.amax(torch.abs(t), dim=1, keepdim=True), min=1e-8)
    ts = over_127(tmax)
    tq = torch.clamp(torch.round(t / ts), -127, 127).to(torch.int8)
    y = int8_matmul_ref(tq, v_q).float()
    return y * ts * v_scale.float()


def int8_linear_ref(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """K6's serving entry: x (M, C) quantized per row, the exact int32
    product with w_q (C, S), then ``(acc * x_scale) * w_scale`` (1, S),
    rounded once to x's dtype."""
    x_q, x_scale = quantize_rowwise(x)
    acc = int8_matmul_ref(x_q, w_q)
    return (acc.float() * x_scale * w_scale.float()).to(x.dtype)


def int8_lowrank_linear_ref(x: torch.Tensor, u_q: torch.Tensor, u_scale: torch.Tensor,
                            v_q: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
    """K7's serving entry: x (M, C) quantized per row, then
    :func:`int8_lowrank_matmul_ref` times the x scales, rounded once to x's
    dtype (the per-row x scales factor out of the rank-r requantization)."""
    x_q, x_scale = quantize_rowwise(x)
    y = int8_lowrank_matmul_ref(x_q, u_q, u_scale, v_q, v_scale)
    return (y * x_scale).to(x.dtype)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, q_scale: float = 1.0) -> torch.Tensor:
    """K8's plain version: q (B, Sq, H, D), k (B, Sk, KV, D), v (B, Sk, KV,
    Dv) -> (B, Sq, H, Dv) in q's dtype; q head h reads kv head h // (H / KV).

    The TPU kernel's arithmetic in its order (flash_attention.py:37-76),
    with every kv block at once: q times ``q_scale`` rounded to q's dtype
    (``_flash_path``'s undo of the projection's pre-scale, attention.py:193;
    skipped at 1.0), logits (q k^T) in float32 times D**-0.5, -1e30 where
    key > query (positions counted from 0 for both) under ``causal``,
    m = row max, p = exp(s - m) in float32, l = sum p, acc = p cast to v's
    dtype times v summed in float32, out = acc / max(l, 1e-30)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"flash_attention: {h} q heads are not a multiple of {kvh} kv heads")
    g = h // kvh
    if q_scale != 1.0:
        q = q * torch.tensor(q_scale, dtype=q.dtype, device=q.device)
    qg = q.reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k.float())
    s = s * torch.tensor(d ** -0.5, dtype=torch.float32, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), v.float())
    l = l.permute(0, 3, 1, 2)[..., None]  # (b, q, kv, g, 1)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
