"""Shared layer primitives: linear (dense or LRD-factorised), norms,
embeddings, RoPE, FFN and the loss — the counterparts of
``repro/models/common.py``.

``linear`` is the dispatch point of the paper's technique: a param group
with a ``kernel`` runs dense, one with ``u``/``v`` runs the factorised path
through :func:`repro_torch.kernels.ops.lowrank_apply`, and the int8 groups
of the serving export (``kernel_q`` or ``u_q``/``v_q`` with float32 scales)
run through ``ops.int8_apply`` (K6) or ``ops.int8_lowrank_apply`` (K7).  Products that the
JAX code accumulates in float32 widen their operands to float32 here, so
the rounding points do not depend on the backend's reduced-precision
settings.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

Params = Dict[str, Any]


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in float64 if it is float64 (a reference run)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def dot32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 operands and result (JAX ``preferred_element_type``;
    float64 operands stay float64)."""
    return torch.matmul(wide(a), wide(b))


def linear(p: Params, x: torch.Tensor, *,
           policy: "bool | kops.KernelPolicy" = False) -> torch.Tensor:
    """y = x @ W (+ b), where W may be factorised as u @ v (LRD)."""
    pol = kops.as_policy(policy)
    if "kernel" in p:
        y = dot32(x, p["kernel"]).to(x.dtype)
    elif "kernel_q" in p:
        y = _int8_dense(p, x, pol)
    elif "u_q" in p:
        y = _int8_lowrank(p, x, pol)
    else:
        y = kops.lowrank_apply(x, p["u"], p["v"], use_kernel=pol.use_kernel,
                               freeze_group=pol.freeze_group, autotune=pol.autotune)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _dequant_bf16(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale.float()).to(torch.bfloat16)


def _int8_dense(p: Params, x: torch.Tensor, pol: "kops.KernelPolicy") -> torch.Tensor:
    """An int8-exported dense kernel.  ``int8_decode="native"`` consumes the
    int8 values directly (K6 through ``ops.int8_apply``); ``"bf16"`` is the
    round trip that dequantizes the whole weight and runs a bf16 product,
    kept as the serving baseline."""
    if pol.int8_decode == "bf16":
        w = _dequant_bf16(p["kernel_q"], p["kernel_scale"])
        return dot32(x.to(torch.bfloat16), w).to(x.dtype)
    return kops.int8_apply(x, p["kernel_q"], p["kernel_scale"], use_kernel=pol.use_kernel)


def _int8_lowrank(p: Params, x: torch.Tensor, pol: "kops.KernelPolicy") -> torch.Tensor:
    """An int8-exported factor pair, with :func:`_int8_dense`'s decode
    modes; the native path is K7 through ``ops.int8_lowrank_apply``."""
    if pol.int8_decode == "bf16":
        u = _dequant_bf16(p["u_q"], p["u_scale"])
        v = _dequant_bf16(p["v_q"], p["v_scale"])
        t = dot32(x.to(torch.bfloat16), u).to(torch.bfloat16)
        return dot32(t, v).to(x.dtype)
    return kops.int8_lowrank_apply(x, p["u_q"], p["u_scale"], p["v_q"], p["v_scale"],
                                   use_kernel=pol.use_kernel)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device, stack: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones(stack + (d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, device, stack: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones(stack + (d,), dtype=dtype, device=device),
            "ln_bias": torch.zeros(stack + (d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """float32 statistics; the population variance, as ``jnp.var``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["ln_bias"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# Embeddings
# --------------------------------------------------------------------------

def embedding_init(dec, vocab: int, d: int, dtype) -> Params:
    return {"embedding": (dec.normal((vocab, d)) * 0.01).to(dtype)}


def mask_vocab(logits: torch.Tensor, true_vocab: int) -> torch.Tensor:
    """-1e30 on the padded vocab tail."""
    if logits.shape[-1] == true_vocab:
        return logits
    iota = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(iota < true_vocab, logits, torch.full_like(logits, -1e30))


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens.long()]


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_table(seq_len: int, head_dim: int, theta: float, *, device,
               positions: Optional[torch.Tensor] = None):
    """(cos, sin) tables, each (..., S, head_dim/2), float32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))
    if positions is None:
        positions = torch.arange(seq_len, dtype=torch.float32, device=device)
    else:
        positions = positions.float()
    ang = positions[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2).  Half-split rotation."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------

def ffn_init(dec, path: str, d: int, f: int, activation: str, dtype,
             stack: Tuple[int, ...] = ()) -> Params:
    if activation == "swiglu":
        return {
            "gate": dec.linear(f"{path}/gate", d, f, dtype=dtype, stack=stack),
            "up": dec.linear(f"{path}/up", d, f, dtype=dtype, stack=stack),
            "down": dec.linear(f"{path}/down", f, d, dtype=dtype, stack=stack),
        }
    return {
        "wi": dec.linear(f"{path}/wi", d, f, dtype=dtype, stack=stack),
        "down": dec.linear(f"{path}/down", f, d, dtype=dtype, stack=stack),
    }


def ffn(p: Params, x: torch.Tensor, *,
        policy: "bool | kops.KernelPolicy" = False) -> torch.Tensor:
    pol = kops.as_policy(policy)
    if "gate" in p:
        gate, up = p["gate"], p["up"]
        if "u" in gate and "u" in up and "bias" not in gate and "bias" not in up:
            # Both branches factorised: the fused SwiGLU first half (K5).
            # int8-exported branches (u_q) go through linear one by one.
            h = kops.lowrank_ffn_apply(x, gate["u"], gate["v"], up["u"], up["v"],
                                       use_kernel=pol.use_kernel,
                                       freeze_group=pol.freeze_group, autotune=pol.autotune)
        else:
            g = linear(gate, x, policy=pol)
            u = linear(up, x, policy=pol)
            h = (F.silu(g.float()) * u.float()).to(x.dtype)
    else:
        h = F.gelu(linear(p["wi"], x, policy=pol).float(), approximate="tanh").to(x.dtype)
    return linear(p["down"], h, policy=pol)


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL with a float32 log-softmax (float64 for float64
    logits); with ``mask``, the mean over the positions it weights (at
    least one)."""
    lf = wide(logits)
    nll = torch.logsumexp(lf, dim=-1) - torch.gather(
        lf, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
