"""int8-quantized KV cache — the counterpart of ``repro/models/kvcache.py``.

Values are stored as int8 with one bf16 scale per (batch, position,
kv_head): ``scale = max(amax / 127, 1e-8)`` over the head vector,
``q = clip(round(x / scale), -127, 127)``.  As in the reference, x is
quantized with the float32 scale, and the scale is stored in bf16 after.
``amax / 127`` is one IEEE division (``ref.over_127``), and
``torch.round`` rounds half to even like ``jnp.round``, so the values
equal the reference's bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ref import over_127

__all__ = ["quantize_kv", "dequantize_kv", "init_quantized_kv", "update_quantized_kv"]


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) -> (int8 values, bf16 scales (..., 1))."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(over_127(amax), min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def init_quantized_kv(stack: Tuple[int, ...], batch: int, length: int, kv_heads: int,
                      head_dim: int, device) -> dict:
    vals = stack + (batch, length, kv_heads, head_dim)
    scales = stack + (batch, length, kv_heads, 1)
    return {
        "k": torch.zeros(vals, dtype=torch.int8, device=device),
        "v": torch.zeros(vals, dtype=torch.int8, device=device),
        "k_scale": torch.zeros(scales, dtype=torch.bfloat16, device=device),
        "v_scale": torch.zeros(scales, dtype=torch.bfloat16, device=device),
    }


def write_rows(leaf: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> None:
    """Write ``new`` (B, S, ...) into ``leaf`` (B, Smax, ...) in place at
    positions start[b] .. start[b]+S-1 of each row; ``start`` is (B,) or
    one position for every row."""
    b, s = new.shape[0], new.shape[1]
    rows = start.reshape(-1).long().to(leaf.device).expand(b)
    positions = rows[:, None] + torch.arange(s, device=leaf.device)[None, :]
    leaf[torch.arange(b, device=leaf.device)[:, None], positions] = new.to(leaf.dtype)


def update_quantized_kv(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                        start) -> dict:
    """Quantize one step's k/v (B, S, KV, hd) and write it in place at
    ``start``: a scalar (every row at one position, the fixed-batch decode)
    or a (B,) vector of per-row positions.  Returns ``cache``, whose
    leaves the JAX version returns updated copies of."""
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    start = torch.as_tensor(start)
    for name, val in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
        write_rows(cache[name], val, start)
    return cache
