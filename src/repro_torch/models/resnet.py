"""ResNet-50/101/152, the paper's own experimental models (Tables 1-3) — the
counterpart of ``repro/models/resnet.py``.

The tree is the reference's: HWIO conv kernels ``(k, k, C, S)``, a Tucker
triple ``first (C, r1)``, ``core (k, k, r1, r2)``, ``last (r2, S)`` or an
SVD pair ``u (C, r)``, ``v (r, S)``, and BatchNorm folded into a per-channel
``scale`` / ``bn_bias``.  Activations are NHWC, as in JAX.  A conv hands
cuDNN the NCHW view of the NHWC tensor (``permute(0, 3, 1, 2)``, which is
``channels_last`` in memory) and the kernel as an OIHW ``channels_last``
copy, so cuDNN runs its NHWC kernels on the activations without copying
them.

Three things keep the port on the reference's numbers:

* **SAME padding.**  XLA pads ``total = max((ceil(n/s) - 1) s + k - n, 0)``
  as ``lo = total // 2`` before and the rest after, which is asymmetric for
  a stride-2 conv on an even size (the 7x7 stem on 224: (2, 3); a strided
  3x3 on 56: (0, 1)).  ``F.conv2d(padding=k // 2)`` gives the same output
  size with the window shifted, so asymmetric padding is applied with
  ``F.pad`` first; the 3x3/2 max-pool pads with ``-inf`` the same way.
* **float32 convs.**  The reference computes every conv in float32;
  cuDNN would use TF32 by default.  :func:`conv_apply` runs its convs
  under :func:`fp32_convs`; a conv's backward reads the flag when the
  backward runs, so a train step runs its backward under
  :func:`fp32_convs` too.
* **The strided SVD 1x1 path** subsamples x before ``x @ u`` where JAX
  subsamples after: the same values for a quarter of the work.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.decompose import Decomposer
from repro_torch.models.common import Params, dot32, linear

__all__ = ["STAGES", "fp32_convs", "same_pads", "conv_apply", "max_pool_same",
           "bottleneck_init", "bottleneck_apply", "resnet_init", "resnet_apply"]

STAGES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


@contextlib.contextmanager
def fp32_convs():
    """cuDNN convs in float32 (TF32 off) while open; the caller's other
    cuDNN settings (``benchmark``, ``deterministic``) stay as they are."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (before, after) of one spatial axis of size ``n``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int, value: float = 0.0):
    """(x, padding) for a SAME window op on NHWC ``x``: symmetric padding is
    left to the op, asymmetric padding is applied here."""
    (top, bottom) = same_pads(x.shape[1], kh, stride)
    (left, right) = same_pads(x.shape[2], kw, stride)
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (0, 0, left, right, top, bottom), value=value), (0, 0)


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME conv of NHWC ``x`` with an HWIO ``kernel``, in float32; NHWC out."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    x, padding = _pad_same(x.float(), kh, kw, stride)
    w = kernel.float().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    with fp32_convs():
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_apply(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: NHWC.  Dense kernel, Tucker triple {first, core, last} or SVD u/v,
    then the folded BN; computed in float32, returned in x's dtype."""
    if "kernel" in p:
        y = _conv(x, p["kernel"], stride)
    elif "first" in p:  # Tucker-2: 1x1 -> kxk core -> 1x1 (paper Fig. 1)
        y = _conv(dot32(x, p["first"]), p["core"], stride)
        y = dot32(y, p["last"])
    else:  # SVD pair (1x1 conv == FC), subsampled first
        if stride > 1:
            x = x[:, ::stride, ::stride]
        y = dot32(dot32(x, p["u"]), p["v"])
    if "scale" in p:  # folded BN
        y = y * p["scale"].float() + p["bn_bias"].float()
    return y.to(x.dtype)


def max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """XLA's ``reduce_window(max, -inf, SAME)`` on NHWC ``x``."""
    x, padding = _pad_same(x, k, k, stride, value=float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, padding=padding).permute(0, 2, 3, 1)


def _conv_init(dec: Decomposer, path: str, c: int, s: int, k: int, dtype, *,
               bn: bool = True) -> Params:
    p = dec.conv(path, c, s, k, dtype=dtype)
    if bn:
        p["scale"] = torch.ones((s,), dtype=dtype, device=dec.device)
        p["bn_bias"] = torch.zeros((s,), dtype=dtype, device=dec.device)
    return p


def bottleneck_init(dec: Decomposer, path: str, c_in: int, c_mid: int, dtype) -> Params:
    c_out = c_mid * 4
    p = {
        "conv1x1_a": _conv_init(dec, f"{path}/conv1x1_a", c_in, c_mid, 1, dtype),
        "conv3x3": _conv_init(dec, f"{path}/conv3x3", c_mid, c_mid, 3, dtype),
        "conv1x1_b": _conv_init(dec, f"{path}/conv1x1_b", c_mid, c_out, 1, dtype),
    }
    if c_in != c_out:
        p["shortcut"] = _conv_init(dec, f"{path}/shortcut", c_in, c_out, 1, dtype)
    return p


def bottleneck_apply(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = F.relu(conv_apply(p["conv1x1_a"], x))
    h = F.relu(conv_apply(p["conv3x3"], h, stride))
    h = conv_apply(p["conv1x1_b"], h)
    sc = conv_apply(p["shortcut"], x, stride) if "shortcut" in p else (
        x if stride == 1 else x[:, ::stride, ::stride])
    return F.relu(h + sc)


def resnet_init(variant: str, num_classes: int, dec: Decomposer,
                dtype: torch.dtype = torch.float32) -> Params:
    """Params of ``variant`` drawn from ``dec``'s generator in call order."""
    stages = STAGES[variant]
    p: Params = {"conv_stem": _conv_init(dec, "conv_stem", 3, 64, 7, dtype)}
    c_in = 64
    for si, (blocks, c_mid) in enumerate(zip(stages, (64, 128, 256, 512))):
        for bi in range(blocks):
            p[f"s{si}b{bi}"] = bottleneck_init(dec, f"stage{si}/block{bi}", c_in, c_mid, dtype)
            c_in = c_mid * 4
    p["fc"] = dec.linear("fc", c_in, num_classes, bias=True, dtype=dtype)
    return p


def resnet_apply(p: Params, x: torch.Tensor, variant: str) -> torch.Tensor:
    """x: (B, H, W, 3) -> logits (B, num_classes)."""
    stages = STAGES[variant]
    h = F.relu(conv_apply(p["conv_stem"], x, stride=2))
    h = max_pool_same(h)
    for si, blocks in enumerate(stages):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            h = bottleneck_apply(p[f"s{si}b{bi}"], h, stride)
    h = torch.mean(h, dim=(1, 2))
    return linear(p["fc"], h)
