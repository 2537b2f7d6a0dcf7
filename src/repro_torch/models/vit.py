"""ViT for the paper's Table-4 experiment — the counterpart of
``repro/models/vit.py``.  The two FC layers inside each feed-forward block
and the patch-embedding FC are the layers the paper SVD-decomposes.

Blocks are stacked on a leading ``L`` axis and applied by a loop over it,
as ``lm_apply`` does.  As in the reference, every projection is a plain
``linear`` (an SVD pair is two plain products, no kernel), attention is a
non-causal float32 softmax in plain torch ops, and GELU is the tanh
approximation (``jax.nn.gelu``'s default; ``F.gelu``'s default is erf).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.decompose import Decomposer
from repro_torch.models.common import Params, layernorm, layernorm_init, linear
from repro_torch.models.lm import _layer

__all__ = ["vit_init", "vit_apply"]


def _generator(dec: Decomposer) -> torch.Generator:
    """The generator ``dec`` draws from (the device's default without one)."""
    if dec.generator is not None:
        return dec.generator
    if dec.device.type == "cuda":
        idx = dec.device.index if dec.device.index is not None else torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


def vit_init(dec: Decomposer, *, num_layers: int = 12, d: int = 768, heads: int = 12,
             d_ff: int = 3072, patch: int = 16, img: int = 224, num_classes: int = 10,
             dtype: torch.dtype = torch.float32) -> Params:
    """Params drawn from ``dec``'s generator in call order.  The reference
    draws wq, wk and wv from one key, so they start equal: here each is
    drawn from the same generator state."""
    del heads  # the layout does not depend on it, as in JAX
    n_patches = (img // patch) ** 2
    stack = (num_layers,)
    patch_embed = dec.linear("patch_embed", patch * patch * 3, d, bias=True, dtype=dtype)
    pos_emb = (dec.normal((1, n_patches + 1, d)) * 0.02).to(dtype)
    gen = _generator(dec)
    state = gen.get_state()
    qkv = {}
    for name in ("wq", "wk", "wv"):
        gen.set_state(state)
        qkv[name] = dec.linear(f"blocks/attn/{name}", d, d, bias=True, dtype=dtype,
                               stack=stack)
    blocks = {
        "norm1": layernorm_init(d, dtype, dec.device, stack),
        **qkv,
        "wo": dec.linear("blocks/attn/wo", d, d, bias=True, dtype=dtype, stack=stack),
        "norm2": layernorm_init(d, dtype, dec.device, stack),
        # the paper: "2 fully connected layers inside the feed forward"
        "wi": dec.linear("blocks/ffn/wi", d, d_ff, bias=True, dtype=dtype, stack=stack),
        "down": dec.linear("blocks/ffn/down", d_ff, d, bias=True, dtype=dtype, stack=stack),
    }
    return {
        "patch_embed": patch_embed,
        "pos_emb": pos_emb,
        "cls": torch.zeros((1, 1, d), dtype=dtype, device=dec.device),
        "blocks": blocks,
        "final_norm": layernorm_init(d, dtype, dec.device),
        "head": dec.linear("head", d, num_classes, bias=True, dtype=dtype),
    }


def vit_apply(p: Params, images: torch.Tensor, *, heads: int = 12,
              patch: int = 16) -> torch.Tensor:
    """images: (B, H, W, 3) -> logits."""
    b, hh, ww, _ = images.shape
    ph, pw = hh // patch, ww // patch
    x = images.reshape(b, ph, patch, pw, patch, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, ph * pw, patch * patch * 3)
    h = linear(p["patch_embed"], x)
    d = h.shape[-1]
    h = torch.cat([p["cls"].to(h.dtype).expand(b, 1, d), h], dim=1)
    h = h + p["pos_emb"].to(h.dtype)
    hd = d // heads
    blocks = p["blocks"]
    for l in range(blocks["norm1"]["scale"].shape[0]):
        lp = _layer(blocks, l)
        a_in = layernorm(lp["norm1"], h)
        q = linear(lp["wq"], a_in).reshape(b, -1, heads, hd) * (hd ** -0.5)
        k = linear(lp["wk"], a_in).reshape(b, -1, heads, hd)
        v = linear(lp["wv"], a_in).reshape(b, -1, heads, hd)
        att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v.float()).to(h.dtype)
        h = h + linear(lp["wo"], o.reshape(b, -1, d))
        f_in = layernorm(lp["norm2"], h)
        f = F.gelu(linear(lp["wi"], f_in).float(), approximate="tanh").to(h.dtype)
        h = h + linear(lp["down"], f)
    h = layernorm(p["final_norm"], h)
    return linear(p["head"], h[:, 0])
