"""Decoder-LM assembly for the dense family — the counterpart of
``repro/models/lm.py``.

Layers are stacked (every leaf carries a leading ``L`` dim, built directly
by ``Decomposer(..., stack=(L,))``) and applied by a Python loop over that
axis, where the JAX code scans.  A layer's params are views of the stacked
leaves (``p["u"][l]``), so nothing is copied per layer.

``mode``: ``"full"`` (prefill: returns the per-layer k/v stacked on ``L``),
``"train"`` (``"full"`` with no cache kept, run with grad enabled) or
``"decode"`` (one token or chunk per row against a paged or contiguous
cache, which is updated in place and returned; :func:`init_cache` makes
the contiguous one).  Activation checkpointing is not ported:
``remat`` other than ``"none"`` raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.decompose import Decomposer
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.models.attention import gqa_apply, gqa_init
from repro_torch.models.kvcache import init_quantized_kv
from repro_torch.models.common import (Params, dot32, embed, embedding_init,
                                       ffn, ffn_init, linear, mask_vocab, rmsnorm,
                                       rmsnorm_init, rope_table)

_REMAT_TODO = ("activation checkpointing (remat) is not ported yet "
               "(ROADMAP queue 1 item 11, activation checkpointing)")
_FAMILIES_TODO = ("other model families (MoE, MLA, SSM, hybrid, VLM, enc-dec) "
                  "are not ported yet (ROADMAP queue 1 item 7, other model families)")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.use_mla or cfg.num_experts or cfg.use_mtp:
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): {_FAMILIES_TODO}")


def _layer(tree: Any, l: int) -> Any:
    """Layer ``l`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


# --------------------------------------------------------------------------
# Decoder layer
# --------------------------------------------------------------------------

def decoder_layer_init(dec: Decomposer, path: str, cfg: ModelConfig, *,
                       stack=()) -> Params:
    _check_family(cfg)
    return {
        "norm1": rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device, stack),
        "attn": gqa_init(dec, f"{path}/attn", cfg, stack=stack),
        "norm2": rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device, stack),
        "ffn": ffn_init(dec, f"{path}/ffn", cfg.d_model, cfg.dense_d_ff or cfg.d_ff,
                        cfg.ffn_activation, cfg.pdtype, stack=stack),
    }


def decoder_layer_apply(lp: Params, h: torch.Tensor, cfg: ModelConfig, *, rope,
                        mode: str, cache: Optional[Params], pos, policy=False):
    a_in = rmsnorm(lp["norm1"], h, cfg.norm_eps)
    a_out, new_cache = gqa_apply(lp["attn"], a_in, cfg, rope=rope, mode=mode,
                                 cache=cache, pos=pos, policy=policy)
    h = h + a_out
    f_in = rmsnorm(lp["norm2"], h, cfg.norm_eps)
    h = h + ffn(lp["ffn"], f_in, policy=policy)
    return h, new_cache


# --------------------------------------------------------------------------
# Model init / forward
# --------------------------------------------------------------------------

def lm_init(cfg: ModelConfig, dec: Decomposer) -> Params:
    """Params of a dense decoder LM, drawn from ``dec``'s generator."""
    _check_family(cfg)
    p: Params = {"embed": embedding_init(dec, cfg.vocab_padded, cfg.d_model, cfg.pdtype)}
    p["stack"] = decoder_layer_init(dec, "layers", cfg, stack=(cfg.num_layers,))
    p["final_norm"] = rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device)
    if not cfg.tie_embeddings:
        p["unembed"] = dec.linear("unembed", cfg.d_model, cfg.vocab_padded)
    return p


def lm_apply(p: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
             mode: str = "full", cache: Optional[Params] = None, pos=None,
             policy: "bool | KernelPolicy" = False, remat: str = "none"):
    """Returns (logits float32 (B, S, V), new_cache, aux); ``new_cache`` is
    None in ``mode="train"``."""
    _check_family(cfg)
    if mode not in ("full", "train", "decode"):
        raise ValueError(f"mode must be 'full', 'train' or 'decode', got {mode!r}")
    if remat != "none":
        raise ValueError(f"remat={remat!r}: {_REMAT_TODO}")
    train = mode == "train"
    mode = "full" if train else mode
    s = tokens.shape[1]
    h = embed(p["embed"], tokens).to(cfg.cdtype)
    rope = _make_rope(cfg, s, mode, pos, h.device)
    stacked = p["stack"]
    n_layers = stacked["norm1"]["scale"].shape[0]
    layer_cache = cache["stack"] if cache is not None else None
    ks, vs = [], []
    for l in range(n_layers):
        lc = _layer(layer_cache, l) if layer_cache is not None else None
        h, nc = decoder_layer_apply(_layer(stacked, l), h, cfg, rope=rope, mode=mode,
                                    cache=lc, pos=pos, policy=policy)
        if mode == "full" and not train:
            ks.append(nc["k"])
            vs.append(nc["v"])
    new_cache: Optional[Dict[str, Any]] = (
        None if train
        else {"stack": {"k": torch.stack(ks), "v": torch.stack(vs)}} if mode == "full"
        else cache)
    h = rmsnorm(p["final_norm"], h, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = dot32(h, p["embed"]["embedding"].T)
    else:
        logits = linear(p["unembed"], h, policy=policy).float()
    logits = mask_vocab(logits, cfg.vocab_size)
    return logits, new_cache, torch.zeros((), dtype=torch.float32, device=h.device)


def _make_rope(cfg: ModelConfig, s: int, mode: str, pos, device):
    hd = cfg.resolved_head_dim
    if mode == "full":
        return rope_table(s, hd, cfg.rope_theta, device=device)
    pos_arr = torch.as_tensor(pos, device=device).reshape(-1)
    offsets = torch.arange(s, device=device)
    if pos_arr.numel() > 1:
        # per-slot positions: (B, s, hd/2) tables, one row per slot
        positions = pos_arr[:, None] + offsets[None, :]
    else:
        positions = pos_arr[:1] + offsets
    return rope_table(s, hd, cfg.rope_theta, device=device, positions=positions)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=None) -> Params:
    """The contiguous decode cache of the fixed-batch path: per layer
    ``(L, batch, max_len, KV, hd)`` k/v in ``dtype`` (default the compute
    dtype), or int8 values with bf16 per-position scales when
    ``cfg.kv_cache_dtype == "int8"``."""
    _check_family(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"stack": init_quantized_kv(shape[:1], *shape[1:], device=device)}
    dtype = dtype or cfg.cdtype
    return {"stack": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}}
