"""Encoder-decoder backbone (seamless-m4t-medium) — the counterpart of
``repro/models/encdec.py``.

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, frames, d_model) and is a non-causal
transformer over them; the decoder is a causal transformer whose layers
add a tanh-gated cross-attention block over the encoder's memory.
LayerNorm and a GELU FFN throughout, RoPE on the decoder's self-attention
only.  Layers are stacked on a leading ``L`` axis and run by
``lm._run_stack``, so ``remat`` applies as for the decoder LMs (in
``mode="train"`` only).

``decode`` modes: ``"full"`` (prefill: returns the decoder's self k/v and
the cross k/v of the memory, each stacked on ``L``), ``"train"``
(``"full"`` with no cache kept) and ``"decode"`` (one token per row
against the contiguous cache of :func:`encdec_init_cache`, or a prefill's
cache padded to the window with its cross entries left at the memory's
length; the self k/v are written in place, the cross k/v only read).  The
decode step's RoPE position is the first row's, as the reference's.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.decompose import Decomposer
from repro_torch.models.attention import gqa_apply, gqa_init
from repro_torch.models.common import (Params, embed, embedding_init, ffn, ffn_init,
                                       layernorm, layernorm_init, linear, mask_vocab,
                                       rope_table)
from repro_torch.models.lm import _layer, _run_stack, _zero, check_remat

__all__ = ["encdec_init", "encode", "decode", "encdec_init_cache"]


def _enc_layer_init(dec: Decomposer, cfg: ModelConfig, stack) -> Params:
    ln = functools.partial(layernorm_init, cfg.d_model, cfg.pdtype, dec.device, stack)
    return {
        "norm1": ln(),
        "attn": gqa_init(dec, "enc/attn", cfg, stack=stack),
        "norm2": ln(),
        "ffn": ffn_init(dec, "enc/ffn", cfg.d_model, cfg.d_ff, "gelu", cfg.pdtype,
                        stack=stack),
    }


def _dec_layer_init(dec: Decomposer, cfg: ModelConfig, stack) -> Params:
    ln = functools.partial(layernorm_init, cfg.d_model, cfg.pdtype, dec.device, stack)
    return {
        "norm1": ln(),
        "self_attn": gqa_init(dec, "dec/self_attn", cfg, stack=stack),
        "norm_x": ln(),
        "cross_attn": gqa_init(dec, "dec/cross_attn", cfg, cross=True, stack=stack),
        "norm2": ln(),
        "ffn": ffn_init(dec, "dec/ffn", cfg.d_model, cfg.d_ff, "gelu", cfg.pdtype,
                        stack=stack),
    }


def encdec_init(cfg: ModelConfig, dec: Decomposer) -> Params:
    """Params of an encoder-decoder model, drawn from ``dec``'s generator
    (the reference's tree: ``enc_stack``, ``dec_stack``, a dense
    ``unembed``)."""
    n_enc = cfg.num_encoder_layers or cfg.num_layers
    return {
        "embed": embedding_init(dec, cfg.vocab_padded, cfg.d_model, cfg.pdtype),
        "enc_stack": _enc_layer_init(dec, cfg, (n_enc,)),
        "dec_stack": _dec_layer_init(dec, cfg, (cfg.num_layers,)),
        "enc_norm": layernorm_init(cfg.d_model, cfg.pdtype, dec.device),
        "dec_norm": layernorm_init(cfg.d_model, cfg.pdtype, dec.device),
        "unembed": dec.linear("unembed", cfg.d_model, cfg.vocab_padded),
    }


def _n_layers(stacked: Params) -> int:
    return stacked["norm1"]["scale"].shape[0]


def encode(p: Params, frames: torch.Tensor, cfg: ModelConfig, *,
           remat: str = "none") -> torch.Tensor:
    """frames: (B, T, d) stub frontend embeddings -> the encoder memory (B,
    T, d) in the compute dtype.  The factorised products run with the
    kernels off, as the reference's ``encode`` (its callers give it no
    kernel policy); only ``attention_impl="flash"`` reaches a kernel."""
    check_remat(remat)
    h = frames.to(cfg.cdtype)

    def body(lp, hh):
        a_out, _ = gqa_apply(lp["attn"], layernorm(lp["norm1"], hh, cfg.norm_eps), cfg,
                             mode="full", causal=False)
        hh = hh + a_out
        hh = hh + ffn(lp["ffn"], layernorm(lp["norm2"], hh, cfg.norm_eps))
        return hh, _zero(hh)

    stacked = p["enc_stack"]
    h, _ = _run_stack(stacked, h, body, _n_layers(stacked), remat)
    return layernorm(p["enc_norm"], h, cfg.norm_eps)


def _dec_layer(lp, h, memory, cfg: ModelConfig, *, rope, mode: str, cache, pos, policy):
    """One decoder layer: (h, {"self": k/v, "cross": k/v} or the cache)."""
    self_c, cross_c = (cache["self"], cache["cross"]) if cache else (None, None)
    a_out, self_nc = gqa_apply(lp["self_attn"], layernorm(lp["norm1"], h, cfg.norm_eps), cfg,
                               rope=rope, mode=mode, cache=self_c, pos=pos, policy=policy)
    h = h + a_out
    x_out, cross_nc = gqa_apply(lp["cross_attn"], layernorm(lp["norm_x"], h, cfg.norm_eps),
                                cfg, mode=mode, cache=cross_c, kv_src=memory, policy=policy)
    h = h + x_out
    h = h + ffn(lp["ffn"], layernorm(lp["norm2"], h, cfg.norm_eps), policy=policy)
    return h, {"self": self_nc, "cross": cross_nc}


def decode(p: Params, tokens: torch.Tensor, memory: Optional[torch.Tensor],
           cfg: ModelConfig, *, mode: str = "full", cache: Optional[Params] = None, pos=None,
           remat: str = "none", policy=False):
    """tokens: (B, S); memory: (B, T, d), the encoder's output, needed in
    ``"full"`` and ``"train"`` mode (in ``"decode"`` mode the cross blocks
    read their k/v from the cache, and ``memory`` may be None).  Returns
    (float32 logits (B, S, V), new cache or None in ``"train"`` mode)."""
    if mode not in ("full", "train", "decode"):
        raise ValueError(f"mode must be 'full', 'train' or 'decode', got {mode!r}")
    check_remat(remat)
    if memory is None and mode != "decode":
        raise ValueError(f"decode in {mode!r} mode needs the encoder memory")
    train = mode == "train"
    attn_mode = "full" if train else mode
    s = tokens.shape[1]
    h = embed(p["embed"], tokens).to(cfg.cdtype)
    hd = cfg.resolved_head_dim
    if attn_mode == "full":
        rope = rope_table(s, hd, cfg.rope_theta, device=h.device)
    else:
        first = torch.as_tensor(pos, device=h.device).reshape(-1)[:1]
        rope = rope_table(1, hd, cfg.rope_theta, device=h.device, positions=first)
    stacked = p["dec_stack"]
    n_layers = _n_layers(stacked)
    layer = functools.partial(_dec_layer, cfg=cfg, rope=rope, mode=attn_mode, pos=pos,
                              policy=policy)
    new_cache: Optional[Params] = None
    if train:
        def body(lp, hh):
            hh, _ = layer(lp, hh, memory, cache=None)
            return hh, _zero(hh)

        h, _ = _run_stack(stacked, h, body, n_layers, remat)
    elif mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and a position")
        for l in range(n_layers):
            h, _ = layer(_layer(stacked, l), h, memory, cache=_layer(cache["dec_stack"], l))
        new_cache = cache  # the self k/v written in place
    else:
        per = []
        for l in range(n_layers):
            h, nc = layer(_layer(stacked, l), h, memory, cache=None)
            per.append(nc)
        new_cache = {"dec_stack": {
            part: {kv: torch.stack([c[part][kv] for c in per]) for kv in ("k", "v")}
            for part in ("self", "cross")}}
    h = layernorm(p["dec_norm"], h, cfg.norm_eps)
    logits = linear(p["unembed"], h, policy=policy).float()
    return mask_vocab(logits, cfg.vocab_size), new_cache


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                      dtype=None) -> Params:
    """The contiguous decode cache: per decoder layer the self k/v over
    ``max_len`` positions and the cross k/v over the encoder's frames,
    ``(L, batch, length, KV, hd)`` in ``dtype`` (default the compute
    dtype)."""
    dtype = dtype or cfg.cdtype
    L, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim

    def kv(length):
        return {name: torch.zeros((L, batch, length, kvh, hd), dtype=dtype, device=device)
                for name in ("k", "v")}

    return {"dec_stack": {"self": kv(max_len), "cross": kv(cfg.encoder_frames)}}
