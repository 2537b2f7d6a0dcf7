"""Decoder-LM assembly for the dense and MoE families — the counterpart of
``repro/models/lm.py``.

Layers are stacked (every leaf carries a leading ``L`` dim, built directly
by ``Decomposer(..., stack=(L,))``) and applied by a Python loop over that
axis, where the JAX code scans.  A layer's params are views of the stacked
leaves (``p["u"][l]``), so nothing is copied per layer.  A dense model has
one ``stack``; a MoE model a ``moe_stack`` (after a ``dense_stack`` of
``first_k_dense`` layers when it has one), whose layers run
``models/moe.py`` in place of the FFN and add its load-balance term to
the returned ``aux``.

``mode``: ``"full"`` (prefill: returns the per-layer k/v stacked on ``L``),
``"train"`` (``"full"`` with no cache kept, run with grad enabled) or
``"decode"`` (one token or chunk per row against a paged or contiguous
cache, which is updated in place and returned; :func:`init_cache` makes
the contiguous one).  In ``"train"`` mode ``remat`` is the activation
checkpointing of the reference's ``_scan_stack``: ``"full"`` checkpoints
each layer, ``"sqrt"`` groups of layers with each layer checkpointed
again inside its group, ``"dots"`` saves only the outputs of matmuls
without batch dims (:func:`_run_stack`).  MLA, MTP and the SSM, hybrid,
VLM and enc-dec families raise.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core.decompose import Decomposer
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.models.attention import gqa_apply, gqa_init
from repro_torch.models.kvcache import init_quantized_kv
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.common import (Params, dot32, embed, embedding_init,
                                       ffn, ffn_init, linear, mask_vocab, rmsnorm,
                                       rmsnorm_init, rope_table)

_FAMILIES_TODO = ("other model families (MLA, MTP, SSM, hybrid, VLM, enc-dec) "
                  "are not ported yet (ROADMAP queue 1 item 7, other model families)")
REMAT_POLICIES = ("none", "full", "dots", "sqrt")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe") or cfg.use_mla or cfg.use_mtp:
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): {_FAMILIES_TODO}")


def stack_layers(cfg: ModelConfig) -> Dict[str, int]:
    """Stack name -> layer count, in apply order (the reference's
    ``lm_init`` names and ``serving/paged_cache._stack_layers``)."""
    if cfg.num_experts and cfg.first_k_dense:
        return {"dense_stack": cfg.first_k_dense,
                "moe_stack": cfg.num_layers - cfg.first_k_dense}
    if cfg.num_experts:
        return {"moe_stack": cfg.num_layers}
    return {"stack": cfg.num_layers}


# stack name -> (init path, MoE layers)
_STACKS = {"stack": ("layers", False), "dense_stack": ("layers/dense", False),
           "moe_stack": ("layers/moe", True)}


def _layer(tree: Any, l: int) -> Any:
    """Layer ``l`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


# --------------------------------------------------------------------------
# Decoder layer
# --------------------------------------------------------------------------

def decoder_layer_init(dec: Decomposer, path: str, cfg: ModelConfig, *,
                       moe_layer: bool, stack=()) -> Params:
    _check_family(cfg)
    p: Params = {
        "norm1": rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device, stack),
        "attn": gqa_init(dec, f"{path}/attn", cfg, stack=stack),
        "norm2": rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device, stack),
    }
    if moe_layer:
        p["moe"] = moe_init(dec, f"{path}/moe", cfg, stack=stack)
    else:
        p["ffn"] = ffn_init(dec, f"{path}/ffn", cfg.d_model, cfg.dense_d_ff or cfg.d_ff,
                            cfg.ffn_activation, cfg.pdtype, stack=stack)
    return p


def decoder_layer_apply(lp: Params, h: torch.Tensor, cfg: ModelConfig, *, rope,
                        mode: str, cache: Optional[Params], pos, moe_layer: bool,
                        policy=False):
    """Returns (h, new_cache, aux): aux is the MoE layer's load-balance
    term, a float32 zero for a dense layer."""
    a_in = rmsnorm(lp["norm1"], h, cfg.norm_eps)
    a_out, new_cache = gqa_apply(lp["attn"], a_in, cfg, rope=rope, mode=mode,
                                 cache=cache, pos=pos, policy=policy)
    h = h + a_out
    f_in = rmsnorm(lp["norm2"], h, cfg.norm_eps)
    if moe_layer:
        f_out, aux = moe_apply(lp["moe"], f_in, cfg, policy=policy)
    else:
        f_out = ffn(lp["ffn"], f_in, policy=policy)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + f_out, new_cache, aux


def _best_divisor(n: int) -> int:
    """Divisor of n closest to sqrt(n) (group count for two-level remat)."""
    best = 1
    for g in range(2, int(n ** 0.5) + 1):
        if n % g == 0:
            best = g
    return best


def _dots_policy(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of matmuls
    without batch dims, recompute everything else (``bmm``, attention, and
    the hand-written kernels, which are no aten ops)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _run_stack(stacked: Params, h: torch.Tensor, body, n_layers: int, remat: str):
    """Apply ``body(layer_params, h) -> (h, aux)`` over the layers of a
    stack under ``remat`` (the reference's ``_scan_stack``); returns (h,
    summed aux).  ``"sqrt"`` splits the stack into ``_best_divisor(L)``
    groups (a prime L falls back to ``"full"``), checkpoints each group,
    and each layer again inside it."""
    kw: Dict[str, Any] = dict(use_reentrant=False)
    if remat == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _dots_policy)

    def layers(h, lo, hi, wrap):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for l in range(lo, hi):
            fn = functools.partial(body, _layer(stacked, l))
            h, a = ckpt.checkpoint(fn, h, **kw) if wrap else fn(h)
            aux = aux + a
        return h, aux

    groups = _best_divisor(n_layers) if remat == "sqrt" else 1
    if groups == 1:
        return layers(h, 0, n_layers, remat != "none")
    per, aux = n_layers // groups, torch.zeros((), dtype=torch.float32, device=h.device)
    for g in range(groups):
        h, a = ckpt.checkpoint(layers, h, g * per, (g + 1) * per, True, **kw)
        aux = aux + a
    return h, aux


# --------------------------------------------------------------------------
# Model init / forward
# --------------------------------------------------------------------------

def lm_init(cfg: ModelConfig, dec: Decomposer) -> Params:
    """Params of a dense or MoE decoder LM, drawn from ``dec``'s generator
    (stacks in the reference's order)."""
    _check_family(cfg)
    p: Params = {"embed": embedding_init(dec, cfg.vocab_padded, cfg.d_model, cfg.pdtype)}
    for name, n in stack_layers(cfg).items():
        path, moe_layer = _STACKS[name]
        p[name] = decoder_layer_init(dec, path, cfg, moe_layer=moe_layer, stack=(n,))
    p["final_norm"] = rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device)
    if not cfg.tie_embeddings:
        p["unembed"] = dec.linear("unembed", cfg.d_model, cfg.vocab_padded)
    return p


def lm_apply(p: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
             mode: str = "full", cache: Optional[Params] = None, pos=None,
             policy: "bool | KernelPolicy" = False, remat: str = "none"):
    """Returns (logits float32 (B, S, V), new_cache, aux); ``new_cache`` is
    None in ``mode="train"``, and ``aux`` sums the MoE layers' load-balance
    terms (float32; zero for a dense model).  ``remat`` applies in
    ``mode="train"`` only, the one mode that keeps activations for a
    backward."""
    _check_family(cfg)
    if mode not in ("full", "train", "decode"):
        raise ValueError(f"mode must be 'full', 'train' or 'decode', got {mode!r}")
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {remat!r}")
    train = mode == "train"
    mode = "full" if train else mode
    s = tokens.shape[1]
    h = embed(p["embed"], tokens).to(cfg.cdtype)
    rope = _make_rope(cfg, s, mode, pos, h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    new_cache: Optional[Dict[str, Any]] = None if train else {}
    for name in ("stack", "dense_stack", "moe_stack"):
        if name not in p:
            continue
        stacked, moe_layer = p[name], _STACKS[name][1]
        n_layers = stacked["norm1"]["scale"].shape[0]
        if train:
            def body(lp, hh, moe_layer=moe_layer):
                hh, _, a = decoder_layer_apply(lp, hh, cfg, rope=rope, mode="full",
                                               cache=None, pos=None, moe_layer=moe_layer,
                                               policy=policy)
                return hh, a
            h, a = _run_stack(stacked, h, body, n_layers, remat)
            aux = aux + a
            continue
        layer_cache = cache[name] if cache is not None else None
        ks, vs = [], []
        for l in range(n_layers):
            lc = _layer(layer_cache, l) if layer_cache is not None else None
            h, nc, a = decoder_layer_apply(_layer(stacked, l), h, cfg, rope=rope, mode=mode,
                                           cache=lc, pos=pos, moe_layer=moe_layer,
                                           policy=policy)
            aux = aux + a
            if mode == "full":
                ks.append(nc["k"])
                vs.append(nc["v"])
        if mode == "full":
            new_cache[name] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    if mode == "decode":
        new_cache = cache  # updated in place
    h = rmsnorm(p["final_norm"], h, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = dot32(h, p["embed"]["embedding"].T)
    else:
        logits = linear(p["unembed"], h, policy=policy).float()
    logits = mask_vocab(logits, cfg.vocab_size)
    return logits, new_cache, aux


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
    """The contiguous decode cache of the fixed-batch path, one entry per
    stack: ``(L, batch, max_len, KV, hd)`` k/v in ``dtype`` (default the
    compute dtype), or int8 values with bf16 per-position scales when
    ``cfg.kv_cache_dtype == "int8"``."""
    _check_family(cfg)
    dtype = dtype or cfg.cdtype
    out: Params = {}
    for name, n in stack_layers(cfg).items():
        shape = (n, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        if cfg.kv_cache_dtype == "int8":
            out[name] = init_quantized_kv(shape[:1], *shape[1:], device=device)
        else:
            out[name] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)}
    return out
