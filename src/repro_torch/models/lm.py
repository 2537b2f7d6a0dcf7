"""Decoder-LM assembly for the dense, MoE (MLA and MTP included: DeepSeek-V3),
SSM (xLSTM), hybrid (Zamba2) and VLM (llama-3.2-vision) families — the
counterpart of ``repro/models/lm.py``.

Layers are stacked (every leaf carries a leading ``L`` dim, built directly
by ``Decomposer(..., stack=(L,))``) and applied by a Python loop over that
axis, where the JAX code scans.  A layer's params are views of the stacked
leaves (``p["u"][l]``), so nothing is copied per layer.  A dense model has
one ``stack``; a MoE model a ``moe_stack`` (after a ``dense_stack`` of
``first_k_dense`` layers when it has one), whose layers run
``models/moe.py`` in place of the FFN and add its load-balance term to
the returned ``aux``.  An SSM model is one ``stack`` of mLSTM blocks
(``models/ssm.py``); a hybrid model ``mamba_groups`` of Mamba2 layers
stacked on ``(groups, per group)``, each group followed by the one shared
attention + GELU-FFN block (``shared_attn``, run at width 2d on ``concat(h,
x0)``, x0 the embedding), then a ``mamba_tail``.  Their caches hold state
leaves with no sequence axis (``ssm``, ``conv``; ``c``, ``n``, ``m``) beside
the shared block's k/v of each group.  A VLM is ``self_stack``, decoder
layers stacked on ``(groups, cross_attn_every)``, and ``cross_stack``, one
block a group (tanh-gated cross-attention over the vision embeddings, then
a SwiGLU FFN) after the group's self layers; its cache is ``self`` k/v at
the window and ``cross`` k/v at the image tokens, which a decode step reads
(it takes no vision embeddings).

``mode``: ``"full"`` (prefill: returns the per-layer k/v stacked on ``L``),
``"train"`` (``"full"`` with no cache kept, run with grad enabled) or
``"decode"`` (one token or chunk per row against a paged or contiguous
cache, which is updated in place and returned; :func:`init_cache` makes
the contiguous one).  In ``"train"`` mode ``remat`` is the activation
checkpointing of the reference's ``_scan_stack``: ``"full"`` checkpoints
each layer, ``"sqrt"`` groups of layers with each layer checkpointed
again inside its group, ``"dots"`` saves only the outputs of matmuls
without batch dims (:func:`_run_stack`); a hybrid model checkpoints each
group whole under ``"full"`` and ``"sqrt"`` and its tail as asked
(:func:`_hybrid_forward`), and a VLM each group whole with each self
layer checkpointed again inside it, as the reference's ``_vlm_forward``
(:func:`_vlm_forward`; ``"dots"`` checkpoints nothing there, as in the
reference).  An MLA model's layers run ``attention.mla_apply`` (its cache
holds the ``ckv`` latent and the ``kr`` rope key of each stack), and an
MTP model carries ``p["mtp"]``, whose depth-1 head :func:`mtp_logits`
predicts token t + 2 from the final hidden state (``lm_apply(...,
return_hidden=True)``) and the embedding of token t + 1.  A stack may hold
no layer (DeepSeek-V3 cut to ``num_layers = first_k_dense``: an empty
``moe_stack``).  The enc-dec family has its own assembly
(``models/encdec.py``), which reuses :func:`_run_stack`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core.decompose import Decomposer
from repro_torch.distributed.sharding import bind_context
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.models import ssm
from repro_torch.models.attention import gqa_apply, gqa_init, mla_apply, mla_init
from repro_torch.models.kvcache import init_quantized_kv
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.common import (Params, dot32, embed, embedding_init,
                                       ffn, ffn_init, linear, mask_vocab, rmsnorm,
                                       rmsnorm_init, rope_table)

REMAT_POLICIES = ("none", "full", "dots", "sqrt")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name} (encdec): an encoder-decoder model runs "
                                  f"through models.encdec, not the decoder-LM assembly")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): not a decoder-LM family "
                                  f"{FAMILIES}")


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
    attn = (mla_init if cfg.use_mla else gqa_init)(dec, f"{path}/attn", cfg, stack=stack)
    p: Params = {
        "norm1": rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device, stack),
        "attn": attn,
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
    attn = mla_apply if cfg.use_mla else gqa_apply
    a_out, new_cache = attn(lp["attn"], a_in, cfg, rope=rope, mode=mode, cache=cache, pos=pos,
                            policy=policy)
    h = h + a_out
    f_in = rmsnorm(lp["norm2"], h, cfg.norm_eps)
    if moe_layer:
        f_out, aux = moe_apply(lp["moe"], f_in, cfg, policy=policy)
    else:
        f_out = ffn(lp["ffn"], f_in, policy=policy)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + f_out, new_cache, aux


def check_remat(remat: str) -> None:
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {remat!r}")


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
            h, a = ckpt.checkpoint(bind_context(fn), h, **kw) if wrap else fn(h)
            aux = aux + a
        return h, aux

    groups = _best_divisor(n_layers) if remat == "sqrt" else 1
    if groups == 1:
        return layers(h, 0, n_layers, remat != "none")
    per, aux = n_layers // groups, torch.zeros((), dtype=torch.float32, device=h.device)
    for g in range(groups):
        h, a = ckpt.checkpoint(bind_context(layers), h, g * per, (g + 1) * per, True, **kw)
        aux = aux + a
    return h, aux


# --------------------------------------------------------------------------
# Model init / forward
# --------------------------------------------------------------------------

def lm_init(cfg: ModelConfig, dec: Decomposer) -> Params:
    """Params of a decoder LM of a ported family, drawn from ``dec``'s
    generator (stacks in the reference's order)."""
    _check_family(cfg)
    p: Params = {"embed": embedding_init(dec, cfg.vocab_padded, cfg.d_model, cfg.pdtype)}
    if cfg.family == "hybrid":
        n_grp, per, tail = _hybrid_split(cfg)
        p["mamba_groups"] = ssm.mamba2_init(dec, "layers/mamba", cfg, stack=(n_grp, per))
        if tail:
            p["mamba_tail"] = ssm.mamba2_init(dec, "layers/mamba_tail", cfg, stack=(tail,))
        p["shared_attn"] = _zamba_shared_init(dec, cfg)
    elif cfg.family == "ssm":
        p["stack"] = ssm.mlstm_init(dec, "layers/mlstm", cfg, stack=(cfg.num_layers,))
    elif cfg.family == "vlm":
        n_groups, every = _vlm_split(cfg)
        p["self_stack"] = decoder_layer_init(dec, "layers/self", cfg, moe_layer=False,
                                             stack=(n_groups, every))
        p["cross_stack"] = _vlm_cross_init(dec, cfg, stack=(n_groups,))
    else:
        for name, n in stack_layers(cfg).items():
            path, moe_layer = _STACKS[name]
            p[name] = decoder_layer_init(dec, path, cfg, moe_layer=moe_layer, stack=(n,))
    if cfg.use_mtp:
        p["mtp"] = {
            "proj": dec.linear("mtp/proj", 2 * cfg.d_model, cfg.d_model),
            "layer": decoder_layer_init(dec, "mtp/layer", cfg, moe_layer=bool(cfg.num_experts)),
            "norm_h": rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device),
            "norm_e": rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device),
        }
    p["final_norm"] = rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device)
    if not cfg.tie_embeddings:
        p["unembed"] = dec.linear("unembed", cfg.d_model, cfg.vocab_padded)
    return p


def _vlm_split(cfg: ModelConfig):
    """(groups, self layers a group) of a VLM: each group is
    ``cross_attn_every`` self layers and one cross block."""
    every = cfg.cross_attn_every
    return cfg.num_layers // (every + 1), every


def _vlm_cross_init(dec: Decomposer, cfg: ModelConfig, stack) -> Params:
    """A VLM's cross block: norm, tanh-gated cross-attention (gate zeros at
    the init), norm, SwiGLU FFN."""
    return {
        "norm1": rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device, stack),
        "attn": gqa_init(dec, "layers/cross/attn", cfg, cross=True, stack=stack),
        "norm2": rmsnorm_init(cfg.d_model, cfg.pdtype, dec.device, stack),
        "ffn": ffn_init(dec, "layers/cross/ffn", cfg.d_model, cfg.d_ff, cfg.ffn_activation,
                        cfg.pdtype, stack=stack),
    }


def _vlm_cross_apply(lp: Params, h, cfg: ModelConfig, *, mode: str, cache, vision, policy):
    """One cross block: in full mode k/v from ``vision`` (never causal),
    returned as the cross cache; in decode mode q alone against ``cache``,
    returned unchanged."""
    a_in = rmsnorm(lp["norm1"], h, cfg.norm_eps)
    if mode == "full":
        a_out, nc = gqa_apply(lp["attn"], a_in, cfg, mode="full", kv_src=vision,
                              policy=policy)
    else:
        a_out, nc = gqa_apply(lp["attn"], a_in, cfg, mode="decode", cache=cache, policy=policy)
    h = h + a_out
    return h + ffn(lp["ffn"], rmsnorm(lp["norm2"], h, cfg.norm_eps), policy=policy), nc


def _vlm_forward(p: Params, h, cfg: ModelConfig, rope, *, mode: str, train: bool, cache, pos,
                 vision, policy, remat: str):
    """Groups of ``cross_attn_every`` self layers, each followed by its
    cross block over ``vision`` (in the compute dtype; unread in decode
    mode).  Returns (h, new cache or None).  In train mode ``"full"`` and
    ``"sqrt"`` checkpoint each group whole and each self layer again inside
    it, ``"dots"`` and ``"none"`` nothing (the reference's
    ``_vlm_forward``)."""
    n_groups, every = _vlm_split(cfg)
    self_stack, cross_stack = p["self_stack"], p["cross_stack"]
    if vision is not None:
        vision = vision.to(cfg.cdtype)
    if train:
        inner = "full" if remat in ("full", "sqrt") else "none"

        def self_body(lp, hh):
            hh, _, a = decoder_layer_apply(lp, hh, cfg, rope=rope, mode="full", cache=None,
                                           pos=None, moe_layer=False, policy=policy)
            return hh, a

        def group(g, hh):
            hh, _ = _run_stack(_layer(self_stack, g), hh, self_body, every, inner)
            hh, _ = _vlm_cross_apply(_layer(cross_stack, g), hh, cfg, mode="full", cache=None,
                                     vision=vision, policy=policy)
            return hh

        for g in range(n_groups):
            if remat in ("full", "sqrt"):
                h = ckpt.checkpoint(functools.partial(group, g), h, use_reentrant=False)
            else:
                h = group(g, h)
        return h, None
    self_kv, cross_kv = [], []
    for g in range(n_groups):
        sc = _layer(cache["self"], g) if cache is not None else None
        for l in range(every):
            lc = _layer(sc, l) if sc is not None else None
            h, nc, _ = decoder_layer_apply(_layer(_layer(self_stack, g), l), h, cfg, rope=rope,
                                           mode=mode, cache=lc, pos=pos, moe_layer=False,
                                           policy=policy)
            self_kv.append(nc)
        h, nc = _vlm_cross_apply(_layer(cross_stack, g), h, cfg, mode=mode,
                                 cache=_layer(cache["cross"], g) if cache is not None else None,
                                 vision=vision, policy=policy)
        cross_kv.append(nc)
    if mode == "decode":
        return h, cache  # the self k/v written in place, the cross k/v only read
    kv = ("k", "v")
    return h, {"self": {k: torch.stack([c[k] for c in self_kv]).unflatten(0, (n_groups, every))
                        for k in kv},
               "cross": {k: torch.stack([c[k] for c in cross_kv]) for k in kv}}


def _hybrid_split(cfg: ModelConfig):
    """(groups, Mamba2 layers a group, tail layers) of a hybrid model."""
    per = cfg.attn_every
    n_grp = cfg.num_layers // per
    return n_grp, per, cfg.num_layers - n_grp * per


def _zamba_wide_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared block's config: width 2d, plain GQA."""
    return dataclasses.replace(cfg, d_model=2 * cfg.d_model, use_mla=False, qk_norm=False,
                               qkv_bias=False)


def _zamba_shared_init(dec: Decomposer, cfg: ModelConfig) -> Params:
    """Zamba2's shared transformer block, run at 2d on concat(h, x0): GQA,
    a GELU FFN and ``down_proj`` back to d."""
    d2, wide = 2 * cfg.d_model, _zamba_wide_cfg(cfg)
    return {
        "norm1": rmsnorm_init(d2, cfg.pdtype, dec.device),
        "attn": gqa_init(dec, "shared/attn", wide),
        "norm2": rmsnorm_init(d2, cfg.pdtype, dec.device),
        "ffn": ffn_init(dec, "shared/ffn", d2, cfg.d_ff, "gelu", cfg.pdtype),
        "down": dec.linear("shared/down_proj", d2, cfg.d_model),
    }


def _zamba_shared_apply(sp: Params, h, x0, cfg: ModelConfig, rope, mode: str, lc, pos,
                        policy):
    """The shared block on concat(h, x0), its output added to h.  ``rope``
    is the (cos, sin) pair of head dim 2d / heads, applied to q and k alike
    (the reference's 4-tuple repeats it)."""
    z = torch.cat([h, x0], dim=-1)
    a_out, nc = gqa_apply(sp["attn"], rmsnorm(sp["norm1"], z, cfg.norm_eps),
                          _zamba_wide_cfg(cfg), rope=rope, mode=mode, cache=lc, pos=pos,
                          policy=policy)
    z = z + a_out
    z = z + ffn(sp["ffn"], rmsnorm(sp["norm2"], z, cfg.norm_eps), policy=policy)
    return h + linear(sp["down"], z, policy=policy), nc


def _zero(h: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=h.device)


def _mlstm_body(lp, h, *, cfg, policy):
    """One mLSTM layer in train mode (no state kept): (h, aux)."""
    out, _ = ssm.mlstm_apply(lp, h, cfg, policy=policy)
    return h + out, _zero(h)


def _mamba_body(lp, h, *, cfg, policy):
    """One Mamba2 layer in train mode (no state kept): (h, aux)."""
    out, _ = ssm.mamba2_apply(lp, h, cfg, mode="full", policy=policy, keep_state=False)
    return h + out, _zero(h)


def _write_state(cache: Params, new: Params) -> None:
    """Copy a layer's new recurrent state into its cache views (the decode
    cache is updated in place, where the JAX steps donate it)."""
    for k, v in new.items():
        cache[k].copy_(v)


def _stack_states(states) -> Params:
    """Per-layer state dicts -> one dict of leaves stacked on a leading axis."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _recurrent_stack(stacked: Params, h, cfg, *, mode: str, cache, policy, apply_fn,
                     n_layers: int):
    """A stack of recurrent layers in full (prefill) or decode mode: returns
    (h, the stacked new states in full mode, None in decode mode, where the
    cache views are written in place)."""
    states = []
    for l in range(n_layers):
        lc = _layer(cache, l) if cache is not None else None
        out, ns = apply_fn(_layer(stacked, l), h, cfg, mode=mode, state=lc, policy=policy)
        h = h + out
        if mode == "decode":
            _write_state(lc, ns)
        else:
            states.append(ns)
    return h, (_stack_states(states) if states else None)


def _hybrid_forward(p: Params, h, cfg: ModelConfig, rope, *, mode: str, train: bool, cache,
                    pos, policy, remat: str):
    """Zamba2: groups of Mamba2 layers, each followed by the shared block on
    concat(h, x0); then the tail.  Returns (h, new cache or None).  In train
    mode ``"full"`` and ``"sqrt"`` checkpoint each group whole (the groups
    are the outer level) with no remat inside, and the tail takes
    ``remat`` as given, as the reference's ``_hybrid_forward``."""
    x0 = h
    shared, groups = p["shared_attn"], p["mamba_groups"]
    n_grp, per, tail = _hybrid_split(cfg)
    if train:
        def group(g, hh):
            gp = _layer(groups, g)
            for l in range(per):
                hh, _ = _mamba_body(_layer(gp, l), hh, cfg=cfg, policy=policy)
            hh, _ = _zamba_shared_apply(shared, hh, x0, cfg, rope, "full", None, None, policy)
            return hh

        for g in range(n_grp):
            if remat in ("full", "sqrt"):
                h = ckpt.checkpoint(functools.partial(group, g), h, use_reentrant=False)
            else:
                h = group(g, h)
        if tail:
            body = functools.partial(_mamba_body, cfg=cfg, policy=policy)
            h, _ = _run_stack(p["mamba_tail"], h, body, tail, remat)
        return h, None

    grp_states, kvs = [], []
    for g in range(n_grp):
        gc = _layer(cache["mamba_groups"], g) if cache is not None else None
        h, st = _recurrent_stack(_layer(groups, g), h, cfg, mode=mode, cache=gc, policy=policy,
                                 apply_fn=ssm.mamba2_apply, n_layers=per)
        ac = _layer(cache["shared_attn"], g) if cache is not None else None
        h, nc = _zamba_shared_apply(shared, h, x0, cfg, rope, mode, ac, pos, policy)
        grp_states.append(st)
        kvs.append(nc)
    tail_st = None
    if tail:
        h, tail_st = _recurrent_stack(p["mamba_tail"], h, cfg, mode=mode,
                                      cache=cache["mamba_tail"] if cache is not None else None,
                                      policy=policy, apply_fn=ssm.mamba2_apply, n_layers=tail)
    if mode == "decode":
        return h, cache
    new_cache = {"mamba_groups": _stack_states(grp_states),
                 "shared_attn": {"k": torch.stack([c["k"] for c in kvs]),
                                 "v": torch.stack([c["v"] for c in kvs])}}
    if tail:
        new_cache["mamba_tail"] = tail_st
    return h, new_cache


def _ssm_forward(p: Params, h, cfg: ModelConfig, *, mode: str, train: bool, cache, pos,
                 policy, remat: str):
    del pos  # the recurrence carries its position in its state
    """xLSTM: one stack of mLSTM blocks.  Returns (h, new cache or None)."""
    n_layers = cfg.num_layers
    if train:
        body = functools.partial(_mlstm_body, cfg=cfg, policy=policy)
        h, _ = _run_stack(p["stack"], h, body, n_layers, remat)
        return h, None
    h, st = _recurrent_stack(p["stack"], h, cfg, mode=mode,
                             cache=cache["stack"] if cache is not None else None,
                             policy=policy, apply_fn=ssm.mlstm_apply, n_layers=n_layers)
    return h, (cache if mode == "decode" else {"stack": st})


def lm_apply(p: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
             mode: str = "full", cache: Optional[Params] = None, pos=None,
             vision_embeddings: Optional[torch.Tensor] = None,
             policy: "bool | KernelPolicy" = False, remat: str = "none",
             return_hidden: bool = False):
    """Returns (logits float32 (B, S, V), new_cache, aux), and with
    ``return_hidden`` the final-normed hidden state (B, S, d) after them
    (what :func:`mtp_logits` reads); ``new_cache`` is
    None in ``mode="train"``, and ``aux`` sums the MoE layers' load-balance
    terms (float32; zero for every other model).  ``remat`` applies in
    ``mode="train"`` only, the one mode that keeps activations for a
    backward.  A VLM takes ``vision_embeddings`` (B, image tokens, d) in
    full and train mode (its cross blocks raise without them); a decode
    step reads the cross k/v from the cache and needs none."""
    _check_family(cfg)
    if mode not in ("full", "train", "decode"):
        raise ValueError(f"mode must be 'full', 'train' or 'decode', got {mode!r}")
    check_remat(remat)
    train = mode == "train"
    mode = "full" if train else mode
    s = tokens.shape[1]
    h = embed(p["embed"], tokens).to(cfg.cdtype)
    rope = _make_rope(cfg, s, mode, pos, h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family in ("hybrid", "ssm", "vlm"):
        fwd = {"hybrid": _hybrid_forward, "ssm": _ssm_forward, "vlm": _vlm_forward}[cfg.family]
        kw = {"hybrid": dict(rope=rope), "ssm": {},
              "vlm": dict(rope=rope, vision=vision_embeddings)}[cfg.family]
        h, new_cache = fwd(p, h, cfg, mode=mode, train=train, cache=cache, pos=pos,
                           policy=policy, remat=remat, **kw)
        return _head(p, h, cfg, policy, new_cache, aux, return_hidden)
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
        kvs = []
        for l in range(n_layers):
            lc = _layer(layer_cache, l) if layer_cache is not None else None
            h, nc, a = decoder_layer_apply(_layer(stacked, l), h, cfg, rope=rope, mode=mode,
                                           cache=lc, pos=pos, moe_layer=moe_layer,
                                           policy=policy)
            aux = aux + a
            kvs.append(nc)
        if mode == "full":  # k / v, or MLA's ckv / kr
            new_cache[name] = (_stack_states(kvs) if kvs
                               else _no_layer_cache(cfg, tokens.shape[0], s, h))
    if mode == "decode":
        new_cache = cache  # updated in place
    return _head(p, h, cfg, policy, new_cache, aux, return_hidden)


def _no_layer_cache(cfg: ModelConfig, b: int, s: int, h: torch.Tensor) -> Params:
    """The prefill cache of a stack with no layer: its leaves with a
    leading 0, as the reference's scan over no layer returns them."""
    if cfg.use_mla:
        shapes = {"ckv": (0, b, s, cfg.kv_lora_rank), "kr": (0, b, s, cfg.qk_rope_head_dim)}
    else:
        shapes = dict.fromkeys(("k", "v"), (0, b, s, cfg.num_kv_heads, cfg.resolved_head_dim))
    return {k: torch.empty(v, dtype=h.dtype, device=h.device) for k, v in shapes.items()}


def _logits(p: Params, hn: torch.Tensor, cfg: ModelConfig, policy) -> torch.Tensor:
    """The float32 logits of a final-normed hidden state, padded vocab
    masked."""
    if cfg.tie_embeddings:
        logits = dot32(hn, p["embed"]["embedding"].T)
    else:
        logits = linear(p["unembed"], hn, policy=policy).float()
    return mask_vocab(logits, cfg.vocab_size)


def _head(p: Params, h: torch.Tensor, cfg: ModelConfig, policy, new_cache, aux,
          return_hidden: bool):
    """Final norm and logits: ``lm_apply``'s return tuple."""
    hn = rmsnorm(p["final_norm"], h, cfg.norm_eps)
    out = (_logits(p, hn, cfg, policy), new_cache, aux)
    return out + (hn,) if return_hidden else out


# --------------------------------------------------------------------------
# MTP head (DeepSeek-V3)
# --------------------------------------------------------------------------

def mtp_logits(p: Params, h: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig, *,
               policy: "bool | KernelPolicy" = False) -> torch.Tensor:
    """Depth-1 multi-token prediction: the logits of token t + 2 from the
    final-normed hidden state ``h`` at t and the embedding of token t + 1.
    The shift is a roll padded back to S (the last two positions are
    masked out of the loss, :func:`mtp_loss_mask`); the MTP layer runs as a
    decoder layer in full mode with no remat, its MoE aux dropped, and the
    head shares the model's final norm and unembedding, as the
    reference's."""
    mtp = p["mtp"]
    emb_next = embed(p["embed"], torch.roll(tokens, -1, dims=1)).to(h.dtype)
    h_in = torch.cat([rmsnorm(mtp["norm_h"], h, cfg.norm_eps),
                      rmsnorm(mtp["norm_e"], emb_next, cfg.norm_eps)], dim=-1)
    hm = linear(mtp["proj"], h_in, policy=policy)
    hd = cfg.qk_rope_head_dim if cfg.use_mla else cfg.resolved_head_dim
    rope = rope_table(hm.shape[1], hd, cfg.rope_theta, device=hm.device)
    hm, _, _ = decoder_layer_apply(mtp["layer"], hm, cfg, rope=rope, mode="full", cache=None,
                                   pos=None, moe_layer=bool(cfg.num_experts), policy=policy)
    return _logits(p, rmsnorm(p["final_norm"], hm, cfg.norm_eps), cfg, policy)


def mtp_loss_mask(tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) float32 weights of the padded depth-1 MTP loss: the last two
    positions are invalid."""
    b, s = tokens.shape
    valid = (torch.arange(s, device=tokens.device) < s - 2).float()
    return valid.expand(b, s)


def _make_rope(cfg: ModelConfig, s: int, mode: str, pos, device):
    """RoPE tables for this call: none for an SSM model; head dim 2d / heads
    for the hybrid's shared block (it runs at 2d); MLA's rope head dim."""
    if cfg.family == "ssm":
        return None
    if cfg.use_mla:
        hd = cfg.qk_rope_head_dim
    elif cfg.family == "hybrid":
        hd = 2 * cfg.d_model // cfg.num_heads
    else:
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
    """The contiguous decode cache of the fixed-batch path: for a dense or
    MoE model one entry per stack, ``(L, batch, max_len, KV, hd)`` k/v in
    ``dtype`` (default the compute dtype), or int8 values with bf16
    per-position scales when ``cfg.kv_cache_dtype == "int8"``; for a hybrid
    model the Mamba2 states of each group and of the tail and the shared
    block's k/v a group (head dim 2d / heads); for an SSM model the mLSTM
    states (``m`` in float32); for a VLM the self layers' k/v stacked on
    (groups, layers a group) and the cross blocks' on (groups,) over
    ``num_image_tokens`` positions; for an MLA model each stack's ``ckv``
    (L, batch, max_len, kv_lora_rank) and ``kr`` (L, batch, max_len,
    qk_rope_head_dim) in ``dtype``, whatever ``kv_cache_dtype`` says, as in
    the reference."""
    _check_family(cfg)
    dtype = dtype or cfg.cdtype

    def kv_cache(stack, heads, hd, length=max_len):
        shape = stack + (batch, length, heads, hd)
        if cfg.kv_cache_dtype == "int8":
            return init_quantized_kv(stack, *shape[len(stack):], device=device)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def stacked(state, stack):
        return {k: v.expand(stack + tuple(v.shape)).clone() for k, v in state.items()}

    if cfg.family == "hybrid":
        n_grp, per, tail = _hybrid_split(cfg)
        state = ssm.mamba2_init_state(cfg, batch, dtype, device)
        out = {"mamba_groups": stacked(state, (n_grp, per)),
               "shared_attn": kv_cache((n_grp,), cfg.num_kv_heads,
                                       2 * cfg.d_model // cfg.num_heads)}
        if tail:
            out["mamba_tail"] = stacked(state, (tail,))
        return out
    if cfg.family == "ssm":
        return {"stack": stacked(ssm.mlstm_init_state(cfg, batch, dtype, device),
                                 (cfg.num_layers,))}
    if cfg.family == "vlm":
        n_groups, every = _vlm_split(cfg)
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        return {"self": kv_cache((n_groups, every), kv, hd),
                "cross": kv_cache((n_groups,), kv, hd, cfg.num_image_tokens)}
    if cfg.use_mla:
        return {name: {"ckv": torch.zeros((n, batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                                          device=device),
                       "kr": torch.zeros((n, batch, max_len, cfg.qk_rope_head_dim),
                                         dtype=dtype, device=device)}
                for name, n in stack_layers(cfg).items()}
    return {name: kv_cache((n,), cfg.num_kv_heads, cfg.resolved_head_dim)
            for name, n in stack_layers(cfg).items()}
