"""GQA attention with paged decode — the dense-family counterpart of
``repro/models/attention.py``.

All projections route through ``common.linear`` and are therefore
LRD-aware.  q is pre-scaled by ``hd**-0.5`` in the projection, masks use
-1e30, the softmax runs in float32 and the probabilities are cast to v's
dtype before the PV product, as in the JAX code.  ``attention_impl="flash"``
runs prefill attention through the flash-attention kernel (K8,
``ops.flash_attention_apply``); decode always reads the paged cache
through :func:`dense_attention`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import Params, apply_rope, linear, rmsnorm, rmsnorm_init

# --------------------------------------------------------------------------
# Softmax attention cores
# --------------------------------------------------------------------------


def dense_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,KV,D). GQA via head-group broadcast.

    ``kv_len`` masks reads beyond the live length: (B,) one length per row,
    or (B, Sq) a length per row per query position.
    """
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    logits = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k.float())
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        tpos = torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(~(qpos[:, None] >= tpos[None, :]), -1e30)
    if kv_len is not None:
        logits = _mask_kv_len(logits, k.shape[1], kv_len)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _mask_kv_len(logits: torch.Tensor, t: int, kv_len: torch.Tensor) -> torch.Tensor:
    """Apply a (B,) or (B, Sq) length mask to (b, kv, g, q, t) logits."""
    iota = torch.arange(t, device=logits.device)
    if kv_len.dim() == 2:
        valid = iota[None, None, :] < kv_len[:, :, None]  # (b, q, t)
        return logits.masked_fill(~valid[:, None, None, :, :], -1e30)
    valid = iota[None, :] < kv_len.reshape(-1, 1)
    return logits.masked_fill(~valid[:, None, None, None, :], -1e30)


def blockwise_attention(q, k, v, *, causal: bool, block_q: int,
                        block_kv: int) -> torch.Tensor:
    """Online-softmax attention over (q block, kv block) pairs.

    Peak temporary memory is one q block's logits against one kv block,
    instead of (Sq, Sk).  Falls to :func:`dense_attention` when the lengths
    do not tile, as the JAX version does.
    """
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    bq, bkv = min(block_q, sq), min(block_kv, sk)
    if sq % bq or sk % bkv:
        return dense_attention(q, k, v, causal=causal)
    g = h // kvh
    dv = v.shape[-1]
    qg = q.reshape(b, sq, kvh, g, d).float()
    kf, vv = k.float(), v
    outs = []
    for i in range(sq // bq):
        qi = qg[:, i * bq:(i + 1) * bq]
        m = torch.full((b, bq, kvh, g), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, bq, kvh, g), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, bq, kvh, g, dv), dtype=torch.float32, device=q.device)
        for j in range(sk // bkv):
            kj = kf[:, j * bkv:(j + 1) * bkv]
            vj = vv[:, j * bkv:(j + 1) * bkv]
            logits = torch.einsum("bqkgd,btkd->bqkgt", qi, kj)
            if causal:
                qpos = i * bq + torch.arange(bq, device=q.device)
                kpos = j * bkv + torch.arange(bkv, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                logits = logits.masked_fill(~mask[None, :, None, None, :], -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgt,btkd->bqkgd", p.to(v.dtype).float(), vj.float())
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(b, sq, h, dv)


def attention_core(q, k, v, cfg: ModelConfig, *, causal: bool) -> torch.Tensor:
    if cfg.attention_impl == "flash":
        return _flash_path(q, k, v, causal=causal)
    if cfg.attention_impl == "dense" or q.shape[1] <= cfg.attention_block_q:
        return dense_attention(q, k, v, causal=causal)
    return blockwise_attention(q, k, v, causal=causal,
                               block_q=cfg.attention_block_q,
                               block_kv=cfg.attention_block_kv)


def _flash_path(q, k, v, *, causal: bool) -> torch.Tensor:
    """Flash attention (opt-in, ``attention_impl="flash"``): K8 on CUDA
    tensors, its plain version on CPU ones.  GQA and the (B, S, H, D)
    layout are handled in the kernel.  q comes pre-scaled by D**-0.5 from
    the projection and the kernel applies its own scale, so q is first
    multiplied by sqrt(D) in its own dtype, where the JAX wrapper does
    (repro/models/attention.py:193).  No shape fallback: K8 takes every
    length."""
    return ops.flash_attention_apply(q, k, v, causal=causal, q_scale=q.shape[-1] ** 0.5)


# --------------------------------------------------------------------------
# Paged decode cache addressing
# --------------------------------------------------------------------------


def _paged_write(pool: torch.Tensor, new: torch.Tensor, phys: torch.Tensor) -> None:
    """Scatter one decode step into the block pool, in place.

    pool: (num_blocks, block_size, ...); new: (B, S, ...); phys: (B, S) flat
    physical positions.  Inactive slots point at the sink block 0, where
    their duplicate writes collide harmlessly.
    """
    nb, bs = pool.shape[0], pool.shape[1]
    flat = pool.view((nb * bs,) + tuple(pool.shape[2:]))
    flat[phys.reshape(-1).long()] = new.to(pool.dtype).reshape((-1,) + tuple(pool.shape[2:]))


def _paged_gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(num_blocks, block_size, ...) pool + (B, max_blocks) table ->
    (B, max_blocks * block_size, ...) logical per-slot views."""
    nb, bs = pool.shape[0], pool.shape[1]
    flat = pool.view((nb * bs,) + tuple(pool.shape[2:]))
    b, mb = page_table.shape
    phys = (page_table.long()[:, :, None] * bs
            + torch.arange(bs, device=pool.device)[None, None, :])
    return flat[phys.reshape(b, mb * bs)]


def _gqa_paged_update(cache: Params, k_new, v_new, rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write this step's k/v (B, S, KV, hd) into the paged pool in place at
    logical positions rows[b] .. rows[b]+S-1, and return the gathered
    (B, Lmax, KV, hd) views.  The in-place update stands in for the JAX
    step's donated cache buffer."""
    if "k_scale" in cache:
        raise NotImplementedError("int8 KV pools are not ported (ROADMAP queue 1 "
                                  "item 5, serving features)")
    pt = cache["page_table"].long()
    bs = cache["k"].shape[1]
    s = k_new.shape[1]
    positions = rows[:, None] + torch.arange(s, device=rows.device)[None, :]
    phys = pt[torch.arange(pt.shape[0], device=pt.device)[:, None], positions // bs] * bs \
        + positions % bs
    _paged_write(cache["k"], k_new, phys)
    _paged_write(cache["v"], v_new, phys)
    k_view = _paged_gather(cache["k"], pt).to(k_new.dtype)
    v_view = _paged_gather(cache["v"], pt).to(v_new.dtype)
    return k_view, v_view


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------


def gqa_init(dec, path: str, cfg: ModelConfig, *, stack: Tuple[int, ...] = ()) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p: Params = {
        "wq": dec.linear(f"{path}/wq", d, h * hd, bias=cfg.qkv_bias, stack=stack),
        "wk": dec.linear(f"{path}/wk", d, kv * hd, bias=cfg.qkv_bias, stack=stack),
        "wv": dec.linear(f"{path}/wv", d, kv * hd, bias=cfg.qkv_bias, stack=stack),
        "wo": dec.linear(f"{path}/wo", h * hd, d, stack=stack),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, cfg.pdtype, dec.device, stack)
        p["k_norm"] = rmsnorm_init(hd, cfg.pdtype, dec.device, stack)
    return p


def _project_qkv(p, x, cfg, rope, *, policy=False):
    hd = cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    b, s = x.shape[0], x.shape[1]
    q = linear(p["wq"], x, policy=policy).reshape(b, s, h, hd)
    k = linear(p["wk"], x, policy=policy).reshape(b, s, kvh, hd)
    v = linear(p["wv"], x, policy=policy).reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = q * (hd ** -0.5)
    return q, k, v


def gqa_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *, rope=None,
              mode: str = "full", cache: Optional[Params] = None,
              pos: Optional[torch.Tensor] = None, causal: bool = True,
              policy=False) -> Tuple[torch.Tensor, Optional[Params]]:
    """``mode="full"``: attention over x itself, returns its k/v as the cache.
    ``mode="decode"``: x holds one token (or a chunk) per slot at per-slot
    positions ``pos`` (B,), against a paged cache updated in place."""
    b, s = x.shape[0], x.shape[1]
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if mode == "full":
        q, k, v = _project_qkv(p, x, cfg, rope, policy=policy)
        out = attention_core(q, k, v, cfg, causal=causal)
        new_cache = {"k": k, "v": v}
    else:
        if cache is None or pos is None or "page_table" not in cache:
            raise NotImplementedError(
                "decode runs against a paged cache in this port; contiguous "
                "decode caches come with the legacy fixed-batch path "
                "(ROADMAP queue 1, serving features)")
        q, k_new, v_new = _project_qkv(p, x, cfg, rope, policy=policy)
        rows = pos.reshape(-1).long().to(x.device).expand(b)
        # query j of row b attends to positions < rows[b] + j + 1
        length = rows[:, None] + 1 + torch.arange(s, device=x.device)[None, :]
        k_cache, v_cache = _gqa_paged_update(cache, k_new, v_new, rows)
        out = dense_attention(q, k_cache, v_cache, causal=False, kv_len=length)
        new_cache = cache
    y = linear(p["wo"], out.reshape(b, s, h * hd), policy=policy)
    return y, new_cache
