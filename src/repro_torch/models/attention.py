"""GQA attention with paged decode, tanh-gated cross-attention, and MLA
(DeepSeek-V3) with its absorbed decode — the counterpart of
``repro/models/attention.py``.

All projections route through ``common.linear`` and are therefore
LRD-aware.  q is pre-scaled by ``hd**-0.5`` in the projection, masks use
-1e30, the softmax runs in float32 and the probabilities are cast to v's
dtype before the PV product, as in the JAX code.  ``attention_impl="flash"``
runs prefill attention through the flash-attention kernel (K8,
``ops.flash_attention_apply``).  Decode reads a paged block pool
(the scheduler's) or a contiguous (B, Smax, ...) cache (the fixed-batch
path's), either bf16 or int8 with per-position scales
(``models/kvcache.py``): int8 is consumed by :func:`int8_dense_attention`
under ``int8_decode="native"`` and dequantized first under ``"bf16"``.
Decode caches are updated in place, where the JAX steps donate them.
Cross-attention (``gqa_apply(..., kv_src=memory)``: the enc-dec decoder's
over the encoder memory, the VLM's over the vision embeddings) takes k/v
from ``kv_src``, is never causal and scales its output by ``tanh(gate)``;
in decode it projects q alone against the cross cache, so a decode step
needs no ``kv_src``.  MLA (:func:`mla_apply`) caches the normalised kv
latent and the rotated rope key (``{"ckv", "kr"}``) in a contiguous
(B, Smax, ...) cache, one row a slot (the scheduler's slot layout), and
decodes in latent space without building per-head k or v.

Under a TP serving mesh a paged pool holds this rank's KV heads
(``sharding.paged_pool_shardings``): decode takes those heads and their
query groups from the whole q/k/v the projections gathered, writes and
reads only the local pool, runs attention on the local heads and
all-gathers the head outputs over ``model`` before ``wo``.  A pool that
holds every head (the head count does not divide the axis) runs attention
whole on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.kernels import ops
from repro_torch.models import kvcache as kvq
from repro_torch.models.common import (Params, apply_rope, dot32, linear, rmsnorm,
                                       rmsnorm_init, wide)

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


def int8_dense_attention(q, k_q, k_scale, v_q, v_scale, *,
                         kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention straight on int8 KV values.

    The per-(batch, position, head) scales are rank-1 in the (q, t) logit
    matrix, so k's folds in after the QKᵀ product and v's into the
    probabilities before the PV product: no dequantized copy of either
    cache is made.  q: (B, Sq, H, D); k_q/v_q: (B, T, KV, D) int8; scales:
    (B, T, KV, 1).
    """
    b, sq, h, d = q.shape
    t, kvh = k_q.shape[1], k_q.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    # (B, T, KV, 1) -> (B, KV, 1, 1, T): broadcast over (g, q)
    ks = k_scale[..., 0].transpose(1, 2)[:, :, None, None, :].float()
    vs = v_scale[..., 0].transpose(1, 2)[:, :, None, None, :].float()
    logits = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k_q.float()) * ks
    if kv_len is not None:
        logits = _mask_kv_len(logits, t, kv_len)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p * vs, v_q.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


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


def attention_core(q, k, v, cfg: ModelConfig, *, causal: bool, policy=False) -> torch.Tensor:
    if cfg.attention_impl == "flash":
        return _flash_path(q, k, v, causal=causal, autotune=ops.as_policy(policy).autotune)
    if cfg.attention_impl == "dense" or q.shape[1] <= cfg.attention_block_q:
        return dense_attention(q, k, v, causal=causal)
    return blockwise_attention(q, k, v, causal=causal,
                               block_q=cfg.attention_block_q,
                               block_kv=cfg.attention_block_kv)


def _flash_path(q, k, v, *, causal: bool, autotune: bool = False) -> torch.Tensor:
    """Flash attention (opt-in, ``attention_impl="flash"``): K8 on CUDA
    tensors, its plain version on CPU ones.  GQA and the (B, S, H, D)
    layout are handled in the kernel.  q comes pre-scaled by D**-0.5 from
    the projection and the kernel applies its own scale, so q is first
    multiplied by sqrt(D) in its own dtype, where the JAX wrapper does
    (repro/models/attention.py:193).  No shape fallback: K8 takes every
    length.  With ``autotune`` (the policy's) its grid is the tuning
    table's."""
    return ops.flash_attention_apply(q, k, v, causal=causal, q_scale=q.shape[-1] ** 0.5,
                                     autotune=autotune)


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


def _gqa_paged_update(cache: Params, k_new, v_new, rows, *, native_int8: bool = False):
    """Write this step's k/v (B, S, KV, hd) into the paged pool in place at
    logical positions rows[b] .. rows[b]+S-1, and return the gathered
    (B, Lmax, KV, hd) views.  The in-place update stands in for the JAX
    step's donated cache buffer.  An int8 pool quantizes on the way in;
    ``native_int8`` then returns ``(values, scales)`` pairs for
    :func:`int8_dense_attention`, else views dequantized to k's dtype."""
    pt = cache["page_table"].long()
    bs = cache["k"].shape[1]
    s = k_new.shape[1]
    positions = rows[:, None] + torch.arange(s, device=rows.device)[None, :]
    # an extend chunk's padded tail can reach past the table: those writes
    # go to the sink block (the reference clamps them to the last entry)
    blk = positions // bs
    page = pt[torch.arange(pt.shape[0], device=pt.device)[:, None],
              blk.clamp(max=pt.shape[1] - 1)] * (blk < pt.shape[1])
    phys = page * bs + positions % bs
    if "k_scale" in cache:
        kq, ks = kvq.quantize_kv(k_new)
        vq, vs = kvq.quantize_kv(v_new)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            _paged_write(cache[name], val, phys)
        return _int8_views((_paged_gather(cache["k"], pt), _paged_gather(cache["k_scale"], pt)),
                           (_paged_gather(cache["v"], pt), _paged_gather(cache["v_scale"], pt)),
                           native_int8, k_new.dtype)
    _paged_write(cache["k"], k_new, phys)
    _paged_write(cache["v"], v_new, phys)
    k_view = _paged_gather(cache["k"], pt).to(k_new.dtype)
    v_view = _paged_gather(cache["v"], pt).to(v_new.dtype)
    return k_view, v_view


def _int8_views(k_view, v_view, native_int8: bool, dtype):
    """int8 ``(values, scales)`` views as they are (``native_int8``), or
    dequantized to ``dtype``."""
    if native_int8:
        return k_view, v_view
    return kvq.dequantize_kv(*k_view, dtype), kvq.dequantize_kv(*v_view, dtype)


def _contiguous_update(cache: Params, k_new, v_new, rows, *, native_int8: bool = False):
    """The same for a contiguous (B, Smax, KV, hd) cache (the fixed-batch
    path's, ``lm.init_cache``): rows[b] is row b's write offset."""
    if "k_scale" in cache:
        kvq.update_quantized_kv(cache, k_new, v_new, rows)
        return _int8_views((cache["k"], cache["k_scale"]), (cache["v"], cache["v_scale"]),
                           native_int8, k_new.dtype)
    kvq.write_rows(cache["k"], k_new, rows)
    kvq.write_rows(cache["v"], v_new, rows)
    return cache["k"], cache["v"]


def _local_kv_heads(pool: torch.Tensor, kvh: int):
    """(mesh, first KV head, KV heads) of this rank's block when a decode
    cache leaf (..., KV, hd) holds fewer than the model's ``kvh`` heads (a
    TP-sharded pool), else None."""
    local = pool.shape[-2]
    if local == kvh:
        return None
    mesh = sharding.current_mesh()
    if mesh is None or local * collectives.axes_size(mesh, ("model",)) != kvh:
        raise ValueError(f"a decode cache of {local} of {kvh} KV heads outside a mesh "
                         f"whose model axis splits them")
    return mesh, collectives.coordinate(mesh, ("model",)) * local, local


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------


def gqa_init(dec, path: str, cfg: ModelConfig, *, cross: bool = False,
             stack: Tuple[int, ...] = ()) -> Params:
    """GQA params; ``cross`` adds the tanh gate of cross-attention, zeros
    (the reference's init: a new cross block starts as the identity)."""
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
    if cross:
        p["gate"] = torch.zeros(stack + (1,), dtype=cfg.pdtype, device=dec.device)
    return p


def _project_q(p, x, cfg, *, policy=False):
    """q alone, qk-normed, unrotated and unscaled: (B, S, H, hd)."""
    b, s = x.shape[0], x.shape[1]
    q = linear(p["wq"], x, policy=policy).reshape(b, s, cfg.num_heads, cfg.resolved_head_dim)
    return rmsnorm(p["q_norm"], q, cfg.norm_eps) if cfg.qk_norm else q


def _project_qkv(p, x, kv_src, cfg, rope, *, policy=False):
    """q from x, k and v from ``kv_src`` (x itself when None)."""
    hd, kvh = cfg.resolved_head_dim, cfg.num_kv_heads
    b = x.shape[0]
    q = _project_q(p, x, cfg, policy=policy)
    src = x if kv_src is None else kv_src
    t = src.shape[1]
    k = linear(p["wk"], src, policy=policy).reshape(b, t, kvh, hd)
    v = linear(p["wv"], src, policy=policy).reshape(b, t, kvh, hd)
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = q * (hd ** -0.5)
    return q, k, v


def gqa_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *, rope=None,
              mode: str = "full", cache: Optional[Params] = None,
              pos: Optional[torch.Tensor] = None, kv_src: Optional[torch.Tensor] = None,
              causal: bool = True, policy=False) -> Tuple[torch.Tensor, Optional[Params]]:
    """``mode="full"``: attention over x itself, or cross-attention over
    ``kv_src`` (never causal), returning the k/v as the cache.
    ``mode="decode"``: x holds one token (or a chunk of S) per row at
    positions ``pos`` ((B,) per row, or one for every row), against a paged
    or contiguous cache updated in place.  A cross block (given ``kv_src``,
    or gated: ``gqa_init(cross=True)``'s params) decodes by projecting q
    alone against the cross cache, returned unchanged; ``kv_src`` is read
    in full mode only.  A cross block's output is scaled by
    ``tanh(gate)``."""
    b, s = x.shape[0], x.shape[1]
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    cross = kv_src is not None or "gate" in p
    if mode == "full":
        if cross and kv_src is None:
            raise ValueError("cross-attention needs kv_src (the encoder memory or the "
                             "vision embeddings)")
        q, k, v = _project_qkv(p, x, kv_src, cfg, rope, policy=policy)
        out = attention_core(q, k, v, cfg, causal=causal and not cross, policy=policy)
        new_cache = {"k": k, "v": v}
    elif cross:
        if cache is None:
            raise ValueError("cross-attention decode needs the cross cache")
        q = _project_q(p, x, cfg, policy=policy) * (hd ** -0.5)
        out = dense_attention(q, cache["k"], cache["v"], causal=False)
        new_cache = cache
    else:
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and positions")
        q, k_new, v_new = _project_qkv(p, x, None, cfg, rope, policy=policy)
        heads = _local_kv_heads(cache["k"], cfg.num_kv_heads)
        if heads is not None:  # this rank's KV heads and their query groups
            _, k0, kl = heads
            g = h // cfg.num_kv_heads
            q = q[:, :, k0 * g:(k0 + kl) * g]
            k_new, v_new = k_new[:, :, k0:k0 + kl], v_new[:, :, k0:k0 + kl]
        rows = pos.reshape(-1).long().to(x.device).expand(b)
        # query j of row b attends to positions < rows[b] + j + 1: the live
        # length and the in-chunk causal mask of a verify or extend chunk
        length = rows[:, None] + 1 + torch.arange(s, device=x.device)[None, :]
        native_int8 = ops.as_policy(policy).int8_decode == "native"
        update = _gqa_paged_update if "page_table" in cache else _contiguous_update
        k_cache, v_cache = update(cache, k_new, v_new, rows, native_int8=native_int8)
        if isinstance(k_cache, tuple):  # native int8: raw values and scales
            out = int8_dense_attention(q, *k_cache, *v_cache, kv_len=length)
        else:
            out = dense_attention(q, k_cache, v_cache, causal=False, kv_len=length)
        if heads is not None:
            out = collectives.all_gather(out, heads[0], ("model",), 2, path="activation")
        new_cache = cache
    y = linear(p["wo"], out.reshape(b, s, h * hd), policy=policy)
    if cross and "gate" in p:
        y = y * torch.tanh(p["gate"].float()).to(y.dtype)
    return y, new_cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# --------------------------------------------------------------------------


def mla_init(dec, path: str, cfg: ModelConfig, stack: Tuple[int, ...] = ()) -> Params:
    """MLA params: the q and kv down-projections (the policy keeps them
    dense), their norms, the up-projections to per-head q (nope + rope) and
    k-nope / v, and ``wo``."""
    d, h = cfg.d_model, cfg.num_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "q_down": dec.linear(f"{path}/q_down", d, cfg.q_lora_rank, stack=stack),
        "q_norm": rmsnorm_init(cfg.q_lora_rank, cfg.pdtype, dec.device, stack),
        "q_up": dec.linear(f"{path}/q_up", cfg.q_lora_rank, h * (nd + rd), stack=stack),
        "kv_down": dec.linear(f"{path}/kv_down", d, cfg.kv_lora_rank + rd, stack=stack),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, cfg.pdtype, dec.device, stack),
        "kv_up": dec.linear(f"{path}/kv_up", cfg.kv_lora_rank, h * (nd + vd), stack=stack),
        "wo": dec.linear(f"{path}/wo", h * vd, d, stack=stack),
    }


def _mla_q(p, x, cfg, rope, policy):
    """(q_nope, q_rope) (B, S, H, nd / rd), q_rope rotated."""
    b, s = x.shape[0], x.shape[1]
    nd, rd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rmsnorm(p["q_norm"], linear(p["q_down"], x, policy=policy), cfg.norm_eps)
    q = linear(p["q_up"], cq, policy=policy).reshape(b, s, cfg.num_heads, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    if rope is not None:
        q_rope = apply_rope(q_rope, *rope)
    return q_nope, q_rope


def _slot_starts(pos, b: int, s: int, max_len: int, device):
    """(write starts, mask bases), each (B,), of a decode chunk of ``s``
    positions per row.  ``pos`` holding one position a row (B > 1) writes
    row b at pos[b]; otherwise its first entry is every row's start (a
    batch of 1 takes this path, as the reference's ``_row_positions``).  A
    write that would run past ``max_len`` starts at ``max_len - s``, as
    ``lax.dynamic_update_slice`` clamps it; the mask keeps the unclamped
    start."""
    flat = torch.as_tensor(pos, device=device).reshape(-1).long()
    base = flat if flat.numel() == b and b > 1 else flat[:1].expand(b)
    return base.clamp(0, max_len - s), base


def mla_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *, rope=None, mode: str = "full",
              cache: Optional[Params] = None, pos=None,
              policy=False) -> Tuple[torch.Tensor, Optional[Params]]:
    """``mode="full"``: causal attention over per-head k = [k_nope, k_rope
    broadcast to every head] and v from ``kv_up`` (head dims nope + rope and
    v: under ``attention_impl="flash"`` K8 at (192, 128) for DeepSeek-V3),
    returning ``{"ckv", "kr"}`` as the cache.  ``mode="decode"``: the
    absorbed decode against a contiguous cache written in place: q-nope
    taken into the latent space through ``kv_up``'s k part, scores against
    the latent cache plus the rope scores, the context taken back out
    through its v part.  Every product accumulates in float32 and is
    rounded to x's dtype where the reference rounds it; query j of row b
    sees positions < start[b] + j + 1 (in-chunk causality for a
    speculative verify chunk)."""
    b, s = x.shape[0], x.shape[1]
    h, lat = cfg.num_heads, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = (nd + rd) ** -0.5
    ckv_full = linear(p["kv_down"], x, policy=policy)  # (B, S, lat + rd)
    ckv = rmsnorm(p["kv_norm"], ckv_full[..., :lat], cfg.norm_eps)
    k_rope = ckv_full[..., lat:].reshape(b, s, 1, rd)
    if rope is not None:
        k_rope = apply_rope(k_rope, *rope)
    q_nope, q_rope = _mla_q(p, x, cfg, rope, policy)
    if mode == "full":
        kv = linear(p["kv_up"], ckv, policy=policy).reshape(b, s, h, nd + vd)
        k = torch.cat([kv[..., :nd], k_rope.expand(b, s, h, rd)], dim=-1)
        # the scale as x's dtype holds it (the reference's weakly typed scalar)
        q = torch.cat([q_nope, q_rope], dim=-1) * torch.tensor(scale, dtype=x.dtype,
                                                                 device=x.device)
        # v as a tensor of its own (K8 reads contiguous operands by TMA)
        out = attention_core(q, k, kv[..., nd:].contiguous(), cfg, causal=True, policy=policy)
        new_cache = {"ckv": ckv, "kr": k_rope[..., 0, :]}
    else:
        if cache is None or pos is None:
            raise ValueError("MLA decode needs a cache and positions")
        starts, base = _slot_starts(pos, b, s, cache["ckv"].shape[1], x.device)
        kvq.write_rows(cache["ckv"], ckv, starts)
        kvq.write_rows(cache["kr"], k_rope[:, :, 0, :], starts)
        ckv_c, kr_c = cache["ckv"], cache["kr"]
        up = p["kv_up"]
        w_kv = up["kernel"] if "kernel" in up else dot32(up["u"], up["v"]).to(up["u"].dtype)
        w_kv = w_kv.reshape(lat, h, nd + vd)
        w_uk, w_uv = w_kv[..., :nd], w_kv[..., nd:]
        q_lat = torch.einsum("bshn,lhn->bshl", wide(q_nope), wide(w_uk)).to(x.dtype)
        logits = (torch.einsum("bshl,btl->bhst", wide(q_lat), wide(ckv_c))
                  + torch.einsum("bshr,btr->bhst", wide(q_rope), wide(kr_c))) * scale
        length = base[:, None] + 1 + torch.arange(s, device=x.device)[None, :]  # (B, S)
        valid = torch.arange(logits.shape[-1], device=x.device)[None, None, :] < length[..., None]
        probs = torch.softmax(logits.masked_fill(~valid[:, None], -1e30), dim=-1)
        ctx = torch.einsum("bhst,btl->bshl", wide(probs.to(x.dtype)), wide(ckv_c)).to(x.dtype)
        out = torch.einsum("bshl,lhv->bshv", wide(ctx), wide(w_uv)).to(x.dtype)
        new_cache = cache
    return linear(p["wo"], out.reshape(b, s, h * vd), policy=policy), new_cache
