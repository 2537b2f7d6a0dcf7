"""Paged KV cache: fixed-size blocks, free-list allocator, slot page tables.

The counterpart of ``repro/serving/paged_cache.py``.  The physical cache is
a pool of ``num_blocks`` fixed-size blocks shared by all slots, and a
per-slot page table maps logical block index -> physical block id.  Blocks
are allocated on demand and returned the moment a request retires, so the
pool can be oversubscribed relative to ``num_slots * max_len``.

Layout per layer stack (``stack`` of a dense model, ``moe_stack`` of a MoE
one, ``dense_stack`` and ``moe_stack`` of a MoE model with dense first
layers; ``models.lm.stack_layers``)::

    {"k": (L, num_blocks, block_size, KV, hd),
     "v": (L, num_blocks, block_size, KV, hd),
     "page_table": (L, num_slots, max_blocks) int32}

An int8 pool (``ModelConfig.kv_cache_dtype == "int8"``) holds int8 ``k`` /
``v`` and bf16 ``k_scale`` / ``v_scale`` leaves of shape
``(L, num_blocks, block_size, KV, 1)``, one scale per position and head
(``models/kvcache.py``): (hd + 2) / (2 hd) of the bf16 pool's bytes.

``page_table`` rides inside the cache tree (broadcast over L), so each
layer sees its pool slice plus the shared table.  **Block 0 is a reserved
sink**: retired slots' page tables point at it, so the fixed-shape decode
step keeps writing for inactive rows without corrupting live blocks.

The host-side bookkeeping (:class:`BlockAllocator`,
:class:`PageTableManager`) is plain numpy, copied from the JAX package.
The device pools are updated in place (the JAX steps donate them).

Under a TP serving mesh (``mesh`` of more than one rank) each rank's pool
holds the KV heads ``distributed.sharding.paged_pool_shardings`` gives it
(its ``model`` coordinate's heads when the head count divides the axis,
else all of them), and the page tables are whole on every rank: the
scheduler makes the same host decisions on every rank, so the tables
agree.  :func:`init_paged_cache` allocates the local blocks,
:func:`insert_prefill_paged` writes the local heads of a whole prefill, and
:func:`paged_pool_bytes` counts this rank's bytes.

An MLA model (DeepSeek-V3) keeps its latent cache contiguous instead, the
scheduler's slot layout: slot ``s`` owns row ``s`` of an (L, num_slots,
max_len, ...) cache (:func:`init_slot_cache`), a prefill is written into
its row (:func:`insert_prefill_rows`), and each row decodes at its own
position.  The row is the allocation, so no allocator is involved.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import mesh_size, paged_pool_shardings
from repro_torch.models import kvcache as kvq
from repro_torch.models import lm
from repro_torch.models.lm import stack_layers

__all__ = ["BlockAllocator", "PageTableManager", "blocks_for", "supports_paged",
           "init_paged_cache", "with_page_table", "insert_prefill_paged",
           "paged_pool_bytes", "init_slot_cache", "insert_prefill_rows"]


def blocks_for(length: int, block_size: int) -> int:
    """Number of blocks covering ``length`` positions."""
    return -(-max(int(length), 0) // block_size)


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` physical blocks.

    Block 0 is reserved as the sink (module docstring) and never handed
    out; ``alloc`` is all-or-nothing so a request can never be admitted
    with a partial page set.

    Refcounts enable the radix prefix cache's copy-on-write sharing
    (serving/radix_cache.py): a block allocated once (``rc == 1``) may be
    ``ref``'d by every slot whose prompt matched it in the trie, and only
    returns to the free list when the last holder ``free``'s it.  Non-shared
    operation is unchanged — rc stays 1 from alloc to free.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the reserved sink)")
        self.num_blocks = num_blocks
        self._free: deque = deque(range(1, num_blocks))
        self._rc = np.zeros(num_blocks, np.int32)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return int(self._rc[block])

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks (rc=1 each), or None (no side effect) if
        unavailable."""
        if n > len(self._free):
            return None
        blocks = [self._free.popleft() for _ in range(n)]
        self._rc[blocks] = 1
        return blocks

    def ref(self, blocks: List[int]) -> None:
        """Add one holder to each (already-allocated) block."""
        for b in blocks:
            if not 1 <= b < self.num_blocks or self._rc[b] < 1:
                raise ValueError(f"ref on unallocated block id {b}")
            self._rc[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one holder per block; last holder returns it to the pool."""
        for b in blocks:
            if not 1 <= b < self.num_blocks or self._rc[b] < 1:
                raise ValueError(f"freeing invalid block id {b}")
            self._rc[b] -= 1
            if self._rc[b] == 0:
                self._free.append(b)


class PageTableManager:
    """Slot page tables + allocator, the scheduler's memory authority.

    ``table`` is the (num_slots, max_blocks) int32 array shipped to the
    device each step; unallocated entries stay 0 (the sink block).
    """

    def __init__(self, num_slots: int, max_blocks: int, num_blocks: int,
                 block_size: int):
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.allocator = BlockAllocator(num_blocks)
        self.table = np.zeros((num_slots, max_blocks), np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(num_slots)]
        # bumped on every table mutation — lets the scheduler skip the
        # host->device table upload on steps where nothing changed
        self.version = 0
        # most blocks ever simultaneously held (telemetry: the pool size a
        # non-oversubscribed run of this workload would have needed)
        self.high_water = 0

    def allocated(self, slot: int) -> int:
        return len(self._slot_blocks[slot])

    def blocks(self, slot: int) -> List[int]:
        """The slot's physical blocks in logical order (copy)."""
        return list(self._slot_blocks[slot])

    @property
    def used_blocks(self) -> int:
        """Blocks currently held by slots (sink block excluded)."""
        return self.allocator.num_blocks - 1 - self.allocator.free_blocks

    def admit(self, slot: int, length: int,
              shared: Optional[List[int]] = None) -> bool:
        """Allocate pages covering ``length`` positions for a fresh slot.

        ``shared``: physical blocks matched in the radix prefix cache
        (serving/radix_cache.py) forming the head of the slot's logical
        pages.  They are refcounted (copy-on-write — decode never writes
        into them; writes start past the shared prefix in slot-private
        blocks) and only the remainder is freshly allocated, all-or-nothing.
        """
        shared = list(shared or [])
        need = blocks_for(length, self.block_size)
        if need > self.max_blocks:
            raise ValueError(
                f"request needs {need} blocks > max_blocks_per_slot "
                f"{self.max_blocks}; raise max_len/block budget")
        if len(shared) > need:
            raise ValueError(f"{len(shared)} shared blocks exceed the "
                             f"{need}-block request")
        blocks = self.allocator.alloc(need - len(shared))
        if blocks is None:
            return False
        if self._slot_blocks[slot]:
            raise RuntimeError(f"slot {slot} admitted while holding blocks")
        self.allocator.ref(shared)
        self._slot_blocks[slot] = shared + blocks
        self.table[slot, :] = 0
        self.table[slot, :need] = self._slot_blocks[slot]
        self.version += 1
        self.high_water = max(self.high_water, self.used_blocks)
        return True

    def ensure(self, slot: int, pos: int) -> bool:
        """Grow the slot's pages so logical position ``pos`` is writable."""
        need = blocks_for(pos + 1, self.block_size)
        held = self._slot_blocks[slot]
        if need <= len(held):
            return True
        if need > self.max_blocks:
            return False
        blocks = self.allocator.alloc(need - len(held))
        if blocks is None:
            return False
        self.table[slot, len(held):need] = blocks
        held.extend(blocks)
        self.version += 1
        self.high_water = max(self.high_water, self.used_blocks)
        return True

    def trim(self, slot: int, length: int) -> int:
        """Shrink a slot's pages to cover only ``length`` positions.

        The speculative-decode rollback primitive (DESIGN.md §13): a
        rejected draft leaves KV written past the committed length, which
        the masks already hide — but the tail *blocks* the lookahead
        allocated stay held.  Under pool pressure the scheduler trims them
        back to the committed length so waiting requests can admit.
        Returns the number of blocks freed (0 when nothing to trim).
        """
        keep = blocks_for(length, self.block_size)
        held = self._slot_blocks[slot]
        if keep >= len(held):
            return 0
        tail = held[keep:]
        del held[keep:]
        self.allocator.free(tail)
        self.table[slot, keep:] = 0
        self.version += 1
        return len(tail)

    def release(self, slot: int) -> None:
        """Retire a slot: free its blocks, point its table at the sink."""
        self.allocator.free(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self.table[slot, :] = 0
        self.version += 1


# --------------------------------------------------------------------------
# Device-side cache trees
# --------------------------------------------------------------------------

def supports_paged(cfg: ModelConfig) -> bool:
    """Families whose decode cache is plain per-layer GQA K/V blocks."""
    return cfg.family in ("dense", "moe") and not cfg.use_mla


def init_paged_cache(cfg: ModelConfig, num_slots: int, num_blocks: int,
                     block_size: int, max_blocks: int, device, mesh=None) -> Dict[str, Any]:
    """Allocate the block pools (+ zeroed page tables) on ``device``, one
    pool per layer stack under the stack's name; on a ``mesh`` of more than
    one rank, this rank's blocks of them."""
    if not supports_paged(cfg):
        raise ValueError(
            f"the paged KV cache holds the dense and MoE GQA families' k/v, not "
            f"{cfg.family}{'/mla' if cfg.use_mla else ''}: an MLA model's latent cache "
            f"takes the slot layout (init_slot_cache), as in the reference")
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    quant = cfg.kv_cache_dtype == "int8"
    dtype = torch.int8 if quant else cfg.cdtype
    whole = {}
    for name, n in stack_layers(cfg).items():
        shape = (n, num_blocks, block_size, kv, hd)
        stack = {"k": (shape, dtype), "v": (shape, dtype)}
        if quant:
            for leaf in ("k_scale", "v_scale"):
                stack[leaf] = (shape[:-1] + (1,), torch.bfloat16)
        stack["page_table"] = ((n, num_slots, max_blocks), torch.int32)
        whole[name] = {k: torch.empty(sh, dtype=dt, device="meta")
                       for k, (sh, dt) in stack.items()}
    local = (paged_pool_shardings(whole, mesh) if mesh is not None and mesh_size(mesh) > 1
             else None)
    return {name: {k: torch.zeros(local[name][k].local_shape(tuple(t.shape)) if local
                                  else t.shape, dtype=t.dtype, device=device)
                   for k, t in stack.items()}
            for name, stack in whole.items()}


def with_page_table(cache: Dict[str, Any], table: np.ndarray) -> Dict[str, Any]:
    """Copy the host (num_slots, max_blocks) page table into every stack's
    device table, in place (broadcast over L)."""
    for stack in cache.values():
        dst = stack["page_table"]
        src = torch.from_numpy(np.ascontiguousarray(table, np.int32))
        dst.copy_(src.to(dst.device)[None].expand_as(dst))
    return cache


def paged_pool_bytes(cache: Dict[str, Any]) -> int:
    """Persistent device bytes of the block pools (page tables included):
    this rank's, under a mesh."""
    return sum(t.numel() * t.element_size()
               for stack in cache.values() for t in stack.values())


def insert_prefill_paged(cache: Dict[str, Any], prefill_cache: Dict[str, Any],
                         page_row: torch.Tensor, mesh=None) -> Dict[str, Any]:
    """Scatter a batch-1 prefill cache into one slot's pages, in place.

    ``prefill_cache`` leaves are (L, 1, P, KV, hd) from a ``mode="full"``
    forward; ``page_row`` is the slot's (max_blocks,) page-table row.  All P
    padded positions are written: tail positions beyond the prompt map to
    the slot's own partially-filled last block or to the sink block, and are
    either overwritten by decode or masked by the live length.  Quantizes
    on the way in when the pool is int8.  On a ``mesh`` of more than one
    rank the prefill's k/v hold every KV head and this rank's pool its
    block of them: the block is what is written.
    """
    heads = (paged_pool_shardings(prefill_cache, mesh)
             if mesh is not None and mesh_size(mesh) > 1 else None)
    for name, stack in cache.items():
        pool_k = stack["k"]
        n_layers, nb, bs = pool_k.shape[:3]
        p_len = prefill_cache[name]["k"].shape[2]
        j = torch.arange(p_len, device=pool_k.device)
        phys = page_row.to(pool_k.device).long()[j // bs] * bs + j % bs  # (P,)
        new = {leaf: (heads[name][leaf].block(prefill_cache[name][leaf]) if heads
                      else prefill_cache[name][leaf])[:, 0] for leaf in ("k", "v")}
        if "k_scale" in stack:
            new["k"], new["k_scale"] = kvq.quantize_kv(new["k"])
            new["v"], new["v_scale"] = kvq.quantize_kv(new["v"])
        for leaf, vals in new.items():
            pool = stack[leaf]
            flat = pool.view((n_layers, nb * bs) + tuple(pool.shape[3:]))
            flat[:, phys] = vals.to(pool.dtype)
    return cache


# --------------------------------------------------------------------------
# Contiguous slot cache (MLA's latent cache)
# --------------------------------------------------------------------------

def init_slot_cache(cfg: ModelConfig, num_slots: int, max_len: int, device) -> Dict[str, Any]:
    """The contiguous per-slot cache: ``models.lm.init_cache`` sized to the
    slots, on ``device``."""
    return lm.init_cache(cfg, num_slots, max_len, device)


def insert_prefill_rows(cache: Any, prefill_cache: Any, slot: int) -> Any:
    """Write a batch-1 prefill cache into slot row ``slot``, in place.

    Generic over cache trees, as the reference's: a leaf (L, num_slots,
    ...) takes its prefill leaf (L, 1, P, ...) at row ``slot`` and
    positions [0, P) (a state leaf with no sequence axis, wholesale); an
    int8 cache quantizes bf16 k / v on the way in and takes the scales from
    that; leaves the prefill does not hold are left alone."""

    def walk(c, p):
        if isinstance(c, dict):
            for k in c:
                if k in ("k_scale", "v_scale") and isinstance(p, dict) and k not in p:
                    walk(c[k], kvq.quantize_kv(p[k[0]])[1])
                elif isinstance(p, dict) and k in p:
                    src = p[k]
                    if k in ("k", "v") and c[k].dtype == torch.int8 and src.dtype != torch.int8:
                        src = kvq.quantize_kv(src)[0]
                    walk(c[k], src)
            return
        c[(slice(None), slice(slot, slot + 1)) + tuple(slice(0, n) for n in p.shape[2:])] = \
            p.to(c.dtype)

    walk(cache, prefill_cache)
    return cache
