"""Radix-tree prefix cache over the paged KV block pool — a copy of
``repro/serving/radix_cache.py`` over the port's allocator.

Requests that share a prompt prefix (system prompts, few-shot headers)
should prefill it once: retired requests donate their prompt KV blocks to a
token-keyed radix tree, and admission looks the new prompt up to reuse the
matched blocks copy-on-write.  Sharing is **block-granular** — a prefix
only counts as matched in whole ``block_size`` units, so a shared block is
always completely filled with prefix KV and is never written by its new
holders (their writes start past the shared region, in slot-private
blocks).  That is what keeps the fork copy-on-write with nothing but
refcounts in :class:`~repro_torch.serving.paged_cache.BlockAllocator` — there is
no block copying anywhere.

Tree shape: each edge/node holds a run of tokens whose length is a multiple
of ``block_size`` plus the physical block ids storing their KV.  Children
are keyed by the *full first block* of their token run (a
``tuple`` of ``block_size`` tokens), so lookup is O(blocks) dict hops and
splits only ever happen at block boundaries — two prompts diverging
mid-block share nothing for that block, by construction matching the
copy-on-write granularity.

Eviction: cached-only blocks (``rc == 1`` — held by the tree alone) are
reclaimed LRU-leaf-first, tail blocks before head blocks, so a hot prefix's
head survives longest.  The scheduler tries eviction before youngest-first
preemption — dropping cache beats killing live work (scheduler.py).
Block 0 is the allocator's reserved sink and is never handed out, so it
never enters the tree.

Exactness: a matched prefix skips recomputing KV for those positions, and
the suffix is prefilled through the same chunked forward the verify step
uses, with per-row positions/kv_len masks — greedy decode is token-exact vs
the uncached path (tests/test_torch_radix.py).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.paged_cache import BlockAllocator

__all__ = ["RadixNode", "RadixCache"]


class RadixNode:
    """One edge of the trie: a block-aligned token run + its blocks."""

    __slots__ = ("tokens", "blocks", "children", "parent", "last_used")

    def __init__(self, tokens: Tuple[int, ...], blocks: List[int],
                 parent: Optional["RadixNode"]):
        self.tokens = tokens          # len(tokens) == len(blocks) * bs
        self.blocks = blocks          # physical ids, tree holds one ref each
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.parent = parent
        self.last_used = 0

    def key_of(self, bs: int) -> Tuple[int, ...]:
        return self.tokens[:bs]


class RadixCache:
    """Token-trie over cached prompt-prefix blocks.

    The cache owns one allocator reference per block it indexes; ``match``
    hands blocks out *without* an extra ref (the caller refs them via
    ``PageTableManager.admit(shared=...)``), so between match and admit the
    blocks are protected only by the tree's own ref — callers that run
    eviction in that window must pass them in ``protect``.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self.root = RadixNode((), [], None)
        self._clock = itertools.count(1)
        # telemetry
        self.cached_blocks = 0
        self.evicted_blocks = 0

    # -- lookup ------------------------------------------------------------

    def match(self, tokens: np.ndarray) -> List[int]:
        """Longest block-aligned cached prefix of ``tokens`` -> block ids.

        Touches every node on the path (LRU freshness).  The returned
        prefix length is ``len(result) * block_size``.
        """
        bs = self.block_size
        toks = tuple(int(t) for t in np.asarray(tokens).reshape(-1))
        node, out, i = self.root, [], 0
        now = next(self._clock)
        while len(toks) - i >= bs:
            child = node.children.get(toks[i:i + bs])
            if child is None:
                break
            run = child.tokens
            n_full = min((len(toks) - i) // bs, len(run) // bs)
            if toks[i:i + n_full * bs] != run[:n_full * bs]:
                # first block matched but the run diverges mid-way through a
                # later block of this edge — take the whole-block agreement
                n_full = 0
                for b in range(len(run) // bs):
                    if toks[i + b * bs:i + (b + 1) * bs] != \
                            run[b * bs:(b + 1) * bs]:
                        break
                    n_full = b + 1
            if n_full == 0:
                break
            out.extend(child.blocks[:n_full])
            child.last_used = now
            i += n_full * bs
            if n_full < len(run) // bs:
                break  # partial edge match: nothing deeper can apply
            node = child
        return out

    # -- insertion ---------------------------------------------------------

    def insert(self, tokens: np.ndarray, blocks: List[int]) -> int:
        """Index ``tokens`` (block-aligned prefix thereof) -> ``blocks``.

        Walks the existing path and adopts ONLY the novel tail: blocks
        under an already-cached prefix are left to their current owners (no
        duplicate indexing, no ref leak).  Adopted blocks get one tree ref.
        Returns the number of blocks adopted.
        """
        bs = self.block_size
        toks = tuple(int(t) for t in np.asarray(tokens).reshape(-1))
        n_blocks = min(len(toks) // bs, len(blocks))
        toks = toks[:n_blocks * bs]
        now = next(self._clock)
        node, i = self.root, 0
        while i < n_blocks:
            child = node.children.get(toks[i * bs:(i + 1) * bs])
            if child is None:
                tail_toks = toks[i * bs:]
                tail_blocks = list(blocks[i:n_blocks])
                new = RadixNode(tail_toks, tail_blocks, node)
                new.last_used = now
                node.children[new.key_of(bs)] = new
                self.allocator.ref(tail_blocks)
                self.cached_blocks += len(tail_blocks)
                return len(tail_blocks)
            run = child.tokens
            agree = 0
            for b in range(min(len(run) // bs, n_blocks - i)):
                if toks[(i + b) * bs:(i + b + 1) * bs] != \
                        run[b * bs:(b + 1) * bs]:
                    break
                agree = b + 1
            child.last_used = now
            if agree == len(run) // bs:
                node, i = child, i + agree  # full edge consumed, descend
                continue
            if i + agree == n_blocks:
                return 0  # new tokens are a prefix of this edge: all cached
            # split the edge at the divergence boundary
            self._split(child, agree)
            node, i = child, i + agree
        return 0

    def _split(self, node: RadixNode, at_blocks: int) -> None:
        """Split ``node``'s run after ``at_blocks`` blocks (> 0)."""
        bs = self.block_size
        tail = RadixNode(node.tokens[at_blocks * bs:],
                         node.blocks[at_blocks:], node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        tail.last_used = node.last_used
        node.tokens = node.tokens[:at_blocks * bs]
        node.blocks = node.blocks[:at_blocks]
        node.children = {tail.key_of(bs): tail}

    # -- eviction ----------------------------------------------------------

    def evict(self, need: int, protect=()) -> int:
        """Free up to ``need`` cached-only blocks back to the pool.

        Only blocks whose sole holder is the tree (``rc == 1``) can go, and
        only from leaf edges, tail blocks first — LRU leaves before fresher
        ones.  ``protect``: block ids exempt this pass (a just-matched
        prefix the caller has not refcounted yet).  Returns blocks freed.
        """
        protect = set(protect)
        freed = 0
        while freed < need:
            leaves = [n for n in self._nodes() if not n.children and n.blocks]
            leaves.sort(key=lambda n: n.last_used)
            progress = False
            for leaf in leaves:
                while (freed < need and leaf.blocks
                       and leaf.blocks[-1] not in protect
                       and self.allocator.refcount(leaf.blocks[-1]) == 1):
                    b = leaf.blocks.pop()
                    leaf.tokens = leaf.tokens[:len(leaf.blocks)
                                              * self.block_size]
                    self.allocator.free([b])
                    self.cached_blocks -= 1
                    self.evicted_blocks += 1
                    freed += 1
                    progress = True
                if not leaf.blocks and leaf.parent is not None:
                    del leaf.parent.children[self._key_for(leaf)]
                    progress = True
                if freed >= need:
                    break
            if not progress:
                break  # everything left is shared with live slots/protected
        return freed

    def _key_for(self, leaf: RadixNode) -> Tuple[int, ...]:
        for k, v in leaf.parent.children.items():
            if v is leaf:
                return k
        raise KeyError("detached radix node")

    def _nodes(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                yield n
            stack.extend(n.children.values())

    # -- teardown ----------------------------------------------------------

    def drop_all(self) -> int:
        """Release every tree ref (idle-only reset). Returns blocks freed."""
        freed = 0
        for n in list(self._nodes()):
            self.allocator.free(n.blocks)
            freed += len(n.blocks)
        self.root = RadixNode((), [], None)
        self.cached_blocks = 0
        return freed
