"""Continuous-batching scheduler: admission queue, slots, fixed-shape steps.

The counterpart of ``repro/serving/scheduler.py`` for the paged layout.
Requests enter a FIFO admission queue; ``num_slots`` decode slots run as
one fixed-shape batch.  A free slot triggers prefill-on-free-slot: the
head-of-queue request is prefilled (batch 1, padded to ``prefill_len``),
its KV is written into the slot's pages, and from the next step on it
decodes beside the other slots.  A request retires the moment it emits
``eos_id`` or reaches ``max_new``; its slot and blocks free at once.

When a growth allocation fails, the youngest slot is preempted: its
request goes back to the queue front with its generated tokens and resumes
later by re-prefilling prompt + generated (exact under greedy decode).

Decode always runs over all ``num_slots`` rows, inactive ones included
(their writes land in the sink block), so the step's shapes never change —
which a CUDA graph of the step will need.  The block pools are updated in
place, where the JAX steps donate them.  Host bookkeeping (queue, slots,
allocator) is plain Python/numpy.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.serving import paged_cache as pc

__all__ = ["Request", "Scheduler"]


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record (times on the trace
    clock: ``t_started`` first prefill start, ``t_first`` first token,
    ``t_done`` retirement; the first two are set once, across preemption)."""

    rid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new: int
    eos_id: Optional[int]
    arrival: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_started: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    preemptions: int = 0
    prefix_hit_len: int = 0  # always 0: no prefix cache in this port yet
    drafted: int = 0  # always 0: no speculative decoding in this port yet
    accepted: int = 0

    @property
    def done(self) -> bool:
        return self.t_done is not None

    def fed_tokens(self) -> np.ndarray:
        """The prompt plus all generated tokens but the last (the pending
        token the next decode step consumes)."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt, np.asarray(self.tokens[:-1], np.int32)])


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0  # logical position the next decode step writes at
    token: int = 0  # pending token (last generated, not yet fed)
    admitted_at: int = 0  # admission counter, for youngest-first preemption

    @property
    def active(self) -> bool:
        return self.req is not None


class Scheduler:
    """Admission queue + slot table + the prefill and decode steps.

    ``num_slots`` decode batch width; ``max_len`` serving window (prompt +
    max_new must fit); ``prefill_len`` fixed padded prompt length (also the
    re-prefill budget of a preemption resume); ``block_size`` positions per
    block; ``num_blocks`` pool size including the sink block (default: fully
    provisioned; lower it to oversubscribe); ``on_token(request, token)``
    fires per generated token.
    """

    def __init__(self, run: RunConfig, params: Any, *, device,
                 num_slots: int = 4, max_len: int = 256,
                 prefill_len: Optional[int] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 on_token: Optional[Callable[[Request, int], None]] = None):
        cfg = run.model
        if not pc.supports_paged(cfg):
            raise ValueError(
                f"the port's scheduler serves the dense decoder family, not "
                f"{cfg.family!r} (ROADMAP queue 1, other model families)")
        self.run_config = run
        self.params = params
        self.device = torch.device(device)
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill_len = min(prefill_len or max_len, max_len)
        self.on_token = on_token
        self.layout = "paged"
        self.block_size = block_size
        max_blocks = pc.blocks_for(max_len, block_size)
        if num_blocks is None:
            num_blocks = 1 + num_slots * max_blocks
        self.pages = pc.PageTableManager(num_slots, max_blocks, num_blocks, block_size)
        self.cache = pc.init_paged_cache(cfg, num_slots, num_blocks, block_size,
                                         max_blocks, self.device)
        self._prefill = steps_mod.build_slot_prefill_step(run)
        self._decode = steps_mod.build_serve_step(run)

        self.queue: Deque[Request] = deque()
        self.slots = [_Slot() for _ in range(num_slots)]
        self.finished: Dict[int, Request] = {}
        self._rid = 0
        self._admit_seq = 0
        self._t0: Optional[float] = None
        self._positions = np.zeros((num_slots,), np.int32)
        self._tokens = np.zeros((num_slots, 1), np.int32)
        self._pt_version = -1  # last page-table version copied to the device
        self._prefill_tokens = 0  # real tokens run through prefill forwards
        #: model forwards run, and how many of them produced a non-finite
        #: logit at a sampled position
        self.forward_stats = {"prefill": 0, "decode": 0, "nonfinite": 0}

    def cache_bytes(self) -> int:
        return pc.paged_pool_bytes(self.cache)

    # -- submission --------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int = 32,
               eos_id: Optional[int] = None, arrival: float = 0.0) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0 or prompt.size > self.prefill_len:
            raise ValueError(f"prompt length {prompt.size} outside (0, prefill_len="
                             f"{self.prefill_len}]")
        if prompt.size + max_new > self.max_len:
            raise ValueError(f"prompt {prompt.size} + max_new {max_new} exceeds "
                             f"max_len {self.max_len}")
        req = Request(self._rid, prompt, max_new, eos_id, arrival=arrival)
        self._rid += 1
        self.queue.append(req)
        return req.rid

    def has_work(self) -> bool:
        return bool(self.queue) or any(s.active for s in self.slots)

    # -- internals ---------------------------------------------------------

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = time.monotonic()
        return time.monotonic() - self._t0

    def _sample(self, logits: torch.Tensor, kind: str) -> np.ndarray:
        """Greedy tokens of (B, V) logits, counting the forward and whether
        its sampled logits were finite (one host read for both)."""
        self.forward_stats[kind] += 1
        tok = torch.argmax(logits, dim=-1)
        finite = torch.isfinite(logits).all().to(tok.dtype)
        out = torch.cat([tok, finite[None]]).cpu().numpy()
        if not out[-1]:
            self.forward_stats["nonfinite"] += 1
        return out[:-1]

    def _emit(self, slot: _Slot, tok: int) -> None:
        req = slot.req
        req.tokens.append(tok)
        if req.t_first is None:
            req.t_first = self._now()
        if self.on_token is not None:
            self.on_token(req, tok)
        if (req.eos_id is not None and tok == req.eos_id) \
                or len(req.tokens) >= req.max_new:
            self._retire(slot)
        else:
            slot.token = tok

    def _retire(self, slot: _Slot) -> None:
        req = slot.req
        req.t_done = self._now()
        self.finished[req.rid] = req
        self._release(slot)

    def _release(self, slot: _Slot) -> None:
        idx = next(i for i, s in enumerate(self.slots) if s is slot)
        self.pages.release(idx)
        slot.req = None
        slot.pos = 0
        self._positions[idx] = 0
        self._tokens[idx, 0] = 0

    def _preemptable(self, slot: _Slot) -> bool:
        """Resume re-prefills prompt + generated[:-1]: possible only while
        that still fits the fixed prefill shape."""
        req = slot.req
        return req.prompt.size + max(len(req.tokens) - 1, 0) <= self.prefill_len

    def _preempt(self, slot: _Slot) -> None:
        slot.req.preemptions += 1
        self.queue.appendleft(slot.req)
        self._release(slot)

    def _admit(self, now: float) -> None:
        for idx, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            req = self.queue[0]
            if req.arrival > now:
                break  # FIFO: later arrivals wait behind the head
            fed = req.fed_tokens()
            # +1 covers the first decode write, so a fresh admission always
            # makes one token of progress before it can be preempted again
            need_len = fed.size + 1
            if not self.pages.admit(idx, need_len):
                if not any(s.active for s in self.slots):
                    raise RuntimeError(
                        f"request {req.rid} needs "
                        f"{pc.blocks_for(need_len, self.block_size)} blocks but "
                        f"the pool has {self.pages.allocator.free_blocks} free at "
                        f"idle — raise num_blocks")
                break  # no pages — wait for a retirement
            self.queue.popleft()
            self._start(idx, slot, req, fed)

    def _start(self, idx: int, slot: _Slot, req: Request, fed: np.ndarray) -> None:
        now = self._now()
        if req.t_started is None:
            req.t_started = now
        self._prefill_tokens += int(fed.size)
        padded = np.zeros((1, self.prefill_len), np.int32)
        padded[0, :fed.size] = fed
        tokens = torch.from_numpy(padded).to(self.device)
        last, pcache = self._prefill(self.params, {"tokens": tokens},
                                     torch.tensor([fed.size - 1], device=self.device))
        pc.insert_prefill_paged(self.cache, pcache,
                                torch.from_numpy(self.pages.table[idx]).to(self.device))
        first_tok = int(self._sample(last, "prefill")[0])
        slot.req = req
        slot.pos = fed.size
        slot.admitted_at = self._admit_seq
        self._admit_seq += 1
        if req.tokens:  # preemption resume: the pending token is known
            slot.token = req.tokens[-1]
        else:
            self._emit(slot, first_tok)

    def _ensure_pages(self) -> None:
        """Grow page tables so every active slot can write at its position;
        preempt youngest-first (possibly the growing slot itself) when the
        pool runs dry."""
        for idx, slot in enumerate(self.slots):
            while slot.active and not self.pages.ensure(idx, slot.pos):
                victims = [s for s in self.slots if s.active and self._preemptable(s)]
                if not victims:
                    raise RuntimeError(
                        "page pool dry and every active request grew past "
                        "prefill_len (cannot re-prefill) — size num_blocks "
                        "for the live working set")
                victim = max(victims, key=lambda s: s.admitted_at)
                self._preempt(victim)
                if victim is slot:
                    break

    # -- the step ----------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> None:
        """Admit what fits, then run one fixed-shape decode step."""
        self._admit(self._now())
        self._ensure_pages()
        active = [(i, s) for i, s in enumerate(self.slots) if s.active]
        if not active:
            return
        for i, s in active:
            self._positions[i] = s.pos
            self._tokens[i, 0] = s.token
        if self._pt_version != self.pages.version:
            pc.with_page_table(self.cache, self.pages.table)
            self._pt_version = self.pages.version
        logits, self.cache, _ = self._decode(
            self.params, self.cache, torch.from_numpy(self._tokens).to(self.device),
            torch.from_numpy(self._positions).to(self.device))
        nxt = self._sample(logits[:, -1], "decode")
        for i, s in active:
            if not s.active:  # preempted between bookkeeping passes
                continue
            s.pos += 1
            self._emit(s, int(nxt[i]))

    def run(self, poll: float = 0.0005) -> Dict[int, np.ndarray]:
        """Drive until queue and slots drain; returns rid -> tokens."""
        while self.has_work():
            if not any(s.active for s in self.slots) and self.queue:
                wait = self.queue[0].arrival - self._now()
                if wait > 0:
                    time.sleep(min(wait, poll * 100))
                    continue
            self.step()
        return {rid: np.asarray(r.tokens, np.int32) for rid, r in self.finished.items()}

    # -- trace stats -------------------------------------------------------

    #: latency_stats() keys (the JAX scheduler's); the speculative and
    #: prefix-cache keys read 0 until those features are ported
    STAT_KEYS = ("requests", "generated_tokens", "tok_per_s",
                 "p50_latency_s", "p95_latency_s", "p99_latency_s",
                 "p50_first_token_s", "p95_first_token_s",
                 "p50_queue_wait_s", "p95_queue_wait_s",
                 "preemptions", "preempted_requests",
                 "spec_steps", "drafted_tokens", "accepted_tokens",
                 "acceptance_rate",
                 "prefill_tokens", "prefix_lookups", "prefix_hits",
                 "prefix_hit_tokens", "prefix_evicted_blocks")

    def reset_stats(self) -> None:
        """Drop finished-request records and re-anchor the trace clock
        (only while idle)."""
        if self.has_work():
            raise RuntimeError("reset_stats with work in flight")
        self.finished.clear()
        self._prefill_tokens = 0
        self._t0 = None

    def latency_stats(self) -> Dict[str, float]:
        """Latency/throughput summary over finished requests, every anchor
        relative to the request's original ``arrival``."""
        reqs = list(self.finished.values())
        if not reqs:
            return {k: 0.0 for k in self.STAT_KEYS}
        lat = np.asarray([r.t_done - r.arrival for r in reqs])
        first = np.asarray([r.t_first - r.arrival for r in reqs])
        wait = np.asarray([(r.t_started or r.arrival) - r.arrival for r in reqs])
        total_tok = sum(len(r.tokens) for r in reqs)
        span = max(max(r.t_done for r in reqs), 1e-9)
        stats = {k: 0.0 for k in self.STAT_KEYS}
        stats.update({
            "requests": float(len(reqs)),
            "generated_tokens": float(total_tok),
            "tok_per_s": total_tok / span,
            "p50_latency_s": float(np.percentile(lat, 50)),
            "p95_latency_s": float(np.percentile(lat, 95)),
            "p99_latency_s": float(np.percentile(lat, 99)),
            "p50_first_token_s": float(np.percentile(first, 50)),
            "p95_first_token_s": float(np.percentile(first, 95)),
            "p50_queue_wait_s": float(np.percentile(wait, 50)),
            "p95_queue_wait_s": float(np.percentile(wait, 95)),
            "preemptions": float(sum(r.preemptions for r in reqs)),
            "preempted_requests": float(sum(1 for r in reqs if r.preemptions)),
            "prefill_tokens": float(self._prefill_tokens),
        })
        return stats
