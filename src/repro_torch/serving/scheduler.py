"""Continuous-batching scheduler: admission queue, slots, fixed-shape steps.

The counterpart of ``repro/serving/scheduler.py``.  Requests enter a FIFO
admission queue; ``num_slots`` decode slots run as one fixed-shape batch.
A free slot triggers prefill-on-free-slot: the head-of-queue request is
prefilled (batch 1, padded to ``prefill_len``), its KV is written into the
slot's pages (or its row), and from the next step on it
decodes beside the other slots.  A request retires the moment it emits
``eos_id`` or reaches ``max_new``; its slot and blocks free at once.

Cache layouts (``serving/paged_cache.py``): ``paged`` for the dense and
MoE GQA families (block pools and page tables; when a growth allocation
fails, the youngest slot is preempted: its request goes back to the queue
front with its generated tokens and resumes later by re-prefilling prompt
+ generated, exact under greedy decode), and ``slots`` for an MLA model
(DeepSeek-V3), whose latent cache is already rank-compressed: each slot
owns one row of a contiguous cache and decodes at its own position, so
admission needs no allocator and nothing is preempted.  The radix prefix
cache needs the paged layout: on the slot layout it is off, even when
asked for, as in the reference.

Decode always runs over all ``num_slots`` rows, inactive ones included
(their writes land in the sink block, or in their own free row), so the
step's shapes never change —
which a CUDA graph of the step will need.  The block pools are updated in
place, where the JAX steps donate them.  Host bookkeeping (queue, slots,
allocator) is plain Python/numpy.

Speculative decoding (``speculative_k > 0``, ``serving/speculative.py``):
each step runs k draft decodes with ``draft_params`` and one chunked
full-model verify, and emits the longest matching prefix plus the full
model's next token (1..k+1 tokens a slot, each what plain greedy decode
would emit).  The verify overwrites the draft KV; the rejected tail stays
masked by the live length until later writes reclaim it.  The window is
padded by k so the draft lookahead never leaves a slot's pages.

Prefix cache (``prefix_cache=True``, ``serving/radix_cache.py``): a slot's
full prompt blocks enter a radix tree at admission; a later prompt that
matches whole blocks shares them by refcount and only its suffix is run,
through the extend step, with its writes starting block-aligned past the
shared blocks.

``forward_stats`` counts the model forwards of each kind (prefill,
extend, decode, draft, verify): the JAX scheduler's compile-once contract
(one program per step kind, and no plain decode program while speculating)
becomes "which forwards ran, and how often".

TP-sharded serving (``mesh`` of more than one rank, one process a rank,
``ServeEngine(mesh=...)``): the params and the draft are placed by
``steps.place_served_params`` (factor columns over ``model``), the pools
hold this rank's KV heads (``paged_cache``), and every step runs under the
mesh's rules, so its kernels run on the rank's column blocks and it gathers
activations only.  Every rank must make the same host decisions, or the
ranks' collectives part: the only host input that differs across ranks is
the clock, so rank 0's ``now`` is broadcast once per scheduling step
(``collectives.broadcast_object``, path ``serve/clock``) and every rank
admits, preempts and evicts from that value.  Greedy tokens come from
logits that are whole on every rank; :meth:`check_ranks_agree` raises if
the ranks' tokens differ.  A MoE model's experts are split over ``model``
(``steps.serve_shardings``) and its layers run the reference's expert
parallelism (``models.moe``: EP where the step's length divides the mesh,
its gshard fallback, a decode step's, with the experts' outputs gathered).
MLA is refused under such a mesh (ROADMAP queue 1 item 8).

Telemetry (``obs``, a ``repro_torch.obs.EventLog``): the reference's
per-request lifecycle events (``request_queued``, ``request_prefill``,
``request_first_token``, ``request_retired``, ``request_preempted``), one
``spec_step`` a speculative step and one ``serve_step`` a step that ran a
forward, with the ``serve_*`` and ``spec_*`` series of the default
metrics registry, at the reference's points and with its fields, all from
host state the scheduler holds already (no device read).  Every emit is
guarded by ``obs.active``.  The reference's ``compile_cache`` events are
not emitted: the port compiles nothing, and ``forward_stats`` counts what
ran.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import mesh_size
from repro_torch.launch import steps as steps_mod
from repro_torch.obs import NULL_LOG, EventLog, default_registry
from repro_torch.serving import paged_cache as pc
from repro_torch.serving import speculative
from repro_torch.serving.radix_cache import RadixCache

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
    prefix_hit_len: int = 0  # prompt tokens served from the radix cache
    drafted: int = 0  # speculative draft tokens proposed for this request
    accepted: int = 0  # draft tokens the verify pass kept

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
    fires per generated token; ``speculative_k`` draft tokens a step (0 =
    plain decode) with ``draft_params`` (default ``params``: acceptance 1.0);
    ``prefix_cache`` turns the radix prefix cache on (the paged layout only;
    ``block_size`` and ``num_blocks`` apply to it alone); ``obs`` receives
    the telemetry events (default ``NULL_LOG``: none); ``mesh`` (a
    ``(data, model)`` mesh with data 1) serves TP-sharded, ``params`` and
    ``draft_params`` then being the WHOLE trees on every rank.
    """

    def __init__(self, run: RunConfig, params: Any, *, device,
                 num_slots: int = 4, max_len: int = 256,
                 prefill_len: Optional[int] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 on_token: Optional[Callable[[Request, int], None]] = None,
                 speculative_k: int = 0, draft_params: Any = None,
                 prefix_cache: bool = False, obs: Optional[EventLog] = None, mesh: Any = None):
        cfg = run.model
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"the port's scheduler serves the dense and MoE decoder families, not "
                f"{cfg.family!r}; the ssm, hybrid, encdec and vlm families serve through "
                f"ServeEngine.generate's fixed-batch path, as in the reference (ROADMAP "
                f"queue 1 item 7, other model families)")
        self.mesh = mesh if mesh is not None and mesh_size(mesh) > 1 else None
        if self.mesh is not None and cfg.use_mla:
            raise ValueError(
                f"serving {cfg.name} over a mesh of {mesh_size(mesh)} ranks: MLA is not "
                f"served sharded yet (ROADMAP queue 1 item 8, distributed)")
        self.run_config = run
        self.device = torch.device(device)
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill_len = min(prefill_len or max_len, max_len)
        self.on_token = on_token
        self.obs = obs if obs is not None else NULL_LOG
        self.spec_k = max(int(speculative_k), 0)
        draft = (draft_params if draft_params is not None else params) if self.spec_k else None
        leaves = None
        if self.mesh is not None:
            # each rank's blocks of the whole trees, and the registry the
            # steps' kernel dispatch reads each leaf's split from
            params, leaves = steps_mod.place_served_params(params, self.mesh)
            if draft is not None:
                draft, more = steps_mod.place_served_params(draft, self.mesh, "draft/")
                leaves.update(more)
        self.params = params
        self.draft_params = draft
        self.layout = "paged" if pc.supports_paged(cfg) else "slots"
        self.block_size = block_size
        # the draft lookahead writes up to pos + spec_k: the window covers it
        window = max_len + self.spec_k
        if self.layout == "paged":
            max_blocks = pc.blocks_for(window, block_size)
            if num_blocks is None:
                num_blocks = 1 + num_slots * max_blocks
            self.pages = pc.PageTableManager(num_slots, max_blocks, num_blocks, block_size)
            self.cache = pc.init_paged_cache(cfg, num_slots, num_blocks, block_size,
                                             max_blocks, self.device, self.mesh)
            self.prefix = (RadixCache(self.pages.allocator, block_size) if prefix_cache
                           else None)
        else:
            self.pages = None
            self.cache = pc.init_slot_cache(cfg, num_slots, window, self.device)
            self.prefix = None  # contiguous rows: nothing to share
        on = dict(mesh=self.mesh, leaves=leaves)
        self._prefill = steps_mod.build_slot_prefill_step(run, **on)
        self._decode = steps_mod.build_serve_step(run, **on)
        self._extend = (steps_mod.build_extend_step(run, **on) if self.prefix is not None
                        else None)
        self._draft = (steps_mod.build_draft_chain(run, self.spec_k, **on) if self.spec_k
                       else None)
        self._verify = steps_mod.build_verify_step(run, **on) if self.spec_k else None

        self.queue: Deque[Request] = deque()
        self.slots = [_Slot() for _ in range(num_slots)]
        self.finished: Dict[int, Request] = {}
        self._rid = 0
        self._admit_seq = 0
        self._t0: Optional[float] = None
        self._positions = np.zeros((num_slots,), np.int32)
        self._tokens = np.zeros((num_slots, 1), np.int32)
        self._pt_version = -1  # last page-table version copied to the device
        #: model forwards run by kind (a draft chain is k draft forwards),
        #: and how many of them produced a non-finite logit at a sampled
        #: position (draft forwards are proposals, not checked)
        self.forward_stats = {"prefill": 0, "extend": 0, "decode": 0, "draft": 0,
                              "verify": 0, "nonfinite": 0}
        #: speculative counters (drafted/accepted are token counts over the
        #: active slots; acceptance compares draft tokens with the verify
        #: chunk's greedy choices, whatever a mid-chunk retirement emitted)
        self.spec_stats = {"spec_steps": 0, "drafted": 0, "accepted": 0,
                           "rejected": 0, "emitted": 0}
        #: prefix-cache counters; ``prefill_tokens`` counts the real
        #: (unpadded) tokens run through a prefill or extend forward, with
        #: the cache off too
        self.prefix_stats = {"lookups": 0, "hits": 0, "hit_tokens": 0,
                             "prefill_tokens": 0, "evicted_blocks": 0}

    def acceptance_rate(self) -> float:
        """Draft acceptance since the last ``reset_stats``."""
        st = self.spec_stats
        return st["accepted"] / st["drafted"] if st["drafted"] else 0.0

    def cache_bytes(self) -> int:
        return pc.paged_pool_bytes(self.cache) if self.pages is not None else sum(
            t.numel() * t.element_size() for stack in self.cache.values()
            for t in stack.values())

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
        if self.obs.active:
            self.obs.emit("request_queued", rid=req.rid, prompt_len=int(prompt.size),
                          max_new=max_new, arrival=arrival)
        return req.rid

    def has_work(self) -> bool:
        return bool(self.queue) or any(s.active for s in self.slots)

    # -- internals ---------------------------------------------------------

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = time.monotonic()
        return time.monotonic() - self._t0

    def _clock(self) -> float:
        """The scheduling clock: this rank's ``_now``, or under a mesh rank
        0's, broadcast to every rank (one ``serve/clock`` broadcast)."""
        if self.mesh is None:
            return self._now()
        return collectives.broadcast_object(self._now(), self.mesh, path="serve/clock")

    def check_ranks_agree(self, rids) -> None:
        """Under a mesh, raise on every rank unless every rank generated the
        same tokens for the requests ``rids`` (rank 0's broadcast, path
        ``serve/tokens``, and one ``any_rank`` flag)."""
        if self.mesh is None:
            return
        mine = [list(self.finished[r].tokens) for r in rids]
        first = collectives.broadcast_object(mine, self.mesh, path="serve/tokens")
        if collectives.any_rank(first != mine, self.mesh):
            raise RuntimeError(f"the mesh's ranks generated different tokens (this rank "
                               f"{'agrees with' if first == mine else 'differs from'} rank 0)")

    def _read(self, tokens: torch.Tensor, logits: torch.Tensor, kind: str) -> np.ndarray:
        """``tokens`` on the host, counting the forward of ``kind`` and
        whether its ``logits`` were finite (one host read for both)."""
        self.forward_stats[kind] += 1
        finite = torch.isfinite(logits).all().to(tokens.dtype)
        out = torch.cat([tokens.reshape(-1), finite[None]]).cpu().numpy()
        if not out[-1]:
            self.forward_stats["nonfinite"] += 1
        return out[:-1].reshape(tokens.shape)

    def _sample(self, logits: torch.Tensor, kind: str) -> np.ndarray:
        """Greedy tokens of (B, V) logits (see :meth:`_read`)."""
        return self._read(torch.argmax(logits, dim=-1), logits, kind)

    def _emit(self, slot: _Slot, tok: int) -> None:
        req = slot.req
        req.tokens.append(tok)
        if req.t_first is None:
            req.t_first = self._now()
            if self.obs.active:
                self.obs.emit("request_first_token", rid=req.rid,
                              ttft_s=req.t_first - req.arrival)
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
        if self.obs.active:
            self.obs.emit("request_retired", rid=req.rid, latency_s=req.t_done - req.arrival,
                          tokens=len(req.tokens), preemptions=req.preemptions,
                          drafted_tokens=req.drafted, accepted_tokens=req.accepted,
                          prefix_hit_len=req.prefix_hit_len)
        self._release(slot)

    def _release(self, slot: _Slot) -> None:
        idx = next(i for i, s in enumerate(self.slots) if s is slot)
        if self.pages is not None:
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
        if self.obs.active:
            self.obs.emit("request_preempted", rid=slot.req.rid,
                          generated=len(slot.req.tokens))
        self.queue.appendleft(slot.req)
        self._release(slot)

    def _match_prefix(self, fed: np.ndarray) -> List[int]:
        """Radix lookup for an admission, capped so the suffix keeps at
        least one token: the extend step then has logits to sample from,
        and its writes start block-aligned in slot-private blocks (shared
        blocks are never written)."""
        if self.prefix is None:
            return []
        self.prefix_stats["lookups"] += 1
        blocks = self.prefix.match(fed)
        usable = min(len(blocks), (fed.size - 1) // self.block_size)
        shared = blocks[:usable]
        if shared:
            self.prefix_stats["hits"] += 1
            self.prefix_stats["hit_tokens"] += usable * self.block_size
        return shared

    def _evict(self, need: int, protect=()) -> int:
        freed = self.prefix.evict(need, protect=protect)
        self.prefix_stats["evicted_blocks"] += freed
        return freed

    def _admit(self, now: float) -> None:
        for idx, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            req = self.queue[0]
            if req.arrival > now:
                break  # FIFO: later arrivals wait behind the head
            fed = req.fed_tokens()
            if self.pages is None:  # the slot's row is its allocation
                self.queue.popleft()
                self._start(idx, slot, req, fed, [])
                continue
            # +1 covers the first decode write, so a fresh admission always
            # makes one token of progress before it can be preempted again;
            # +spec_k covers that step's draft lookahead
            need_len = fed.size + 1 + self.spec_k
            shared = self._match_prefix(fed)
            if not self.pages.admit(idx, need_len, shared=shared):
                if self.prefix is not None:
                    # cached-only blocks go before anyone waits; the matched
                    # prefix is not refcounted by the slot yet, so protect it
                    self._evict(pc.blocks_for(need_len, self.block_size) - len(shared)
                                - self.pages.allocator.free_blocks, protect=shared)
                if not self.pages.admit(idx, need_len, shared=shared):
                    if not any(s.active for s in self.slots):
                        # idle: drop the whole cache, the match too, and
                        # retry with a full allocation
                        if self.prefix is not None:
                            self._evict(self.prefix.cached_blocks)
                            shared = []
                            if self.pages.admit(idx, need_len):
                                self.queue.popleft()
                                self._start(idx, slot, req, fed, shared)
                                continue
                        raise RuntimeError(
                            f"request {req.rid} needs "
                            f"{pc.blocks_for(need_len, self.block_size)} blocks but "
                            f"the pool has {self.pages.allocator.free_blocks} free at "
                            f"idle — raise num_blocks")
                    break  # no pages — wait for a retirement
            self.queue.popleft()
            self._start(idx, slot, req, fed, shared)

    def _start(self, idx: int, slot: _Slot, req: Request, fed: np.ndarray,
               shared: List[int]) -> None:
        now = self._now()
        if req.t_started is None:
            req.t_started = now
        hit = len(shared) * self.block_size
        if not req.tokens:
            req.prefix_hit_len = hit
        if self.obs.active:
            self.obs.emit("request_prefill", rid=req.rid, slot=idx, fed_len=int(fed.size),
                          resume=bool(req.tokens),
                          queue_wait_s=max(req.t_started - req.arrival, 0.0),
                          prefix_hit_len=hit)
        self.prefix_stats["prefill_tokens"] += int(fed.size) - hit
        page_row = (torch.from_numpy(self.pages.table[idx]).to(self.device)
                    if self.pages is not None else None)
        padded = np.zeros((1, self.prefill_len), np.int32)
        if hit:
            # the shared blocks hold fed[:hit]'s KV: run only the suffix
            suffix = fed[hit:]
            padded[0, :suffix.size] = suffix
            self.cache, nxt, logits = self._extend(
                self.params, self.cache, torch.from_numpy(padded).to(self.device),
                page_row, hit)
            first_tok = int(self._read(nxt[0, suffix.size - 1:suffix.size],
                                       logits[0, suffix.size - 1], "extend")[0])
        else:
            padded[0, :fed.size] = fed
            last, pcache = self._prefill(self.params,
                                         {"tokens": torch.from_numpy(padded).to(self.device)},
                                         torch.tensor([fed.size - 1], device=self.device))
            if self.pages is not None:
                pc.insert_prefill_paged(self.cache, pcache, page_row, self.mesh)
                steps_mod.clamp_paged_cache(self.cache, self.mesh, self.run_config.model
                                            .num_kv_heads)
            else:
                pc.insert_prefill_rows(self.cache, pcache, idx)
            first_tok = int(self._sample(last, "prefill")[0])
        if self.prefix is not None:
            # index the slot's full prompt blocks; insert() adopts only the
            # part the tree does not hold yet
            n_full = fed.size // self.block_size
            if n_full:
                self.prefix.insert(fed, self.pages.blocks(idx)[:n_full])
        slot.req = req
        slot.pos = fed.size
        slot.admitted_at = self._admit_seq
        self._admit_seq += 1
        if req.tokens:  # preemption resume: the pending token is known
            slot.token = req.tokens[-1]
        else:
            self._emit(slot, first_tok)

    def _ensure_pages(self) -> None:
        """Grow page tables so every active slot can write at its position
        (and its draft lookahead); evict cached-only blocks, then preempt
        youngest-first (possibly the growing slot itself) when the pool
        runs dry.  Nothing to do on the slot layout."""
        if self.pages is None:
            return
        for idx, slot in enumerate(self.slots):
            while slot.active and not self.pages.ensure(idx, slot.pos + self.spec_k):
                if self.prefix is not None and self._evict(
                        pc.blocks_for(slot.pos + self.spec_k + 1, self.block_size)
                        - self.pages.allocated(idx)):
                    continue
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

    def _spec_decode(self, active) -> None:
        """One speculative step: k draft decodes, one chunked verify, then
        the longest matching prefix and the full model's next token,
        emitted one at a time through ``_emit`` (so eos / max_new retire
        mid-chunk as plain decode would)."""
        k = self.spec_k
        pos = torch.from_numpy(self._positions).to(self.device)
        self.cache, chunk_dev = self._draft(self.draft_params, self.cache,
                                            torch.from_numpy(self._tokens).to(self.device), pos)
        self.forward_stats["draft"] += k
        self.cache, verify_dev, logits = self._verify(self.params, self.cache, chunk_dev, pos)
        both = self._read(torch.cat([chunk_dev, verify_dev], dim=1), logits, "verify")
        chunk, verify = both[:, :k + 1], both[:, k + 1:]
        ns = speculative.accept_lengths(chunk, verify)
        drafted = accepted = emitted = 0
        for i, s in active:
            if not s.active:
                continue
            acc = int(ns[i])
            drafted += k
            accepted += acc
            s.req.drafted += k
            s.req.accepted += acc
            for j in range(acc):
                s.pos += 1
                self._emit(s, int(chunk[i, j + 1]))
                emitted += 1
                if not s.active:  # retired mid-chunk (eos / max_new)
                    break
            if s.active:
                s.pos += 1
                self._emit(s, int(verify[i, acc]))
                emitted += 1
        st = self.spec_stats
        st["spec_steps"] += 1
        st["drafted"] += drafted
        st["accepted"] += accepted
        st["rejected"] += drafted - accepted
        st["emitted"] += emitted
        # a dry pool with someone waiting: the lookahead blocks past each
        # slot's committed length are idle, so trim them back
        if (self.pages is not None and self.queue
                and self.pages.allocator.free_blocks == 0):
            for i, s in enumerate(self.slots):
                if s.active:
                    self.pages.trim(i, s.pos + 1)
        if self.obs.active:
            self.obs.emit("spec_step", drafted=drafted, accepted=accepted, emitted=emitted,
                          acceptance_rate=accepted / drafted if drafted else 0.0)
            reg = default_registry()
            reg.counter("spec_drafted_tokens").inc(drafted)
            reg.counter("spec_accepted_tokens").inc(accepted)
            reg.counter("spec_rejected_tokens").inc(drafted - accepted)
            reg.gauge("spec_acceptance_rate").set(self.acceptance_rate())

    # -- the step ----------------------------------------------------------

    @torch.inference_mode()
    def step(self, now: Optional[float] = None) -> None:
        """Admit what fits at ``now`` (default: :meth:`_clock`), then run one
        fixed-shape decode step."""
        self._admit(self._clock() if now is None else now)
        self._ensure_pages()
        active = [(i, s) for i, s in enumerate(self.slots) if s.active]
        if not active:
            return
        for i, s in active:
            self._positions[i] = s.pos
            self._tokens[i, 0] = s.token
        if self.pages is not None and self._pt_version != self.pages.version:
            pc.with_page_table(self.cache, self.pages.table)
            self._pt_version = self.pages.version
        if self.spec_k:
            self._spec_decode(active)
        else:
            logits, self.cache, _ = self._decode(
                self.params, self.cache, torch.from_numpy(self._tokens).to(self.device),
                torch.from_numpy(self._positions).to(self.device))
            nxt = self._sample(logits[:, -1], "decode")
            for i, s in active:
                if not s.active:  # preempted between bookkeeping passes
                    continue
                s.pos += 1
                self._emit(s, int(nxt[i]))
        if self.obs.active:
            self._note_step()

    def _note_step(self) -> None:
        """The ``serve_step`` event of a step that ran, with the pool fields
        on the paged layout, and the registry's occupancy gauges."""
        ev = {"active_slots": sum(1 for s in self.slots if s.active),
              "queued": len(self.queue)}
        if self.pages is not None:
            ev.update(pool_used=self.pages.used_blocks,
                      pool_free=self.pages.allocator.free_blocks,
                      pool_high_water=self.pages.high_water)
        self.obs.emit("serve_step", **ev)
        reg = default_registry()
        reg.gauge("serve_active_slots").set(ev["active_slots"])
        if self.pages is not None:
            reg.gauge("serve_pool_used_blocks").set(ev["pool_used"])
            reg.gauge("serve_pool_high_water").set(ev["pool_high_water"])

    def run(self, poll: float = 0.0005) -> Dict[int, np.ndarray]:
        """Drive until queue and slots drain; returns rid -> tokens."""
        while self.has_work():
            now = self._clock()
            if not any(s.active for s in self.slots) and self.queue:
                wait = self.queue[0].arrival - now
                if wait > 0:
                    time.sleep(min(wait, poll * 100))
                    continue
            self.step(now)
        return {rid: np.asarray(r.tokens, np.int32) for rid, r in self.finished.items()}

    # -- trace stats -------------------------------------------------------

    #: latency_stats() keys (the JAX scheduler's)
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
        for stats in (self.spec_stats, self.prefix_stats):
            for key in stats:
                stats[key] = 0
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
        return {
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
            "spec_steps": float(self.spec_stats["spec_steps"]),
            "drafted_tokens": float(self.spec_stats["drafted"]),
            "accepted_tokens": float(self.spec_stats["accepted"]),
            "acceptance_rate": self.acceptance_rate(),
            "prefill_tokens": float(self.prefix_stats["prefill_tokens"]),
            "prefix_lookups": float(self.prefix_stats["lookups"]),
            "prefix_hits": float(self.prefix_stats["hits"]),
            "prefix_hit_tokens": float(self.prefix_stats["hit_tokens"]),
            "prefix_evicted_blocks": float(self.prefix_stats["evicted_blocks"]),
        }
