"""Typed serving configuration + structured per-request results.

``ServeConfig`` is the one way to parameterize a
:class:`repro_torch.serving.engine.ServeEngine`: a single frozen value —
slots/lengths, the paged pool, speculative decoding, the int8 / export
artifact knobs, the mesh and the radix prefix cache — validated at
construction.

``RequestResult`` is one request's tokens and lifecycle record; it still
quacks like a token array (``len`` / ``[...]`` / ``np.asarray``).

This is a copy of ``repro/serving/config.py`` for the PyTorch port.  The
port's engine rejects the fields whose features it does not have yet
(speculative decoding, int8 KV pools, the mesh, the prefix cache, the
fixed-batch path) with a ``ValueError`` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

__all__ = ["ServeConfig", "RequestResult"]

_EXPORT_CHOICES = ("none", "analytic", "measured")
_INT8_DECODE_CHOICES = ("native", "bf16")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything a serving engine needs beyond ``(run, params)``.

    Groups (DESIGN.md §14):

    * slots / lengths — ``num_slots`` (0 = legacy fixed-batch path),
      ``max_len``, ``prefill_len``, paged-pool ``block_size``/``num_blocks``;
    * speculative — ``speculative_k`` draft tokens per step plus the draft
      derivation knobs (``spec_rank`` / ``spec_fraction``);
    * artifact — ``export`` backend for the Algorithm-1 serve-time
      rank-quantization, ``export_int8`` factor quantization,
      ``kv_int8`` paged-pool dtype, ``int8_decode`` consumption mode;
    * mesh — ``(mesh_data, mesh_model)`` for the TP-sharded engine
      (params placed under ``FROZEN_PARAM_RULES``, pools sharded over the
      model axis on KV heads);
    * ``prefix_cache`` — the radix-tree prompt-prefix cache over the paged
      block pool (serving/radix_cache.py).
    """

    max_len: int = 256
    num_slots: int = 0
    prefill_len: Optional[int] = None
    block_size: int = 16
    num_blocks: Optional[int] = None
    speculative_k: int = 0
    spec_rank: Optional[int] = None
    spec_fraction: float = 0.5
    kv_int8: bool = False
    export: str = "none"
    export_int8: bool = False
    int8_decode: str = "native"
    mesh_data: int = 1
    mesh_model: int = 1
    prefix_cache: bool = False

    def __post_init__(self):
        def bail(msg):
            raise ValueError(f"ServeConfig: {msg}")

        if self.max_len <= 0:
            bail(f"max_len must be positive, got {self.max_len}")
        if self.num_slots < 0:
            bail(f"num_slots must be >= 0, got {self.num_slots}")
        if self.prefill_len is not None and not (
                0 < self.prefill_len <= self.max_len):
            bail(f"prefill_len {self.prefill_len} outside (0, max_len="
                 f"{self.max_len}]")
        if self.block_size < 1:
            bail(f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks is not None and self.num_blocks < 2:
            bail(f"num_blocks must be >= 2 (block 0 is the reserved sink), "
                 f"got {self.num_blocks}")
        if self.speculative_k < 0:
            bail(f"speculative_k must be >= 0, got {self.speculative_k}")
        if self.num_slots == 0 and self.speculative_k > 0:
            bail(f"speculative_k={self.speculative_k} requires the "
                 f"continuous-batching scheduler, but num_slots=0 selects "
                 f"the legacy fixed-batch path, which has no draft/verify "
                 f"programs and used to silently ignore it — set "
                 f"num_slots > 0 (or speculative_k=0)")
        if self.num_slots == 0 and self.prefix_cache:
            bail("prefix_cache=True requires the paged scheduler "
                 "(num_slots > 0); the legacy fixed-batch path has no "
                 "block pool to share")
        if self.spec_rank is not None and self.spec_rank < 1:
            bail(f"spec_rank must be >= 1 (or None for the Algorithm-1 "
                 f"sweep), got {self.spec_rank}")
        if not 0.0 < self.spec_fraction <= 1.0:
            bail(f"spec_fraction must be in (0, 1], got "
                 f"{self.spec_fraction}")
        if self.export not in _EXPORT_CHOICES:
            bail(f"export must be one of {_EXPORT_CHOICES}, got "
                 f"{self.export!r}")
        if self.export_int8 and self.export == "none":
            bail("export_int8=True quantizes the Algorithm-1 export "
                 "artifact — pick export='analytic' or 'measured'")
        if self.int8_decode not in _INT8_DECODE_CHOICES:
            bail(f"int8_decode must be one of {_INT8_DECODE_CHOICES}, got "
                 f"{self.int8_decode!r}")
        if self.mesh_data < 1 or self.mesh_model < 1:
            bail(f"mesh axes must be >= 1, got mesh_data={self.mesh_data} "
                 f"mesh_model={self.mesh_model}")

    # -- construction paths ------------------------------------------------

    @classmethod
    def from_args(cls, args: Any, **overrides) -> "ServeConfig":
        """Build from an argparse-style namespace (``launch/serve.py`` and
        ``benchmarks/serve_throughput.py`` share this path).

        Reads the CLI flag names (``slots``, ``spec_k``, ``mesh_model``,
        ...), treating 0 as "default" for the optional ints the CLI can't
        express as None; ``overrides`` win over ``args`` (the CLI passes
        the derived ``max_len``/``prefill_len``).
        """
        def get(name, default):
            return getattr(args, name, default)

        export = get("export", "none")
        kw = dict(
            num_slots=get("slots", 0),
            max_len=get("max_len", 0) or 256,
            prefill_len=get("prompt_len", None),
            block_size=get("block_size", 16),
            num_blocks=get("num_blocks", 0) or None,
            speculative_k=get("spec_k", 0),
            spec_rank=get("spec_rank", 0) or None,
            spec_fraction=get("spec_fraction", 0.5),
            kv_int8=bool(get("kv_int8", False)),
            export=export if export in _EXPORT_CHOICES else "none",
            export_int8=bool(get("export_int8", False)),
            int8_decode=get("int8_decode", "native"),
            mesh_data=get("mesh_data", 1),
            mesh_model=get("mesh_model", 1),
            prefix_cache=bool(get("prefix_cache", False)),
        )
        kw.update(overrides)
        return cls(**kw)

    def scheduler_kwargs(self) -> dict:
        """The subset the scheduler constructor consumes."""
        return dict(num_slots=self.num_slots, max_len=self.max_len,
                    prefill_len=self.prefill_len, block_size=self.block_size,
                    num_blocks=self.num_blocks,
                    speculative_k=self.speculative_k,
                    prefix_cache=self.prefix_cache)


@dataclasses.dataclass
class RequestResult:
    """One request's tokens + lifecycle record, returned by ``serve()``.

    Every latency field is measured from the request's ORIGINAL arrival on
    the trace clock (unchanged by preemption).
    """

    rid: int
    tokens: np.ndarray  # (n,) int32 generated tokens
    prompt_len: int
    queue_wait_s: float
    ttft_s: float
    latency_s: float
    preemptions: int
    prefix_hit_len: int  # prompt tokens served from the radix cache
    drafted_tokens: int  # speculative: draft tokens proposed for this request
    accepted_tokens: int  # speculative: draft tokens the verify pass kept

    @property
    def token_count(self) -> int:
        return int(len(self.tokens))

    @property
    def acceptance_rate(self) -> float:
        return (self.accepted_tokens / self.drafted_tokens
                if self.drafted_tokens else 0.0)

    @classmethod
    def from_request(cls, req: Any) -> "RequestResult":
        """Build from a finished ``scheduler.Request``."""
        arrival = req.arrival
        return cls(
            rid=req.rid,
            tokens=np.asarray(req.tokens, np.int32),
            prompt_len=int(req.prompt.size),
            queue_wait_s=max((req.t_started or arrival) - arrival, 0.0),
            ttft_s=(req.t_first - arrival) if req.t_first is not None else 0.0,
            latency_s=(req.t_done - arrival) if req.t_done is not None else 0.0,
            preemptions=req.preemptions,
            prefix_hit_len=int(req.prefix_hit_len or 0),
            drafted_tokens=req.drafted,
            accepted_tokens=req.accepted,
        )

    # -- token-array compatibility ----------------------------------------
    # serve() used to return bare np arrays; results keep quacking like one.

    def __len__(self) -> int:
        return len(self.tokens)

    def __getitem__(self, idx):
        return self.tokens[idx]

    def __iter__(self):
        return iter(self.tokens)

    def __array__(self, dtype=None):
        return np.asarray(self.tokens, dtype)

    def tolist(self):
        return self.tokens.tolist()
