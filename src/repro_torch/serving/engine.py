"""Serving engine: continuous batching over the scheduler.

The counterpart of ``repro/serving/engine.py``.  ``ServeEngine(run, params,
config=ServeConfig(num_slots=..., ...), device="cuda")`` owns one
:class:`repro_torch.serving.scheduler.Scheduler`; ``serve`` submits request
dicts and returns :class:`RequestResult` records, ``generate`` keeps the
batch signature on top of it.

The engine runs on CUDA unless ``device="cpu"`` is passed, and raises
without a GPU.  ``config.export != "none"`` runs the Algorithm-1 serving
export (``serving/export.py``) on ``params`` at construction, with the
measured backend's probes timed on the engine's device (``params`` must
already lie there);
``engine.export_report`` holds its report.  Features of the JAX engine that
are not ported yet raise a ``ValueError`` naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.serving.config import RequestResult, ServeConfig

__all__ = ["ServeEngine"]

_SERVING_ITEM = "ROADMAP queue 1 item 5, serving features"


def _unported(config: ServeConfig, obs: Any, draft_params: Any, mesh: Any) -> Optional[str]:
    """The first requested feature this port does not have, or None."""
    if config.num_slots == 0:
        return ("num_slots=0 selects the legacy fixed-batch path, which is not "
                f"ported ({_SERVING_ITEM}); set num_slots > 0")
    if config.speculative_k or draft_params is not None:
        return f"speculative decoding is not ported ({_SERVING_ITEM})"
    if config.prefix_cache:
        return f"the radix prefix cache is not ported ({_SERVING_ITEM})"
    if config.kv_int8:
        return f"int8 KV pools are not ported ({_SERVING_ITEM})"
    if config.mesh_data != 1 or config.mesh_model != 1 or mesh is not None:
        return "the serving mesh is not ported (ROADMAP queue 1, distributed)"
    if obs is not None:
        return "serving telemetry (obs) is not ported (ROADMAP queue 1, telemetry)"
    return None


class ServeEngine:
    """Facade over the continuous-batching scheduler."""

    def __init__(self, run: RunConfig, params: Any, *,
                 config: Optional[ServeConfig] = None, device="cuda",
                 obs: Any = None, draft_params: Any = None, mesh: Any = None):
        self.config = config or ServeConfig()
        why = _unported(self.config, obs, draft_params, mesh)
        if why:
            raise ValueError(f"ServeEngine: {why}")
        self.device = steps_mod.resolve_device(device)
        self.run = run
        self.params = params
        self.export_report = None
        if self.config.export != "none":
            from repro_torch.core.freezing import tree_leaves
            from repro_torch.serving.export import export_for_serving
            off = {str(t.device) for t in tree_leaves(params)
                   if t.device.type != self.device.type}
            if off:
                # the measured export times its probes where the params lie
                raise ValueError(f"ServeEngine: params on {sorted(off)}, engine on "
                                 f"{self.device}; move them before the export")
            backend = "measured" if self.config.export == "measured" else "analytic-tpu"
            with torch.no_grad():
                self.params, self.export_report = export_for_serving(
                    params, backend=backend, probe_tokens=max(self.config.num_slots, 1),
                    quantize_factors="int8" if self.config.export_int8 else None)
        self._scheduler = None

    @property
    def scheduler(self):
        """The engine's (lazily built, lifetime-shared) scheduler."""
        if self._scheduler is None:
            from repro_torch.serving.scheduler import Scheduler
            c = self.config
            self._scheduler = Scheduler(
                self.run, self.params, device=self.device, num_slots=c.num_slots,
                max_len=c.max_len, prefill_len=c.prefill_len,
                block_size=c.block_size, num_blocks=c.num_blocks)
        return self._scheduler

    def serve(self, requests: Sequence[Dict[str, Any]],
              on_token=None) -> List[RequestResult]:
        """Submit request dicts (``{"prompt": 1-D int tokens, "max_new": int,
        "eos_id": Optional[int], "arrival": float seconds}``; only ``prompt``
        required), drain the scheduler, and return one
        :class:`RequestResult` per request in submission order."""
        sched = self.scheduler
        sched.on_token = on_token
        if not sched.has_work():
            sched.reset_stats()
        rids = [sched.submit(np.asarray(r["prompt"], np.int32),
                             max_new=int(r.get("max_new", 32)),
                             eos_id=r.get("eos_id"),
                             arrival=float(r.get("arrival", 0.0)))
                for r in requests]
        with torch.inference_mode():
            sched.run()
        return [RequestResult.from_request(sched.finished[r]) for r in rids]

    def generate(self, tokens: np.ndarray, max_new: int = 32,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """Greedy batched generation. tokens: (B, prompt_len) int32.

        Returns (B, n) generated tokens, n <= max_new; rows that finished
        early are padded with ``eos_id`` (or 0).
        """
        outs = self.serve([{"prompt": row, "max_new": max_new, "eos_id": eos_id}
                           for row in np.asarray(tokens)])
        n = max(len(o) for o in outs)
        arr = np.full((len(outs), n), eos_id if eos_id is not None else 0, np.int32)
        for i, o in enumerate(outs):
            arr[i, :len(o)] = o.tokens
        return arr
