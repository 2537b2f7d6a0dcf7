"""Serving engine: continuous batching over the scheduler, and the
fixed-batch path.

The counterpart of ``repro/serving/engine.py``.  ``ServeEngine(run, params,
config=ServeConfig(...), device="cuda")`` routes by ``config.num_slots``:
with ``num_slots > 0`` it owns one
:class:`repro_torch.serving.scheduler.Scheduler` (paged KV pools,
speculative decoding with ``speculative_k``, the radix prefix cache with
``prefix_cache``); ``serve`` submits request dicts and returns
:class:`RequestResult` records, and ``generate`` keeps the batch signature
on top of it.  ``num_slots == 0`` (the default), or a batch whose prompts
do not fit the scheduler's window, takes the fixed-batch path: one prefill
of the whole batch, a contiguous cache padded to the window
(:func:`pad_cache`), and lock-step decode.

With ``speculative_k`` and no ``draft_params`` the draft is derived from
``params`` when the scheduler is first built
(``serving/speculative.py``; ``engine.draft_report`` holds its report).
Int8 KV pools come from ``ModelConfig.kv_cache_dtype == "int8"``, as in the
reference, whose engine never reads ``ServeConfig.kv_int8``: the port
rejects that field rather than ignore it.

The engine runs on CUDA unless ``device="cpu"`` is passed, and raises
without a GPU.  ``config.export != "none"`` runs the Algorithm-1 serving
export (``serving/export.py``) on ``params`` at construction, with the
measured backend's probes timed on the engine's device (``params`` must
already lie there); ``engine.export_report`` holds its report.  With
``export_int8`` every exported group is stored as int8 and served through
K7 (factor pairs, any rank up to 4096) or K6 (merged groups), on the
scheduler and on the fixed-batch path alike, in every family but MoE: a
MoE model serves through the same scheduler and fixed-batch path (every
layer stack gets its pool or padded cache), but its int8 export raises,
since the reference cannot serve int8 expert groups.  An MLA model
(DeepSeek-V3) takes the scheduler's slot layout (its latent cache, one
contiguous row a slot), and its fixed-batch cache pads the ``ckv`` /
``kr`` leaves.  The SSM (xLSTM) and hybrid (Zamba2) families take the
fixed-batch path whatever ``num_slots`` says, as in the reference (its
scheduler serves dense and MoE only): their prefill cache carries
recurrent state leaves, which :func:`pad_cache` leaves as they are, beside
the hybrid's shared-block k/v.  So do the encoder-decoder family and the
VLM family: ``generate(..., extras={"frames": f})`` or
``extras={"vision_embeddings": e}`` puts the frames (which the prefill
encodes) or the image tokens' embeddings in the prefill batch; the decode
steps read the cross k/v from the cache, which
:func:`pad_cache_preserving_cross` keeps at the memory's or the image
tokens' length.  The encoder runs with the kernel policy off, as the
reference's ``encode`` does, so its int8 groups take the weight-only
formula (``ops.int8_apply``'s ``disabled`` branch).  ``obs`` (a
``repro_torch.obs.EventLog``) goes to the scheduler, which emits the
request lifecycle and step events into it; the fixed-batch path emits
none, as in the reference.

TP-sharded serving (one process a rank, ``torch.distributed.run``):
``ServeConfig(mesh_model=N)`` builds ``launch.mesh.make_host_mesh(1, N)``
over the process group, or ``mesh=`` takes a ``(data, model)`` mesh.
Every rank passes the same whole ``params`` (checked by a digest,
``steps.check_same_on_ranks``); the export runs on each rank (the measured
one decided on rank 0) and the draft is derived on each, each checked the
same way; the scheduler places both (``steps.place_served_params``) and
serves with pools of this rank's KV heads; ``serve`` raises unless every
rank generated the same tokens.  Still refused, naming ROADMAP queue 1 item 8:
``mesh_data > 1``, a mesh of other axes, the fixed-batch path (its
families, ``num_slots == 0``, a batch outside the scheduler's shapes), MLA
and ``LRDConfig.int8_decode="bf16"`` (its dequantized products see only a
rank's columns).  A MoE model serves with its experts split over ``model``
(expert parallelism, ``models.moe``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import RunConfig
from repro_torch.distributed.sharding import mesh_size
from repro_torch.launch import steps as steps_mod
from repro_torch.serving.config import RequestResult, ServeConfig

__all__ = ["ServeEngine", "pad_cache", "pad_cache_preserving_cross"]

# leaf name -> axis that indexes kv positions (k_scale/v_scale share k/v's;
# MLA's latent ckv and rope key kr have no head axis); every other leaf (the
# recurrent states ssm, conv, c, n, m) has none
_SEQ_AXIS = {"k": -3, "v": -3, "k_scale": -3, "v_scale": -3, "ckv": -2, "kr": -2}
# families the scheduler serves; the rest take the fixed-batch path
_SCHEDULED = ("dense", "moe")


def _pad_leaf(t: torch.Tensor, name: str, target_len: int) -> torch.Tensor:
    ax = _SEQ_AXIS.get(name)
    if ax is None or t.shape[ax] >= target_len:
        return t
    pad = [0, 0] * t.dim()  # F.pad lists the last axis first
    pad[2 * (-ax - 1) + 1] = target_len - t.shape[ax]
    return F.pad(t, pad)


def pad_cache(cache: Any, target_len: int, skip: Optional[set] = None) -> Any:
    """Zero-pad every kv-position axis of a cache tree to ``target_len``."""

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree if skip and name in skip else _pad_leaf(tree, name, target_len)

    return walk(cache, "")


def pad_cache_preserving_cross(cache: Any, target_len: int) -> Any:
    """Like :func:`pad_cache`, but cross-attention caches (key ``cross``)
    keep their own length."""

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: (v if k == "cross" else walk(v, k)) for k, v in tree.items()}
        return _pad_leaf(tree, name, target_len)

    return walk(cache, "")


_ITEM_8 = "ROADMAP queue 1 item 8, distributed"


def _unported(config: ServeConfig, mesh: Any) -> Optional[str]:
    """The first requested feature this port does not have, or None."""
    if config.kv_int8:
        return ("kv_int8=True: the engine takes int8 KV pools from "
                "ModelConfig.kv_cache_dtype='int8', as the reference does, whose "
                "engine never reads kv_int8 (ROADMAP queue 1 item 5, serving features)")
    if config.mesh_data != 1:
        return (f"mesh_data={config.mesh_data}: data-parallel serving is not ported; a pool "
                f"replicated over data would miss the blocks other ranks' slots write "
                f"({_ITEM_8})")
    if mesh is not None and (tuple(getattr(mesh, "mesh_dim_names", ())) != ("data", "model")
                             or int(mesh.shape[0]) != 1):
        return (f"a serving mesh other than a (data=1, model) host mesh is not ported, got "
                f"{mesh!r} ({_ITEM_8})")
    return None


def _unported_sharded(run: RunConfig, config: ServeConfig) -> Optional[str]:
    """What a multi-rank mesh cannot serve yet, or None."""
    cfg = run.model
    if cfg.family not in _SCHEDULED or config.num_slots == 0:
        return (f"the fixed-batch path ({cfg.family} family, num_slots={config.num_slots}) "
                f"is not served sharded yet ({_ITEM_8})")
    if cfg.use_mla:
        return (f"MLA ({cfg.name}) is not served sharded yet: its latent cache and absorbed "
                f"decode over model ({_ITEM_8})")
    if run.lrd.int8_decode == "bf16":
        return (f"int8_decode='bf16' dequantizes whole weights, which a rank holds only "
                f"columns of ({_ITEM_8})")
    return None


class ServeEngine:
    """Facade over the continuous-batching scheduler and the fixed-batch
    path."""

    def __init__(self, run: RunConfig, params: Any, *, config: Optional[ServeConfig] = None,
                 device="cuda", obs: Any = None, draft_params: Any = None, mesh: Any = None):
        self.config = config or ServeConfig()
        why = _unported(self.config, mesh)
        if why:
            raise ValueError(f"ServeEngine: {why}")
        model = self.config.mesh_model if mesh is None else int(mesh.shape[1])
        why = _unported_sharded(run, self.config) if model > 1 else None
        if why:
            raise ValueError(f"ServeEngine: {why}")
        if mesh is None:
            from repro_torch.launch.mesh import make_host_mesh
            mesh = make_host_mesh(1, model)
        self.mesh = mesh
        self.sharded = mesh_size(mesh) > 1
        if self.config.export_int8 and run.model.num_experts:
            raise ValueError(
                "ServeEngine: an int8 export of a MoE model's expert groups cannot be "
                "served: the reference's _expert_ffn reads only 'kernel' or 'u'/'v' "
                "(ROADMAP queue 3, departures by design)")
        self.device = steps_mod.resolve_device(device)
        self.run = run
        self.params = params
        self.obs = obs
        self.draft_params = draft_params
        self.draft_report = None  # set when a draft is derived lazily
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
        if self.sharded:
            steps_mod.check_same_on_ranks(params, mesh, what="the served params")
        if self.config.export != "none":
            backend = "measured" if self.config.export == "measured" else "analytic-tpu"
            with torch.no_grad():
                self.params, self.export_report = export_for_serving(
                    params, backend=backend, probe_tokens=max(self.config.num_slots, 1),
                    quantize_factors="int8" if self.config.export_int8 else None,
                    mesh=mesh)
            if self.sharded:
                steps_mod.check_same_on_ranks(self.params, mesh, what="the exported trees")
        self._prefill = steps_mod.build_prefill_step(run)
        self._step = steps_mod.build_serve_step(run)
        self._scheduler = None

    @property
    def scheduler(self):
        """The engine's (lazily built, lifetime-shared) scheduler."""
        if self._scheduler is None:
            from repro_torch.serving.scheduler import Scheduler
            c = self.config
            draft = self.draft_params
            if c.speculative_k and draft is None:
                from repro_torch.serving import speculative
                rank_map = speculative.draft_rank_map(self.params, rank=c.spec_rank,
                                                      fraction=c.spec_fraction)
                with torch.no_grad():
                    draft, self.draft_report = speculative.make_draft_params(
                        self.params, rank_map)
            if self.sharded and draft is not None:
                steps_mod.check_same_on_ranks(draft, self.mesh, what="the draft params")
            self._scheduler = Scheduler(
                self.run, self.params, device=self.device, num_slots=c.num_slots,
                max_len=c.max_len, prefill_len=c.prefill_len,
                block_size=c.block_size, num_blocks=c.num_blocks,
                speculative_k=c.speculative_k, draft_params=draft,
                prefix_cache=c.prefix_cache, obs=self.obs, mesh=self.mesh)
        return self._scheduler

    def _scheduler_usable(self, extras, prompt_len: int, max_new: int) -> bool:
        """Prompts must fit the scheduler's fixed prefill and window shapes;
        other batches, batches with extras (an encoder-decoder model's
        frames, a VLM's vision embeddings) and the families it does not
        serve take the fixed-batch path."""
        c = self.config
        eff_prefill = min(c.prefill_len or c.max_len, c.max_len)
        return (c.num_slots > 0 and extras is None
                and self.run.model.family in _SCHEDULED
                and 0 < prompt_len <= eff_prefill
                and prompt_len + max_new <= c.max_len)

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
        sched.check_ranks_agree(rids)
        return [RequestResult.from_request(sched.finished[r]) for r in rids]

    def generate(self, tokens: np.ndarray, max_new: int = 32,
                 extras: Optional[Dict[str, Any]] = None,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """Greedy batched generation. tokens: (B, prompt_len) int32;
        ``extras`` (an encoder-decoder model's ``frames`` (B, T, d), a
        VLM's ``vision_embeddings`` (B, image tokens, d)) join the prefill
        batch.

        Returns (B, n) generated tokens, n <= max_new; rows that finished
        early are padded with ``eos_id`` (or 0).
        """
        tokens = np.asarray(tokens)
        if not self._scheduler_usable(extras, tokens.shape[1], max_new):
            if self.sharded:
                raise ValueError(f"ServeEngine.generate: this batch takes the fixed-batch "
                                 f"path, which is not served sharded yet ({_ITEM_8})")
            return self._generate_fixed(tokens, max_new, extras, eos_id)
        outs = self.serve([{"prompt": row, "max_new": max_new, "eos_id": eos_id}
                           for row in tokens])
        n = max(len(o) for o in outs)
        arr = np.full((len(outs), n), eos_id if eos_id is not None else 0, np.int32)
        for i, o in enumerate(outs):
            arr[i, :len(o)] = o.tokens
        return arr

    @torch.inference_mode()
    def _generate_fixed(self, tokens: np.ndarray, max_new: int,
                        extras: Optional[Dict[str, Any]],
                        eos_id: Optional[int]) -> np.ndarray:
        """Lock-step decode of the whole batch.  As in the reference, the
        cache is the prefill's own (in the compute dtype) padded to the
        window, cross-attention entries kept at the memory's length; rows
        that finished emit ``eos_id`` from then on."""
        b, t = tokens.shape
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in (extras or {}).items()}
        batch["tokens"] = torch.as_tensor(tokens, dtype=torch.int32, device=self.device)
        last, cache = self._prefill(self.params, batch)
        cache = pad_cache_preserving_cross(cache, t + max_new)
        tk = torch.argmax(last, dim=-1).cpu().numpy()[:, None].astype(np.int32)
        out = [tk]
        done = np.zeros((b,), bool)
        if eos_id is not None:
            done |= tk[:, 0] == eos_id
        token = torch.from_numpy(tk).to(self.device)
        for i in range(max_new - 1):
            if done.all():
                break
            pos = torch.tensor(t + i, dtype=torch.int32, device=self.device)
            _, cache, token = self._step(self.params, cache, token, pos)
            tk = token.cpu().numpy().astype(np.int32)
            if eos_id is not None:
                tk = np.where(done[:, None], eos_id, tk).astype(np.int32)
            out.append(tk)
            if eos_id is not None:
                done |= tk[:, 0] == eos_id
        return np.concatenate(out, axis=1)
