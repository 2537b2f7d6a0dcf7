"""Parameter init, the train step and the serving steps — the counterpart
of ``repro/launch/steps.py`` on one device.

PyTorch runs eagerly, so a "step" here is a plain function over the param
tree.  The serving steps run under ``torch.inference_mode()``.  The train
step is ``build_train_step(run)(state, batch, phase=p)``: the
:class:`TrainState` is PARTITIONED for the sequential-freezing phase
(``core.freezing``), only the trainable partition's leaves require grad,
and the optimizer state exists for that partition only.  The phase also
reaches every factorised projection as the ``freeze_group`` of the
:class:`~repro_torch.kernels.ops.KernelPolicy`, so the frozen factor's
gradient kernel (K3 at phase 0, K4 at phase 1) is never launched.
:func:`repartition_state` is the Algorithm-2 phase swap: it rotates the
optimizer moments, parking the frozen group's on the CPU, so unfreezing
never resets them; with a rank schedule (``core.rank_adapt``) the same swap
shrinks the ranks.

Entry points run on CUDA unless the caller asks for the CPU:
:func:`resolve_device` raises when CUDA is asked for and absent.  The meta
device builds every tree without drawing a value (:func:`init_params`
with ``device="meta"``, and the ``abstract_*`` stand-ins of the dry-run,
``launch/dryrun.py``), on one device: the sharded forms are queue 1 item 8.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import freezing, rank_adapt
from repro_torch.core.decompose import Decomposer
from repro_torch.core.freezing import tree_leaves, tree_map
from repro_torch.core.policy import LM_DEFAULT, NO_LRD
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.models import encdec, lm
from repro_torch.models.common import cross_entropy
from repro_torch.optim import init_moments, init_optimizer
from repro_torch.optim.optimizers import OptState, apply_updates

__all__ = ["resolve_device", "make_decomposer", "init_params", "kernel_policy",
           "run_phase", "TrainState", "make_train_state", "partition_bytes",
           "repartition_state", "build_train_step", "build_prefill_step",
           "build_slot_prefill_step", "build_serve_step", "build_draft_chain",
           "build_verify_step", "build_extend_step", "batch_specs", "abstract_params",
           "abstract_state", "abstract_cache", "decode_extras_specs"]

def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing CUDA when no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    return dev


def make_decomposer(run: RunConfig, device="cuda",
                    generator: Optional[torch.Generator] = None) -> Decomposer:
    """The init-time decomposer of ``run``: its LRD policy, with Algorithm-1
    ranks from the default ``RankResolver`` (the analytic backend at 4096
    probe tokens, as the JAX ``init_params`` builds it) when
    ``lrd.rank_quantize`` is on."""
    policy = (LM_DEFAULT.with_alpha(run.lrd.alpha)
              .with_quantize(run.lrd.rank_quantize)
              .with_min_dim(run.lrd.min_dim)) if run.lrd.enabled else NO_LRD
    return Decomposer(policy, dtype=run.model.pdtype, device=device,
                      generator=generator)


def init_params(run: RunConfig, device="cuda",
                generator: Optional[torch.Generator] = None):
    """(params, plan) drawn from ``generator`` (default: one on ``device``
    seeded with ``run.seed``).  On the meta device nothing is drawn (meta
    has no generator): the same plan, leaf shapes and dtypes, no values."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(run.seed)
    dec = make_decomposer(run, dev, generator)
    if run.model.family == "encdec":
        return encdec.encdec_init(run.model, dec), dec.plan
    return lm.lm_init(run.model, dec), dec.plan


def kernel_policy(run: RunConfig, phase: int = -1) -> KernelPolicy:
    """The kernel-dispatch policy of a run at freezing ``phase``:
    ``lrd.use_pallas_kernel`` turns the hand-written CUDA kernels on (the
    flag keeps the JAX name); group ``phase`` is frozen, so its gradient
    kernel is not launched.

    With ``lrd.pallas_autotune`` each kernel call consults the active
    ``kernels.autotune.TuningTable``; ``lrd.pallas_autotune_table`` names
    the JSON to activate, loaded once: an already active table is never
    replaced, so a CLI or test that installed its own keeps it."""
    if run.lrd.pallas_autotune and run.lrd.pallas_autotune_table:
        from repro_torch.kernels import autotune
        if autotune.get_table() is None:
            autotune.load_table(run.lrd.pallas_autotune_table)
    return KernelPolicy(use_kernel=run.lrd.use_pallas_kernel,
                        freeze_group=freezing.frozen_group_for_phase(phase),
                        int8_decode=run.lrd.int8_decode, autotune=run.lrd.pallas_autotune)


def run_phase(run: RunConfig, epoch: int = 0) -> int:
    """The freezing phase the run sits in at ``epoch`` (-1 when LRD or
    freezing is off)."""
    if not run.lrd.enabled:
        return -1
    return freezing.phase_for_epoch(epoch, run.lrd.freeze_mode, run.lrd.epochs_per_phase)


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

class TrainState(NamedTuple):
    """Partitioned train state: ``trainable``/``frozen`` are complementary
    ``None``-holed views of one param tree; ``opt`` covers the trainable
    partition only.  ``state.params`` merges the two (no copies)."""
    trainable: Any
    frozen: Any
    opt: Any

    @property
    def params(self) -> Any:
        return freezing.merge(self.trainable, self.frozen)


def make_train_state(optim_cfg, params, phase: int = -1):
    """Partition ``params`` for ``phase`` and build the matching state.

    Returns ``(state, parked)``: ``parked = (mu, nu)`` holds the zero
    moments of the frozen partition on the CPU, off the device."""
    trainable, frozen = freezing.partition(params, phase)
    return (TrainState(trainable, frozen, init_optimizer(optim_cfg, trainable)),
            init_moments(optim_cfg, frozen, on_host=True))


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def partition_bytes(state: TrainState) -> Dict[str, int]:
    """Live bytes of each partition of the state; parked moments excluded."""
    return {"trainable_bytes": _tree_bytes(state.trainable),
            "frozen_bytes": _tree_bytes(state.frozen),
            "opt_bytes": _tree_bytes(state.opt)}


def repartition_state(optim_cfg, state: TrainState, parked, new_phase: int, *,
                      schedule: Optional[rank_adapt.RankSchedule] = None,
                      boundary: Optional[int] = None):
    """The Algorithm-2 phase swap, between steps: re-partition the merged
    params for ``new_phase`` and rotate the moment slices — those of leaves
    that stay trainable carry over, those of newly frozen leaves are parked
    on the CPU, and the parked moments of newly unfrozen leaves return to
    the device.  Returns ``(state, parked)``.

    With an active ``schedule`` the swap also adapts the ranks: the groups
    ``rank_adapt.plan_rank_map`` shrinks at ``boundary`` (the swap's index,
    gating ``schedule.start_boundary``) are Eckart–Young-truncated on the
    merged params, both factors computed fresh on their device, and the
    live and parked moment slices are cut to the new rank (parked ones stay
    on the CPU) before the partition is rebuilt, so the step, its grads and
    the optimizer state carry the new shapes only."""
    del optim_cfg  # the moments' dtype is already set
    params = freezing.merge(state.trainable, state.frozen)
    moments = freezing.merge_moments((state.opt.mu, state.opt.nu), parked)
    if schedule is not None and schedule.active:
        trunc = rank_adapt.plan_rank_map(params, schedule, boundary)
        if trunc:
            params = rank_adapt.truncate_params(params, trunc)
            moments = rank_adapt.slice_moments(moments, trunc)
    trainable, frozen = freezing.partition(params, new_phase)
    active, new_parked = freezing.partition_moments(moments, new_phase)
    dev = state.opt.step.device
    opt = OptState(state.opt.step, *(tree_map(lambda t: t.to(dev), a) for a in active))
    return (TrainState(trainable, frozen, opt),
            tuple(tree_map(lambda t: t.cpu(), p) for p in new_parked))


def _forward(params, batch, run: RunConfig, *, mode: str, policy, remat: str = "none",
             return_hidden: bool = False):
    """(logits, cache, aux) of one forward over a batch (the reference's
    ``_forward_full``), and with ``return_hidden`` a decoder LM's
    final-normed hidden state after them (the MTP head's input).  An
    encoder-decoder model first encodes ``batch["frames"]`` with the
    kernels off, as the reference's
    ``encode`` runs (it is given no kernel policy), then decodes
    ``batch["tokens"]`` against that memory; its aux is zero.  A VLM reads
    ``batch["vision_embeddings"]``, as the reference's does."""
    cfg = run.model
    if cfg.family != "encdec":
        vision = batch["vision_embeddings"] if cfg.family == "vlm" else None
        return lm.lm_apply(params, batch["tokens"], cfg, mode=mode, policy=policy,
                           remat=remat, vision_embeddings=vision,
                           return_hidden=return_hidden)
    # remat keeps activations for a backward: train mode only, as lm_apply
    remat = remat if mode == "train" else "none"
    memory = encdec.encode(params, batch["frames"], cfg, remat=remat)
    logits, cache = encdec.decode(params, batch["tokens"], memory, cfg, mode=mode,
                                  policy=policy, remat=remat)
    return logits, cache, torch.zeros((), dtype=torch.float32, device=logits.device)


def _loss_fn(trainable, frozen, batch, run: RunConfig, phase: int) -> torch.Tensor:
    """Mean token NLL of the merged params; for an MTP model plus
    ``mtp_loss_weight`` times the masked NLL of the MTP head's logits
    against the labels shifted left by one (the last two positions
    masked); then ``0.01 * aux`` for a MoE model (the reference's
    load-balance weight).  ``frozen`` leaves carry no grad, so no gradient
    of a frozen leaf is ever built."""
    cfg = run.model
    params = freezing.merge(trainable, frozen)
    policy = kernel_policy(run, phase)
    out = _forward(params, batch, run, mode="train", policy=policy, remat=run.dist.remat,
                   return_hidden=cfg.use_mtp)
    logits, aux = out[0], out[2]
    loss = cross_entropy(logits, batch["labels"])
    if cfg.use_mtp:
        tokens = batch["tokens"]
        mtp = lm.mtp_logits(params, out[3], tokens, cfg, policy=policy)
        loss = loss + cfg.mtp_loss_weight * cross_entropy(
            mtp, torch.roll(batch["labels"], -1, dims=1), mask=lm.mtp_loss_mask(tokens))
    if cfg.num_experts:
        loss = loss + 0.01 * aux
    return loss


def _value_and_grad(trainable, frozen, batch, run: RunConfig, phase: int):
    """(loss, grads over the trainable partition): fresh leaves that require
    grad stand in for the trainable ones; a leaf the loss does not reach
    gets a zero gradient, as under JAX's ``value_and_grad``."""
    leaves = tree_leaves(trainable)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    with torch.enable_grad():
        loss = _loss_fn(tree_map(lambda _: next(it), trainable), frozen, batch, run, phase)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t) for g, t in zip(grads, leaves))
    return loss.detach(), tree_map(lambda _: next(it), trainable)


def build_train_step(run: RunConfig, device="cuda", *, donate: bool = False):
    """Returns ``train_step(state, batch, *, phase) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` (B, S) as numpy arrays or
    tensors (and ``frames`` (B, T, d) for an encoder-decoder model,
    ``vision_embeddings`` (B, image tokens, d) for a VLM); they are moved
    to ``device``.  ``run.dist.microbatches`` > 1
    splits the batch and accumulates the grads in ``run.dist.accum_dtype``.
    ``metrics`` holds the float32 ``loss`` and ``grad_norm`` tensors.  With
    ``donate`` the update is written into the state's own params and
    moments (the reference's train CLI donates its state): the returned
    state shares their tensors, and the one passed in is not to be used
    again."""
    dev = resolve_device(device)
    m = run.dist.microbatches
    adt = getattr(torch, run.dist.accum_dtype)

    def train_step(state: TrainState, batch, *, phase: int):
        # the phase must match the partition, or freeze_group would skip
        # the wrong factor's gradient kernel
        freezing.check_partition(state.trainable, state.frozen, phase)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if m > 1:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=adt, device=p.device),
                            state.trainable)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            parts = {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
                     for k, v in b.items()}
            for i in range(m):
                loss_i, g = _value_and_grad(state.trainable, state.frozen,
                                            {k: v[i] for k, v in parts.items()}, run, phase)
                gsum = tree_map(lambda a, gi: a + gi.to(adt), gsum, g)
                lsum = lsum + loss_i
            loss = lsum / m
            grads = tree_map(lambda g: g / m, gsum)
        else:
            loss, grads = _value_and_grad(state.trainable, state.frozen, b, run, phase)
        new_trainable, new_opt = apply_updates(run.optim, state.trainable, grads, state.opt,
                                               donate=donate)
        # square in the grad dtype, accumulate in float32
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g), dtype=torch.float32)
                               for g in tree_leaves(grads)))
        return (TrainState(new_trainable, state.frozen, new_opt),
                {"loss": loss, "grad_norm": gnorm})

    return train_step


def build_prefill_step(run: RunConfig):
    """Prefill of the fixed-batch path: the whole (B, T) batch at once,
    returning the last position's logits and the cache (the (L, B, T, KV,
    hd) k/v of each stack; for the SSM and hybrid families their recurrent
    states, with the hybrid's shared-block k/v a group; for an
    encoder-decoder model, whose batch also holds ``frames``, the
    decoder's self k/v and the cross k/v of the memory; for a VLM, whose
    batch also holds ``vision_embeddings``, the self k/v and the cross k/v
    of the image tokens)."""
    policy = kernel_policy(run)

    @torch.inference_mode()
    def prefill_step(params, batch):
        logits, cache, _ = _forward(params, batch, run, mode="full", policy=policy)
        return logits[:, -1], cache

    return prefill_step


def build_slot_prefill_step(run: RunConfig):
    """Prefill for the continuous-batching scheduler.

    ``last_pos`` is the index of each row's final real prompt token, so
    prompts padded to the engine's fixed prefill length still hand back the
    logits the first generated token is sampled from.
    """
    cfg, policy = run.model, kernel_policy(run)

    @torch.inference_mode()
    def slot_prefill_step(params, batch, last_pos):
        logits, cache, _ = lm.lm_apply(params, batch["tokens"], cfg, mode="full",
                                       policy=policy)
        idx = torch.as_tensor(last_pos, device=logits.device).reshape(-1).long()
        last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        return last, cache

    return slot_prefill_step


def build_serve_step(run: RunConfig):
    """One decode step at per-slot positions ``pos`` (B,) against a paged
    cache, or at one position for every row against a contiguous cache
    (the fixed-batch path); the cache is updated in place and returned.
    An encoder-decoder model's or a VLM's step reads its cross k/v from the
    cache, telling a cross block by its ``gate``, so it takes no memory or
    vision embeddings (the reference's step is handed ``extras`` that only
    mark its cross blocks)."""
    cfg, policy = run.model, kernel_policy(run)

    @torch.inference_mode()
    def serve_step(params, cache, token, pos):
        if cfg.family == "encdec":
            logits, new_cache = encdec.decode(params, token, None, cfg, mode="decode",
                                              cache=cache, pos=pos, policy=policy)
        else:
            logits, new_cache, _ = lm.lm_apply(params, token, cfg, mode="decode",
                                               cache=cache, pos=pos, policy=policy)
        next_token = torch.argmax(logits[:, -1:], dim=-1).to(token.dtype)
        return logits, new_cache, next_token

    return serve_step


def build_draft_chain(run: RunConfig, k: int):
    """k draft decode steps, each one's argmax fed to the next.  Returns
    ``(cache, chunk)``: chunk (B, k+1) is the pending token followed by the
    k draft tokens, the verify step's input as it stands.  Run it with the
    draft params; the draft KV lands in the shared pool at pos..pos+k-1."""
    cfg, policy = run.model, kernel_policy(run)

    @torch.inference_mode()
    def draft_chain(params, cache, token, pos):
        toks = [token]
        for j in range(k):
            logits, cache, _ = lm.lm_apply(params, toks[-1], cfg, mode="decode",
                                           cache=cache, pos=pos + j, policy=policy)
            toks.append(torch.argmax(logits[:, -1:], dim=-1).to(token.dtype))
        return cache, torch.cat(toks, dim=1)

    return draft_chain


def build_verify_step(run: RunConfig):
    """The speculative verify: a (B, k+1) chunk fed at per-row start
    positions ``pos`` in one full-model forward, writing all k+1 positions.
    Returns ``(cache, next_tokens)``, the greedy next token at every chunk
    position."""
    cfg, policy = run.model, kernel_policy(run)

    @torch.inference_mode()
    def verify_step(params, cache, tokens, pos):
        logits, cache, _ = lm.lm_apply(params, tokens, cfg, mode="decode", cache=cache,
                                       pos=pos, policy=policy)
        return cache, torch.argmax(logits, dim=-1).to(tokens.dtype), logits

    return verify_step


def build_extend_step(run: RunConfig):
    """Suffix prefill onto a radix-cache prefix hit: the (1, P) padded
    suffix fed at ``start`` (the matched prefix length, block-aligned) as a
    chunked decode against a one-slot view of the pools, whose page table
    is the slot's row broadcast over the layers.  Its writes land in the
    slot's private tail blocks (a shared block lies wholly before
    ``start``), and its reads see the shared prefix through the row.  The
    pools are written in place; the full page table is left as it was.
    Returns ``(cache, next_tokens, logits)`` as the verify step does, at
    every suffix position."""
    cfg, policy = run.model, kernel_policy(run)

    @torch.inference_mode()
    def extend_step(params, cache, tokens, page_row, start):
        view = {}
        for name, stack in cache.items():
            row = page_row.to(device=stack["page_table"].device, dtype=torch.int32)
            view[name] = dict(stack, page_table=row.reshape(1, 1, -1).expand(
                stack["page_table"].shape[0], 1, -1))
        pos = torch.as_tensor(start, device=tokens.device).reshape(1)
        logits, _, _ = lm.lm_apply(params, tokens, cfg, mode="decode", cache=view,
                                   pos=pos, policy=policy)
        return cache, torch.argmax(logits, dim=-1).to(tokens.dtype), logits

    return extend_step


# --------------------------------------------------------------------------
# abstract stand-ins (dry-run): meta tensors, one device
# --------------------------------------------------------------------------

META = torch.device("meta")


def batch_specs(run: RunConfig) -> Dict[str, torch.Tensor]:
    """A train or prefill batch of ``run.shape`` on the meta device: int32
    ``tokens`` and ``labels`` (B, S), and an encoder-decoder model's
    ``frames`` or a VLM's ``vision_embeddings`` in the compute dtype."""
    cfg, shp = run.model, run.shape
    b, s = shp.global_batch, shp.seq_len
    out = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META),
           "labels": torch.empty((b, s), dtype=torch.int32, device=META)}
    if cfg.family == "encdec":
        out["frames"] = torch.empty((b, cfg.encoder_frames, cfg.d_model), dtype=cfg.cdtype,
                                    device=META)
    if cfg.family == "vlm":
        out["vision_embeddings"] = torch.empty((b, cfg.num_image_tokens, cfg.d_model),
                                               dtype=cfg.cdtype, device=META)
    return out


def abstract_params(run: RunConfig):
    """The param tree of ``run`` on the meta device."""
    return init_params(run, META)[0]


def abstract_state(run: RunConfig, phase: Optional[int] = None,
                   rank_map: Optional[Dict[str, int]] = None) -> TrainState:
    """The partitioned :class:`TrainState` of ``run`` on the meta device:
    the optimizer stand-ins cover the trainable partition only, so its bytes
    show the structural freeze saving.  ``phase`` defaults to the run's
    epoch-0 phase; ``rank_map`` rewrites factor groups to scheduled ranks
    first (``rank_adapt.decay_rank_maps`` prices each boundary)."""
    if phase is None:
        phase = run_phase(run)
    params = abstract_params(run)
    if rank_map:
        params = rank_adapt.apply_rank_map_to_shapes(params, rank_map)
    return make_train_state(run.optim, params, phase)[0]


def abstract_cache(run: RunConfig):
    """The fixed-batch decode cache of ``run.shape`` (batch, seq_len) on the
    meta device."""
    cfg, shp = run.model, run.shape
    if cfg.family == "encdec":
        return encdec.encdec_init_cache(cfg, shp.global_batch, shp.seq_len, META)
    return lm.init_cache(cfg, shp.global_batch, shp.seq_len, META)


def decode_extras_specs(run: RunConfig):
    """The reference's decode extras on the meta device: an encoder-decoder
    model's ``memory`` or a VLM's ``vision_embeddings`` (B, frames or image
    tokens, d), else None.  The port's decode step reads their k/v from the
    cache and takes neither."""
    cfg, shp = run.model, run.shape
    if cfg.family == "encdec":
        return {"memory": torch.empty((shp.global_batch, cfg.encoder_frames, cfg.d_model),
                                      dtype=cfg.cdtype, device=META)}
    if cfg.family == "vlm":
        return {"vision_embeddings": torch.empty(
            (shp.global_batch, cfg.num_image_tokens, cfg.d_model), dtype=cfg.cdtype,
            device=META)}
    return None
