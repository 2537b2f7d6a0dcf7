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
:func:`resolve_device` raises when CUDA is asked for and absent.
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
from repro_torch.models import lm
from repro_torch.models.common import cross_entropy
from repro_torch.optim import init_moments, init_optimizer
from repro_torch.optim.optimizers import OptState, apply_updates

__all__ = ["resolve_device", "make_decomposer", "init_params", "kernel_policy",
           "run_phase", "TrainState", "make_train_state", "partition_bytes",
           "repartition_state", "build_train_step", "build_slot_prefill_step",
           "build_serve_step"]

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
    seeded with ``run.seed``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(run.seed)
    dec = make_decomposer(run, dev, generator)
    if run.model.family == "encdec":
        raise NotImplementedError("enc-dec models are not ported yet "
                                  "(ROADMAP queue 1, other model families)")
    return lm.lm_init(run.model, dec), dec.plan


def kernel_policy(run: RunConfig, phase: int = -1) -> KernelPolicy:
    """The kernel-dispatch policy of a run at freezing ``phase``:
    ``lrd.use_pallas_kernel`` turns the hand-written CUDA kernels on (the
    flag keeps the JAX name); group ``phase`` is frozen, so its gradient
    kernel is not launched."""
    return KernelPolicy(use_kernel=run.lrd.use_pallas_kernel,
                        freeze_group=freezing.frozen_group_for_phase(phase),
                        int8_decode=run.lrd.int8_decode)


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


def _loss_fn(trainable, frozen, batch, run: RunConfig, phase: int) -> torch.Tensor:
    """Mean token NLL of the merged params; ``frozen`` leaves carry no grad,
    so no gradient of a frozen leaf is ever built."""
    params = freezing.merge(trainable, frozen)
    logits, _, _ = lm.lm_apply(params, batch["tokens"], run.model, mode="train",
                               policy=kernel_policy(run, phase), remat=run.dist.remat)
    return cross_entropy(logits, batch["labels"])


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


def build_train_step(run: RunConfig, device="cuda"):
    """Returns ``train_step(state, batch, *, phase) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` (B, S) as numpy arrays or
    tensors; they are moved to ``device``.  ``run.dist.microbatches`` > 1
    splits the batch and accumulates the grads in ``run.dist.accum_dtype``.
    ``metrics`` holds the float32 ``loss`` and ``grad_norm`` tensors."""
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
        new_trainable, new_opt = apply_updates(run.optim, state.trainable, grads, state.opt)
        # square in the grad dtype, accumulate in float32
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g), dtype=torch.float32)
                               for g in tree_leaves(grads)))
        return (TrainState(new_trainable, state.frozen, new_opt),
                {"loss": loss, "grad_norm": gnorm})

    return train_step


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
    cache, which is updated in place and returned."""
    cfg, policy = run.model, kernel_policy(run)

    @torch.inference_mode()
    def serve_step(params, cache, token, pos):
        logits, new_cache, _ = lm.lm_apply(params, token, cfg, mode="decode",
                                           cache=cache, pos=pos, policy=policy)
        next_token = torch.argmax(logits[:, -1:], dim=-1).to(token.dtype)
        return logits, new_cache, next_token

    return serve_step
