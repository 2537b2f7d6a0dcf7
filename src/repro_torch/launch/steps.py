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

Sharded training (one process a rank; ``launch.mesh``): with a mesh of
more than one rank the state's leaves are each rank's LOCAL blocks under
the placement contract of :func:`state_shardings` — trainable per the
run's param rules (FSDP or TP; an LRD factor's rank dim storage-sharded
over ``data``), frozen under ``FROZEN_PARAM_RULES`` (no data axis: a frozen
factor enters no collective), optimizer moments over the trainable
partition (data-sharded under ``zero1``) — and ``TrainState.shapes`` holds
the merged params' global shapes on the meta device.
:func:`make_sharded_train_state`, :func:`shard_batch`,
:func:`packed_state_shardings` (the elastic restore's target, with
:func:`place_packed`), :func:`check_state_placement` and
``repartition_state(mesh=...)`` are the reference's; ``build_train_step(...,
mesh=)`` gives the sharded step (:func:`_sharded_train_step`), for the dense
and MoE families (a MoE layer's experts over ``model``: ``models.moe``'s
expert parallelism) on one or more microbatches.

Sharded serving (TP over ``model``, one process a rank): the served tree
is placed by :func:`place_served_params` under :func:`serve_shardings` (a
factor's ``v``, and an int8 export's ``v_q`` / ``kernel_q`` with their
column scales, split by columns over ``model``; every other leaf whole),
the paged pools hold this rank's KV heads (``serving.paged_cache``,
``sharding.paged_pool_shardings``), and the serving steps
(``build_*_step(run, mesh=, leaves=)``) run under ``axis_rules(mesh, ...)``
with each served leaf's path and split registered, as the train step
registers them, so the kernel dispatch runs K1 / K5 / K6 / K7 on the
rank's column blocks.  A serving step gathers activations only: no
collective of a serving step carries a param path.
:func:`clamp_paged_cache` checks each echoed pool against its placement;
:func:`cache_specs` is the reference's placement of a fixed-batch cache.

Entry points run on CUDA unless the caller asks for the CPU:
:func:`resolve_device` raises when CUDA is asked for and absent.  The meta
device builds every tree without drawing a value (:func:`init_params`
with ``device="meta"``, and the ``abstract_*`` stand-ins of the dry-run,
``launch/dryrun.py``), on one device.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import freezing, rank_adapt
from repro_torch.core.decompose import Decomposer
from repro_torch.core.freezing import tree_leaves, tree_map
from repro_torch.core.policy import LM_DEFAULT, NO_LRD
from repro_torch.distributed import collectives, compression
from repro_torch.distributed.sharding import (ACT_RULES, ACT_RULES_SP, FROZEN_PARAM_RULES,
                                              PARAM_RULES, PARAM_RULES_NO_FSDP, NamedSharding,
                                              _resolve_spec, axis_rules, axis_sizes,
                                              mesh_size, named_shardings,
                                              paged_pool_shardings, spec_axes)
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.models import encdec, lm
from repro_torch.models.common import cross_entropy
from repro_torch.optim import init_moments, init_optimizer
from repro_torch.optim.optimizers import OptState, apply_updates

__all__ = ["resolve_device", "make_decomposer", "init_params", "kernel_policy",
           "run_phase", "TrainState", "make_train_state", "partition_bytes",
           "repartition_state", "state_shardings", "batch_shardings", "shard_batch",
           "make_sharded_train_state", "packed_state_shardings", "place_packed",
           "check_state_placement", "gather_state", "meta_like", "check_sharded_family",
           "serve_shardings", "place_served_params", "tree_digest", "check_same_on_ranks",
           "cache_specs", "clamp_paged_cache", "build_train_step", "build_prefill_step",
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
    partition only.  ``state.params`` merges the two (no copies).  On a
    mesh of more than one rank the leaves are this rank's blocks and
    ``shapes`` is the merged tree's global shapes on the meta device; else
    ``shapes`` is None and the leaves are whole."""
    trainable: Any
    frozen: Any
    opt: Any
    shapes: Any = None

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
                      mesh=None, run: Optional[RunConfig] = None,
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
    the optimizer state carry the new shapes only.

    With a ``mesh`` of more than one rank (and ``run`` for the rule
    tables) the swap is shard-aware: only the leaves of the factor groups
    ``freezing.groups_to_replace(old, new)`` names, and under a schedule
    the truncated groups, are re-placed (gathered whole, then cut to this
    rank's block under their new placement); every other leaf keeps its
    tensor.  Parked moments are whole CPU tensors with no placement.  Under
    a schedule every factor group is gathered whole to plan and truncate it
    (Eckart–Young needs the whole factors)."""
    if mesh is not None and mesh_size(mesh) > 1:
        return _repartition_sharded(run, state, parked, new_phase, mesh, schedule, boundary)
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


# --------------------------------------------------------------------------
# sharded placement (one process a rank; each leaf this rank's block)
# --------------------------------------------------------------------------

def _param_rules(run: RunConfig):
    if run.dist.param_layout == "zero1":
        return PARAM_RULES_NO_FSDP
    return PARAM_RULES if run.dist.fsdp else PARAM_RULES_NO_FSDP


def _opt_rules(run: RunConfig):
    # ZeRO-1: optimizer state (and the grads it takes) sharded over data too
    if run.dist.param_layout == "zero1":
        return PARAM_RULES
    return _param_rules(run)


def meta_like(tree):
    """``tree``'s shapes and dtypes as meta tensors (no data)."""
    return tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype, device=META), tree)


def _global_shapes(state: TrainState):
    """The merged params' global shapes (meta tensors)."""
    return state.shapes if state.shapes is not None else meta_like(state.params)


def _like(shapes, tree):
    """The leaves of ``shapes`` where ``tree`` has a leaf (holes kept)."""
    if isinstance(tree, dict):
        return {k: _like(shapes[k], v) for k, v in tree.items()}
    return None if tree is None else shapes


def _paths(tree, path=""):
    """The tree of each leaf's param path."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{path}/{k}" if path else k) for k, v in tree.items()}
    return None if tree is None else path


def state_shardings(run: RunConfig, mesh, state: TrainState) -> TrainState:
    """:class:`~repro_torch.distributed.sharding.NamedSharding` tree
    mirroring a partitioned state: trainable under the run's param rules,
    frozen under ``FROZEN_PARAM_RULES``, moments under the optimizer rules,
    the step replicated.  Resolved on the global shapes."""
    shapes = _global_shapes(state)
    tr = named_shardings(_like(shapes, state.trainable), mesh, _param_rules(run))
    fr = named_shardings(_like(shapes, state.frozen), mesh, FROZEN_PARAM_RULES)
    mu = named_shardings(_like(shapes, state.opt.mu), mesh, _opt_rules(run))
    nu = (() if state.opt.nu == ()
          else named_shardings(_like(shapes, state.opt.nu), mesh, _opt_rules(run)))
    return TrainState(tr, fr, OptState(NamedSharding(mesh, ()), mu, nu))


def batch_shardings(batch, mesh):
    """Leading dim over (pod, data) for each leaf of a (global) batch."""
    return {k: NamedSharding(mesh, _resolve_spec(tuple(v.shape),
                                                 ("batch",) + (None,) * (len(v.shape) - 1),
                                                 ACT_RULES, mesh))
            for k, v in batch.items()}


def shard_batch(batch, mesh, device=None):
    """This rank's block of a global batch (numpy arrays or tensors), as
    tensors on ``device``."""
    shs = batch_shardings(batch, mesh)
    return {k: shs[k].block(torch.as_tensor(v)).to(device).contiguous()
            for k, v in batch.items()}


def _block(t: torch.Tensor, sh: NamedSharding, device=None) -> torch.Tensor:
    return sh.block(t).to(device or t.device).contiguous()


def make_sharded_train_state(run: RunConfig, params, phase: int, mesh):
    """:func:`make_train_state` of the whole ``params`` + placement: each
    device leaf cut to this rank's block under :func:`state_shardings`,
    ``parked`` whole on the CPU.  Returns ``(state, parked)``."""
    state, parked = make_train_state(run.optim, params, phase)
    shs = state_shardings(run, mesh, state)
    cut = lambda t, sh: tree_map(_block, t, sh)  # noqa: E731
    opt = OptState(state.opt.step, cut(state.opt.mu, shs.opt.mu),
                   cut(state.opt.nu, shs.opt.nu) if state.opt.nu != () else ())
    return (TrainState(cut(state.trainable, shs.trainable), cut(state.frozen, shs.frozen),
                       opt, meta_like(state.params)), parked)


def packed_state_shardings(run: RunConfig, mesh, phase: int,
                           rank_map: Optional[Dict[str, int]] = None):
    """Target placements of a ``pack_phased_state`` checkpoint tree at
    ``phase`` (the elastic restore's map; :func:`place_packed`): params per
    the phase's partition, active moments under the optimizer rules, and
    ``None`` at the parked moment slices, which stay whole on the CPU.
    ``rank_map`` (the manifest's) rewrites the shapes to the checkpoint's
    ranks first."""
    shapes = abstract_params(run)
    if rank_map:
        shapes = rank_adapt.apply_rank_map_to_shapes(shapes, rank_map)
    trainable, frozen = freezing.partition(shapes, phase)
    params_sh = freezing.merge(named_shardings(trainable, mesh, _param_rules(run)),
                               named_shardings(frozen, mesh, FROZEN_PARAM_RULES))
    mu_sh = named_shardings(trainable, mesh, _opt_rules(run))
    nu_sh = mu_sh if run.optim.name == "adamw" else ()
    return {"params": params_sh, "step": NamedSharding(mesh, ()), "mu": mu_sh, "nu": nu_sh}


def place_packed(saved, shardings, device):
    """A whole checkpoint tree (``load_checkpoint``'s, on the CPU) placed
    under ``shardings``: this rank's block of each leaf with a placement,
    on ``device``; leaves without one (parked moments) stay on the CPU."""

    def walk(t, sh):
        if isinstance(t, dict):
            return {k: walk(v, sh.get(k) if isinstance(sh, dict) else None)
                    for k, v in t.items()}
        if isinstance(t, torch.Tensor) and isinstance(sh, NamedSharding):
            return _block(t, sh, device)
        return t

    return walk(saved, shardings)


def check_state_placement(run: RunConfig, mesh, state: TrainState) -> None:
    """Raise if a leaf of ``state`` deviates from :func:`state_shardings`:
    its shape must be the block its placement implies, and this rank's
    mesh coordinates must be its place in the mesh (the coordinates every
    block was cut at).  Touches no data."""
    if hasattr(mesh, "mesh"):
        where = (mesh.mesh == collectives.process_rank()).nonzero().reshape(-1).tolist()
        if list(mesh.get_coordinate()) != where:
            raise AssertionError(f"mesh coordinates {mesh.get_coordinate()} != {where}")
    shs = state_shardings(run, mesh, state)
    shapes = _global_shapes(state)

    def walk(t, sh, g, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], sh[k], g[k], f"{path}/{k}")
            return
        if t is None:
            return
        want = sh.local_shape(tuple(g.shape))
        if tuple(t.shape) != want:
            raise AssertionError(f"placement drift at {path}: local {tuple(t.shape)} != "
                                 f"{want}, the block of {tuple(g.shape)} under {sh.spec}")

    walk(state.trainable, shs.trainable, _like(shapes, state.trainable), "trainable")
    walk(state.frozen, shs.frozen, _like(shapes, state.frozen), "frozen")
    walk(state.opt.mu, shs.opt.mu, _like(shapes, state.opt.mu), "opt.mu")
    if state.opt.nu != ():
        walk(state.opt.nu, shs.opt.nu, _like(shapes, state.opt.nu), "opt.nu")


def _live_axes(mesh, entry) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in spec_axes(entry) if sizes[a] > 1)


def _reshard(t: torch.Tensor, src, dst, mesh, path: str, *, forbid=()):
    """``t``, this rank's block under spec ``src``, as its block under
    ``dst``: an all-gather along each dim whose axes differ, then a local
    cut.  A gather over an axis in ``forbid`` raises (a frozen leaf: never
    over ``data`` or ``pod``)."""
    src = tuple(src) + (None,) * (t.ndim - len(src))
    dst = tuple(dst) + (None,) * (t.ndim - len(dst))
    cut = []
    for d, (a, b) in enumerate(zip(src, dst)):
        sa, sb = _live_axes(mesh, a), _live_axes(mesh, b)
        if sa == sb:
            continue
        if sa:
            if set(sa) & set(forbid):
                raise AssertionError(f"{path}: placement {src} -> {dst} needs a collective "
                                     f"over {sa}")
            t = collectives.all_gather(t, mesh, sa, d, path=path)
        if sb:
            cut.append((d, sb))
    for d, axes in cut:
        n = collectives.axes_size(mesh, axes)
        size = t.shape[d] // n
        t = t.narrow(d, collectives.coordinate(mesh, axes) * size, size)
    return t.contiguous() if cut else t


def _is_factor(path: str) -> bool:
    return freezing.factor_group(path.rsplit("/", 1)[-1]) is not None


def _scatter_dim(opt_spec, compute_spec, rows, mesh) -> Optional[int]:
    """The dim a gradient whole in ``compute_spec`` can be reduce-scattered
    along into ``opt_spec``: the one dim ``opt_spec`` splits, over exactly
    the live ``rows`` axes; None when there is none."""
    live = [(d, _live_axes(mesh, e)) for d, e in enumerate(opt_spec)]
    split = [(d, a) for d, a in live if a]
    if (len(split) != 1 or split[0][1] != rows or not rows
            or any(_live_axes(mesh, e) for e in compute_spec)):
        return None
    return split[0][0]


def _whole(t: torch.Tensor, sh: NamedSharding, path: str):
    return _reshard(t, sh.spec, (), sh.mesh, path)


def gather_state(state: TrainState, parked, run: RunConfig, mesh):
    """The whole state of a sharded one (every leaf gathered; a collective
    every rank joins), as a one-device :class:`TrainState` with
    ``shapes`` None, and ``parked`` as it is (whole already): what
    ``pack_phased_state`` saves."""
    if state.shapes is None:
        return state, parked
    shs = state_shardings(run, mesh, state)
    whole = lambda t, sh, p: tree_map(_whole, t, sh, p)  # noqa: E731
    paths = _paths(state.params)
    opt = OptState(state.opt.step, whole(state.opt.mu, shs.opt.mu, _like(paths, state.opt.mu)),
                   () if state.opt.nu == () else whole(state.opt.nu, shs.opt.nu,
                                                       _like(paths, state.opt.nu)))
    return TrainState(whole(state.trainable, shs.trainable, _like(paths, state.trainable)),
                      whole(state.frozen, shs.frozen, _like(paths, state.frozen)), opt), parked


def _repartition_sharded(run, state: TrainState, parked, new_phase: int, mesh, schedule,
                         boundary):
    old_phase = freezing.phase_of_partition(state.trainable, state.frozen)
    moved = freezing.groups_to_replace(old_phase, new_phase)
    adapt = schedule is not None and schedule.active
    shs = state_shardings(run, mesh, state)
    shapes = state.shapes
    dev = state.opt.step.device

    def needed(path: str) -> bool:
        g = freezing.factor_group(path.rsplit("/", 1)[-1])
        return _is_factor(path) and (g in moved or adapt)

    def gather(tree, sh):
        return tree_map(lambda t, s, p: _whole(t, s, p) if needed(p) else t, tree, sh,
                        _like(_paths(shapes), tree))

    params = freezing.merge(gather(state.trainable, shs.trainable),
                            gather(state.frozen, shs.frozen))
    live = (gather(state.opt.mu, shs.opt.mu),
            () if state.opt.nu == () else gather(state.opt.nu, shs.opt.nu))
    moments = freezing.merge_moments(live, parked)
    if adapt:
        trunc = rank_adapt.plan_rank_map(params, schedule, boundary)
        if trunc:
            params = rank_adapt.truncate_params(params, trunc)
            moments = rank_adapt.slice_moments(moments, trunc)
            shapes = rank_adapt.apply_rank_map_to_shapes(shapes, trunc)
    trainable, frozen = freezing.partition(params, new_phase)
    active, new_parked = freezing.partition_moments(moments, new_phase)
    new = TrainState(trainable, frozen, OptState(state.opt.step, *active), shapes)
    nshs = state_shardings(run, mesh, new)

    def place(tree, sh):
        # a whole leaf (gathered, truncated or parked) -> this rank's block;
        # a block already placed keeps its tensor
        return tree_map(lambda t, s, g: (_block(t, s, dev) if tuple(t.shape) == tuple(g.shape)
                                         else t), tree, sh, _like(shapes, tree))

    opt = OptState(state.opt.step, place(active[0], nshs.opt.mu),
                   () if active[1] == () else place(active[1], nshs.opt.nu))
    out = TrainState(place(trainable, nshs.trainable), place(frozen, nshs.frozen), opt, shapes)
    return out, tuple(tree_map(lambda t: t.cpu(), p) for p in new_parked)


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


def _value_and_grad(trainable, frozen, batch, run: RunConfig, phase: int,
                    scale: float = 1.0):
    """(loss, grads over the trainable partition): fresh leaves that require
    grad stand in for the trainable ones; a leaf the loss does not reach
    gets a zero gradient, as under JAX's ``value_and_grad``.  ``scale``
    multiplies the loss first (the sharded step's 1 / batch ranks)."""
    leaves = tree_leaves(trainable)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    with torch.enable_grad():
        loss = _loss_fn(tree_map(lambda _: next(it), trainable), frozen, batch, run, phase)
        if scale != 1.0:
            loss = loss * scale
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t) for g, t in zip(grads, leaves))
    return loss.detach(), tree_map(lambda _: next(it), trainable)


def build_train_step(run: RunConfig, device="cuda", *, donate: bool = False, mesh=None):
    """Returns ``train_step(state, batch, *, phase) -> (state, metrics)``.

    With a ``mesh`` of more than one rank the step is the sharded one
    (:func:`_sharded_train_step`): ``state`` is placed
    (:func:`make_sharded_train_state`) and ``batch`` is the GLOBAL batch,
    of which each rank takes its block.

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
    if mesh is not None and mesh_size(mesh) > 1:
        return _sharded_train_step(run, dev, donate, mesh)
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


ITEM_8 = "ROADMAP queue 1 item 8, distributed"


def microbatch_rows(batch, m: int, dp: int):
    """The GLOBAL batch regrouped as the reference regroups it under a mesh,
    ``(m, B / m, ...)``: microbatch i holds rows i B/m + [0, B/m), which
    the step then cuts over the ``dp`` batch ranks (rank r's rows of
    microbatch i are i B/m + [r B/(m dp), (r+1) B/(m dp)); MoE drops depend
    on which tokens share a microbatch).  Raises ValueError where B does
    not divide into m microbatches of dp equal blocks, rather than dropping
    the rest."""
    n = next(iter(batch.values())).shape[0]
    if n % (m * dp):
        raise ValueError(f"a global batch of {n} rows does not divide into {m} microbatches "
                         f"over {dp} batch rank(s)")
    return [{k: v.reshape((m, n // m) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
            for i in range(m)]


def check_sharded_family(run: RunConfig) -> None:
    """The sharded step trains the dense and MoE families (the MoE layer's
    experts over ``model``, :mod:`repro_torch.models.moe`), on any number
    of microbatches.  Raise for the rest: MTP, MLA and the other families
    (the int8 sync of a MoE model, which needs the mesh, is refused where
    the step is built)."""
    cfg = run.model
    if cfg.family not in ("dense", "moe") or cfg.use_mtp or cfg.use_mla:
        what = ("MTP" if cfg.use_mtp else "MLA") if cfg.family in ("dense", "moe") else "it"
        raise ValueError(f"sharded training of the {cfg.family} family ({cfg.name}; {what}) "
                         f"is not ported ({ITEM_8})")


# the leaves the kernel dispatch consumes by column blocks over ``model``: a
# factor's v, and an int8 export's v and merged kernel with their column
# scales (K7 / K6 on the local block)
_COLUMN_LEAVES = ("v", "v_q", "v_scale", "kernel_q", "kernel_scale")


def _is_expert(path: str) -> bool:
    return "/experts/" in path


def _compute_spec(path: str, shape, mesh, manual) -> Tuple:
    """The layout the forward consumes a leaf in: an expert leaf (``kernel``,
    ``u``, ``v`` of ``.../experts/...``, (..., E, a, b)) split over
    ``model`` on its expert dim when E divides (the reference's
    ``P("model", None, None)``: each rank runs its experts); a factor's
    ``v`` (and an int8 export's column leaves) split over ``model`` by
    columns when they divide (the kernel dispatch's block); everything else
    whole."""
    sizes = axis_sizes(mesh)
    msize = sizes.get("model", 1)
    if msize == 1 or "model" in manual:
        return ()
    if _is_expert(path):
        if shape[-3] % msize == 0:
            return (None,) * (len(shape) - 3) + ("model", None, None)
        return ()
    if path.rsplit("/", 1)[-1] in _COLUMN_LEAVES and shape[-1] % msize == 0:
        return (None,) * (len(shape) - 1) + ("model",)
    return ()


def _cols(spec) -> bool:
    """Whether a compute spec splits the columns (the kernel dispatch's
    block), as :func:`sharding.axis_rules`' ``leaves`` registry records."""
    return bool(spec) and spec[-1] == "model"


def _sharded_train_step(run: RunConfig, dev: torch.device, donate: bool, mesh):
    """The sharded train step on this rank's blocks.

    1. Each trainable leaf is all-gathered from its storage placement to the
       layout the forward consumes (whole, a ``v``'s columns over
       ``model``, or an expert leaf's experts over ``model``; FSDP
       granularity: the whole partition, once a step); a frozen leaf is
       never gathered over ``data`` or ``pod`` (checked).
       Under TP, ``FROZEN_PARAM_RULES`` splits ``wo/u`` and ``down/u``'s
       input dim over ``model`` while the dispatch consumes u whole, so
       those are gathered over ``model``, as the reference's ``shard_map``
       (in_spec ``P()``) gathers them.
    2. Forward and backward run on this rank's batch rows, the factorised
       projections through the sharded kernel dispatch (``kernels.ops``),
       which all-reduces each trainable factor's gradient; every other
       trainable gradient, an expert's factors' too (they run ``bmm``, not
       the dispatch), is all-reduced over the batch axes here and never
       over ``model`` (the MoE layer sums its router's over ``model``
       itself), the loss scaled by 1 / (batch ranks) so the sums are the
       global mean's.  With ``grad_compression="int8"`` on a pure
       data-parallel mesh the sync is
       ``compression.value_and_grad_compressed``'s instead.  With
       ``microbatches`` m > 1 the GLOBAL batch is regrouped as (m, B / m,
       ...), each microbatch's rows cut over the batch axes, the gradients
       accumulated in ``accum_dtype`` and synced once after the loop, as
       the reference accumulates under a mesh (and, as there, without the
       int8 sync).
    3. Each synced gradient is brought to its optimizer placement (a
       reduce-scatter for a non-factor gradient whose placement splits one
       dim over the batch axes, as under FSDP and ``zero1``; else a local
       cut, after an all-gather over ``model`` for a ``v`` whose placement
       keeps its columns whole) and ``apply_updates`` runs on the blocks;
       where the optimizer placement differs from the param placement
       (``zero1``) the updated blocks are gathered back to it.
    4. The loss is the batch mean over the data axes, the grad norm the
       global one.  Every collective is recorded with its path
       (``distributed.collectives``).
    """
    check_sharded_family(run)
    act = ACT_RULES_SP if run.dist.sequence_parallel else ACT_RULES
    prm = _param_rules(run)
    m = run.dist.microbatches
    # as in the reference, microbatches take the plain sync: the int8 one
    # is only on the one-microbatch path
    axis = None if m > 1 else compression.manual_axis(mesh, run.dist.grad_compression)
    if axis and run.model.family == "moe":
        raise ValueError(f"the int8 gradient sync of the moe family ({run.model.name}) is not "
                         f"ported ({ITEM_8}): the reference's expert shard_map raises inside "
                         f"the sync's manual {axis!r} region")
    adt = getattr(torch, run.dist.accum_dtype)

    def train_step(state: TrainState, batch, *, phase: int):
        freezing.check_partition(state.trainable, state.frozen, phase)
        shs = state_shardings(run, mesh, state)
        shapes = state.shapes
        paths = _paths(shapes)
        bsh = batch_shardings(batch, mesh)
        rows = _live_axes(mesh, next(iter(bsh.values())).spec[0])
        local = shard_batch(batch, mesh, dev) if m == 1 else None
        mbs = microbatch_rows(batch, m, collectives.axes_size(mesh, rows)) if m > 1 else None
        manual = frozenset({axis}) if axis else frozenset()
        cspec = tree_map(lambda g, p: _compute_spec(p, tuple(g.shape), mesh, manual),
                         shapes, paths)
        tr_p, fr_p = _like(paths, state.trainable), _like(paths, state.frozen)
        tr_c = tree_map(lambda t, sh, c, p: _reshard(t, sh.spec, c, mesh, p),
                        state.trainable, shs.trainable, _like(cspec, state.trainable), tr_p)
        fr_c = tree_map(lambda t, sh, c, p: _reshard(t, sh.spec, c, mesh, p,
                                                     forbid=("data", "pod")),
                        state.frozen, shs.frozen, _like(cspec, state.frozen), fr_p)
        leaves = {}  # path -> (the tensor the forward consumes, columns split)
        for part, ps in ((tr_c, tr_p), (fr_c, fr_p)):
            tree_map(lambda t, p, c: leaves.__setitem__(p, (t, _cols(c))), part, ps,
                     _like(cspec, part))

        osh = shs.opt.mu
        # where the optimizer placement splits one dim over exactly the row
        # axes (FSDP, zero1), a non-factor gradient is reduce-scattered into
        # it; every other one is all-reduced and cut
        scatter = tree_map(lambda o, c, p: (None if _is_factor(p) else
                                            _scatter_dim(o.spec, c, rows, mesh)),
                           osh, _like(cspec, state.trainable), tr_p)

        # the row axes of the context: the int8 region leaves its axis out
        rows_now = tuple(a for a in rows if a not in manual)

        def value_and_grad(trainable_c, b):
            # the loss and grads of this rank's rows, the loss scaled by
            # 1 / (row ranks) so the sums are the mean's
            return _value_and_grad(trainable_c, fr_c, b, run, phase,
                                   scale=1.0 / collectives.axes_size(mesh, rows_now))

        def sync(g, p, d):
            # over the row axes, never over model, where an expert lives on
            # one rank and every other gradient is whole (the MoE layer
            # sums its router's over model itself)
            if _is_factor(p) and not _is_expert(p):
                return g  # the kernel dispatch reduced it
            if d is not None and rows_now == rows:
                return collectives.reduce_scatter(g, mesh, rows_now, d, path=p)
            return collectives.all_reduce(g, mesh, rows_now, path=p)

        def synced(trainable_c, b):
            loss, grads = value_and_grad(trainable_c, b)
            return (collectives.all_reduce(loss.float(), mesh, rows_now, path="loss"),
                    tree_map(sync, grads, tr_p, scatter))

        def accumulated(trainable_c):
            # the reference's microbatch loop under a mesh: each
            # microbatch's rows cut over the batch axes; gradients
            # accumulated in accum_dtype in the layout the forward consumes
            # and synced once after the loop (a factor's by the kernel
            # dispatch, each microbatch)
            gsum = lsum = None
            for mb in mbs:
                loss_i, g = value_and_grad(trainable_c, shard_batch(mb, mesh, dev))
                g = tree_map(lambda t: t.to(adt), g)
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
                lsum = loss_i.float() if lsum is None else lsum + loss_i.float()
            grads = tree_map(lambda t: t / m, tree_map(sync, gsum, tr_p, scatter))
            return collectives.all_reduce(lsum / m, mesh, rows_now, path="loss"), grads

        with axis_rules(mesh, act=act, params=prm, rows=rows, leaves=leaves):
            if m > 1:
                loss, grads = accumulated(tr_c)
            elif axis:
                loss, grads = compression.value_and_grad_compressed(
                    synced, tr_c, local, mesh, axis, tr_p)
            else:
                loss, grads = synced(tr_c, local)
        # the optimizer placement: a local cut of the synced grads (a
        # scattered one is there already)
        scattered = not axis
        grads = tree_map(lambda g, c, sh, p, d: (g if scattered and d is not None else
                                                 _reshard(g, c, sh.spec, mesh, p)),
                         grads, _like(cspec, state.trainable), osh, tr_p, scatter)
        params_o = tree_map(lambda t, sh, o, p: _reshard(t, sh.spec, o.spec, mesh, p),
                            state.trainable, shs.trainable, osh, tr_p)
        new_o, new_opt = apply_updates(run.optim, params_o, grads, state.opt, donate=donate)
        new_trainable = tree_map(lambda t, o, sh, p: _reshard(t, o.spec, sh.spec, mesh, p),
                                 new_o, osh, shs.trainable, tr_p)
        # the global norm: each leaf's local sum of squares, summed over
        # the axes its optimizer placement splits
        by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
        for g, sh in zip(tree_leaves(grads), tree_leaves(osh)):
            key = tuple(a for e in sh.spec for a in _live_axes(mesh, e))
            sq = torch.sum(torch.square(g), dtype=torch.float32)
            by_axes[key] = by_axes[key] + sq if key in by_axes else sq
        gnorm = torch.sqrt(sum(collectives.all_reduce(v, mesh, k, path="grad_norm")
                               for k, v in by_axes.items()))
        return (TrainState(new_trainable, state.frozen, new_opt, shapes),
                {"loss": loss, "grad_norm": gnorm})

    return train_step


# --------------------------------------------------------------------------
# sharded serving (TP over ``model``; one process a rank)
# --------------------------------------------------------------------------

def serve_shardings(params, mesh):
    """:class:`NamedSharding` tree of a whole served param tree on ``mesh``:
    the layout a serving step consumes each leaf in (:func:`_compute_spec`).
    A factor's ``v``, and an int8 export's ``v_q`` / ``kernel_q`` with their
    ``*_scale`` siblings, hold this rank's block of columns over ``model``
    where the columns divide; an expert leaf holds this rank's experts (the
    reference's ``P("model", None, None)``); every other leaf is whole.
    Heterogeneous per-layer ranks (a draft's, an export's) resolve leaf by
    leaf.

    Against the reference's placement, ``named_shardings(params, mesh,
    FROZEN_PARAM_RULES)`` (the int8 leaves resolving through their float
    leaf's pattern), it departs where the reference lets XLA gather or
    partition: ``wo/u``, ``down/u`` (and their int8 ``u_q``) and the
    embedding, which it splits over ``model`` (heads, mlp, vocab), are held
    whole, as the dispatch consumes them, so no serving step gathers a
    param (the sharded train step gathers wo/u and down/u every step);
    ``wo/v``, ``down/v`` and their int8 leaves,
    whose ``embed`` columns it keeps whole, are split by columns like every
    other ``v``; a bf16 ``kernel`` (a merged group of an export without
    int8) and a bias are whole, each rank running that library product in
    full."""
    return tree_map(lambda t, p: NamedSharding(mesh, _compute_spec(p, tuple(t.shape), mesh,
                                                                   frozenset())),
                    params, _paths(params))


def place_served_params(params, mesh, prefix: str = ""):
    """``(local, leaves)`` of a whole served tree, which every rank holds:
    ``local`` is each leaf cut to this rank's block under
    :func:`serve_shardings` (whole leaves kept as they are), ``leaves`` maps
    ``prefix + path`` to ``(block, columns split)`` for ``axis_rules(...,
    leaves=)``.  A local cut: no collective."""
    shs = serve_shardings(params, mesh)
    local = tree_map(lambda t, sh: sh.block(t).contiguous() if any(sh.spec) else t,
                     params, shs)
    leaves = {}
    tree_map(lambda t, sh, p: leaves.__setitem__(prefix + p, (t, _cols(sh.spec))), local, shs,
             _paths(params))
    return local, leaves


def tree_digest(tree, values: bool = True):
    """A host digest of a tensor tree: each leaf's path, shape and dtype,
    and with ``values`` a position-weighted checksum of its bits, summed on
    its device (two trees with the same digest hold the same bits, short of
    a checksum collision)."""
    out = []

    def leaf(t, p):
        item = [p, list(t.shape), str(t.dtype)]
        if values:
            words = t.detach().contiguous().reshape(-1)
            if words.is_floating_point():
                words = words.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                                    1: torch.int8}[words.element_size()])
            w = torch.arange(words.numel(), device=words.device, dtype=torch.int64) % 65521 + 1
            item.append(int(torch.sum(words.long() * w)))
        out.append(item)

    tree_map(leaf, tree, _paths(tree))
    return out


def check_same_on_ranks(tree, mesh, *, what: str, values: bool = True) -> None:
    """Raise on every rank unless each rank of ``mesh`` holds the same
    :func:`tree_digest` of ``tree`` as its first rank (one broadcast under
    ``serve/check``, one ``any_rank`` flag).  Nothing on a one-rank mesh."""
    if mesh is None or mesh_size(mesh) == 1:
        return
    mine = tree_digest(tree, values)
    first = collectives.broadcast_object(mine, mesh, path="serve/check")
    if collectives.any_rank(first != mine, mesh):
        bad = [a[0] for a, b in zip(first, mine) if a != b] or ["(structure)"]
        raise RuntimeError(f"{what} differ across the mesh's ranks (this rank: "
                           f"{'same' if first == mine else 'at ' + ', '.join(bad[:4])})")


# the reference's logical axes of a fixed-batch cache's leaves
_CACHE_AXES = {
    "k": (None, "batch", "kv_seq", "kv_heads", None),
    "v": (None, "batch", "kv_seq", "kv_heads", None),
    "k_scale": (None, "batch", "kv_seq", "kv_heads", None),
    "v_scale": (None, "batch", "kv_seq", "kv_heads", None),
    "ckv": (None, "batch", "kv_seq", None),
    "kr": (None, "batch", "kv_seq", None),
    "ssm": (None, "batch", "heads", None, None),
    "conv": (None, "batch", None, "mlp"),
    "c": (None, "batch", "heads", None, None),
    "n": (None, "batch", "heads", None),
    "m": (None, "batch", "heads"),
}


def cache_specs(cache_shapes, run: RunConfig, mesh):
    """:class:`NamedSharding` tree of a fixed-batch decode cache (tensors
    or meta tensors, e.g. :func:`abstract_cache`'s): each leaf's logical
    axes resolved under the activation rules, as the reference's
    ``cache_specs`` resolves them (batch over the data axes, KV heads over
    ``model`` where they divide)."""
    act = ACT_RULES_SP if run.dist.sequence_parallel else ACT_RULES

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        nd = len(tree.shape)
        axes = _CACHE_AXES.get(name, (None,) * nd)
        axes = ((None,) * (nd - len(axes)) + axes[-nd:] if nd >= len(axes)
                else axes[-nd:])
        return NamedSharding(mesh, _resolve_spec(tuple(tree.shape), axes, act, mesh))

    return walk(cache_shapes, "")


def clamp_paged_cache(cache, mesh, num_kv_heads: int):
    """Check that a paged cache a serving step hands back still holds this
    rank's blocks: each pool leaf (L, num_blocks, block_size, KV, hd), and
    its int8 scales, the KV heads ``sharding.paged_pool_shardings`` gives
    this rank of ``num_kv_heads``, each page table whole, every leaf of a
    stack on one device.  The reference pins its jit outputs' placement
    here; the port writes the pools in place, so nothing can move and this
    is a check (an ``AssertionError`` on drift).  No-op on a one-rank mesh
    and on a slot (non-paged) cache.  Returns ``cache``."""
    if mesh is None or mesh_size(mesh) == 1:
        return cache
    if not any(isinstance(st, dict) and "page_table" in st for st in cache.values()):
        return cache
    for name, stack in cache.items():
        whole = {leaf: torch.empty(tuple(t.shape[:3]) + (num_kv_heads,) + tuple(t.shape[4:])
                                   if leaf != "page_table" else tuple(t.shape), device=META)
                 for leaf, t in stack.items()}
        shs = paged_pool_shardings(whole, mesh)
        devices = {t.device for t in stack.values()}
        for leaf, t in stack.items():
            want = shs[leaf].local_shape(tuple(whole[leaf].shape))
            if tuple(t.shape) != want or len(devices) != 1:
                raise AssertionError(f"paged cache drift at {name}/{leaf}: local "
                                     f"{tuple(t.shape)} on {sorted(map(str, devices))}, want "
                                     f"{want} under {shs[leaf].spec}")
    return cache


def _serve_rules(run: RunConfig, mesh, leaves):
    """The context a serving step runs in: on a mesh of more than one rank
    ``axis_rules`` with the frozen param rules, rows whole (TP only) and
    the served leaves' registry (:func:`place_served_params`); else none."""
    if mesh is None or mesh_size(mesh) == 1:
        return contextlib.nullcontext()
    act = ACT_RULES_SP if run.dist.sequence_parallel else ACT_RULES
    return axis_rules(mesh, act=act, params=FROZEN_PARAM_RULES, rows=(), leaves=leaves or {})


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


def build_slot_prefill_step(run: RunConfig, mesh=None, leaves=None):
    """Prefill for the continuous-batching scheduler.

    ``last_pos`` is the index of each row's final real prompt token, so
    prompts padded to the engine's fixed prefill length still hand back the
    logits the first generated token is sampled from.  On a multi-rank
    ``mesh`` it runs under :func:`_serve_rules` and returns the WHOLE k/v
    (its attention runs on every head); the scheduler writes this rank's
    heads into its pool.
    """
    cfg, policy = run.model, kernel_policy(run)

    @torch.inference_mode()
    def slot_prefill_step(params, batch, last_pos):
        with _serve_rules(run, mesh, leaves):
            logits, cache, _ = lm.lm_apply(params, batch["tokens"], cfg, mode="full",
                                           policy=policy)
        idx = torch.as_tensor(last_pos, device=logits.device).reshape(-1).long()
        last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        return last, cache

    return slot_prefill_step


def build_serve_step(run: RunConfig, mesh=None, leaves=None):
    """One decode step at per-slot positions ``pos`` (B,) against a paged
    cache, or at one position for every row against a contiguous cache
    (the fixed-batch path); the cache is updated in place and returned.
    An encoder-decoder model's or a VLM's step reads its cross k/v from the
    cache, telling a cross block by its ``gate``, so it takes no memory or
    vision embeddings (the reference's step is handed ``extras`` that only
    mark its cross blocks).  On a multi-rank ``mesh`` (the paged path) it
    runs under :func:`_serve_rules` and checks the echoed pool
    (:func:`clamp_paged_cache`); its logits are whole on every rank."""
    cfg, policy = run.model, kernel_policy(run)

    @torch.inference_mode()
    def serve_step(params, cache, token, pos):
        with _serve_rules(run, mesh, leaves):
            if cfg.family == "encdec":
                logits, new_cache = encdec.decode(params, token, None, cfg, mode="decode",
                                                  cache=cache, pos=pos, policy=policy)
            else:
                logits, new_cache, _ = lm.lm_apply(params, token, cfg, mode="decode",
                                                   cache=cache, pos=pos, policy=policy)
        next_token = torch.argmax(logits[:, -1:], dim=-1).to(token.dtype)
        return logits, clamp_paged_cache(new_cache, mesh, cfg.num_kv_heads), next_token

    return serve_step


def build_draft_chain(run: RunConfig, k: int, mesh=None, leaves=None):
    """k draft decode steps, each one's argmax fed to the next.  Returns
    ``(cache, chunk)``: chunk (B, k+1) is the pending token followed by the
    k draft tokens, the verify step's input as it stands.  Run it with the
    draft params; the draft KV lands in the shared pool at pos..pos+k-1.
    ``mesh`` / ``leaves`` as :func:`build_serve_step`'s."""
    cfg, policy = run.model, kernel_policy(run)

    @torch.inference_mode()
    def draft_chain(params, cache, token, pos):
        toks = [token]
        with _serve_rules(run, mesh, leaves):
            for j in range(k):
                logits, cache, _ = lm.lm_apply(params, toks[-1], cfg, mode="decode",
                                               cache=cache, pos=pos + j, policy=policy)
                toks.append(torch.argmax(logits[:, -1:], dim=-1).to(token.dtype))
        return clamp_paged_cache(cache, mesh, cfg.num_kv_heads), torch.cat(toks, dim=1)

    return draft_chain


def build_verify_step(run: RunConfig, mesh=None, leaves=None):
    """The speculative verify: a (B, k+1) chunk fed at per-row start
    positions ``pos`` in one full-model forward, writing all k+1 positions.
    Returns ``(cache, next_tokens)``, the greedy next token at every chunk
    position.  ``mesh`` / ``leaves`` as :func:`build_serve_step`'s."""
    cfg, policy = run.model, kernel_policy(run)

    @torch.inference_mode()
    def verify_step(params, cache, tokens, pos):
        with _serve_rules(run, mesh, leaves):
            logits, cache, _ = lm.lm_apply(params, tokens, cfg, mode="decode", cache=cache,
                                           pos=pos, policy=policy)
        return (clamp_paged_cache(cache, mesh, cfg.num_kv_heads),
                torch.argmax(logits, dim=-1).to(tokens.dtype), logits)

    return verify_step


def build_extend_step(run: RunConfig, mesh=None, leaves=None):
    """Suffix prefill onto a radix-cache prefix hit: the (1, P) padded
    suffix fed at ``start`` (the matched prefix length, block-aligned) as a
    chunked decode against a one-slot view of the pools, whose page table
    is the slot's row broadcast over the layers.  Its writes land in the
    slot's private tail blocks (a shared block lies wholly before
    ``start``), and its reads see the shared prefix through the row.  The
    pools are written in place; the full page table is left as it was.
    Returns ``(cache, next_tokens, logits)`` as the verify step does, at
    every suffix position.  ``mesh`` / ``leaves`` as
    :func:`build_serve_step`'s."""
    cfg, policy = run.model, kernel_policy(run)

    @torch.inference_mode()
    def extend_step(params, cache, tokens, page_row, start):
        view = {}
        for name, stack in cache.items():
            row = page_row.to(device=stack["page_table"].device, dtype=torch.int32)
            view[name] = dict(stack, page_table=row.reshape(1, 1, -1).expand(
                stack["page_table"].shape[0], 1, -1))
        pos = torch.as_tensor(start, device=tokens.device).reshape(1)
        with _serve_rules(run, mesh, leaves):
            logits, _, _ = lm.lm_apply(params, tokens, cfg, mode="decode", cache=view,
                                       pos=pos, policy=policy)
        return (clamp_paged_cache(cache, mesh, cfg.num_kv_heads),
                torch.argmax(logits, dim=-1).to(tokens.dtype), logits)

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
