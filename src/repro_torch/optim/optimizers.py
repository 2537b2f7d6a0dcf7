"""Optimizers (SGD+momentum — the paper's choice — and AdamW) and LR
schedules: the counterpart of ``repro/optim/optimizers.py``.

Plain functions over nested-dict tensor trees under ``torch.no_grad()``,
not ``torch.optim``: the train state is partitioned (frozen leaves are
``None`` holes), and the moments of a frozen factor group are parked on
the host and rotated back at the Algorithm-2 phase swap
(``launch.steps.repartition_state``), which needs the moments as a tree
that can be split per factor group.  The arithmetic is JAX's: float32 for
every update, moments stored in ``state_dtype``, params cast back to their
own dtype.  Updates return new tensors, unless ``apply_updates(...,
donate=True)`` writes them into the params and moments it is given (the
reference's train CLI donates its state, ``donate_argnums=(0,)``): the
same arithmetic, element by element, a slice of a leaf at a time, so no
second copy of the params or moments is ever held.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.configs.base import OptimConfig
from repro_torch.core.freezing import tree_map

__all__ = ["OptState", "make_schedule", "sgdm_init", "adamw_init", "init_optimizer",
           "init_moments", "apply_updates"]


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any  # momentum / first moment
    nu: Any  # second moment (AdamW) or () for SGD


def make_schedule(cfg: OptimConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int tensor, 0-indexed) -> float32 learning rate: linear warmup
    then cosine / linear decay to 0 at ``total_steps``, or constant."""
    base, warm, total = cfg.lr, cfg.warmup_steps, cfg.total_steps

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32) + 1.0  # 1-indexed: first step lr > 0
        warmup = base * step / max(warm, 1)
        if cfg.schedule in ("cosine", "linear"):
            t = torch.clamp((step - warm) / max(total - warm, 1), 0.0, 1.0)
            decay = (base * 0.5 * (1.0 + torch.cos(math.pi * t)) if cfg.schedule == "cosine"
                     else base * (1.0 - t))
        else:  # constant
            decay = torch.full_like(step, base)
        return torch.where(step < warm, warmup, decay)

    return schedule


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _zeros_like(params, dtype, device=None):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device if device is None else device),
                    params)


def _step0(params) -> torch.Tensor:
    from repro_torch.core.freezing import tree_leaves

    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else "cpu")


def sgdm_init(params, state_dtype=torch.float32) -> OptState:
    return OptState(_step0(params), _zeros_like(params, state_dtype), ())


def adamw_init(params, state_dtype=torch.float32) -> OptState:
    return OptState(_step0(params), _zeros_like(params, state_dtype),
                    _zeros_like(params, state_dtype))


def init_optimizer(cfg: OptimConfig, params) -> OptState:
    """Optimizer state over ``params`` — the trainable partition; ``None``
    holes carry through as holes."""
    dt = _dtype(cfg.state_dtype)
    return sgdm_init(params, dt) if cfg.name == "sgdm" else adamw_init(params, dt)


def init_moments(cfg: OptimConfig, params, on_host: bool = False) -> Tuple[Any, Any]:
    """Zero ``(mu, nu)`` slices over ``params`` (``nu = ()`` for SGD) — the
    parked moments of a frozen partition.  ``on_host=True`` puts them on the
    CPU, so the frozen group's moments take no device memory."""
    dt = _dtype(cfg.state_dtype)
    dev = "cpu" if on_host else None
    nu = () if cfg.name == "sgdm" else _zeros_like(params, dt, dev)
    return _zeros_like(params, dt, dev), nu


# elements of a slice of a donated update: float32 temporaries of 256 MB
_SLICE = 1 << 26


def _donated(fn: Callable, out: torch.Tensor, *ins: torch.Tensor) -> torch.Tensor:
    """``out.copy_(fn(*ins))`` a slice of at most ``_SLICE`` elements at a
    time (elementwise, so the same bits as one call); returns ``out``."""
    if not all(t.is_contiguous() for t in (out,) + ins):
        return out.copy_(fn(*ins))
    flat = [t.view(-1) for t in (out,) + ins]
    for i in range(0, out.numel(), _SLICE):
        flat[0][i:i + _SLICE].copy_(fn(*(t[i:i + _SLICE] for t in flat[1:])))
    return out


@torch.no_grad()
def apply_updates(cfg: OptimConfig, params, grads, state: OptState, *, donate: bool = False):
    """One optimizer step over the trainable partition; all trees share one
    hole structure.  Returns ``(new_params, new_state)``; with ``donate``
    their leaves are those of ``params`` and ``state``, updated in place."""
    lr = make_schedule(cfg)(state.step)
    step = state.step + 1
    sdt = _dtype(cfg.state_dtype)
    f32 = torch.float32

    def put(fn):
        return (lambda out, *ins: _donated(fn, out, out, *ins)) if donate else fn

    if cfg.name == "sgdm":
        new_mu = tree_map(put(lambda mu, g: (cfg.momentum * mu.to(f32) + g.to(f32)).to(sdt)),
                          state.mu, grads)
        new_params = tree_map(
            put(lambda p, mu: (p.to(f32) - lr * (mu.to(f32) + cfg.weight_decay * p.to(f32))
                               ).to(p.dtype)),
            params, new_mu)
        return new_params, OptState(step, new_mu, ())

    b1, b2, eps = 0.9, 0.95, 1e-8
    t = step.to(f32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    new_mu = tree_map(put(lambda mu, g: (b1 * mu.to(f32) + (1 - b1) * g.to(f32)).to(sdt)),
                      state.mu, grads)
    new_nu = tree_map(put(lambda nu, g: (b2 * nu.to(f32) + (1 - b2) * torch.square(g.to(f32))
                                         ).to(sdt)),
                      state.nu, grads)

    def upd(p, mu, nu):
        mhat = mu.to(f32) / c1
        vhat = nu.to(f32) / c2
        return (p.to(f32) - lr * (mhat / (torch.sqrt(vhat) + eps)
                                  + cfg.weight_decay * p.to(f32))).to(p.dtype)

    return tree_map(put(upd), params, new_mu, new_nu), OptState(step, new_mu, new_nu)
