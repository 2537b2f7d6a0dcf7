"""Parameter init and the serving steps — the serve half of
``repro/launch/steps.py``.

PyTorch runs eagerly, so a "step" here is a plain function over the param
tree; each runs under ``torch.inference_mode()`` (this slice has no
backward).  Entry points run on CUDA unless the caller asks for the CPU:
:func:`resolve_device` raises when CUDA is asked for and absent.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.decompose import Decomposer
from repro_torch.core.policy import LM_DEFAULT, NO_LRD
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.models import lm

__all__ = ["resolve_device", "make_decomposer", "init_params", "kernel_policy",
           "build_slot_prefill_step", "build_serve_step"]


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


def kernel_policy(run: RunConfig) -> KernelPolicy:
    """The kernel-dispatch policy of a run: ``lrd.use_pallas_kernel`` turns
    the hand-written CUDA kernels on (the flag keeps the JAX name)."""
    return KernelPolicy(use_kernel=run.lrd.use_pallas_kernel,
                        int8_decode=run.lrd.int8_decode)


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
