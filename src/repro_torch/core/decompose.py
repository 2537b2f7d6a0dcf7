"""Init-time LRD for the PyTorch port: plans and factorised param layouts.

The counterpart of ``repro/core/decompose.py`` for the serving slice: model
``init`` functions call :meth:`Decomposer.linear`, which creates either a
dense ``{"kernel"}`` or a factorised ``{"u", "v"}`` group according to the
policy and records the decision in the plan.  Ranks come from Eq. 5
(``rank_quantize=False``).  Algorithm 1 (``rank_quantize=True``) needs an
H100 timing backend for ``core/rank_opt.py`` and raises until it is ported.
Layouts follow the JAX tree: ``kernel (C, S)``, ``u (C, r)``, ``v (r, S)``,
with any stack dims (``L``) in front.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import svd
from repro_torch.core.policy import DecompositionPolicy, Rule

__all__ = ["LayerPlan", "DecompositionPlan", "RankDecision", "RankResolver",
           "Decomposer", "iter_factor_groups"]


@dataclasses.dataclass
class LayerPlan:
    path: str
    method: str  # "svd"
    shape: Tuple[int, ...]  # original kernel shape (without stack dim)
    rank: int
    rank2: int = 0
    eq5_rank: int = 0  # pre-optimization Eq.-5 rank, for reporting
    use_decomposed: bool = True  # Algorithm-1 guard outcome

    def params_saved(self) -> int:
        c, s = self.shape[-2], self.shape[-1]
        return c * s - self.rank * (c + s)


@dataclasses.dataclass
class DecompositionPlan:
    layers: Dict[str, LayerPlan] = dataclasses.field(default_factory=dict)
    policy_name: str = ""

    def to_json(self) -> str:
        return json.dumps(
            {p: dataclasses.asdict(lp) for p, lp in self.layers.items()}, indent=1
        )

    def summary(self) -> str:
        n = len(self.layers)
        saved = sum(lp.params_saved() for lp in self.layers.values() if lp.use_decomposed)
        kept = sum(1 for lp in self.layers.values() if not lp.use_decomposed)
        return f"plan[{self.policy_name}]: {n} layers, {kept} kept dense, {saved/1e6:.1f}M params saved"


@dataclasses.dataclass(frozen=True)
class RankDecision:
    """Outcome of the rank choice for one layer geometry."""

    rank: int
    use_decomposed: bool


class RankResolver:
    """Caches rank decisions per (shape, rule)."""

    def __init__(self):
        self._cache: Dict[Tuple, RankDecision] = {}

    def svd_rank(self, c: int, s: int, rule: Rule) -> RankDecision:
        key = ("svd", c, s, rule.alpha, rule.rank_quantize)
        if key not in self._cache:
            if rule.rank_quantize:
                raise NotImplementedError(
                    "Algorithm-1 rank quantization (core/rank_opt.py) has no "
                    "H100 backend in the PyTorch port yet (ROADMAP queue 1, "
                    "item 3); use LRDConfig(rank_quantize=False)")
            r = svd.svd_rank_for_compression(c, s, rule.alpha)
            self._cache[key] = RankDecision(
                rank=max(1, min(r, svd.max_rank(c, s))), use_decomposed=True)
        return self._cache[key]


class Decomposer:
    """Init-time LRD: hands factorised param layouts to model ``init`` fns.

    Weights are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``) in call order, so one seed gives one set of weights.
    """

    def __init__(self, policy: Optional[DecompositionPolicy], *,
                 resolver: Optional[RankResolver] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu",
                 generator: Optional[torch.Generator] = None):
        self.policy = policy
        self.resolver = resolver or RankResolver()
        self.dtype = dtype
        self.device = torch.device(device)
        self.generator = generator
        self.plan = DecompositionPlan(policy_name=policy.name if policy else "none")

    def normal(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """Standard-normal float32 draws on the decomposer's device."""
        return torch.randn(shape, generator=self.generator,
                           dtype=torch.float32, device=self.device)

    def dense(self, shape: Tuple[int, ...], dtype=None) -> torch.Tensor:
        """Fan-in scaled normal init (``repro.core.decompose._init_dense``)."""
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / np.sqrt(max(fan_in, 1))
        return (self.normal(shape) * scale).to(dtype or self.dtype)

    def linear(self, path: str, c: int, s: int, *, bias: bool = False,
               dtype=None, stack: Tuple[int, ...] = ()) -> Dict[str, Any]:
        """Dense or SVD-factorised linear params for ``y = x @ W``.

        ``stack`` prepends scan-over-layers dims to every leaf.
        """
        dtype = dtype or self.dtype
        rule = self.policy.match(path) if self.policy else None
        if rule is not None and min(c, s) < rule.min_dim:
            rule = None
        out: Dict[str, Any] = {}
        if rule is None or rule.method != "svd":
            out["kernel"] = self.dense(stack + (c, s), dtype)
        else:
            dec = self.resolver.svd_rank(c, s, rule)
            self.plan.layers[path] = LayerPlan(
                path=path, method="svd", shape=(c, s), rank=dec.rank,
                eq5_rank=svd.svd_rank_for_compression(c, s, rule.alpha),
                use_decomposed=dec.use_decomposed,
            )
            r = dec.rank
            # He-style fan-in init split across the two factors so the
            # composed map has the same variance as a dense init.
            out["u"] = self.dense(stack + (c, r), dtype)
            out["v"] = self.dense(stack + (r, s), dtype)
        if bias:
            out["bias"] = torch.zeros(stack + (s,), dtype=dtype, device=self.device)
        return out


def _is_factor_group(tree: Any) -> bool:
    """An SVD factor group: ``{u, v}`` plus an optional ``bias``."""
    return (isinstance(tree, dict) and "u" in tree and "v" in tree
            and not isinstance(tree["u"], dict)
            and set(tree) <= {"u", "v", "bias"})


def iter_factor_groups(params: Any, path: str = ""):
    """Yield ``(path, group_dict)`` for every SVD factor group in the tree."""
    if not isinstance(params, dict):
        return
    if _is_factor_group(params):
        yield path, params
        return
    for k, v in params.items():
        yield from iter_factor_groups(v, f"{path}/{k}" if path else k)
