"""Applying LRD to models: plans, init-time factorised layouts, and
decomposition of dense weights — the counterpart of
``repro/core/decompose.py``.

Two entry points share one source of ranks (:class:`RankResolver`).  At
init, model ``init`` functions call :meth:`Decomposer.linear` and
:meth:`Decomposer.conv`, which create either a dense ``{"kernel"}`` or a
factorised ``{"u", "v"}`` / ``{"first", "core", "last"}`` group according
to the policy and record the decision in the plan.  :func:`apply_lrd` is
the paper's own flow: it walks a dense param tree, factorises every
policy-matched ``kernel`` with a truncated SVD (``core/svd.py``) or, for a
k x k conv, a Tucker-2 HOSVD (``core/tucker.py``), and records the same
plan.  Ranks come from Eq. 5 (``rank_quantize=False``) or from Algorithm 1
(``rank_quantize=True``, :class:`RankResolver` over ``core/rank_opt.py``),
whose guard keeps a layer dense when its decomposition is no faster.
Layouts follow the JAX tree: ``kernel (C, S)``, ``u (C, r)``, ``v (r, S)``,
HWIO conv kernels ``(k, k, C, S)``, ``first (C, r1)``, ``core (k, k, r1,
r2)``, ``last (r2, S)``, with any stack dims (``L``) in front.
:func:`map_factor_groups` and :func:`merge_factor_group` rewrite a trained
tree (the serve-time export).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rank_opt, svd, tucker
from repro_torch.core.policy import DecompositionPolicy, Rule
from repro_torch.core.rank_opt import RankDecision

__all__ = ["LayerPlan", "DecompositionPlan", "RankDecision", "RankResolver",
           "Decomposer", "apply_lrd", "iter_factor_groups", "map_factor_groups",
           "merge_factor_group"]

@dataclasses.dataclass
class LayerPlan:
    path: str
    method: str  # "svd" | "tucker"
    shape: Tuple[int, ...]  # original kernel shape (without stack dim)
    rank: int  # r (SVD) or r1 (Tucker)
    rank2: int = 0  # r2 (Tucker only)
    eq5_rank: int = 0  # pre-optimization Eq.-5 rank, for reporting
    use_decomposed: bool = True  # Algorithm-1 guard outcome

    def params_saved(self) -> int:
        if self.method == "svd":
            c, s = self.shape[-2], self.shape[-1]
            return c * s - self.rank * (c + s)
        c, s, k, _ = self.shape
        return c * s * k * k - (c * self.rank + self.rank * self.rank2 * k * k
                                + self.rank2 * s)


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


class RankResolver:
    """Caches Algorithm-1 decisions per (shape, rule): one sweep per distinct
    layer geometry.  ``backend``, ``probe_tokens`` and ``hw`` are those of
    ``rank_opt.optimize_rank``; the defaults are the JAX package's."""

    def __init__(self, backend: str = "analytic-tpu", probe_tokens: int = 4096,
                 hw: rank_opt.HardwareModel = rank_opt.TPU_V5E):
        self.backend = backend
        self.probe_tokens = probe_tokens
        self.hw = hw
        self._cache: Dict[Tuple, RankDecision] = {}

    def svd_rank(self, c: int, s: int, rule: Rule) -> RankDecision:
        key = ("svd", c, s, rule.alpha, rule.rank_quantize)
        if key not in self._cache:
            if rule.rank_quantize:
                # a sweep stride > 1 only shortens the sweep; cliffs are
                # every hw.mxu_tile, so the stride stays below one tile
                stride = max(1, min(self.hw.mxu_tile // 4, 32))
                dec = rank_opt.optimize_rank(
                    c, s, alpha=rule.alpha, m=self.probe_tokens,
                    backend=self.backend, hw=self.hw, stride=stride)
            else:
                r = svd.svd_rank_for_compression(c, s, rule.alpha)
                t_orig = rank_opt.analytic_layer_time(self.probe_tokens, c, s, None,
                                                      hw=self.hw)
                t_dec = rank_opt.analytic_layer_time(self.probe_tokens, c, s, r,
                                                     hw=self.hw)
                dec = RankDecision(rank=r, use_decomposed=True, original_time=t_orig,
                                   decomposed_time=t_dec)
            self._cache[key] = dataclasses.replace(
                dec, rank=max(1, min(dec.rank, svd.max_rank(c, s))))
        return self._cache[key]

    def tucker_ranks(self, c: int, s: int, k: int, rule: Rule) -> RankDecision:
        """r1 of a (C, S, k, k) conv: Algorithm 1, or Eq. 5 with the guard's
        times fixed at 1.0 / 0.5 (always decomposed), as in JAX."""
        key = ("tucker", c, s, k, rule.alpha, rule.rank_quantize)
        if key not in self._cache:
            if rule.rank_quantize:
                dec = rank_opt.optimize_rank_tucker(
                    c, s, k, alpha=rule.alpha, m=self.probe_tokens, hw=self.hw,
                    stride=max(1, min(self.hw.mxu_tile // 4, 32)))
            else:
                r1, _ = tucker.tucker_rank_for_compression(c, s, k, rule.alpha)
                dec = RankDecision(rank=r1, use_decomposed=True, original_time=1.0,
                                   decomposed_time=0.5)
            self._cache[key] = dec
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
        """Fan-in scaled normal init (``repro.core.decompose._init_dense``):
        fan-in C of a ``(..., C, S)`` matrix, kh * kw * C of a 4-D HWIO
        kernel (and the product of the three axes before S of a stacked one)."""
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        if len(shape) >= 4:
            fan_in = int(np.prod(shape[-4:-1]))
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
            if not dec.use_decomposed:  # Algorithm-1 guard: keep the layer
                out["kernel"] = self.dense(stack + (c, s), dtype)
            else:
                r = dec.rank
                # He-style fan-in init split across the two factors so the
                # composed map has the same variance as a dense init.
                out["u"] = self.dense(stack + (c, r), dtype)
                out["v"] = self.dense(stack + (r, s), dtype)
        if bias:
            out["bias"] = torch.zeros(stack + (s,), dtype=dtype, device=self.device)
        return out

    def conv(self, path: str, c: int, s: int, k: int, *, dtype=None,
             stack: Tuple[int, ...] = ()) -> Dict[str, Any]:
        """Dense or factorised k x k conv params (HWIO kernels): a 1x1 conv
        under a Tucker rule takes the SVD (it is a matrix), a k x k one the
        Tucker-2 triple at r2 = min(r1, S)."""
        dtype = dtype or self.dtype
        rule = self.policy.match(path) if self.policy else None
        if rule is not None and min(c, s) < rule.min_dim:
            rule = None
        if k == 1 and rule is not None and rule.method == "tucker":
            # 1x1 convs are matrices: the paper treats them as FC (SVD)
            rule = dataclasses.replace(rule, method="svd")
        out: Dict[str, Any] = {}
        if rule is None or rule.method == "none":
            out["kernel"] = self.dense(stack + (k, k, c, s), dtype)
        elif rule.method == "svd":
            dec = self.resolver.svd_rank(c, s, rule)
            self.plan.layers[path] = LayerPlan(
                path=path, method="svd", shape=(c, s), rank=dec.rank,
                eq5_rank=svd.svd_rank_for_compression(c, s, rule.alpha),
                use_decomposed=dec.use_decomposed,
            )
            if not dec.use_decomposed:
                out["kernel"] = self.dense(stack + (k, k, c, s), dtype)
            else:
                out["u"] = self.dense(stack + (c, dec.rank), dtype)
                out["v"] = self.dense(stack + (dec.rank, s), dtype)
        else:  # tucker
            dec = self.resolver.tucker_ranks(c, s, k, rule)
            r1 = dec.rank
            r2 = max(1, min(int(r1), s))
            self.plan.layers[path] = LayerPlan(
                path=path, method="tucker", shape=(c, s, k, k), rank=r1, rank2=r2,
                eq5_rank=tucker.tucker_rank_for_compression(c, s, k, rule.alpha)[0],
                use_decomposed=dec.use_decomposed,
            )
            if not dec.use_decomposed:
                out["kernel"] = self.dense(stack + (k, k, c, s), dtype)
            else:
                out["first"] = self.dense(stack + (c, r1), dtype)
                out["core"] = self.dense(stack + (k, k, r1, r2), dtype)
                out["last"] = self.dense(stack + (r2, s), dtype)
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


def map_factor_groups(params: Any, fn) -> Any:
    """Rebuild the tree with ``fn(path, group) -> new_group`` applied to
    every factor group (return the group unchanged to keep it).  Leaves and
    non-factor subtrees pass through untouched."""

    def walk(tree, path):
        if not isinstance(tree, dict):
            return tree
        if _is_factor_group(tree):
            return fn(path, tree)
        return {k: walk(v, f"{path}/{k}" if path else k) for k, v in tree.items()}

    return walk(params, "")


def merge_factor_group(group: Dict[str, Any]) -> Dict[str, Any]:
    """Collapse ``{"u", "v"[, "bias"]}`` into ``{"kernel"[, "bias"]}`` (the
    product in float32, stored in u's dtype): ``models.common.linear``
    dispatches on the key set, so the layer then runs one dense matmul."""
    u, v = group["u"], group["v"]
    out = {"kernel": torch.matmul(u.float(), v.float()).to(u.dtype)}
    if "bias" in group:
        out["bias"] = group["bias"]
    return out


# --------------------------------------------------------------------------
# Decomposition of dense weights (the paper's flow)
# --------------------------------------------------------------------------

def apply_lrd(params: Any, policy: DecompositionPolicy, *,
              resolver: Optional[RankResolver] = None,
              use_randomized_svd_above: int = 2048 * 2048,
              balance: str = "balanced") -> Tuple[Any, DecompositionPlan]:
    """Factorise every policy-matched ``kernel`` leaf of a dense param tree.

    2-D and stacked 3-D kernels become SVD groups ``{"u", "v"}`` at the
    resolver's rank (a 2-D kernel of more than ``use_randomized_svd_above``
    elements through :func:`svd.randomized_svd`), as do 1x1 HWIO conv
    kernels; a k x k HWIO conv kernel under a Tucker rule becomes the
    Tucker-2 triple ``{"first", "core", "last"}`` at r2 = r1 (JAX's rule
    here, where :meth:`Decomposer.conv` caps r2 at S).  A layer the
    Algorithm-1 guard keeps dense stays as it is.  Everything else passes
    through untouched.  Returns ``(new_params, plan)``; the plan is the one
    :class:`Decomposer` records at init for the same policy, keyed by the
    tree's group paths.
    """
    resolver = resolver or RankResolver()
    plan = DecompositionPlan(policy_name=policy.name)

    def walk(tree, path):
        if not isinstance(tree, dict):
            return tree
        if "kernel" in tree and not isinstance(tree["kernel"], dict):
            rewritten = _maybe_factorize(tree["kernel"], path, policy, resolver, plan,
                                         use_randomized_svd_above, balance)
            if rewritten is None:
                return tree
            out = {k: v for k, v in tree.items() if k != "kernel"}
            out.update(rewritten)
            return out
        return {k: walk(v, f"{path}/{k}" if path else k) for k, v in tree.items()}

    return walk(params, ""), plan


def _svd_group(path, rule, resolver, plan, c, s, decompose):
    """Record the SVD decision for a (C, S) weight; the factors from
    ``decompose(rank)``, or None where the guard keeps the layer dense."""
    dec = resolver.svd_rank(c, s, rule)
    plan.layers[path] = LayerPlan(
        path=path, method="svd", shape=(c, s), rank=dec.rank,
        eq5_rank=svd.svd_rank_for_compression(c, s, rule.alpha),
        use_decomposed=dec.use_decomposed,
    )
    if not dec.use_decomposed:
        return None
    u, v = decompose(dec.rank)
    return {"u": u, "v": v}


def _maybe_factorize(w, path, policy, resolver, plan, rsvd_threshold, balance):
    rule = policy.match(path + "/kernel")
    if rule is None:
        return None
    if w.dim() in (2, 3):
        c, s = int(w.shape[-2]), int(w.shape[-1])
        if min(c, s) < rule.min_dim:
            return None
        if w.dim() == 2 and c * s > rsvd_threshold:
            return _svd_group(path, rule, resolver, plan, c, s,
                              lambda r: svd.randomized_svd(w, r, balance=balance))
        return _svd_group(path, rule, resolver, plan, c, s,
                          lambda r: svd.svd_decompose(w, r, balance=balance))
    if w.dim() == 4:  # HWIO conv kernel
        kh, kw, c, s = (int(d) for d in w.shape)
        if min(c, s) < rule.min_dim:
            return None
        if kh == 1 and kw == 1:  # a 1x1 conv is a matrix (paper Fig. 1)
            return _svd_group(path, rule, resolver, plan, c, s,
                              lambda r: svd.svd_decompose(w[0, 0], r, balance=balance))
        if rule.method != "tucker":
            return None
        dec = resolver.tucker_ranks(c, s, kh, rule)
        r1, r2 = dec.rank, max(1, int(dec.rank))
        plan.layers[path] = LayerPlan(
            path=path, method="tucker", shape=(c, s, kh, kw), rank=r1, rank2=r2,
            eq5_rank=tucker.tucker_rank_for_compression(c, s, kh, rule.alpha)[0],
            use_decomposed=dec.use_decomposed,
        )
        if not dec.use_decomposed:
            return None
        # HWIO -> (C, S, kh, kw) for the HOSVD; the core back to HWIO
        first, core, last = tucker.tucker2_decompose(w.permute(2, 3, 0, 1), r1, r2)
        return {"first": first, "core": core.permute(2, 3, 0, 1).contiguous(),
                "last": last}
    return None
