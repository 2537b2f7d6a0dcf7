"""Decomposition policies: which weights get LRD, with what settings.

A policy is an ordered list of rules matched against the '/'-joined param
path (e.g. ``"layers/attn/wq/kernel"``).  First match wins.  The default LM
policy decomposes every projection matrix and leaves embeddings, vector
params (norms, biases) and already-factorized weights (MLA latents) alone —
see DESIGN.md §4 for the per-architecture rationale.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple

__all__ = ["Rule", "DecompositionPolicy", "LM_DEFAULT", "RESNET_DEFAULT", "NO_LRD"]


@dataclasses.dataclass(frozen=True)
class Rule:
    pattern: str  # regex, searched against the param path
    method: str  # "svd" | "tucker" | "none"
    alpha: float = 2.0  # target compression ratio (paper uses 2x)
    rank_quantize: bool = True  # snap rank to the MXU tile (Algorithm 1, analytic)
    min_dim: int = 128  # skip matrices smaller than this on either side

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


@dataclasses.dataclass(frozen=True)
class DecompositionPolicy:
    rules: Tuple[Rule, ...]
    name: str = "custom"

    def match(self, path: str) -> Optional[Rule]:
        for rule in self.rules:
            if rule.matches(path):
                return None if rule.method == "none" else rule
        return None

    def with_alpha(self, alpha: float) -> "DecompositionPolicy":
        return DecompositionPolicy(
            rules=tuple(dataclasses.replace(r, alpha=alpha) for r in self.rules),
            name=f"{self.name}@{alpha}x",
        )

    def with_quantize(self, flag: bool) -> "DecompositionPolicy":
        return DecompositionPolicy(
            rules=tuple(dataclasses.replace(r, rank_quantize=flag) for r in self.rules),
            name=self.name,
        )

    def with_min_dim(self, n: int) -> "DecompositionPolicy":
        return DecompositionPolicy(
            rules=tuple(dataclasses.replace(r, min_dim=n) for r in self.rules),
            name=self.name,
        )


# ---------------------------------------------------------------------------
# Canonical policies
# ---------------------------------------------------------------------------

LM_DEFAULT = DecompositionPolicy(
    name="lm-default",
    rules=(
        # Never decompose: embeddings / output head (policy-excluded by
        # default; factorized embeddings change softmax cost), norms, biases,
        # MLA's own latent factors (already low-rank), router gates, conv1d.
        Rule(r"(embed|unembed|lm_head|pos_emb)", "none"),
        Rule(r"(norm|scale|bias|gate_bias)", "none"),
        Rule(r"(kv_down|q_down)", "none"),  # MLA latent projections
        Rule(r"(router|gate_w)$", "none"),
        Rule(r"conv1d", "none"),  # depthwise — no channel-mixing rank structure
        # Everything else that looks like a projection matrix:
        Rule(r"(kernel|w[qkvo]|wi|wo|up|down|gate|proj)", "svd"),
    ),
)

RESNET_DEFAULT = DecompositionPolicy(
    name="resnet-default",
    rules=(
        Rule(r"(bn|norm|bias|scale)", "none"),
        Rule(r"conv_stem", "none"),  # 7x7 stem: tiny, irregular — paper keeps it
        Rule(r"conv.*1x1|shortcut|fc", "svd", min_dim=64),
        Rule(r"conv", "tucker", min_dim=64),
    ),
)

NO_LRD = DecompositionPolicy(name="no-lrd", rules=(Rule(r".*", "none"),))
