"""Deterministic synthetic data with checkpointable state — a copy of
``SyntheticLM``, ``SyntheticClassification`` and ``LMBatchIterator`` from
``repro/data/synthetic.py`` (numpy only), so the same seed gives the same
batches as the JAX package.

The stream is hash-counter based: the iterator state is a single int (plus
the host shard id), which makes the pipeline exactly resumable from a
checkpoint.  ``SyntheticLM`` is a Markov-ish token stream (a mixture of
per-topic bigram tables), so LM training loss measurably decreases.
``SyntheticClassification`` draws NHWC images around one fixed center per
class, for the ResNet and ViT experiments.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

__all__ = ["SyntheticLM", "SyntheticClassification", "LMBatchIterator"]


def _rng_for(step: int, shard: int, seed: int) -> np.random.Generator:
    # counter-based: state is (seed, shard, step) — no mutable RNG to persist
    return np.random.default_rng(np.uint64(seed * 1_000_003 + shard * 7919 + step))


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_per_host: int
    shard: int = 0
    num_shards: int = 1
    seed: int = 17
    step: int = 0  # checkpointable iterator state

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 4096)
        # 8 latent "topics", each a sparse bigram table over a reduced vocab
        self._v = v
        self._tables = rng.integers(0, v, size=(8, v, 4))

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = _rng_for(self.step, self.shard, self.seed)
        b, s = self.batch_per_host, self.seq_len
        topics = rng.integers(0, 8, size=(b,))
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self._v, size=(b,))
        choice = rng.integers(0, 4, size=(b, s))
        noise = rng.random((b, s)) < 0.1
        rand_tok = rng.integers(0, self._v, size=(b, s))
        for t in range(s):
            nxt = self._tables[topics, toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        self.step += 1
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "shard": self.shard, "seed": self.seed}

    def load_state_dict(self, st: Dict[str, int]) -> None:
        self.step = int(st["step"])
        self.seed = int(st["seed"])


@dataclasses.dataclass
class SyntheticClassification:
    num_classes: int = 10
    img: int = 32
    batch: int = 32
    seed: int = 23
    step: int = 0
    noise: float = 0.35

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._centers = rng.normal(0, 1, size=(self.num_classes, self.img, self.img, 3))

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        rng = _rng_for(self.step, 0, self.seed)
        labels = rng.integers(0, self.num_classes, size=(self.batch,))
        x = self._centers[labels] + rng.normal(0, self.noise,
                                               size=(self.batch, self.img, self.img, 3))
        self.step += 1
        return x.astype(np.float32), labels.astype(np.int32)

    def eval_batch(self, n: int = 256) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed + 999)
        labels = rng.integers(0, self.num_classes, size=(n,))
        x = self._centers[labels] + rng.normal(0, self.noise, size=(n, self.img, self.img, 3))
        return x.astype(np.float32), labels.astype(np.int32)


class LMBatchIterator:
    """Host-sharded iterator facade used by the train CLI."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 shard: int = 0, num_shards: int = 1, seed: int = 17):
        assert global_batch % num_shards == 0
        self.ds = SyntheticLM(vocab, seq_len, global_batch // num_shards,
                              shard=shard, num_shards=num_shards, seed=seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.ds.next_batch()

    def state_dict(self):
        return self.ds.state_dict()

    def load_state_dict(self, st):
        self.ds.load_state_dict(st)
