"""The radix prefix cache in the port against the JAX package: the tree's
``match`` / ``insert`` / ``evict`` / ``drop_all`` op for op on the same
allocator script (same results, same refcounts and free lists), and the
same shared-prefix traces through both ``ServeEngine``s with the cache on
and off (params made in JAX, carried over by ``repro_torch.bridge``):
identical greedy tokens and prefix counters, fewer prefilled tokens with
the cache on, and eviction and preemption under a tight pool."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.launch import steps as jsteps
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving.paged_cache import BlockAllocator as JAlloc
from repro.serving.radix_cache import RadixCache as JRadix
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.launch import serve as tserve
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving.paged_cache import BlockAllocator as TAlloc
from repro_torch.serving.radix_cache import RadixCache as TRadix

torch.set_num_threads(1)

ARCH = "smollm-360m"
STATS = ("prefix_lookups", "prefix_hits", "prefix_hit_tokens", "prefill_tokens",
         "prefix_evicted_blocks", "preemptions")


def _state(alloc, tree):
    return (sorted(alloc._free), alloc._rc.tolist(), tree.cached_blocks,
            tree.evicted_blocks)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_ops_match_jax_on_one_allocator_script(seed):
    """Random admissions (match, alloc the rest, insert), retirements,
    evictions and a final drop_all, through both trees on their own
    allocators: every result and the allocators' state stay equal."""
    rng = np.random.default_rng(seed)
    bs, nb = 4, 40
    sides = [(JAlloc(nb), None), (TAlloc(nb), None)]
    sides = [(a, cls(a, bs)) for (a, _), cls in zip(sides, (JRadix, TRadix))]
    heads = [rng.integers(0, 5, 12) for _ in range(3)]  # shared prompt heads
    live = []  # per side: the block lists slots hold
    for step in range(60):
        op = rng.choice(["admit", "admit", "retire", "evict", "match"])
        toks = np.concatenate([heads[rng.integers(3)][:rng.integers(0, 13)],
                               rng.integers(0, 5, rng.integers(1, 9))])
        if op == "evict":
            need, protect = int(rng.integers(0, 6)), ()
            res = [t.evict(need, protect) for _, t in sides]
        elif op == "match":
            res = [t.match(toks) for _, t in sides]
        elif op == "retire" and live:
            held = live.pop(int(rng.integers(len(live))))
            for (a, _), blocks in zip(sides, held):
                a.free(blocks)
            res = [None, None]
        else:
            res, held = [], []
            for a, t in sides:
                shared = t.match(toks)
                n = -(-len(toks) // bs)
                fresh = a.alloc(max(n - len(shared), 0))
                if fresh is None:
                    res.append(None)
                    held.append(None)
                    continue
                a.ref(shared)
                blocks = shared + fresh
                adopted = t.insert(toks, blocks[:len(toks) // bs])
                res.append((shared, fresh, adopted))
                held.append(blocks)
            if held[0] is not None:
                live.append(held)
        assert res[0] == res[1], (step, op)
        assert _state(*sides[0]) == _state(*sides[1]), (step, op)
    assert sides[0][1].drop_all() == sides[1][1].drop_all()
    assert _state(*sides[0]) == _state(*sides[1])


@pytest.fixture(scope="module")
def params():
    jrun = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", 48, 2, "decode"),
                     lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False),
                     dist=DistConfig(fsdp=False, remat="none"))
    jparams, _ = jsteps.init_params(jrun, jax.random.PRNGKey(11))
    return jparams, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _runs(kv_dtype=None):
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    if kv_dtype:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_dtype)
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv_dtype)
    jrun = RunConfig(model=jcfg, shape=ShapeConfig("s", 48, 2, "decode"),
                     lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False),
                     dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=tcfg, shape=TShape("s", 48, 2, "decode"),
                lrd=TLRD(enabled=True, min_dim=16, rank_quantize=False),
                dist=TDist(fsdp=False, remat="none"))
    return jrun, trun


CASES = {
    # name: (ServeConfig kwargs, kv dtype, requests)
    "bf16": (dict(num_slots=2, max_len=48, prefill_len=24, block_size=4), None, "shared"),
    "int8": (dict(num_slots=2, max_len=48, prefill_len=24, block_size=4), "int8", "shared"),
    "spec": (dict(num_slots=2, max_len=48, prefill_len=24, block_size=4, speculative_k=2),
             None, "shared"),
    # one slot and 11 blocks: a disjoint second prompt evicts cached blocks
    "evict": (dict(num_slots=1, max_len=48, prefill_len=24, block_size=4, num_blocks=11),
              None, "disjoint"),
    # two slots and 13 blocks for prompts that grow past them: preemption
    "preempt": (dict(num_slots=2, max_len=48, prefill_len=24, block_size=4, num_blocks=13),
                None, "grow"),
}


def _requests(kind, vocab):
    rng = np.random.default_rng(12)
    if kind == "shared":
        prefix = rng.integers(1, vocab, 13).astype(np.int32)
        return [{"prompt": np.concatenate([prefix, rng.integers(1, vocab, int(n))
                                           .astype(np.int32)]), "max_new": 7}
                for n in (3, 1, 6, 4, 2)]
    if kind == "disjoint":
        return [{"prompt": (np.arange(20) + base).astype(np.int32) % vocab, "max_new": 4}
                for base in (1, 100)]
    return [{"prompt": rng.integers(1, vocab, 18).astype(np.int32), "max_new": 12}
            for _ in range(2)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_cache_tokens_and_counters_match_jax(params, case):
    kw, kv_dtype, kind = CASES[case]
    jparams, tparams = params
    jrun, trun = _runs(kv_dtype)
    reqs = _requests(kind, jrun.model.vocab_size)
    toks, stats = {}, {}
    for cached in (False, True):
        cfg = dict(kw, prefix_cache=cached)
        jeng = JServeEngine(jrun, jparams, config=JServeConfig(**cfg))
        want = jeng.serve([dict(r) for r in reqs])
        engine = ServeEngine(trun, tparams, config=ServeConfig(**cfg), device="cpu")
        got = engine.serve([dict(r) for r in reqs])
        toks[cached] = [r.tokens.tolist() for r in got]
        assert toks[cached] == [r.tokens.tolist() for r in want]
        assert [r.prefix_hit_len for r in got] == [r.prefix_hit_len for r in want]
        tstats, jstats = engine.scheduler.latency_stats(), jeng.scheduler.latency_stats()
        assert {k: tstats[k] for k in STATS} == {k: jstats[k] for k in STATS}
        stats[cached] = tstats
        fwd = engine.scheduler.forward_stats
        assert fwd["nonfinite"] == 0
        # a hit whose admission waits for pages is looked up again later
        assert fwd["extend"] <= tstats["prefix_hits"]
    assert toks[True] == toks[False]
    if kind == "shared":
        assert stats[True]["prefix_hits"] == len(reqs) - 1 == fwd["extend"]
        assert stats[True]["prefill_tokens"] < stats[False]["prefill_tokens"]
        assert stats[True]["prefix_hit_tokens"] % kw["block_size"] == 0
    if case == "evict":
        assert stats[True]["prefix_evicted_blocks"] > 0 and stats[True]["preemptions"] == 0
    if case == "preempt":
        assert stats[True]["preemptions"] >= 1


def test_serve_cli_prefix_cache(capsys):
    engine, outs = tserve.main(["--smoke", "--device", "cpu", "--lrd", "--requests", "4",
                                "--slots", "2", "--prompt-len", "16", "--max-new", "4",
                                "--block-size", "2", "--prefix-cache"])
    out = capsys.readouterr().out
    assert "prefix cache:" in out and [len(o) for o in outs] == [4] * 4
    assert engine.scheduler.prefix is not None


def test_shared_prefix_trace_matches_jax():
    from repro.launch.serve import shared_prefix_trace as j_trace

    want = j_trace(5, 100.0, 20, 6, 256, seed=3)
    got = tserve.shared_prefix_trace(5, 100.0, 20, 6, 256, seed=3)
    assert [(r["arrival"], r["prompt"].tolist()) for r in got] == \
        [(r["arrival"], r["prompt"].tolist()) for r in want]
