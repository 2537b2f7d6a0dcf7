"""The same request trace through the JAX ``ServeEngine`` and the port's
``ServeEngine(device="cpu")``, on the same params (made in JAX, carried
over by ``repro_torch.bridge``): the greedy tokens of every request must be
identical — with more requests than slots (slot recycling), and with a pool
too small for the working set (preemption and resume)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.launch import steps as jsteps
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.serving import ServeConfig, ServeEngine

torch.set_num_threads(1)

ARCH = "smollm-360m"
CASES = {
    # name: (ServeConfig kwargs, lrd) — 4 slots, block_size 8, 7 requests
    "recycle": (dict(num_slots=4, max_len=40, prefill_len=16, block_size=8), True),
    "recycle-dense": (dict(num_slots=4, max_len=40, prefill_len=16, block_size=8), False),
    # 9 blocks of 8 for 4 slots that grow to 16+14 positions: preemption
    "preempt": (dict(num_slots=4, max_len=40, prefill_len=32, block_size=8,
                     num_blocks=9), True),
}


def _trace(vocab):
    rng = np.random.default_rng(11)
    return [{"prompt": rng.integers(0, vocab, int(rng.integers(4, 16)), dtype=np.int32),
             "max_new": int(rng.integers(6, 15))} for _ in range(7)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_scheduler_tokens_match_jax_engine(case):
    kw, lrd = CASES[case]
    jrun = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", 40, 4, "decode"),
                     lrd=LRDConfig(enabled=lrd, min_dim=16, rank_quantize=False),
                     dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=t_get_smoke_config(ARCH), shape=TShape("s", 40, 4, "decode"),
                lrd=TLRD(enabled=lrd, min_dim=16, rank_quantize=False),
                dist=TDist(fsdp=False, remat="none"))
    jparams, _ = jsteps.init_params(jrun, jax.random.PRNGKey(3))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    trace = _trace(jrun.model.vocab_size)

    want = JServeEngine(jrun, jparams, config=JServeConfig(**kw)).serve(trace)
    engine = ServeEngine(trun, tparams, config=ServeConfig(**kw), device="cpu")
    got = engine.serve(trace)

    assert [r.tokens.tolist() for r in got] == [r.tokens.tolist() for r in want]
    assert [len(r) for r in got] == [r["max_new"] for r in trace]
    stats = engine.scheduler.latency_stats()
    assert stats["requests"] == len(trace)
    assert (stats["preemptions"] > 0) == (case == "preempt")
    fwd = engine.scheduler.forward_stats
    assert fwd["nonfinite"] == 0 and fwd["prefill"] >= len(trace)


def test_engine_rejects_unported_features():
    run = TRun(model=t_get_smoke_config(ARCH), shape=TShape("s", 40, 4, "decode"))
    for cfg, match in [(ServeConfig(num_slots=0), "fixed-batch"),
                       (ServeConfig(num_slots=2, speculative_k=2), "speculative"),
                       (ServeConfig(num_slots=2, prefix_cache=True), "prefix cache"),
                       (ServeConfig(num_slots=2, kv_int8=True), "int8"),
                       (ServeConfig(num_slots=2, mesh_model=2), "mesh")]:
        with pytest.raises(ValueError, match=match):
            ServeEngine(run, {}, config=cfg, device="cpu")


def test_generate_pads_early_finishers_with_eos():
    run = TRun(model=t_get_smoke_config(ARCH), shape=TShape("s", 32, 2, "decode"),
               lrd=TLRD(enabled=True, min_dim=16, rank_quantize=False))
    from repro_torch.launch import steps

    params, _ = steps.init_params(run, device="cpu")
    engine = ServeEngine(run, params, device="cpu",
                         config=ServeConfig(num_slots=2, max_len=32, prefill_len=8,
                                            block_size=4))
    prompts = np.random.default_rng(1).integers(0, 256, (3, 6), dtype=np.int32)
    ref = engine.generate(prompts, max_new=6)
    eos = int(ref[0, 1])
    out = engine.generate(prompts, max_new=6, eos_id=eos)
    for row_ref, row in zip(ref, out):
        hits = np.flatnonzero(row_ref == eos)
        if hits.size:  # up to the first eos: unchanged; from it on: eos
            k = int(hits[0])
            np.testing.assert_array_equal(row[:k + 1], row_ref[:k + 1])
            assert (row[k:] == eos).all()
        else:
            np.testing.assert_array_equal(row, row_ref[:len(row)])
