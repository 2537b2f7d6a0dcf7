"""The fixed-batch serving path in the port against the JAX package, on the
same params (made in JAX, carried over by ``repro_torch.bridge``):
``ServeEngine(num_slots=0).generate`` gives the same greedy tokens as JAX's
with bf16 and with ``kv_cache_dtype="int8"`` (whose fixed-batch cache is,
in both packages, the prefill's own in the compute dtype), early finishers
padded with ``eos_id``; a batch too long for the scheduler's window takes
the fixed path from a slotted engine too; and ``pad_cache`` pads as JAX's
does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.launch import steps as jsteps
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving import engine as tengine

torch.set_num_threads(1)

ARCH = "smollm-360m"


def _pair(kv_dtype="bfloat16", lrd=True, seed=13):
    jcfg = dataclasses.replace(get_smoke_config(ARCH), kv_cache_dtype=kv_dtype)
    tcfg = dataclasses.replace(t_get_smoke_config(ARCH), kv_cache_dtype=kv_dtype)
    jrun = RunConfig(model=jcfg, shape=ShapeConfig("s", 32, 3, "decode"),
                     lrd=LRDConfig(enabled=lrd, min_dim=16, rank_quantize=False),
                     dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=tcfg, shape=TShape("s", 32, 3, "decode"),
                lrd=TLRD(enabled=lrd, min_dim=16, rank_quantize=False),
                dist=TDist(fsdp=False, remat="none"))
    jparams, _ = jsteps.init_params(jrun, jax.random.PRNGKey(seed))
    return jrun, trun, jparams, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                              jparams))


@pytest.mark.parametrize("kv_dtype,lrd", [("bfloat16", True), ("bfloat16", False),
                                          ("int8", True)])
def test_fixed_batch_generate_matches_jax(kv_dtype, lrd):
    jrun, trun, jparams, tparams = _pair(kv_dtype, lrd)
    prompts = np.random.default_rng(14).integers(0, 256, (3, 10)).astype(np.int32)
    want = JServeEngine(jrun, jparams).generate(prompts, max_new=9)
    engine = ServeEngine(trun, tparams, device="cpu")  # num_slots=0: the default
    assert engine.config.num_slots == 0
    got = engine.generate(prompts, max_new=9)
    np.testing.assert_array_equal(got, want)
    assert engine._scheduler is None  # the scheduler was never built
    # eos: each row's third token ends it; later columns read eos_id
    eos = int(want[0, 2])
    np.testing.assert_array_equal(engine.generate(prompts, max_new=9, eos_id=eos),
                                  JServeEngine(jrun, jparams).generate(prompts, max_new=9,
                                                                       eos_id=eos))


def test_oversized_batch_takes_the_fixed_path():
    """A slotted engine routes prompts longer than its prefill length to the
    fixed path, as JAX's does, and fitting ones to the scheduler."""
    jrun, trun, jparams, tparams = _pair()
    kw = dict(num_slots=2, max_len=32, prefill_len=8, block_size=4)
    rng = np.random.default_rng(15)
    for prompt_len in (12, 6):
        prompts = rng.integers(0, 256, (2, prompt_len)).astype(np.int32)
        want = JServeEngine(jrun, jparams, config=JServeConfig(**kw)).generate(prompts,
                                                                                max_new=6)
        engine = ServeEngine(trun, tparams, config=ServeConfig(**kw), device="cpu")
        np.testing.assert_array_equal(engine.generate(prompts, max_new=6), want)
        assert (engine._scheduler is None) == (prompt_len > 8)


@pytest.mark.parametrize("target", [5, 9])
def test_pad_cache_matches_jax(target):
    rng = np.random.default_rng(16)
    tree = {"stack": {"k": rng.normal(size=(2, 3, 5, 2, 4)).astype(np.float32),
                      "v": rng.normal(size=(2, 3, 5, 2, 4)).astype(np.float32),
                      "k_scale": rng.normal(size=(2, 3, 5, 2, 1)).astype(np.float32),
                      "other": rng.normal(size=(2, 3)).astype(np.float32)},
            "cross": {"k": rng.normal(size=(2, 3, 4, 2, 4)).astype(np.float32)}}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = bridge.from_numpy(tree)
    for jfn, tfn in ((jengine.pad_cache, tengine.pad_cache),
                     (jengine.pad_cache_preserving_cross, tengine.pad_cache_preserving_cross)):
        want = jax.tree_util.tree_map(np.asarray, jfn(jtree, target))
        got = bridge.to_numpy(tfn(ttree, target))
        assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    skipped = tengine.pad_cache(ttree, 9, skip={"v"})
    assert skipped["stack"]["v"].shape[2] == 5 and skipped["stack"]["k"].shape[2] == 9
