"""Smoke smollm-360m through the port's ``lm_apply`` against the JAX
``lm_apply``, on params made by ``repro.launch.steps.init_params`` and
carried over by ``repro_torch.bridge``: prefill (``mode="full"``) and paged
decode steps at per-slot positions, LRD on and off, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.serving import paged_cache as jpc
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import LRDConfig as TLRDConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.core.decompose import iter_factor_groups
from repro_torch.launch.steps import init_params
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.serving import paged_cache as tpc

torch.set_num_threads(1)

TOL = 1e-5  # float32 logits; the same products summed in another order
ARCH = "smollm-360m"


def _params(lrd: bool):
    run = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", 16, 2, "decode"),
                    lrd=LRDConfig(enabled=lrd, min_dim=16, rank_quantize=False),
                    dist=DistConfig(fsdp=False, remat="none"))
    params, plan = jsteps.init_params(run, jax.random.PRNGKey(7))
    assert bool(plan.layers) == lrd
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    # the same factor groups as the port's own init draws for this run
    own, own_plan = init_params(_torch_run(lrd), device="cpu")
    groups = sorted(p for p, _ in iter_factor_groups(own))  # JAX trees sort their keys
    assert groups == sorted(p for p, _ in iter_factor_groups(tparams))
    assert len(groups) == (7 if lrd else 0)
    assert {k: v.rank for k, v in own_plan.layers.items()} == \
        {k: v.rank for k, v in plan.layers.items()}
    return params, tparams


def _torch_run(lrd: bool):
    return TRunConfig(model=t_get_smoke_config(ARCH), shape=TShapeConfig("s", 16, 2, "decode"),
                      lrd=TLRDConfig(enabled=lrd, min_dim=16, rank_quantize=False))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("lrd", [False, True])
def test_prefill_logits_match_jax(lrd):
    jparams, tparams = _params(lrd)
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    jlog, jcache, _ = jlm.lm_apply(jparams, jnp.asarray(toks), jcfg, mode="full")
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        tlog, tcache, _ = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg, mode="full",
                                       policy=True)
    _close(tlog.numpy(), jlog)
    for leaf in ("k", "v"):
        _close(tcache["stack"][leaf].numpy(), jcache["stack"][leaf])
    # LRD on: 5 factorised projections and one fused FFN a layer, all on
    # the plain versions because the tensors lie on the CPU
    want = 6 * jcfg.num_layers if lrd else 0
    assert len(fbs) == want and all(f.reason == "platform" for f in fbs)


@pytest.mark.parametrize("lrd", [False, True])
def test_paged_decode_logits_match_jax(lrd):
    """Two slots at different positions: batch-1 prefills inserted into
    their pages, then decode steps that cross block boundaries (the page
    table grows in between), in both packages from the same params."""
    jparams, tparams = _params(lrd)
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    slots, bs, max_len, plen = 2, 4, 20, 8
    max_blocks = jpc.blocks_for(max_len, bs)
    nb = 1 + slots * max_blocks
    pages = jpc.PageTableManager(slots, max_blocks, nb, bs)
    jcache = jpc.init_paged_cache(jcfg, slots, nb, bs, max_blocks)
    tcache = tpc.init_paged_cache(tcfg, slots, nb, bs, max_blocks, "cpu")
    rng = np.random.default_rng(5)
    lens = [5, 7]
    pos = np.zeros(slots, np.int32)
    nxt = np.zeros((slots, 1), np.int32)
    for s, n in enumerate(lens):
        assert pages.admit(s, n + 1)
        padded = np.zeros((1, plen), np.int32)
        padded[0, :n] = rng.integers(0, jcfg.vocab_size, n)
        jlog, jpre, _ = jlm.lm_apply(jparams, jnp.asarray(padded), jcfg, mode="full")
        jcache = jpc.insert_prefill_paged(jcache, jpre, jnp.asarray(pages.table[s]))
        with torch.inference_mode():
            tlog, tpre, _ = tlm.lm_apply(tparams, torch.from_numpy(padded), tcfg,
                                         mode="full")
            tpc.insert_prefill_paged(tcache, tpre, torch.from_numpy(pages.table[s]))
        _close(tlog.numpy(), jlog)
        pos[s] = n
        nxt[s, 0] = int(np.argmax(np.asarray(jlog)[0, n - 1]))
    for _ in range(4):
        for s in range(slots):
            assert pages.ensure(s, int(pos[s]))
        jin = jpc.with_page_table(jcache, pages.table)
        jlog, jcache, _ = jlm.lm_apply(jparams, jnp.asarray(nxt), jcfg, mode="decode",
                                       cache=jin, pos=jnp.asarray(pos))
        with torch.inference_mode():
            tpc.with_page_table(tcache, pages.table)
            tlog, tcache, _ = tlm.lm_apply(tparams, torch.from_numpy(nxt), tcfg,
                                           mode="decode", cache=tcache,
                                           pos=torch.from_numpy(pos), policy=True)
        _close(tlog.numpy(), jlog)
        nxt = np.argmax(np.asarray(jlog)[:, -1:], axis=-1).astype(np.int32)
        pos = pos + 1
    tnp = bridge.cache_to_numpy(tcache)
    for leaf in ("k", "v", "page_table"):
        _close(tnp["stack"][leaf], jcache["stack"][leaf])


def test_bridge_round_trips_bfloat16_bit_for_bit():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)), jnp.bfloat16)
    t = bridge.from_numpy({"a": [np.asarray(x)]})["a"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy(t), np.asarray(x, np.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_jax(causal):
    """The online-softmax path long prefills take (Sq > attention_block_q)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 32, h, 8)).astype(np.float32) for h in (4, 2, 2))
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, block_q=8, block_kv=16)
    got = tattn.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal, block_q=8, block_kv=16)
    _close(got.numpy(), want)
    _close(got.numpy(), tattn.dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                              causal=causal).numpy())
