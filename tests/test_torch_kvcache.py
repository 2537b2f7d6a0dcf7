"""int8 KV caches in the port against the JAX package: ``quantize_kv`` bit
for bit, ``int8_dense_attention`` within 1e-5, the contiguous and paged
writes equal to JAX's on the same inputs, the int8 pool's bytes, and the
same request trace through both ``ServeEngine``s with
``kv_cache_dtype="int8"`` pools in both ``int8_decode`` modes (params made
in JAX, carried over by ``repro_torch.bridge``): identical greedy tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.launch import steps as jsteps
from repro.models import kvcache as jkv
from repro.models import lm as jlm
from repro.models.attention import int8_dense_attention as j_int8_attention
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import paged_cache as jpc
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.models import kvcache as tkv
from repro_torch.models import lm as tlm
from repro_torch.models.attention import int8_dense_attention as t_int8_attention
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving import paged_cache as tpc

torch.set_num_threads(1)

ARCH = "smollm-360m"


def _jt(a):
    """A JAX array as a torch tensor (bf16 bit for bit)."""
    return bridge.from_numpy(np.asarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2.0, (3, 7, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero head vector: the 1e-8 scale floor
    x[1, 2, 1, :3] = [127.5, -63.5, 0.5]  # ties for round-half-to-even
    jx = jnp.asarray(x, dtype)
    jq, js = jkv.quantize_kv(jx)
    tq, ts = tkv.quantize_kv(_jt(jx))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert torch.equal(ts, _jt(js))
    for out_dtype, t_out in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        want = jkv.dequantize_kv(jq, js, jnp.dtype(out_dtype))
        assert torch.equal(tkv.dequantize_kv(tq, ts, t_out), _jt(want))


@pytest.mark.parametrize("kv_len_kind", ["none", "rows", "per_query"])
def test_int8_dense_attention_matches_jax(kv_len_kind):
    rng = np.random.default_rng(1)
    b, sq, h, kvh, d, t = 2, 3, 4, 2, 16, 11
    q = jnp.asarray(rng.normal(0, 0.3, (b, sq, h, d)), jnp.float32)
    kq, ks = jkv.quantize_kv(jnp.asarray(rng.normal(0, 1, (b, t, kvh, d)), jnp.float32))
    vq, vs = jkv.quantize_kv(jnp.asarray(rng.normal(0, 1, (b, t, kvh, d)), jnp.float32))
    kv_len = {"none": None, "rows": jnp.asarray([4, 11], jnp.int32),
              "per_query": jnp.asarray([[3, 4, 5], [9, 10, 11]], jnp.int32)}[kv_len_kind]
    want = np.asarray(j_int8_attention(q, kq, ks, vq, vs, kv_len=kv_len))
    got = t_int8_attention(_jt(q), _jt(kq), _jt(ks), _jt(vq), _jt(vs),
                           kv_len=None if kv_len is None else _jt(kv_len).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("start", [5, (2, 7)])
def test_update_quantized_kv_matches_jax(start):
    rng = np.random.default_rng(2)
    k_new = jnp.asarray(rng.normal(0, 1, (2, 1, 2, 16)), jnp.float32)
    v_new = jnp.asarray(rng.normal(0, 1, (2, 1, 2, 16)), jnp.float32)
    jcache = jkv.init_quantized_kv((), 2, 12, 2, 16)
    tcache = tkv.init_quantized_kv((), 2, 12, 2, 16, device="cpu")
    jstart = jnp.asarray(start, jnp.int32)
    want = jkv.update_quantized_kv(jcache, k_new, v_new, jstart)
    got = tkv.update_quantized_kv(tcache, _jt(k_new), _jt(v_new), _jt(jstart))
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(got[name], _jt(want[name])), name


def test_int8_pool_bytes_and_quantizing_insert():
    """The int8 pool is (hd + 2) / (2 hd) of the bf16 pool's bytes, and a
    prefill insert quantizes into the same values and scales as JAX's."""
    cfg = t_get_config(ARCH)  # bf16 compute, hd 64
    hd = cfg.resolved_head_dim
    sizes = {}
    for dtype in ("bfloat16", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=dtype)
        pools = tpc.init_paged_cache(c, 2, 5, 16, 2, device="meta")
        sizes[dtype] = sum(t.numel() * t.element_size() for n, t in pools["stack"].items()
                           if n != "page_table")
    assert sizes["int8"] * 2 * hd == sizes["bfloat16"] * (hd + 2)

    jcfg = dataclasses.replace(get_smoke_config(ARCH), kv_cache_dtype="int8")
    tcfg = dataclasses.replace(t_get_smoke_config(ARCH), kv_cache_dtype="int8")
    rng = np.random.default_rng(3)
    shape = (jcfg.num_layers, 1, 10, jcfg.num_kv_heads, jcfg.resolved_head_dim)
    pre = {"stack": {"k": jnp.asarray(rng.normal(0, 1, shape), jnp.float32),
                     "v": jnp.asarray(rng.normal(0, 1, shape), jnp.float32)}}
    row = jnp.asarray([3, 1, 0], jnp.int32)
    want = jpc.insert_prefill_paged(jpc.init_paged_cache(jcfg, 2, 5, 4, 3), pre, row)
    got = tpc.insert_prefill_paged(tpc.init_paged_cache(tcfg, 2, 5, 4, 3, device="cpu"),
                                   bridge.from_numpy(jax.tree_util.tree_map(np.asarray, pre)),
                                   _jt(row))
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(got["stack"][name], _jt(want["stack"][name])), name


def test_contiguous_int8_decode_matches_jax_and_bf16():
    """Teacher-forced decode through ``lm.init_cache`` caches: the int8
    cache's logits equal JAX's int8 ones within 1e-5, and stay within 5% of
    the bf16 cache's (the reference's bound)."""
    jcfg = get_smoke_config(ARCH)
    tcfg = t_get_smoke_config(ARCH)
    run = RunConfig(model=jcfg, shape=ShapeConfig("t", 16, 2, "decode"),
                    lrd=LRDConfig(enabled=False), dist=DistConfig(fsdp=False, remat="none"))
    jparams, _ = jsteps.init_params(run, jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    out = {}
    for dtype in ("bfloat16", "int8"):
        jc = dataclasses.replace(jcfg, kv_cache_dtype=dtype)
        tc = dataclasses.replace(tcfg, kv_cache_dtype=dtype)
        jcache, tcache = jlm.init_cache(jc, 2, 16), tlm.init_cache(tc, 2, 16, device="cpu")
        with torch.inference_mode():
            for t in range(8):
                jl, jcache, _ = jlm.lm_apply(jparams, jnp.asarray(toks[:, t:t + 1]), jc,
                                             mode="decode", cache=jcache,
                                             pos=jnp.asarray(t, jnp.int32))
                tl, tcache, _ = tlm.lm_apply(tparams, torch.from_numpy(toks[:, t:t + 1]), tc,
                                             mode="decode", cache=tcache,
                                             pos=torch.tensor(t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
        out[dtype] = tl.numpy()
    rel = np.abs(out["bfloat16"] - out["int8"]).max() / np.abs(out["bfloat16"]).max()
    assert rel < 0.05, rel


@pytest.mark.parametrize("mode", ["native", "bf16"])
def test_int8_pools_serve_tokens_match_jax_engine(mode):
    kw = dict(num_slots=3, max_len=40, prefill_len=16, block_size=8)
    jcfg = dataclasses.replace(get_smoke_config(ARCH), kv_cache_dtype="int8")
    tcfg = dataclasses.replace(t_get_smoke_config(ARCH), kv_cache_dtype="int8")
    jrun = RunConfig(model=jcfg, shape=ShapeConfig("s", 40, 3, "decode"),
                     lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False,
                                   int8_decode=mode),
                     dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=tcfg, shape=TShape("s", 40, 3, "decode"),
                lrd=TLRD(enabled=True, min_dim=16, rank_quantize=False, int8_decode=mode),
                dist=TDist(fsdp=False, remat="none"))
    jparams, _ = jsteps.init_params(jrun, jax.random.PRNGKey(5))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(6)
    trace = [{"prompt": rng.integers(0, jcfg.vocab_size, int(rng.integers(3, 16)),
                                     dtype=np.int32), "max_new": 9} for _ in range(5)]
    want = JServeEngine(jrun, jparams, config=JServeConfig(**kw)).serve(trace)
    engine = ServeEngine(trun, tparams, config=ServeConfig(**kw), device="cpu")
    got = engine.serve(trace)
    assert [r.tokens.tolist() for r in got] == [r.tokens.tolist() for r in want]
    pools = engine.scheduler.cache["stack"]
    assert pools["k"].dtype == torch.int8 and pools["k_scale"].dtype == torch.bfloat16
    assert engine.scheduler.forward_stats["nonfinite"] == 0
