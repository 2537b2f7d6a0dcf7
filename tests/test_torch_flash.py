"""Flash attention (K8) in the port against the JAX package on the CPU.

K8's plain version (``ref.flash_attention_fwd_ref``, what the port runs on
CPU tensors) against the JAX Pallas kernel run as its own tests run it
(``interpret=True``), the port's ``attention_core`` and ``lm_apply`` with
``attention_impl="flash"`` against JAX's (which falls back to dense or
blockwise attention where the lengths do not tile its blocks; the port's
path takes every length), and the port's ``ServeEngine`` against the JAX
engine on the flash config.  Inputs come from numpy seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.serving import ServeConfig, ServeEngine

torch.set_num_threads(1)

ARCH = "smollm-360m"
# tests/test_flash_attention.py's CASES: (bh, sq, sk, d, causal, bq, bkv)
CASES = [
    (4, 512, 512, 64, True, 128, 128),
    (2, 256, 512, 128, False, 128, 256),
    (6, 512, 512, 128, True, 256, 512),
    (1, 1024, 1024, 64, True, 256, 256),
    (3, 128, 384, 64, False, 128, 128),
]
# max |port - JAX| / max |JAX|: float32 sums taken in another order (one
# softmax pass against the kernel's online blocks); in bf16 also p's
# rounding relative to another running max (tests/test_flash_attention.py's
# bound)
F32_TOL, BF16_TOL = 1e-5, 3e-2
MODEL_TOL = 1e-4  # test_flash_impl_matches_blockwise_in_model's bound


def _normal(seed, *shapes, scales=None):
    rng = np.random.default_rng(seed)
    scales = scales or [1.0] * len(shapes)
    return [(rng.standard_normal(s) * c).astype(np.float32) for s, c in zip(shapes, scales)]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# --------------------------------------------------------------------------
# (a), (b): K8's plain version against the JAX kernel (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bh,sq,sk,d,causal,bq,bkv", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_kernel(bh, sq, sk, d, causal, bq, bkv, dtype):
    q, k, v = _normal(bh * sq + sk, (bh, sq, d), (bh, sk, d), (bh, sk, d),
                      scales=[0.5, 0.5, 1.0])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = j_flash_attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                             causal=causal, block_q=bq, block_kv=bkv, interpret=True)
    tdt = getattr(torch, dtype)
    # (BH, S, D) -> (B = BH, S, H = 1, D)
    tq, tk, tv = (torch.from_numpy(a).to(tdt)[:, :, None] for a in (q, k, v))
    with torch.inference_mode():
        got = flash_attention(tq, tk, tv, causal=causal)[:, :, 0]
    assert got.dtype == tdt
    assert _rel(got.float().numpy(), want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


def test_plain_version_ignores_future_kv_exactly():
    """Causal output is invariant to the content of future positions."""
    q, k, v = (torch.from_numpy(a)[:, :, None]
               for a in _normal(0, (2, 256, 64), (2, 256, 64), (2, 256, 64)))
    base = flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, 128:] = 999.0  # poison strictly-future kv for rows < 128
    v2[:, 128:] = -999.0
    poisoned = flash_attention(q, k2, v2, causal=True)
    assert torch.equal(base[:, :128], poisoned[:, :128])
    # and the unpoisoned rows agree with the JAX kernel
    jq, jk, jv = (jnp.asarray(t[:, :, 0].numpy()) for t in (q, k, v))
    want = j_flash_attention(jq, jk, jv, causal=True, block_q=128, block_kv=128,
                             interpret=True)
    assert _rel(poisoned[:, :128, 0].numpy(), np.asarray(want)[:, :128]) <= F32_TOL


# --------------------------------------------------------------------------
# (c): attention_core with attention_impl="flash", GQA, hd 64 / 128
# --------------------------------------------------------------------------

def _cfgs(h, kv, hd):
    over = dict(num_heads=h, num_kv_heads=kv, head_dim=hd, attention_impl="flash",
                attention_block_q=16, attention_block_kv=16)
    return (dataclasses.replace(get_smoke_config(ARCH), **over),
            dataclasses.replace(t_get_smoke_config(ARCH), **over))


@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [32, 20])  # tiles the 16-blocks / JAX falls back
@pytest.mark.parametrize("causal", [True, False])
def test_attention_core_matches_jax(g, hd, s, causal):
    kv = 2
    jcfg, tcfg = _cfgs(kv * g, kv, hd)
    q, k, v = _normal(hd + s + g, (2, s, kv * g, hd), (2, s, kv, hd), (2, s, kv, hd),
                      scales=[hd ** -0.5, 1.0, 1.0])
    want = jattn.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg,
                                causal=causal)
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        got = tattn.attention_core(*(torch.from_numpy(a) for a in (q, k, v)), tcfg,
                                   causal=causal)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= F32_TOL
    assert [(f.op, f.reason) for f in fbs] == [("flash_attention", "platform")]


# --------------------------------------------------------------------------
# (d), (f), (g): the whole slice through lm_apply
# --------------------------------------------------------------------------

def _params(lrd: bool):
    run = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", 32, 2, "decode"),
                    lrd=LRDConfig(enabled=lrd, min_dim=16, rank_quantize=False),
                    dist=DistConfig(fsdp=False, remat="none"))
    params, _ = jsteps.init_params(run, jax.random.PRNGKey(7))
    return params, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _flash(cfg):
    return dataclasses.replace(cfg, attention_impl="flash", attention_block_q=16,
                               attention_block_kv=16)


@pytest.mark.parametrize("lrd", [False, True])
@pytest.mark.parametrize("s", [32, 20])
def test_lm_prefill_logits_match_jax(lrd, s):
    jparams, tparams = _params(lrd)
    jcfg, tcfg = _flash(get_smoke_config(ARCH)), _flash(t_get_smoke_config(ARCH))
    toks = np.random.default_rng(s).integers(0, jcfg.vocab_size, (2, s), dtype=np.int32)
    jlog, jcache, _ = jlm.lm_apply(jparams, jnp.asarray(toks), jcfg, mode="full")
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        tlog, tcache, _ = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg, mode="full",
                                       policy=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=MODEL_TOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tcache["stack"][leaf].numpy(),
                                   np.asarray(jcache["stack"][leaf]), rtol=0, atol=MODEL_TOL)
    flash = [f for f in fbs if f.op == "flash_attention"]
    hd = tcfg.resolved_head_dim
    assert flash == [ops.Fallback("flash_attention", "platform",
                                  (2, s, s, tcfg.num_heads, tcfg.num_kv_heads, hd))
                     ] * tcfg.num_layers


def test_flash_does_not_read_the_kernel_policy():
    """Like JAX's ``_flash_path``, the config alone selects the path: with
    the policy off the attention still goes through the flash dispatcher."""
    _, tparams = _params(False)
    tcfg = _flash(t_get_smoke_config(ARCH))
    toks = torch.zeros((1, 16), dtype=torch.int32)
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        tlm.lm_apply(tparams, toks, tcfg, mode="full", policy=False)
    assert sum(f.op == "flash_attention" for f in fbs) == tcfg.num_layers


def test_flash_is_forward_only():
    _, tparams = _params(True)
    tcfg = _flash(t_get_smoke_config(ARCH))
    live = jax.tree_util.tree_map(lambda t: t.detach().requires_grad_(True), tparams)
    toks = torch.zeros((2, 16), dtype=torch.int32)
    with torch.enable_grad(), pytest.raises(RuntimeError, match="forward only"):
        tlm.lm_apply(live, toks, tcfg, mode="train", policy=True)
    q = torch.zeros((1, 4, 2, 64), requires_grad=True)
    with torch.enable_grad(), pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention_apply(q, q.detach(), q.detach(), causal=True)
    # under inference the same call runs
    with torch.no_grad():
        assert ops.flash_attention_apply(q, q, q, causal=True).shape == q.shape


# --------------------------------------------------------------------------
# (e): the serving engine on the flash config
# --------------------------------------------------------------------------

def test_engine_greedy_tokens_match_jax_engine():
    kw = dict(num_slots=2, max_len=40, prefill_len=16, block_size=8)
    jrun = RunConfig(model=_flash(get_smoke_config(ARCH)),
                     shape=ShapeConfig("s", 40, 2, "decode"),
                     lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False),
                     dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=_flash(t_get_smoke_config(ARCH)), shape=TShape("s", 40, 2, "decode"),
                lrd=TLRD(enabled=True, min_dim=16, rank_quantize=False))
    jparams, _ = jsteps.init_params(jrun, jax.random.PRNGKey(3))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(12)
    trace = [{"prompt": rng.integers(0, jrun.model.vocab_size, int(rng.integers(4, 16)),
                                     dtype=np.int32), "max_new": 6} for _ in range(3)]
    want = JServeEngine(jrun, jparams, config=JServeConfig(**kw)).serve(trace)
    engine = ServeEngine(trun, tparams, config=ServeConfig(**kw), device="cpu")
    with ops.capture_fallbacks() as fbs:
        got = engine.serve(trace)
    assert [r.tokens.tolist() for r in got] == [r.tokens.tolist() for r in want]
    n_flash = sum(f.op == "flash_attention" for f in fbs)
    assert n_flash == engine.scheduler.forward_stats["prefill"] * trun.model.num_layers
