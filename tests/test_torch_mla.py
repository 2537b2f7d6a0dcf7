"""MLA (DeepSeek-V3's attention) in the port against the JAX package, on
the smoke deepseek-v3-671b (float32; d 64, 4 heads, q latent 32, kv latent
16, nope / rope / v head dims 16 / 8 / 16), one layer's params made in JAX
(LRD on at Eq.-5 ranks, or off: ``kv_up`` factorised or dense) and
carried over by ``repro_torch.bridge``, inputs from a numpy seed:

* ``mla_init``'s leaves;
* ``mla_apply`` in full mode (output and the ``{"ckv", "kr"}`` cache) under
  ``attention_impl`` dense, blockwise and flash (K8's plain version against
  JAX's Pallas kernel in interpret mode);
* the absorbed decode against JAX's from the same padded cache: plain
  decode steps at per-row positions and at one position, a speculative
  verify chunk of 3 at per-row positions, a batch of 1 (the scalar-start
  path), a write that would run past ``max_len`` (clamped back inside, as
  ``lax.dynamic_update_slice`` clamps it);
* the absorbed decode against a full-mode forward over the same tokens;
* K8's plain version at MLA's head dims (q/k 192, v 128) against JAX's
  flash kernel in interpret mode, float32 and bfloat16.

Tolerance: 1e-5 relative and absolute in float32 (the same products
summed in another order); K8 as ``tests/test_torch_flash.py`` bounds it.
"""

import dataclasses
import functools

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
from repro.models import common as jcommon
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core.decompose import Decomposer
from repro_torch.core.policy import LM_DEFAULT
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
TOL = 1e-5  # float32: the same products summed in another order
F32_TOL, BF16_TOL = 1e-5, 3e-2  # K8's plain version against the Pallas kernel
B, S, MAX_LEN = 3, 10, 16


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_trees(got, want, tol=TOL):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys() and g
    for k in w:
        _close(g[k].detach().numpy(), np.asarray(w[k]), tol)


def _cfgs(impl="dense"):
    return (dataclasses.replace(get_smoke_config(ARCH), attention_impl=impl),
            dataclasses.replace(t_get_smoke_config(ARCH), attention_impl=impl))


@functools.lru_cache(maxsize=None)
def _layer(lrd: bool):
    """Layer 0 of JAX's dense stack's MLA params (numpy leaves; every
    leaf multiplied by a seeded factor so the norms' scales are not all
    ones), and the port's copy."""
    run = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", S, B, "train"),
                    lrd=LRDConfig(enabled=lrd, min_dim=16, rank_quantize=False),
                    dist=DistConfig(fsdp=False, remat="none"))
    params, _ = jsteps.init_params(run, jax.random.PRNGKey(3))
    attn = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], params["dense_stack"]["attn"])
    rng = np.random.default_rng(4)
    for norm in ("q_norm", "kv_norm"):
        attn[norm]["scale"] = rng.uniform(0.5, 1.5, attn[norm]["scale"].shape).astype(np.float32)
    return attn, bridge.params_from_jax(attn)


def _x(seed, b, s):
    return np.random.default_rng(seed).standard_normal((b, s, 64)).astype(np.float32)


def _ropes(s, pos=None):
    """(JAX's, the port's) rope tables at rope head dim 8: positions 0..s-1,
    or pos[b] + 0..s-1 per row for a (B,) ``pos``, or pos + 0..s-1."""
    if pos is None:
        return (jcommon.rope_table(s, 8, 1e4),
                tcommon.rope_table(s, 8, 1e4, device="cpu"))
    pos = np.asarray(pos).reshape(-1)
    positions = (pos[:, None] + np.arange(s)[None, :] if pos.size > 1
                 else pos[:1] + np.arange(s))
    return (jcommon.rope_table(s, 8, 1e4, positions=jnp.asarray(positions)),
            tcommon.rope_table(s, 8, 1e4, device="cpu", positions=torch.from_numpy(positions)))


def _full(lrd, impl, x):
    jcfg, tcfg = _cfgs(impl)
    jp, tp = _layer(lrd)
    jrope, trope = _ropes(x.shape[1])
    jy, jc = jattn.mla_apply(jp, jnp.asarray(x), jcfg, rope_q=jrope, rope_k=jrope, mode="full")
    with torch.inference_mode():
        ty, tc = tattn.mla_apply(tp, torch.from_numpy(x), tcfg, rope=trope, mode="full")
    return (jy, jc), (ty, tc)


def test_mla_init_leaves_match_jax():
    """The port's ``mla_init`` makes JAX's leaves, shapes and dtypes (the
    policy keeps q_down / kv_down dense, factorises q_up, kv_up and wo)."""
    jp, _ = _layer(True)
    tcfg = t_get_smoke_config(ARCH)
    dec = Decomposer(LM_DEFAULT.with_quantize(False).with_min_dim(16), dtype=torch.float32,
                     device="cpu", generator=torch.Generator().manual_seed(0))
    tp = tattn.mla_init(dec, "layers/dense/attn", tcfg)
    assert {k: tuple(v.shape) for k, v in _flat(tp).items()} == \
        {k: np.asarray(v).shape for k, v in _flat(jp).items()}
    assert "kernel" in tp["q_down"] and "kernel" in tp["kv_down"]
    assert all("u" in tp[k] for k in ("q_up", "kv_up", "wo"))
    assert set(dec.plan.layers) == {"layers/dense/attn/q_up", "layers/dense/attn/kv_up",
                                    "layers/dense/attn/wo"}


@pytest.mark.parametrize("impl", ["dense", "blockwise", "flash"])
@pytest.mark.parametrize("lrd", [True, False])
def test_mla_full_mode_matches_jax(lrd, impl):
    """Causal attention over per-head k = [k_nope, k_rope broadcast] and v:
    the output and the latent cache (``ckv`` normed, ``kr`` rotated).  The
    flash path runs K8's plain version here and JAX's Pallas kernel in
    interpret mode, at q/k head dim 24 and v head dim 16."""
    x = _x(1, B, S)
    (jy, jc), (ty, tc) = _full(lrd, impl, x)
    _close(ty.numpy(), jy)
    _close_trees(tc, jc)
    assert tuple(tc["ckv"].shape) == (B, S, 16) and tuple(tc["kr"].shape) == (B, S, 8)


def _padded_cache(lrd, x):
    """The full-mode cache of ``x``, padded to MAX_LEN: (JAX's, the
    port's), equal to begin with."""
    (_, jc), (_, tc) = _full(lrd, "dense", x)
    pad = MAX_LEN - x.shape[1]
    jc = {k: jnp.pad(v, ((0, 0), (0, pad), (0, 0))) for k, v in jc.items()}
    tc = {k: torch.nn.functional.pad(v, (0, 0, 0, pad)).clone() for k, v in tc.items()}
    return jc, tc


def _decode(lrd, jc, tc, x, pos):
    jcfg, tcfg = _cfgs()
    jp, tp = _layer(lrd)
    jrope, trope = _ropes(x.shape[1], pos)
    jy, jc = jattn.mla_apply(jp, jnp.asarray(x), jcfg, rope_q=jrope, rope_k=jrope,
                             mode="decode", cache=jc, pos=jnp.asarray(pos))
    with torch.inference_mode():
        ty, tc2 = tattn.mla_apply(tp, torch.from_numpy(x), tcfg, rope=trope, mode="decode",
                                  cache=tc, pos=torch.as_tensor(np.asarray(pos)))
    assert tc2 is tc  # written in place
    return jy, jc, ty


# (batch rows, chunk length, positions): plain decode at per-row
# positions, one position for every row, a verify chunk of 3 at per-row
# positions, a batch of 1 given a (1,) position (the scalar-start path), and
# writes that would run past MAX_LEN (row 2's chunk and the one-position
# batch): clamped back inside, masked at the unclamped length
DECODE_CASES = [(3, 1, (10, 7, 4)), (3, 1, 10), (3, 3, (10, 8, 5)), (1, 1, (9,)),
                (1, 3, (6,)), (3, 3, (10, 12, 15)), (3, 2, 15)]


@pytest.mark.parametrize("lrd", [True, False])
@pytest.mark.parametrize("b,s,pos", DECODE_CASES)
def test_mla_absorbed_decode_matches_jax(lrd, b, s, pos):
    """The absorbed decode (``kv_up`` taken apart into its k and v parts,
    ``u @ v`` when factorised) from the same padded cache: the output and
    the updated cache, written in place."""
    x = _x(2, b, S)
    jc, tc = _padded_cache(lrd, x)
    jy, jc, ty = _decode(lrd, jc, tc, _x(3, b, s), pos)
    _close(ty.numpy(), jy)
    _close_trees(tc, jc)


@pytest.mark.parametrize("lrd", [True, False])
def test_mla_decode_matches_full_forward(lrd):
    """Decoding tokens 8, 9 (one at a time) and 10-12 (one verify chunk)
    after a prefill of 8 gives the full-mode forward's outputs over all 13
    positions at those positions (the port alone, 1e-5)."""
    _, tcfg = _cfgs()
    _, tp = _layer(lrd)
    x = _x(5, B, 13)
    with torch.inference_mode():
        want, _ = tattn.mla_apply(tp, torch.from_numpy(x), tcfg, rope=_ropes(13)[1],
                                  mode="full")
        _, cache = tattn.mla_apply(tp, torch.from_numpy(x[:, :8]), tcfg, rope=_ropes(8)[1],
                                   mode="full")
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, MAX_LEN - 8)).clone()
                 for k, v in cache.items()}
        got = []
        for lo, hi in ((8, 9), (9, 10), (10, 13)):
            pos = np.full((B,), lo)
            y, _ = tattn.mla_apply(tp, torch.from_numpy(x[:, lo:hi]), tcfg,
                                   rope=_ropes(hi - lo, pos)[1], mode="decode", cache=cache,
                                   pos=torch.from_numpy(pos))
            got.append(y)
    _close(torch.cat(got, dim=1).numpy(), want[:, 8:].numpy())


def test_mla_decode_needs_a_cache():
    _, tcfg = _cfgs()
    _, tp = _layer(True)
    with pytest.raises(ValueError, match="cache and positions"):
        tattn.mla_apply(tp, torch.from_numpy(_x(0, 1, 1)), tcfg, mode="decode")


@pytest.mark.parametrize("causal,sq,sk", [(True, 64, 64), (False, 32, 64), (True, 32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_plain_version_at_mla_head_dims_matches_jax_kernel(dtype, causal, sq, sk):
    """K8's plain version at q/k head dim 192 and v head dim 128 (DeepSeek-V3's
    nope + rope and v) against JAX's flash kernel in interpret mode, whose
    blocks are (BH, S, D / Dv): the output's head dim is 128."""
    rng = np.random.default_rng(sq + sk)
    q, k = (rng.standard_normal((2, n, 192)).astype(np.float32) * 0.5 for n in (sq, sk))
    v = rng.standard_normal((2, sk, 128)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = j_flash_attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
                             block_q=32, block_kv=32, interpret=True)
    tdt = getattr(torch, dtype)
    with torch.inference_mode():
        got = flash_attention(*(torch.from_numpy(a).to(tdt)[:, :, None] for a in (q, k, v)),
                              causal=causal)[:, :, 0]
    assert got.dtype == tdt and tuple(got.shape) == (2, sq, 128)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= (F32_TOL if dtype == "float32" else BF16_TOL)
