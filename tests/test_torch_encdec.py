"""The encoder-decoder family's modules in the port against the JAX package,
on the smoke seamless-m4t-medium (float32; 2 encoder and 2 decoder layers,
d 64, 4 heads of 16, GELU FFN 128, 16 frames), LRD on at Eq.-5 ranks, with
params made once in JAX and carried over by ``repro_torch.bridge``.

Every cross-attention ``gate`` is overwritten by a seeded non-zero value
in both packages' trees: the init's zeros make ``y * tanh(gate)`` zero, so
a check at the init would not reach cross-attention at all.

* cross-attention ``gqa_apply`` in full mode (k/v from the memory, not
  causal) and in decode mode (q alone, against the cross cache);
* ``encode``;
* ``decode`` in full, train and decode mode (logits and caches);
* ``encdec_init`` (tree, shapes, plan) and ``encdec_init_cache``.

Tolerance: 1e-5 relative and absolute (float32; the same products summed
in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.serving.engine import pad_cache_preserving_cross as jpad_cross
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core.decompose import iter_factor_groups
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.serving.engine import pad_cache_preserving_cross

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
TOL = 1e-5  # float32: the same products summed in another order
B, S = 2, 10


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {} if tree is None else {path: tree}


def _shapes(tree):
    return {p: (tuple(t.shape), str(t.dtype).split(".")[-1]) for p, t in _flat(tree).items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_trees(got, want, tol=TOL):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys() and g
    for k in w:
        _close(g[k].detach().numpy(), w[k], tol)


def set_gates(params, seed=5):
    """``params`` (numpy leaves) with every cross-attention gate a seeded
    draw from U(0.3, 1.2) with a random sign: tanh(gate) is then between
    0.29 and 0.83 in magnitude, so the cross blocks weigh in."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.asarray, params)
    gate = out["dec_stack"]["cross_attn"]["gate"]
    vals = rng.uniform(0.3, 1.2, gate.shape) * rng.choice([-1.0, 1.0], gate.shape)
    out["dec_stack"]["cross_attn"]["gate"] = vals.astype(gate.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _params(lrd=True):
    """(JAX numpy params with non-zero gates, the port's copy), after
    checking the port's own init lays out the same tree and plan."""
    lrd_kw = dict(enabled=lrd, min_dim=16, rank_quantize=False)
    run = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", S, B, "train"),
                    lrd=LRDConfig(**lrd_kw), dist=DistConfig(fsdp=False, remat="none"))
    jparams, plan = jsteps.init_params(run, jax.random.PRNGKey(3))
    jparams = set_gates(jparams)
    tparams = bridge.params_from_jax(jparams)
    own, own_plan = steps.init_params(
        TRun(model=t_get_smoke_config(ARCH), shape=TShape("s", S, B, "train"),
             lrd=TLRD(**lrd_kw)), device="cpu")
    assert _shapes(own) == _shapes(tparams)
    assert sorted(p for p, _ in iter_factor_groups(own)) == \
        sorted(p for p, _ in iter_factor_groups(tparams))
    assert {k: (v.rank, v.shape) for k, v in own_plan.layers.items()} == \
        {k: (v.rank, tuple(v.shape)) for k, v in plan.layers.items()}
    assert not own["dec_stack"]["cross_attn"]["gate"].any()  # the init's zeros
    return jparams, tparams


def _inputs(seed, cfg):
    rng = np.random.default_rng(seed)
    frames = rng.normal(0, 0.1, (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return frames, toks


def _layer(tree, l=0):
    return jax.tree_util.tree_map(lambda a: a[l], tree)


# --------------------------------------------------------------------------
# cross-attention
# --------------------------------------------------------------------------

def test_init_lays_out_the_reference_tree():
    jparams, tparams = _params()
    assert set(tparams) == {"embed", "enc_stack", "dec_stack", "enc_norm", "dec_norm",
                            "unembed"}
    assert "kernel" in tparams["unembed"]  # dense, as the policy keeps it
    assert tparams["dec_stack"]["cross_attn"]["gate"].shape == (2, 1)
    assert "gate" not in tparams["dec_stack"]["self_attn"]
    assert "gate" not in tparams["enc_stack"]["attn"]


@pytest.mark.parametrize("lrd", [False, True])
def test_cross_attention_full_and_decode_match_jax(lrd):
    """Layer 0's cross block over a 16-frame memory: the output and the k/v
    it returns in full mode; then one decode row of queries against that
    k/v as the cross cache, returned unchanged."""
    jparams, tparams = _params(lrd)
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    jp = _layer(jparams["dec_stack"]["cross_attn"])
    tp = bridge.params_from_jax(jp)
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (B, S, jcfg.d_model)).astype(np.float32)
    mem = rng.normal(0, 1, (B, jcfg.encoder_frames, jcfg.d_model)).astype(np.float32)
    jy, jc = jattn.gqa_apply(jp, jnp.asarray(x), jcfg, mode="full", kv_src=jnp.asarray(mem))
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        ty, tc = tattn.gqa_apply(tp, torch.from_numpy(x), tcfg, mode="full",
                                 kv_src=torch.from_numpy(mem), policy=True)
    _close(ty.numpy(), jy)
    _close_trees(tc, jc)
    assert tc["k"].shape == (B, jcfg.encoder_frames, jcfg.num_kv_heads, 16)
    assert np.abs(np.asarray(jy)).max() > 1e-2  # the gate lets it through
    assert sum(f.op == "lowrank_fwd" for f in fbs) == (4 if lrd else 0)
    # decode: one token a row, the full mode's k/v as the cross cache
    xd = x[:, :1]
    jyd, jcd = jattn.gqa_apply(jp, jnp.asarray(xd), jcfg, mode="decode", cache=jc,
                               pos=jnp.zeros((), jnp.int32), kv_src=jnp.asarray(mem))
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        tyd, tcd = tattn.gqa_apply(tp, torch.from_numpy(xd), tcfg, mode="decode", cache=tc,
                                   pos=torch.zeros((), dtype=torch.int32),
                                   kv_src=torch.from_numpy(mem), policy=True)
    _close(tyd.numpy(), jyd)
    assert tcd is tc
    # q and wo only: the cache holds k and v
    assert sum(f.op == "lowrank_fwd" for f in fbs) == (2 if lrd else 0)


def test_gate_scales_the_cross_output():
    """tanh(gate) scales the cross block's output, in the param dtype's
    rounding: a zero gate gives exactly zero, as at the reference's init."""
    _, tparams = _params()
    tcfg = t_get_smoke_config(ARCH)
    tp = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["dec_stack"]["cross_attn"].items()}
    x = torch.randn((B, S, tcfg.d_model), generator=torch.Generator().manual_seed(0))
    mem = torch.randn((B, 16, tcfg.d_model), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        y, _ = tattn.gqa_apply(tp, x, tcfg, kv_src=mem)
        y0, _ = tattn.gqa_apply(dict(tp, gate=torch.zeros(1)), x, tcfg, kv_src=mem)
        y1, _ = tattn.gqa_apply({k: v for k, v in tp.items() if k != "gate"}, x, tcfg,
                                kv_src=mem)
    assert not y0.any()
    torch.testing.assert_close(y, y1 * torch.tanh(tp["gate"].float()), rtol=0, atol=0)


# --------------------------------------------------------------------------
# encode / decode
# --------------------------------------------------------------------------

def test_encode_matches_jax():
    jparams, tparams = _params()
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    frames, _ = _inputs(1, jcfg)
    want = jed.encode(jparams, jnp.asarray(frames), jcfg)
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        got = ted.encode(tparams, torch.from_numpy(frames), tcfg)
    _close(got.numpy(), want)
    assert got.shape == (B, jcfg.encoder_frames, jcfg.d_model)
    # the reference's encoder runs with the kernels off
    assert {f.reason for f in fbs if f.op == "lowrank_fwd"} == {"disabled"}


def test_decode_full_and_train_match_jax():
    jparams, tparams = _params()
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    frames, toks = _inputs(2, jcfg)
    jmem = jed.encode(jparams, jnp.asarray(frames), jcfg)
    tmem = torch.from_numpy(np.array(jmem))
    jlog, jcache = jed.decode(jparams, jnp.asarray(toks), jmem, jcfg, mode="full")
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        tlog, tcache = ted.decode(tparams, torch.from_numpy(toks), tmem, tcfg, mode="full",
                                  policy=True)
    _close(tlog.numpy(), jlog)
    _close_trees(tcache, jcache)
    assert tlog.dtype == torch.float32 and tlog.shape == (B, S, tcfg.vocab_padded)
    # 10 factorised projections a decoder layer (self 4, cross 4, FFN 2)
    assert sum(f.op == "lowrank_fwd" and f.reason == "platform" for f in fbs) == 20
    jtrain, none = jed.decode(jparams, jnp.asarray(toks), jmem, jcfg, mode="train")
    with torch.inference_mode():
        ttrain, tnone = ted.decode(tparams, torch.from_numpy(toks), tmem, tcfg, mode="train")
    assert tnone is None and none["dec_stack"] is None
    _close(ttrain.numpy(), jtrain)


def test_decode_steps_match_jax():
    """Prefill of 10 tokens, the cache padded to a 13-position window with
    the cross k/v kept at 16 frames, then 3 greedy decode steps, the
    port's given no memory (its cross blocks read the cache): logits, and
    the caches at the end."""
    jparams, tparams = _params()
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    frames, toks = _inputs(3, jcfg)
    jmem = jed.encode(jparams, jnp.asarray(frames), jcfg)
    tmem = torch.from_numpy(np.array(jmem))
    jlog, jcache = jed.decode(jparams, jnp.asarray(toks), jmem, jcfg, mode="full")
    jcache = jpad_cross(jcache, 13)
    with torch.inference_mode():
        _, tcache = ted.decode(tparams, torch.from_numpy(toks), tmem, tcfg, mode="full")
        tcache = pad_cache_preserving_cross(tcache, 13)
    assert {k: v[0] for k, v in _shapes(tcache).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jcache).items()}
    decode = jax.jit(lambda p, t, m, c, pos: jed.decode(p, t, m, jcfg, mode="decode",
                                                        cache=c, pos=pos))
    nxt = np.argmax(np.asarray(jlog)[:, -1:], axis=-1).astype(np.int32)
    for i in range(3):
        pos = np.int32(S + i)
        jlog, jcache = decode(jparams, jnp.asarray(nxt), jmem, jcache, jnp.asarray(pos))
        with torch.inference_mode():
            tlog, tcache = ted.decode(tparams, torch.from_numpy(nxt), None, tcfg,
                                      mode="decode", cache=tcache, pos=torch.tensor(pos),
                                      policy=True)
        _close(tlog.numpy(), jlog)
        nxt = np.argmax(np.asarray(jlog)[:, -1:], axis=-1).astype(np.int32)
    _close_trees(tcache, jcache)


@pytest.mark.parametrize("mode", ["full", "train"])
def test_decode_needs_the_memory(mode):
    """The prefill and train modes project the cross k/v from the memory;
    a decode step reads them from the cache and takes none."""
    _, tparams = _params()
    tcfg = t_get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="memory"):
        ted.decode(tparams, torch.zeros((1, 1), dtype=torch.int32), None, tcfg, mode=mode)


def test_init_cache_matches_jax_layout():
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            _flat(jed.encdec_init_cache(jcfg, 3, 20)).items()}
    got = _shapes(ted.encdec_init_cache(tcfg, 3, 20, "cpu"))
    assert got == want


def test_decode_from_an_init_cache_matches_a_padded_prefill():
    """The same decode step against ``encdec_init_cache`` filled with a
    prefill's k/v as against that prefill's padded cache: one layout."""
    _, tparams = _params()
    tcfg = t_get_smoke_config(ARCH)
    frames, toks = _inputs(4, tcfg)
    with torch.inference_mode():
        mem = ted.encode(tparams, torch.from_numpy(frames), tcfg)
        log, pre = ted.decode(tparams, torch.from_numpy(toks), mem, tcfg, mode="full")
        cache = ted.encdec_init_cache(tcfg, B, 13, "cpu")
        for part in ("self", "cross"):
            for kv in ("k", "v"):
                src = pre["dec_stack"][part][kv]
                cache["dec_stack"][part][kv][:, :, :src.shape[2]] = src
        padded = pad_cache_preserving_cross(pre, 13)
        tok = torch.argmax(log[:, -1:], dim=-1).to(torch.int32)
        a, _ = ted.decode(tparams, tok, mem, tcfg, mode="decode", cache=cache,
                          pos=torch.tensor(S))
        b, _ = ted.decode(tparams, tok, mem, tcfg, mode="decode", cache=padded,
                          pos=torch.tensor(S))
    assert torch.equal(a, b)
