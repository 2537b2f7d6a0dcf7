"""The VLM family's model in the port against the JAX package, on the smoke
llama-3.2-vision-90b (float32; 6 layers as 2 groups of 2 self layers and a
cross block, d 64, 4 heads of 16 with 2 KV heads, SwiGLU 128, 8 image
tokens), LRD on at Eq.-5 ranks, with params made once in JAX and carried
over by ``repro_torch.bridge``.

Every cross-attention ``gate`` is overwritten by a seeded non-zero value
in both packages' trees: the init's zeros make ``y * tanh(gate)`` zero, so
a check at the init would not reach cross-attention at all.

* ``lm_init`` (the two-axis ``self_stack``, ``cross_stack``, the plan);
* ``lm_apply`` in full, train and decode mode (logits within 1e-5, the
  self and cross caches);
* every remat policy against ``none`` (logits and gradients);
* ``init_cache``, and a decode step from it against one from a padded
  prefill;
* the bridge both ways on the VLM tree;
* the gated block's ``ValueError`` without vision embeddings.

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
from repro.models import lm as jlm
from repro.serving.engine import pad_cache_preserving_cross as jpad_cross
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core.decompose import iter_factor_groups
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import pad_cache_preserving_cross

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"
TOL = 1e-5  # float32: the same products summed in another order
B, S = 2, 10
GROUPS, EVERY = 2, 2  # the smoke config: 6 layers, a cross block after every 2


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
    """``params`` (numpy leaves) with every cross gate a seeded draw from
    U(0.3, 1.2) with a random sign: |tanh(gate)| is then 0.29 to 0.83, so
    the cross blocks weigh in."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.asarray, params)
    gate = out["cross_stack"]["attn"]["gate"]
    vals = rng.uniform(0.3, 1.2, gate.shape) * rng.choice([-1.0, 1.0], gate.shape)
    out["cross_stack"]["attn"]["gate"] = vals.astype(gate.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _params(lrd=True):
    """(JAX numpy params with non-zero gates, the port's copy), after
    checking that the port's own init lays out the same tree and plan."""
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
    assert not own["cross_stack"]["attn"]["gate"].any()  # the init's zeros
    return jparams, tparams


def _inputs(seed, cfg, s=S):
    rng = np.random.default_rng(seed)
    vision = rng.normal(0, 0.1, (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, s), dtype=np.int32)
    return vision, toks


# --------------------------------------------------------------------------
# init and bridge
# --------------------------------------------------------------------------

def test_config_matches_jax():
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    assert (tcfg.num_layers, tcfg.cross_attn_every, tcfg.num_image_tokens,
            tcfg.num_kv_heads) == (6, 2, 8, 2)
    for name in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
                 "cross_attn_every", "num_image_tokens", "rope_theta", "family"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


def test_init_lays_out_the_reference_tree():
    _, tparams = _params()
    assert set(tparams) == {"embed", "self_stack", "cross_stack", "final_norm", "unembed"}
    assert tparams["self_stack"]["norm1"]["scale"].shape == (GROUPS, EVERY, 64)
    assert tparams["self_stack"]["attn"]["wq"]["u"].shape[:2] == (GROUPS, EVERY)
    assert tparams["cross_stack"]["attn"]["gate"].shape == (GROUPS, 1)
    assert tparams["cross_stack"]["ffn"]["down"]["u"].shape[0] == GROUPS
    assert "gate" not in tparams["self_stack"]["attn"]


@pytest.mark.parametrize("lrd", [False, True])
def test_bridge_carries_the_vlm_tree_both_ways(lrd):
    """numpy -> torch -> numpy keeps every leaf of the two-axis self stack
    and the cross gates bit for bit."""
    jparams, tparams = _params(lrd)
    back = bridge.params_to_numpy(tparams)
    j, b = _flat(jparams), _flat(back)
    assert j.keys() == b.keys()
    for k in j:
        np.testing.assert_array_equal(b[k], np.asarray(j[k], np.float32))
    gate = tparams["cross_stack"]["attn"]["gate"]
    assert gate.dtype == torch.float32 and (gate != 0).all()


# --------------------------------------------------------------------------
# lm_apply
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lrd", [False, True])
def test_full_mode_logits_and_caches_match_jax(lrd):
    jparams, tparams = _params(lrd)
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    vision, toks = _inputs(1, jcfg)
    jlog, jcache, _ = jlm.lm_apply(jparams, jnp.asarray(toks), jcfg, mode="full",
                                   vision_embeddings=jnp.asarray(vision))
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        tlog, tcache, aux = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg, mode="full",
                                         vision_embeddings=torch.from_numpy(vision),
                                         policy=True)
    _close(tlog.numpy(), jlog)
    _close_trees(tcache, jcache)
    assert tcache["self"]["k"].shape == (GROUPS, EVERY, B, S, 2, 16)
    assert tcache["cross"]["k"].shape == (GROUPS, B, tcfg.num_image_tokens, 2, 16)
    assert float(aux) == 0.0
    # each layer, self or cross: wq, wk, wv, wo and down through K1, gate/up
    # through K5
    n = GROUPS * (EVERY + 1)
    assert sum(f.op == "lowrank_fwd" for f in fbs) == (5 * n if lrd else 0)
    assert sum(f.op == "lowrank_ffn" for f in fbs) == (n if lrd else 0)


def test_cross_blocks_reach_the_logits():
    """With the gates seeded, other vision embeddings give other logits;
    at the init's zero gates they give the same."""
    jparams, tparams = _params()
    tcfg = t_get_smoke_config(ARCH)
    vision, toks = _inputs(2, tcfg)
    other = vision[::-1].copy()
    with torch.inference_mode():
        a, _, _ = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg,
                               vision_embeddings=torch.from_numpy(vision))
        b, _, _ = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg,
                               vision_embeddings=torch.from_numpy(other))
        shut = dict(tparams, cross_stack=dict(
            tparams["cross_stack"], attn=dict(tparams["cross_stack"]["attn"],
                                              gate=torch.zeros(GROUPS, 1))))
        c, _, _ = tlm.lm_apply(shut, torch.from_numpy(toks), tcfg,
                               vision_embeddings=torch.from_numpy(vision))
        d, _, _ = tlm.lm_apply(shut, torch.from_numpy(toks), tcfg,
                               vision_embeddings=torch.from_numpy(other))
    assert (a - b).abs().max() > 1e-3
    assert torch.equal(c, d)


def test_train_mode_matches_jax():
    jparams, tparams = _params()
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    vision, toks = _inputs(3, jcfg)
    jlog, jcache, _ = jlm.lm_apply(jparams, jnp.asarray(toks), jcfg, mode="train",
                                   vision_embeddings=jnp.asarray(vision))
    with torch.inference_mode():
        tlog, tcache, _ = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg, mode="train",
                                       vision_embeddings=torch.from_numpy(vision), policy=True)
    assert tcache is None and jcache["self"] is None and jcache["cross"] is None
    _close(tlog.numpy(), jlog)


@pytest.mark.parametrize("mode", ["full", "train"])
def test_gated_block_without_vision_embeddings_raises(mode):
    """The port's cross blocks need ``kv_src`` in full and train mode (the
    reference's would run as causal self-attention with the gate unused)."""
    _, tparams = _params()
    tcfg = t_get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="kv_src"):
        tlm.lm_apply(tparams, torch.zeros((1, 4), dtype=torch.int32), tcfg, mode=mode)


def test_prefill_then_decode_steps_match_jax():
    """Prefill of 10 tokens, the cache padded to a 13-position window with
    the cross k/v kept at the 8 image tokens, then 3 greedy decode steps
    (JAX's handed the vision embeddings, which only mark its cross blocks;
    the port's given none): logits each step, and both caches at the end,
    the cross k/v unchanged."""
    jparams, tparams = _params()
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    vision, toks = _inputs(4, jcfg)
    jvis = jnp.asarray(vision)
    jlog, jcache, _ = jlm.lm_apply(jparams, jnp.asarray(toks), jcfg, mode="full",
                                   vision_embeddings=jvis)
    jcache = jpad_cross(jcache, 13)
    with torch.inference_mode():
        _, tcache, _ = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg, mode="full",
                                    vision_embeddings=torch.from_numpy(vision))
        tcache = pad_cache_preserving_cross(tcache, 13)
    assert {k: v[0] for k, v in _shapes(tcache).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jcache).items()}
    cross0 = {k: v.clone() for k, v in tcache["cross"].items()}
    decode = jax.jit(lambda p, t, c, pos: jlm.lm_apply(p, t, jcfg, mode="decode", cache=c,
                                                       pos=pos, vision_embeddings=jvis))
    nxt = np.argmax(np.asarray(jlog)[:, -1:], axis=-1).astype(np.int32)
    for i in range(3):
        pos = np.int32(S + i)
        jlog, jcache, _ = decode(jparams, jnp.asarray(nxt), jcache, jnp.asarray(pos))
        with ops.capture_fallbacks() as fbs, torch.inference_mode():
            tlog, tcache, _ = tlm.lm_apply(tparams, torch.from_numpy(nxt), tcfg, mode="decode",
                                           cache=tcache, pos=torch.tensor(pos), policy=True)
        _close(tlog.numpy(), jlog)
        # a cross block projects q and wo only in decode
        assert sum(f.op == "lowrank_fwd" for f in fbs) == GROUPS * (EVERY * 5 + 3)
        nxt = np.argmax(np.asarray(jlog)[:, -1:], axis=-1).astype(np.int32)
    _close_trees(tcache, jcache)
    assert all(torch.equal(tcache["cross"][k], cross0[k]) for k in cross0)


@pytest.mark.parametrize("remat", ["full", "dots", "sqrt"])
def test_remat_equals_none(remat):
    """Every remat policy runs the same forward: the train-mode logits and
    every gradient equal those without remat bit for bit; ``full`` and
    ``sqrt`` run each layer's forward again (a group's cross block once
    more, its self layers twice more: the group and the layer are both
    checkpointed), ``dots`` none (as the reference's ``_vlm_forward``)."""
    _, tparams = _params()
    tcfg = t_get_smoke_config(ARCH)
    vision, toks = _inputs(5, tcfg)

    def run(policy):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in _flat(tparams).items()}

        def rebuild(tree, path=""):
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{path}/{k}") for k, v in tree.items()}
            return leaves[path]

        with ops.capture_fallbacks() as fbs:
            logits, _, _ = tlm.lm_apply(rebuild(tparams), torch.from_numpy(toks), tcfg,
                                        mode="train", remat=policy,
                                        vision_embeddings=torch.from_numpy(vision), policy=True)
            grads = torch.autograd.grad(logits.square().mean(), list(leaves.values()),
                                        allow_unused=True)
        fwd = sum(f.op == "lowrank_ffn" for f in fbs)
        return logits.detach(), grads, fwd

    want, wgrads, wfwd = run("none")
    got, ggrads, gfwd = run(remat)
    assert torch.equal(got, want)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(ggrads, wgrads))
    # K5 once a layer forward, plus the recomputes (the backward recomputes
    # the FFN's branches through K1, not K5)
    extra = {"full": GROUPS * (1 + 2 * EVERY), "sqrt": GROUPS * (1 + 2 * EVERY), "dots": 0}
    assert gfwd == wfwd + extra[remat]


def test_init_cache_matches_jax_layout():
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            _flat(jlm.init_cache(jcfg, 3, 20)).items()}
    got = _shapes(tlm.init_cache(tcfg, 3, 20, "cpu"))
    assert got == want
    assert got["/cross/k"][0] == (GROUPS, 3, 8, 2, 16)


def test_decode_from_an_init_cache_matches_a_padded_prefill():
    """The same decode step against ``init_cache`` filled with a prefill's
    k/v as against that prefill's padded cache: one layout."""
    _, tparams = _params()
    tcfg = t_get_smoke_config(ARCH)
    vision, toks = _inputs(6, tcfg)
    with torch.inference_mode():
        log, pre, _ = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg, mode="full",
                                   vision_embeddings=torch.from_numpy(vision))
        cache = tlm.init_cache(tcfg, B, 13, "cpu")
        for part in ("self", "cross"):
            for kv in ("k", "v"):
                src = pre[part][kv]
                cache[part][kv][..., :src.shape[-3], :, :] = src
        padded = pad_cache_preserving_cross(pre, 13)
        tok = torch.argmax(log[:, -1:], dim=-1).to(torch.int32)
        a, _, _ = tlm.lm_apply(tparams, tok, tcfg, mode="decode", cache=cache,
                               pos=torch.tensor(S))
        b, _, _ = tlm.lm_apply(tparams, tok, tcfg, mode="decode", cache=padded,
                               pos=torch.tensor(S))
    assert torch.equal(a, b)
