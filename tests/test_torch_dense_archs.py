"""The large dense configs' own attention paths in the port against the JAX
package, at smoke size (float32; 2 layers, d 64, 4 heads of 16 with 2 KV
heads, SwiGLU 128): qwen2-72b's q/k/v biases (``qkv_bias``), qwen3-32b's
per-head q/k RMS norms (``qk_norm``; also at its own head dim 128) and
deepseek-coder-33b's plain GQA at rope theta 1e5.  LRD on at Eq.-5 ranks,
params made once in JAX (every bias and qk-norm scale a seeded draw, so
neither is the init's zero or one) and carried over by
``repro_torch.bridge``:

* the prefill step's last-position logits and k/v cache, then three serve
  steps, against JAX's (1e-5);
* decode against a full forward over the same tokens (the port alone);
* one train step's loss and gradients against JAX's at phase 1 (1e-4),
  the frozen factor's kernel never run.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro.data import LMBatchIterator
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.serving.engine import pad_cache as jpad_cache
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import pad_cache

torch.set_num_threads(1)

TOL = 1e-5  # float32 logits: the same products summed in another order
GRAD_TOL = 1e-4  # loss and gradients of a train step
SEQ, BATCH = 16, 2
# (arch, head dim override): each config's own path, qwen3-32b also at its
# full head dim
CASES = [("qwen2-72b", None), ("qwen3-32b", None), ("qwen3-32b", 128),
         ("deepseek-coder-33b", None)]
IDS = ["qwen2-72b", "qwen3-32b", "qwen3-32b-hd128", "deepseek-coder-33b"]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {} if tree is None else {path: tree}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_trees(got, want, tol=TOL):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys() and g
    for k in w:
        _close(g[k].detach().numpy(), np.asarray(w[k]), tol)


def _cfgs(arch, hd):
    kw = {} if hd is None else {"head_dim": hd}
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(t_get_smoke_config(arch), **kw))


def _lrd(**kw):
    return dict(enabled=True, min_dim=16, rank_quantize=False, **kw)


@functools.lru_cache(maxsize=None)
def _params(arch, hd):
    jcfg, _ = _cfgs(arch, hd)
    run = RunConfig(model=jcfg, shape=ShapeConfig("s", SEQ, BATCH, "train"),
                    lrd=LRDConfig(**_lrd()), dist=DistConfig(fsdp=False, remat="none"))
    jparams, _ = jsteps.init_params(run, jax.random.PRNGKey(11))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(12)
    attn = jparams["stack"]["attn"]
    for k in ("q_norm", "k_norm"):
        if k in attn:
            attn[k]["scale"] = rng.uniform(0.5, 1.5, attn[k]["scale"].shape).astype(np.float32)
    for k in ("wq", "wk", "wv"):
        if "bias" in attn[k]:
            attn[k]["bias"] = rng.normal(0, 0.5, attn[k]["bias"].shape).astype(np.float32)
    return jparams, bridge.params_from_jax(jparams)


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


@pytest.mark.parametrize("arch,hd", CASES, ids=IDS)
def test_config_path_is_what_the_test_means(arch, hd):
    """The smoke trees carry what each config is chosen for."""
    _, tparams = _params(arch, hd)
    attn = tparams["stack"]["attn"]
    assert ("bias" in attn["wq"]) == (arch == "qwen2-72b")
    assert ("q_norm" in attn) == (arch == "qwen3-32b")
    assert tuple(attn["wq"]["v"].shape)[-1] == 4 * (hd or 16)


@pytest.mark.parametrize("arch,hd", CASES, ids=IDS)
def test_prefill_and_serve_steps_match_jax(arch, hd):
    jparams, tparams = _params(arch, hd)
    jcfg, tcfg = _cfgs(arch, hd)
    jrun = RunConfig(model=jcfg, shape=ShapeConfig("s", 16, 3, "decode"),
                     lrd=LRDConfig(**_lrd()), dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=tcfg, shape=TShape("s", 16, 3, "decode"),
                lrd=TLRD(**_lrd(), use_pallas_kernel=True), dist=TDist(fsdp=False, remat="none"))
    mesh = make_host_mesh(1, 1)
    toks = _tokens(1, 3, 10)
    jlast, jcache = jsteps.build_prefill_step(jrun, mesh)(jparams, {"tokens": jnp.asarray(toks)})
    tlast, tcache = steps.build_prefill_step(trun)(tparams, {"tokens": torch.from_numpy(toks)})
    _close(tlast.numpy(), jlast)
    _close_trees(tcache, jcache)
    jcache, tcache = jpad_cache(jcache, 13), pad_cache(tcache, 13)
    jstep = jax.jit(jsteps.build_serve_step(jrun, mesh))
    tstep = steps.build_serve_step(trun)
    nxt = np.argmax(np.asarray(jlast), axis=-1).astype(np.int32)[:, None]
    for i in range(3):
        pos = np.int32(10 + i)
        jlog, jcache, jnext = jstep(jparams, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        tlog, tcache, tnext = tstep(tparams, tcache, torch.from_numpy(nxt), torch.tensor(pos))
        _close(tlog.numpy(), jlog)
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
        nxt = np.array(jnext)
    _close_trees(tcache, jcache)


@pytest.mark.parametrize("arch,hd", CASES, ids=IDS)
def test_decode_matches_full_forward(arch, hd):
    _, tparams = _params(arch, hd)
    _, tcfg = _cfgs(arch, hd)
    toks = torch.from_numpy(_tokens(2, 2, 12))
    with torch.inference_mode():
        want, _, _ = tlm.lm_apply(tparams, toks, tcfg, mode="full")
        _, cache, _ = tlm.lm_apply(tparams, toks[:, :9], tcfg, mode="full")
        cache = pad_cache(cache, 12)
        for t in range(9, 12):
            got, cache, _ = tlm.lm_apply(tparams, toks[:, t:t + 1], tcfg, mode="decode",
                                         cache=cache, pos=torch.full((2,), t))
            _close(got[:, 0].numpy(), want[:, t].numpy())


@pytest.mark.parametrize("arch,hd", CASES, ids=IDS)
def test_train_step_grads_match_jax(arch, hd):
    """Phase 1 (v frozen): loss and every trainable gradient, biases and
    qk-norm scales included; no dV kernel."""
    jcfg, tcfg = _cfgs(arch, hd)
    lrd = _lrd(freeze_mode="sequential")
    opt = dict(name="sgdm", lr=1e-2, warmup_steps=2, total_steps=8)
    jrun = RunConfig(model=jcfg, shape=ShapeConfig("t", SEQ, BATCH, "train"),
                     lrd=LRDConfig(**lrd), dist=DistConfig(fsdp=False, remat="none"),
                     optim=OptimConfig(**opt))
    trun = TRun(model=tcfg, shape=TShape("t", SEQ, BATCH, "train"),
                lrd=TLRD(**lrd, use_pallas_kernel=True), dist=TDist(fsdp=False, remat="none"),
                optim=TOptim(**opt))
    batch = next(iter(LMBatchIterator(256, SEQ, BATCH, seed=3)))
    jstate, jparked = jsteps.make_train_state(jrun.optim, _params(arch, hd)[0], 1)
    jnew, jm = jax.jit(functools.partial(jsteps.build_train_step(jrun, make_host_mesh(1, 1)),
                                         phase=1))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, _ = bridge.train_state_from_jax(jstate, jparked)
    with ops.capture_fallbacks() as fbs:
        loss, grads = steps._value_and_grad(state.trainable, state.frozen,
                                            bridge.batch_from_numpy(batch), trun, 1)
    _close(loss.item(), float(jm["loss"]), GRAD_TOL)
    _close_trees(grads, jnew.opt.mu, GRAD_TOL)  # sgdm's first momentum is the gradient
    flat = _flat(grads)
    assert not any(k.endswith("/v") for k in flat)
    if arch == "qwen2-72b":
        assert flat["/stack/attn/wk/bias"].abs().max() > 0
    if arch == "qwen3-32b":
        assert flat["/stack/attn/k_norm/scale"].abs().max() > 0
    seen = [(f.op, f.reason) for f in fbs]
    assert ("lowrank_du", "platform") in seen and ("lowrank_dv", "platform") not in seen
