"""DeepSeek-V3 (MLA and MTP) through the port's model, steps, scheduler,
engine and CLIs against the JAX package, on the smoke deepseek-v3-671b
(float32; 3 layers: 1 dense and 2 MoE of 8 experts top-2 with a shared
expert, d 64, 4 heads, MLA latents 32 / 16, head dims 16 / 8 / 16, an MTP
layer), LRD on at Eq.-5 ranks, params made once in JAX and carried over by
``repro_torch.bridge``, inputs from numpy seeds:

* the prefill step's last-position logits and ``{"ckv", "kr"}`` cache and
  the serve step's logits against JAX's (1e-5), and decode against a
  full forward over the same tokens;
* ``lm_apply(return_hidden=True)``, ``mtp_logits`` and ``mtp_loss_mask``;
* the train step's loss (with the MTP term) and gradients at phases -1, 0
  and 1 within 1e-4 of JAX's, the frozen factor's kernel never run, the
  MTP layer's factors included;
* the scheduler's greedy tokens on the slot layout, plain and speculative
  (k = 2), identical to JAX's engine, and ``init_slot_cache`` /
  ``insert_prefill_rows`` against JAX's;
* the bridge both ways on the MLA and MTP tree;
* the full config's Eq.-5 and Algorithm-1 plans on the meta device against
  JAX's under ``jax.eval_shape``;
* DeepSeek-V3 cut to one layer (``num_layers = first_k_dense``: an empty
  ``moe_stack``, the MTP layer the one MoE layer): init, prefill,
  ``init_cache``, freezing, the bridge and a train step against JAX's;
* both CLIs at ``--smoke --device cpu``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro.core import freezing as jfreezing
from repro.data import LMBatchIterator
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import paged_cache as jpc
from repro.serving.engine import pad_cache as jpad_cache
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core import freezing
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving import paged_cache as tpc
from repro_torch.serving.engine import pad_cache

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
TOL = 1e-5  # float32 logits: the same products summed in another order
GRAD_TOL = 1e-4  # loss and gradients of a train step
SEQ, BATCH = 16, 2
# K1 launches of a forward: q_up, kv_up and wo in each of the 3 layers and
# the MTP layer, the dense layer's down, the shared expert's down in the 2
# MoE layers and the MTP layer, mtp/proj; K5: the dense layer's and the 3
# shared experts' gate/up.  The experts are torch.bmm; q_down / kv_down stay
# dense (the policy), as do the embedding and unembedding.
K1_FWD, K5_FWD = 3 * 3 + 1 + 2, 1 + 2
K1_MTP, K5_MTP = 3 + 1 + 1, 1


def _lrd(**kw):
    return dict(enabled=True, min_dim=16, rank_quantize=False, **kw)


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


def _cfgs(**kw):
    return (dataclasses.replace(get_smoke_config(ARCH), **kw),
            dataclasses.replace(t_get_smoke_config(ARCH), **kw))


@functools.lru_cache(maxsize=None)
def _params(layers: int = 3):
    """JAX's init (numpy leaves, every norm scale a seeded draw so the MTP
    and MLA norms are not all ones) and the port's copy; the port's own
    init lays out the same tree and plan."""
    jcfg, tcfg = _cfgs(num_layers=layers)
    run = RunConfig(model=jcfg, shape=ShapeConfig("s", SEQ, BATCH, "train"),
                    lrd=LRDConfig(**_lrd()), dist=DistConfig(fsdp=False, remat="none"))
    jparams, plan = jsteps.init_params(run, jax.random.PRNGKey(5))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(6)

    def seed_norms(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                seed_norms(v)
            elif k == "scale":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)

    seed_norms(jparams)
    own, own_plan = steps.init_params(
        TRun(model=tcfg, shape=TShape("s", SEQ, BATCH, "train"), lrd=TLRD(**_lrd())),
        device="cpu")
    tparams = bridge.params_from_jax(jparams)
    assert {k: tuple(v.shape) for k, v in _flat(own).items()} == \
        {k: tuple(v.shape) for k, v in _flat(tparams).items()}
    assert {k: v.rank for k, v in own_plan.layers.items()} == \
        {k: v.rank for k, v in plan.layers.items()}
    return jparams, tparams


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s), dtype=np.int32)


def _serve_runs(max_len=24, b=3, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jrun = RunConfig(model=jcfg, shape=ShapeConfig("s", max_len, b, "decode"),
                     lrd=LRDConfig(**_lrd()), dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=tcfg, shape=TShape("s", max_len, b, "decode"),
                lrd=TLRD(**_lrd(), use_pallas_kernel=True), dist=TDist(fsdp=False, remat="none"))
    return jrun, trun


# --------------------------------------------------------------------------
# the model and the serving steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_prefill_and_serve_steps_match_jax(impl):
    """Prefill logits and the latent cache, then 3 serve steps fed JAX's
    greedy tokens at one position for every row (the fixed-batch path),
    logits within 1e-5 and the updated cache; ``flash`` runs K8's plain
    version at q/k head dim 24 and v head dim 16 against JAX's Pallas
    kernel in interpret mode."""
    jparams, tparams = _params()
    jrun, trun = _serve_runs(attention_impl=impl)
    mesh = make_host_mesh(1, 1)
    toks = _tokens(4, 3, 10)
    jlast, jcache = jsteps.build_prefill_step(jrun, mesh)(jparams, {"tokens": jnp.asarray(toks)})
    with ops.capture_fallbacks() as fbs:
        tlast, tcache = steps.build_prefill_step(trun)(tparams, {"tokens": torch.from_numpy(toks)})
    _close(tlast.numpy(), jlast)
    _close_trees(tcache, jcache)
    assert set(tcache) == {"dense_stack", "moe_stack"}
    assert set(tcache["moe_stack"]) == {"ckv", "kr"}
    seen = [(f.op, f.reason) for f in fbs]
    assert seen.count(("lowrank_fwd", "platform")) == K1_FWD
    assert seen.count(("lowrank_ffn", "platform")) == K5_FWD
    assert seen.count(("flash_attention", "platform")) == (3 if impl == "flash" else 0)
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


def test_decode_matches_full_forward():
    """The absorbed decode over tokens 8..11 of each row, one at a time at
    per-row positions after a prefill of 8, gives the full forward's logits
    at those positions (the port alone)."""
    _, tparams = _params()
    _, tcfg = _cfgs()
    toks = torch.from_numpy(_tokens(7, 3, 12))
    with torch.inference_mode():
        want, _, _ = tlm.lm_apply(tparams, toks, tcfg, mode="full")
        _, cache, _ = tlm.lm_apply(tparams, toks[:, :8], tcfg, mode="full")
        cache = pad_cache(cache, 12)
        for t in range(8, 12):
            got, cache, _ = tlm.lm_apply(tparams, toks[:, t:t + 1], tcfg, mode="decode",
                                         cache=cache, pos=torch.full((3,), t))
            _close(got[:, 0].numpy(), want[:, t].numpy())


def test_init_cache_matches_jax_and_ignores_the_kv_dtype():
    for kv_dtype in ("bfloat16", "int8"):
        jcfg, tcfg = _cfgs(kv_cache_dtype=kv_dtype)
        want = jlm.init_cache(jcfg, 3, 20)
        got = tlm.init_cache(tcfg, 3, 20, "cpu")
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _flat(got).items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(want).items()}


def test_hidden_mtp_logits_and_mask_match_jax():
    """``lm_apply(mode="train", return_hidden=True)``'s final-normed hidden
    state, ``mtp_logits`` of it (the MTP layer a MoE layer) and
    ``mtp_loss_mask``."""
    jparams, tparams = _params()
    jcfg, tcfg = _cfgs()
    toks = _tokens(8, BATCH, SEQ)
    jlog, _, jaux, jh = jlm.lm_apply(jparams, jnp.asarray(toks), jcfg, mode="train",
                                     return_hidden=True)
    jmtp = jlm.mtp_logits(jparams, jh, jnp.asarray(toks), jcfg)
    with torch.inference_mode(), ops.capture_fallbacks() as fbs:
        tlog, cache, taux, th = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg, mode="train",
                                             return_hidden=True, policy=True)
        tmtp = tlm.mtp_logits(tparams, th, torch.from_numpy(toks), tcfg, policy=True)
    assert cache is None
    _close(tlog.numpy(), jlog)
    _close(taux.item(), float(jaux))
    _close(th.numpy(), jh)
    _close(tmtp.numpy(), jmtp)
    seen = [(f.op, f.reason) for f in fbs]
    assert seen.count(("lowrank_fwd", "platform")) == K1_FWD + K1_MTP
    assert seen.count(("lowrank_ffn", "platform")) == K5_FWD + K5_MTP
    np.testing.assert_array_equal(tlm.mtp_loss_mask(torch.from_numpy(toks)).numpy(),
                                  np.asarray(jlm.mtp_loss_mask(jnp.asarray(toks))))


# --------------------------------------------------------------------------
# the scheduler on the slot layout
# --------------------------------------------------------------------------

def _trace(vocab):
    rng = np.random.default_rng(11)
    return [{"prompt": rng.integers(0, vocab, int(rng.integers(4, 16)), dtype=np.int32),
             "max_new": int(rng.integers(6, 15))} for _ in range(7)]


@pytest.mark.parametrize("spec_k", [0, 2])
def test_scheduler_tokens_on_the_slot_layout_match_jax_engine(spec_k):
    """7 requests through 3 slots (recycled), plain and speculative (the
    derived draft): the same greedy tokens as JAX's engine; the layout is
    ``slots``, no page table, and the prefix cache stays off when asked
    for, as in the reference."""
    jrun, trun = _serve_runs(max_len=40)
    jparams, tparams = _params()
    trace = _trace(256)
    kw = dict(num_slots=3, max_len=40, prefill_len=16, speculative_k=spec_k)
    jeng = JServeEngine(jrun, jparams, config=JServeConfig(**kw))
    want = jeng.serve(trace)
    engine = ServeEngine(trun, tparams, config=ServeConfig(**kw, prefix_cache=True),
                         device="cpu")
    got = engine.serve(trace)
    assert [r.tokens.tolist() for r in got] == [r.tokens.tolist() for r in want]
    sched = engine.scheduler
    assert sched.layout == jeng.scheduler.layout == "slots"
    assert sched.pages is None and sched.prefix is None
    assert set(sched.cache) == {"dense_stack", "moe_stack"}
    assert tuple(sched.cache["moe_stack"]["ckv"].shape) == (2, 3, 40 + spec_k, 16)
    assert sched.cache_bytes() == jeng.scheduler.cache_bytes()
    fwd = sched.forward_stats
    assert fwd["nonfinite"] == 0 and fwd["extend"] == 0
    assert (fwd["decode"] == 0) == bool(spec_k) and (fwd["verify"] > 0) == bool(spec_k)


def test_fixed_batch_tokens_match_jax_engine():
    jrun, trun = _serve_runs()
    jparams, tparams = _params()
    prompts = _tokens(14, 3, 10)
    want = JServeEngine(jrun, jparams).generate(prompts, max_new=9)
    got = ServeEngine(trun, tparams, device="cpu").generate(prompts, max_new=9)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_slot_cache_insert_matches_jax():
    """``init_slot_cache`` and ``insert_prefill_rows`` of a batch-1 prefill
    into slot 1 of 3 (positions [0, 10), in place), then into slot 2."""
    jparams, tparams = _params()
    jrun, trun = _serve_runs()
    mesh = make_host_mesh(1, 1)
    jcache = jpc.init_slot_cache(jrun.model, 3, 20)
    tcache = tpc.init_slot_cache(trun.model, 3, 20, "cpu")
    _close_trees(tcache, jcache)
    for slot, seed in ((1, 20), (2, 21)):
        toks = _tokens(seed, 1, 10)
        _, jp = jsteps.build_prefill_step(jrun, mesh)(jparams, {"tokens": jnp.asarray(toks)})
        _, tp = steps.build_prefill_step(trun)(tparams, {"tokens": torch.from_numpy(toks)})
        jcache = jpc.insert_prefill_rows(jcache, jp, slot)
        assert tpc.insert_prefill_rows(tcache, tp, slot) is tcache
        _close_trees(tcache, jcache)
    assert not tcache["moe_stack"]["ckv"][:, 0].any()


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _train_runs(layers: int = 3):
    lrd = _lrd(freeze_mode="sequential")
    opt = dict(name="sgdm", lr=1e-2, warmup_steps=2, total_steps=8)
    jcfg, tcfg = _cfgs(num_layers=layers)
    jrun = RunConfig(model=jcfg, shape=ShapeConfig("t", SEQ, BATCH, "train"),
                     lrd=LRDConfig(**lrd), dist=DistConfig(fsdp=False, remat="none"),
                     optim=OptimConfig(**opt))
    trun = TRun(model=tcfg, shape=TShape("t", SEQ, BATCH, "train"),
                lrd=TLRD(**lrd, use_pallas_kernel=True), dist=TDist(fsdp=False, remat="none"),
                optim=TOptim(**opt))
    return jrun, trun


def _batch(seed=0):
    return next(iter(LMBatchIterator(256, SEQ, BATCH, seed=seed)))


def _train_step_matches_jax(phase, layers):
    jrun, trun = _train_runs(layers)
    batch = _batch()
    jstate, jparked = jsteps.make_train_state(jrun.optim, _params(layers)[0], phase)
    jnew, jm = jax.jit(functools.partial(jsteps.build_train_step(jrun, make_host_mesh(1, 1)),
                                         phase=phase))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    # sgdm from zero momentum: the first step's momentum IS the gradient
    state, _ = bridge.train_state_from_jax(jstate, jparked)
    with ops.capture_fallbacks() as fbs:
        loss, grads = steps._value_and_grad(state.trainable, state.frozen,
                                            bridge.batch_from_numpy(batch), trun, phase)
    _close(loss.item(), float(jm["loss"]), GRAD_TOL)
    _close_trees(grads, jnew.opt.mu, GRAD_TOL)
    new, m = steps.build_train_step(trun, device="cpu")(state, batch, phase=phase)
    _close(m["loss"].item(), float(jm["loss"]), GRAD_TOL)
    _close(m["grad_norm"].item(), float(jm["grad_norm"]), GRAD_TOL)
    _close_trees(new.trainable, jnew.trainable, GRAD_TOL)
    return _flat(grads), [(f.op, f.reason) for f in fbs]


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_train_step_loss_and_grads_match_jax(phase):
    """Loss (cross-entropy + 0.3 x the MTP head's masked cross-entropy +
    0.01 x the MoE aux) and gradients of every trainable leaf, the MTP
    subtree included; the frozen factor's gradient kernel is never run,
    for the MTP layer's and mtp/proj's factors too."""
    flat, seen = _train_step_matches_jax(phase, 3)
    frozen = {0: "/u", 1: "/v"}.get(phase)
    assert not frozen or not any(k.endswith(frozen) for k in flat)
    mtp = [k for k in flat if k.startswith("/mtp/")]
    assert "/mtp/norm_h/scale" in mtp and all(flat[k].abs().max() > 0 for k in mtp)
    if phase != 0:
        assert "/mtp/proj/u" in flat and "/mtp/layer/attn/kv_up/u" in flat
    # the backward recomputes each K5's two branches through K1
    k5 = K5_FWD + K5_MTP
    pairs = K1_FWD + K1_MTP + 2 * k5
    assert seen.count(("lowrank_fwd", "platform")) == pairs
    assert seen.count(("lowrank_ffn", "platform")) == k5
    assert seen.count(("lowrank_dx", "platform")) == pairs
    assert seen.count(("lowrank_du", "platform")) == (0 if phase == 0 else pairs)
    assert seen.count(("lowrank_dv", "platform")) == (0 if phase == 1 else pairs)


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_freeze_partition_matches_jax(phase):
    """The factors of both stacks and the MTP subtree freeze by group; the
    embedding, norms, routers and unembedding never do."""
    jparams, tparams = _params()
    jtr, jfr = jfreezing.partition(jparams, phase)
    ttr, tfr = freezing.partition(tparams, phase)
    assert set(_flat(ttr)) == set(_flat(jtr)) and set(_flat(tfr)) == set(_flat(jfr))
    frozen = set(_flat(tfr))
    assert (phase == -1) == (not frozen)
    if phase != -1:
        assert any(k.startswith("/mtp/") for k in frozen)
        assert not any("norm" in k or "embed" in k or "router" in k for k in frozen)


def test_bridge_round_trips_the_mla_and_mtp_tree():
    """Params, a prefill cache and a train state through the bridge and
    back, bit for bit."""
    jparams, tparams = _params()
    back = bridge.params_to_numpy(tparams)
    assert _flat(back).keys() == _flat(jparams).keys()
    assert {"q_down", "q_norm", "q_up", "kv_down", "kv_norm", "kv_up", "wo"} == \
        set(back["moe_stack"]["attn"])
    assert set(back["mtp"]) == {"proj", "layer", "norm_h", "norm_e"}
    for k, v in _flat(jparams).items():
        np.testing.assert_array_equal(_flat(back)[k], v)
    jrun, _ = _serve_runs()
    _, jcache = jsteps.build_prefill_step(jrun, make_host_mesh(1, 1))(
        jparams, {"tokens": jnp.asarray(_tokens(3, 2, 6))})
    cache = bridge.cache_to_numpy(bridge.cache_from_jax(jcache))
    for k, v in _flat(jcache).items():
        np.testing.assert_array_equal(_flat(cache)[k], np.asarray(v))
    jstate, jparked = jsteps.make_train_state(_train_runs()[0].optim, jparams, 1)
    state, parked = bridge.train_state_from_jax(jstate, jparked)
    nstate, _ = bridge.train_state_to_numpy(state, parked)
    for k, v in _flat(jstate.trainable).items():
        np.testing.assert_array_equal(_flat(nstate.trainable)[k], np.asarray(v))


# --------------------------------------------------------------------------
# DeepSeek-V3 cut to its dense layer: an empty MoE stack
# --------------------------------------------------------------------------

def test_one_layer_model_has_an_empty_moe_stack_as_jax():
    """``num_layers = first_k_dense = 1``: the MoE stack holds no layer
    (leaves with a leading 0) and the MTP layer is the model's one MoE
    layer; prefill, ``init_cache``, the freeze partition and the bridge
    take the empty stack as JAX does."""
    jparams, tparams = _params(1)
    assert tuple(tparams["moe_stack"]["norm1"]["scale"].shape) == (0, 64)
    assert "moe" in tparams["mtp"]["layer"]
    jrun, trun = _serve_runs(num_layers=1)
    toks = _tokens(9, 2, 8)
    jlast, jcache = jsteps.build_prefill_step(jrun, make_host_mesh(1, 1))(
        jparams, {"tokens": jnp.asarray(toks)})
    tlast, tcache = steps.build_prefill_step(trun)(tparams, {"tokens": torch.from_numpy(toks)})
    _close(tlast.numpy(), jlast)
    assert {k: tuple(v.shape) for k, v in _flat(tcache).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jcache).items()}
    got = tlm.init_cache(trun.model, 2, 12, "cpu")
    assert tuple(got["moe_stack"]["ckv"].shape) == (0, 2, 12, 16)
    row = {name: {k: v[:, :1] for k, v in st.items()} for name, st in tcache.items()}
    slot = tpc.insert_prefill_rows(tpc.init_slot_cache(trun.model, 3, 12, "cpu"), row, 1)
    assert torch.equal(slot["dense_stack"]["ckv"][:, 1, :8], row["dense_stack"]["ckv"][:, 0])
    assert tuple(slot["moe_stack"]["kr"].shape) == (0, 3, 12, 8)
    for phase in (0, 1):
        jtr, jfr = jfreezing.partition(jparams, phase)
        ttr, tfr = freezing.partition(tparams, phase)
        assert set(_flat(ttr)) == set(_flat(jtr)) and set(_flat(tfr)) == set(_flat(jfr))
    back = bridge.params_to_numpy(tparams)
    assert back["moe_stack"]["moe"]["experts"]["gate"]["u"].shape == \
        jparams["moe_stack"]["moe"]["experts"]["gate"]["u"].shape


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_one_layer_train_step_matches_jax(phase):
    """The train step of the one-layer cut (chip_smoke.py's train
    geometry) against JAX's: loss and every gradient, the MTP layer's
    experts and routers included."""
    flat, _ = _train_step_matches_jax(phase, 1)
    assert not any(k.startswith("/moe_stack/") and flat[k].numel() for k in flat)
    assert "/mtp/layer/moe/router/kernel" in flat


# --------------------------------------------------------------------------
# the plan at full size
# --------------------------------------------------------------------------

def _plan_ranks(plan):
    return {k: (v.rank, tuple(v.shape), v.use_decomposed) for k, v in plan.layers.items()}


@pytest.mark.parametrize("quantize", [False, True])
def test_full_config_plan_matches_jax(quantize):
    """deepseek-v3-671b at full size, LRD at Eq.-5 or Algorithm-1 ranks: the
    port's init on the meta device (no data) against JAX's under
    ``eval_shape``: the same paths, shapes, ranks and guard decisions and
    the same leaf shapes.  At Eq. 5: q_up 722, kv_up 252, wo 2493, the
    dense FFN 2580, experts and shared expert 796, mtp/proj 2389 (q_down
    and kv_down stay dense: the policy keeps MLA's latent projections)."""
    jcfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    lrd = dict(_lrd(), rank_quantize=quantize)
    jrun = RunConfig(model=jcfg, shape=ShapeConfig("s", 256, 8, "train"),
                     lrd=LRDConfig(**lrd), dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=tcfg, shape=TShape("s", 256, 8, "train"), lrd=TLRD(**lrd))
    holder = {}

    def init():
        params, plan = jsteps.init_params(jrun, jax.random.PRNGKey(0))
        holder["plan"] = plan
        return params

    jshapes = jax.eval_shape(init)
    dec = steps.make_decomposer(trun, device="meta")
    tparams = tlm.lm_init(tcfg, dec)
    assert _plan_ranks(dec.plan) == _plan_ranks(holder["plan"])
    assert {k: tuple(v.shape) for k, v in _flat(tparams).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jshapes).items()}
    assert tuple(tparams["moe_stack"]["norm1"]["scale"].shape) == (58, 7168)
    if not quantize:
        ranks = {k: v.rank for k, v in dec.plan.layers.items()}
        assert ranks["layers/dense/attn/q_up"] == 722 and ranks["layers/moe/attn/kv_up"] == 252
        assert ranks["layers/moe/attn/wo"] == 2493 and ranks["layers/dense/ffn/gate"] == 2580
        assert ranks["mtp/proj"] == 2389
        assert {r for k, r in ranks.items() if "/moe/experts/" in k or "/shared" in k} == {796}
        assert not any(k.endswith(("q_down", "kv_down")) for k in ranks)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cli", ["serve", "train"])
def test_cli_runs_mla_and_mtp(cli, capsys, tmp_path):
    """Both CLIs run the smoke DeepSeek-V3 on the CPU: the serve CLI through
    the scheduler on the slot layout (plain, then speculative), the train
    CLI through a phase swap, a checkpoint and a resume."""
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--lrd"]
    if cli == "serve":
        args = common + ["--slots", "3", "--requests", "6", "--rate", "1000",
                         "--prompt-len", "12", "--max-new", "5"]
        engine, outs = tserve.main(args)
        _, spec = tserve.main(args + ["--spec-k", "2"])
        assert [o.tokens.tolist() for o in spec] == [o.tokens.tolist() for o in outs]
        assert engine.scheduler.layout == "slots" and len(outs) == 6
        assert "layout slots" in capsys.readouterr().out
        return
    train = common + ["--lrd-min-dim", "16", "--no-rank-opt", "--use-pallas", "--freeze",
                      "sequential", "--steps-per-epoch", "1", "--global-batch", "2",
                      "--seq-len", "16", "--log-every", "1", "--save-every", "2",
                      "--ckpt-dir", str(tmp_path)]
    state, losses = ttrain.main(train + ["--steps", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert {"dense_stack", "moe_stack", "mtp"} <= set(state.params)
    state2, losses2 = ttrain.main(train + ["--steps", "3"])
    assert len(losses2) == 1 and np.isfinite(losses2[0])
    assert "[resume] from step 2" in capsys.readouterr().out
