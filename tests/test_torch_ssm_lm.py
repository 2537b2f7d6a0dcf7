"""The SSM (xLSTM) and hybrid (Zamba2) families through the port's model,
serving and training entry points against the JAX package, on the smoke
configs (float32; xlstm: 2 mLSTM layers, d 64, 2 heads; zamba2: 2 groups of
2 Mamba2 layers and a tail of 1, the shared block at 2d = 128, chunk 8),
LRD on (Eq.-5 ranks), with params made once in JAX and carried over by
``repro_torch.bridge``:

* ``lm_apply`` logits and caches in full (prefill), decode and train mode,
  within 1e-5 of each one's largest entry (float32 sums in another order,
  carried through up to 7 blocks: the largest seen is 9.8e-6 of max |logit|,
  zamba2 prefill);
* the train step's loss and gradients at phases -1, 0 and 1 within 1e-4,
  no gradient, moment or K3 (K4) launch for the frozen u (v), and (zamba2)
  a 6-step trajectory across two phase swaps;
* greedy tokens of the fixed-batch ``ServeEngine.generate`` equal to the
  JAX engine's;
* the hybrid's remat ``full`` and ``sqrt`` gradients equal to ``none``'s
  bit for bit;
* the serve and train CLIs at ``--smoke --device cpu``.
The JAX train steps run their plain jnp path; the port's run its kernels'
plain versions (the CPU), whose dispatch records which ran.
"""

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
from repro.models import lm as jlm
from repro.serving import ServeEngine as JServeEngine
from repro.serving.engine import pad_cache as jpad_cache
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core.decompose import iter_factor_groups
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving.engine import pad_cache

torch.set_num_threads(1)

TOL = 1e-5  # float32: the same products summed in another order
GRAD_TOL = 1e-4  # loss and gradients of a train step
ARCHS = ["xlstm-350m", "zamba2-1.2b"]
SEQ, BATCH = 16, 2
# factorised projections a forward runs: xlstm 5 a layer (wq, wk, wv,
# wo_gate, wo; the gates are dense under min_dim); zamba2 in_proj and
# out_proj a Mamba2 layer, and 7 a shared-block application (wq, wk, wv,
# wo, ffn wi and down, down_proj) after each of 2 groups
LOWRANK_CALLS = {"xlstm-350m": 10, "zamba2-1.2b": 5 * 2 + 2 * 7}


def _lrd(**kw):
    return dict(enabled=True, min_dim=16, rank_quantize=False, **kw)


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg = get_smoke_config(arch)
    run = RunConfig(model=jcfg, shape=ShapeConfig("s", SEQ, BATCH, "train"),
                    lrd=LRDConfig(**_lrd()), dist=DistConfig(fsdp=False, remat="none"))
    params, plan = jsteps.init_params(run, jax.random.PRNGKey(7))
    params = jax.tree_util.tree_map(np.asarray, params)
    # the port's own init lays out the same tree, factor groups and ranks
    own, own_plan = steps.init_params(
        TRun(model=t_get_smoke_config(arch), shape=TShape("s", SEQ, BATCH, "train"),
             lrd=TLRD(**_lrd())), device="cpu")
    tparams = bridge.params_from_jax(params)
    assert sorted(p for p, _ in iter_factor_groups(own)) == \
        sorted(p for p, _ in iter_factor_groups(tparams))
    assert _shapes(own) == _shapes(tparams)
    assert {k: v.rank for k, v in own_plan.layers.items()} == \
        {k: v.rank for k, v in plan.layers.items()}
    return params, tparams


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
    g = {k: v.detach().numpy() for k, v in _flat(got).items()}
    w = {k: np.asarray(v) for k, v in _flat(want).items()}
    assert g.keys() == w.keys() and g
    for k in w:
        _close(g[k], w[k], tol)


def _close_max(got, want, tol=TOL):
    """max |got - want| within ``tol`` of max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _close_max_trees(got, want, tol=TOL):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys() and g
    for k in w:
        _close_max(g[k].numpy(), w[k], tol)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


# --------------------------------------------------------------------------
# lm_apply
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_and_train_logits_and_cache_match_jax(arch):
    jparams, tparams = _params(arch)
    jcfg, tcfg = get_smoke_config(arch), t_get_smoke_config(arch)
    toks = _tokens(3, 2, 12, jcfg.vocab_size)
    jlog, jcache, _ = jax.jit(lambda p, t: jlm.lm_apply(p, t, jcfg, mode="full"))(
        jparams, jnp.asarray(toks))
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        tlog, tcache, taux = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg, mode="full",
                                          policy=True)
    _close_max(tlog.numpy(), jlog)
    assert float(taux) == 0.0
    _close_max_trees(tcache, jcache)
    # xbc_tail runs in_proj once more a Mamba2 layer in a full pass
    extra = 5 if jcfg.family == "hybrid" else 0
    assert sum(f.op == "lowrank_fwd" for f in fbs) == LOWRANK_CALLS[arch] + extra
    jtrain, _, _ = jlm.lm_apply(jparams, jnp.asarray(toks), jcfg, mode="train")
    with torch.inference_mode():
        ttrain_log, none, _ = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg,
                                           mode="train")
    assert none is None
    _close_max(ttrain_log.numpy(), jtrain)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """Prefill of 10 tokens, the cache padded to the window (state leaves
    untouched), then 3 greedy decode steps: logits and caches."""
    jparams, tparams = _params(arch)
    jcfg, tcfg = get_smoke_config(arch), t_get_smoke_config(arch)
    toks = _tokens(4, 2, 10, jcfg.vocab_size)
    jlog, jcache, _ = jlm.lm_apply(jparams, jnp.asarray(toks), jcfg, mode="full")
    jcache = jpad_cache(jcache, 13)
    with torch.inference_mode():
        tlog, tcache, _ = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg, mode="full")
        tcache = pad_cache(tcache, 13)
    assert _shapes(tcache).keys() == _flat(jcache).keys()
    assert {k: v[0] for k, v in _shapes(tcache).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jcache).items()}
    decode = jax.jit(lambda p, t, c, pos: jlm.lm_apply(p, t, jcfg, mode="decode", cache=c,
                                                       pos=pos))
    nxt = np.argmax(np.asarray(jlog)[:, -1:], axis=-1).astype(np.int32)
    for i in range(3):
        pos = np.int32(10 + i)
        jlog, jcache, _ = decode(jparams, jnp.asarray(nxt), jcache, jnp.asarray(pos))
        with torch.inference_mode():
            tlog, tcache, _ = tlm.lm_apply(tparams, torch.from_numpy(nxt), tcfg, mode="decode",
                                           cache=tcache, pos=torch.tensor(pos), policy=True)
        _close_max(tlog.numpy(), jlog)
        nxt = np.argmax(np.asarray(jlog)[:, -1:], axis=-1).astype(np.int32)
    _close_max_trees(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax_layout(arch):
    jcfg, tcfg = get_smoke_config(arch), t_get_smoke_config(arch)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            _flat(jlm.init_cache(jcfg, 3, 20)).items()}
    got = _shapes(tlm.init_cache(tcfg, 3, 20, "cpu"))
    assert got == want


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _train_runs(arch, remat="none"):
    lrd = _lrd(freeze_mode="sequential")
    opt = dict(name="sgdm", lr=1e-2, warmup_steps=2, total_steps=8)
    jrun = RunConfig(model=get_smoke_config(arch), shape=ShapeConfig("t", SEQ, BATCH, "train"),
                     lrd=LRDConfig(**lrd), dist=DistConfig(fsdp=False, remat=remat),
                     optim=OptimConfig(**opt))
    trun = TRun(model=t_get_smoke_config(arch), shape=TShape("t", SEQ, BATCH, "train"),
                lrd=TLRD(**lrd, use_pallas_kernel=True), dist=TDist(fsdp=False, remat=remat),
                optim=TOptim(**opt))
    return jrun, trun


def _batches(arch, n):
    it = iter(LMBatchIterator(get_smoke_config(arch).vocab_size, SEQ, BATCH, seed=0))
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("phase", [-1, 0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_grads_match_jax(arch, phase):
    jrun, trun = _train_runs(arch)
    batch = _batches(arch, 1)[0]
    jstate, jparked = jsteps.make_train_state(jrun.optim, _params(arch)[0], phase)
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
    # the frozen factor of every projection gets no gradient and no moment
    frozen = {0: "/u", 1: "/v"}.get(phase)
    for tree in (grads, state.opt.mu):
        assert not any(k.endswith(frozen) for k in _flat(tree)) if frozen else True
    assert any(k.endswith("/u") for k in _flat(grads)) == (phase != 0)
    assert any(k.endswith("/A_log") for k in _flat(grads)) == (arch == "zamba2-1.2b")
    n = LOWRANK_CALLS[arch]
    seen = [f.op for f in fbs]
    assert seen.count("lowrank_fwd") == seen.count("lowrank_dx") == n
    assert seen.count("lowrank_du") == (0 if phase == 0 else n)
    assert seen.count("lowrank_dv") == (0 if phase == 1 else n)
    new, m = steps.build_train_step(trun, device="cpu")(state, batch, phase=phase)
    _close(m["loss"].item(), float(jm["loss"]), GRAD_TOL)
    _close(m["grad_norm"].item(), float(jm["grad_norm"]), GRAD_TOL)
    _close_trees(new.trainable, jnew.trainable, GRAD_TOL)


def test_six_step_trajectory_across_two_phase_swaps_matches_jax():
    """On the hybrid, the family with groups, a shared block and a tail
    (the SSM family's steps are held at every phase above)."""
    arch = "zamba2-1.2b"
    jrun, trun = _train_runs(arch)
    jtrain = jsteps.build_train_step(jrun, make_host_mesh(1, 1))
    ttrain_step = steps.build_train_step(trun, device="cpu")
    jfns = {}
    jstate, jparked = jsteps.make_train_state(jrun.optim, _params(arch)[0], 0)
    state, parked = bridge.train_state_from_jax(jstate, jparked)
    cur, phases, jlosses, losses = 0, [], [], []
    for step, batch in enumerate(_batches(arch, 6)):
        phase = jsteps.run_phase(jrun, step // 2)
        if phase != cur:
            jstate, jparked = jsteps.repartition_state(jrun.optim, jstate, jparked, phase)
            state, parked = steps.repartition_state(trun.optim, state, parked, phase)
            cur = phase
        if phase not in jfns:
            jfns[phase] = jax.jit(functools.partial(jtrain, phase=phase))
        jstate, jm = jfns[phase](jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = ttrain_step(state, batch, phase=phase)
        phases.append(phase)
        jlosses.append(float(jm["loss"]))
        losses.append(m["loss"].item())
    assert phases == [0, 0, 1, 1, 0, 0]
    _close(losses, jlosses, GRAD_TOL)
    assert steps.partition_bytes(state) == jsteps.partition_bytes(jstate)


@pytest.mark.parametrize("remat", ["full", "sqrt"])
def test_hybrid_remat_grads_equal_none_bitwise(remat):
    """Checkpointing each group whole (and the tail as asked) recomputes the
    same forward: every gradient equals the un-rematerialised step's bit
    for bit."""
    arch = "zamba2-1.2b"
    _, trun = _train_runs(arch)
    _, trun_r = _train_runs(arch, remat)
    tparams = _params(arch)[1]
    batch = bridge.batch_from_numpy(_batches(arch, 1)[0])
    state, _ = steps.make_train_state(trun.optim, tparams, 0)
    _, want = steps._value_and_grad(state.trainable, state.frozen, batch, trun, 0)
    _, got = steps._value_and_grad(state.trainable, state.frozen, batch, trun_r, 0)
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    assert all(torch.equal(g[k], w[k]) for k in w)


# --------------------------------------------------------------------------
# serving and the CLIs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_fixed_batch_tokens_match_jax_engine(arch):
    lrd = _lrd()
    jrun = RunConfig(model=get_smoke_config(arch), shape=ShapeConfig("s", 24, 3, "decode"),
                     lrd=LRDConfig(**lrd), dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=t_get_smoke_config(arch), shape=TShape("s", 24, 3, "decode"),
                lrd=TLRD(**lrd), dist=TDist(fsdp=False, remat="none"))
    jparams, tparams = _params(arch)
    prompts = _tokens(14, 3, 10, 256)
    want = JServeEngine(jrun, jparams).generate(prompts, max_new=8)
    # num_slots > 0 still takes the fixed-batch path for these families
    engine = ServeEngine(trun, tparams, device="cpu", config=ServeConfig(num_slots=2))
    got = engine.generate(prompts, max_new=8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert engine._scheduler is None
    with pytest.raises(ValueError, match="fixed-batch path"):
        _ = engine.scheduler
    # the int8 export serves on the same path (tests/test_torch_int8_families.py
    # holds its tokens to the JAX engine's)
    int8 = ServeEngine(trun, tparams, device="cpu",
                       config=ServeConfig(export="analytic", export_int8=True))
    assert int8.generate(prompts, max_new=8).shape == (3, 8) and int8._scheduler is None
    assert all(l.quantized for l in int8.export_report.layers.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serve_and_train_on_cpu(arch, tmp_path):
    common = ["--arch", arch, "--smoke", "--device", "cpu", "--lrd"]
    engine, out = tserve.main(common + ["--slots", "2", "--prompt-len", "8",
                                        "--max-new", "4"])
    assert out.shape == (2, 4) and engine._scheduler is None
    state, losses = ttrain.main(common + ["--lrd-min-dim", "16", "--no-rank-opt",
                                          "--use-pallas", "--freeze", "sequential",
                                          "--remat", "full", "--steps", "3",
                                          "--steps-per-epoch", "1", "--global-batch", "2",
                                          "--seq-len", "16", "--log-every", "1",
                                          "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert ("mamba_groups" in state.params) == (arch == "zamba2-1.2b")
    with pytest.raises(SystemExit):
        tserve.main(common + ["--spec-k", "2"])
