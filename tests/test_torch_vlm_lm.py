"""The VLM family through the port's steps, engine and CLIs against the JAX
package, on the smoke llama-3.2-vision-90b (float32; 2 groups of 2 self
layers and a cross block, d 64, 4 heads, 8 image tokens), LRD on at Eq.-5
ranks, params made once in JAX and carried over by ``repro_torch.bridge``,
every cross gate a seeded non-zero value, vision embeddings from a numpy
seed:

* the prefill step's last-position logits and cache and the serve step's
  logits against JAX's ``build_prefill_step`` / ``build_serve_step``
  (1e-5), JAX's serve step handed the embeddings as ``extras`` and the
  port's none;
* greedy fixed-batch tokens of ``ServeEngine.generate(...,
  extras={"vision_embeddings"})`` equal to JAX's engine given the same;
* the train step's loss and gradients at phases -1, 0 and 1 within 1e-4 of
  JAX's (whose batch carries the same embeddings), the frozen factor's
  kernel never run, and a 6-step trajectory across two phase swaps;
* the plan's ranks (smoke, and the full config's on the meta device
  against ``jax.eval_shape``: Eq.-5 2048 / 455 / 3185) and the freeze
  partition against JAX's;
* both CLIs at ``--smoke --device cpu`` (the train CLI through a
  checkpoint and a resume) and their refusals, and, pinned so the recorded
  departure stays true, that the JAX train path without vision embeddings
  leaves the gate unused.
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
from repro.serving import ServeEngine as JServeEngine
from repro.serving.engine import pad_cache_preserving_cross as jpad_cross
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
from repro_torch.serving.engine import pad_cache_preserving_cross

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"
TOL = 1e-5  # float32 logits: the same products summed in another order
GRAD_TOL = 1e-4  # loss and gradients of a train step
SEQ, BATCH = 16, 2
# factorised projections a forward runs: each of the 6 layers (4 self, 2
# cross) has wq, wk, wv, wo and down through K1 and gate/up through K5
K1_CALLS, K5_CALLS = 6 * 5, 6


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


def _seed_gates(jparams, seed):
    gate = jparams["cross_stack"]["attn"]["gate"]
    rng = np.random.default_rng(seed)
    jparams["cross_stack"]["attn"]["gate"] = (
        rng.uniform(0.3, 1.2, gate.shape) * rng.choice([-1.0, 1.0], gate.shape)
    ).astype(gate.dtype)
    return jparams


@functools.lru_cache(maxsize=None)
def _params():
    """JAX's init (numpy leaves) with every cross gate a seeded draw of
    +-U(0.3, 1.2), and the port's copy."""
    run = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", SEQ, BATCH, "train"),
                    lrd=LRDConfig(**_lrd()), dist=DistConfig(fsdp=False, remat="none"))
    jparams, _ = jsteps.init_params(run, jax.random.PRNGKey(9))
    jparams = _seed_gates(jax.tree_util.tree_map(np.asarray, jparams), 21)
    return jparams, bridge.params_from_jax(jparams)


def _vision(seed, b):
    cfg = get_smoke_config(ARCH)
    return np.random.default_rng(seed).normal(
        0, 0.1, (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)


def _serve_runs(max_len=24, b=3):
    jrun = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", max_len, b, "decode"),
                     lrd=LRDConfig(**_lrd()), dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=t_get_smoke_config(ARCH), shape=TShape("s", max_len, b, "decode"),
                lrd=TLRD(**_lrd(), use_pallas_kernel=True),
                dist=TDist(fsdp=False, remat="none"))
    return jrun, trun


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_prefill_and_serve_steps_match_jax():
    """JAX's and the port's prefill step on tokens and vision embeddings,
    the caches padded (cross kept at 8 image tokens), then 3 serve steps fed
    JAX's greedy tokens, JAX's each given ``extras={"vision_embeddings"}``;
    the port's reads its cross k/v from the cache and takes none."""
    jparams, tparams = _params()
    jrun, trun = _serve_runs()
    mesh = make_host_mesh(1, 1)
    toks = np.random.default_rng(4).integers(0, 256, (3, 10), dtype=np.int32)
    vision = _vision(5, 3)
    jbatch = {"tokens": jnp.asarray(toks), "vision_embeddings": jnp.asarray(vision)}
    jlast, jcache = jsteps.build_prefill_step(jrun, mesh)(jparams, jbatch)
    with ops.capture_fallbacks() as fbs:
        tlast, tcache = steps.build_prefill_step(trun)(
            tparams, {"tokens": torch.from_numpy(toks),
                      "vision_embeddings": torch.from_numpy(vision)})
    _close(tlast.numpy(), jlast)
    _close_trees(tcache, jcache)
    seen = [(f.op, f.reason) for f in fbs]
    assert seen.count(("lowrank_fwd", "platform")) == K1_CALLS
    assert seen.count(("lowrank_ffn", "platform")) == K5_CALLS
    jcache, tcache = jpad_cross(jcache, 13), pad_cache_preserving_cross(tcache, 13)
    jstep = jax.jit(jsteps.build_serve_step(jrun, mesh))
    tstep = steps.build_serve_step(trun)
    nxt = np.argmax(np.asarray(jlast), axis=-1).astype(np.int32)[:, None]
    for i in range(3):
        pos = np.int32(10 + i)
        jlog, jcache, jnext = jstep(jparams, jcache, jnp.asarray(nxt), jnp.asarray(pos),
                                    {"vision_embeddings": jnp.asarray(vision)})
        tlog, tcache, tnext = tstep(tparams, tcache, torch.from_numpy(nxt), torch.tensor(pos))
        _close(tlog.numpy(), jlog)
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
        nxt = np.array(jnext)
    _close_trees(tcache, jcache)


@pytest.mark.parametrize("num_slots", [0, 2])
def test_fixed_batch_tokens_match_jax_engine(num_slots):
    """Greedy tokens of ``ServeEngine.generate(extras={"vision_embeddings"})``
    against JAX's engine given the same extras; extras always take the
    fixed-batch path, as in the reference; an eos stops rows alike."""
    jparams, tparams = _params()
    jrun, trun = _serve_runs()
    prompts = np.random.default_rng(14).integers(0, 256, (3, 10), dtype=np.int32)
    vision = _vision(15, 3)
    jextras = {"vision_embeddings": jnp.asarray(vision)}
    want = JServeEngine(jrun, jparams).generate(prompts, max_new=8, extras=jextras)
    engine = ServeEngine(trun, tparams, device="cpu", config=ServeConfig(num_slots=num_slots))
    textras = {"vision_embeddings": vision}
    got = engine.generate(prompts, max_new=8, extras=textras)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert engine._scheduler is None
    eos = int(np.asarray(want)[0, 2])
    np.testing.assert_array_equal(
        engine.generate(prompts, max_new=8, extras=textras, eos_id=eos),
        np.asarray(JServeEngine(jrun, jparams).generate(prompts, max_new=8, extras=jextras,
                                                        eos_id=eos)))


def test_engine_refuses_the_int8_export_and_the_scheduler():
    """The scheduler still refuses the family; the int8 export, refused
    until K7 took ranks past 512, now serves on the fixed-batch path
    (tests/test_torch_int8_families.py holds its tokens to JAX's)."""
    _, tparams = _params()
    _, trun = _serve_runs()
    int8 = ServeEngine(trun, tparams, device="cpu",
                       config=ServeConfig(export="analytic", export_int8=True))
    prompts = np.random.default_rng(14).integers(0, 256, (3, 10), dtype=np.int32)
    out = int8.generate(prompts, max_new=4, extras={"vision_embeddings": _vision(15, 3)})
    assert out.shape == (3, 4) and int8._scheduler is None
    assert all(l.quantized for l in int8.export_report.layers.values())
    from repro_torch.serving.scheduler import Scheduler
    with pytest.raises(ValueError, match="ssm, hybrid, encdec and vlm families.*item 7"):
        Scheduler(trun, tparams, device="cpu")


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _train_runs(remat="none"):
    lrd = _lrd(freeze_mode="sequential")
    opt = dict(name="sgdm", lr=1e-2, warmup_steps=2, total_steps=8)
    jrun = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("t", SEQ, BATCH, "train"),
                     lrd=LRDConfig(**lrd), dist=DistConfig(fsdp=False, remat=remat),
                     optim=OptimConfig(**opt))
    trun = TRun(model=t_get_smoke_config(ARCH), shape=TShape("t", SEQ, BATCH, "train"),
                lrd=TLRD(**lrd, use_pallas_kernel=True), dist=TDist(fsdp=False, remat=remat),
                optim=TOptim(**opt))
    return jrun, trun


def _batch(seed=0):
    batch = next(iter(LMBatchIterator(get_smoke_config(ARCH).vocab_size, SEQ, BATCH,
                                      seed=seed)))
    return dict(batch, vision_embeddings=_vision(seed + 100, BATCH))


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_train_step_loss_and_grads_match_jax(phase):
    jrun, trun = _train_runs()
    batch = _batch()
    jstate, jparked = jsteps.make_train_state(jrun.optim, _params()[0], phase)
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
    flat = _flat(grads)
    frozen = {0: "/u", 1: "/v"}.get(phase)
    assert not frozen or not any(k.endswith(frozen) for k in flat)
    # the gates reach the loss: they and the cross k/v factors learn
    gate = flat["/cross_stack/attn/gate"]
    assert (gate != 0).all()
    wk = [k for k in flat if k.startswith("/cross_stack/attn/wk/")]
    assert wk and all(flat[k].abs().max() > 0 for k in wk)
    seen = [(f.op, f.reason) for f in fbs]
    # the backward recomputes each FFN's two branches through K1
    n1, n5 = K1_CALLS + 2 * K5_CALLS, K5_CALLS
    assert seen.count(("lowrank_fwd", "platform")) == n1
    assert seen.count(("lowrank_ffn", "platform")) == n5
    pairs = K1_CALLS + 2 * K5_CALLS  # factor pairs whose gradient runs K2-K4
    # no dx for the cross wk / wv: their input, the vision embeddings, takes
    # no gradient
    assert seen.count(("lowrank_dx", "platform")) == pairs - 2 * 2
    assert seen.count(("lowrank_du", "platform")) == (0 if phase == 0 else pairs)
    assert seen.count(("lowrank_dv", "platform")) == (0 if phase == 1 else pairs)
    new, m = steps.build_train_step(trun, device="cpu")(state, batch, phase=phase)
    _close(m["loss"].item(), float(jm["loss"]), GRAD_TOL)
    _close(m["grad_norm"].item(), float(jm["grad_norm"]), GRAD_TOL)
    _close_trees(new.trainable, jnew.trainable, GRAD_TOL)


@pytest.mark.parametrize("remat", ["full", "sqrt"])
def test_train_step_remat_matches_jax(remat):
    """The train step under remat against JAX's under the same policy: the
    same loss and gradients (the checkpointed groups recompute the same
    forward)."""
    jrun, trun = _train_runs(remat)
    batch = _batch(3)
    jstate, jparked = jsteps.make_train_state(jrun.optim, _params()[0], 1)
    jnew, jm = jax.jit(functools.partial(jsteps.build_train_step(jrun, make_host_mesh(1, 1)),
                                         phase=1))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, _ = bridge.train_state_from_jax(jstate, jparked)
    loss, grads = steps._value_and_grad(state.trainable, state.frozen,
                                        bridge.batch_from_numpy(batch), trun, 1)
    _close(loss.item(), float(jm["loss"]), GRAD_TOL)
    _close_trees(grads, jnew.opt.mu, GRAD_TOL)


def test_six_step_trajectory_across_two_phase_swaps_matches_jax():
    jrun, trun = _train_runs()
    jtrain = jsteps.build_train_step(jrun, make_host_mesh(1, 1))
    tstep = steps.build_train_step(trun, device="cpu")
    jfns = {}
    jstate, jparked = jsteps.make_train_state(jrun.optim, _params()[0], 0)
    state, parked = bridge.train_state_from_jax(jstate, jparked)
    cur, jlosses, losses = 0, [], []
    for step in range(6):
        batch = _batch(step)
        phase = jsteps.run_phase(jrun, step // 2)
        if phase != cur:
            jstate, jparked = jsteps.repartition_state(jrun.optim, jstate, jparked, phase)
            state, parked = steps.repartition_state(trun.optim, state, parked, phase)
            cur = phase
        if phase not in jfns:
            jfns[phase] = jax.jit(functools.partial(jtrain, phase=phase))
        jstate, jm = jfns[phase](jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = tstep(state, batch, phase=phase)
        jlosses.append(float(jm["loss"]))
        losses.append(m["loss"].item())
    _close(losses, jlosses, GRAD_TOL)
    assert steps.partition_bytes(state) == jsteps.partition_bytes(jstate)


def test_microbatches_split_the_vision_embeddings():
    """Two microbatches split the embeddings with the tokens: the whole
    batch's loss and gradient norm (the mean of the halves)."""
    _, trun = _train_runs()
    trun2 = dataclasses.replace(trun, dist=dataclasses.replace(trun.dist, microbatches=2))
    batch = _batch(2)
    state, _ = steps.make_train_state(trun.optim, _params()[1], -1)
    _, m1 = steps.build_train_step(trun, device="cpu")(state, batch, phase=-1)
    state, _ = steps.make_train_state(trun.optim, _params()[1], -1)
    _, m2 = steps.build_train_step(trun2, device="cpu")(state, batch, phase=-1)
    _close(m2["loss"].item(), m1["loss"].item(), GRAD_TOL)
    _close(m2["grad_norm"].item(), m1["grad_norm"].item(), GRAD_TOL)


def test_jax_train_path_without_vision_embeddings_leaves_the_gate_unused():
    """The reference's train CLI puts no ``vision_embeddings`` in its
    batches; its ``lm_apply`` then runs every cross block as causal
    self-attention over the text with the gate unused, so two different
    gates give the same logits.  Pinned so that the recorded departure of
    the port's train CLI (stub embeddings) stays true."""
    jparams, _ = _params()
    cfg = get_smoke_config(ARCH)
    toks = jnp.asarray(np.random.default_rng(8).integers(0, 256, (2, 12), dtype=np.int32))
    other = _seed_gates(jax.tree_util.tree_map(np.array, jparams), 99)
    a, _, _ = jlm.lm_apply(jparams, toks, cfg, mode="train")
    b, _, _ = jlm.lm_apply(other, toks, cfg, mode="train")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    c, _, _ = jlm.lm_apply(jparams, toks, cfg, mode="train",
                           vision_embeddings=jnp.asarray(_vision(1, 2)))
    d, _, _ = jlm.lm_apply(other, toks, cfg, mode="train",
                           vision_embeddings=jnp.asarray(_vision(1, 2)))
    assert np.abs(np.asarray(c) - np.asarray(d)).max() > 1e-4


# --------------------------------------------------------------------------
# plan and partition
# --------------------------------------------------------------------------

def _plan_ranks(plan):
    return {k: (v.rank, tuple(v.shape), v.use_decomposed) for k, v in plan.layers.items()}


@pytest.mark.parametrize("quantize", [False, True])
def test_full_config_plan_matches_jax(quantize):
    """llama-3.2-vision-90b at full size, LRD at Eq.-5 or Algorithm-1 ranks:
    the port's init on the meta device (no data) against JAX's under
    ``eval_shape``: the same paths, shapes, ranks and guard decisions and
    the same leaf shapes (self stack (20, 4, ...), cross stack (20, ...));
    at Eq. 5 the ranks past K1's old ceiling and K5's that this family
    brings: wq / wo 2048, wk / wv 455, the FFN 3185."""
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
    assert tuple(tparams["self_stack"]["norm1"]["scale"].shape) == (20, 4, 8192)
    assert tuple(tparams["cross_stack"]["attn"]["gate"].shape) == (20, 1)
    if not quantize:
        ranks = {k.split("/", 1)[1]: v.rank for k, v in dec.plan.layers.items()}
        for part in ("self", "cross"):
            assert {k.split("/", 1)[1]: r for k, r in ranks.items()
                    if k.startswith(part)} == {"attn/wq": 2048, "attn/wo": 2048,
                                               "attn/wk": 455, "attn/wv": 455,
                                               "ffn/gate": 3185, "ffn/up": 3185,
                                               "ffn/down": 3185}


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_freeze_partition_matches_jax(phase):
    """Which leaves each phase freezes (the factors of both stacks; never
    the embedding, norms, gates or unembedding), the partition's bytes, and
    a swap to the other phase."""
    jparams, tparams = _params()
    jtr, jfr = jfreezing.partition(jparams, phase)
    ttr, tfr = freezing.partition(tparams, phase)
    assert set(_flat(ttr)) == set(_flat(jtr)) and set(_flat(tfr)) == set(_flat(jfr))
    frozen = set(_flat(tfr))
    assert all(k.startswith(("/self_stack/", "/cross_stack/")) for k in frozen)
    assert not any("gate" in k.split("/")[-1] or "norm" in k or "embed" in k for k in frozen)
    assert len(frozen) == (0 if phase == -1 else 2 * 7)
    jrun, trun = _train_runs()
    jstate, jparked = jsteps.make_train_state(jrun.optim, jparams, phase)
    state, parked = steps.make_train_state(trun.optim, tparams, phase)
    assert steps.partition_bytes(state) == jsteps.partition_bytes(jstate)
    other = 1 if phase != 1 else 0
    jstate, _ = jsteps.repartition_state(jrun.optim, jstate, jparked, other)
    state, _ = steps.repartition_state(trun.optim, state, parked, other)
    assert steps.partition_bytes(state) == jsteps.partition_bytes(jstate)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

def test_cli_serve_and_train_on_cpu(tmp_path):
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--lrd"]
    engine, out = tserve.main(common + ["--slots", "2", "--prompt-len", "8",
                                        "--max-new", "4"])
    assert out.shape == (2, 4) and engine._scheduler is None
    train = common + ["--lrd-min-dim", "16", "--no-rank-opt", "--use-pallas", "--freeze",
                      "sequential", "--remat", "full", "--steps-per-epoch", "1",
                      "--global-batch", "2", "--seq-len", "16", "--log-every", "1",
                      "--save-every", "2", "--ckpt-dir", str(tmp_path)]
    state, losses = ttrain.main(train + ["--steps", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert set(state.params) >= {"self_stack", "cross_stack"}
    # the checkpoint at step 2 resumes: one more step, at phase 0 again
    state2, losses2 = ttrain.main(train + ["--steps", "3"])
    assert len(losses2) == 1 and np.isfinite(losses2[0])


@pytest.mark.parametrize("bad", [["--spec-k", "2"], ["--prefix-cache"]])
def test_cli_serve_refuses_what_the_fixed_batch_path_lacks(bad, capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--lrd", *bad])
    assert exc.value.code == 2
    assert "item 7" in capsys.readouterr().err


def test_cli_serves_the_int8_export(capsys):
    """``--export analytic --export-int8`` serves on the fixed-batch path
    (tests/test_torch_int8_families.py holds its tokens to the JAX
    engine's)."""
    engine, out = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--lrd",
                               "--slots", "2", "--prompt-len", "8", "--max-new", "4",
                               "--export", "analytic", "--export-int8"])
    assert out.shape == (2, 4) and engine._scheduler is None
    assert engine.export_report.summary() in capsys.readouterr().out
    assert all(l.quantized for l in engine.export_report.layers.values())


def test_cli_stub_vision_embeddings_are_seeded_by_step():
    run = ttrain.build_run(ttrain._parser().parse_args(
        ["--arch", ARCH, "--smoke", "--global-batch", "2"]))
    a, b = ttrain.stub_vision_embeddings(run, 0, 3), ttrain.stub_vision_embeddings(run, 0, 4)
    assert a.shape == (2, 8, 64) and a.dtype == np.float32
    np.testing.assert_array_equal(a, ttrain.stub_vision_embeddings(run, 0, 3))
    assert not np.array_equal(a, b) and abs(float(a.std()) - 0.1) < 0.02


def test_cli_vlm_extras_match_jax_cli_draws():
    """The serve CLI's embeddings are the JAX CLI's draws: the same
    generator, after the same prompts."""
    cfg = t_get_smoke_config(ARCH)
    run = tserve.serve_run(cfg, max_len=12, slots=2, lrd=False, device=torch.device("cpu"),
                           seed=0)
    rng = np.random.default_rng(7)
    rng.integers(0, cfg.vocab_size, size=(2, 8), dtype=np.int32)
    got = tserve.vlm_extras(run, rng, 2, torch.device("cpu"))["vision_embeddings"]
    ref = np.random.default_rng(7)
    ref.integers(0, cfg.vocab_size, size=(2, 8), dtype=np.int32)
    want = ref.normal(0, 0.1, (2, cfg.num_image_tokens, cfg.d_model))
    _close(got.numpy(), want.astype(np.float32), 0)
    assert got.dtype == cfg.cdtype
