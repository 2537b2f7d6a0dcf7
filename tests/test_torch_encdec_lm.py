"""The encoder-decoder family through the port's steps, engine and CLIs
against the JAX package, on the smoke seamless-m4t-medium (float32; 2
encoder and 2 decoder layers, d 64, 4 heads, 16 frames), LRD on at Eq.-5
ranks, params made once in JAX and carried over by ``repro_torch.bridge``,
every cross-attention gate a seeded non-zero value (at the init's zeros the
decoder ignores the memory and the encoder gets no gradient):

* the prefill step's last-position logits and cache and the serve step's
  logits against JAX's ``build_prefill_step`` / ``build_serve_step``
  (1e-5);
* greedy fixed-batch tokens of ``ServeEngine.generate(...,
  extras={"frames"})`` equal to JAX's ``ServeEngine.generate(...,
  extras={"frames", "memory"})``;
* the train step's loss and gradients at phases -1, 0 and 1 within 1e-4
  of JAX's, the frozen factor's kernel never run, and the encoder's
  gradients non-zero; remat ``full`` and ``dots`` bit-identical to none;
* the plan's ranks (smoke, and the full config's on the meta device
  against ``jax.eval_shape``: Eq.-5 256 / 409, Algorithm-1 255 / 384) and
  the freeze partition and its bytes against JAX's;
* both CLIs at ``--smoke --device cpu`` (the train CLI through a
  checkpoint and a resume), and, pinned so the recorded departure stays
  true, both JAX CLIs' ``KeyError: 'frames'`` on this family.
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
from repro.launch import serve as jserve_cli
from repro.launch import steps as jsteps
from repro.launch import train as jtrain_cli
from repro.launch.mesh import make_host_mesh
from repro.models import encdec as jed
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
from repro_torch.models import encdec as ted
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving.engine import pad_cache_preserving_cross

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
TOL = 1e-5  # float32 logits: the same products summed in another order
GRAD_TOL = 1e-4  # loss and gradients of a train step
SEQ, BATCH = 16, 2
# factorised projections a decoder layer runs (self and cross wq/wk/wv/wo,
# FFN wi and down) over 2 layers; the encoder's 6 a layer run with the
# kernels off, as the reference's encode
DEC_CALLS, ENC_CALLS = 2 * 10, 2 * 6


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


@functools.lru_cache(maxsize=None)
def _params():
    """JAX's init (numpy leaves) with every cross gate a seeded draw of
    +-U(0.3, 1.2), and the port's copy."""
    run = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", SEQ, BATCH, "train"),
                    lrd=LRDConfig(**_lrd()), dist=DistConfig(fsdp=False, remat="none"))
    jparams, _ = jsteps.init_params(run, jax.random.PRNGKey(9))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    gate = jparams["dec_stack"]["cross_attn"]["gate"]
    rng = np.random.default_rng(21)
    jparams["dec_stack"]["cross_attn"]["gate"] = (
        rng.uniform(0.3, 1.2, gate.shape) * rng.choice([-1.0, 1.0], gate.shape)
    ).astype(gate.dtype)
    return jparams, bridge.params_from_jax(jparams)


def _frames(seed, b):
    cfg = get_smoke_config(ARCH)
    return np.random.default_rng(seed).normal(
        0, 0.1, (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)


def _serve_runs(max_len=24, b=3):
    kw = dict(lrd=_lrd())
    jrun = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", max_len, b, "decode"),
                     lrd=LRDConfig(**kw["lrd"]), dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=t_get_smoke_config(ARCH), shape=TShape("s", max_len, b, "decode"),
                lrd=TLRD(**kw["lrd"], use_pallas_kernel=True),
                dist=TDist(fsdp=False, remat="none"))
    return jrun, trun


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_prefill_and_serve_steps_match_jax():
    """JAX's and the port's prefill step on tokens and frames, the caches
    padded (cross kept at 16 frames), then 3 serve steps fed JAX's greedy
    tokens, JAX's each given ``extras={"memory": ...}``; the port's reads
    its cross k/v from the cache and takes no memory."""
    jparams, tparams = _params()
    jrun, trun = _serve_runs()
    mesh = make_host_mesh(1, 1)
    toks = np.random.default_rng(4).integers(0, 256, (3, 10), dtype=np.int32)
    frames = _frames(5, 3)
    jbatch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    jlast, jcache = jsteps.build_prefill_step(jrun, mesh)(jparams, jbatch)
    with ops.capture_fallbacks() as fbs:
        tlast, tcache = steps.build_prefill_step(trun)(
            tparams, {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})
    _close(tlast.numpy(), jlast)
    _close_trees(tcache, jcache)
    assert [f.reason for f in fbs if f.op == "lowrank_fwd"].count("platform") == DEC_CALLS
    assert [f.reason for f in fbs if f.op == "lowrank_fwd"].count("disabled") == ENC_CALLS
    jmem = jed.encode(jparams, jnp.asarray(frames), jrun.model)
    jcache, tcache = jpad_cross(jcache, 13), pad_cache_preserving_cross(tcache, 13)
    jstep = jax.jit(jsteps.build_serve_step(jrun, mesh))
    tstep = steps.build_serve_step(trun)
    nxt = np.argmax(np.asarray(jlast), axis=-1).astype(np.int32)[:, None]
    for i in range(3):
        pos = np.int32(10 + i)
        jlog, jcache, jnext = jstep(jparams, jcache, jnp.asarray(nxt), jnp.asarray(pos),
                                    {"memory": jmem})
        tlog, tcache, tnext = tstep(tparams, tcache, torch.from_numpy(nxt),
                                    torch.tensor(pos))
        _close(tlog.numpy(), jlog)
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
        nxt = np.array(jnext)


@pytest.mark.parametrize("num_slots", [0, 2])
def test_fixed_batch_tokens_match_jax_engine(num_slots):
    """Greedy tokens of ``ServeEngine.generate(extras={"frames"})`` against
    JAX's engine given the frames and their memory; extras always take the
    fixed-batch path, as in the reference."""
    jparams, tparams = _params()
    jrun, trun = _serve_runs()
    prompts = np.random.default_rng(14).integers(0, 256, (3, 10), dtype=np.int32)
    frames = _frames(15, 3)
    jextras = {"frames": jnp.asarray(frames),
               "memory": jed.encode(jparams, jnp.asarray(frames), jrun.model)}
    want = JServeEngine(jrun, jparams).generate(prompts, max_new=8, extras=jextras)
    engine = ServeEngine(trun, tparams, device="cpu", config=ServeConfig(num_slots=num_slots))
    textras = {"frames": frames}
    got = engine.generate(prompts, max_new=8, extras=textras)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert engine._scheduler is None
    eos = int(np.asarray(want)[0, 2])
    np.testing.assert_array_equal(
        engine.generate(prompts, max_new=8, extras=textras, eos_id=eos),
        np.asarray(JServeEngine(jrun, jparams).generate(prompts, max_new=8, extras=jextras,
                                                        eos_id=eos)))
    # the int8 export serves on the same path (tests/test_torch_int8_families.py
    # holds its tokens to the JAX engine's)
    int8 = ServeEngine(trun, tparams, device="cpu",
                       config=ServeConfig(export="analytic", export_int8=True))
    assert int8.generate(prompts, max_new=8, extras=textras).shape == (3, 8)
    assert all(l.quantized for l in int8.export_report.layers.values())


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
    return dict(batch, frames=_frames(seed + 100, BATCH))


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
    # the gate reaches the memory: the encoder's trainable leaves learn
    enc = [k for k in flat if k.startswith("/enc_stack/") and not k.endswith(frozen or "-")]
    assert enc and all(flat[k].abs().max() > 0 for k in enc)
    seen = [(f.op, f.reason) for f in fbs]
    n = DEC_CALLS
    assert seen.count(("lowrank_fwd", "platform")) == seen.count(("lowrank_dx", "platform")) == n
    assert seen.count(("lowrank_du", "platform")) == (0 if phase == 0 else n)
    assert seen.count(("lowrank_dv", "platform")) == (0 if phase == 1 else n)
    assert seen.count(("lowrank_fwd", "disabled")) == ENC_CALLS
    new, m = steps.build_train_step(trun, device="cpu")(state, batch, phase=phase)
    _close(m["loss"].item(), float(jm["loss"]), GRAD_TOL)
    _close(m["grad_norm"].item(), float(jm["grad_norm"]), GRAD_TOL)
    _close_trees(new.trainable, jnew.trainable, GRAD_TOL)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_grads_equal_none_bitwise(remat):
    """Checkpointing the encoder's and the decoder's layers recomputes the
    same forward: every gradient equals the un-rematerialised step's bit
    for bit."""
    _, trun = _train_runs()
    _, trun_r = _train_runs(remat)
    batch = bridge.batch_from_numpy(_batch(1))
    state, _ = steps.make_train_state(trun.optim, _params()[1], 0)
    with ops.capture_fallbacks() as plain:
        loss, want = steps._value_and_grad(state.trainable, state.frozen, batch, trun, 0)
    with ops.capture_fallbacks() as recomputed:
        loss_r, got = steps._value_and_grad(state.trainable, state.frozen, batch, trun_r, 0)
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys() and torch.equal(loss, loss_r)
    assert all(torch.equal(g[k], w[k]) for k in w)
    fwd = lambda fbs: sum(f.op == "lowrank_fwd" for f in fbs)  # noqa: E731
    assert fwd(recomputed) == 2 * fwd(plain)  # every layer's forward once more


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


# --------------------------------------------------------------------------
# plan and partition
# --------------------------------------------------------------------------

def _plan_ranks(plan):
    return {k: (v.rank, tuple(v.shape), v.use_decomposed) for k, v in plan.layers.items()}


# (attention, FFN) ranks of full-width seamless-m4t-medium: Eq. 5 at alpha
# 2, and Algorithm 1 (rank quantization on the v5e model, the train CLI's
# default) snapping them to 255 and 384
FULL_RANKS = {False: (256, 409), True: (255, 384)}


@pytest.mark.parametrize("quantize", [False, True])
def test_full_config_plan_matches_jax(quantize):
    """seamless-m4t-medium at full size, LRD at Eq.-5 or Algorithm-1 ranks:
    the port's init on the meta device (no data) against JAX's under
    ``eval_shape``: the same paths, shapes, ranks and guard decisions, the
    same leaf shapes, a dense unembedding."""
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
    tparams = ted.encdec_init(tcfg, dec)
    assert _plan_ranks(dec.plan) == _plan_ranks(holder["plan"])
    ranks = {k.split("/")[-1]: v.rank for k, v in dec.plan.layers.items()}
    attn, ffn = FULL_RANKS[quantize]
    assert ranks == {"wq": attn, "wk": attn, "wv": attn, "wo": attn, "wi": ffn, "down": ffn}
    assert all(v.use_decomposed for v in dec.plan.layers.values())
    assert len(dec.plan.layers) == 2 * 6 + 4 * 1  # enc attn 4 + ffn 2; dec two attn + ffn
    assert {k: tuple(v.shape) for k, v in _flat(tparams).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jshapes).items()}
    assert tuple(tparams["unembed"]["kernel"].shape) == (1024, 256256)


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_freeze_partition_matches_jax(phase):
    """Which leaves each phase freezes (the factors of both stacks; never
    the embedding, norms, gates or the dense unembedding), the partition's
    bytes, and a swap to the other phase."""
    jparams, tparams = _params()
    jtr, jfr = jfreezing.partition(jparams, phase)
    ttr, tfr = freezing.partition(tparams, phase)
    assert set(_flat(ttr)) == set(_flat(jtr)) and set(_flat(tfr)) == set(_flat(jfr))
    frozen = set(_flat(tfr))
    assert all(k.startswith(("/enc_stack/", "/dec_stack/")) for k in frozen)
    assert not any("gate" in k or "norm" in k or "embed" in k for k in frozen)
    assert len(frozen) == (0 if phase == -1 else 16)
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
    assert set(state.params) >= {"enc_stack", "dec_stack"}
    # the checkpoint at step 2 resumes: one more step, at phase 0 again
    state2, losses2 = ttrain.main(train + ["--steps", "3"])
    assert len(losses2) == 1 and np.isfinite(losses2[0])
    for bad in (["--spec-k", "2"], ["--prefix-cache"]):
        with pytest.raises(SystemExit) as exc:
            tserve.main(common + bad)
        assert exc.value.code == 2
    # the int8 export serves
    engine, out = tserve.main(common + ["--slots", "2", "--prompt-len", "8", "--max-new", "4",
                                        "--export", "analytic", "--export-int8"])
    assert out.shape == (2, 4) and engine.export_report is not None


def test_cli_stub_frames_are_seeded_by_step():
    run = ttrain.build_run(ttrain._parser().parse_args(
        ["--arch", ARCH, "--smoke", "--global-batch", "2"]))
    a, b = ttrain.stub_frames(run, 0, 3), ttrain.stub_frames(run, 0, 4)
    assert a.shape == (2, 16, 64) and a.dtype == np.float32
    np.testing.assert_array_equal(a, ttrain.stub_frames(run, 0, 3))
    assert not np.array_equal(a, b) and abs(float(a.std()) - 0.1) < 0.01


@pytest.mark.parametrize("cli", ["train", "serve"])
def test_jax_clis_fail_on_this_family_for_want_of_frames(cli, tmp_path):
    """The reference's CLIs cannot run this family (its train batches carry
    no frames; its serve CLI hands the engine the memory alone, whose
    prefill encodes ``batch["frames"]``): the port's CLIs depart from them
    by drawing frames.  Pinned so the departure stays recorded truly."""
    with pytest.raises(KeyError, match="frames"):
        if cli == "train":
            jtrain_cli.main(["--arch", ARCH, "--smoke", "--steps", "1", "--global-batch",
                             "2", "--seq-len", "8", "--ckpt-dir", str(tmp_path)])
        else:
            jserve_cli.main(["--arch", ARCH, "--smoke", "--slots", "2", "--prompt-len", "8",
                             "--max-new", "2"])


def test_prefill_batch_shapes_split_for_microbatches():
    """Microbatching splits the frames with the tokens: two microbatches
    give the whole batch's gradient (mean of the halves)."""
    _, trun = _train_runs()
    trun2 = dataclasses.replace(trun, dist=dataclasses.replace(trun.dist, microbatches=2))
    batch = _batch(2)
    state, _ = steps.make_train_state(trun.optim, _params()[1], -1)
    _, m1 = steps.build_train_step(trun, device="cpu")(state, batch, phase=-1)
    state, _ = steps.make_train_state(trun.optim, _params()[1], -1)
    _, m2 = steps.build_train_step(trun2, device="cpu")(state, batch, phase=-1)
    _close(m2["loss"].item(), m1["loss"].item(), GRAD_TOL)
    _close(m2["grad_norm"].item(), m1["grad_norm"].item(), GRAD_TOL)
