"""The MoE family through the port's model, serving and training entry
points against the JAX package, on the smoke olmoe-1b-7b (float32, 2
layers, d 64, 8 experts top-2, qk-norm), with params made once in JAX and
carried over by ``repro_torch.bridge``.  Both dispatch semantics the
configs use are covered: ``dense`` (the smoke default) and ``ep``, which
every JAX entry point runs inside ``axis_rules`` of a host mesh and which
the port runs as its one-device counterpart:

* ``lm_apply`` prefill logits, caches and aux, and paged decode logits,
  within 1e-5;
* greedy tokens of the port's ``ServeEngine`` equal to the JAX
  ``ServeEngine``'s, with slot recycling and with preemption, and on the
  fixed-batch path;
* the train step's loss and gradients at phases -1, 0 and 1 against JAX's
  ``build_train_step`` (its kernels in Pallas interpret mode), and a
  6-step trajectory across two phase swaps;
* the serve and train CLIs at ``--smoke --device cpu``, and their refusal
  of CUDA without a GPU.
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
from repro.core import freezing as jfreezing
from repro.data import LMBatchIterator
from repro.distributed.sharding import axis_rules
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import paged_cache as jpc
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
from repro_torch.serving import paged_cache as tpc

torch.set_num_threads(1)

TOL = 1e-5  # float32: the same products summed in another order
# params and moments after 6 sgdm steps: per-step differences of TOL
# compound through the updates (test_torch_train.py's bound)
STATE_TOL = 1e-4
ARCH, SEQ, BATCH = "olmoe-1b-7b", 16, 4
IMPLS = ("dense", "ep")


def _cfgs(impl):
    return (dataclasses.replace(get_smoke_config(ARCH), moe_impl=impl),
            dataclasses.replace(t_get_smoke_config(ARCH), moe_impl=impl))


@functools.lru_cache(maxsize=None)
def _params(lrd: bool):
    jcfg, tcfg = _cfgs("ep")
    run = RunConfig(model=jcfg, shape=ShapeConfig("s", SEQ, BATCH, "train"),
                    lrd=LRDConfig(enabled=lrd, min_dim=16, rank_quantize=False),
                    dist=DistConfig(fsdp=False, remat="none"))
    params, plan = jsteps.init_params(run, jax.random.PRNGKey(7))
    params = jax.tree_util.tree_map(np.asarray, params)
    # the port's own init lays out the same tree: stack names, expert
    # factor groups (L, E, C, r) and ranks
    own, own_plan = steps.init_params(
        TRun(model=tcfg, shape=TShape("s", SEQ, BATCH, "train"),
             lrd=TLRD(enabled=lrd, min_dim=16, rank_quantize=False)), device="cpu")
    tparams = bridge.params_from_jax(params)
    assert sorted(p for p, _ in iter_factor_groups(own)) == \
        sorted(p for p, _ in iter_factor_groups(tparams))
    assert _shapes(own) == _shapes(tparams)
    assert {k: v.rank for k, v in own_plan.layers.items()} == \
        {k: v.rank for k, v in plan.layers.items()}
    assert ("moe_stack" in own) and ("stack" not in own)
    if lrd:  # 4 attention projections and 3 expert groups a layer
        assert len(plan.layers) == 7
        assert own["moe_stack"]["moe"]["experts"]["gate"]["u"].shape == (2, 8, 64, 16)
    return params, tparams


def _shapes(tree):
    return {p: tuple(t.shape) for p, t in _flat(tree).items()}


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
    g = {k: v.detach().numpy() for k, v in _flat(got).items()}
    w = {k: np.asarray(v) for k, v in _flat(want).items()}
    assert g.keys() == w.keys() and g
    for k in w:
        _close(g[k], w[k], tol)


def _mesh():
    return axis_rules(make_host_mesh(1, 1))


@pytest.mark.parametrize("lrd", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_logits_match_jax(impl, lrd):
    jparams, tparams = _params(lrd)
    jcfg, tcfg = _cfgs(impl)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    with _mesh():
        jlog, jcache, jaux = jax.jit(lambda p, t: jlm.lm_apply(p, t, jcfg, mode="full"))(
            jparams, jnp.asarray(toks))
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        tlog, tcache, taux = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg,
                                          mode="full", policy=True)
    _close(tlog.numpy(), jlog)
    _close(taux.item(), float(jaux))
    assert set(tcache) == set(jcache) == {"moe_stack"}
    for leaf in ("k", "v"):
        _close(tcache["moe_stack"][leaf].numpy(), jcache["moe_stack"][leaf])
    # 4 factorised attention projections a layer on the plain version (CPU);
    # the experts are torch.bmm, as they are einsum in JAX
    assert len(fbs) == (4 * jcfg.num_layers if lrd else 0)


@pytest.mark.parametrize("impl", IMPLS)
def test_dense_first_layers_match_jax(impl):
    """``first_k_dense``: a ``dense_stack`` of FFN layers before the
    ``moe_stack``, initialised and applied in the reference's order."""
    jcfg, tcfg = (dataclasses.replace(c, num_layers=3, first_k_dense=1, dense_d_ff=128)
                  for c in _cfgs(impl))
    run = RunConfig(model=jcfg, shape=ShapeConfig("s", SEQ, BATCH, "train"),
                    lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False),
                    dist=DistConfig(fsdp=False, remat="none"))
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jsteps.init_params(run, jax.random.PRNGKey(2))[0])
    tparams = bridge.params_from_jax(jparams)
    own, _ = steps.init_params(TRun(model=tcfg, shape=TShape("s", SEQ, BATCH, "train"),
                                    lrd=TLRD(enabled=True, min_dim=16,
                                             rank_quantize=False)), device="cpu")
    assert _shapes(own) == _shapes(tparams)
    assert tlm.stack_layers(tcfg) == {"dense_stack": 1, "moe_stack": 2}
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    with _mesh():
        jlog, jcache, jaux = jax.jit(lambda p, t: jlm.lm_apply(p, t, jcfg, mode="full"))(
            jparams, jnp.asarray(toks))
    with torch.inference_mode():
        tlog, tcache, taux = tlm.lm_apply(tparams, torch.from_numpy(toks), tcfg, mode="full")
    _close(tlog.numpy(), jlog)
    _close(taux.item(), float(jaux))
    assert set(tcache) == set(jcache) == {"dense_stack", "moe_stack"}
    assert set(tlm.init_cache(tcfg, 2, 8, "cpu")) == {"dense_stack", "moe_stack"}


@pytest.mark.parametrize("impl", IMPLS)
def test_paged_decode_logits_match_jax(impl):
    """Two slots at different positions, batch-1 prefills inserted into
    their pages, then decode steps across block boundaries."""
    jparams, tparams = _params(True)
    jcfg, tcfg = _cfgs(impl)
    slots, bs, max_len, plen = 2, 4, 20, 8
    max_blocks = jpc.blocks_for(max_len, bs)
    nb = 1 + slots * max_blocks
    pages = jpc.PageTableManager(slots, max_blocks, nb, bs)
    jcache = jpc.init_paged_cache(jcfg, slots, nb, bs, max_blocks)
    tcache = tpc.init_paged_cache(tcfg, slots, nb, bs, max_blocks, "cpu")
    assert set(tcache) == set(jcache) == {"moe_stack"}
    prefill = jax.jit(lambda p, t: jlm.lm_apply(p, t, jcfg, mode="full"))
    decode = jax.jit(lambda p, t, c, pos: jlm.lm_apply(p, t, jcfg, mode="decode", cache=c,
                                                       pos=pos))
    rng = np.random.default_rng(5)
    pos = np.zeros(slots, np.int32)
    nxt = np.zeros((slots, 1), np.int32)
    with _mesh():
        for s, n in enumerate([5, 7]):
            assert pages.admit(s, n + 1)
            padded = np.zeros((1, plen), np.int32)
            padded[0, :n] = rng.integers(0, jcfg.vocab_size, n)
            jlog, jpre, _ = prefill(jparams, jnp.asarray(padded))
            jcache = jpc.insert_prefill_paged(jcache, jpre, jnp.asarray(pages.table[s]))
            with torch.inference_mode():
                tlog, tpre, _ = tlm.lm_apply(tparams, torch.from_numpy(padded), tcfg,
                                             mode="full")
                tpc.insert_prefill_paged(tcache, tpre, torch.from_numpy(pages.table[s]))
            _close(tlog.numpy(), jlog)
            pos[s] = n
            nxt[s, 0] = int(np.argmax(np.asarray(jlog)[0, n - 1]))
        for _ in range(4):
            for s in range(slots):
                assert pages.ensure(s, int(pos[s]))
            jin = jpc.with_page_table(jcache, pages.table)
            jlog, jcache, _ = decode(jparams, jnp.asarray(nxt), jin, jnp.asarray(pos))
            with torch.inference_mode():
                tpc.with_page_table(tcache, pages.table)
                tlog, tcache, _ = tlm.lm_apply(tparams, torch.from_numpy(nxt), tcfg,
                                               mode="decode", cache=tcache,
                                               pos=torch.from_numpy(pos), policy=True)
            _close(tlog.numpy(), jlog)
            nxt = np.argmax(np.asarray(jlog)[:, -1:], axis=-1).astype(np.int32)
            pos += 1


SERVE_CASES = {
    "recycle": dict(num_slots=4, max_len=40, prefill_len=16, block_size=8),
    # 9 blocks of 8 for 4 slots that grow to 16+14 positions: preemption
    "preempt": dict(num_slots=4, max_len=40, prefill_len=32, block_size=8, num_blocks=9),
}


def _trace(vocab):
    rng = np.random.default_rng(11)
    return [{"prompt": rng.integers(0, vocab, int(rng.integers(4, 16)), dtype=np.int32),
             "max_new": int(rng.integers(6, 15))} for _ in range(7)]


def _serve_runs(impl):
    jcfg, tcfg = _cfgs(impl)
    lrd = dict(enabled=True, min_dim=16, rank_quantize=False)
    return (RunConfig(model=jcfg, shape=ShapeConfig("s", 40, 4, "decode"),
                      lrd=LRDConfig(**lrd), dist=DistConfig(fsdp=False, remat="none")),
            TRun(model=tcfg, shape=TShape("s", 40, 4, "decode"), lrd=TLRD(**lrd),
                 dist=TDist(fsdp=False, remat="none")))


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
@pytest.mark.parametrize("impl", IMPLS)
def test_scheduler_tokens_match_jax_engine(impl, case):
    jrun, trun = _serve_runs(impl)
    jparams, tparams = _params(True)
    trace = _trace(jrun.model.vocab_size)
    kw = SERVE_CASES[case]
    want = JServeEngine(jrun, jparams, config=JServeConfig(**kw)).serve(trace)
    engine = ServeEngine(trun, tparams, config=ServeConfig(**kw), device="cpu")
    got = engine.serve(trace)
    assert [r.tokens.tolist() for r in got] == [r.tokens.tolist() for r in want]
    assert set(engine.scheduler.cache) == {"moe_stack"}
    assert (engine.scheduler.latency_stats()["preemptions"] > 0) == (case == "preempt")
    assert engine.scheduler.forward_stats["nonfinite"] == 0


@pytest.mark.parametrize("impl", IMPLS)
def test_fixed_batch_tokens_match_jax_engine(impl):
    jrun, trun = _serve_runs(impl)
    jparams, tparams = _params(True)
    prompts = np.random.default_rng(14).integers(0, 256, (3, 10)).astype(np.int32)
    want = JServeEngine(jrun, jparams).generate(prompts, max_new=9)
    got = ServeEngine(trun, tparams, device="cpu").generate(prompts, max_new=9)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_engine_refuses_int8_export_of_experts():
    _, trun = _serve_runs("ep")
    with pytest.raises(ValueError, match="int8 export of a MoE model's expert groups"):
        ServeEngine(trun, _params(True)[1], device="cpu",
                    config=ServeConfig(num_slots=2, export="analytic", export_int8=True))


def _train_runs(optimizer="sgdm", kernels=True, impl="ep"):
    jcfg, tcfg = _cfgs(impl)
    lrd = dict(enabled=True, min_dim=16, freeze_mode="sequential", rank_quantize=False)
    opt = dict(name=optimizer, lr=1e-2, warmup_steps=2, total_steps=8)
    jrun = RunConfig(
        model=jcfg, shape=ShapeConfig("t", SEQ, BATCH, "train"),
        lrd=LRDConfig(**lrd, use_pallas_kernel=kernels, pallas_interpret=kernels,
                      pallas_block_m=32, pallas_block_k=64, pallas_block_n=32),
        dist=DistConfig(fsdp=False, remat="none"), optim=OptimConfig(**opt))
    trun = TRun(model=tcfg, shape=TShape("t", SEQ, BATCH, "train"),
                lrd=TLRD(**lrd, use_pallas_kernel=kernels),
                dist=TDist(fsdp=False, remat="none"), optim=TOptim(**opt))
    return jrun, trun


def _batches(n):
    it = iter(LMBatchIterator(get_smoke_config(ARCH).vocab_size, SEQ, BATCH, seed=0))
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_train_step_loss_and_grads_match_jax(phase):
    jrun, trun = _train_runs()
    params = _params(True)[0]
    batch = _batches(1)[0]
    jstate, jparked = jsteps.make_train_state(jrun.optim, params, phase)
    jnew, jm = jax.jit(functools.partial(jsteps.build_train_step(jrun, make_host_mesh(1, 1)),
                                         phase=phase))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    # sgdm from zero momentum: the first step's momentum IS the gradient
    state, _ = bridge.train_state_from_jax(jstate, jparked)
    with ops.capture_fallbacks() as fbs:
        loss, grads = steps._value_and_grad(state.trainable, state.frozen,
                                            bridge.batch_from_numpy(batch), trun, phase)
    _close(loss.item(), float(jm["loss"]))
    _close_trees(grads, jnew.opt.mu)
    # the router and every expert factor of the trainable group get a gradient
    flat = _flat(grads)
    assert any(k.endswith("router/kernel") for k in flat)
    assert sum("experts" in k for k in flat) == (6 if phase == -1 else 3)
    ops_seen = [f.op for f in fbs]
    assert ops_seen.count("lowrank_du") == (0 if phase == 0 else 8)
    assert ops_seen.count("lowrank_dv") == (0 if phase == 1 else 8)
    assert ops_seen.count("lowrank_fwd") == ops_seen.count("lowrank_dx") == 8
    new, m = steps.build_train_step(trun, device="cpu")(state, batch, phase=phase)
    _close(m["loss"].item(), float(jm["loss"]))
    _close(m["grad_norm"].item(), float(jm["grad_norm"]))
    _close_trees(new.trainable, jnew.trainable)


def test_six_step_trajectory_across_two_phase_swaps_matches_jax():
    jrun, trun = _train_runs(kernels=False)
    batches = _batches(6)
    jtrain = jsteps.build_train_step(jrun, make_host_mesh(1, 1))
    ttrain_step = steps.build_train_step(trun, device="cpu")
    jfns = {}
    jstate, jparked = jsteps.make_train_state(jrun.optim, _params(True)[0], 0)
    state, parked = bridge.train_state_from_jax(jstate, jparked)
    cur, phases, jlosses, losses = 0, [], [], []
    for step, batch in enumerate(batches):
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
    _close(losses, jlosses)
    nstate, nparked = bridge.train_state_to_numpy(state, parked)
    _close_trees(bridge.from_numpy(jfreezing.merge(nstate.trainable, nstate.frozen)),
                 jstate.params, STATE_TOL)
    assert steps.partition_bytes(state) == jsteps.partition_bytes(jstate)


def test_cli_serve_and_train_moe_on_cpu(tmp_path):
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--lrd"]
    engine, outs = tserve.main(common + ["--slots", "2", "--requests", "3", "--rate", "100",
                                         "--prompt-len", "8", "--max-new", "4",
                                         "--block-size", "4"])
    assert [len(o) for o in outs] == [4, 4, 4]
    assert set(engine.scheduler.cache) == {"moe_stack"}
    state, losses = ttrain.main(common + ["--lrd-min-dim", "16", "--no-rank-opt",
                                          "--use-pallas", "--freeze", "sequential",
                                          "--remat", "full", "--steps", "3",
                                          "--steps-per-epoch", "1", "--global-batch", "2",
                                          "--seq-len", "16", "--log-every", "1",
                                          "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "moe_stack" in state.params


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_cli_without_gpu_and_device_cpu_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", ARCH, "--smoke", "--lrd", "--requests", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", ARCH, "--smoke", "--remat", "full", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)])


def test_apply_lrd_leaves_expert_stacks_dense_as_jax():
    """``apply_lrd`` of a dense MoE tree under the LM policy factorises the
    attention projections and leaves the 4-D (L, E, C, S) expert kernels
    dense in both packages: the reference sends 4-D kernels down its HWIO
    conv branch, where an SVD rule keeps them as they are."""
    from repro.core.decompose import apply_lrd as japply_lrd
    from repro.core.policy import LM_DEFAULT as JLM
    from repro_torch.core.decompose import apply_lrd
    from repro_torch.core.policy import LM_DEFAULT

    dense = _params(False)[0]
    jtree, jplan = japply_lrd(jax.tree_util.tree_map(jnp.asarray, dense),
                              JLM.with_quantize(False).with_min_dim(16))
    tree, plan = apply_lrd(bridge.params_from_jax(dense),
                           LM_DEFAULT.with_quantize(False).with_min_dim(16))
    assert {k: v.rank for k, v in plan.layers.items()} == \
        {k: v.rank for k, v in jplan.layers.items()}
    assert sorted(plan.layers) == [f"moe_stack/attn/{w}" for w in ("wk", "wo", "wq", "wv")]
    for g in ("gate", "up", "down"):
        assert set(tree["moe_stack"]["moe"]["experts"][g]) == {"kernel"}
        assert set(jtree["moe_stack"]["moe"]["experts"][g]) == {"kernel"}
    # the factorised projections match JAX's products
    for w in ("wq", "wk", "wv", "wo"):
        got = tree["moe_stack"]["attn"][w]
        want = jtree["moe_stack"]["attn"][w]
        _close((got["u"] @ got["v"]).numpy(), np.asarray(want["u"]) @ np.asarray(want["v"]),
               1e-4)
