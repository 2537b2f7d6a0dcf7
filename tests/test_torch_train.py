"""The port's train step against the JAX package's on the smoke
smollm-360m (float32, 2 layers, d 64, LRD with min_dim=16 and Eq.-5 ranks),
on params made once in JAX and carried over by ``repro_torch.bridge``:

* one step's loss and gradients at freezing phases -1, 0 and 1, with the
  JAX kernels in Pallas interpret mode (blocks 32/64/32 divide every dim);
* a 6-step loss trajectory across two sequential-freezing swaps
  (``repartition_state``), for sgdm and adamw, with the final params and
  the full (merged) optimizer moments.
"""

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
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDistConfig
from repro_torch.configs.base import LRDConfig as TLRDConfig
from repro_torch.configs.base import OptimConfig as TOptimConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.core import freezing
from repro_torch.kernels import ops
from repro_torch.launch import steps

torch.set_num_threads(1)

# float32 loss and gradients: the same products summed in another order
TOL = 1e-5
# params and moments after 6 optimizer steps: per-step differences of
# TOL compound through the updates
STATE_TOL = 1e-4
# adamw params after 6 steps: the update lr * m/(sqrt(v) + 1e-8) is close
# to lr * sign(g) for a gradient near float32 noise, so such an element may
# move by a fraction of lr (1e-2) one way in one package and not the
# other; the moments themselves still agree to STATE_TOL
ADAMW_PARAM_TOL = 2e-3
ARCH, SEQ, BATCH = "smollm-360m", 16, 4


def _runs(optimizer="sgdm", kernels=True):
    lrd = dict(enabled=True, min_dim=16, freeze_mode="sequential", rank_quantize=False)
    opt = dict(name=optimizer, lr=1e-2, warmup_steps=2, total_steps=8)
    jrun = RunConfig(
        model=get_smoke_config(ARCH), shape=ShapeConfig("t", SEQ, BATCH, "train"),
        lrd=LRDConfig(**lrd, use_pallas_kernel=kernels, pallas_interpret=kernels,
                      pallas_block_m=32, pallas_block_k=64, pallas_block_n=32),
        dist=DistConfig(fsdp=False, remat="none"), optim=OptimConfig(**opt))
    trun = TRunConfig(
        model=t_get_smoke_config(ARCH), shape=TShapeConfig("t", SEQ, BATCH, "train"),
        lrd=TLRDConfig(**lrd, use_pallas_kernel=kernels),
        dist=TDistConfig(fsdp=False, remat="none"), optim=TOptimConfig(**opt))
    return jrun, trun


@functools.lru_cache(maxsize=None)
def _params():
    jrun, _ = _runs()
    params, plan = jsteps.init_params(jrun, jax.random.PRNGKey(0))
    assert sum(lp.use_decomposed for lp in plan.layers.values()) == 7
    return jax.tree_util.tree_map(np.asarray, params)


def _batches(n):
    it = iter(LMBatchIterator(get_smoke_config(ARCH).vocab_size, SEQ, BATCH, seed=0))
    return [next(it) for _ in range(n)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_trees(got, want, tol):
    gl, wl = freezing.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl) > 0
    # JAX trees sort dict keys; compare path by path
    flat_g = _by_path(got)
    flat_w = _by_path(want)
    assert flat_g.keys() == flat_w.keys()
    for k in flat_w:
        _close(flat_g[k], flat_w[k], tol)


def _by_path(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_path(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_by_path(v, f"{path}/{i}"))
        return out
    if tree is None:
        return {}
    return {path: tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_train_step_loss_grads_and_update_match_jax(phase):
    jrun, trun = _runs()
    params = _params()
    batch = _batches(1)[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = make_host_mesh(1, 1)
    jstate, jparked = jsteps.make_train_state(jrun.optim, params, phase)
    jnew, jm = jax.jit(functools.partial(jsteps.build_train_step(jrun, mesh),
                                         phase=phase))(jstate, jbatch)
    # sgdm from zero momentum: the first step's momentum IS the gradient
    jloss, jgrads = jm["loss"], jnew.opt.mu

    state, parked = bridge.train_state_from_jax(jstate, jparked)
    tbatch = bridge.batch_from_numpy(batch)
    with ops.capture_fallbacks() as fbs:
        loss, grads = steps._value_and_grad(state.trainable, state.frozen, tbatch, trun, phase)
    _close(loss.item(), float(jloss))
    _close_trees(grads, jgrads, TOL)
    # the frozen group's gradient was never computed (7 factor groups,
    # 2 layers: 10 plain linears + 2 FFN halves with 2 factors each)
    ops_seen = [f.op for f in fbs]
    assert ops_seen.count("lowrank_du") == (0 if phase == 0 else 14)
    assert ops_seen.count("lowrank_dv") == (0 if phase == 1 else 14)
    assert ops_seen.count("lowrank_dx") == 14

    new, m = steps.build_train_step(trun, device="cpu")(state, batch, phase=phase)
    _close(m["loss"].item(), float(jm["loss"]))
    _close(m["grad_norm"].item(), float(jm["grad_norm"]))
    _close_trees(new.trainable, jnew.trainable, TOL)
    _close_trees(new.opt.mu, jnew.opt.mu, TOL)
    assert int(new.opt.step) == int(jnew.opt.step) == 1
    assert new.frozen is state.frozen


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
def test_six_step_trajectory_across_two_phase_swaps_matches_jax(optimizer):
    jrun, trun = _runs(optimizer, kernels=False)
    params = _params()
    batches = _batches(6)
    mesh = make_host_mesh(1, 1)
    jtrain = jsteps.build_train_step(jrun, mesh)
    ttrain = steps.build_train_step(trun, device="cpu")
    jfns = {}
    jstate, jparked = jsteps.make_train_state(jrun.optim, params, 0)
    state, parked = bridge.train_state_from_jax(jstate, jparked)
    cur, phases, jlosses, losses = 0, [], [], []
    for step, batch in enumerate(batches):
        phase = jsteps.run_phase(jrun, step // 2)
        assert phase == steps.run_phase(trun, step // 2)
        if phase != cur:
            jstate, jparked = jsteps.repartition_state(jrun.optim, jstate, jparked, phase)
            state, parked = steps.repartition_state(trun.optim, state, parked, phase)
            assert all(t.device.type == "cpu" for t in freezing.tree_leaves(parked))
            cur = phase
        if phase not in jfns:
            jfns[phase] = jax.jit(functools.partial(jtrain, phase=phase))
        jstate, jm = jfns[phase](jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = ttrain(state, batch, phase=phase)
        phases.append(phase)
        jlosses.append(float(jm["loss"]))
        losses.append(m["loss"].item())
    assert phases == [0, 0, 1, 1, 0, 0]
    _close(losses, jlosses)
    nstate, nparked = bridge.train_state_to_numpy(state, parked)
    _close_trees(jfreezing.merge(nstate.trainable, nstate.frozen), jstate.params,
                 ADAMW_PARAM_TOL if optimizer == "adamw" else STATE_TOL)
    jmoments = jfreezing.merge_moments((jstate.opt.mu, jstate.opt.nu), jparked)
    moments = jfreezing.merge_moments((nstate.opt.mu, nstate.opt.nu), nparked)
    _close_trees(moments, jmoments, STATE_TOL)
    assert steps.partition_bytes(state) == jsteps.partition_bytes(jstate)


def test_microbatched_step_matches_jax():
    jrun, trun = _runs("adamw", kernels=False)
    jrun = jrun.__class__(**{**jrun.__dict__, "dist": DistConfig(fsdp=False, remat="none",
                                                                 microbatches=2)})
    trun = trun.__class__(**{**trun.__dict__, "dist": TDistConfig(fsdp=False, remat="none",
                                                                  microbatches=2)})
    batch = _batches(1)[0]
    jstate, jparked = jsteps.make_train_state(jrun.optim, _params(), 1)
    jnew, jm = jax.jit(functools.partial(jsteps.build_train_step(jrun, make_host_mesh(1, 1)),
                                         phase=1))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, _ = bridge.train_state_from_jax(jstate, jparked)
    new, m = steps.build_train_step(trun, device="cpu")(state, batch, phase=1)
    _close(m["loss"].item(), float(jm["loss"]))
    _close(m["grad_norm"].item(), float(jm["grad_norm"]))
    _close_trees(new.trainable, jnew.trainable, TOL)


def test_step_refuses_a_state_partitioned_for_another_phase():
    _, trun = _runs()
    state, _ = bridge.train_state_from_jax(*jsteps.make_train_state(_runs()[0].optim,
                                                                    _params(), 0))
    with pytest.raises(ValueError, match="partition/phase mismatch"):
        steps.build_train_step(trun, device="cpu")(state, _batches(1)[0], phase=1)
    # a rank schedule before its start boundary swaps the phase and cuts nothing
    from repro_torch.core.rank_adapt import RankSchedule, live_rank_map
    ranks = live_rank_map(state.params)
    swapped, parked = steps.repartition_state(
        trun.optim, state, (None, ()), 1, schedule=RankSchedule(policy="decay"), boundary=0)
    assert live_rank_map(swapped.params) == ranks
    with pytest.raises(ValueError, match="partition/phase mismatch"):
        steps.build_train_step(trun, device="cpu")(swapped, _batches(1)[0], phase=0)
