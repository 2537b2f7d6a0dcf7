"""In-training rank adaptation in the port against the JAX package, on the
CPU — the contracts of ``tests/test_rank_adapt.py`` on both packages at
once, with params made in JAX and carried over by ``repro_torch.bridge``:

* the schedule: validation, gating, decay and energy targets, the decay
  trajectory (``plan_rank_map`` / ``decay_rank_maps`` give JAX's maps);
* truncation: ``truncate_params`` products against JAX's, Eckart–Young
  optimality, a trained group truncated in flight against a fresh
  decomposition of its product, and moment slicing (cut leaves own their
  storage, parked ones stay on the CPU);
* ``steps.repartition_state(schedule=...)``: JAX's rank maps, shapes and
  partition bytes on the same trained state, and a step at the new ranks;
* the train CLI with ``--rank-schedule decay`` and ``energy`` resuming a
  JAX run at smoke size: the same ``[rank-adapt]`` maps at each boundary,
  the same losses and final factors; the trainable-byte trajectory of
  ``benchmarks/results/BENCH_rank_adaptation.json``; a save and resume at
  truncated ranks, and the restore guard on a wrong rank map.

Signs: a truncation's factors are unique only up to a sign per rank column,
and the kept moment slices live in the old coordinates, so a flipped
column changes the next updates.  On the CLI runs' inputs this host's
LAPACK under torch and under JAX do flip some columns (the products agree
within 1e-5), so the CLI test carries JAX's truncated factors across at
each boundary (``truncate_params`` patched to return JAX's, after holding
the port's products against them).  The unit tests compare truncated
products, and factors only where their signs agree on this host.
"""

import ast
import dataclasses
import functools
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro.core import freezing as jfreezing
from repro.core import rank_adapt as jrank_adapt
from repro.core import svd as jsvd
from repro.core.decompose import iter_factor_groups as j_iter_groups
from repro.data import LMBatchIterator
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.launch.mesh import make_host_mesh
from repro_torch import bridge
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import DistConfig as TDistConfig
from repro_torch.configs.base import LRDConfig as TLRDConfig
from repro_torch.configs.base import OptimConfig as TOptimConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.core import freezing, rank_adapt, svd
from repro_torch.core.decompose import iter_factor_groups, map_factor_groups
from repro_torch.core.rank_adapt import RankSchedule
from repro_torch.launch import steps, train

torch.set_num_threads(1)

# float32 losses and truncated products: the same QR/SVD and products,
# summed in another order
TOL = 1e-5
# params and factors after further optimizer steps, and a trained group
# truncated in flight against a fresh SVD of its product (JAX's own bound)
STATE_TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--arch", "smollm-360m", "--smoke", "--lrd", "--lrd-min-dim", "16",
         "--no-rank-opt", "--freeze", "sequential", "--steps-per-epoch", "2",
         "--global-batch", "2", "--seq-len", "16", "--log-every", "100"]


def _runs(microbatches=1, rank_schedule="none", decay=0.75, lr=1e-2, seq=32, batch=4):
    """JAX's and the port's run of JAX's rank-adaptation tests."""
    lrd = dict(enabled=True, min_dim=16, rank_quantize=False, freeze_mode="sequential",
               rank_schedule=rank_schedule, rank_decay=decay, rank_min=2)
    opt = dict(name="adamw", lr=lr, warmup_steps=0, total_steps=100, schedule="constant")
    jrun = RunConfig(model=get_smoke_config("smollm-360m"), shape=ShapeConfig("b", seq, batch, "train"),
                     lrd=LRDConfig(**lrd), optim=OptimConfig(**opt),
                     dist=DistConfig(fsdp=False, remat="none", microbatches=microbatches))
    trun = TRunConfig(model=t_smoke("smollm-360m"), shape=TShapeConfig("b", seq, batch, "train"),
                      lrd=TLRDConfig(**lrd), optim=TOptimConfig(**opt),
                      dist=TDistConfig(fsdp=False, remat="none", microbatches=microbatches))
    return jrun, trun


@functools.lru_cache(maxsize=None)
def _init_params(seed=0):
    params, _ = jsteps.init_params(_runs()[0], jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(run, seed=0):
    rng = np.random.default_rng(seed)
    b, s = run.shape.global_batch, run.shape.seq_len
    return {"tokens": rng.integers(0, run.model.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, run.model.vocab_size, (b, s)).astype(np.int32)}


def _jax_trained(jrun, steps_n, phase=0):
    """JAX's state after ``steps_n`` steps at ``phase`` (init factors are
    exact SVDs, so truncation parity would be vacuous on them)."""
    mesh = make_host_mesh(1, 1)
    state, parked = jsteps.make_train_state(jrun.optim, _init_params(), phase)
    fn = jax.jit(functools.partial(jsteps.build_train_step(jrun, mesh), phase=phase))
    for i in range(steps_n):
        state, m = fn(state, {k: jnp.asarray(v) for k, v in _batch(jrun, i).items()})
        assert np.isfinite(float(m["loss"]))
    return state, parked


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------------------
# the schedule
# --------------------------------------------------------------------------

def test_rank_schedule_validation_and_config_match_jax():
    for kw, match in ((dict(policy="linear"), "policy"), (dict(policy="decay", decay=1.0), "decay"),
                      (dict(policy="energy", energy_threshold=0.0), "energy_threshold"),
                      (dict(policy="decay", min_rank=0), "min_rank")):
        with pytest.raises(ValueError, match=match):
            RankSchedule(**kw)
        with pytest.raises(ValueError, match=match):
            jrank_adapt.RankSchedule(**kw)
    assert not RankSchedule().active
    lrd = dict(enabled=True, rank_schedule="decay", rank_decay=0.5, rank_min=3,
               rank_schedule_tile=64, rank_schedule_start=2)
    s = rank_adapt.schedule_from_config(TLRDConfig(**lrd))
    assert s.active and s.decay == 0.5 and s.min_rank == 3 and s.tile == 64
    assert dataclasses.asdict(s) == dataclasses.asdict(
        jrank_adapt.schedule_from_config(LRDConfig(**lrd)))


def _toy(rank=6, seed=0, stack=()):
    """A JAX-made group ``wq`` (+ a bias and a norm) as numpy."""
    u = jax.random.normal(jax.random.PRNGKey(seed), stack + (16, rank), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(seed + 1), stack + (rank, 12), jnp.float32)
    return {"wq": {"u": np.asarray(u), "v": np.asarray(v), "bias": np.zeros(stack + (12,),
                                                                           np.float32)},
            "norm": {"scale": np.ones((16,), np.float32)}}


@pytest.mark.parametrize("rank", [2, 3, 6, 40, 130, 349])
@pytest.mark.parametrize("decay,min_rank,tile,start", [(0.5, 2, 128, 1), (0.75, 2, 128, 1),
                                                       (0.75, 4, 8, 2), (0.3, 1, 32, 1)])
def test_plan_rank_map_gating_and_decay_targets_match_jax(rank, decay, min_rank, tile, start):
    p = _toy(rank=rank)
    kw = dict(policy="decay", decay=decay, min_rank=min_rank, tile=tile, start_boundary=start)
    t, j = RankSchedule(**kw), jrank_adapt.RankSchedule(**kw)
    assert rank_adapt.plan_rank_map(bridge.from_numpy(p), RankSchedule()) == {}
    for boundary in (None, 0, 1, 2, 3):
        assert (rank_adapt.plan_rank_map(bridge.from_numpy(p), t, boundary)
                == jrank_adapt.plan_rank_map(p, j, boundary))
    # JAX's worked cases: decay 0.5, min 2
    half = RankSchedule(policy="decay", decay=0.5, min_rank=2)
    expect = {6: {"wq": 3}, 3: {"wq": 2}, 2: {}}
    if rank in expect and (decay, min_rank) == (0.5, 2):
        assert rank_adapt.plan_rank_map(bridge.from_numpy(p), half, boundary=1) == expect[rank]
        assert rank_adapt.plan_rank_map(bridge.from_numpy(p), half, boundary=0) == {}


def test_energy_policy_matches_jax():
    # spectrum [10, 10, 1e-3, ...]: 99.99..% of the squared mass in two modes
    diag = jnp.full((12,), 1e-3).at[:2].set(10.0)
    w = jnp.zeros((16, 12)).at[:12, :12].set(jnp.diag(diag))
    u, v = jsvd.svd_decompose(w, 8)
    uf, vf = jsvd.svd_decompose(jnp.eye(16, 12) * 3.0, 8)
    cases = {"peaked": {"wq": {"u": u, "v": v}}, "flat": {"wq": {"u": uf, "v": vf}},
             "stacked": {"wq": {"u": jnp.stack([u, uf]), "v": jnp.stack([v, vf])}},
             "random": _toy(rank=10, seed=3), "random_stack": _toy(rank=10, seed=5, stack=(3,))}
    for name, tree in cases.items():
        tree = jax.tree_util.tree_map(np.asarray, tree)
        for thr in (0.5, 0.9, 0.98, 1.0):
            kw = dict(policy="energy", energy_threshold=thr, min_rank=2)
            got = rank_adapt.plan_rank_map(bridge.from_numpy(tree), RankSchedule(**kw), 1)
            assert got == jrank_adapt.plan_rank_map(tree, jrank_adapt.RankSchedule(**kw), 1), \
                (name, thr)
    sched = RankSchedule(policy="energy", energy_threshold=0.9, min_rank=2)
    assert rank_adapt.plan_rank_map(bridge.from_numpy(cases["peaked"]), sched, 1) == {"wq": 2}
    flat = RankSchedule(policy="energy", energy_threshold=1.0, min_rank=2)
    assert rank_adapt.plan_rank_map(bridge.from_numpy(cases["flat"]), flat, 1).get("wq", 8) >= 7
    assert rank_adapt.plan_rank_map(bridge.from_numpy(cases["stacked"]), sched, 1).get("wq", 8) > 2


def test_decay_rank_maps_match_jax():
    shapes = {"a": {"u": (2, 64, 16), "v": (2, 16, 64)}, "b": {"u": (64, 10), "v": (10, 32)}}
    meta = {g: {k: torch.empty(s, device="meta") for k, s in d.items()} for g, d in shapes.items()}
    sds = {g: {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in d.items()}
           for g, d in shapes.items()}
    for kw in (dict(policy="decay", decay=0.5, min_rank=2, start_boundary=2),
               dict(policy="decay", decay=0.75, min_rank=3), dict()):
        got = rank_adapt.decay_rank_maps(meta, RankSchedule(**kw), 4)
        assert got == jrank_adapt.decay_rank_maps(sds, jrank_adapt.RankSchedule(**kw), 4)
    assert rank_adapt.decay_rank_maps(meta, RankSchedule(policy="decay", decay=0.5,
                                                         min_rank=2, start_boundary=2), 4) \
        == [{"a": 16, "b": 10}, {"a": 8, "b": 5}, {"a": 4, "b": 2}, {"a": 2, "b": 2}]
    assert rank_adapt.live_rank_map(meta) == {"a": 16, "b": 10}


# --------------------------------------------------------------------------
# truncation and slicing
# --------------------------------------------------------------------------

def test_truncate_params_matches_jax():
    p = {"layer": _toy(rank=6), "emb": np.ones((32, 16), np.float32),
         "blk": _toy(rank=9, seed=4, stack=(2,))["wq"]}
    rank_map = {"layer/wq": 3, "blk": 5, "missing": 2}
    jt = jrank_adapt.truncate_params(p, rank_map)
    tp = bridge.from_numpy(p)
    tt = rank_adapt.truncate_params(tp, rank_map)
    assert tuple(tt["layer"]["wq"]["u"].shape) == (16, 3)
    assert tuple(tt["layer"]["wq"]["v"].shape) == (3, 12)
    assert tuple(tt["blk"]["u"].shape) == (2, 16, 5) and tuple(tt["blk"]["v"].shape) == (2, 5, 12)
    assert tt["emb"] is tp["emb"] and tt["layer"]["wq"]["bias"] is tp["layer"]["wq"]["bias"]
    for path, jg in (("layer/wq", jt["layer"]["wq"]), ("blk", jt["blk"])):
        g = dict(iter_factor_groups(tt))[path]
        assert _rel((g["u"] @ g["v"]).numpy(), np.asarray(jg["u"] @ jg["v"])) <= TOL, path
        # the same factors, signs included, on this host
        assert _rel(g["u"].numpy(), jg["u"]) <= STATE_TOL and _rel(g["v"].numpy(), jg["v"]) <= STATE_TOL
    # a rank at or above the live one leaves the group as it is
    same = rank_adapt.truncate_params(tp, {"layer/wq": 6})
    assert same["layer"]["wq"] is tp["layer"]["wq"]


def test_slice_tree_and_moments_cut_owned_copies():
    rank_map = {"layer/wq": 3, "blk": 4}
    mu = {"layer": {"wq": {"u": np.arange(96, dtype=np.float32).reshape(16, 6), "v": None,
                           "bias": np.ones(12, np.float32)},
                    "norm": {"scale": np.ones(16, np.float32)}},
          "blk": {"u": np.ones((2, 16, 6), np.float32), "v": np.ones((2, 6, 12), np.float32)},
          "emb": np.ones((32, 16), np.float32)}
    want = jrank_adapt.slice_tree(mu, rank_map)
    tmu = bridge.from_numpy(mu)
    got = rank_adapt.slice_tree(tmu, rank_map)
    assert got["layer"]["wq"]["v"] is None
    assert got["layer"]["wq"]["bias"] is tmu["layer"]["wq"]["bias"]
    for a, b in zip(freezing.tree_leaves(_by_path(got)), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b)
    for cut in (got["layer"]["wq"]["u"], got["blk"]["u"], got["blk"]["v"]):
        assert cut.is_contiguous() and cut.device.type == "cpu"
        # a copy of the kept slice, not a view holding the untruncated storage
        assert cut.untyped_storage().nbytes() == cut.numel() * cut.element_size()
    assert tuple(got["blk"]["u"].shape) == (2, 16, 4) and tuple(got["blk"]["v"].shape) == (2, 4, 12)
    mu2, nu2 = rank_adapt.slice_moments((tmu, ()), rank_map)
    assert nu2 == () and tuple(mu2["layer"]["wq"]["u"].shape) == (16, 3)


def test_truncate_factors_eckart_young_property():
    """On random pairs the QR-reduced truncation matches the error of the
    optimal SVD of the product, beats dropping trailing columns, and its
    error does not grow with the rank."""
    for seed in (0, 1, 2):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        u = torch.from_numpy(np.array(jax.random.normal(k1, (40, 10), jnp.float32)))
        v = torch.from_numpy(np.array(jax.random.normal(k2, (10, 24), jnp.float32)))
        w = u @ v
        errs = []
        for r in (2, 5, 8):
            u2, v2 = svd.truncate_factors(u, v, r)
            e = svd.reconstruction_error(w, u2, v2).item()
            ur, vr = svd.svd_decompose(w, r)
            assert e <= svd.reconstruction_error(w, ur, vr).item() * (1 + 1e-3) + 1e-6
            assert e <= svd.reconstruction_error(w, u[:, :r], v[:r, :]).item() + 1e-6
            errs.append(e)
        assert errs == sorted(errs, reverse=True)


def test_midtrain_truncation_matches_fresh_decompose_and_jax():
    """A TRAINED group truncated to rank r in flight is a fresh rank-r
    decomposition of its merged product (products and loss within
    STATE_TOL, JAX's bound), and JAX's truncation of the same params."""
    jrun, trun = _runs()
    jstate, _ = _jax_trained(jrun, 3)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tparams = bridge.from_numpy(params)
    sched = RankSchedule(policy="decay", decay=0.5, min_rank=2)
    rank_map = rank_adapt.plan_rank_map(tparams, sched, boundary=1)
    assert len(rank_map) == 7
    assert rank_map == jrank_adapt.plan_rank_map(
        params, jrank_adapt.RankSchedule(policy="decay", decay=0.5, min_rank=2), 1)
    truncated = rank_adapt.truncate_params(tparams, rank_map)

    def fresh_group(path, group):
        r = rank_map.get(path)
        if r is None:
            return group
        u2, v2 = svd.svd_decompose(group["u"].float() @ group["v"].float(), r)
        return dict(group, u=u2.to(group["u"].dtype), v=v2.to(group["v"].dtype))

    fresh = dict(iter_factor_groups(map_factor_groups(tparams, fresh_group)))
    jtrunc = dict(j_iter_groups(jrank_adapt.truncate_params(params, rank_map)))
    for path, g in iter_factor_groups(truncated):
        w = (g["u"] @ g["v"]).numpy()
        assert _rel(w, (fresh[path]["u"] @ fresh[path]["v"]).numpy()) <= STATE_TOL, path
        assert _rel(w, np.asarray(jtrunc[path]["u"] @ jtrunc[path]["v"])) <= TOL, path
        assert _rel(g["u"].numpy(), jtrunc[path]["u"]) <= STATE_TOL, path  # signs agree
    batch = bridge.batch_from_numpy(_batch(trun, seed=99))

    def loss(p):
        return steps._loss_fn(p, freezing.partition(p, -1)[1], batch, trun, -1).item()

    assert abs(loss(truncated) - loss(map_factor_groups(tparams, fresh_group))) <= STATE_TOL


# --------------------------------------------------------------------------
# repartition_state(schedule=...)
# --------------------------------------------------------------------------

def _shapes(tree):
    return freezing.tree_map(lambda t: tuple(t.shape), tree)


def _jshapes(tree):
    """JAX tree shapes as nested dicts with None holes (JAX sorts keys)."""
    if isinstance(tree, dict):
        return {k: _jshapes(v) for k, v in tree.items()}
    return None if tree is None else tuple(tree.shape)


def test_repartition_truncates_every_downstream_structure():
    jrun, trun = _runs(microbatches=2, rank_schedule="decay", decay=0.75)
    schedule = rank_adapt.schedule_from_config(trun.lrd)
    jschedule = jrank_adapt.schedule_from_config(jrun.lrd)
    jstate, jparked = _jax_trained(jrun, 2)
    state, parked = bridge.train_state_from_jax(jstate, jparked)
    ranks0 = rank_adapt.live_rank_map(state.params)
    bytes0 = steps.partition_bytes(state)
    train_step = steps.build_train_step(trun, device="cpu")
    jmesh = make_host_mesh(1, 1)
    for boundary, phase in ((1, 1), (2, 0)):
        # both packages swap the same state (adamw steps drift apart near
        # zero gradients, test_torch_train.py's ADAMW_PARAM_TOL)
        state, parked = bridge.train_state_from_jax(jstate, jparked)
        jstate, jparked = jsteps.repartition_state(jrun.optim, jstate, jparked, phase,
                                                   schedule=jschedule, boundary=boundary)
        state, parked = steps.repartition_state(trun.optim, state, parked, phase,
                                                schedule=schedule, boundary=boundary)
        ranks = rank_adapt.live_rank_map(state.params)
        assert ranks == jrank_adapt.live_rank_map(jstate.params)
        assert all(ranks[p] < ranks0[p] for p in ranks0), (ranks0, ranks)
        assert steps.partition_bytes(state) == jsteps.partition_bytes(jstate)
        # moments mirror the truncated trainable partition, parked slices
        # the frozen one, on the CPU, each cut leaf owning its storage
        tr_shapes = _shapes(state.trainable)
        assert _shapes(state.opt.mu) == tr_shapes == _shapes(state.opt.nu)
        assert _shapes(parked[0]) == _shapes(state.frozen) == _shapes(parked[1])
        assert _jshapes(state.trainable) == _jshapes(jstate.trainable)
        for leaf in freezing.tree_leaves(parked):
            assert leaf.device.type == "cpu"
        for leaf in freezing.tree_leaves((state.opt.mu, state.opt.nu, parked)):
            assert leaf.untyped_storage().nbytes() == leaf.numel() * leaf.element_size()
        jg = dict(j_iter_groups(jstate.params))
        for path, g in iter_factor_groups(state.params):
            want = np.asarray(jg[path]["u"]) @ np.asarray(jg[path]["v"])
            assert _rel((g["u"] @ g["v"]).numpy(), want) <= TOL, path
        jmu = jfreezing.merge_moments((jstate.opt.mu, jstate.opt.nu), jparked)
        tmu = freezing.merge_moments((state.opt.mu, state.opt.nu), parked)
        for a, b in zip(freezing.tree_leaves(_by_path(tmu)), freezing.tree_leaves(_by_path(jmu))):
            np.testing.assert_array_equal(_np(a), _np(b))  # slices of the same moments
        # the step (2 microbatches: grads summed over them) runs at the new shapes
        new, m = train_step(state, _batch(trun, seed=boundary), phase=phase)
        assert np.isfinite(m["loss"].item())
        assert _shapes(new.trainable) == tr_shapes and _shapes(new.opt.mu) == tr_shapes
        jstate, _ = jax.jit(functools.partial(jsteps.build_train_step(jrun, jmesh), phase=phase))(
            jstate, {k: jnp.asarray(v) for k, v in _batch(jrun, seed=boundary).items()})
        ranks0 = ranks
    bytes2 = steps.partition_bytes(new)
    assert bytes2["trainable_bytes"] + bytes2["opt_bytes"] < bytes0["trainable_bytes"] + \
        bytes0["opt_bytes"]


def _by_path(tree, path=""):
    """Leaves keyed by path, sorted (JAX's trees sort their keys)."""
    if isinstance(tree, (list, tuple)):
        return {f"{path}/{i}": _by_path(v, f"{path}/{i}") for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _by_path(tree[k], f"{path}/{k}") for k in sorted(tree)}
    return tree


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------

def _rank_lines(out):
    return [ast.literal_eval(line.split(": ", 1)[1]) for line in out.splitlines()
            if line.startswith("[rank-adapt] boundary")]


@pytest.mark.parametrize("schedule", ["decay", "energy"])
def test_train_cli_rank_schedule_matches_jax(schedule, capsys, monkeypatch, tmp_path):
    """JAX trains 6 steps with the schedule, saving at step 2; the port
    resumes from that checkpoint and crosses the same two boundaries (steps
    2 and 4): the same shrunk groups at each, its truncated products
    JAX's, JAX's losses, and at the end JAX's rank map and products.  At
    each boundary the port goes on from JAX's truncated factors (module
    docstring: signs)."""
    argv = [*SMOKE, "--rank-schedule", schedule, "--steps", "6", "--save-every", "2"]
    jstate, jlosses = jtrain.main([*argv, "--ckpt-dir", str(tmp_path / "jax")])
    jmaps = _rank_lines(capsys.readouterr().out)
    step2 = "smollm-360m-smoke/step_00000002"
    shutil.copytree(tmp_path / "jax" / step2, tmp_path / "port" / step2)
    own = rank_adapt.truncate_params

    def jax_truncation(params, rank_map):
        got = own(params, rank_map)
        want = jrank_adapt.truncate_params(bridge.to_numpy(params), rank_map)
        jg = dict(j_iter_groups(want))
        for path, g in iter_factor_groups(got):
            # trained smoke groups have nearly flat spectra: the truncation's
            # float32 conditioning (sigma_1 over the gap at the new rank)
            # reaches 1e-5 here, so the mid-train bound
            assert _rel((g["u"] @ g["v"]).numpy(), np.asarray(jg[path]["u"] @ jg[path]["v"])) \
                <= STATE_TOL, path
        return bridge.from_numpy(jax.tree_util.tree_map(np.asarray, want))

    monkeypatch.setattr(rank_adapt, "truncate_params", jax_truncation)
    seen = []
    state, losses = train.main(["--device", "cpu", *argv, "--ckpt-dir", str(tmp_path / "port")],
                               on_step=lambda step, phase, m: seen.append((step, m["rank_map"])))
    maps = _rank_lines(capsys.readouterr().out)
    assert len(jmaps) == 2 and maps == jmaps
    assert [s for s, _ in seen] == [2, 3, 4, 5]
    np.testing.assert_allclose(losses, jlosses[2:], rtol=TOL, atol=TOL)
    final = rank_adapt.live_rank_map(state.params)
    assert final == jrank_adapt.live_rank_map(jstate.params) == seen[-1][1]
    # products, not factors: JAX's truncation of the two runs' (1e-6 apart)
    # params may rotate a pair of nearly equal singular vectors
    jg = dict(j_iter_groups(jstate.params))
    for path, g in iter_factor_groups(state.params):
        want = np.asarray(jg[path]["u"]) @ np.asarray(jg[path]["v"])
        assert _rel((g["u"] @ g["v"]).numpy(), want) <= STATE_TOL, path


def test_trainable_byte_trajectory_matches_bench_rank_adaptation():
    """The structural numbers of ``BENCH_rank_adaptation.json`` at its
    configuration (smoke smollm-360m, 4 x 32 tokens, adamw, 4 epochs of 8
    steps, decay 0.75): trainable-partition bytes (params + float32 grads +
    moments) and total rank per epoch, fixed ranks and decay."""
    rows = json.loads((ROOT / "benchmarks/results/BENCH_rank_adaptation.json").read_text())
    for variant in ("fixed", "decay"):
        _, trun = _runs(rank_schedule="decay" if variant == "decay" else "none", lr=1e-3)
        schedule = rank_adapt.schedule_from_config(trun.lrd)
        state, parked = steps.make_train_state(trun.optim, bridge.from_numpy(_init_params()), 0)
        train_step = steps.build_train_step(trun, device="cpu")
        data = iter(LMBatchIterator(trun.model.vocab_size, 32, 4, seed=17))
        got, cur = [], 0
        for epoch in range(4):
            phase = epoch % 2
            if phase != cur:
                state, parked = steps.repartition_state(
                    trun.optim, state, parked, phase,
                    schedule=schedule if schedule.active else None, boundary=epoch)
                cur = phase
            trainable = freezing.tree_leaves(state.trainable)
            nbytes = (sum(t.numel() * t.element_size() for t in trainable)
                      + sum(t.numel() * 4 for t in trainable)
                      + sum(t.numel() * t.element_size()
                            for t in freezing.tree_leaves((state.opt.mu, state.opt.nu))))
            got.append((epoch, phase, sum(rank_adapt.live_rank_map(state.params).values()),
                        nbytes))
            for _ in range(8):
                state, m = train_step(state, next(data), phase=phase)
                assert np.isfinite(m["loss"].item())
        want = [(r["epoch"], r["phase"], r["total_rank"], r["trainable_partition_bytes"])
                for r in rows if r["variant"] == variant and not r.get("summary")]
        assert got == want
    assert [b for *_, b in got] == [568320, 467968, 427008, 369664]


# --------------------------------------------------------------------------
# checkpoints at truncated ranks
# --------------------------------------------------------------------------

def test_checkpoint_rank_map_roundtrip_and_guard(tmp_path):
    jrun, trun = _runs(rank_schedule="decay", decay=0.5)
    jstate, jparked = _jax_trained(jrun, 1)
    state, parked = bridge.train_state_from_jax(jstate, jparked)
    state, parked = steps.repartition_state(trun.optim, state, parked, 1,
                                            schedule=rank_adapt.schedule_from_config(trun.lrd),
                                            boundary=1)
    rank_map = rank_adapt.live_rank_map(state.params)
    store.save_checkpoint(tmp_path, 5, store.pack_phased_state(state, parked),
                          extra={"phase": 1, "rank_map": rank_map})
    saved, step_n, extra = store.load_checkpoint(store.latest_checkpoint(tmp_path))
    assert step_n == 5 and {p: int(r) for p, r in extra["rank_map"].items()} == rank_map
    assert store.live_rank_map(saved) == rank_map == store.live_rank_map(saved["params"])
    (tr, fr, _), _ = store.unpack_phased_state(saved, 1, expect_rank_map=rank_map)
    assert rank_adapt.live_rank_map(freezing.merge(tr, fr)) == rank_map
    wrong = dict(rank_map)
    wrong[next(iter(wrong))] += 1
    with pytest.raises(ValueError, match="rank"):
        store.unpack_phased_state(saved, 1, expect_rank_map=wrong)


def test_train_cli_resumes_at_truncated_ranks(tmp_path):
    """A run saved after a boundary resumes at the saved (truncated) ranks
    and goes on as the straight run does; a manifest whose rank map
    disagrees with the leaves is refused."""
    argv = ["--device", "cpu", *SMOKE, "--rank-schedule", "decay", "--save-every", "3"]
    _, straight = train.main([*argv, "--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    _, first = train.main([*argv, "--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    ckpt = store.latest_checkpoint(tmp_path / "b" / "smollm-360m-smoke")
    saved_map = json.loads((ckpt / "manifest.json").read_text())["extra"]["rank_map"]
    assert saved_map["stack/attn/wq"] == 12  # truncated at step 2 (16 -> 12)
    seen = []
    state, rest = train.main([*argv, "--steps", "6", "--ckpt-dir", str(tmp_path / "b")],
                             on_step=lambda step, phase, m: seen.append((step, m["rank_map"])))
    assert seen[0] == (3, saved_map) and [s for s, _ in seen] == [3, 4, 5]
    np.testing.assert_allclose(first + rest, straight, rtol=TOL, atol=TOL)
    assert rank_adapt.live_rank_map(state.params)["stack/attn/wq"] == 9
    shutil.copytree(ckpt, tmp_path / "c" / "smollm-360m-smoke" / ckpt.name)
    manifest = tmp_path / "c" / "smollm-360m-smoke" / ckpt.name / "manifest.json"
    doc = json.loads(manifest.read_text())
    doc["extra"]["rank_map"]["stack/attn/wq"] = 16
    manifest.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="rank map"):
        train.main([*argv, "--steps", "6", "--ckpt-dir", str(tmp_path / "c")])
