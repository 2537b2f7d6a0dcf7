"""Sharded, freezing-aware training of the port (``launch/steps.py`` with
a mesh, ``kernels/ops.py``'s sharded dispatch, ``distributed/``) on the
CPU, against the JAX package.

As ``tests/test_sharded_train.py`` runs its checks in ONE 8-device
subprocess, this file runs one group of 4 gloo ranks that does every check
and writes what it saw; the tests read it.  Params are made once in JAX
(smoke smollm-360m, float32, LRD at Eq.-5 ranks) and carried to the ranks
through ``repro_torch.bridge``; the batch is made from a seed with numpy.
Each test names the contract of ``tests/test_sharded_train.py`` it
mirrors:

* PLACEMENT_OK — ``check_state_placement`` on (2, 2) and (4, 1), and every
  leaf's local shape is the block JAX's ``param_specs`` imply, under the
  TP-only, FSDP and zero1 layouts (the latter two with their gradients);
* the loss and gradients of a step on (2, 2) at phases -1 / 0 / 1 within
  1e-5 / 1e-4 of JAX's single-device step (sgdm from zero momentum: the
  first step's momentum is the gradient);
* FROZEN_COLLECTIVE_OK — on (4, 1) the sync bytes of phases 0 and 1 are
  strictly below phase -1's and equal to those JAX's placements imply, and
  no collective serves a frozen leaf's path (on any mesh: under TP,
  ``FROZEN_PARAM_RULES`` splits wo/u and down/u's input dim over
  ``model``, and those are gathered over ``model`` only, never ``data``);
* INT8_PSUM_OK — with int8 compression on (4, 1) the wire carries int8 for
  every trainable grad and nothing for a frozen one; on (2, 2) it warns
  once and syncs uncompressed;
* KERNEL_SHMAP_OK — the sharded K1 / K5 dispatch forward and backward
  against the plain unsharded version at freeze_group None / 0 / 1, with
  dU or dV, and its all-reduce, absent when frozen;
* ELASTIC_OK — a 1-rank checkpoint restored on (2, 2) gives a next loss
  within 1e-5 of the 1-rank continuation;
* RANK_SYNC_OK — under a decaying rank schedule on (4, 1) the sync bytes
  strictly decrease at every boundary;
* ``count_step``'s collective bytes are the step's records.

About 40 s on the CPU (the 4 ranks' imports, their 30 steps and JAX's three
compiles)."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro.core import freezing as jfreezing
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
ENV = {"PYTHONPATH": os.pathsep.join(filter(None, [SRC, os.environ.get("PYTHONPATH")]))}
TOL, GRAD_TOL = 1e-5, 1e-4
SEQ, BATCH = 32, 8

_WORKER = r'''
import dataclasses, json, os, sys, warnings
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch import bridge
from repro_torch.analysis import cost
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro_torch.core import freezing, rank_adapt
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import axis_rules
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.optimizers import OptState

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
d = sys.argv[1]
collectives.init_process_group("gloo", "env://", rank, world)
flat = np.load(d + "/params.npz")
params = {}
for k in flat.files:
    node = params
    *head, leaf = k.split("/")
    for h in head:
        node = node.setdefault(h, {})
    node[leaf] = flat[k]
params = bridge.from_numpy(params)
b = np.load(d + "/batch.npz")
batch = {"tokens": b["tokens"], "labels": b["labels"]}
run = RunConfig(model=get_smoke_config("smollm-360m"), shape=ShapeConfig("t", %(seq)d, %(batch)d, "train"),
                lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False, freeze_mode="sequential",
                              use_pallas_kernel=True),
                dist=DistConfig(fsdp=False, remat="none"),
                optim=OptimConfig(name="sgdm", lr=1e-2, warmup_steps=2, total_steps=8))
out = {"placement": {}, "loss": {}, "sync": {}, "int8": {}, "dispatch": {}}
arrays = {}
rec = lambda log: [[c.op, c.dtype, c.bytes, c.path, list(c.axes)] for c in log]

def shapes_of(tree, path=""):
    if isinstance(tree, dict):
        o = {}
        for k, v in tree.items():
            o.update(shapes_of(v, f"{path}/{k}" if path else k))
        return o
    return {} if tree is None else {path: list(tree.shape)}

meshes = {"2x2": make_host_mesh(2, 2), "4x1": make_host_mesh(4, 1)}
for name, mesh in meshes.items():
    train = steps.build_train_step(run, "cpu", mesh=mesh)
    for phase in (-1, 0, 1):
        st, parked = steps.make_sharded_train_state(run, params, phase, mesh)
        steps.check_state_placement(run, mesh, st)
        out["placement"][f"{name}/{phase}"] = {
            "trainable": shapes_of(st.trainable), "frozen": shapes_of(st.frozen),
            "mu": shapes_of(st.opt.mu)}
        with collectives.recording() as log:
            st2, m = train(st, batch, phase=phase)
        steps.check_state_placement(run, mesh, st2)
        out["sync"][f"{name}/{phase}"] = rec(log)
        out["loss"][f"{name}/{phase}"] = [float(m["loss"]), float(m["grad_norm"])]
        whole, _ = steps.gather_state(st2, parked, run, mesh)
        if name == "2x2":
            def walk(t, path=""):
                if isinstance(t, dict):
                    for k, v in t.items():
                        walk(v, f"{path}/{k}" if path else k)
                elif t is not None:
                    arrays[f"grad/{phase}/{path}"] = t.numpy()
            walk(whole.opt.mu)

# the FSDP and zero1 layouts: one step each
out["layouts"] = {}
for layout, name, phase in (("fsdp", "4x1", 0), ("zero1", "2x2", 1)):
    mesh = meshes[name]
    run_l = dataclasses.replace(run, dist=dataclasses.replace(run.dist, fsdp=True,
                                                              param_layout=layout))
    st, parked = steps.make_sharded_train_state(run_l, params, phase, mesh)
    steps.check_state_placement(run_l, mesh, st)
    key = f"{layout}/{name}/{phase}"
    out["layouts"][key] = {"trainable": shapes_of(st.trainable), "mu": shapes_of(st.opt.mu)}
    with collectives.recording() as log:
        st, m = steps.build_train_step(run_l, "cpu", mesh=mesh)(st, batch, phase=phase)
    steps.check_state_placement(run_l, mesh, st)
    out["layouts"][key].update(log=rec(log), loss=float(m["loss"]))
    whole, _ = steps.gather_state(st, parked, run_l, mesh)
    for p, t in shapes_of(whole.opt.mu).items():
        node = whole.opt.mu
        for k in p.split("/"):
            node = node[k]
        arrays[f"layout/{key}/{p}"] = node.numpy()

# int8 compression: pure DP compresses, TP warns once and does not
run8 = dataclasses.replace(run, dist=dataclasses.replace(run.dist, grad_compression="int8"))
for name, mesh in meshes.items():
    with warnings.catch_warnings(record=True) as wrec:
        warnings.simplefilter("always")
        tr8 = steps.build_train_step(run8, "cpu", mesh=mesh)
        steps.build_train_step(run8, "cpu", mesh=mesh)  # a second build warns no more
    out["int8"][f"{name}/warnings"] = [str(w.message) for w in wrec if "pure-DP" in str(w.message)]
    for phase in (0, 1):
        st, _ = steps.make_sharded_train_state(run8, params, phase, mesh)
        with collectives.recording() as log, ops.capture_fallbacks() as fbs:
            st, m = tr8(st, batch, phase=phase)
        out["int8"][f"{name}/{phase}"] = {
            "log": rec(log), "loss": float(m["loss"]),
            "dispatch": sorted({(f.op, f.reason, f.shape[0]) for f in fbs})}

# the sharded K1 / K5 dispatch against the plain unsharded version
mesh = meshes["2x2"]
g = torch.Generator().manual_seed(7)
M, C, R, S = 16, 32, 8, 64
x = torch.randn(M, C, generator=g) * 0.5
fac = {k: torch.randn(*shp, generator=g) * 0.5 for k, shp in
       (("u", (C, R)), ("v", (R, S)), ("gu", (C, R)), ("gv", (R, S)), ("uu", (C, R)), ("uv", (R, S)))}
di = collectives.coordinate(mesh, ("data",))
mi = collectives.coordinate(mesh, ("model",))
rows = slice(di * M // 2, (di + 1) * M // 2)
cols = slice(mi * S // 2, (mi + 1) * S // 2)
for kind in ("lowrank", "ffn"):
    for fg in (None, 0, 1):
        names = ("u", "v") if kind == "lowrank" else ("gu", "gv", "uu", "uv")
        whole = {k: fac[k].clone().requires_grad_(i %% 2 != fg) for i, k in enumerate(names)}
        local = {k: (fac[k][:, cols] if i %% 2 else fac[k]).clone().contiguous().requires_grad_(i %% 2 != fg)
                 for i, k in enumerate(names)}
        xl = x[rows].clone().requires_grad_(True)
        xw = x.clone().requires_grad_(True)
        leaves = {k: (local[k], bool(i %% 2)) for i, k in enumerate(names)}
        with collectives.recording() as log, ops.capture_fallbacks() as fbs, \
                axis_rules(mesh, rows=("data",), leaves=leaves):
            if kind == "lowrank":
                y = ops.lowrank_apply(xl, local["u"], local["v"], use_kernel=True, freeze_group=fg)
            else:
                y = ops.lowrank_ffn_apply(xl, *(local[k] for k in names), use_kernel=True,
                                          freeze_group=fg)
            (y ** 2).sum().backward()
        if kind == "lowrank":
            yw = ref.lowrank_matmul_ref(xw, whole["u"], whole["v"])
        else:
            yw = ref.lowrank_gated_ffn_ref(xw, *(whole[k] for k in names))
        (yw ** 2).sum().backward()
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
        errs = {"y": rel(y, yw[rows]), "dx": rel(xl.grad, xw.grad[rows])}
        for i, k in enumerate(names):
            if i %% 2 == fg:
                errs[k] = None if local[k].grad is None else -1.0
            elif i %% 2:
                errs[k] = rel(local[k].grad, whole[k].grad[:, cols])
            else:
                errs[k] = rel(local[k].grad, whole[k].grad)
        out["dispatch"][f"{kind}/{fg}"] = {"errs": errs, "log": rec(log),
                                           "ops": sorted({f.op for f in fbs})}

# elastic: a 1-rank checkpoint restored on (2, 2)
one = steps.build_train_step(run, "cpu")
s1, p1 = steps.make_train_state(run.optim, params, 0)
for _ in range(2):
    s1, _ = one(s1, batch, phase=0)
if rank == 0:
    store.save_checkpoint(d + "/ckpt", 2, store.pack_phased_state(s1, p1), extra={"phase": 0})
_, mA = one(s1, batch, phase=0)
collectives.any_rank(False, meshes["2x2"])  # the save is on disk before any rank reads it
saved, step_n, extra = store.load_checkpoint(store.latest_checkpoint(d + "/ckpt"))
mesh = meshes["2x2"]
shapes = steps.meta_like(saved["params"])
placed = steps.place_packed(saved, steps.packed_state_shardings(run, mesh, 0), "cpu")
(tr, fr, (stp, mu, nu)), parked = store.unpack_phased_state(placed, 0)
st = steps.TrainState(tr, fr, OptState(stp, mu, nu), shapes)
steps.check_state_placement(run, mesh, st)
_, mB = steps.build_train_step(run, "cpu", mesh=mesh)(st, batch, phase=0)
out["elastic"] = [step_n, float(mA["loss"]), float(mB["loss"]),
                  all(not isinstance(t, torch.Tensor) or t.device.type == "cpu"
                      for t in freezing.tree_leaves(parked))]

# rank adaptation on (4, 1): sync bytes shrink at every boundary
mesh = meshes["4x1"]
run_ra = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, rank_schedule="decay",
                                                          rank_decay=0.75, rank_min=2))
sched = rank_adapt.schedule_from_config(run_ra.lrd)
train_ra = steps.build_train_step(run_ra, "cpu", mesh=mesh)
st, parked = steps.make_sharded_train_state(run_ra, params, 0, mesh)
segs = []
for epoch in range(4):
    phase = epoch %% 2
    if epoch:
        st, parked = steps.repartition_state(run_ra.optim, st, parked, phase, mesh=mesh, run=run_ra,
                                             schedule=sched, boundary=epoch)
    steps.check_state_placement(run_ra, mesh, st)
    with collectives.recording() as log:
        st, m = train_ra(st, batch, phase=phase)
    segs.append([sum(c.bytes for c in log), sum(rank_adapt.live_rank_map(st.shapes).values()),
                 float(m["loss"])])
out["rank_adapt"] = segs

# count_step reads the step's records
mesh = meshes["4x1"]
st, _ = steps.make_sharded_train_state(run, params, 0, mesh)
train = steps.build_train_step(run, "cpu", mesh=mesh)
with collectives.recording() as log:
    c = cost.count_step(train, st, batch, phase=0)
out["count_step"] = [c.collective_bytes, c.collective_bytes_by_dtype,
                     collectives.by_op(log), collectives.by_op_dtype(log)]

json.dump(out, open(d + f"/out{rank}.json", "w"))
np.savez(d + f"/arrays{rank}.npz", **arrays)
collectives.destroy_process_group()
''' % {"seq": SEQ, "batch": BATCH}


def _torchrun(args, n, *, timeout, env):
    """``python -m torch.distributed.run --standalone`` with ``n`` ranks on
    ``args``: (return code, stdout, stderr), each rank's lines prefixed
    ``[default<rank>]:``.  A failed rank stops the others and fails the run;
    past ``timeout`` the launcher is stopped, which stops its ranks."""
    p = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          f"--nproc-per-node={n}", "--tee=3", *args],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=dict(os.environ, **env))
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.terminate()
        out, err = p.communicate()
    return p.returncode, out, err


def _jrun():
    return RunConfig(
        model=get_smoke_config("smollm-360m"), shape=ShapeConfig("t", SEQ, BATCH, "train"),
        lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False, freeze_mode="sequential"),
        dist=DistConfig(fsdp=False, remat="none"),
        optim=OptimConfig(name="sgdm", lr=1e-2, warmup_steps=2, total_steps=8))


@functools.lru_cache(maxsize=None)
def _params():
    params, plan = jsteps.init_params(_jrun(), jax.random.PRNGKey(0))
    assert sum(lp.use_decomposed for lp in plan.layers.values()) == 7
    return jax.tree_util.tree_map(np.asarray, params)


def _batch():
    rng = np.random.default_rng(0)
    vocab = get_smoke_config("smollm-360m").vocab_size
    return {"tokens": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {} if tree is None else {path: np.asarray(tree)}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    np.savez(d / "params.npz", **_flat(_params()))
    np.savez(d / "batch.npz", **_batch())
    rc, _, err = _torchrun(["--no-python", sys.executable, "-c", _WORKER, str(d)], 4,
                           timeout=600, env=ENV)
    assert rc == 0, err[-4000:]
    outs = [json.load(open(d / f"out{r}.json")) for r in range(4)]
    return outs, dict(np.load(d / "arrays0.npz"))


def _mesh(shape):
    from types import SimpleNamespace
    return SimpleNamespace(axis_names=("data", "model"), devices=np.empty(shape, object))


def _jax_partition(phase):
    return jfreezing.partition(_params(), phase)


def _local(shape, spec, sizes):
    out = list(shape)
    for i, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            out[i] //= sizes[a]
    return out


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_placement_local_shapes_are_jax_specs_blocks(group, mesh, phase):
    """PLACEMENT_OK: trainable under the param rules, frozen under
    FROZEN_PARAM_RULES, moments under the optimizer rules, every rank."""
    outs, _ = group
    shape = tuple(int(n) for n in mesh.split("x"))
    sizes = dict(zip(("data", "model"), shape))
    tr, fr = _jax_partition(phase)
    for part, tree, rules in (("trainable", tr, jsh.PARAM_RULES_NO_FSDP),
                              ("frozen", fr, jsh.FROZEN_PARAM_RULES),
                              ("mu", tr, jsh.PARAM_RULES_NO_FSDP)):
        specs = _flat_specs(jsh.param_specs(tree, _mesh(shape), rules))
        want = {p: _local(_flat(tree)[p].shape, s, sizes) for p, s in specs.items()}
        for out in outs:
            assert out["placement"][f"{mesh}/{phase}"][part] == want, part
    if phase >= 0:
        assert outs[0]["placement"][f"{mesh}/{phase}"]["frozen"]
    # something is sharded on every mesh
    assert any(_flat(tr)[p].shape != tuple(s) for p, s in
               outs[0]["placement"][f"{mesh}/{phase}"]["trainable"].items())


def _flat_specs(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(k.key for k in path): tuple(s) for path, s in flat}


@functools.lru_cache(maxsize=None)
def _jax_step(phase):
    run = _jrun()
    state, _ = jsteps.make_train_state(run.optim, _params(), phase)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    new, m = jax.jit(functools.partial(jsteps.build_train_step(run, make_host_mesh(1, 1)),
                                       phase=phase))(state, jb)
    return float(m["loss"]), float(m["grad_norm"]), _flat(jax.tree_util.tree_map(np.asarray,
                                                                                  new.opt.mu))


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_loss_and_grads_match_jax_single_device(group, phase):
    outs, arrays = group
    loss, gnorm, grads = _jax_step(phase)
    for out in outs:
        got_loss, got_norm = out["loss"][f"2x2/{phase}"]
        assert abs(got_loss - loss) <= TOL * max(1.0, abs(loss)), (got_loss, loss)
        assert abs(got_norm - gnorm) <= GRAD_TOL * max(1.0, gnorm), (got_norm, gnorm)
        assert abs(out["loss"][f"4x1/{phase}"][0] - loss) <= TOL * max(1.0, abs(loss))
    got = {k.split("/", 2)[2]: v for k, v in arrays.items() if k.startswith(f"grad/{phase}/")}
    assert got.keys() == grads.keys() and grads
    for p, g in grads.items():
        np.testing.assert_allclose(got[p], g, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=p)


def _param_paths(log):
    return [e for e in log if e[3] not in ("activation", "loss", "grad_norm")]


def _implied_bytes_4x1(phase):
    """Param-path sync bytes of a (4, 1) step from JAX's placements: each
    trainable leaf sharded over data is all-gathered once (its block's
    bytes), and every trainable leaf's whole gradient is all-reduced over
    data once (the factors' a layer at a time: the same bytes)."""
    tr, _ = _jax_partition(phase)
    specs = _flat_specs(jsh.param_specs(tr, _mesh((4, 1)), jsh.PARAM_RULES_NO_FSDP))
    want = {}
    for p, a in _flat(tr).items():
        sharded = any(e == "data" for e in specs[p])
        local = int(np.prod(_local(a.shape, specs[p], {"data": 4, "model": 1})))
        want[p] = (local * a.itemsize if sharded else 0) + a.size * a.itemsize
    return want


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_sync_bytes_are_what_the_placements_imply(group, phase):
    """FROZEN_COLLECTIVE_OK, part 1: on (4, 1) each path's bytes equal the
    placements' (JAX's specs), and nothing else is synced but the loss and
    the grad norm."""
    outs, _ = group
    for out in outs:
        log = out["sync"][f"4x1/{phase}"]
        got = {}
        for op, dt, nb, path, axes in _param_paths(log):
            got[path] = got.get(path, 0) + nb
            assert axes == ["data"] and dt == "float32"
        assert got == _implied_bytes_4x1(phase)
        assert {e[3] for e in log} - set(got) <= {"loss", "grad_norm"}


@pytest.mark.parametrize("key", ["fsdp/4x1/0", "zero1/2x2/1"])
def test_fsdp_and_zero1_layouts(group, key):
    """PLACEMENT_OK and the gradients under FSDP (params and moments over
    data too) and zero1 (params TP-only, moments over data): the local
    shapes are JAX's specs' blocks, the gradients JAX's single-device
    ones; under FSDP the embedding's gradient is reduce-scattered into its
    block."""
    outs, arrays = group
    layout, mesh, phase = key.split("/")
    phase = int(phase)
    shape = tuple(int(n) for n in mesh.split("x"))
    sizes = dict(zip(("data", "model"), shape))
    tr, _ = _jax_partition(phase)
    prm = jsh.PARAM_RULES if layout == "fsdp" else jsh.PARAM_RULES_NO_FSDP
    for part, rules in (("trainable", prm), ("mu", jsh.PARAM_RULES)):
        specs = _flat_specs(jsh.param_specs(tr, _mesh(shape), rules))
        want = {p: _local(_flat(tr)[p].shape, s, sizes) for p, s in specs.items()}
        for out in outs:
            assert out["layouts"][key][part] == want, part
    loss, _, grads = _jax_step(phase)
    assert abs(outs[0]["layouts"][key]["loss"] - loss) <= TOL * max(1.0, abs(loss))
    got = {k.split("/", 4)[4]: v for k, v in arrays.items() if k.startswith(f"layout/{key}/")}
    assert got.keys() == grads.keys()
    for p, g in grads.items():
        np.testing.assert_allclose(got[p], g, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=p)
    ops = {(e[0], e[3]) for e in outs[0]["layouts"][key]["log"]}
    assert (("reduce-scatter", "embed/embedding") in ops) == (layout == "fsdp")


def test_frozen_phases_sync_strictly_less(group):
    """FROZEN_COLLECTIVE_OK, part 2."""
    outs, _ = group
    for mesh in ("4x1", "2x2"):
        total = {p: sum(e[2] for e in outs[0]["sync"][f"{mesh}/{p}"]) for p in (-1, 0, 1)}
        if mesh == "4x1":
            assert total[0] < total[-1] and total[1] < total[-1], total
        param = {p: sum(e[2] for e in _param_paths(outs[0]["sync"][f"{mesh}/{p}"]))
                 for p in (-1, 0, 1)}
        assert param[0] < param[-1] and param[1] < param[-1], (mesh, param)


@pytest.mark.parametrize("phase", [0, 1])
def test_no_data_collective_at_a_frozen_path(group, phase):
    outs, _ = group
    _, fr = _jax_partition(phase)
    frozen = set(_flat(fr))
    assert frozen
    for out in outs:
        for e in out["sync"][f"4x1/{phase}"] + out["int8"][f"4x1/{phase}"]["log"]:
            assert e[3] not in frozen, e
        for e in out["sync"][f"2x2/{phase}"]:
            # TP only: FROZEN_PARAM_RULES splits wo/u and down/u over model
            assert e[3] not in frozen or (e[0] == "all-gather" and e[4] == ["model"]
                                          and e[3].endswith(("wo/u", "down/u"))), e


@pytest.mark.parametrize("phase", [0, 1])
def test_int8_on_the_wire_for_trainable_paths_only(group, phase):
    """INT8_PSUM_OK on the pure data-parallel mesh."""
    outs, _ = group
    tr, fr = _jax_partition(phase)
    trainable = _flat(tr)
    for out in outs:
        res = out["int8"][f"4x1/{phase}"]
        assert np.isfinite(res["loss"])
        int8 = {e[3]: e[2] for e in res["log"] if e[1] == "int8"}
        assert int8 == {p: a.size for p, a in trainable.items()}
        for op, dt, nb, path, axes in res["log"]:
            assert dt == "int8" or nb == 4 or op == "all-gather", (op, dt, nb, path)
            assert path not in _flat(fr)


@pytest.mark.parametrize("phase", [0, 1])
def test_int8_region_runs_the_kernel_dispatch_on_local_rows(group, phase):
    """Inside the int8 region on (4, 1) there is nothing to map (the rows'
    axis is the region's): each rank runs the unsharded kernel dispatch on
    its own rows, here the kernels' plain versions (reason ``platform``,
    the CPU), with K3 only at phase 1 and K4 only at phase 0; the
    reference's jnp path on whole tensors has no counterpart."""
    outs, _ = group
    frozen_op = {0: "lowrank_du", 1: "lowrank_dv"}[phase]
    want = {"lowrank_fwd", "lowrank_ffn", "lowrank_dx", "lowrank_du", "lowrank_dv"} - {frozen_op}
    for out in outs:
        got = out["int8"][f"4x1/{phase}"]["dispatch"]
        assert {op for op, _, _ in got} == want, got
        assert {(reason, m) for _, reason, m in got} == {("platform", BATCH * SEQ // 4)}, got


def test_microbatches_under_a_mesh_are_refused():
    """What the sharded step still refuses (ROADMAP item 8 keeps it): MTP
    and MLA, and the families past dense and MoE.  Microbatches are taken
    now, for the dense and MoE families alike (their parity with JAX's
    sharded step is ``tests/test_torch_moe_ep.py``'s)."""
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.configs.base import DistConfig as TDist, RunConfig as TRun
    from repro_torch.configs.base import ShapeConfig as TShape
    from repro_torch.launch import steps

    def run(arch, **dist):
        return TRun(model=t_smoke(arch), shape=TShape("t", SEQ, BATCH, "train"),
                    dist=TDist(**dist))

    for arch in ("smollm-360m", "olmoe-1b-7b"):
        steps.check_sharded_family(run(arch, microbatches=2))
    with pytest.raises(ValueError, match="MTP.*not ported.*item 8"):
        steps.check_sharded_family(run("deepseek-v3-671b", microbatches=2))
    mla = run("deepseek-v3-671b")
    mla = dataclasses.replace(mla, model=dataclasses.replace(mla.model, use_mtp=False))
    with pytest.raises(ValueError, match="MLA.*not ported.*item 8"):
        steps.check_sharded_family(mla)
    for arch in ("xlstm-350m", "seamless-m4t-medium"):
        with pytest.raises(ValueError, match="not ported.*item 8"):
            steps.check_sharded_family(run(arch))


def test_int8_on_a_tp_mesh_warns_once_and_syncs_uncompressed(group):
    outs, _ = group
    for out in outs:
        assert out["int8"]["4x1/warnings"] == []
        # once a process: the first builder warns, the second does not
        assert len(out["int8"]["2x2/warnings"]) <= 1
        for phase in (0, 1):
            assert not any(e[1] == "int8" for e in out["int8"][f"2x2/{phase}"]["log"])
    assert sum(len(o["int8"]["2x2/warnings"]) for o in outs) == 4


@pytest.mark.parametrize("kind", ["lowrank", "ffn"])
@pytest.mark.parametrize("fg", [None, 0, 1])
def test_sharded_dispatch_matches_plain(group, kind, fg):
    """KERNEL_SHMAP_OK: x rows over data, u whole, v columns over model."""
    outs, _ = group
    names = ("u", "v") if kind == "lowrank" else ("gu", "gv", "uu", "uv")
    for out in outs:
        res = out["dispatch"][f"{kind}/{fg}"]
        # max |sharded - plain| / max |plain| of y, dx and each gradient:
        # float32 sums taken in another order
        for k, err in res["errs"].items():
            if k in names and names.index(k) % 2 == fg:
                assert err is None, k  # no gradient at all for the frozen factor
            else:
                assert err <= 1e-5, (k, err)
        paths = [e[3] for e in res["log"]]
        for i, k in enumerate(names):
            assert (k in paths) == (i % 2 != fg), (k, paths)
        # dU's all-reduce over data and model, dV's over data; dx's and the
        # output's over model
        for op, dt, nb, path, axes in res["log"]:
            want = {"activation": (["model"],), "u": (["data", "model"],),
                    "gu": (["data", "model"],), "uu": (["data", "model"],)}
            assert tuple([axes]) in [want.get(path, (["data"],))], (path, axes)
        assert ("lowrank_du" in res["ops"]) == (fg != 0)
        assert ("lowrank_dv" in res["ops"]) == (fg != 1)


def test_elastic_resume_from_one_rank(group):
    """ELASTIC_OK."""
    outs, _ = group
    for out in outs:
        step_n, loss_a, loss_b, parked_on_cpu = out["elastic"]
        assert step_n == 2 and parked_on_cpu
        assert abs(loss_a - loss_b) <= TOL, (loss_a, loss_b)


def test_rank_adaptation_sync_bytes_shrink(group):
    """RANK_SYNC_OK."""
    outs, _ = group
    segs = outs[0]["rank_adapt"]
    sync, ranks = [s[0] for s in segs], [s[1] for s in segs]
    assert all(a > b for a, b in zip(ranks, ranks[1:])), ranks
    assert all(a > b for a, b in zip(sync, sync[1:])), sync
    assert all(np.isfinite(s[2]) for s in segs)


def test_count_step_collective_bytes_are_the_records(group):
    outs, _ = group
    by_op, by_dtype, log_op, log_dtype = outs[0]["count_step"]
    assert by_op == {k: float(v) for k, v in log_op.items()} and by_op["all-reduce"] > 0
    assert by_dtype == {k: float(v) for k, v in log_dtype.items()}
