"""Expert parallelism in the port (``models/moe.py`` under a mesh:
``collectives.all_to_all``, the sharded train step's MoE placements and
microbatches, MoE serving over ``(1, 2)``) on the CPU, against the JAX
package ON THE SAME MESH SHAPE: the reference's capacity drops depend on
``ep_size``, so JAX on one device is not its reference.

One group of 4 gloo ranks (meshes (1, 2), (2, 2) and (1, 4); ranks past a
mesh idle while it runs) does every port check and writes what it saw;
JAX runs beside it in one subprocess with 4 forced host devices, as
``tests/test_sharded_train.py`` runs its meshes.  Params are made once in
JAX (smoke OLMoE with ``moe_impl="ep"``, float32; LRD experts at Eq.-5
ranks, and a tree with dense experts) and carried to the ranks through
``repro_torch.bridge``; inputs and batches come from numpy seeds.

* ``moe_apply`` at (1, 2), (2, 2) and (1, 4), LRD and dense experts: y and
  aux within 1e-5 of JAX's, and the gradients of x, the router and every
  expert leaf within 1e-4, at ``capacity_factor`` 1.25 (at (1, 4) JAX's
  own output differs from its one-device output: the drops differ), one
  shape that falls back to gshard (s = 15 at (2, 2)) and the smoke
  configs' ``moe_impl="dense"`` at (2, 2);
* the sharded train step against JAX's sharded step on (1, 2) and (2, 2)
  at phases -1 / 0 / 1 (loss within 1e-5, gradients within 1e-4: sgdm from
  zero momentum, so the first step's momentum is the gradient), with
  ``--microbatches 2`` on (2, 2) for the MoE and the dense family, and on
  (2, 2) under FSDP, zero1 and ``--remat full``; a batch that does not
  divide into the microbatches and the int8 sync of a MoE model (JAX's
  raises) are refused;
* placement: every leaf's local shape is JAX's ``param_specs`` block (the
  experts split over ``model`` on their expert dim; over ``data`` too
  under FSDP); no collective serves a frozen expert factor over ``data``; the router's gradient is the same on
  every rank; ``count_step``'s bytes by path are the step's records, and
  its all_to_all bytes the capacities' arithmetic;
* serving over (1, 2) with the prefix cache: tokens equal to, and every
  decode step's logits within 1e-5 of, JAX's engine on a (1, 2) host mesh.

About 90 s on the CPU, run alone (JAX's sharded compiles and its engine
set it; the 4 ranks finish first)."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro.core import freezing as jfreezing
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
ENV = {"PYTHONPATH": os.pathsep.join(filter(None, [SRC, os.environ.get("PYTHONPATH")]))}
TOL, GRAD_TOL = 1e-5, 1e-4
SEQ, BATCH = 16, 8
SERVE = dict(max_len=48, num_slots=2, prefill_len=24, block_size=4)
# (name, mesh, expert kind, sequence length, moe_impl): "gshard/2x2" falls
# back to gshard, "impl-dense/2x2" runs the smoke configs' dense rule
MOE_CASES = [("lrd/1x2", (1, 2), "lrd", 16, "ep"), ("lrd/2x2", (2, 2), "lrd", 16, "ep"),
             ("lrd/1x4", (1, 4), "lrd", 16, "ep"), ("dense/1x2", (1, 2), "dense", 16, "ep"),
             ("dense/2x2", (2, 2), "dense", 16, "ep"), ("dense/1x4", (1, 4), "dense", 16, "ep"),
             ("gshard/2x2", (2, 2), "lrd", 15, "ep"),
             ("impl-dense/2x2", (2, 2), "lrd", 16, "dense")]
# (name, mesh, phase, microbatches, family, DistConfig fields): FSDP and
# zero1 put the expert leaves' storage over data too, remat recomputes each
# layer in the backward
TRAIN_CASES = [(f"{m}/{p}", m, p, 1, "moe", {}) for m in ("1x2", "2x2") for p in (-1, 0, 1)]
TRAIN_CASES += [("mb/moe", "2x2", 0, 2, "moe", {}), ("mb/dense", "2x2", 0, 2, "dense", {}),
                ("fsdp/-1", "2x2", -1, 1, "moe", {"fsdp": True}),
                ("fsdp/0", "2x2", 0, 1, "moe", {"fsdp": True}),
                ("zero1/1", "2x2", 1, 1, "moe", {"fsdp": True, "param_layout": "zero1"}),
                ("remat/1", "2x2", 1, 1, "moe", {"remat": "full"})]

# the cells whose one-process version (the one-device step with every MoE
# layer run by ``moe_ep_plain``, chip_smoke.py's reference) is checked too
ONE_PROCESS = ["1x2/-1", "2x2/0", "mb/moe"]

_COMMON = r'''
import dataclasses, json, sys
import numpy as np
d = sys.argv[1]
CASES = json.load(open(d + "/cases.json"))

def unflat(flat, prefix=""):
    tree = {}
    for k in flat.files:
        if not k.startswith(prefix):
            continue
        node = tree
        *head, leaf = k[len(prefix):].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = flat[k]
    return tree

def flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{path}/{k}" if path else k))
        return out
    return {} if tree is None else {path: np.asarray(tree)}

def runs(cfgmod, Dist, LRD, Optim, Run, Shape):
    moe = dataclasses.replace(cfgmod.get_smoke_config("olmoe-1b-7b"), moe_impl="ep")
    dense = cfgmod.get_smoke_config("smollm-360m")
    mk = lambda m, mb=1, dist={}: Run(
        model=m, shape=Shape("t", CASES["seq"], CASES["batch"], "train"),
        lrd=LRD(enabled=True, min_dim=16, rank_quantize=False, freeze_mode="sequential"),
        dist=Dist(**dict(dict(fsdp=False, remat="none", microbatches=mb), **dist)),
        optim=Optim(name="sgdm", lr=1e-2, warmup_steps=2, total_steps=8))
    return mk, moe, dense
'''

_JAX = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import functools
import jax, jax.numpy as jnp
from repro import configs as cfgmod
from repro.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro.distributed.sharding import axis_rules
from repro.launch import steps
from repro.launch.mesh import make_host_mesh
from repro.models import moe as jmoe
from repro.serving import ServeConfig, ServeEngine
''' + _COMMON + r'''
mk, moe_cfg, dense_cfg = runs(cfgmod, DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig)
P = np.load(d + "/params.npz")
X = np.load(d + "/inputs.npz")
tree = lambda pre: jax.tree_util.tree_map(jnp.asarray, unflat(P, pre))
out, arrays = {"moe": {}, "train": {}}, {}

# moe_apply on each mesh (and on one device, for the drops)
for name, shape, kind, s, impl in CASES["moe"] + [["one/1x1", [1, 1], "lrd", 16, "ep"]]:
    lp = jax.tree_util.tree_map(lambda t: t[0], tree(f"{kind}/moe_stack/moe/"))
    x, ct = jnp.asarray(X[f"x{s}"]), jnp.asarray(X[f"ct{s}"])
    mesh = make_host_mesh(*shape)
    cfg = dataclasses.replace(moe_cfg, moe_impl=impl)

    def f(lp, x):
        with axis_rules(mesh):
            y, aux = jmoe.moe_apply(lp, x, cfg)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(lp, x)
    arrays.update({f"moe/{name}/y": np.asarray(y), f"moe/{name}/dx": np.asarray(gx)})
    arrays.update({f"moe/{name}/d/{k}": v for k, v in flat(jax.device_get(gp)).items()})
    out["moe"][name] = float(aux)

# the sharded train step on the same meshes
batch = {"tokens": X["tokens"], "labels": X["labels"]}
for name, mesh_s, phase, mb, fam, dist in CASES["train"]:
    run = mk(moe_cfg if fam == "moe" else dense_cfg, mb, dist)
    params = unflat(P, "lrd/" if fam == "moe" else "smollm/")
    mesh = make_host_mesh(*(int(n) for n in mesh_s.split("x")))
    st, _ = steps.make_sharded_train_state(run, params, phase, mesh)
    b = steps.shard_batch(batch, mesh)
    shs = steps.state_shardings(run, mesh, st)
    fn = jax.jit(functools.partial(steps.build_train_step(run, mesh), phase=phase),
                 in_shardings=(shs, steps.batch_shardings(b, mesh)), out_shardings=(shs, None))
    new, m = fn(st, b)
    out["train"][name] = [float(m["loss"]), float(m["grad_norm"])]
    arrays.update({f"train/{name}/{k}": v for k, v in flat(jax.device_get(new.opt.mu)).items()})

# serving over (1, 2) with the prefix cache
srun = dataclasses.replace(mk(moe_cfg), shape=ShapeConfig("s", 48, 2, "decode"))
eng = ServeEngine(srun, tree("lrd/"), config=ServeConfig(**CASES["serve"], mesh_model=2,
                                                          prefix_cache=True))
sched, logits = eng.scheduler, []
dec = sched._decode

def rec(*a):
    res = dec(*a)
    logits.append(np.asarray(res[0][:, -1], np.float32))
    return res

sched._decode = rec
res = eng.serve([{"prompt": np.asarray(r["prompt"], np.int32), "max_new": r["max_new"]}
                 for r in CASES["requests"]])
out["serve"] = [np.asarray(r).tolist() for r in res]
for i, l in enumerate(logits):
    arrays[f"serve/{i}"] = l
json.dump(out, open(d + "/jax.json", "w"))
np.savez(d + "/jax.npz", **arrays)
'''

_WORKER = r'''
import os
import torch
torch.set_num_threads(1)
from repro_torch import bridge, configs as cfgmod
from repro_torch.analysis import cost
from repro_torch.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import axis_rules
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe
from repro_torch.serving import ServeConfig, ServeEngine
''' + _COMMON + r'''
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
ONE_PROCESS = CASES["one_process"]
collectives.init_process_group("gloo", "env://", rank, world)
mk, moe_cfg, dense_cfg = runs(cfgmod, DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig)
P = np.load(d + "/params.npz")
X = np.load(d + "/inputs.npz")
tree = lambda pre: bridge.from_numpy(unflat(P, pre))
meshes = {"1x2": make_host_mesh(1, 2), "2x2": make_host_mesh(2, 2), "1x4": make_host_mesh(1, 4),
          "2x1": make_host_mesh(2, 1)}
rec = lambda log: [[c.op, c.dtype, c.bytes, c.path, list(c.axes)] for c in log]
out, arrays = {"moe": {}, "train": {}, "placement": {}, "logs": {}, "router": {}}, {}

def coords(mesh):
    return [collectives.coordinate(mesh, ("data",)), collectives.coordinate(mesh, ("model",))]

def in_mesh(mesh):
    return mesh.get_coordinate() is not None

def shapes_of(tree, path=""):
    return {k: list(v.shape) for k, v in flat(tree, path).items()}

# moe_apply under each mesh: this rank's pieces
for name, shape, kind, s, impl in CASES["moe"]:
    mesh = meshes["x".join(map(str, shape))]
    if not in_mesh(mesh):
        continue
    dp = shape[0]
    di, mi = coords(mesh)
    lp = {g: (({k: v[0].clone().requires_grad_(True) for k, v in grp.items()})
              if "kernel" in grp else
              {e: {k: v[0].clone().requires_grad_(True) for k, v in f.items()}
               for e, f in grp.items()})
          for g, grp in tree(f"{kind}/moe_stack/moe/").items()}
    bl = CASES["batch_moe"] // dp
    x = torch.from_numpy(X[f"x{s}"][di * bl:(di + 1) * bl]).clone().requires_grad_(True)
    ct = torch.from_numpy(X[f"ct{s}"][di * bl:(di + 1) * bl])
    with axis_rules(mesh, rows=("data",) if dp > 1 else ()), collectives.recording() as log:
        y, aux = tmoe.moe_apply(lp, x, dataclasses.replace(moe_cfg, moe_impl=impl))
        (torch.sum(y * ct) + aux / dp).backward()
    grads = {"router/kernel": lp["router"]["kernel"].grad}
    grads.update({f"experts/{e}/{k}": v.grad for e, f in lp["experts"].items()
                  for k, v in f.items()})
    for k, g in grads.items():
        if dp > 1:  # each data rank's share of a replicated leaf's gradient
            g = collectives.all_reduce(g.clone(), mesh, ("data",), path="test")
        arrays[f"moe/{name}/d/{k}"] = g.numpy()
    arrays[f"moe/{name}/y"] = y.detach().numpy()
    arrays[f"moe/{name}/dx"] = x.grad.numpy()
    out["moe"][name] = {"aux": float(aux), "coords": [di, mi], "log": rec(log)}

# the sharded train step
batch = {"tokens": X["tokens"], "labels": X["labels"]}
for name, mesh_s, phase, mb, fam, dist in CASES["train"]:
    mesh = meshes[mesh_s]
    if not in_mesh(mesh):
        continue
    run = mk(moe_cfg if fam == "moe" else dense_cfg, mb, dist)
    run = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, use_pallas_kernel=True))
    params = tree("lrd/" if fam == "moe" else "smollm/")
    st, parked = steps.make_sharded_train_state(run, params, phase, mesh)
    steps.check_state_placement(run, mesh, st)
    out["placement"][name] = {"trainable": shapes_of(st.trainable),
                              "frozen": shapes_of(st.frozen), "mu": shapes_of(st.opt.mu)}
    train = steps.build_train_step(run, "cpu", mesh=mesh)
    with collectives.recording() as log, ops.capture_fallbacks() as fbs:
        c = cost.count_step(train, st, batch, phase=phase)
    out["logs"][name] = rec(log)
    out["train"][name] = {"coords": coords(mesh), "by_path": c.collective_bytes_by_path,
                          "by_op": c.collective_bytes,
                          "fallbacks": sorted({(f.op, f.reason) for f in fbs})}
    with collectives.recording():
        st2, m = train(st, batch, phase=phase)
    out["train"][name].update(loss=float(m["loss"]), gnorm=float(m["grad_norm"]))
    if fam == "moe" and phase != 0:
        r = st2.opt.mu["moe_stack"]["moe"]["router"]["kernel"]
        out["router"][name] = steps.tree_digest({"r": r})
    whole, _ = steps.gather_state(st2, parked, run, mesh)
    if rank == 0:
        arrays.update({f"train/{name}/{k}": v for k, v in flat(whole.opt.mu).items()})
    if rank == 0 and name in ONE_PROCESS:
        # the one-process version chip_smoke.py holds the step to: the
        # one-device step with every MoE layer run by moe_ep_plain
        from repro_torch.models import lm
        real = lm.moe_apply
        lm.moe_apply = lambda p, x, cfg, policy=False: tmoe.moe_ep_plain(
            p, x, cfg, *(int(n) for n in mesh_s.split("x")))
        try:
            st1, _ = steps.make_train_state(run.optim, params, phase)
            st1, m1 = steps.build_train_step(run, "cpu")(st1, batch, phase=phase)
        finally:
            lm.moe_apply = real
        out["train"][name]["one_loss"] = float(m1["loss"])
        arrays.update({f"one/{name}/{k}": v for k, v in flat(st1.opt.mu).items()})

# a global batch that does not divide into the microbatches is refused on
# every rank, before any collective (6 rows, 4 microbatches)
mesh = meshes["1x2"]
if in_mesh(mesh):
    run = mk(moe_cfg, 4)
    st, _ = steps.make_sharded_train_state(run, tree("lrd/"), 1, mesh)
    try:
        steps.build_train_step(run, "cpu", mesh=mesh)(
            st, {k: v[:6] for k, v in batch.items()}, phase=1)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
# the int8 sync (data manual, on a pure data-parallel mesh) of a MoE model
# is refused: the reference's expert shard_map raises inside it
mesh = meshes["2x1"]
if in_mesh(mesh):
    try:
        steps.build_train_step(mk(moe_cfg, 1, {"grad_compression": "int8"}), "cpu", mesh=mesh)
        out["int8_refused"] = None
    except ValueError as e:
        out["int8_refused"] = str(e)

# serving over (1, 2) with the prefix cache
mesh = meshes["1x2"]
if in_mesh(mesh):
    srun = dataclasses.replace(mk(moe_cfg), shape=ShapeConfig("s", 48, 2, "decode"))
    srun = dataclasses.replace(srun, lrd=dataclasses.replace(srun.lrd, use_pallas_kernel=True))
    eng = ServeEngine(srun, tree("lrd/"), config=ServeConfig(**CASES["serve"], prefix_cache=True),
                      device="cpu", mesh=mesh)
    s = eng.scheduler
    logs, dec = [], s._decode

    def wrapped(*a):
        with collectives.recording() as log:
            res = dec(*a)
        logs.append([res[0][:, -1].float().numpy(), rec(log)])
        return res

    s._decode = wrapped
    with collectives.recording() as slog:
        res = eng.serve([{"prompt": np.asarray(r["prompt"], np.int32), "max_new": r["max_new"]}
                         for r in CASES["requests"]])
    out["serve"] = {"tokens": [r.tokens.tolist() for r in res],
                    "decode_logs": [l for _, l in logs],
                    "paths": sorted({(c.op, c.path) for c in slog}),
                    "local": shapes_of(s.params), "forward": dict(s.forward_stats)}
    for i, (l, _) in enumerate(logs):
        arrays[f"serve/{i}"] = l
json.dump(out, open(d + f"/out{rank}.json", "w"))
np.savez(d + f"/arrays{rank}.npz", **arrays)
collectives.destroy_process_group()
'''


def _jrun(model, mb=1):
    return RunConfig(model=model, shape=ShapeConfig("t", SEQ, BATCH, "train"),
                     lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False,
                                   freeze_mode="sequential"),
                     dist=DistConfig(fsdp=False, remat="none", microbatches=mb),
                     optim=OptimConfig(name="sgdm", lr=1e-2, warmup_steps=2, total_steps=8))


MOE_CFG = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), moe_impl="ep")


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {} if tree is None else {path: np.asarray(tree)}


@functools.lru_cache(maxsize=None)
def _params():
    key = jax.random.PRNGKey(0)
    lrd, _ = jsteps.init_params(_jrun(MOE_CFG), key)
    dense, _ = jsteps.init_params(dataclasses.replace(
        _jrun(MOE_CFG), lrd=LRDConfig(enabled=False)), key)
    smollm, _ = jsteps.init_params(_jrun(get_smoke_config("smollm-360m")), key)
    return {"lrd": jax.tree_util.tree_map(np.asarray, lrd),
            "dense": jax.tree_util.tree_map(np.asarray, dense),
            "smollm": jax.tree_util.tree_map(np.asarray, smollm)}


def _popen(cmd, env):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, **env))


def _wait(p, timeout):
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.terminate()
        out, err = p.communicate()
    return p.returncode, out, err


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    np.savez(d / "params.npz", **_flat(_params()))
    rng = np.random.default_rng(0)
    inputs = {}
    for s in sorted({c[3] for c in MOE_CASES}):
        inputs[f"x{s}"] = rng.standard_normal((4, s, MOE_CFG.d_model)).astype(np.float32)
        inputs[f"ct{s}"] = rng.standard_normal((4, s, MOE_CFG.d_model)).astype(np.float32)
    vocab = MOE_CFG.vocab_size
    inputs["tokens"] = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    inputs["labels"] = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    np.savez(d / "inputs.npz", **inputs)
    prefix = rng.integers(1, vocab, 12).astype(np.int32)
    reqs = [{"prompt": np.concatenate([prefix, rng.integers(1, vocab, 4)]).tolist(),
             "max_new": 6} for _ in range(4)]
    (d / "cases.json").write_text(json.dumps(
        {"moe": MOE_CASES, "train": TRAIN_CASES, "one_process": ONE_PROCESS, "seq": SEQ,
         "batch": BATCH, "batch_moe": 4,
         "serve": SERVE, "requests": reqs}))
    ranks = _popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node=4", "--tee=3", "--no-python", sys.executable, "-c",
                    _WORKER, str(d)], ENV)
    jproc = _popen([sys.executable, "-c", _JAX, str(d)], dict(ENV, JAX_PLATFORMS="cpu"))
    rc, _, err = _wait(ranks, 600)
    assert rc == 0, err[-4000:]
    jrc, _, jerr = _wait(jproc, 600)
    assert jrc == 0, jerr[-4000:]
    outs = [json.loads((d / f"out{r}.json").read_text()) for r in range(4)]
    arrays = [dict(np.load(d / f"arrays{r}.npz")) for r in range(4)]
    return outs, arrays, json.loads((d / "jax.json").read_text()), dict(np.load(d / "jax.npz"))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _expert_block(path, mi, ep, arr):
    """This model rank's expert block of a layer leaf's gradient (a router
    or expert leaf's whole gradient otherwise)."""
    if "experts" not in path:
        return arr
    e = arr.shape[0] // ep
    return arr[mi * e:(mi + 1) * e]


@pytest.mark.parametrize("case", [c[0] for c in MOE_CASES])
def test_moe_apply_matches_jax_on_the_same_mesh(group, case):
    outs, arrays, jout, jarr = group
    name, (dp, ep), _, s, impl = next(c for c in MOE_CASES if c[0] == case)
    seen = 0
    for out, arr in zip(outs, arrays):
        if case not in out["moe"]:
            continue
        seen += 1
        di, mi = out["moe"][case]["coords"]
        rows = slice(di * 4 // dp, (di + 1) * 4 // dp)
        assert abs(out["moe"][case]["aux"] - jout["moe"][case]) <= TOL
        _close(arr[f"moe/{case}/y"], jarr[f"moe/{case}/y"][rows], TOL, "y")
        _close(arr[f"moe/{case}/dx"], jarr[f"moe/{case}/dx"][rows], GRAD_TOL, "dx")
        leaves = [k.split("/d/", 1)[1] for k in jarr if k.startswith(f"moe/{case}/d/")]
        assert leaves and any("router" in k for k in leaves)
        for k in leaves:
            got = _expert_block(k, mi, ep, arr[f"moe/{case}/d/{k}"])
            _close(got, _expert_block(k, mi, ep, jarr[f"moe/{case}/d/{k}"]), GRAD_TOL, k)
        ops = {(e[0], e[3]) for e in out["moe"][case]["log"]}
        a2a = {p for o, p in ops if o == "all-to-all"}
        if s % ep or impl == "dense":  # the experts' outputs gathered, no exchange
            assert not a2a and ("all-gather", "moe/expert_out") in ops
        else:
            assert a2a == {"moe/dispatch", "moe/dispatch_ids", "moe/combine"}
    assert seen == dp * ep


def test_drops_at_1x4_differ_from_one_device(group):
    """The case the contract names: at (1, 4) and capacity 1.25 JAX's own
    output is not its one-device output, and the port matched the (1, 4)
    one (the test above)."""
    _, _, _, jarr = group
    one = jarr["moe/one/1x1/y"]
    assert np.max(np.abs(jarr["moe/lrd/1x4/y"] - one)) > 1e-2 * np.max(np.abs(one))
    np.testing.assert_array_equal(jarr["moe/lrd/1x2/y"], one)  # nothing dropped differently


def _jax_partition(phase):
    return jfreezing.partition(_params()["lrd"], phase)


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_sharded_step_matches_jax_sharded_step(group, case):
    outs, arrays, jout, jarr = group
    loss, gnorm = jout["train"][case]
    for out in outs:
        if case not in out["train"]:
            continue
        got = out["train"][case]
        assert abs(got["loss"] - loss) <= TOL * max(1.0, abs(loss)), (got["loss"], loss)
        assert abs(got["gnorm"] - gnorm) <= GRAD_TOL * max(1.0, gnorm), (got["gnorm"], gnorm)
        # every kernel call ran its plain version because the tensors lie
        # on the CPU, never because the dispatch could not map a shard
        assert got["fallbacks"] and all(r == "platform" for _, r in got["fallbacks"])
    want = {k.split("/", 3)[3]: v for k, v in jarr.items() if k.startswith(f"train/{case}/")}
    got = {k.split("/", 3)[3]: v for k, v in arrays[0].items() if k.startswith(f"train/{case}/")}
    assert got.keys() == want.keys() and want
    for p, g in want.items():
        _close(got[p], g, GRAD_TOL, p)


@pytest.mark.parametrize("case", ONE_PROCESS)
def test_one_process_version_is_the_sharded_step(group, case):
    """chip_smoke.py holds the card's sharded step to the one-device step
    with every MoE layer run by ``moe_ep_plain`` over the same mesh: in
    float32 the two agree (the loss within 1e-5, the momentum within
    1e-4), with microbatches too."""
    outs, arrays, _, _ = group
    got = outs[0]["train"][case]
    assert abs(got["loss"] - got["one_loss"]) <= TOL * max(1.0, abs(got["one_loss"]))
    one = {k.split("/", 3)[3]: v for k, v in arrays[0].items() if k.startswith(f"one/{case}/")}
    sharded = {k.split("/", 3)[3]: v for k, v in arrays[0].items()
               if k.startswith(f"train/{case}/")}
    assert one.keys() == sharded.keys() and one
    for p, w in one.items():
        _close(sharded[p], w, GRAD_TOL, p)


def _mesh(shape):
    from types import SimpleNamespace
    return SimpleNamespace(axis_names=("data", "model"), devices=np.empty(shape, object))


def _local(shape, spec, sizes):
    out = list(shape)
    for i, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            out[i] //= sizes[a]
    return out


def _flat_specs(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(k.key for k in path): tuple(s) for path, s in flat}


# (trainable rules, optimizer rules) of each layout
_LAYOUTS = {"tp": (jsh.PARAM_RULES_NO_FSDP, jsh.PARAM_RULES_NO_FSDP),
            "fsdp": (jsh.PARAM_RULES, jsh.PARAM_RULES),
            "zero1": (jsh.PARAM_RULES_NO_FSDP, jsh.PARAM_RULES)}


@pytest.mark.parametrize("case", ["1x2/-1", "2x2/0", "2x2/1", "fsdp/-1", "fsdp/0", "zero1/1"])
def test_placement_local_shapes_are_jax_specs_blocks(group, case):
    outs, _, _, _ = group
    _, mesh_s, phase, _, _, dist = next(c for c in TRAIN_CASES if c[0] == case)
    shape = tuple(int(n) for n in mesh_s.split("x"))
    sizes = dict(zip(("data", "model"), shape))
    tr, fr = _jax_partition(int(phase))
    layout = dist.get("param_layout", "fsdp") if dist.get("fsdp") else "tp"
    prules, orules = _LAYOUTS[layout]
    for part, t, rules in (("trainable", tr, prules), ("frozen", fr, jsh.FROZEN_PARAM_RULES),
                           ("mu", tr, orules)):
        specs = _flat_specs(jsh.param_specs(t, _mesh(shape), rules))
        want = {p: _local(_flat(t)[p].shape, sp, sizes) for p, sp in specs.items()}
        for out in outs:
            if case in out["placement"]:
                assert out["placement"][case][part] == want, part
        experts = {p: sp for p, sp in specs.items() if "/experts/" in p}
        assert all(sp[1] == "model" for sp in experts.values())
        assert experts or part == "frozen"


@pytest.mark.parametrize("phase", [0, 1])
def test_no_data_collective_serves_a_frozen_expert_factor(group, phase):
    outs, _, _, _ = group
    _, fr = _jax_partition(phase)
    frozen = {p for p in _flat(fr) if "/experts/" in p}
    assert frozen
    seen = set()
    for out in outs:
        for case in (f"2x2/{phase}", f"1x2/{phase}", f"fsdp/{phase}", f"zero1/{phase}"):
            seen.update([case] if case in out["logs"] else [])
            for op, dt, nb, path, axes in out["logs"].get(case, []):
                assert path not in frozen, (op, path, axes)
        # the trainable expert factors are synced over data, never model
        # (all-reduced, or reduce-scattered into an FSDP / zero1 placement)
        for case in (f"2x2/{phase}", f"fsdp/{phase}", f"zero1/{phase}"):
            for op, dt, nb, path, axes in out["logs"].get(case, []):
                if "/experts/" in path and op in ("all-reduce", "reduce-scatter"):
                    assert axes == ["data"], (case, op, path, axes)
    assert f"2x2/{phase}" in seen and f"1x2/{phase}" in seen


def test_indivisible_microbatches_are_refused(group):
    """A global batch of 6 rows in 4 microbatches raises on every rank of
    (1, 2), rather than training on the 4 rows that divide."""
    outs, _, _, _ = group
    msgs = [out["refused"] for out in outs if "refused" in out]
    assert len(msgs) == 2
    assert all(m and "6 rows" in m and "4 microbatches" in m for m in msgs), msgs


def test_int8_sync_of_a_moe_model_is_refused(group):
    outs, _, _, _ = group
    msgs = [out["int8_refused"] for out in outs if "int8_refused" in out]
    assert len(msgs) == 2
    assert all(m and "item 8" in m and "int8" in m for m in msgs), msgs


@pytest.mark.parametrize("rows,m,dp,ok", [(8, 2, 2, True), (8, 4, 2, True), (10, 4, 1, False),
                                         (8, 2, 3, False), (12, 4, 2, False)])
def test_microbatch_rows_regroups_the_global_batch(rows, m, dp, ok):
    from repro_torch.launch import steps as tsteps

    batch = {"tokens": np.arange(rows * 3).reshape(rows, 3)}
    if not ok:
        with pytest.raises(ValueError, match="does not divide"):
            tsteps.microbatch_rows(batch, m, dp)
        return
    mbs = tsteps.microbatch_rows(batch, m, dp)
    assert len(mbs) == m
    for i, mb in enumerate(mbs):  # microbatch i: global rows i B/m + [0, B/m)
        np.testing.assert_array_equal(mb["tokens"],
                                      batch["tokens"][i * rows // m:(i + 1) * rows // m])


def test_checkpointed_layers_see_the_forward_context_on_another_thread():
    """A CUDA backward recomputes a checkpointed layer on autograd's device
    thread, where the forward's thread-local ``axis_rules`` is not active:
    ``bind_context`` carries it there (the remat case above runs on the
    CPU, whose backward stays on the calling thread)."""
    import threading
    from types import SimpleNamespace

    from repro_torch.distributed import sharding as tsh

    mesh, seen = SimpleNamespace(name="mesh"), {}
    read = lambda: (tsh.current_mesh(), tsh.current_row_axes())  # noqa: E731
    with tsh.axis_rules(mesh, rows=("data",)):
        bound = tsh.bind_context(read)
    for key, fn in (("bound", bound), ("plain", read)):
        t = threading.Thread(target=lambda k=key, f=fn: seen.__setitem__(k, f()))
        t.start()
        t.join()
    assert seen["bound"] == (mesh, ("data",))
    assert seen["plain"] == (None, ())
    assert read() == (None, ())  # the caller's own context is left as it was


def test_router_gradient_is_the_same_on_every_rank(group):
    outs, _, _, _ = group
    for case in ("1x2/-1", "1x2/1", "2x2/-1", "2x2/1"):
        digests = [out["router"][case] for out in outs if case in out["router"]]
        assert len(digests) == (2 if case.startswith("1x2") else 4)
        assert all(dg == digests[0] for dg in digests), case


@pytest.mark.parametrize("case", ["1x2/-1", "2x2/0", "mb/moe"])
def test_count_step_bytes_by_path_are_the_records(group, case):
    """``count_step``'s bytes by path are the step's records, and each
    all_to_all's the capacities' arithmetic: per layer a forward sends x,
    the ids and the outputs once each, the backward x and the outputs
    again (its grads)."""
    from repro_torch.models.moe import ep_exchange_bytes
    from repro_torch.configs import get_smoke_config as t_smoke

    outs, _, _, _ = group
    cfg = dataclasses.replace(t_smoke("olmoe-1b-7b"), moe_impl="ep")
    m = 2 if case.startswith("mb/") else 1
    mesh_s = "2x2" if case != "1x2/-1" else "1x2"
    dp, ep = (int(n) for n in mesh_s.split("x"))
    t = BATCH // m // dp * SEQ // ep
    per = ep_exchange_bytes(t, cfg.d_model, cfg, ep, 4)
    want_a2a = {f"all-to-all {p}": cfg.num_layers * m * nb * (1 if p.endswith("ids") else 2)
                for p, nb in per.items()}
    for out in outs:
        if case not in out["train"]:
            continue
        recs = {}
        for op, dt, nb, path, axes in out["logs"][case]:
            recs[f"{op} {path}"] = recs.get(f"{op} {path}", 0) + nb
        assert out["train"][case]["by_path"] == {k: float(v) for k, v in recs.items()}
        got = {k: v for k, v in recs.items() if k.startswith("all-to-all")}
        assert got == want_a2a
        assert out["train"][case]["by_op"]["all-to-all"] == sum(want_a2a.values())


def test_serving_over_1x2_matches_jax_engine_on_1x2(group):
    outs, arrays, jout, jarr = group
    served = [(o, a) for o, a in zip(outs, arrays) if "serve" in o]
    assert len(served) == 2
    want = [jarr[f"serve/{i}"] for i in range(sum(k.startswith("serve/") for k in jarr))]
    assert want
    for out, arr in served:
        assert out["serve"]["tokens"] == jout["serve"]
        got = [arr[f"serve/{i}"] for i in range(len(want))]
        assert len(out["serve"]["decode_logs"]) == len(want)
        drift = max(float(np.max(np.abs(g - w))) for g, w in zip(got, want))
        assert drift <= TOL, drift
        # experts split over model; a decode step (s = 1) falls back to
        # gshard and gathers the experts' outputs, and exchanges nothing
        local = out["serve"]["local"]
        assert local["moe_stack/moe/experts/gate/u"][1] == MOE_CFG.num_experts // 2
        for log in out["serve"]["decode_logs"]:
            paths = {(e[0], e[3]) for e in log}
            assert ("all-gather", "moe/expert_out") in paths
            assert not any(op == "all-to-all" for op, _ in paths)
    # the prefill (24 positions over 2 ranks) exchanged pairs
    assert ["all-to-all", "moe/dispatch"] in served[0][0]["serve"]["paths"]
