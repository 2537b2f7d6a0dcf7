"""TP-sharded serving of the port (``ServeEngine(mesh_model=2)``: the
scheduler, the serving steps under ``axis_rules``, KV-head-sharded paged
pools and the kernel dispatch on each rank's column blocks) on the CPU,
against the JAX package.

As ``tests/test_sharded_serving.py`` runs its scenarios in ONE 8-device
subprocess, this file runs one group of 2 gloo ranks (mesh (1, 2)) that
serves every scenario and writes what it saw; the tests read it.  Params
are made once in JAX (smoke smollm-360m, float32, LRD at Eq.-5 ranks; 2 KV
heads, so ``model=2`` splits the pools) and carried to the ranks through
``repro_torch.bridge``; the requests are made from a seed with numpy.  The
scenarios mirror the reference's three:

* prefix-cached paged serving: greedy tokens identical to JAX's
  single-device ``ServeEngine`` on the same params and requests, every
  decode step's logits within 1e-5 of its (the bound of
  ``tests/test_sharded_serving.py``), the prefix cache hit;
* a speculative draft with heterogeneous per-layer ranks (made in JAX):
  tokens identical to JAX's and to plain decoding;
* the analytic int8 export (smollm's smoke config widened to d_model 256
  and d_ff 512, so the export keeps factor pairs for K7 beside merged
  groups for K6): tokens identical to the port's one-rank engine serving
  the same export; the measured export decided on rank 0 (rank 1 times no
  probe) and the same tree on both ranks.

Also: each served leaf's and pool leaf's local shape is the block JAX's
``param_specs(FROZEN_PARAM_RULES)`` and ``paged_pool_specs`` imply, but for
the port's named departures; no serving step records a collective on a
param path (a decode step gathers activations only, one gather a
factorised projection and one for the attention heads); the kernel
dispatch's plain path ran at the local column shapes; with rank 1's clock
skewed the ranks admit identically; the serve CLI on two ranks; the
fixed-batch cache's specs and the pools' placement check.

About 35 s on the CPU, run alone (the two ranks' imports and serves, and
a second pair running the serve CLI, while the JAX engines compile)."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.core.decompose import map_factor_groups
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import make_draft_params
from repro.serving import paged_cache as jpc

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
ENV = {"PYTHONPATH": os.pathsep.join(filter(None, [SRC, os.environ.get("PYTHONPATH")]))}
TOL = 1e-5
RANKS = 2
SERVE = dict(max_len=48, num_slots=2, prefill_len=24, block_size=4)
CLI_ARGV = ["--smoke", "--device", "cpu", "--lrd", "--slots", "2", "--requests", "6",
            "--rate", "1000", "--prompt-len", "12", "--max-new", "5", "--prefix-cache",
            "--block-size", "4", "--spec-k", "2"]
WIDE = dict(d_model=256, d_ff=512)
# the port's served layout departs from FROZEN_PARAM_RULES' blocks here
# (launch.steps.serve_shardings): held whole where the reference splits ...
WHOLE = ("wo/u", "wo/u_q", "down/u", "down/u_q", "embed/embedding")
# ... and split by columns where the reference keeps the embed columns whole
COLS = tuple(f"{g}/{leaf}" for g in ("wo", "down")
             for leaf in ("v", "v_q", "v_scale", "kernel_q", "kernel_scale"))

_WORKER = r'''
import dataclasses, json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro_torch.core import rank_opt
from repro_torch.distributed import collectives
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serving import ServeConfig, ServeEngine

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
d = sys.argv[1]
collectives.init_process_group("gloo", "env://", rank, world)
mesh = make_host_mesh(1, world)

def load(name):
    flat, tree = np.load(f"{d}/{name}.npz"), {}
    for k in flat.files:
        node = tree
        *head, leaf = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = flat[k]
    return bridge.from_numpy(tree)

def run_of(**wide):
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), **wide)
    return RunConfig(model=cfg, shape=ShapeConfig("s", 48, 2, "decode"),
                     lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False,
                                   use_pallas_kernel=True),
                     dist=DistConfig(fsdp=False, remat="none"))

def shapes_of(tree, path=""):
    if isinstance(tree, dict):
        o = {}
        for k, v in tree.items():
            o.update(shapes_of(v, f"{path}/{k}" if path else k))
        return o
    return {path: list(tree.shape)}

reqs = json.load(open(f"{d}/requests.json"))
serve_kw = json.load(open(f"{d}/serve.json"))
params, draft, wide = load("params"), load("draft"), load("wide")
run, wrun = run_of(), run_of(**json.load(open(f"{d}/wide.json")))
out = {}

def served(label, engine, trace, skew=0.0):
    """Serve ``trace``, recording every collective, each decode step's
    logits, collectives and dispatcher shapes, and the admissions."""
    s = engine.scheduler
    steps_log, admits = [], []
    decode, start = s._decode, s._start

    def wrapped(*a):
        with collectives.recording() as log, ops.capture_fallbacks() as fb:
            res = decode(*a)
        steps_log.append(dict(logits=res[0][:, -1].tolist(),
                              coll=[[c.op, c.path, c.bytes] for c in log],
                              fallbacks=sorted({(f.op, f.reason) + f.shape for f in fb})))
        return res

    def started(idx, slot, req, fed, shared):
        admits.append([req.rid, idx, s.forward_stats["decode"] + s.forward_stats["verify"]])
        return start(idx, slot, req, fed, shared)

    s._decode, s._start = wrapped, started
    if skew:
        now = s._now
        s._now = lambda: now() + skew
    with collectives.recording() as log:
        res = engine.serve([{"prompt": np.asarray(r["prompt"], np.int32),
                             "max_new": r["max_new"], "arrival": r.get("arrival", 0.0)}
                            for r in trace])
    s._decode, s._start = decode, start
    out[label] = dict(
        tokens=[r.tokens.tolist() for r in res], steps=steps_log, admits=admits,
        coll=sorted({(c.op, c.path) for c in log}), forward=dict(s.forward_stats),
        stats={k: float(v) for k, v in s.latency_stats().items()},
        local=shapes_of(s.params), pool=shapes_of(s.cache), pool_bytes=s.cache_bytes(),
        draft=shapes_of(s.draft_params) if s.spec_k else {},
        whole=shapes_of(engine.params))

# 1. prefix-cached paged serving on (1, 2) (the engine makes its mesh from
# mesh_model; the rest are handed this one); then the same trace with rank
# 1's clock 100 s ahead and staggered arrivals
cfg1 = ServeConfig(**serve_kw, mesh_model=world, prefix_cache=True)
served("prefix", ServeEngine(run, params, config=cfg1, device="cpu"), reqs)
skewed = [dict(r, arrival=a) for r, a in zip(reqs, (0.0, 0.0, 0.15, 0.3))]
served("skew", ServeEngine(run, params, config=cfg1, device="cpu", mesh=mesh), skewed,
       skew=100.0 if rank == 1 else 0.0)

# 2. the heterogeneous-rank draft (made in JAX), k = 2, on (1, 2)
cfg2 = ServeConfig(**serve_kw, mesh_model=world, speculative_k=2)
served("spec", ServeEngine(run, params, config=cfg2, device="cpu", draft_params=draft,
                           mesh=mesh), reqs)

# 3. the analytic int8 export on (1, 2), and on one rank (rank 0)
cfg3 = dict(serve_kw, prefix_cache=True, export="analytic", export_int8=True)
served("int8", ServeEngine(wrun, wide, config=ServeConfig(**cfg3, mesh_model=world),
                           device="cpu", mesh=mesh), reqs)
if rank == 0:
    one = ServeEngine(wrun, wide, config=ServeConfig(**cfg3), device="cpu")
    out["int8_one"] = [r.tokens.tolist() for r in one.serve(
        [{"prompt": np.asarray(r["prompt"], np.int32), "max_new": r["max_new"]}
         for r in reqs])]

# the measured export: its probes timed on rank 0 alone
probes = []
timed = rank_opt.measured_linear_time_fn
def counting(*a, **k):
    probes.append(a[:2])
    return timed(*a, **k)
rank_opt.measured_linear_time_fn = counting
with collectives.recording() as log:
    meng = ServeEngine(wrun, wide, config=ServeConfig(**dict(cfg3, export="measured"),
                                                      mesh_model=world), device="cpu",
                       mesh=mesh)
rank_opt.measured_linear_time_fn = timed
out["measured"] = dict(probes=len(probes), digest=steps.tree_digest(meng.params, values=False),
                       summary=meng.export_report.summary(),
                       coll=sorted({(c.op, c.path) for c in log}))
served("measured_serve", meng, reqs)

json.dump(out, open(f"{d}/out{rank}.json", "w"))
collectives.destroy_process_group()
'''


def _torchrun(args, n, *, env):
    """``python -m torch.distributed.run --standalone`` with ``n`` ranks on
    ``args``, started now; the caller waits on the returned process."""
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc-per-node={n}", "--tee=3", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, **env))


def _jrun(**wide):
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), **wide)
    return RunConfig(model=cfg, shape=ShapeConfig("s", 48, 2, "decode"),
                     lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False),
                     dist=DistConfig(fsdp=False, remat="none"))


def _requests(vocab):
    """The reference's trace: four prompts sharing a 12-token prefix."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, vocab, 12).astype(np.int32)
    return [{"prompt": np.concatenate([prefix, rng.integers(1, vocab, 4).astype(np.int32)]),
             "max_new": 6} for _ in range(4)]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: np.asarray(tree)}


def _heterogeneous_draft(params):
    """The reference's non-uniform rank map: every factor group a different
    target."""
    geoms = []

    def collect(path, group):
        geoms.append((path, int(group["u"].shape[-1])))
        return group

    map_factor_groups(params, collect)
    rank_map = {p: max(4, r // 2 - 2 * i) for i, (p, r) in enumerate(geoms)}
    return make_draft_params(params, rank_map)[0], rank_map


class _DecodeLogits:
    """Wraps a JAX scheduler's decode program to keep each step's logits."""

    def __init__(self, sched):
        self.fn, self.logits = sched._decode, []
        sched._decode = self

    def __call__(self, *a):
        res = self.fn(*a)
        self.logits.append(np.asarray(res[0][:, -1], np.float32))
        return res


def _jax_serve(run, params, reqs, **kw):
    eng = JServeEngine(run, params, config=JServeConfig(**SERVE, **kw))
    rec = _DecodeLogits(eng.scheduler)
    res = eng.serve([dict(r) for r in reqs])
    return [np.asarray(r).tolist() for r in res], rec.logits, eng.scheduler


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_serve")
    jparams, _ = jsteps.init_params(_jrun(), jax.random.PRNGKey(0))
    jdraft, rank_map = _heterogeneous_draft(jparams)
    wparams, _ = jsteps.init_params(_jrun(**WIDE), jax.random.PRNGKey(0))
    reqs = _requests(_jrun().model.vocab_size)
    for name, tree in (("params", jparams), ("draft", jdraft), ("wide", wparams)):
        np.savez(d / f"{name}.npz", **_flat(jax.tree_util.tree_map(np.asarray, tree)))
    (d / "requests.json").write_text(json.dumps(
        [dict(r, prompt=r["prompt"].tolist()) for r in reqs]))
    (d / "serve.json").write_text(json.dumps(SERVE))
    (d / "wide.json").write_text(json.dumps(WIDE))
    proc = _torchrun(["--no-python", sys.executable, "-c", _WORKER, str(d)], RANKS, env=ENV)
    cli = _torchrun(["-m", "repro_torch.launch.serve", *CLI_ARGV, "--dist-backend", "gloo",
                     "--mesh-model", str(RANKS)], RANKS, env=ENV)
    # the JAX references while the ranks serve
    ref = {}
    ref["prefix"] = _jax_serve(_jrun(), jparams, reqs, prefix_cache=True)
    ref["spec"] = _jax_serve(_jrun(), jparams, reqs, speculative_k=2)
    try:
        _, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.terminate()
        _, err = proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    outs = [json.loads((d / f"out{r}.json").read_text()) for r in range(RANKS)]
    cli_out, cli_err = cli.communicate(timeout=600)
    return SimpleNamespace(outs=outs, ref=ref, jparams=jparams, jdraft=jdraft,
                           rank_map=rank_map, d=d, cli=(cli.returncode, cli_out, cli_err))


def _mesh():
    return SimpleNamespace(axis_names=("data", "model"), devices=np.empty((1, RANKS), object))


def _block(shape, spec):
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            out[i] //= RANKS
    return out


def _served_block(path, shape, spec):
    """The block the port serves a leaf in: JAX's FROZEN_PARAM_RULES block
    but for the named departures."""
    if path.endswith(WHOLE):
        return list(shape)
    if path.endswith(COLS):
        return list(shape[:-1]) + [shape[-1] // RANKS if shape[-1] % RANKS == 0
                                   else shape[-1]]
    return _block(shape, spec)


def _check_served_shapes(whole, local):
    """Each local leaf shape against JAX's spec of the whole shape."""
    tree = {}
    for path, shape in whole.items():
        node = tree
        *head, leaf = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = jax.ShapeDtypeStruct(tuple(shape), jnp.float32)
    specs = jsh.param_specs(tree, _mesh(), jsh.FROZEN_PARAM_RULES)
    flat = {}

    def walk(t, p=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{p}/{k}" if p else k)
        else:
            flat[p] = t

    walk(specs)
    assert set(local) == set(whole)
    departed = set()
    for path, shape in whole.items():
        want = _served_block(path, shape, flat[path])
        assert local[path] == want, (path, local[path], want, flat[path])
        if want != _block(shape, flat[path]):
            departed.add(path.rsplit("/", 2)[-2] + "/" + path.rsplit("/", 1)[-1])
    return departed


def test_prefix_serving_matches_jax_single_device(group):
    want_tokens, want_logits, jsched = group.ref["prefix"]
    for o in group.outs:
        got = o["prefix"]
        assert got["tokens"] == want_tokens
        assert [len(t) for t in got["tokens"]] == [6] * 4
        assert got["stats"]["prefix_hits"] == jsched.latency_stats()["prefix_hits"] == 3
        assert len(got["steps"]) == len(want_logits) > 0
        drift = max(float(np.max(np.abs(np.asarray(s["logits"], np.float32) - w)))
                    for s, w in zip(got["steps"], want_logits))
        assert drift <= TOL, drift


def test_heterogeneous_draft_matches_jax_and_plain(group):
    want_tokens = group.ref["spec"][0]
    assert len(set(group.rank_map.values())) > 1  # genuinely non-uniform
    for o in group.outs:
        got = o["spec"]
        assert got["tokens"] == want_tokens == group.ref["prefix"][0]
        assert got["forward"]["verify"] > 0 and got["forward"]["decode"] == 0
        whole = {k: list(v.shape) for k, v in _flat(jax.tree_util.tree_map(
            np.asarray, group.jdraft)).items()}
        _check_served_shapes(whole, got["draft"])


def test_int8_export_matches_one_rank_engine(group):
    one = group.outs[0]["int8_one"]
    for o in group.outs:
        assert o["int8"]["tokens"] == one
        assert [len(t) for t in one] == [6] * 4
        # K6 (merged groups) and K7 (factor pairs) both ran, on local columns
        ops_seen = {f[0] for s in o["int8"]["steps"] for f in s["fallbacks"]}
        assert {"int8_dense", "int8_lowrank"} <= ops_seen


def test_measured_export_decided_on_rank_zero(group):
    m0, m1 = (o["measured"] for o in group.outs)
    assert m0["probes"] > 0 and m1["probes"] == 0
    assert m0["digest"] == m1["digest"] and m0["summary"] == m1["summary"]
    assert ["broadcast", "serve/export"] in m0["coll"]
    assert group.outs[0]["measured_serve"]["tokens"] == group.outs[1]["measured_serve"]["tokens"]


def test_local_shapes_are_jax_blocks_but_named_departures(group):
    whole = {k: list(v.shape) for k, v in _flat(jax.tree_util.tree_map(
        np.asarray, group.jparams)).items()}
    for o in group.outs:
        departed = _check_served_shapes(whole, o["prefix"]["local"])
        assert departed == {"wo/u", "down/u", "embed/embedding", "wo/v", "down/v"}
        _check_served_shapes(o["int8"]["whole"], o["int8"]["local"])
        # the pools: KV heads over model (2 of 2 divide), page tables whole
        cfg = _jrun().model
        mb = jpc.blocks_for(SERVE["max_len"], SERVE["block_size"])
        jcache = jpc.init_paged_cache(cfg, SERVE["num_slots"], 1 + SERVE["num_slots"] * mb,
                                      SERVE["block_size"], mb)
        specs = jsh.paged_pool_specs(jcache, _mesh())
        for name, stack in jcache.items():
            for leaf, t in stack.items():
                assert o["prefix"]["pool"][f"{name}/{leaf}"] == _block(t.shape,
                                                                       specs[name][leaf])
        one = sum(int(np.prod(t.shape)) * t.dtype.itemsize for stack in jcache.values()
                  for n, t in stack.items() if n != "page_table")
        tables = sum(int(np.prod(t.shape)) * 4 for stack in jcache.values()
                     for n, t in stack.items() if n == "page_table")
        assert o["prefix"]["pool_bytes"] == one // RANKS + tables


def test_no_param_collective_in_a_serving_step(group):
    control = {"serve/clock", "serve/tokens", "serve/check", "serve/export"}
    params = set(_flat(jax.tree_util.tree_map(np.asarray, group.jparams)))
    layers = _jrun().model.num_layers
    for o in group.outs:
        for label in ("prefix", "skew", "spec", "int8", "measured_serve"):
            paths = {p for _, p in o[label]["coll"]}
            assert paths <= control | {"activation"}, (label, paths)
            assert not paths & params
        for s in o["prefix"]["steps"]:
            # one gather a factorised projection (wq, wk, wv, wo, gate/up in
            # one K5, down) and one of the attention heads, a layer
            assert [c[:2] for c in s["coll"]] == [["all-gather", "activation"]] * 7 * layers
            # K1 / K5 ran on the local columns: every S the whole one / 2
            shapes = {f[0]: f[2:] for f in s["fallbacks"]}
            assert all(f[1] == "platform" for f in s["fallbacks"])
            assert {f[-1] for f in s["fallbacks"] if f[0] == "lowrank_fwd"} == {32, 16}
            assert shapes["lowrank_ffn"][-1] == _jrun().model.d_ff // RANKS


def test_skewed_clocks_admit_identically(group):
    a0, a1 = (o["skew"] for o in group.outs)
    assert a0["admits"] == a1["admits"]
    assert [r for r, _, _ in a0["admits"]] == [0, 1, 2, 3]
    assert a0["tokens"] == a1["tokens"] == group.ref["prefix"][0]
    assert ["broadcast", "serve/clock"] in a0["coll"]


def test_serve_cli_on_two_ranks(group):
    """``torch.distributed.run ... -m repro_torch.launch.serve --mesh-model 2
    --dist-backend gloo``: rank 0 alone prints, the reference's mesh line
    among it, and the sample is the one-rank CLI's."""
    from repro_torch.launch import serve

    rc, out, err = group.cli
    assert rc == 0, err[-4000:]
    assert out.count("mesh: data=1 model=2 (2 devices)") == 1
    assert "[default1]" not in out
    _, results = serve.main(CLI_ARGV)
    sample = [line for line in out.splitlines() if "sample:" in line]
    assert sample == [f"[default0]:sample: {results[0][:16].tolist()}"]


@pytest.mark.parametrize("arch", ["smollm-360m", "xlstm-350m"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 1)])
def test_cache_specs_match_jax(arch, shape):
    """``steps.cache_specs`` of a fixed-batch cache, leaf by leaf, against
    the reference's resolution of its ``_CACHE_AXES`` under ``ACT_RULES``
    (the reference attaches them to a JAX mesh, which needs the devices)."""
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.configs.base import RunConfig as TRun
    from repro_torch.configs.base import ShapeConfig as TShape
    from repro_torch.launch import steps as tsteps

    run = TRun(model=t_smoke(arch), shape=TShape("d", 32, 4, "decode"))
    cache = tsteps.abstract_cache(run)
    mesh = SimpleNamespace(axis_names=("data", "model"), devices=np.empty(shape, object))
    got = tsteps.cache_specs(cache, run, mesh)

    def walk(c, g, name=""):
        if isinstance(c, dict):
            for k in c:
                walk(c[k], g[k], k)
            return
        nd = len(c.shape)
        axes = jsteps._CACHE_AXES.get(name, (None,) * nd)
        axes = (None,) * (nd - len(axes)) + axes[-nd:] if nd >= len(axes) else axes[-nd:]
        want = jsh._resolve_spec(tuple(c.shape), axes, jsh.ACT_RULES, mesh)
        assert g.spec == tuple(want), (name, g.spec, want)

    walk(cache, got)


def test_pool_placement_and_its_check():
    """``init_paged_cache`` on a (1, 2) mesh allocates each rank's KV heads
    (whole page tables); ``clamp_paged_cache`` passes it, and raises on a
    pool that lost its placement."""
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.launch import steps as tsteps
    from repro_torch.serving import paged_cache as tpc

    class Mesh:  # a (1, 2) mesh at coordinate (0, 1), read as the placement reads one
        mesh_dim_names, shape = ("data", "model"), (1, RANKS)

        def get_coordinate(self):
            return [0, 1]

    cfg = t_smoke("smollm-360m")
    mesh = Mesh()
    cache = tpc.init_paged_cache(cfg, 2, 9, 4, 4, "cpu", mesh)
    stack = cache["stack"]
    assert tuple(stack["k"].shape) == (2, 9, 4, cfg.num_kv_heads // RANKS, 16)
    assert tuple(stack["page_table"].shape) == (2, 2, 4)
    assert tsteps.clamp_paged_cache(cache, mesh, cfg.num_kv_heads) is cache
    whole = tpc.init_paged_cache(cfg, 2, 9, 4, 4, "cpu")
    assert tpc.paged_pool_bytes(whole) - tpc.paged_pool_bytes(cache) == (
        stack["k"].numel() * 4 * 2)
    with pytest.raises(AssertionError, match="paged cache drift at stack/k"):
        tsteps.clamp_paged_cache(whole, mesh, cfg.num_kv_heads)
