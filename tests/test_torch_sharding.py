"""The port's sharding rules against the JAX package's, with no process
group: ``repro_torch.distributed.sharding`` resolves a placement from a
mesh's axis names and shape only, so both packages resolve on the same
stand-in meshes (a ``SimpleNamespace`` with ``axis_names`` and
``devices.shape``, which JAX's resolver reads too).

* every leaf's placement equals JAX's ``param_specs`` under
  ``PARAM_RULES``, ``PARAM_RULES_NO_FSDP`` and ``FROZEN_PARAM_RULES`` on
  meshes (4, 2), (8, 1), (1, 8), (2, 2), (16, 16) and (2, 16, 16), for the
  smoke trees of every family (JAX's shapes, and the port's own init on
  the meta device) and for the int8 serving export's leaf layout;
* ``_resolve_spec``'s divisibility and no-reuse cases, and a property test
  that every resolved spec is valid (as ``tests/test_distributed.py``);
* ``paged_pool_specs`` equals JAX's; ``FROZEN_PARAM_RULES`` names no
  ``data`` or ``pod`` axis; ``shard`` warns once outside a context;
  ``make_host_mesh`` / ``make_production_mesh`` raise with the counts.

About 10 s on one thread (JAX's traced inits most of it)."""

import functools
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config
from repro.configs.base import LRDConfig, RunConfig, ShapeConfig
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import LRDConfig as TLRDConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps

torch.set_num_threads(1)

MESHES = {"4x2": (("data", "model"), (4, 2)), "8x1": (("data", "model"), (8, 1)),
          "1x8": (("data", "model"), (1, 8)), "2x2": (("data", "model"), (2, 2)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
ARCHS = ("smollm-360m", "olmoe-1b-7b", "xlstm-350m", "zamba2-1.2b", "seamless-m4t-medium",
         "llama-3.2-vision-90b", "deepseek-v3-671b")
RULES = ("PARAM_RULES", "PARAM_RULES_NO_FSDP", "FROZEN_PARAM_RULES")


def _mesh(name):
    axes, shape = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape, object))


def _lrd():
    return dict(enabled=True, min_dim=16, rank_quantize=False)


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    run = RunConfig(model=get_smoke_config(arch), shape=ShapeConfig("t", 16, 2, "train"),
                    lrd=LRDConfig(**_lrd()))
    return jax.eval_shape(lambda: jsteps.init_params(run, jax.random.PRNGKey(0))[0])


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    run = TRunConfig(model=t_get_smoke_config(arch), shape=TShapeConfig("t", 16, 2, "train"),
                     lrd=TLRDConfig(**_lrd()))
    return steps.abstract_params(run)


def _int8_tree():
    """The int8 serving export's leaf layout on the smoke smollm tree (the
    shapes ``serving/export.py`` writes with ``quantize_factors="int8"``):
    each factor ``u``/``v`` as ``<name>_q`` (int8, same shape) and
    ``<name>_scale`` (..., 1, out), the dense FFN ``down`` of layer stack
    as a guard-merged ``kernel_q`` / ``kernel_scale``."""

    def walk(t, name=""):
        if not isinstance(t, dict):
            return t
        if "u" in t and "v" in t:
            out = {k: v for k, v in t.items() if k not in ("u", "v")}
            if name == "down":
                c, s_ = t["u"].shape[-2], t["v"].shape[-1]
                lead = t["u"].shape[:-2]
                return {**out, "kernel_q": jax.ShapeDtypeStruct(lead + (c, s_), np.int8),
                        "kernel_scale": jax.ShapeDtypeStruct(lead + (1, s_), np.float32)}
            for f in ("u", "v"):
                x = t[f]
                out[f"{f}_q"] = jax.ShapeDtypeStruct(x.shape, np.int8)
                out[f"{f}_scale"] = jax.ShapeDtypeStruct(x.shape[:-2] + (1, x.shape[-1]),
                                                         np.float32)
            return out
        return {k: walk(v, k) for k, v in t.items()}

    return walk(_jax_shapes("smollm-360m"))


def _by_path(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_path(v, f"{path}/{k}" if path else k))
        return out
    return {} if tree is None else {path: tree}


def _jax_specs(tree, mesh, rules):
    specs = jsh.param_specs(tree, mesh, getattr(jsh, rules))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(k.key for k in path): tuple(spec) for path, spec in flat}


def _port_specs(tree, mesh, rules):
    return _by_path(sh.param_specs(tree, mesh, getattr(sh, rules)))


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax_leaf_for_leaf(arch, mesh, rules):
    m = _mesh(mesh)
    tree = _jax_shapes(arch)
    want = _jax_specs(tree, m, rules)
    assert len(want) > 5
    assert _port_specs(tree, m, rules) == want
    # the port's own init on the meta device: the same paths and shapes
    assert _port_specs(_port_shapes(arch), m, rules) == want


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_int8_export_specs_match_jax(mesh, rules):
    m = _mesh(mesh)
    tree = _int8_tree()
    want = _jax_specs(tree, m, rules)
    assert any(p.endswith("/u_q") for p in want) and any(p.endswith("kernel_scale")
                                                        for p in want)
    assert _port_specs(tree, m, rules) == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_frozen_rules_name_no_data_or_pod_axis(mesh):
    specs = _port_specs(_jax_shapes("smollm-360m"), _mesh(mesh), "FROZEN_PARAM_RULES")
    for path, spec in specs.items():
        flat = [a for e in spec for a in sh.spec_axes(e)]
        assert "data" not in flat and "pod" not in flat, (path, spec)
    for table in (sh.FROZEN_PARAM_RULES,):
        named = {a for cands in table.values() for c in cands for a in sh.spec_axes(c)}
        assert not named & {"data", "pod"}


def test_frozen_factor_specs():
    frozen = {"layers": {"wq": {"u": np.zeros((2, 64, 16), np.float32)},
                         "gate": {"v": np.zeros((2, 16, 64), np.float32)}}}
    specs = sh.param_specs(frozen, _mesh("2x2"), sh.FROZEN_PARAM_RULES)
    assert specs["layers"]["wq"]["u"] == (None, None, None)
    assert specs["layers"]["gate"]["v"] == (None, None, "model")


def _mesh44():
    return SimpleNamespace(axis_names=("data", "model"), devices=np.empty((4, 4), object))


@pytest.mark.parametrize("case", [
    ((8, 128, 2, 16), ("batch", "kv_seq", "kv_heads", None), "ACT_RULES"),
    ((8, 128, 8, 16), ("batch", "kv_seq", "kv_heads", None), "ACT_RULES"),
    ((8, 128, 8, 16), ("batch", "kv_seq", "kv_heads", None), "ACT_RULES_SP"),
    ((16, 16), ("embed", "rank"), "PARAM_RULES"),
    ((6, 16), ("embed", "rank"), "PARAM_RULES"),
    ((16, 6), ("batch", "mlp"), "ACT_RULES")])
def test_resolve_spec_cases_match_jax(case):
    shape, axes, rules = case
    want = tuple(jsh._resolve_spec(shape, axes, getattr(jsh, rules), _mesh44()))
    assert sh._resolve_spec(shape, axes, getattr(sh, rules), _mesh44()) == want


def test_resolve_spec_divisibility_and_no_reuse():
    m = _mesh44()
    assert sh._resolve_spec((8, 128, 2, 16), ("batch", "kv_seq", "kv_heads", None),
                            sh.ACT_RULES, m) == ("data", None, None, None)
    assert sh._resolve_spec((8, 128, 8, 16), ("batch", "kv_seq", "kv_heads", None),
                            sh.ACT_RULES_SP, m) == ("data", "model", None, None)
    assert sh._resolve_spec((16, 16), ("embed", "rank"), sh.PARAM_RULES, m) == ("data", "model")


@settings(max_examples=30, deadline=None)
@given(dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 16, 48]), min_size=1, max_size=4))
def test_resolve_spec_always_valid(dims):
    m = _mesh44()
    axes = ("batch", "kv_seq", "kv_heads", "mlp")[:len(dims)]
    spec = sh._resolve_spec(tuple(dims), axes, sh.ACT_RULES, m)
    assert spec == tuple(jsh._resolve_spec(tuple(dims), axes, jsh.ACT_RULES, m))
    used = [a for e in spec for a in sh.spec_axes(e)]
    assert len(used) == len(set(used))
    for dim, e in zip(dims, spec):
        total = 1
        for a in sh.spec_axes(e):
            total *= 4
        assert dim % total == 0


@pytest.mark.parametrize("mesh", ["4x2", "1x8", "2x16x16"])
def test_paged_pool_specs_match_jax(mesh):
    m = _mesh(mesh)
    cache = {"stack": {"k": np.zeros((2, 5, 4, 8, 16)), "v": np.zeros((2, 5, 4, 8, 16)),
                       "k_scale": np.zeros((2, 5, 4, 8, 1)), "page_table": np.zeros((2, 3))}}
    want = jsh.paged_pool_specs(cache, m)
    got = sh.paged_pool_specs(cache, m)
    for k in cache["stack"]:
        assert got["stack"][k] == tuple(want["stack"][k]), k


def test_named_sharding_local_shapes():
    m = _mesh("4x2")
    tree = {"stack": {"attn": {"wq": {"u": np.zeros((2, 64, 16)), "v": np.zeros((2, 16, 64))}}}}
    shs = sh.named_shardings(tree, m, sh.PARAM_RULES_NO_FSDP)
    assert shs["stack"]["attn"]["wq"]["u"].local_shape((2, 64, 16)) == (2, 64, 4)
    assert shs["stack"]["attn"]["wq"]["v"].local_shape((2, 16, 64)) == (2, 4, 32)


def test_shard_warns_once_outside_axis_rules():
    prev = sh._warned_no_rules
    sh._warned_no_rules = False
    try:
        x = torch.ones(4, 4)
        with pytest.warns(UserWarning, match="outside an\\s+axis_rules"):
            assert sh.shard(x, "batch", None) is x
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert sh.shard(x, "batch", None) is x
        with sh.axis_rules(_mesh("2x2")):
            assert sh.shard(x, "batch", None) is x
            with pytest.raises(ValueError, match="2 axes"):
                sh.shard(torch.ones(2, 2, 2), "batch", None)
    finally:
        sh._warned_no_rules = prev


def test_host_mesh_validates_rank_count():
    m = tmesh.make_host_mesh(1, 1)
    assert tuple(m.shape) == (1, 1) and tuple(m.mesh_dim_names) == ("data", "model")
    with pytest.raises(ValueError, match=r"\(data=2\) x \(model=1\) = 2 ranks.*only 1 rank"):
        tmesh.make_host_mesh(2, 1)
    with pytest.raises(ValueError, match="nproc-per-node 4"):
        tmesh.make_host_mesh(2, 2)
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.make_host_mesh(0, 1)


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_production_mesh_raises_with_counts(multi_pod, need):
    with pytest.raises(ValueError, match=f"= {need} ranks.*exceed"):
        tmesh.make_production_mesh(multi_pod=multi_pod)


def test_place_at_paths_cuts_only_the_named_groups():
    """A truncated group's whole leaves are cut to this rank's block under
    their rule-resolved spec; every other leaf passes through (a fake rank
    at coordinate (1, 0) of a (2, 2) mesh)."""
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2),
                           get_coordinate=lambda: [1, 0])
    u = torch.arange(2 * 8 * 4, dtype=torch.float32).reshape(2, 8, 4)
    v = torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6)
    tree = {"stack": {"attn": {"wq": {"u": u, "v": v}, "wk": {"u": u, "v": v}}}}
    out = sh.place_at_paths(tree, mesh, sh.PARAM_RULES_NO_FSDP, ["stack/attn/wq"])
    # u (embed, rank): rank over data -> the second half of r; v (rank,
    # heads): rank over data, heads over model -> rows 2:4, columns 0:3
    assert torch.equal(out["stack"]["attn"]["wq"]["u"], u[..., 2:4])
    assert torch.equal(out["stack"]["attn"]["wq"]["v"], v[:, 2:4, 0:3])
    assert out["stack"]["attn"]["wk"]["u"] is u and out["stack"]["attn"]["wk"]["v"] is v


@pytest.mark.parametrize("backend,device", [("nccl", "cuda"), ("gloo", "cpu")])
def test_control_device_is_one_the_backend_takes(backend, device):
    """NCCL takes CUDA tensors alone, gloo CPU ones."""
    from repro_torch.distributed import collectives

    assert collectives.control_device(backend) == torch.device(device)


def test_any_rank_builds_its_flag_on_the_groups_control_device(monkeypatch):
    """``collectives.any_rank`` (the train CLI's save and preemption
    decisions, every sharded step) asks ``control_device`` for its group's
    backend and all-reduces the flag there, never on a fixed CPU device."""
    from repro_torch.distributed import collectives

    seen = []

    def all_reduce(t, op, group):
        seen.append((t.device.type, group))
        t.fill_(1)

    monkeypatch.setattr(collectives, "_names", lambda mesh: ("data", "model"))
    monkeypatch.setattr(collectives, "_live", lambda mesh, axes: ("data",))
    monkeypatch.setattr(collectives, "_group", lambda mesh, axes: "data group")
    monkeypatch.setattr(collectives.dist, "get_backend", lambda group: "nccl")
    monkeypatch.setattr(collectives, "control_device",
                        lambda b: seen.append(b) or torch.device("meta"))
    monkeypatch.setattr(collectives.dist, "all_reduce", all_reduce)
    monkeypatch.setattr(torch.Tensor, "item", lambda t: 1)
    assert collectives.any_rank(False, object()) is True
    assert seen == ["nccl", ("meta", "data group")]
