"""The port's meta-device dry-run (``repro_torch.launch.dryrun`` and the
``abstract_*`` stand-ins of ``launch/steps.py``) against the JAX package:

* ``steps.abstract_params`` / ``abstract_state`` leaf shapes and dtypes
  equal JAX's on a one-device host mesh, per smoke family, per freezing
  phase and under a rank map; ``abstract_cache`` and ``batch_specs`` too;
* ``rank_adapt.apply_rank_map_to_shapes`` equals JAX's;
* ``dryrun.rank_adaptation_trajectory`` rows equal JAX's;
* a cell's FLOPs on meta equal the same step's count on the CPU;
* a cell's JSON has the reference's keys (``hlo_path`` aside: the port has
  no HLO, and stores its ``step_cost`` instead);
* ``--multi-pod``, ``--fsdp`` and ``--grad-compression int8`` are refused,
  naming ROADMAP queue 1 item 8.

Nothing is allocated on meta: ``init_params(device="meta")`` draws no
value."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro.core import rank_adapt as jrank_adapt
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro_torch.analysis.cost import count_step
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import LRDConfig as TLRDConfig
from repro_torch.configs.base import OptimConfig as TOptimConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.core import rank_adapt
from repro_torch.launch import dryrun, steps

torch.set_num_threads(1)

# the reference's dry-run sets XLA_FLAGS for a 512-device host platform
# when imported: import it with JAX already up on this host's one CPU
# device, and leave the environment as it was for later subprocesses
jax.devices()
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ARCHS = ["smollm-360m", "olmoe-1b-7b", "xlstm-350m", "zamba2-1.2b", "seamless-m4t-medium",
         "llama-3.2-vision-90b", "deepseek-v3-671b"]
SEQ, BATCH = 16, 2
# the reference's cell schema (repro/launch/dryrun.py run_cell, with
# save_hlo): every key but hlo_path, which names an HLO file
JAX_CELL_KEYS = {"arch", "shape", "mesh", "variant", "devices", "status", "seconds",
                 "memory_per_device", "cost_analysis_per_device",
                 "collective_bytes_per_device"}
JAX_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "total_bytes"}
JAX_COST_KEYS = {"flops", "bytes_accessed", "transcendentals"}
JAX_SECONDS_KEYS = {"build", "lower", "compile"}
JAX_TRAJECTORY_KEYS = {"boundary", "phase", "total_rank", "trainable_param_bytes",
                       "frozen_param_bytes", "opt_bytes", "trainable_partition_bytes"}


def _runs(arch, kind="train", optim="adamw", **lrd_kw):
    lrd = dict(enabled=True, min_dim=16, freeze_mode="sequential", rank_quantize=False,
               **lrd_kw)
    jrun = RunConfig(model=get_smoke_config(arch), shape=ShapeConfig("t", SEQ, BATCH, kind),
                     lrd=LRDConfig(**lrd), optim=OptimConfig(name=optim))
    trun = TRunConfig(model=t_get_smoke_config(arch), shape=TShapeConfig("t", SEQ, BATCH, kind),
                      lrd=TLRDConfig(**lrd), optim=TOptimConfig(name=optim))
    return jrun, trun


def _jax_leaves(tree):
    """{path: (shape, dtype name)} of an abstract JAX tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                       for p in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _torch_leaves(tree, path=""):
    """{path: (shape, dtype name)} of a port tree (``None`` holes and ``()``
    skipped, as JAX's flattening skips them)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_torch_leaves(v, f"{path}/{k}" if path else str(k)))
        return out
    if isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", range(len(tree)))
        out = {}
        for k, v in zip(names, tree):
            out.update(_torch_leaves(v, f"{path}/{k}" if path else str(k)))
        return out
    if tree is None:
        return {}
    assert tree.device.type == "meta"
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax(arch):
    jrun, trun = _runs(arch)
    want = _jax_leaves(jsteps.abstract_params(jrun, make_host_mesh(1, 1)))
    got = _torch_leaves(steps.abstract_params(trun))
    assert got == want
    # the meta init keeps the CUDA init's plan
    assert steps.init_params(trun, "meta")[1].to_json() == steps.init_params(trun, "cpu")[1].to_json()


@pytest.mark.parametrize("phase", [-1, 0, 1])
@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b", "seamless-m4t-medium"])
def test_abstract_state_matches_jax(arch, phase):
    jrun, trun = _runs(arch)
    want = _jax_leaves(jsteps.abstract_state(jrun, make_host_mesh(1, 1), phase=phase))
    got = _torch_leaves(steps.abstract_state(trun, phase=phase))
    assert got == want


@pytest.mark.parametrize("phase", [0, 1])
def test_abstract_state_under_a_rank_map_matches_jax(phase):
    jrun, trun = _runs("smollm-360m", optim="sgdm")
    rmap = {"stack/attn/wq": 9, "stack/ffn/gate": 5, "stack/ffn/up": 40}
    want = _jax_leaves(jsteps.abstract_state(jrun, make_host_mesh(1, 1), phase=phase,
                                             rank_map=rmap))
    got = _torch_leaves(steps.abstract_state(trun, phase=phase, rank_map=rmap))
    assert got == want
    assert got["trainable/stack/attn/wq/" + ("v" if phase == 0 else "u")][0][-2 + phase] == 9


@pytest.mark.parametrize("arch", ["smollm-360m", "xlstm-350m", "zamba2-1.2b",
                                  "seamless-m4t-medium", "llama-3.2-vision-90b"])
def test_abstract_cache_and_batch_specs_match_jax(arch):
    jrun, trun = _runs(arch, kind="decode")
    mesh = make_host_mesh(1, 1)
    assert _torch_leaves(steps.abstract_cache(trun)) == _jax_leaves(
        jsteps.abstract_cache(jrun, mesh))
    assert _torch_leaves(steps.batch_specs(trun)) == _jax_leaves(jsteps.batch_specs(jrun, mesh))
    jx = jsteps.decode_extras_specs(jrun, mesh)
    tx = steps.decode_extras_specs(trun)
    assert (tx is None) == (jx is None)
    if jx is not None:
        assert _torch_leaves(tx) == _jax_leaves(jx)


@pytest.mark.parametrize("rmap", [{}, {"stack/attn/wk": 3}, {"stack/attn/wq": 100},
                                  {"stack/ffn/down": 7, "stack/attn/wo": 1}])
def test_apply_rank_map_to_shapes_matches_jax(rmap):
    jrun, trun = _runs("smollm-360m")
    jshapes = jax.eval_shape(lambda: jsteps.init_params(jrun)[0])
    want = _jax_leaves(jrank_adapt.apply_rank_map_to_shapes(jshapes, rmap))
    got = _torch_leaves(rank_adapt.apply_rank_map_to_shapes(steps.abstract_params(trun), rmap))
    assert got == want


@pytest.mark.parametrize("schedule,optim", [("decay", "sgdm"), ("energy", "adamw")])
def test_rank_adaptation_trajectory_matches_jax(schedule, optim):
    jrun, trun = _runs("smollm-360m", optim=optim, rank_schedule=schedule,
                       rank_schedule_tile=8)
    want = jdryrun.rank_adaptation_trajectory(jrun, make_host_mesh(1, 1), 4)
    got = dryrun.rank_adaptation_trajectory(trun, 4)
    assert got == want and len(got) == 5
    assert got[-1]["total_rank"] < got[0]["total_rank"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_cell_flops_equal_the_cpu_count(kind):
    _, trun = _runs("smollm-360m", kind=kind)
    fn, args, donate = dryrun.cell(trun)
    meta = dryrun.measure_cell(fn, args, donate)
    if kind == "train":
        params, _ = steps.init_params(trun, "cpu")
        cpu_args = (steps.make_train_state(trun.optim, params, 0)[0],
                    {k: torch.zeros((BATCH, SEQ), dtype=torch.int32) for k in ("tokens", "labels")})
        cpu = count_step(dryrun.train_fn(trun, 0, "cpu"), *cpu_args)
    elif kind == "prefill":
        cpu = count_step(steps.build_prefill_step(trun), steps.init_params(trun, "cpu")[0],
                         {k: torch.zeros((BATCH, SEQ), dtype=torch.int32)
                          for k in ("tokens", "labels")})
    else:
        from repro_torch.models import lm
        cpu = count_step(steps.build_serve_step(trun), steps.init_params(trun, "cpu")[0],
                         lm.init_cache(trun.model, BATCH, SEQ, "cpu"),
                         torch.zeros((BATCH, 1), dtype=torch.int32),
                         torch.zeros((), dtype=torch.int32))
    assert meta["cost_analysis_per_device"]["flops"] == cpu.flops > 0
    assert meta["step_cost"]["bytes"] == cpu.bytes
    mem = meta["memory_per_device"]
    assert mem["total_bytes"] == mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
    # the train step updates its donated state in place, decode its cache
    assert (mem["alias_bytes"] > 0) == (kind != "prefill")


def test_cell_json_has_the_references_keys(tmp_path):
    res = dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--out",
                       str(tmp_path)])
    rec = json.loads((tmp_path / "smollm-360m__decode_32k__1gpu__lrd.json").read_text())
    assert rec == json.loads(json.dumps(res))
    assert set(rec) == JAX_CELL_KEYS | {"step_cost"}
    assert set(rec["memory_per_device"]) == JAX_MEMORY_KEYS
    assert set(rec["cost_analysis_per_device"]) == JAX_COST_KEYS
    assert set(rec["seconds"]) == JAX_SECONDS_KEYS
    assert rec["status"] == "ok" and rec["devices"] == 1 and rec["collective_bytes_per_device"] == {}
    # one decode step of 128 rows against a 32k cache updates the cache in place
    run = dryrun.build_cell("smollm-360m", "decode_32k")[2]
    assert rec["memory_per_device"]["alias_bytes"] == dryrun._tree_bytes(
        steps.abstract_cache(run))


def test_rank_adaptation_in_the_cell(tmp_path):
    fn, args, run, donate = dryrun.build_cell(
        "smollm-360m", TShapeConfig("t", 64, 4, "train"), rank_schedule="decay")
    rows = dryrun.rank_adaptation_trajectory(run, 2)
    assert [set(r) for r in rows] == [JAX_TRAJECTORY_KEYS] * 3
    assert [r["phase"] for r in rows] == [0, 1, 0]


@pytest.mark.parametrize("flag", [["--multi-pod"], ["--fsdp"], ["--grad-compression", "int8"]])
def test_item_8_flags_are_refused(flag, tmp_path):
    with pytest.raises(SystemExit, match="item 8"):
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--out", str(tmp_path)]
                    + flag)
    assert not list(tmp_path.iterdir())


def test_build_cell_picks_the_references_per_shape_choices():
    _, _, run, donate = dryrun.build_cell("smollm-360m", "train_4k")
    # the remat stash of 32 x (256 x 4096) x 960 bf16 at one data-parallel
    # way halves until it is under 2 GiB
    assert run.dist.microbatches == 32 and run.dist.remat == "sqrt" and donate == (0,)
    assert run.optim.name == "sgdm" and run.optim.state_dtype == "float32"
    assert run.lrd.use_pallas_kernel and run.lrd.rank_quantize
    _, _, run, donate = dryrun.build_cell("deepseek-v3-671b", "decode_32k")
    assert run.optim.name == "adamw" and run.optim.state_dtype == "bfloat16"
    assert run.dist.microbatches == 1 and donate == (1,)
    with pytest.raises(SystemExit, match="SKIP"):
        dryrun.build_cell("smollm-360m", "long_500k")
