"""The port stands alone: importing every module of ``repro_torch`` and
``chip_smoke`` (the telemetry layer, ``repro_torch.obs``, the analysis
slice, ``repro_torch.analysis``, ``kernels.autotune`` and
``launch.dryrun``, and the sharded path, ``repro_torch.distributed`` and
``launch.mesh``, among them) pulls in neither JAX nor the JAX package,
and the entry points refuse to run without CUDA unless the CPU is asked
for."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro."))
print(len(names), bad, sorted(n for n in names if n.startswith(
    ("repro_torch.obs", "repro_torch.analysis", "repro_torch.kernels.autotune",
     "repro_torch.launch.dryrun", "repro_torch.distributed", "repro_torch.launch.mesh"))))
"""
# the telemetry layer's, the analysis slice's and the sharded path's
# modules: each imported by the probe above
TELEMETRY = ["repro_torch.analysis", "repro_torch.analysis.cost",
             "repro_torch.analysis.obs_report", "repro_torch.analysis.report",
             "repro_torch.analysis.roofline", "repro_torch.distributed",
             "repro_torch.distributed.collectives", "repro_torch.distributed.compression",
             "repro_torch.distributed.sharding", "repro_torch.kernels.autotune",
             "repro_torch.launch.dryrun",
             "repro_torch.launch.mesh", "repro_torch.obs", "repro_torch.obs.__main__",
             "repro_torch.obs.events", "repro_torch.obs.registry", "repro_torch.obs.schema"]


def test_port_imports_no_jax_and_nothing_of_repro():
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n, rest = out.stdout.strip().split(" ", 1)
    bad, telemetry = rest.split("] ", 1)
    assert int(n) >= 20 and bad == "[", out.stdout
    assert telemetry == repr(TELEMETRY), out.stdout


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the entry points would run")
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch import serve, steps
    from repro_torch.serving import ServeConfig, ServeEngine

    run = RunConfig(model=get_smoke_config("smollm-360m"), shape=ShapeConfig("s", 8, 1, "decode"))
    with pytest.raises(RuntimeError, match="cuda"):
        steps.init_params(run)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(run, {}, config=ServeConfig(num_slots=1))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke", "--requests", "1"])
    params, _ = steps.init_params(run, device="cpu")
    assert ServeEngine(run, params, config=ServeConfig(num_slots=1), device="cpu")
    engine, outs = serve.main(["--smoke", "--device", "cpu", "--lrd", "--requests", "2",
                               "--slots", "2", "--prompt-len", "8", "--max-new", "3"])
    assert [len(o) for o in outs] == [3, 3]


def test_training_entry_points_need_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the entry points would run")
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch import steps, train

    run = RunConfig(model=get_smoke_config("smollm-360m"), shape=ShapeConfig("t", 8, 2, "train"))
    with pytest.raises(RuntimeError, match="cuda"):
        steps.build_train_step(run)
    argv = ["--smoke", "--steps", "1", "--global-batch", "2", "--seq-len", "8",
            "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(argv)
    assert steps.build_train_step(run, device="cpu")
    _, losses = train.main(["--device", "cpu", *argv])
    assert len(losses) == 1


def test_serve_cli_rejects_unported_flags():
    from repro_torch.launch import serve

    for argv in (["--mesh-data", "2"], ["--export-int8"],
                 ["--arch", "deepseek-v3-671b", "--mesh-model", "2"],
                 ["--arch", "seamless-m4t-medium", "--spec-k", "2"]):
        with pytest.raises(SystemExit) as exc:
            serve.main(["--smoke", "--device", "cpu", *argv])
        assert exc.value.code == 2


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
