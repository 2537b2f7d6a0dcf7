"""The port's checkpoints and training CLI against the JAX package's, on
the CPU: the on-disk format is shared (a bf16 leaf's ``.npy`` bytes are
identical, and each package loads the other's checkpoints), a JAX run
resumes in the port's ``train.main`` with the losses JAX itself goes on
to, the port resumes its own runs, flags of unported features are
rejected while the telemetry flags run, the sharded flags run on a 2-rank
gloo group, and ``bridge`` carries NamedTuple states."""

import functools
import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.launch import train as jtrain
from repro.optim.optimizers import OptState as JOptState
from repro_torch import bridge
from repro_torch.checkpoint import store
from repro_torch.launch import train

torch.set_num_threads(1)

TOL = 1e-5  # float32 losses: the same products summed in another order
SRC = str(Path(__file__).resolve().parents[1] / "src")
ENV = {"PYTHONPATH": os.pathsep.join(filter(None, [SRC, os.environ.get("PYTHONPATH")]))}
SMOKE = ["--arch", "smollm-360m", "--smoke", "--lrd", "--lrd-min-dim", "16",
         "--no-rank-opt", "--freeze", "sequential", "--steps-per-epoch", "2",
         "--global-batch", "2", "--seq-len", "16", "--log-every", "100"]


def _tree():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    return {"params": {"w": w, "b": w[0].astype(ml_dtypes.bfloat16)},
            "step": np.int32(7), "mu": {"w": w * 2}, "nu": ()}


def test_bf16_leaves_and_manifests_are_byte_identical(tmp_path):
    tree = _tree()
    jstore.save_checkpoint(tmp_path / "jax", 7, tree, extra={"phase": 1})
    store.save_checkpoint(tmp_path / "port", 7, bridge.from_numpy(tree), extra={"phase": 1})
    jdir, tdir = tmp_path / "jax" / "step_00000007", tmp_path / "port" / "step_00000007"
    assert sorted(p.name for p in jdir.iterdir()) == sorted(p.name for p in tdir.iterdir())
    for p in jdir.iterdir():
        assert (tdir / p.name).read_bytes() == p.read_bytes(), p.name
    loaded, step, extra = store.load_checkpoint(tdir)
    assert step == 7 and extra == {"phase": 1} and loaded["nu"] == ()
    assert loaded["params"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(loaded["params"]["b"].view(torch.int16).numpy(),
                                  tree["params"]["b"].view(np.int16))
    np.testing.assert_array_equal(loaded["mu"]["w"].numpy(), tree["mu"]["w"])


def test_port_checkpoint_loads_in_jax_with_equal_leaves(tmp_path):
    train.main(["--device", "cpu", *SMOKE, "--steps", "2", "--save-every", "2",
                "--ckpt-dir", str(tmp_path)])
    latest = jstore.latest_checkpoint(tmp_path / "smollm-360m-smoke")
    jstate, jstep, jextra = jstore.load_checkpoint(latest)
    tstate, tstep, textra = store.load_checkpoint(latest)
    assert jstep == tstep == 2 and jextra == textra and jextra["phase"] == 0
    flat_j, flat_t = jstore._flatten(jstate), store._flatten(tstate)
    assert flat_j.keys() == flat_t.keys()
    for k, v in flat_j.items():
        if v is None:  # an empty tuple (sgdm's nu)
            assert flat_t[k] is None, k
            continue
        np.testing.assert_array_equal(np.asarray(v), flat_t[k].numpy(), err_msg=k)
    # JAX's resume path takes it: re-partition for the saved phase
    (tr, fr, opt), parked = jstore.unpack_phased_state(
        jstate, jextra["phase"], expect_rank_map=jextra["rank_map"])
    assert jax.tree_util.tree_leaves(tr) and jax.tree_util.tree_leaves(parked[0])


def test_jax_run_resumes_in_the_port_with_jax_losses(tmp_path):
    """JAX trains 4 steps saving at 2 and 4; the port resumes from JAX's
    step-2 checkpoint (weights, moments, data state, phase) and its steps
    2 and 3 (a phase swap at 2) give JAX's losses."""
    _, jlosses = jtrain.main([*SMOKE, "--steps", "4", "--save-every", "2",
                              "--ckpt-dir", str(tmp_path / "jax")])
    # JAX's step-2 save completed before its step-4 save was queued
    step2 = "smollm-360m-smoke/step_00000002"
    shutil.copytree(tmp_path / "jax" / step2, tmp_path / "port" / step2)
    seen = []
    _, losses = train.main(["--device", "cpu", *SMOKE, "--steps", "4", "--save-every", "100",
                            "--ckpt-dir", str(tmp_path / "port")],
                           on_step=lambda step, phase, m: seen.append((step, phase)))
    assert seen == [(2, 1), (3, 1)]
    np.testing.assert_allclose(losses, jlosses[2:], rtol=TOL, atol=TOL)


def test_port_run_resumes_across_a_phase_swap(tmp_path):
    sigterm = signal.getsignal(signal.SIGTERM)
    argv = ["--device", "cpu", *SMOKE, "--save-every", "2"]
    _, straight = train.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    _, first = train.main([*argv, "--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    seen = []
    _, rest = train.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path / "b")],
                         on_step=lambda step, phase, m: seen.append((step, phase)))
    assert seen == [(2, 1), (3, 1)]
    np.testing.assert_allclose(first + rest, straight, rtol=TOL, atol=TOL)
    assert store.latest_checkpoint(tmp_path / "b" / "smollm-360m-smoke").name == "step_00000004"
    assert signal.getsignal(signal.SIGTERM) is sigterm  # the CLI put its handler back


@pytest.mark.parametrize("flags,says", [
    (["--mesh", "production"], "(data=16) x (model=16) = 256 ranks, but only 1 rank"),
    (["--mesh-data", "2"], "nproc-per-node 2"),
    (["--pallas-interpret"], "ROADMAP")])
def test_train_cli_rejects_unported_flags(flags, says, capsys):
    """``--pallas-interpret`` names no port (the kernels have no interpret
    mode); a mesh larger than the one-rank world fails with the mesh
    constructor's counts."""
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", *SMOKE, "--steps", "1", *flags])
    assert exc.value.code == 2
    assert says in capsys.readouterr().err


@functools.lru_cache(maxsize=None)
def _one_rank_losses(tmp):
    _, losses = train.main(["--device", "cpu", *SMOKE, "--steps", "3", "--save-every", "100",
                            "--ckpt-dir", tmp])
    return losses


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


@pytest.mark.parametrize("flags", [
    ["--mesh-data", "2"], ["--mesh-model", "2"], ["--fsdp"], ["--grad-compression", "int8"]])
def test_train_cli_runs_sharded_flags(flags, tmp_path):
    """The four flags the port once refused, run on a 2-rank gloo group on
    the CPU (the mesh (2, 1), (1, 2), (2, 1) under FSDP, (2, 1) with the
    int8 sync): rank 0's losses are the one-rank run's (int8: the first
    step's, then within the quantization's drift), and it alone writes."""
    argv = ["-m", "repro_torch.launch.train", "--device", "cpu", "--dist-backend", "gloo",
            *SMOKE, "--steps", "3", "--save-every", "2", "--ckpt-dir", str(tmp_path / "ck"),
            "--obs", "--obs-dir", str(tmp_path / "obs"), *flags]
    rc, out, err = _torchrun(argv, 2, timeout=240, env=ENV)
    assert rc == 0, err[-3000:]
    assert "[default0]:[mesh]" in out and "[default1]:" not in out
    events = _events(tmp_path / "obs" / "events.jsonl")
    losses = [e["loss"] for e in events if e["type"] == "train_step"]
    want = _one_rank_losses(str(tmp_path.parent / "one_rank"))
    if flags[0] == "--grad-compression":
        np.testing.assert_allclose(losses[0], want[0], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(losses, want, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(losses, want, rtol=TOL, atol=TOL)
    assert [e["sync_bytes_per_step"] > 0 for e in events if e["type"] == "train_step"] == \
        [True] * 3
    assert store.latest_checkpoint(tmp_path / "ck" / "smollm-360m-smoke").name == "step_00000002"


def _events(path):
    from repro_torch.obs import validate_file

    assert validate_file(path) > 0
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("flags", [
    ["--obs-dir", "runs/obs"], ["--obs"], ["--profile-steps", "1:2"],
    ["--log-format", "jsonl"], ["--obs-step-every", "2"]])
def test_train_cli_takes_telemetry_flags(flags, capsys, monkeypatch, tmp_path):
    """The five telemetry flags the port once refused: each runs and does
    what the JAX CLI's does (the trace itself: tests/test_torch_obs_train.py)."""
    monkeypatch.chdir(tmp_path)  # --obs-dir runs/obs is relative
    run_dir = tmp_path / "ck" / "smollm-360m-smoke"
    argv = ["--device", "cpu", *SMOKE, "--steps", "3", "--ckpt-dir", str(tmp_path / "ck")]
    _, losses = train.main([*argv, *flags])
    assert len(losses) == 3
    out = capsys.readouterr().out
    flag = flags[0]
    if flag == "--obs-dir":  # names where --obs writes; alone it writes nothing
        assert not (tmp_path / "runs").exists() and not list(tmp_path.rglob("*.jsonl"))
        train.main([*argv, "--steps", "1", *flags, "--obs", "--ckpt-dir", str(tmp_path / "ck2")])
        assert [e["type"] for e in _events(tmp_path / "runs/obs/events.jsonl")] == [
            "run_start", "train_step", "run_end"]
        assert not list((tmp_path / "ck2").rglob("*.jsonl"))
    elif flag == "--obs":  # events.jsonl in the checkpoint directory
        events = _events(run_dir / "events.jsonl")
        assert [e["type"] for e in events] == [
            "run_start", "train_step", "train_step", "phase_swap", "train_step", "run_end"]
        assert [e["loss"] for e in events if e["type"] == "train_step"] == losses
    elif flag == "--profile-steps":  # a Chrome trace of step 1 and its event
        assert "[profile] traced steps 1...2 -> " in out
        trace = json.loads((run_dir / "profile" / "trace.json").read_text())
        assert trace["traceEvents"]
        assert not list(tmp_path.rglob("*.jsonl"))  # no --obs: no event file
    elif flag == "--log-format":  # the console mirrors the events themselves
        shown = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
        assert [e["type"] for e in shown] == ["train_step", "phase_swap", "train_step"]
        assert [e["step"] for e in shown if e["type"] == "train_step"] == [0, 2]
        assert not any(line.startswith("step ") for line in out.splitlines())
    else:  # a train_step record every second step
        train.main([*argv, "--steps", "3", *flags, "--obs", "--ckpt-dir",
                    str(tmp_path / "ck2")])
        events = _events(tmp_path / "ck2" / "smollm-360m-smoke" / "events.jsonl")
        assert [e["step"] for e in events if e["type"] == "train_step"] == [0, 2]
        assert not list(run_dir.glob("*.jsonl"))  # the first run had no --obs


def test_train_cli_rejects_a_bad_profile_window():
    for spec in ("2:1", "3:3", "-1:2", "7", "a:b"):
        with pytest.raises(SystemExit, match="--profile-steps"):
            train.main(["--device", "cpu", *SMOKE, "--steps", "1", f"--profile-steps={spec}"])


def test_train_cli_trains_at_algorithm_1_ranks(capsys, tmp_path):
    """Without ``--no-rank-opt`` the CLI trains ``--lrd`` at the resolver's
    Algorithm-1 ranks (at smoke size its guard keeps every layer dense, as
    JAX's does)."""
    argv = [a for a in SMOKE if a != "--no-rank-opt"]
    _, losses = train.main(["--device", "cpu", *argv, "--steps", "1",
                            "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert "kept dense" in capsys.readouterr().out


def test_bridge_round_trips_jax_opt_state():
    rng = np.random.default_rng(1)
    mu = {"a": {"u": rng.standard_normal((4, 2)).astype(np.float32), "v": None}}
    state = JOptState(jnp.asarray(3, jnp.int32), jax.tree_util.tree_map(jnp.asarray, mu), ())
    t = bridge.from_numpy(state)
    assert type(t) is JOptState and t.nu == () and t.mu["a"]["v"] is None
    assert t.step.dtype == torch.int32 and int(t.step) == 3
    back = bridge.to_numpy(t)
    assert type(back) is JOptState
    np.testing.assert_array_equal(back.mu["a"]["u"], mu["a"]["u"])
