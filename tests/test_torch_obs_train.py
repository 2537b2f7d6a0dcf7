"""The port's train CLI with telemetry on, against the JAX CLI's, on the
CPU: JAX trains ``tests/test_obs.py``'s smoke run (8 steps, 3 a epoch,
``--rank-schedule decay``) with ``--obs``, saving at step 2; the port
resumes from that checkpoint with ``--obs``.  From the resume on the two
traces hold the same events in the same order (JAX's ``phase_compile``
taken out: the port compiles nothing), with the same steps, epochs,
phases, rank maps and partition bytes, and losses within the train
tolerance; ``obs_report`` of either trace, read by either package's
report, gives the same structural columns.  With telemetry off the port's
losses and dispatch decisions are those of the run with it on, and no
``.jsonl`` is written; ``--profile-steps`` writes a Chrome trace and emits
``profile_window``.

As in ``tests/test_torch_rank_adapt.py``, the port goes on from JAX's
truncated factors at each boundary: LAPACK under torch and under JAX flip
some singular-vector signs on these inputs."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis import obs_report as jreport
from repro.checkpoint import store as jstore
from repro.core import rank_adapt as jrank_adapt
from repro.launch import train as jtrain
from repro_torch import bridge
from repro_torch.analysis import obs_report
from repro_torch.core import rank_adapt
from repro_torch.kernels.lowrank_bwd import (lowrank_matmul_du, lowrank_matmul_dv,
                                             lowrank_matmul_dx)
from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
from repro_torch.kernels.lowrank_matmul import lowrank_matmul
from repro_torch.launch import train
from repro_torch.obs import MetricsRegistry, set_default_registry, validate_file

torch.set_num_threads(1)

TOL = 1e-5  # float32 losses: the same products summed in another order
# tests/test_obs.py's instrumented run
ARGV = ["--arch", "smollm-360m", "--smoke", "--steps", "8", "--steps-per-epoch", "3",
        "--global-batch", "2", "--seq-len", "32", "--lrd", "--lrd-min-dim", "16",
        "--no-rank-opt", "--freeze", "sequential", "--rank-schedule", "decay",
        "--rank-decay", "0.6", "--rank-min", "2", "--log-every", "4"]
# the fields each event of the two traces must agree on (losses: TOL)
SAME = {"train_step": ("step", "epoch", "phase", "total_rank", "rank_map", "trainable_bytes",
                       "frozen_bytes", "opt_bytes", "sync_bytes_per_step"),
        "phase_swap": ("epoch", "phase", "boundary"),
        "rank_adapt": ("epoch", "boundary", "shrunk", "rank_map"),
        "run_end": ("kind", "reason", "final_step")}
# the report's structural columns (step times and tokens/s are measured)
COLUMNS = ("phase", "epoch", "boundary", "rank_adapted", "truncated_groups", "steps",
           "sync_bytes_per_step", "trainable_bytes", "frozen_bytes", "opt_bytes", "total_rank",
           "d_sync_bytes", "d_trainable_bytes", "d_total_rank")


def _load(path):
    assert validate_file(path) > 0
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_train")
    mp = pytest.MonkeyPatch()
    # the JAX CLI keeps its 3 newest checkpoints: keep step 2's past step 8
    mp.setattr(jtrain, "CheckpointManager",
               lambda *a, **kw: jstore.CheckpointManager(*a, **{**kw, "keep": 4}))
    try:
        jtrain.main([*ARGV, "--ckpt-dir", str(d / "jax"), "--save-every", "2",
                     "--obs", "--obs-dir", str(d / "jax_events")])
    finally:
        mp.undo()
    step2 = "smollm-360m-smoke/step_00000002"
    shutil.copytree(d / "jax" / step2, d / "port" / step2)
    own = rank_adapt.truncate_params

    def jax_truncation(params, rank_map):
        own(params, rank_map)  # the port's truncation still runs
        want = jrank_adapt.truncate_params(bridge.to_numpy(params), rank_map)
        return bridge.from_numpy(jax.tree_util.tree_map(np.asarray, want))

    mp.setattr(rank_adapt, "truncate_params", jax_truncation)
    try:
        _, losses = train.main(["--device", "cpu", *ARGV, "--ckpt-dir", str(d / "port"),
                                "--save-every", "100", "--obs", "--obs-dir",
                                str(d / "port_events")])
    finally:
        mp.undo()
    return _load(d / "jax_events/events.jsonl"), _load(d / "port_events/events.jsonl"), losses


def test_port_trace_matches_jax_from_the_resume_on(traces):
    jev, tev, losses = traces
    assert [e["type"] for e in tev[:2]] == ["resume", "run_start"]
    assert tev[0]["step"] == 2 and tev[0]["phase"] == 0 and tev[1]["start_step"] == 2
    # JAX's events after its step-1 record, less phase_compile and its
    # straggler checks (a wall-clock judgement the port's 6 steps cannot make)
    start = next(i for i, e in enumerate(jev) if e["type"] == "train_step" and e["step"] == 1)
    want = [e for e in jev[start + 1:] if e["type"] not in ("phase_compile", "straggler")]
    got = tev[2:]
    assert [e["type"] for e in got] == [e["type"] for e in want]
    assert [e["type"] for e in got].count("rank_adapt") == 2
    for g, w in zip(got, want):
        for k in SAME.get(g["type"], ()):
            assert g[k] == w[k], (g["type"], k)
    steps = [e for e in got if e["type"] == "train_step"]
    np.testing.assert_allclose([e["loss"] for e in steps],
                               [e["loss"] for e in want if e["type"] == "train_step"],
                               rtol=TOL, atol=TOL)
    assert [e["loss"] for e in steps] == losses
    assert all(e["total_rank"] == sum(e["rank_map"].values()) for e in steps)
    assert all(e["step_time_s"] > 0 and e["tokens_per_s"] > 0 for e in steps)


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_report_columns_match(traces, reader):
    jev, tev, _ = traces
    attribution = (obs_report if reader == "port" else jreport).train_attribution
    rows, jrows = attribution(tev), attribution(jev)
    # the port's trace opens at the resume (step 2, still epoch 0)
    assert [r["phase"] for r in rows] == [r["phase"] for r in jrows] == [0, 1, 0]
    assert rows[0]["steps"] == 1 and jrows[0]["steps"] == 3
    for r, w in zip(rows[1:], jrows[1:]):
        assert {k: r.get(k) for k in COLUMNS} == {k: w.get(k) for k in COLUMNS}
    assert {k: rows[0][k] for k in COLUMNS if k != "steps" and k in rows[0]} == \
        {k: jrows[0][k] for k in COLUMNS if k != "steps" and k in jrows[0]}
    assert rows[2]["d_total_rank"] < 0 and rows[2]["d_trainable_bytes"] < 0


def _counted(argv):
    """``train.main`` under a fresh registry: losses, the registry's
    ``kernel_fallbacks`` series and K1-K5's launch counts."""
    kernels = (lowrank_matmul, lowrank_gated_ffn, lowrank_matmul_dx, lowrank_matmul_du,
               lowrank_matmul_dv)
    before = [k.launches for k in kernels]
    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    try:
        _, losses = train.main(argv)
    finally:
        set_default_registry(prev)
    return (losses, reg.snapshot()["kernel_fallbacks"],
            [k.launches - b for k, b in zip(kernels, before)])


def test_telemetry_off_changes_nothing_and_the_profile_window(tmp_path, capsys):
    argv = ["--device", "cpu", *ARGV, "--steps", "4", "--use-pallas", "--save-every", "100"]
    off = _counted([*argv, "--ckpt-dir", str(tmp_path / "off")])
    assert not list(tmp_path.rglob("*.jsonl"))
    out_off = capsys.readouterr().out
    on = _counted([*argv, "--ckpt-dir", str(tmp_path / "on"), "--obs", "--profile-steps", "3:4"])
    out_on = capsys.readouterr().out
    assert on == off  # losses bit for bit, the same plain-path decisions and launches
    fallbacks = off[1]["series"]
    assert set(fallbacks) == {f"op={op},reason=platform" for op in (
        "lowrank_fwd", "lowrank_ffn", "lowrank_dx", "lowrank_du", "lowrank_dv")}
    # the console differs only by the [profile] line (and the step times)
    trace_dir = tmp_path / "on" / "smollm-360m-smoke" / "profile"
    untimed = lambda out: [re.sub(r" \d+ms$", "", line) for line in out.splitlines()  # noqa: E731
                           if not line.startswith("[profile]")]
    assert untimed(out_on) == untimed(out_off) and "step     3 epoch   1 phase  1" in out_on
    assert f"[profile] traced steps 3...4 -> {trace_dir}" in out_on
    events = _load(tmp_path / "on" / "smollm-360m-smoke" / "events.jsonl")
    i = [e["type"] for e in events].index("profile_window")
    assert events[i] == dict(events[i], start_step=3, stop_step=4, trace_dir=str(trace_dir))
    assert events[i + 1]["type"] == "train_step" and events[i + 1]["step"] == 3
    trace = json.loads((trace_dir / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names


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


def test_two_rank_run_records_its_collectives(tmp_path):
    """The train CLI on a 2-rank gloo group (mesh (2, 1)): rank 0 alone
    writes the trace; the first step of each phase segment emits
    ``phase_compile`` with that step's sync bytes and collectives by class
    (the reference's compile-time figures), every ``train_step`` carries
    its step's real ``sync_bytes_per_step``, and under the decaying rank
    schedule the bytes fall at each boundary, as the report's
    ``d_sync_bytes`` shows."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {"PYTHONPATH": os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")]))}
    argv = ["-m", "repro_torch.launch.train", "--device", "cpu", "--dist-backend", "gloo",
            *ARGV, "--mesh-data", "2", "--ckpt-dir", str(tmp_path / "ck"),
            "--save-every", "100", "--obs", "--obs-dir", str(tmp_path / "obs")]
    rc, _, err = _torchrun(argv, 2, timeout=240, env=env)
    assert rc == 0, err[-3000:]
    events = _load(tmp_path / "obs" / "events.jsonl")
    assert len(list(tmp_path.rglob("events.jsonl"))) == 1
    compiles = [e for e in events if e["type"] == "phase_compile"]
    steps = [e for e in events if e["type"] == "train_step"]
    assert [e["phase"] for e in compiles] == [0, 1, 0]
    for e in compiles:
        assert e["sync_bytes_per_step"] == sum(e["collectives"].values()) > 0
        assert set(e["collectives"]) <= {"all-reduce", "all-gather", "reduce-scatter"}
    # each step's bytes are its segment's phase_compile figure
    seg = []
    for e in events:
        if e["type"] == "phase_compile":
            seg.append(e["sync_bytes_per_step"])
        elif e["type"] == "train_step":
            assert e["sync_bytes_per_step"] == seg[-1], e["step"]
    assert len(steps) == 8 and seg[0] > seg[1] > seg[2]
    rows = obs_report.train_attribution(events)
    assert [r["phase"] for r in rows] == [0, 1, 0]
    assert all(r["d_sync_bytes"] < 0 for r in rows[1:])
