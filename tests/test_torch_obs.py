"""The port's telemetry layer against the JAX package's, on the CPU: the
event schema (``EVENT_FIELDS``, ``REQUEST_FIELD_EVENTS``,
``SCHEMA_VERSION``) equal dict for dict, the metrics registries' snapshots
equal after the same operations, ``render_text``'s console lines identical
for every event type of ``tests/test_obs.py``, ``validate_event``
accepting and rejecting the same events, ``EventLog(None)`` creating no
file, the ``jsonl`` mirror printing the serialized event, the report's
rows and summaries equal on the same events, and the dispatcher's
``kernel_fallbacks`` counter."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import obs_report as jreport
from repro.obs import events as jevents
from repro.obs import registry as jregistry
from repro.obs import schema as jschema
from repro_torch.analysis import obs_report
from repro_torch.kernels import ops
from repro_torch.obs import (NULL_LOG, EventLog, MetricsRegistry, default_registry,
                             render_text, set_default_registry, validate_event,
                             validate_file)
from repro_torch.obs import schema

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_schemas_are_equal():
    assert schema.SCHEMA_VERSION == jschema.SCHEMA_VERSION == 1
    assert schema.EVENT_FIELDS == jschema.EVENT_FIELDS
    assert schema.REQUEST_FIELD_EVENTS == jschema.REQUEST_FIELD_EVENTS


def _drive(reg):
    """One sequence of counter, gauge and histogram operations."""
    c = reg.counter("kernel_fallbacks", "test")
    c.inc(op="lowrank_fwd", reason="platform")
    c.inc(op="lowrank_fwd", reason="platform")
    c.inc(2, op="lowrank_ffn", reason="disabled")
    c.inc(3)
    g = reg.gauge("serve_active_slots", "test")
    g.set(3)
    g.set(1, pool="a")
    g.set(2.5, pool="a")
    h = reg.histogram("step_time_s", "test")
    for v in np.random.default_rng(0).random(37):
        h.observe(float(v), phase=int(v * 3) - 1)
    h.observe(4.0)
    reg.histogram("empty", "test")
    return (c.value(op="lowrank_fwd", reason="platform"), c.total(), g.value(pool="a"),
            g.value(pool="b"), h.count(phase=0), h.percentile(95, phase=1), h.summary(),
            h.summary(phase=7))


def test_registries_give_equal_snapshots():
    ours, theirs = MetricsRegistry(), jregistry.MetricsRegistry()
    assert _drive(ours) == _drive(theirs)
    snap = ours.snapshot()
    assert snap == theirs.snapshot()
    assert snap["kernel_fallbacks"]["series"]["op=lowrank_fwd,reason=platform"] == 2.0
    assert set(snap["step_time_s"]["series"]["phase=1"]) == {"count", "sum", "p50", "p95", "p99"}
    for reg in (ours, theirs):
        with pytest.raises(ValueError):
            reg.gauge("kernel_fallbacks")
    ours.reset()
    assert ours.snapshot() == {}


def test_default_registry_swap():
    fresh = MetricsRegistry()
    prev = set_default_registry(fresh)
    try:
        assert default_registry() is fresh
    finally:
        assert set_default_registry(prev) is fresh
    assert default_registry() is prev


def _step(**kw):
    ev = {"step": 7, "epoch": 1, "phase": 0, "loss": 2.5, "grad_norm": 1.25,
          "step_time_s": 0.05, "tokens_per_s": 100.0, "total_rank": 3, "trainable_bytes": 1,
          "frozen_bytes": 1, "opt_bytes": 1, "sync_bytes_per_step": 0}
    return {**ev, **kw}


# every event type tests/test_obs.py builds, with its fields, and a few more
EVENTS = [
    ("run_start", {"kind": "train"}),
    ("run_end", {"kind": "serve", "tok_per_s": 12.5}),
    ("train_step", _step()),
    ("train_step", _step(step=12345, epoch=321, phase=-1, loss=0.123456, step_time_s=1.23456)),
    ("phase_swap", {"epoch": 1, "phase": 0, "dur_s": 0.01, "boundary": 1}),
    ("phase_swap", {"epoch": 2, "phase": 1, "dur_s": 0.0}),
    ("rank_adapt", {"epoch": 1, "boundary": 1, "shrunk": {"g": "12->8"}, "rank_map": {"g": 8}}),
    ("phase_compile", {"phase": 0, "sync_bytes_per_step": 0, "collectives": {}}),
    ("straggler", {"step": 9, "step_time_s": 0.25, "median_s": 0.1}),
    ("resume", {"step": 2, "phase": 1, "src_mesh": [1, 1], "mesh": [1, 1]}),
    ("resume", {"step": 2, "phase": 1}),
    ("profile_window", {"start_step": 2, "stop_step": 3, "trace_dir": "runs/x/profile"}),
    ("request_queued", {"rid": 0, "prompt_len": 8, "max_new": 10, "arrival": 0.0}),
    ("request_prefill", {"rid": 0, "slot": 1, "fed_len": 8, "resume": False,
                         "queue_wait_s": 0.0, "prefix_hit_len": 0}),
    ("request_first_token", {"rid": 0, "ttft_s": 0.01}),
    ("request_retired", {"rid": 0, "latency_s": 0.2, "tokens": 10, "preemptions": 1}),
    ("request_preempted", {"rid": 0, "generated": 3}),
    ("serve_step", {"active_slots": 1, "queued": 0}),
    ("spec_step", {"drafted": 4, "accepted": 3, "emitted": 5, "acceptance_rate": 0.75}),
    ("compile_cache", {"fn": "decode", "compiles": 1}),
    ("bench_row", {"bench": "b", "row": {"us": 1.5}}),
]


@pytest.mark.parametrize("etype,fields", EVENTS, ids=[f"{t}-{i}" for i, (t, _) in
                                                      enumerate(EVENTS)])
def test_render_text_and_validation_match_jax(etype, fields):
    ev = {"schema": 1, "ts": 1.5, "type": etype, **fields}
    assert render_text(ev) == jevents.render_text(ev)
    validate_event(ev)
    jschema.validate_event(ev)
    for k in schema.EVENT_FIELDS[etype]:  # each required field, missing, is refused by both
        short = {f: v for f, v in ev.items() if f != k}
        with pytest.raises(ValueError, match=k):
            validate_event(short)
        with pytest.raises(ValueError, match=k):
            jschema.validate_event(short)


@pytest.mark.parametrize("ev", [
    [], {"schema": 2, "ts": 0.0, "type": "run_start", "kind": "x"},
    {"schema": 1, "ts": "0", "type": "run_start", "kind": "x"},
    {"schema": 1, "ts": True, "type": "run_start", "kind": "x"},
    {"schema": 1, "ts": 0.0, "type": "no_such_event"},
    {"ts": 0.0, "type": "run_start", "kind": "x"}])
def test_both_validators_refuse(ev):
    with pytest.raises(ValueError) as ours:
        validate_event(ev)
    with pytest.raises(ValueError) as theirs:
        jschema.validate_event(ev)
    assert str(ours.value) == str(theirs.value)


def test_validate_lines_name_the_line(tmp_path):
    good = json.dumps({"schema": 1, "ts": 0.0, "type": "run_start", "kind": "x"})
    bad = json.dumps({"schema": 1, "ts": 0.0, "type": "rank_adapt"})
    p = tmp_path / "e.jsonl"
    p.write_text(f"{good}\n\n{good}\n{bad}\n")
    with pytest.raises(ValueError, match="line 4"):
        validate_file(p)
    p.write_text(f"{good}\n\n{good}\n")
    assert validate_file(p) == jschema.validate_file(p) == 2


def test_disabled_log_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    log = EventLog(None)
    assert not log.enabled and not log.active and not NULL_LOG.active
    ev = log.emit("run_start", kind="train")
    assert ev["type"] == "run_start" and ev["schema"] == 1
    with log.span("phase_swap", epoch=1, phase=0) as extra:
        extra["boundary"] = 1
    log.close()
    assert list(tmp_path.iterdir()) == []


def test_log_writes_what_jax_writes(tmp_path):
    """The same emits through both logs: files equal but for the stamps."""
    seen, jseen = [], []
    for log_cls, d, out in ((EventLog, "port", seen), (jevents.EventLog, "jax", jseen)):
        (tmp_path / d).mkdir()
        with log_cls(tmp_path / d / "events.jsonl", mirror=out.append, fmt="text") as log:
            assert log.enabled and log.active
            log.emit("run_start", _mirror=False, kind="train")
            log.emit("train_step", **_step(loss=np.float32(2.5)))
            log.emit("train_step", _mirror=False, **_step(step=8))
            with log.span("phase_swap", epoch=1, phase=0) as extra:
                extra["boundary"] = 1
            with pytest.raises(ValueError):
                log.emit("train_step", step=0)
            log.emit("run_end", _mirror=False, kind="train")

    def stripped(d):
        rows = [json.loads(line) for line in (tmp_path / d / "events.jsonl").read_text()
                .splitlines()]
        assert all(r.pop("ts") > 0 for r in rows)
        assert rows[3].pop("dur_s") >= 0
        return rows

    assert stripped("port") == stripped("jax")
    assert seen == jseen and len(seen) == 2
    assert seen[0] == "step     7 epoch   1 phase  0 loss 2.5000 gnorm 1.250 50ms"
    assert seen[1] == "[phase] epoch 1: now training group 1, group 0 frozen out of the step"
    assert validate_file(tmp_path / "port" / "events.jsonl") == 5


def test_jsonl_mirror_prints_the_serialized_event(tmp_path):
    seen = []
    with EventLog(None, mirror=seen.append, fmt="jsonl") as log:
        ev = log.emit("serve_step", active_slots=2, queued=1)
        log.emit("run_start", _mirror=False, kind="serve")
    assert len(seen) == 1 and json.loads(seen[0]) == ev
    seen.clear()
    with EventLog(tmp_path / "e.jsonl", mirror=seen.append, fmt="jsonl") as log:
        log.emit("run_start", kind="serve")
    assert seen == (tmp_path / "e.jsonl").read_text().splitlines()
    with pytest.raises(ValueError, match="fmt"):
        EventLog(None, fmt="xml")


def test_the_validator_cli(tmp_path):
    p = tmp_path / "events.jsonl"
    with EventLog(p) as log:
        log.emit("run_start", kind="train")
        log.emit("run_end", kind="train")
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", str(p)], capture_output=True,
                         text=True, timeout=120, env={"PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0 and out.stdout.strip() == f"{p}: 2 events OK (schema v1)"
    (tmp_path / "empty.jsonl").write_text("")
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", str(tmp_path / "empty.jsonl")],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src")})
    assert out.returncode != 0 and "no events" in out.stderr


def _fixture_events():
    """tests/test_obs.py's report fixture: two segments, a rank boundary,
    and serving events beside them."""
    def step(i, phase, dt, sync, trainable, rank):
        return {"schema": 1, "ts": float(i), "type": "train_step", "step": i, "epoch": i // 2,
                "phase": phase, "loss": 1.0 + i, "grad_norm": 0.1, "step_time_s": dt,
                "tokens_per_s": 64 / dt, "total_rank": rank, "trainable_bytes": trainable,
                "frozen_bytes": 100 - trainable, "opt_bytes": trainable,
                "sync_bytes_per_step": sync}

    def ev(t, **kw):
        return {"schema": 1, "ts": 0.0, "type": t, **kw}

    return [
        ev("run_start", kind="train"),
        step(0, -1, 0.10, 1000, 80, 12), step(1, -1, 0.12, 1000, 80, 12),
        ev("phase_swap", epoch=1, phase=0, dur_s=0.01),
        ev("rank_adapt", epoch=1, boundary=1, shrunk={"g": "12->8"}, rank_map={"g": 8}),
        step(2, 0, 0.08, 600, 50, 8), step(3, 0, 0.09, 600, 50, 8),
        ev("resume", step=4, phase=1), step(4, 1, 0.07, 600, 40, 8),
        ev("run_end", kind="train"),
        ev("request_queued", rid=0, prompt_len=8, max_new=4),
        ev("request_queued", rid=1, prompt_len=5, max_new=4),
        ev("request_prefill", rid=0, slot=0, fed_len=8, resume=False, queue_wait_s=0.0,
           prefix_hit_len=4),
        ev("request_first_token", rid=0, ttft_s=0.02),
        ev("request_prefill", rid=1, slot=1, fed_len=5, resume=False, queue_wait_s=0.01,
           prefix_hit_len=0),
        ev("request_first_token", rid=1, ttft_s=0.03),
        ev("serve_step", active_slots=2, queued=0, pool_used=5, pool_free=3,
           pool_high_water=5),
        ev("request_preempted", rid=1, generated=2),
        ev("request_prefill", rid=1, slot=1, fed_len=6, resume=True, queue_wait_s=0.01,
           prefix_hit_len=0),
        ev("request_retired", rid=0, latency_s=0.1, tokens=4, preemptions=0,
           drafted_tokens=6, accepted_tokens=5),
        ev("request_retired", rid=1, latency_s=0.2, tokens=4, preemptions=1,
           drafted_tokens=6, accepted_tokens=2),
        ev("spec_step", drafted=4, accepted=3, emitted=5, acceptance_rate=0.75),
    ]


def test_report_matches_jax_on_the_same_events(tmp_path, capsys):
    events = _fixture_events()
    rows = obs_report.train_attribution(events)
    assert rows == jreport.train_attribution(events)
    assert [r["phase"] for r in rows] == [-1, 0, 1]
    assert rows[1]["rank_adapted"] and rows[1]["d_total_rank"] == -4
    assert obs_report.render_train(rows) == jreport.render_train(rows)
    summary = obs_report.serve_summary(events)
    assert summary == jreport.serve_summary(events)
    assert summary["compiles"] == {} and summary["preempted_requests"] == 1
    assert obs_report.render_serve(summary) == jreport.render_serve(summary)
    p = tmp_path / "events.jsonl"
    p.write_text("".join(json.dumps(e) + "\n" for e in events))
    assert obs_report.load_events(p) == jreport.load_events(p) == events
    out = obs_report.report([str(p)], json_out=str(tmp_path / "r.json"))
    ours = capsys.readouterr().out
    jout = jreport.report([str(p)], json_out=str(tmp_path / "j.json"))
    assert out == jout and ours.replace("r.json", "j.json") == capsys.readouterr().out
    assert json.loads((tmp_path / "r.json").read_text())["serve"] == json.loads(
        (tmp_path / "j.json").read_text())["serve"]
    assert obs_report.main([str(p)]) == 0


def test_kernel_fallbacks_counter():
    """Every plain-path decision of the dispatcher increments
    ``kernel_fallbacks{op, reason}``, as the reference's does; CPU tensors
    are ``platform``, the policy off ``disabled``."""
    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    try:
        g = torch.Generator().manual_seed(0)
        x = torch.randn(2, 5, 16, generator=g)
        u, v = torch.randn(16, 4, generator=g), torch.randn(4, 8, generator=g)
        with ops.capture_fallbacks() as sink:
            ops.lowrank_apply(x, u, v, use_kernel=True)
            ops.lowrank_apply(x, u, v, use_kernel=True)
            ops.lowrank_apply(x, u, v, use_kernel=False)
        c = reg.counter("kernel_fallbacks")
        assert c.value(op="lowrank_fwd", reason="platform") == 2
        assert c.value(op="lowrank_fwd", reason="disabled") == 1
        assert c.total() == len(sink) == 3
    finally:
        set_default_registry(prev)
