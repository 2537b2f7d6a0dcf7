"""Event schema for the JSONL telemetry stream.

A copy of ``repro/obs/schema.py``: the port writes the same schema-v1
events as the JAX package, so the two ``EVENT_FIELDS`` and
``REQUEST_FIELD_EVENTS`` must stay equal dict for dict (the port's tests
hold them equal).  The port emits neither ``compile_cache`` nor
``phase_compile`` (it compiles no executable), and no benchmark writes
``bench_row`` yet; the types stay so the schemas stay equal.

Every event is one JSON object per line with a mandatory envelope::

    {"schema": 1, "ts": <unix seconds>, "type": "<event type>", ...}

``EVENT_FIELDS`` maps each event type to its REQUIRED payload fields.
Extra fields are always allowed (the schema is additive by design —
consumers must ignore what they don't know); missing required fields or
an unknown type fail validation.  Bump ``SCHEMA_VERSION`` only on a
breaking change (field removal / meaning change), never for additions.

Run the validator over files directly (CI does)::

    python -m repro_torch.obs.schema run_dir/events.jsonl [...]
"""

from __future__ import annotations

import json
from typing import Dict, Iterable

SCHEMA_VERSION = 1

# type -> required payload fields (beyond the schema/ts/type envelope).
EVENT_FIELDS: Dict[str, tuple] = {
    # lifecycle (train + serve + bench)
    "run_start": ("kind",),
    "run_end": ("kind",),
    # training (launch/train.py)
    "train_step": ("step", "epoch", "phase", "loss", "grad_norm",
                   "step_time_s", "tokens_per_s", "total_rank",
                   "trainable_bytes", "frozen_bytes", "opt_bytes",
                   "sync_bytes_per_step"),
    "phase_swap": ("epoch", "phase", "dur_s"),
    "rank_adapt": ("epoch", "boundary", "shrunk", "rank_map"),
    "phase_compile": ("phase", "sync_bytes_per_step", "collectives"),
    "straggler": ("step", "step_time_s", "median_s"),
    "resume": ("step", "phase"),
    "profile_window": ("start_step", "stop_step", "trace_dir"),
    # serving (serving/scheduler.py)
    "request_queued": ("rid", "prompt_len", "max_new"),
    "request_prefill": ("rid", "slot", "fed_len", "resume", "queue_wait_s",
                        "prefix_hit_len"),
    "request_first_token": ("rid", "ttft_s"),
    "request_retired": ("rid", "latency_s", "tokens", "preemptions"),
    "request_preempted": ("rid", "generated"),
    "serve_step": ("active_slots", "queued"),
    "spec_step": ("drafted", "accepted", "emitted", "acceptance_rate"),
    "compile_cache": ("fn", "compiles"),
    # benchmarks (benchmarks/common.py)
    "bench_row": ("bench", "row"),
}

# RequestResult field -> (event type, payload key) that reports it.  This is
# the shared vocabulary between serving/config.RequestResult, the scheduler's
# latency_stats and analysis/obs_report.py: consumers aggregate through this
# map instead of re-deriving payload keys by string convention.  Fields whose
# payload key differs from the dataclass name carry the historical event key.
REQUEST_FIELD_EVENTS: Dict[str, tuple] = {
    "rid": ("request_retired", "rid"),
    "token_count": ("request_retired", "tokens"),
    "prompt_len": ("request_queued", "prompt_len"),
    "queue_wait_s": ("request_prefill", "queue_wait_s"),
    "ttft_s": ("request_first_token", "ttft_s"),
    "latency_s": ("request_retired", "latency_s"),
    "preemptions": ("request_retired", "preemptions"),
    "prefix_hit_len": ("request_prefill", "prefix_hit_len"),
    "drafted_tokens": ("request_retired", "drafted_tokens"),
    "accepted_tokens": ("request_retired", "accepted_tokens"),
}

# every mapped (type, key) must be a declared (or additive-extra) payload key
# of a known serving event type; required keys must actually be required
for _f, (_etype, _key) in REQUEST_FIELD_EVENTS.items():
    assert _etype in EVENT_FIELDS, (_f, _etype)
del _f, _etype, _key


def validate_event(ev: dict) -> None:
    """Raise ValueError unless ``ev`` is a valid schema-v1 event."""
    if not isinstance(ev, dict):
        raise ValueError(f"event must be an object, got {type(ev).__name__}")
    if ev.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"schema version {ev.get('schema')!r} != {SCHEMA_VERSION}")
    ts = ev.get("ts")
    if not isinstance(ts, (int, float)) or isinstance(ts, bool):
        raise ValueError(f"ts must be numeric, got {ts!r}")
    etype = ev.get("type")
    if etype not in EVENT_FIELDS:
        raise ValueError(f"unknown event type {etype!r}")
    missing = [f for f in EVENT_FIELDS[etype] if f not in ev]
    if missing:
        raise ValueError(f"event {etype!r} missing fields {missing}")


def validate_lines(lines: Iterable[str]) -> int:
    """Validate JSONL lines; returns the event count, raises on the first
    malformed line (with its 1-based line number)."""
    n = 0
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
            validate_event(ev)
        except ValueError as e:
            raise ValueError(f"line {i}: {e}") from None
        n += 1
    return n


def validate_file(path) -> int:
    """Validate a JSONL file; returns the event count."""
    with open(path) as f:
        return validate_lines(f)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate telemetry JSONL files against the v%d schema"
        % SCHEMA_VERSION)
    ap.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    for path in args.files:
        n = validate_file(path)
        print(f"{path}: {n} events OK (schema v{SCHEMA_VERSION})")
        if n == 0:
            raise SystemExit(f"{path}: no events")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
