"""Per-phase attribution report over a telemetry JSONL trace.

The counterpart of ``repro/analysis/obs_report.py``, line for line.
Consumes the event stream written by ``repro_torch.obs.EventLog`` (training
and/or serving events, schema v1) and produces the live counterpart of
the paper's Tables 1–4: per freezing phase and per rank-truncation
boundary, what happened to step time, throughput, cross-device sync
bytes, and the trainable partition — computed from the recorded
``train_step`` records, not re-measured.

The trace is split into segments at every ``phase_swap`` (and at
``resume``); a ``rank_adapt`` event marks the segment it opens as a
truncation boundary.  Per segment the report gives the median step time
(median, not mean: the first step of a segment may pay a warm-up), mean
tokens/s, the step's sync bytes (0 in the port, which trains on one
device), partition bytes (``steps.partition_bytes``) and summed live
rank, plus deltas against the previous segment.  A port trace has no
``compile_cache`` events, so its serving summary's ``compiles`` map is
empty.

    PYTHONPATH=src python -m repro_torch.analysis.obs_report run/events.jsonl
    ... [--json report.json]
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import schema


def load_events(path) -> List[dict]:
    """Read + schema-validate a JSONL trace; returns events in file order."""
    events = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            try:
                schema.validate_event(ev)
            except ValueError as e:
                raise ValueError(f"{path}:{i}: {e}") from None
            events.append(ev)
    return events


# -------------------------------------------------------------------------
# Training attribution
# -------------------------------------------------------------------------

def train_attribution(events: List[dict]) -> List[Dict]:
    """Per-phase-segment rows with deltas vs the previous segment."""
    segments: List[Dict] = []
    cur: Optional[Dict] = None

    def open_segment(**meta):
        nonlocal cur
        cur = {"steps": [], "boundary": None, "rank_adapted": False,
               "truncated_groups": 0, **meta}
        segments.append(cur)

    for ev in events:
        t = ev["type"]
        if t == "phase_swap":
            open_segment(phase=ev["phase"], epoch=ev["epoch"],
                         boundary=ev.get("boundary"))
        elif t == "rank_adapt" and cur is not None:
            cur["rank_adapted"] = True
            cur["boundary"] = ev["boundary"]
            cur["truncated_groups"] = len(ev["shrunk"])
        elif t == "resume":
            open_segment(phase=ev["phase"], epoch=None, boundary=None)
        elif t == "train_step":
            if cur is None or cur.get("phase") != ev["phase"]:
                # trace starts mid-stream (or first segment): open on the
                # first step record of each phase
                open_segment(phase=ev["phase"], epoch=ev["epoch"],
                             boundary=None)
            cur["steps"].append(ev)

    rows: List[Dict] = []
    prev: Optional[Dict] = None
    for i, seg in enumerate(segments):
        steps = seg["steps"]
        if not steps:
            continue
        dts = np.asarray([s["step_time_s"] for s in steps])
        last = steps[-1]
        row = {
            "segment": i,
            "phase": seg["phase"],
            "epoch": steps[0]["epoch"],
            "boundary": seg["boundary"],
            "rank_adapted": seg["rank_adapted"],
            "truncated_groups": seg["truncated_groups"],
            "steps": len(steps),
            "median_step_s": float(np.median(dts)),
            "mean_tokens_per_s": float(np.mean(
                [s["tokens_per_s"] for s in steps])),
            "sync_bytes_per_step": int(last["sync_bytes_per_step"]),
            "trainable_bytes": int(last["trainable_bytes"]),
            "frozen_bytes": int(last["frozen_bytes"]),
            "opt_bytes": int(last["opt_bytes"]),
            "total_rank": int(last["total_rank"]),
            "mean_loss": float(np.mean([s["loss"] for s in steps])),
        }
        if prev is not None:
            base = max(prev["median_step_s"], 1e-12)
            row["d_step_time_pct"] = float(
                100.0 * (row["median_step_s"] - prev["median_step_s"]) / base)
            row["d_sync_bytes"] = (row["sync_bytes_per_step"]
                                   - prev["sync_bytes_per_step"])
            row["d_trainable_bytes"] = (row["trainable_bytes"]
                                        - prev["trainable_bytes"])
            row["d_total_rank"] = row["total_rank"] - prev["total_rank"]
        rows.append(row)
        prev = row
    return rows


def render_train(rows: List[Dict]) -> str:
    if not rows:
        return "no train_step records in trace"
    hdr = (f"{'seg':>3} {'phase':>5} {'bndry':>5} {'adapt':>5} {'steps':>5} "
           f"{'rank':>5} {'med ms':>8} {'d-step%':>8} {'tok/s':>10} "
           f"{'sync B/step':>12} {'d-sync B':>10} {'trainable MB':>13}")
    lines = ["per-phase attribution (train):", hdr, "-" * len(hdr)]
    for r in rows:
        d_step = ("%+.1f" % r["d_step_time_pct"]
                  if "d_step_time_pct" in r else "-")
        d_sync = ("%+d" % r["d_sync_bytes"] if "d_sync_bytes" in r else "-")
        boundary = "-" if r["boundary"] is None else str(r["boundary"])
        lines.append(
            f"{r['segment']:>3} {r['phase']:>5} {boundary:>5} "
            f"{('yes' if r['rank_adapted'] else '-'):>5} "
            f"{r['steps']:>5} {r['total_rank']:>5} "
            f"{r['median_step_s']*1e3:>8.1f} {d_step:>8} "
            f"{r['mean_tokens_per_s']:>10.0f} "
            f"{r['sync_bytes_per_step']:>12d} {d_sync:>10} "
            f"{r['trainable_bytes']/1e6:>13.3f}")
    return "\n".join(lines)


# -------------------------------------------------------------------------
# Serving summary
# -------------------------------------------------------------------------

def _request_fields(events: List[dict]) -> Dict[str, list]:
    """Collect each ``RequestResult`` field's raw values from its source
    event, as named by :data:`schema.REQUEST_FIELD_EVENTS` — the shared
    vocabulary between the serving results, ``latency_stats`` and this
    report (no per-report key re-derivation)."""
    by_type: Dict[str, list] = {}
    for e in events:
        by_type.setdefault(e["type"], []).append(e)
    return {field: [e[key] for e in by_type.get(etype, []) if key in e]
            for field, (etype, key) in schema.REQUEST_FIELD_EVENTS.items()}


def serve_summary(events: List[dict]) -> Dict:
    """Aggregate the per-request lifecycle + per-step occupancy events."""
    retired = [e for e in events if e["type"] == "request_retired"]
    prefills = [e for e in events if e["type"] == "request_prefill"]
    steps = [e for e in events if e["type"] == "serve_step"]
    fields = _request_fields(events)
    out: Dict = {
        "queued": sum(1 for e in events if e["type"] == "request_queued"),
        "retired": len(retired),
        "preempt_events": sum(
            1 for e in events if e["type"] == "request_preempted"),
        "preempted_requests": sum(
            1 for p in fields["preemptions"] if p > 0),
        "generated_tokens": int(sum(fields["token_count"])),
        "drafted_tokens": int(sum(fields["drafted_tokens"])),
        "accepted_tokens": int(sum(fields["accepted_tokens"])),
        "serve_steps": len(steps),
        "compiles": {e["fn"]: e["compiles"] for e in events
                     if e["type"] == "compile_cache"},
    }
    if fields["latency_s"]:
        lat = np.asarray(fields["latency_s"])
        out["p50_latency_s"] = float(np.percentile(lat, 50))
        out["p99_latency_s"] = float(np.percentile(lat, 99))
    if fields["ttft_s"]:
        out["p50_ttft_s"] = float(np.percentile(fields["ttft_s"], 50))
    wait_key = schema.REQUEST_FIELD_EVENTS["queue_wait_s"][1]
    hit_key = schema.REQUEST_FIELD_EVENTS["prefix_hit_len"][1]
    fresh = [e for e in prefills if not e["resume"]]
    if fresh:
        out["p50_queue_wait_s"] = float(np.percentile(
            [e[wait_key] for e in fresh], 50))
        hits = [e[hit_key] for e in fresh if hit_key in e]
        out["prefix_lookups"] = len(hits)
        out["prefix_hits"] = sum(1 for h in hits if h > 0)
        out["prefix_hit_tokens"] = int(sum(hits))
    if steps:
        out["max_active_slots"] = int(max(e["active_slots"] for e in steps))
        hwm = [e["pool_high_water"] for e in steps if "pool_high_water" in e]
        if hwm:
            out["pool_high_water_blocks"] = int(max(hwm))
    return out


def render_serve(s: Dict) -> str:
    lines = ["serving summary:"]
    lines.append(
        f"  requests: {s['queued']} queued, {s['retired']} retired, "
        f"{s['preempted_requests']} preempted (of which "
        f"{s['preempt_events']} preemption event(s)); "
        f"{s['generated_tokens']} tokens over {s['serve_steps']} steps")
    if "p50_latency_s" in s:
        lines.append(
            f"  latency p50/p99: {s['p50_latency_s']*1e3:.1f}/"
            f"{s['p99_latency_s']*1e3:.1f} ms"
            + (f", ttft p50 {s['p50_ttft_s']*1e3:.1f} ms"
               if "p50_ttft_s" in s else "")
            + (f", queue-wait p50 {s['p50_queue_wait_s']*1e3:.1f} ms"
               if "p50_queue_wait_s" in s else ""))
    if "max_active_slots" in s:
        lines.append(
            f"  occupancy: max {s['max_active_slots']} active slot(s)"
            + (f", pool high-water {s['pool_high_water_blocks']} block(s)"
               if "pool_high_water_blocks" in s else ""))
    if s.get("prefix_hits"):
        lines.append(
            f"  prefix cache: {s['prefix_hits']}/{s['prefix_lookups']} "
            f"hit(s), {s['prefix_hit_tokens']} prompt token(s) reused")
    if s.get("drafted_tokens"):
        lines.append(
            f"  speculative: {s['accepted_tokens']}/{s['drafted_tokens']} "
            f"draft token(s) accepted")
    if s["compiles"]:
        compiled = ", ".join(f"{k}={v}" for k, v in s["compiles"].items())
        lines.append(f"  compile caches: {compiled}")
    return "\n".join(lines)


# -------------------------------------------------------------------------
# CLI
# -------------------------------------------------------------------------

def report(paths, json_out: Optional[str] = None) -> Dict:
    events: List[dict] = []
    for p in paths:
        events.extend(load_events(p))
    train_rows = train_attribution(events)
    out: Dict = {"events": len(events), "train": train_rows}
    if train_rows:
        print(render_train(train_rows))
    if any(e["type"].startswith("request_") or e["type"] == "serve_step"
           for e in events):
        serve = serve_summary(events)
        out["serve"] = serve
        if train_rows:
            print()
        print(render_serve(serve))
    if not train_rows and "serve" not in out:
        print(f"{len(events)} event(s), none attributable "
              "(no train_step or serving records)")
    if json_out:
        with open(json_out, "w") as f:
            json.dump(out, f, indent=1, default=str)
        print(f"\nwrote {json_out}")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="per-phase attribution report from telemetry JSONL")
    ap.add_argument("traces", nargs="+", help="events.jsonl file(s)")
    ap.add_argument("--json", default=None,
                    help="also write the report as JSON")
    args = ap.parse_args(argv)
    report(args.traces, json_out=args.json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
