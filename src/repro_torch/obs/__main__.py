"""CLI: validate telemetry JSONL files against the event schema.

    python -m repro_torch.obs run_dir/events.jsonl [more.jsonl ...]
"""

from repro_torch.obs.schema import main

if __name__ == "__main__":
    raise SystemExit(main())
