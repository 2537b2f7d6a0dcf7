"""Telemetry: metrics registry, structured events, spans.

The counterpart of ``repro/obs``, stdlib only, threaded through the train
CLI (``launch/train.py``), the serve CLI and scheduler
(``launch/serve.py``, ``serving/scheduler.py``) and the kernel
dispatchers (``kernels/ops.py``'s ``kernel_fallbacks`` counter).

Two complementary pipes:

* :mod:`repro_torch.obs.registry` — in-process counters / gauges /
  histograms with labels, snapshotted on demand (kernel fallbacks, slot
  occupancy, pool utilization, speculative acceptance).
* :mod:`repro_torch.obs.events` — schema-versioned JSONL event log
  (:mod:`repro_torch.obs.schema`) appended to the run directory, read by
  ``analysis/obs_report.py``.

    python -m repro_torch.obs run_dir/events.jsonl   # validate a trace
"""

from repro_torch.obs.events import NULL_LOG, EventLog, render_text
from repro_torch.obs.registry import (Counter, Gauge, Histogram, MetricsRegistry,
                                      default_registry, set_default_registry)
from repro_torch.obs.schema import SCHEMA_VERSION, validate_event, validate_file, validate_lines

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "set_default_registry",
    "EventLog", "NULL_LOG", "render_text",
    "SCHEMA_VERSION", "validate_event", "validate_file", "validate_lines",
]
