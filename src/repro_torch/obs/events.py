"""Structured event log: schema-versioned JSONL plus a console mirror.

A copy of ``repro/obs/events.py``.  ``EventLog`` is the single write
path for telemetry events (schema in :mod:`repro_torch.obs.schema`).
Constructed with ``path=None`` it writes NO file — the disabled
configuration costs one attribute check per call site and leaves no
JSONL behind — but can still mirror selected events
to the console, which is how the training driver keeps its legacy
human-readable lines (``[phase]``, ``[rank-adapt]``, ``[straggler]``,
``[resume]``, per-step) bit-identical whether or not telemetry is on.

``render_text`` is that mirror: it maps an event dict back to the exact
pre-telemetry console format (CI greps depend on these strings), or
``None`` for event types that never had a console line.  With
``fmt="jsonl"`` the mirror prints the serialized event instead.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, Optional

from repro_torch.obs.schema import SCHEMA_VERSION, validate_event


def render_text(ev: dict) -> Optional[str]:
    """Legacy console line for an event, or None if the type has no
    text form.  These formats are load-bearing: they predate the event
    log and existing CI greps / user habits expect them verbatim."""
    t = ev["type"]
    if t == "train_step":
        return (f"step {ev['step']:5d} epoch {ev['epoch']:3d} "
                f"phase {ev['phase']:2d} loss {ev['loss']:.4f} "
                f"gnorm {ev['grad_norm']:.3f} {ev['step_time_s']*1e3:.0f}ms")
    if t == "phase_swap":
        phase = ev["phase"]
        return (f"[phase] epoch {ev['epoch']}: now training group "
                f"{1 - phase}, group {phase} frozen out of the step")
    if t == "rank_adapt":
        shrunk = ev["shrunk"]
        return (f"[rank-adapt] boundary truncated {len(shrunk)} group(s): "
                f"{shrunk}")
    if t == "straggler":
        return (f"[straggler] step {ev['step']}: {ev['step_time_s']*1e3:.0f}ms "
                f"(median {ev['median_s']*1e3:.0f}ms)")
    if t == "resume":
        return (f"[resume] from step {ev['step']} (phase {ev['phase']}, "
                f"saved on mesh {ev.get('src_mesh', '?')} -> restored onto "
                f"{ev.get('mesh', '?')})")
    if t == "profile_window":
        return (f"[profile] traced steps {ev['start_step']}..."
                f"{ev['stop_step']} -> {ev['trace_dir']}")
    return None


class EventLog:
    """Append-only JSONL event writer with an optional console mirror.

    * ``path=None`` — no file is ever created (telemetry disabled); the
      mirror still runs, so console output is format-independent.
    * ``mirror`` — a ``callable(str)`` (usually ``print``); ``fmt``
      selects what it receives: ``"text"`` → :func:`render_text` lines
      (events with no text form stay silent), ``"jsonl"`` → the
      serialized event.

    Every emitted event is validated against the schema at write time so
    producers can't drift from :mod:`repro_torch.obs.schema` silently.
    """

    def __init__(self, path=None, *,
                 mirror: Optional[Callable[[str], None]] = None,
                 fmt: str = "text"):
        if fmt not in ("text", "jsonl"):
            raise ValueError(f"fmt must be 'text' or 'jsonl', got {fmt!r}")
        self.path = str(path) if path is not None else None
        self.mirror = mirror
        self.fmt = fmt
        self._f = open(self.path, "w") if self.path is not None else None

    @property
    def enabled(self) -> bool:
        """True when events are being persisted to disk."""
        return self._f is not None

    @property
    def active(self) -> bool:
        """True when emitting has any effect (file or mirror) — hot loops
        may skip event construction entirely when this is False."""
        return self._f is not None or self.mirror is not None

    def emit(self, etype: str, _mirror: bool = True, **fields) -> dict:
        """Append one event; returns the event dict.

        ``_mirror=False`` suppresses the console mirror for this event
        only (e.g. per-step records are logged every step but printed
        only every ``--log-every``)."""
        ev = {"schema": SCHEMA_VERSION, "ts": time.time(),
              "type": etype, **fields}
        validate_event(ev)
        line = None
        if self._f is not None:
            line = json.dumps(ev, default=_jsonable)
            self._f.write(line + "\n")
            self._f.flush()
        if self.mirror is not None and _mirror:
            if self.fmt == "jsonl":
                self.mirror(line if line is not None
                            else json.dumps(ev, default=_jsonable))
            else:
                txt = render_text(ev)
                if txt is not None:
                    self.mirror(txt)
        return ev

    @contextlib.contextmanager
    def span(self, etype: str, _mirror: bool = True, **fields):
        """Context manager emitting ``etype`` with a ``dur_s`` field on
        exit.  Yields a dict; keys added to it land on the event — use it
        to attach results computed inside the span."""
        t0 = time.perf_counter()
        extra: dict = {}
        try:
            yield extra
        finally:
            merged = dict(fields)
            merged.update(extra)
            self.emit(etype, _mirror=_mirror,
                      dur_s=time.perf_counter() - t0, **merged)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(obj):
    """Fallback serializer: numpy scalars -> python, everything else str."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(obj)


#: Shared inert log: no file, no mirror.  Call sites can hold this
#: instead of None and skip the null checks.
NULL_LOG = EventLog(None)
