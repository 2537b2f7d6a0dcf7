"""In-process metrics registry: counters, gauges, histograms with labels.

A copy of ``repro/obs/registry.py``: the same metrics, labels,
percentiles and snapshot layout.

Stdlib-only by design (the telemetry layer must not add dependencies).
A metric is identified by name; each distinct label set (a dict of
string keys) gets its own series inside the metric, keyed by the sorted
``(key, value)`` tuple so ``{a: 1, b: 2}`` and ``{b: 2, a: 1}`` are the
same series.

A process-global default registry (``default_registry()``) is what the
kernel dispatchers (``kernels/ops.py``) and the scheduler feed — callers
that want isolation (tests, concurrent runs) install their own via
``set_default_registry`` or pass an explicit registry around.

Histograms keep raw observations and compute percentiles on demand with
linear interpolation (numpy.percentile semantics) — observation volumes
here are per-step / per-request, small enough that exactness beats
bucketing.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, object] = {}
        self._lock = threading.Lock()

    def _get(self, labels: Dict[str, object], default):
        key = _label_key(labels)
        with self._lock:
            if key not in self._series:
                self._series[key] = default()
            return key

    def series(self) -> Dict[LabelKey, object]:
        with self._lock:
            return dict(self._series)


class Counter(_Metric):
    """Monotonically increasing count per label set."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        key = self._get(labels, float)
        with self._lock:
            self._series[key] = float(self._series[key]) + n

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(_Metric):
    """Last-set value per label set."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        key = self._get(labels, float)
        with self._lock:
            self._series[key] = float(v)

    def value(self, **labels) -> Optional[float]:
        got = self._series.get(_label_key(labels))
        return None if got is None else float(got)


def percentile(values: Iterable[float], q: float) -> float:
    """Linear-interpolated percentile (numpy default semantics), stdlib-only."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of empty series")
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


class Histogram(_Metric):
    """Raw-observation histogram; percentiles computed on demand."""

    kind = "histogram"

    def observe(self, v: float, **labels) -> None:
        key = self._get(labels, list)
        with self._lock:
            self._series[key].append(float(v))

    def values(self, **labels) -> List[float]:
        return list(self._series.get(_label_key(labels), ()))

    def count(self, **labels) -> int:
        return len(self._series.get(_label_key(labels), ()))

    def percentile(self, q: float, **labels) -> float:
        return percentile(self.values(**labels), q)

    def summary(self, **labels) -> Dict[str, float]:
        xs = self.values(**labels)
        if not xs:
            return {"count": 0, "sum": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "count": len(xs),
            "sum": float(sum(xs)),
            "p50": percentile(xs, 50),
            "p95": percentile(xs, 95),
            "p99": percentile(xs, 99),
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create home for named metrics.

    Re-requesting a name with a different kind is a programming error and
    raises — two subsystems silently sharing a name with different
    semantics is exactly the bug a registry exists to prevent.
    """

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, kind: str, name: str, help: str) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _KINDS[kind](name, help)
                self._metrics[name] = m
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create("counter", name, help)  # type: ignore

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create("gauge", name, help)  # type: ignore

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_create("histogram", name, help)  # type: ignore

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Plain-dict dump: name -> {kind, series: {label-str: value}}.

        Histogram series dump their summary (count/sum/p50/p95/p99), not
        the raw observations.
        """
        out: Dict[str, Dict[str, object]] = {}
        for name, m in list(self._metrics.items()):
            series = {}
            for key, val in m.series().items():
                label = ",".join(f"{k}={v}" for k, v in key) or ""
                if m.kind == "histogram":
                    labels = dict(key)
                    series[label] = m.summary(**labels)  # type: ignore
                else:
                    series[label] = val
            out[name] = {"kind": m.kind, "series": series}
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry fed by kernels/autotune/serving."""
    return _DEFAULT


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the previous one."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = reg
    return prev
