"""Process-wide metrics: counters, gauges, and reservoir histograms (copy of
``repro.obs.metrics``, stdlib only).

The serving/runtime counterpart of obs/trace.py: where spans answer
"where did THIS wall-clock go", metrics answer "what are the p50/p99 and
totals over the whole run". Stdlib-only, thread-safe, exportable two ways:

  * ``to_json()``      — structured dict (the ``BENCH_*.json`` /
    ``--metrics`` payload);
  * ``to_prometheus()``— Prometheus text exposition format (counters and
    gauges as-is, histograms as summaries with ``{quantile=...}`` series
    plus ``_count`` / ``_sum``), so a real scrape endpoint only has to
    serve the string.

Histograms use fixed-size uniform reservoir sampling (Vitter's algorithm
R, deterministic per-histogram RNG) so memory stays bounded no matter how
many requests a server answers, while quantiles stay unbiased estimates
of the full stream. Exact count / sum / min / max are tracked alongside
the reservoir.

``KCoreServer`` (``streaming/server.py``) owns a private registry (two
servers in one process must not merge their latency distributions);
engine/runtime-level totals go to
the process-wide default registry (``repro_torch.obs.metrics.counter(...)``),
dumped by the ``--metrics`` CLI flags.
"""

from __future__ import annotations

import math
import random
import re
import threading

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitize a metric name for the Prometheus exposition format."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_label_value(value) -> str:
    """Escape a label value per the exposition-format spec: backslash,
    double-quote, and newline must be escaped inside the quotes."""
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _prom_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{_prom_label_value(v)}"'
                     for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotone counter."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Uniform-reservoir histogram with p50/p95/p99 quantile estimates.

    ``observe`` is O(1); quantiles sort the bounded reservoir on demand.
    The reservoir (default 1024 samples) is an unbiased uniform sample of
    the whole observation stream (algorithm R); count / sum / min / max
    are exact.
    """

    __slots__ = ("_reservoir", "_size", "_count", "_sum", "_min", "_max",
                 "_rng", "_lock")

    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, reservoir_size: int = 1024):
        if reservoir_size < 1:
            raise ValueError("reservoir_size must be >= 1")
        self._reservoir: list[float] = []
        self._size = int(reservoir_size)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        # deterministic per-histogram stream: benchmarks and tests see
        # reproducible quantiles for a fixed observation sequence
        self._rng = random.Random(0x5EED)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)
            if len(self._reservoir) < self._size:
                self._reservoir.append(value)
            else:
                j = self._rng.randrange(self._count)
                if j < self._size:
                    self._reservoir[j] = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile estimate over the reservoir."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        with self._lock:
            sample = sorted(self._reservoir)
        if not sample:
            return math.nan
        pos = q * (len(sample) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(sample) - 1)
        frac = pos - lo
        return sample[lo] * (1.0 - frac) + sample[hi] * frac

    def snapshot(self) -> dict:
        with self._lock:
            empty = self._count == 0
            out = {
                "type": "histogram",
                "count": self._count,
                "sum": self._sum,
                "min": None if empty else self._min,
                "max": None if empty else self._max,
                "mean": None if empty else self._sum / self._count,
            }
        for q in self.QUANTILES:
            v = self.quantile(q)
            out[f"p{int(q * 100)}"] = None if math.isnan(v) else v
        return out


class MetricsRegistry:
    """Get-or-create registry keyed by (name, sorted label items)."""

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict, **kwargs):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                metric = self._metrics[key] = cls(**kwargs)
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r}{labels} already registered as "
                    f"{type(metric).__name__}")
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, reservoir_size: int = 1024,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels,
                         reservoir_size=reservoir_size)

    def reset(self) -> None:
        with self._lock:
            self._metrics = {}

    # ------------------------------------------------------------------ #
    def _items(self) -> list[tuple[str, tuple, object]]:
        with self._lock:
            items = list(self._metrics.items())
        return sorted(((name, labels, m) for (name, labels), m in items))

    def to_json(self) -> dict:
        """``{name: [{labels: {...}, **snapshot}, ...]}`` — every metric."""
        out: dict = {}
        for name, labels, metric in self._items():
            entry = {"labels": dict(labels)}
            entry.update(metric.snapshot())
            out.setdefault(name, []).append(entry)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (histograms as summaries)."""
        lines: list[str] = []
        seen_types: set[str] = set()
        for name, labels, metric in self._items():
            pname = _prom_name(name)
            if isinstance(metric, Counter):
                if pname not in seen_types:
                    lines.append(f"# TYPE {pname} counter")
                    seen_types.add(pname)
                lines.append(f"{pname}{_prom_labels(labels)} {metric.value}")
            elif isinstance(metric, Gauge):
                if pname not in seen_types:
                    lines.append(f"# TYPE {pname} gauge")
                    seen_types.add(pname)
                lines.append(f"{pname}{_prom_labels(labels)} {metric.value}")
            else:  # Histogram -> summary series
                if pname not in seen_types:
                    lines.append(f"# TYPE {pname} summary")
                    seen_types.add(pname)
                for q in Histogram.QUANTILES:
                    v = metric.quantile(q)
                    qlabels = labels + (("quantile", q),)
                    val = "NaN" if math.isnan(v) else repr(v)
                    lines.append(f"{pname}{_prom_labels(qlabels)} {val}")
                lines.append(
                    f"{pname}_sum{_prom_labels(labels)} {metric.sum}")
                lines.append(
                    f"{pname}_count{_prom_labels(labels)} {metric.count}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------- #
# Process-wide default registry.
# ---------------------------------------------------------------------- #

_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT


def counter(name: str, **labels) -> Counter:
    return _DEFAULT.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _DEFAULT.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return _DEFAULT.histogram(name, **labels)


def to_json() -> dict:
    return _DEFAULT.to_json()


def to_prometheus() -> str:
    return _DEFAULT.to_prometheus()


def reset() -> None:
    _DEFAULT.reset()
