"""One process-wide metrics registry: counters, gauges, histograms and
shape sketches (port of ``deepdfa_tpu/telemetry/registry.py``).

``ServingStats`` and ``IngestStats`` (``core/metrics.py``) keep their own
snapshot views, but every bump is mirrored here, so one Prometheus text
exposition (:meth:`Registry.prometheus_text`, the serve ``/metrics``
endpoint's text face) sees the whole process.

Thread-safety: creating a metric takes the registry's lock; each metric
carries its own lock for mutation (serve admission bumps from many
transport threads at once).

Names follow Prometheus conventions; :func:`sanitize` coerces free-form
strings (``reason:v1``) into legal metric names. The text exposition is
byte for byte the reference's after the same operations.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Mapping, Optional, Union

# Colons are legal in Prometheus names but reserved for recording rules;
# exposition names here stay [a-zA-Z_][a-zA-Z0-9_]*.
_NAME_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_]")


def sanitize(name: str) -> str:
    """Free-form string -> legal Prometheus metric-name fragment."""
    out = _BAD_CHARS.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


class Counter:
    """Monotonic counter (``*_total`` by convention)."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, by: Union[int, float] = 1) -> None:
        if by < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += by

    @property
    def value(self) -> Union[int, float]:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (queue depth, ring occupancy)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """count/sum plus a bounded sample ring for offline quantiles.

    Not a bucketed Prometheus histogram: the exposition publishes
    ``_count``/``_sum`` (enough for rate/mean panels) and the snapshot
    adds p50/p99 over the most recent ``window`` observations — the same
    rolling-quantile convention ``ServingStats`` uses.
    """

    kind = "histogram"

    def __init__(self, name: str, window: int = 4096):
        self.name = name
        self._lock = threading.Lock()
        self._window = window
        self._ring: List[float] = [0.0] * window
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self._ring[self._count % self._window] = float(value)
            self._count += 1
            self._sum += float(value)

    def _samples(self) -> List[float]:
        with self._lock:
            n = min(self._count, self._window)
            return list(self._ring[:n])

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the sample window (the
        ``core.metrics.latency_quantile`` convention: a value some
        observation actually took)."""
        xs = sorted(self._samples())
        if not xs:
            return 0.0
        rank = min(int(-(-q * len(xs) // 1)) - 1, len(xs) - 1)
        return xs[max(rank, 0)]

    @property
    def value(self) -> Dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
        return {
            "count": count,
            "sum": total,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
        }


_Metric = Union[Counter, Gauge, Histogram]


class Registry:
    """Create-or-get metric store; kind conflicts are programming errors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, name: str, cls, **kw) -> _Metric:
        if not _NAME_OK.match(name):
            raise ValueError(f"illegal metric name {name!r} "
                             "(use registry.sanitize)")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._get(name, Histogram, window=window)

    def sketch(self, name: str):
        """Create-or-get a bounded shape sketch
        (:class:`deepdfa_tpu_torch.telemetry.sketch.ShapeSketch`): fixed
        log-spaced bins, exact merge, no unbounded sample list."""
        from deepdfa_tpu_torch.telemetry.sketch import ShapeSketch
        return self._get(name, ShapeSketch)

    def sketches(self) -> List:
        """Every registered sketch (the traffic flush hook iterates
        these to emit final ``traffic.shape`` events)."""
        with self._lock:
            return [m for m in self._metrics.values()
                    if getattr(m, "kind", "") == "sketch"]

    def reset(self) -> None:
        """Drop every metric — test isolation only."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> Dict[str, object]:
        """JSON-able {name: value} (histograms expand to count/sum/p50/p99)."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.value for name, m in sorted(metrics.items())}

    def prometheus_text(
        self, extra: Optional[Mapping[str, float]] = None,
        prefix: str = "deepdfa_",
    ) -> str:
        """Prometheus text exposition (version 0.0.4) of every metric,
        plus ``extra`` numeric values exposed as gauges (the serve
        endpoint passes its ``ServingStats`` snapshot through here)."""
        with self._lock:
            metrics = dict(self._metrics)
        lines: List[str] = []
        for name, m in sorted(metrics.items()):
            full = prefix + name
            lines.append(f"# TYPE {full} {m.kind}")
            if getattr(m, "kind", "") in ("histogram", "sketch"):
                v = m.value
                lines.append(f"{full}_count {_fmt(v['count'])}")
                lines.append(f"{full}_sum {_fmt(v['sum'])}")
            else:
                lines.append(f"{full} {_fmt(m.value)}")
        for name, value in sorted((extra or {}).items()):
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                continue
            full = prefix + sanitize(name)
            lines.append(f"# TYPE {full} gauge")
            lines.append(f"{full} {_fmt(value)}")
        return "\n".join(lines) + "\n"


def _fmt(v: Union[int, float]) -> str:
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


# THE process registry every subsystem publishes into.
REGISTRY = Registry()
