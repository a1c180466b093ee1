"""Process-wide metrics registry: Counter / Gauge / Histogram with labeled
children and Prometheus text exposition — the port's copy of
``torchft_tpu/telemetry/registry.py``, unchanged, so both packages render
the same bytes for the same calls.

The reference exports no metrics at all (SURVEY §5.5); the native
lighthouse grew a /metrics endpoint (native/coord.cc) but the Python FT
runtime — where quorum latency, heal cost and allreduce traffic actually
happen — had only ad-hoc ``logging`` lines. This registry is the substrate:
dependency-free, thread-safe, cheap enough for hot paths (a counter inc is
one lock + one float add), rendered on demand in Prometheus text format
(version 0.0.4) or dumped as a plain dict snapshot.

Semantics follow the Prometheus client-library conventions:

* a metric created with ``labelnames`` is a *family*; ``labels(...)``
  returns (creating on first use) the child for one label-value tuple and
  the family itself cannot be observed directly;
* a metric created without labels is its own single child;
* histograms use cumulative ``le`` buckets plus ``+Inf``, ``_sum`` and
  ``_count`` series.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
]

# Latency-oriented default: sub-ms collectives up through minute-scale
# heals land in distinct buckets.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

_LabelValues = Tuple[str, ...]


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


def _labels_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label_value(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Metric:
    """Shared family machinery: child creation, rendering, dumping.

    A family with labelnames holds one child per label-value tuple; a
    label-less family is its own single child (keyed by ``()``).
    """

    type_name = "untyped"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        **kwargs,
    ) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._kwargs = kwargs
        self._lock = threading.Lock()
        self._children: Dict[_LabelValues, _Metric] = {}
        if not self.labelnames:
            self._children[()] = self

    def labels(self, *values, **kw) -> "_Metric":
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by name")
            try:
                values = tuple(kw[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e} (have {self.labelnames})"
                ) from e
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {values}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = type(self)(self.name, self.help, (), **self._kwargs)
                self._children[values] = child
            return child

    def _check_observable(self) -> None:
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; "
                f"call .labels(...) first"
            )

    def _snapshot_children(self) -> List[Tuple[_LabelValues, "_Metric"]]:
        with self._lock:
            return sorted(self._children.items())

    def reset(self) -> None:
        """Zero every child's observations IN PLACE (instrumented modules
        hold child references, so dropping children would silently orphan
        their future observations)."""
        for _values, child in self._snapshot_children():
            child._reset_values()

    def _reset_values(self) -> None:
        raise NotImplementedError

    # subclasses implement:
    def _render_child(
        self, names: Sequence[str], values: _LabelValues
    ) -> List[str]:
        raise NotImplementedError

    def _dump_child(self) -> Dict:
        raise NotImplementedError

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.type_name}",
        ]
        for values, child in self._snapshot_children():
            lines.extend(child._render_child(self.labelnames, values))
        return lines

    def dump(self) -> Dict:
        return {
            "type": self.type_name,
            "help": self.help,
            "labelnames": list(self.labelnames),
            "samples": [
                {
                    "labels": dict(zip(self.labelnames, values)),
                    **child._dump_child(),
                }
                for values, child in self._snapshot_children()
            ],
        }


class Counter(_Metric):
    """Monotonically increasing value."""

    type_name = "counter"

    def __init__(self, name, help="", labelnames=(), **kwargs) -> None:
        self._value = 0.0
        super().__init__(name, help, labelnames, **kwargs)

    def inc(self, amount: float = 1.0) -> None:
        self._check_observable()
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render_child(self, names, values) -> List[str]:
        return [f"{self.name}{_labels_str(names, values)} "
                f"{_format_value(self.value)}"]

    def _dump_child(self) -> Dict:
        return {"value": self.value}

    def _reset_values(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge(_Metric):
    """Value that can go up and down."""

    type_name = "gauge"

    def __init__(self, name, help="", labelnames=(), **kwargs) -> None:
        self._value = 0.0
        super().__init__(name, help, labelnames, **kwargs)

    def set(self, value: float) -> None:
        self._check_observable()
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._check_observable()
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render_child(self, names, values) -> List[str]:
        return [f"{self.name}{_labels_str(names, values)} "
                f"{_format_value(self.value)}"]

    def _dump_child(self) -> Dict:
        return {"value": self.value}

    def _reset_values(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    type_name = "histogram"

    def __init__(
        self,
        name,
        help="",
        labelnames=(),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        **kwargs,
    ) -> None:
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = tuple(bounds)
        self._counts = [0] * (len(bounds) + 1)  # +1 for +Inf
        self._sum = 0.0
        super().__init__(name, help, labelnames, buckets=self.buckets, **kwargs)

    def observe(self, value: float) -> None:
        self._check_observable()
        value = float(value)
        idx = len(self.buckets)
        for i, b in enumerate(self.buckets):
            if value <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += value

    @contextmanager
    def time(self) -> Iterator[None]:
        """Observe the wall-clock duration of a block."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def raw_counts(self) -> List[int]:
        """Raw (non-cumulative) per-bucket counts, last slot is +Inf.

        Mergeable representation: folding N histograms on the same grid is
        elementwise addition, which the fleet-rollup path relies on.
        """
        with self._lock:
            return list(self._counts)

    def snapshot(self) -> Dict:
        """Cumulative bucket counts + sum + count, read under one lock."""
        with self._lock:
            counts = list(self._counts)
            total_sum = self._sum
        cumulative: List[int] = []
        acc = 0
        for c in counts:
            acc += c
            cumulative.append(acc)
        return {
            "buckets": {
                _format_value(b): cumulative[i]
                for i, b in enumerate(self.buckets)
            },
            "count": acc,
            "sum": total_sum,
        }

    def quantile(self, q: float) -> Optional[float]:
        """Approximate quantile interpolated within bucket bounds (the
        scrape-side ``histogram_quantile`` estimate; None when empty).
        Observations past the last bound clamp to it."""
        with self._lock:
            counts = list(self._counts)
        total = sum(counts)
        if not total:
            return None
        target = q * total
        acc = 0
        lo = 0.0
        for i, b in enumerate(self.buckets):
            nxt = acc + counts[i]
            if nxt >= target and counts[i]:
                frac = (target - acc) / counts[i]
                return lo + (b - lo) * min(1.0, max(0.0, frac))
            acc = nxt
            lo = b
        return self.buckets[-1]

    def _render_child(self, names, values) -> List[str]:
        snap = self.snapshot()
        le_names = tuple(names) + ("le",)
        lines = [
            f"{self.name}_bucket{_labels_str(le_names, values + (b,))} {c}"
            for b, c in snap["buckets"].items()
        ]
        lines.append(
            f"{self.name}_bucket{_labels_str(le_names, values + ('+Inf',))} "
            f"{snap['count']}"
        )
        lines.append(
            f"{self.name}_sum{_labels_str(names, values)} "
            f"{_format_value(snap['sum'])}"
        )
        lines.append(
            f"{self.name}_count{_labels_str(names, values)} {snap['count']}"
        )
        return lines

    def _dump_child(self) -> Dict:
        return self.snapshot()

    def _reset_values(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0


class MetricsRegistry:
    """Thread-safe get-or-create registry of metric families.

    ``counter/gauge/histogram`` are idempotent by name: repeat calls return
    the existing family, so module-level instrumentation and tests can both
    name a metric without coordinating construction order. A name clash
    across types raises — silent type morphing would corrupt scrapes.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kwargs) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise ValueError(
                        f"metric {name} already registered as {m.type_name}"
                    )
                if tuple(labelnames) != m.labelnames:
                    # a silent schema mismatch would hand the second
                    # registrant a family whose observe/inc raises later,
                    # ON the hot path — fail at registration instead
                    raise ValueError(
                        f"metric {name} already registered with labels "
                        f"{m.labelnames}, not {tuple(labelnames)}"
                    )
                buckets = kwargs.get("buckets")
                if buckets is not None:
                    req = tuple(sorted(float(b) for b in buckets))
                    # DEFAULT_BUCKETS counts as "unspecified": a plain
                    # get-by-name must not raise against a custom family
                    if req != m.buckets and req != DEFAULT_BUCKETS:
                        raise ValueError(
                            f"metric {name} already registered with "
                            f"buckets {m.buckets}, not {req}"
                        )
                return m
            m = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(), buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self) -> None:
        """Drop every registered family (tests)."""
        with self._lock:
            self._metrics.clear()

    def reset_values(self) -> None:
        """Zero every family's observations in place (tests) — safer than
        :meth:`clear` when instrumented modules hold family references."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: List[str] = []
        for _name, m in metrics:
            out.extend(m.render())
        return "\n".join(out) + "\n"

    def dump(self) -> Dict[str, Dict]:
        """Plain-dict snapshot of every family (JSON-serializable)."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {name: m.dump() for name, m in metrics}
