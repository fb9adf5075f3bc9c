"""Process-local metrics registry with the Prometheus text rendering
(``areal_tpu/observability/metrics.py``).

- Every name matches ``^areal_[a-z0-9_]+$`` and carries help text.
- Counters and histograms keep one cell per writing thread (created once
  under a lock, then written only by their thread), so ``inc`` and
  ``observe`` never contend; a scrape sums the cells. Gauges are one
  last-writer-wins slot.
- Label names are fixed per family; ``labels(**kv)`` resolves one child per
  label-value tuple.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Iterable, Mapping

_NAME_RE = re.compile(r"^areal_[a-z0-9_]+$")

# default histogram buckets: latency-shaped, seconds
DEFAULT_BUCKETS = (
    0.001,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
    30.0,
    60.0,
    120.0,
)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _labels_key(
    label_names: tuple[str, ...], kv: Mapping[str, str]
) -> tuple[str, ...]:
    if set(kv) != set(label_names):
        raise ValueError(
            f"labels {sorted(kv)} != declared label names {sorted(label_names)}"
        )
    return tuple(str(kv[n]) for n in label_names)


class _ThreadShardedValue:
    """One float accumulator per writing thread.

    ``add`` touches only the calling thread's cell (a one-element list, so
    the thread's handle to it stays valid), so the hot path takes no lock; ``total``
    sums a snapshot of all cells. Cell creation (first write from a new
    thread) is the only locked operation.
    """

    __slots__ = ("_cells", "_lock", "_local")

    def __init__(self) -> None:
        self._cells: list[list[float]] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _cell(self) -> list[float]:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = [0.0]
            with self._lock:
                self._cells.append(cell)
            self._local.cell = cell
        return cell

    def add(self, v: float) -> None:
        self._cell()[0] += v

    def total(self) -> float:
        with self._lock:
            cells = list(self._cells)
        return sum(c[0] for c in cells)


class _Child:
    """Base for one (metric family, label values) time series."""

    def __init__(self, family: "MetricFamily", label_values: tuple[str, ...]):
        self._family = family
        self.label_values = label_values


class CounterChild(_Child):
    def __init__(self, family: "MetricFamily", label_values: tuple[str, ...]):
        super().__init__(family, label_values)
        self._value = _ThreadShardedValue()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self._value.add(n)

    def get(self) -> float:
        return self._value.total()


class GaugeChild(_Child):
    def __init__(self, family: "MetricFamily", label_values: tuple[str, ...]):
        super().__init__(family, label_values)
        self._value = 0.0
        self._lock = threading.Lock()  # inc/dec are read-modify-write

    def set(self, v: float) -> None:
        self._value = float(v)  # single store: last-writer-wins by design

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    def get(self) -> float:
        return self._value


class _HistShard:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0


class HistogramChild(_Child):
    def __init__(self, family: "MetricFamily", label_values: tuple[str, ...]):
        super().__init__(family, label_values)
        self.buckets: tuple[float, ...] = family.buckets
        self._shards: list[_HistShard] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _shard(self) -> _HistShard:
        sh = getattr(self._local, "shard", None)
        if sh is None:
            sh = _HistShard(len(self.buckets))
            with self._lock:
                self._shards.append(sh)
            self._local.shard = sh
        return sh

    def observe(self, v: float) -> None:
        sh = self._shard()
        # non-cumulative per-bucket increments; render() accumulates
        for i, le in enumerate(self.buckets):
            if v <= le:
                sh.counts[i] += 1
                break
        sh.sum += v
        sh.count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count)."""
        with self._lock:
            shards = list(self._shards)
        counts = [0] * len(self.buckets)
        total_sum, total_count = 0.0, 0
        for sh in shards:
            for i, c in enumerate(sh.counts):
                counts[i] += c
            total_sum += sh.sum
            total_count += sh.count
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        cum.append(total_count)  # +Inf bucket
        return cum, total_sum, total_count


_CHILD_TYPES = {
    "counter": CounterChild,
    "gauge": GaugeChild,
    "histogram": HistogramChild,
}


class MetricFamily:
    """One named metric with a fixed label schema and N children."""

    def __init__(
        self,
        name: str,
        help: str,
        type: str,
        label_names: tuple[str, ...] = (),
        buckets: Iterable[float] | None = None,
    ):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates ^areal_[a-z0-9_]+$"
            )
        if not help or not help.strip():
            raise ValueError(f"metric {name!r} must have help text")
        if type not in _CHILD_TYPES:
            raise ValueError(f"unknown metric type {type!r}")
        for ln in label_names:
            if ln in ("le", "quantile"):
                raise ValueError(f"reserved label name {ln!r}")
        self.name = name
        self.help = help.strip()
        self.type = type
        self.label_names = tuple(label_names)
        self.buckets = tuple(sorted(set(buckets or DEFAULT_BUCKETS)))
        self._children: dict[tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        self._default: _Child | None = None

    # -- child resolution --------------------------------------------------
    def labels(self, **kv: str):
        key = _labels_key(self.label_names, kv)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, _CHILD_TYPES[self.type](self, key)
                )
        return child

    def _default_child(self):
        if self._default is None:
            if self.label_names:
                raise ValueError(
                    f"metric {self.name!r} has labels {self.label_names}; "
                    "use .labels(...)"
                )
            self._default = self.labels()
        return self._default

    # -- label-less conveniences ------------------------------------------
    def inc(self, n: float = 1.0) -> None:
        self._default_child().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default_child().dec(n)

    def set(self, v: float) -> None:
        self._default_child().set(v)

    def observe(self, v: float) -> None:
        self._default_child().observe(v)

    def get(self) -> float:
        return self._default_child().get()

    @property
    def cardinality(self) -> int:
        with self._lock:
            return len(self._children)

    def children(self) -> list[_Child]:
        with self._lock:
            return list(self._children.values())


class Registry:
    """A named set of metric families; one default instance per process."""

    def __init__(self) -> None:
        self._families: dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _get_or_register(
        self,
        name: str,
        help: str,
        type: str,
        label_names: tuple[str, ...],
        buckets: Iterable[float] | None = None,
    ) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != type or fam.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"schema: {fam.type}{fam.label_names} vs "
                        f"{type}{tuple(label_names)}"
                    )
                return fam
            fam = MetricFamily(name, help, type, tuple(label_names), buckets)
            if not fam.label_names:
                # materialize the unlabeled series at registration so the
                # exposition shows an explicit 0 before the first event
                fam._default_child()
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help: str, label_names: Iterable[str] = ()
    ) -> MetricFamily:
        return self._get_or_register(name, help, "counter", tuple(label_names))

    def gauge(
        self, name: str, help: str, label_names: Iterable[str] = ()
    ) -> MetricFamily:
        return self._get_or_register(name, help, "gauge", tuple(label_names))

    def histogram(
        self,
        name: str,
        help: str,
        label_names: Iterable[str] = (),
        buckets: Iterable[float] | None = None,
    ) -> MetricFamily:
        return self._get_or_register(
            name, help, "histogram", tuple(label_names), buckets
        )

    def families(self) -> list[MetricFamily]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def clear(self) -> None:
        """Drop all families (tests only — live handles go stale)."""
        with self._lock:
            self._families.clear()

    # -- exposition --------------------------------------------------------
    def render_prometheus(self, name_prefix: str | None = None) -> str:
        """Prometheus text exposition format 0.0.4. ``name_prefix``
        restricts output to families whose name starts with it."""
        lines: list[str] = []
        for fam in self.families():
            if name_prefix and not fam.name.startswith(name_prefix):
                continue
            lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            for child in fam.children():
                base = _render_labels(fam.label_names, child.label_values)
                if fam.type == "histogram":
                    cum, total_sum, total_count = child.snapshot()
                    for le, c in zip(
                        list(fam.buckets) + [math.inf], cum
                    ):
                        le_s = _format_value(le)
                        lab = _render_labels(
                            fam.label_names + ("le",),
                            child.label_values + (le_s,),
                        )
                        lines.append(f"{fam.name}_bucket{lab} {c}")
                    lines.append(
                        f"{fam.name}_sum{base} {_format_value(total_sum)}"
                    )
                    lines.append(f"{fam.name}_count{base} {total_count}")
                else:
                    lines.append(
                        f"{fam.name}{base} {_format_value(child.get())}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


def _render_labels(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label_value(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


# ---------------------------------------------------------------------------
# process-default registry
# ---------------------------------------------------------------------------

_REGISTRY = Registry()


def get_registry() -> Registry:
    return _REGISTRY
