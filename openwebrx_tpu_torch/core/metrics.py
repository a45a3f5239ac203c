"""Metrics registry: named counters/gauges, hierarchical JSON + Prometheus.

Reference ``owrx/metrics.py:29-70`` + ``owrx/controllers/metrics.py:13``.

Beside the reference's counters and gauges, ``SpanMetric`` is a log of
timed spans of one name, kept in memory, and ``SpanLog`` the span names
of one owner (a device's runtime registers ``device.<id>.span.<name>``);
the registry shows each as its count and summed seconds (a Prometheus
summary).
"""

from __future__ import annotations

import itertools
import sys
import threading
import time

import numpy as np


class Metric:
    def get_value(self):
        raise NotImplementedError


class CounterMetric(Metric):
    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, increment: int = 1):
        with self._lock:
            self._value += increment

    def get_value(self):
        return {"count": self._value}


class DirectMetric(Metric):
    """A gauge whose value is set directly."""

    def __init__(self, value=0):
        self.value = value

    def set(self, value):
        self.value = value

    def get_value(self):
        return self.value


RECORD = np.dtype([("start", "f8"), ("end", "f8"), ("id", "i8"), ("parent", "i8"),
                   ("ref", "i8"), ("outcome", "i1"), ("seq", "i8")])
CODE_BITS = 5                  # a span id is its sequence number << CODE_BITS | its name's code
_tls = threading.local()       # .current: the innermost span open on this thread


def current_span() -> "OpenSpan | None":
    """The innermost span open on this thread, or None."""
    return getattr(_tls, "current", None)


def _profiling() -> bool:
    """Whether a torch.profiler session records (none can, if torch's
    profiler was never imported)."""
    profiler = sys.modules.get("torch.autograd.profiler")
    return profiler is not None and profiler._is_profiler_enabled


class SpanMetric(Metric):
    """A log of the spans of one name.  A record holds the span's start and
    end on ``time.perf_counter()``, the id of the request it belongs to (a
    block or a change; -1: none), its parent's span id (the span that
    caused it; -1: none), ``ref``, a second request id (the block a change
    reached; -1: none), and its outcome, an index into ``outcomes`` (-1:
    none).  Records go into one preallocated array of ``capacity``
    entries, the oldest overwritten: writing one allocates nothing, and its
    slot comes from an atomic counter, so any thread may write without
    waiting for another.  ``count`` and ``sum`` (seconds) cover every
    record ever written."""

    capacity = 65536

    def __init__(self, log: "SpanLog", name: str, code: int, outcomes=()):
        self.log, self.name, self.code = log, name, code
        self.outcomes = tuple(outcomes)
        self._outcome_code = {o: i for i, o in enumerate(self.outcomes)}
        # zeroed pages are mapped on first write: an idle name costs no memory
        self._rec = np.zeros(self.capacity, RECORD)
        self._seq = itertools.count()
        self._lock = threading.Lock()        # count and sum only
        self.count = 0
        self.sum = 0.0

    def __call__(self, rid: int | None = None, parent: int | None = None) -> "OpenSpan":
        """A span of this name over a ``with`` block.  ``rid`` and
        ``parent`` default to those of the span open on this thread."""
        return OpenSpan(self, rid, parent)

    def _write(self, seq, start, end, rid, parent, ref, outcome):
        code = -1 if outcome is None else self._outcome_code[outcome]
        self._rec[seq % self.capacity] = (start, end, rid, parent, ref, code, seq + 1)
        with self._lock:
            self.count += 1
            self.sum += end - start

    def record(self, start: float, end: float, rid: int = -1, parent: int = -1,
               ref: int = -1, outcome: str | None = None) -> int:
        """Write a span that crossed calls, from its two times → its span id."""
        seq = next(self._seq)
        self._write(seq, start, end, rid, parent, ref, outcome)
        return seq << CODE_BITS | self.code

    def records(self) -> np.ndarray:
        """The records the log still holds, oldest first (a copy); ``seq``
        is one more than a record's sequence number."""
        rec = self._rec[self._rec["seq"] > 0]
        return rec[np.argsort(rec["seq"])]

    def seconds(self, sid: int) -> float | None:
        """The duration of span ``sid``, or None if it is no longer held."""
        r = self._rec[(sid >> CODE_BITS) % self.capacity]
        return float(r["end"] - r["start"]) if r["seq"] == (sid >> CODE_BITS) + 1 else None

    def durations(self, start: float, end: float) -> np.ndarray | None:
        """The durations of the records that started in [start, end], or
        None if the log has overwritten records from that interval."""
        rec = self._rec[self._rec["seq"] > 0]
        if len(rec) and rec["seq"].min() > 1 and rec["start"].min() > start:
            return None
        inside = rec[(rec["start"] >= start) & (rec["start"] <= end)]
        return inside["end"] - inside["start"]

    def get_value(self):
        return {"count": self.count, "sum": self.sum}


class OpenSpan:
    """A span open over a ``with`` block (``SpanMetric.__call__``).  While
    open it is the thread's current span (``prev``: the one it is inside),
    the default parent of spans opened inside it; its id (``sid``) is known
    from the start.  When a torch.profiler session records, it is also a
    ``torch.profiler.record_function("owrx.<name>")`` range.  Set
    ``outcome`` or ``ref`` before it closes; ``t1`` is its end after."""

    __slots__ = ("metric", "rid", "parent", "seq", "sid", "t0", "t1", "outcome", "ref",
                 "prev", "_range")

    def __init__(self, metric: SpanMetric, rid, parent):
        self.metric, self.rid, self.parent = metric, rid, parent
        self.outcome, self.ref, self.t1 = None, -1, None

    def __enter__(self) -> "OpenSpan":
        prev = self.prev = getattr(_tls, "current", None)
        if self.rid is None:
            self.rid = -1 if prev is None else prev.rid
        if self.parent is None:
            self.parent = -1 if prev is None else prev.sid
        self.seq = next(self.metric._seq)
        self.sid = self.seq << CODE_BITS | self.metric.code
        _tls.current = self
        self._range = None
        if _profiling():
            import torch
            self._range = torch.profiler.record_function(f"owrx.{self.metric.name}")
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
        _tls.current = self.prev
        self.metric._write(self.seq, self.t0, self.t1, self.rid, self.parent, self.ref,
                           self.outcome)
        return False


class SpanLog:
    """The span names of one owner, each a ``SpanMetric`` registered as
    ``<prefix>.span.<name>`` (replacing an earlier owner's of the same
    prefix).  ``names`` maps the names registered at once to their
    outcomes; any other name is registered when first used."""

    _shared = None
    _shared_lock = threading.Lock()

    def __init__(self, prefix: str, names: dict | None = None):
        self.prefix = prefix
        self.by_name: dict[str, SpanMetric] = {}
        self.by_code: list[SpanMetric] = []
        self._lock = threading.Lock()
        for name, outcomes in (names or {}).items():
            self.add(name, outcomes)

    def add(self, name: str, outcomes=()) -> SpanMetric:
        with self._lock:
            metric = self.by_name.get(name)
            if metric is None:
                if len(self.by_code) >= 1 << CODE_BITS:
                    raise ValueError(f"{self.prefix}: more than {1 << CODE_BITS} span names")
                metric = SpanMetric(self, name, len(self.by_code), outcomes)
                self.by_code.append(metric)
                self.by_name[name] = metric
                Metrics.shared().add(f"{self.prefix}.span.{name}", metric)
            return metric

    def __getitem__(self, name: str) -> SpanMetric:
        metric = self.by_name.get(name)
        return metric if metric is not None else self.add(name)

    def find(self, sid: int) -> SpanMetric:
        """The name a span id belongs to."""
        return self.by_code[sid & ((1 << CODE_BITS) - 1)]

    @staticmethod
    def current() -> "SpanLog":
        """The log of the span open on this thread, else the process's own
        (``graph``, for block steps run outside a runtime)."""
        span = current_span()
        if span is not None:
            return span.metric.log
        if SpanLog._shared is None:
            with SpanLog._shared_lock:
                if SpanLog._shared is None:
                    SpanLog._shared = SpanLog("graph")
        return SpanLog._shared


class Metrics:
    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def shared() -> "Metrics":
        with Metrics._lock:
            if Metrics._instance is None:
                Metrics._instance = Metrics()
            return Metrics._instance

    def __init__(self):
        self.metrics: dict[str, Metric] = {}

    def add(self, name: str, metric: Metric) -> Metric:
        self.metrics[name] = metric
        return metric

    def get(self, name: str) -> Metric | None:
        return self.metrics.get(name)

    def direct(self, name: str) -> DirectMetric:
        """Get-or-create a gauge."""
        metric = self.metrics.get(name)
        if not isinstance(metric, DirectMetric):
            metric = self.add(name, DirectMetric())
        return metric

    def counter(self, name: str) -> CounterMetric:
        m = self.metrics.get(name)
        if not isinstance(m, CounterMetric):
            m = self.add(name, CounterMetric())
        return m

    def get_hierarchical(self) -> dict:
        """dotted names → nested dicts (reference getHierarchicalMetrics)."""
        root: dict = {}
        for name, metric in self.metrics.items():
            node = root
            parts = name.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = metric.get_value()
        return root

    def render_prometheus(self) -> str:
        lines = []
        for name, metric in self.metrics.items():
            flat = name.replace(".", "_")
            value = metric.get_value()
            if isinstance(metric, SpanMetric):
                lines.append(f"# TYPE {flat} summary")
                lines.append(f"{flat}_count {value['count']}")
                lines.append(f"{flat}_sum {value['sum']}")
            elif isinstance(value, dict) and "count" in value:
                lines.append(f"# TYPE {flat} counter")
                lines.append(f"{flat}_total {value['count']}")
            elif isinstance(value, (int, float)):
                lines.append(f"# TYPE {flat} gauge")
                lines.append(f"{flat} {value}")
        return "\n".join(lines) + "\n"
