"""Metrics registry: named counters/gauges, hierarchical JSON + Prometheus.

Reference ``owrx/metrics.py:29-70`` + ``owrx/controllers/metrics.py:13``.
"""

from __future__ import annotations

import threading


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
            if isinstance(value, dict) and "count" in value:
                lines.append(f"# TYPE {flat} counter")
                lines.append(f"{flat}_total {value['count']}")
            elif isinstance(value, (int, float)):
                lines.append(f"# TYPE {flat} gauge")
                lines.append(f"{flat} {value}")
        return "\n".join(lines) + "\n"
