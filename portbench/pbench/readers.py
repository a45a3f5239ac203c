"""What the per-layer readers share: the run they read."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Run:
    """A run as the per-layer readers see it.  ``spans``: name → list of
    (start, end) host seconds inside the window, the benchmark's own stamps
    (``dispatch``, ``complete``, ``control``: ``cell.window_spans``);
    ``blocks``: the window's blocks; ``changes``: control changes due in
    the window; ``latencies``: each audio delivery of the window's blocks,
    callback minus due, host seconds (``e2e.latency``); ``trace``: the
    traced sub-window's reduction, or None."""
    spans: dict = field(default_factory=dict)
    blocks: int = 0
    changes: int = 0
    latencies: list = field(default_factory=list)
    trace: dict | None = None
