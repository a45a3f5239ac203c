"""What the per-layer readers share: the run they read."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Run:
    """A run as the per-layer readers see it.  ``spans``: name → list of
    (start, end) host seconds inside the window (``dispatch``, ``wait``,
    ``deliver``, ``control``); ``blocks``: the window's blocks;
    ``changes``: control changes due in the window; ``trace``: the traced sub-window's reduction, or None."""
    spans: dict = field(default_factory=dict)
    blocks: int = 0
    changes: int = 0
    trace: dict | None = None


def mean_span_ms(run: Run, name: str, per: int) -> float | None:
    items = run.spans.get(name, [])
    if not items or not per:
        return None
    return 1e3 * sum(b - a for a, b in items) / per
