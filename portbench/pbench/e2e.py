"""End-to-end numbers of a run, from the record, on the host's clock.

* ``latency_p95_ms``: over every (listener, block) audio delivery of the
  window's blocks, callback time minus the block's due time (when its
  last sample left the receiver); kept in a run's information, and read
  per layer by ``metrics/delivery.latency_p95_ms.rt.py``;
* ``tune_p95_ms``: over every control change due in the window, the first
  audio for its listener from a block dispatched after the change's call
  returned, minus the change's scheduled time; a change never heard
  counts as failed and as the longest.
"""

from __future__ import annotations

import numpy as np


def p95(values) -> float:
    v = np.sort(np.asarray(values, np.float64))
    return float(np.quantile(v, 0.95, method="higher")) if len(v) else float("nan")


def window_blocks(drv, t0: float, seconds: float, realtime: bool) -> list[int]:
    out = []
    for b, (_, due, read_at) in enumerate(drv.source.handed):
        if b < drv.first_window_block:
            continue
        when = due if realtime else read_at
        if t0 <= when <= t0 + seconds:
            out.append(b)
    return out


def expected(drv, b) -> list[int]:
    rec = drv.rec
    return [hid for hid, (key, slot) in rec.routing.get(b, {}).items()
            if slot is not None and key in rec.active.get(b, ())]


def latency(drv, deliveries, blocks) -> tuple[list[float], int, int]:
    """Latencies (s) of the blocks' deliveries, deliveries due, missing."""
    due_at = {b: drv.source.handed[b][1] for b in blocks}
    lat, due, missing = [], 0, 0
    for b in blocks:
        for hid in expected(drv, b):
            due += 1
            got = deliveries.get(hid, {}).get(b)
            if got is None:
                missing += 1
            else:
                lat.append(got[0] - due_at[b])
    return lat, due, missing


def tune(drv, deliveries, t0: float, seconds: float):
    """Tune times (s; unheard ones as the longest), changes, unheard."""
    times, unheard = [], 0
    changes = [c for c in drv.rec.control
               if c["scheduled"] is not None and c["scheduled"] <= t0 + seconds]
    for c in changes:
        got = deliveries.get(c["listener"], {})
        heard = [t for b, (t, _) in got.items() if b >= c["first"]]
        if heard:
            times.append(min(heard) - c["scheduled"])
        else:
            unheard += 1
    longest = max(times, default=seconds)
    return times + [longest] * unheard, len(changes), unheard
