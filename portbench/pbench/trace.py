"""The traced run's device side: torch.profiler over a steady sub-window
of the runtime's loop thread, reduced to busy time, the device operations
that took most of it and the longest idle gaps."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict


def init_profiler():
    """Start and stop torch.profiler once on this (the main) thread, so
    that its library is initialised here: it refuses to initialise from
    the runtime's loop thread, where the traced window is profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class LoopProfiler:
    """torch.profiler on the runtime's loop thread, which makes every
    launch of the window, from the first block dispatched at or after
    ``start`` to the first at or after ``stop``: whole blocks are traced.
    The dispatch span calls ``at_dispatch`` before each block."""

    def __init__(self, start: float, stop: float):
        self.start, self.stop = start, stop
        self.prof = None
        self.done = False

    def at_dispatch(self, block: int):
        if self.done:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        now = time.perf_counter()
        if self.prof is None and now >= self.start:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            with record_function("portbench.start"):
                self.t_pc = time.perf_counter()
        elif self.prof is not None and now >= self.stop:
            torch.cuda.synchronize()
            with record_function("portbench.stop"):
                pass
            self.prof.__exit__(None, None, None)
            self.done = True

    def result(self, out_dir: str):
        """→ (perf_counter at the start, the trace's events, (start ts µs,
        length µs))."""
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        marks = {e["name"]: float(e["ts"]) for e in events
                 if e.get("name") in ("portbench.start", "portbench.stop")}
        ts0 = marks["portbench.start"]
        return self.t_pc, events, (ts0, marks["portbench.stop"] - ts0)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_trace(events, marker, t_pc, spans):
    """Busy and window seconds, device ops by time, and idle gaps named by
    the host span they fell in, over the sub-window."""
    ts0, dur = marker
    ts1 = ts0 + dur
    dev = []
    by_name = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if b <= ts0 or a >= ts1:
            continue
        a, b = max(a, ts0), min(b, ts1)
        dev.append((a, b))
        name = str(e.get("name", "?"))[:200]
        by_name[name] += (b - a) * 1e-6
    if not dev:
        cats = defaultdict(int)
        for e in events:
            cats[e.get("cat")] += 1
        span = [(float(e["ts"]), e.get("cat")) for e in events
                if e.get("cat") in DEVICE_CATS]
        raise RuntimeError(f"the profiler saw no device event in the traced window "
                           f"{marker}: event categories {dict(cats)}, device events "
                           f"from {min(span, default=None)} to {max(span, default=None)}")
    dev.sort()
    merged = [list(dev[0])]
    for a, b in dev[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    # idle gaps, named by the benchmark span the host was in at their middle
    offset = t_pc - ts0 * 1e-6
    gaps = []
    edges = [ts0] + [x for ab in merged for x in ab] + [ts1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[span_at(spans, (a + b) / 2 * 1e-6 + offset), (b - a) * 1e-6]
             for a, b in gaps[:10]]
    out = {"busy_s": busy, "window_s": dur * 1e-6,
           "device_ops": [[n, s] for n, s in
                          sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
           "idle_gaps": named}
    return out


def span_at(spans, t: float) -> str:
    for name, items in spans.items():
        for a, b in items:
            if a <= t < b:
                return name
    return "source"
