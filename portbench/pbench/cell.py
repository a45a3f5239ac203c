"""One run of one cell, from set-up to the verdict."""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from pbench import check, e2e
from pbench.readers import Run

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "openwebrx_tpu")


def load_cell(name: str, root: Path = ROOT, extra: dict | None = None):
    """BENCHMARK.json's cell ``name`` → (spec, cell, config, traffic, the
    cell's end-to-end and per-layer metric entries).  ``extra``, a cell
    entry of the same form, stands beside BENCHMARK.json's (a cell kept
    out of it, run by ``readings.py``)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = spec["workloads"] + ([extra] if extra else [])
    cell = next(w for w in cells if w["name"] == name)
    if extra and cell is extra:
        spec["configs"] = spec["configs"] + [
            {"name": extra["config"], "file": f"portbench/configs/{extra['config']}.json"}]
    conf_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf_entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    e2e_metrics = [m for m in spec["end_to_end"]
                   if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e_metrics}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return spec, cell, config, traffic, e2e_metrics, layer


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(metric)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def window_spans(rec, blocks, end: float) -> dict:
    """The benchmark's own stamps of the window, as the readers and the
    trace's idle gaps take them: each block's ``dispatch`` and
    ``complete``, and each ``control`` change due by ``end``."""
    return {"dispatch": [rec.dispatch[b] for b in blocks if b in rec.dispatch],
            "complete": [rec.complete[b] for b in blocks if b in rec.complete],
            "control": [(c["requested"], c["done"]) for c in rec.control
                        if c["scheduled"] is not None and c["scheduled"] <= end]}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, control: bool = False, root: Path = ROOT,
             hooks=None, extra: dict | None = None) -> dict:
    """Set up, warm, measure, drain, judge → the result dict (without
    printing).  ``hooks(driver)`` may break the timed path (the tests do)."""
    import torch

    from pbench.drive import Driver, deliveries as delivered
    from pbench.plan import make_plan
    from pbench.wire import synthesize

    t_start = time.perf_counter() if t_start is None else t_start
    spec, cell, config, traffic, e2e_metrics, layer = load_cell(name, root, extra)
    realtime = traffic["pacing"] == "realtime"
    if trace:
        from pbench.trace import init_profiler
        init_profiler()
    # the runtime first: its block size frames the wire
    drv = Driver(config, device)
    plan0 = make_plan(config, traffic, drv.block, seed, seconds)
    drv.plan = plan0
    drv.waterfall, drv.service = plan0.waterfall, plan0.service
    wire = synthesize(float(config["sample_rate"]), plan0.loop_len, plan0.stations,
                      float(traffic["stations"]["noise_lsb"]),
                      float(traffic["stations"].get("dc_lsb", 0.0)), seed, device)
    if hooks is not None:
        hooks(drv)
    drv.start(wire)
    drv.warm(int(traffic.get("warm_blocks", 4)), plan0.warm_events)
    sub = None
    if trace:
        sub = (min(1.0, 0.2 * seconds), min(3.0, 0.4 * seconds))
    t0, traced = drv.window("realtime" if realtime else "saturate", seconds,
                            plan0.events, sub)
    setup_s = t0 - t_start
    t_drain = time.perf_counter()
    drv.drain(extra=not realtime)
    timings = {"window_and_trace_s": t_drain - t0, "drain_s": time.perf_counter() - t_drain}
    drv.resolve()
    dev_name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0

    got = delivered(drv.rec)
    blocks = e2e.window_blocks(drv, t0, seconds, realtime)
    metrics, attempted, failed = {}, 0, 0
    lat, due, missing = e2e.latency(drv, got, blocks)
    attempted += due
    failed += missing
    tunes, changes, unheard = e2e.tune(drv, got, t0, seconds)
    attempted += changes
    failed += unheard
    values = {"setup_s": setup_s}
    if lat:
        values["latency_p95_ms"] = 1e3 * e2e.p95(lat)
    if tunes:
        values["tune_p95_ms"] = 1e3 * e2e.p95(tunes)
    if not trace:
        for m in e2e_metrics:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    spans = window_spans(drv.rec, blocks, t0 + seconds)
    reduced = None
    if trace:
        from pbench.trace import reduce_trace
        t_pc, events, marker = traced
        reduced = reduce_trace(events, marker, t_pc, spans)
        run = Run(spans=spans, blocks=len(blocks), changes=changes, latencies=lat,
                  trace=reduced)
        for m in layer:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the program's state goes before the reference runs
    source, rec = drv.source, drv.rec
    drv.rt = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers, info = check.judge(config, traffic, drv, wire, got, seed, device,
                                control=control)
    timings["judge_s"] = time.perf_counter() - t_judge
    correct = check.verdict(numbers) and not drv.rec.errors
    found = forbidden_modules()
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else "cpu",
                         "kind": dev_name, "count": 1, "memory_peak_bytes": peak}}
    if reduced is not None:
        result["device"].update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = {k: {"value": float(v), "limit": float(check.LIMITS[k])}
                        for k, v in numbers.items()}
    result["_info"] = dict(info, late_s_max=float(max(source.late, default=0.0)),
                           blocks=len(blocks), changes=changes, unheard=unheard,
                           changes_ambiguous=drv.ambiguous,
                           errors=list(rec.errors), forbidden=found,
                           values=values, timings=timings)
    return result
