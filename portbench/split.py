"""Where a run's audio latency goes: every (listener, block) delivery of
the window split into consecutive pieces, from the runtime's own span log
and the benchmark's records, with the cyclic collector's passes stamped.

    python3 portbench/split.py --workload web8.rt --seed 7 --seconds 51 \\
        --out split.jsonl [--checkout DIR]

One process makes one run, as ``run.py`` makes it (``--checkout``: the
root of another checkout, whose ``portbench/pbench`` runs instead of this
one's), and appends one JSON line: the run's end-to-end values and check,
and for each piece its median over every delivery of the window and its
mean over the deliveries at or above the p95 latency; the collector's
passes in the window (by generation; the tail blocks they overlap); and
the CPU time ``/proc`` gives over the window, of the machine, of the
process and of the runtime's loop thread (``scheduler``).  With
``--blocks``, every window block's worst delivery and its pieces go to
that file too.  The pieces, in order, add up to the latency:

* ``read_late``: the source's read that returned the block, after its due time;
* ``to_dispatch``: from that read to the ``dispatch`` span's start;
* ``stage``, ``upload_rest``: the ``upload`` span, its ``stage`` and the rest;
* ``dispatch_rest``: the rest of ``dispatch`` (graph replays, fetch start);
* ``hold``: the ``hold`` span, from the dispatch's end until the loop takes
  the block off its queue;
* ``to_fetch``: from there to the ``fetch`` span (the ``complete`` span's
  start, and anything the benchmark does inside it first);
* ``fetch``: the wait on the block's event;
* ``deliver``: from there to the listener's callback (the ``deliver`` span's
  numpy, framing and the callbacks before it).

Not part of a benchmark run.
"""

import argparse
import gc
import json
import os
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PIECES = ("read_late", "to_dispatch", "stage", "upload_rest", "dispatch_rest", "hold",
          "to_fetch", "fetch", "deliver")
SPANS = ("dispatch", "upload", "stage", "hold", "fetch")


class Collector:
    """The cyclic collector's passes: (generation, start, end, thread)."""

    def __init__(self):
        self.passes, self._open = [], {}

    def __call__(self, phase, info):
        now = time.perf_counter()
        tid = threading.get_ident()
        if phase == "start":
            self._open[tid] = now
        elif tid in self._open:
            self.passes.append((info["generation"], self._open.pop(tid), now,
                                threading.current_thread().name))


def scheduler(thread_name: str) -> dict:
    """CPU time as ``/proc`` gives it: the machine's busy and stolen time
    and this process's (s), and the loop thread's time on a CPU and waiting
    for one (ms, where the kernel keeps them) with its context switches."""
    out = {}
    hz = os.sysconf("SC_CLK_TCK")
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:9]]
        out.update(busy_s=(sum(cpu) - cpu[3] - cpu[4]) / hz, steal_s=cpu[7] / hz)
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        out["process_s"] = (int(fields[11]) + int(fields[12])) / hz
        tid = next(t.native_id for t in threading.enumerate() if t.name == thread_name)
    except (OSError, StopIteration, IndexError, ValueError):
        return out
    task = Path(f"/proc/self/task/{tid}")
    try:
        run_ns, wait_ns, _ = (task / "schedstat").read_text().split()
        out.update(run_ms=int(run_ns) / 1e6, runqueue_ms=int(wait_ns) / 1e6)
    except (OSError, ValueError):
        pass
    try:
        for line in (task / "status").read_text().splitlines():
            if line.startswith(("voluntary_ctxt_switches", "nonvoluntary_ctxt_switches")):
                out[line.split(":")[0]] = int(line.split()[1])
    except (OSError, ValueError):
        pass
    return out


def by_block(log) -> dict:
    """block → (start, end) of a span log's records."""
    rec = log.records()
    return {int(r["id"]): (float(r["start"]), float(r["end"])) for r in rec if r["id"] >= 0}


def pieces(drv, t0: float, seconds: float, realtime: bool) -> dict:
    """Each window delivery's pieces → {piece: [seconds]} and ``latency``."""
    from openwebrx_tpu_torch.core.metrics import Metrics
    from pbench import e2e
    from pbench.drive import deliveries

    m = Metrics.shared()
    sp = {n: by_block(m.get(f"device.portbench.span.{n}")) for n in SPANS}
    got = deliveries(drv.rec)
    out = {k: [] for k in PIECES + ("latency", "block")}
    for b in e2e.window_blocks(drv, t0, seconds, realtime):
        _, due, read_at = drv.source.handed[b]
        if any(b not in sp[n] for n in SPANS if n != "stage"):
            continue
        d0, d1 = sp["dispatch"][b]
        u0, u1 = sp["upload"][b]
        s0, s1 = sp["stage"].get(b, (u0, u0))        # none on the CPU
        _, h1 = sp["hold"][b]
        f0, f1 = sp["fetch"][b]
        common = {"read_late": read_at - due, "to_dispatch": d0 - read_at,
                  "stage": s1 - s0, "upload_rest": (u1 - u0) - (s1 - s0),
                  "dispatch_rest": (d1 - d0) - (u1 - u0), "hold": h1 - d1,
                  "to_fetch": f0 - h1, "fetch": f1 - f0}
        for per in got.values():
            if b not in per:
                continue
            t_cb = per[b][0]
            for k, v in common.items():
                out[k].append(v)
            out["deliver"].append(t_cb - f1)
            out["latency"].append(t_cb - due)
            out["block"].append(b)
    return out


def summary(split: dict, due: dict, collector: Collector, t0: float,
            seconds: float) -> dict:
    import numpy as np

    lat = np.asarray(split["latency"])
    if not len(lat):
        return {}
    p95 = float(np.quantile(lat, 0.95, method="higher"))
    tail = lat >= p95
    out = {"deliveries": int(len(lat)), "p95_ms": 1e3 * p95,
           "median_ms": 1e3 * float(np.median(lat)), "tail_deliveries": int(tail.sum()),
           "pieces_ms": {}}
    for k in PIECES:
        v = 1e3 * np.asarray(split[k])
        out["pieces_ms"][k] = {"median": float(np.median(v)), "tail_mean": float(v[tail].mean()),
                               "q1": float(np.quantile(v, 0.25)),
                               "q3": float(np.quantile(v, 0.75)), "max": float(v.max())}
    # a block's deliveries last from its due time to its last callback
    last = {}
    for b, lt in zip(split["block"], split["latency"]):
        last[b] = max(last.get(b, 0.0), lt)
    tail_blocks = sorted(set(np.asarray(split["block"])[tail].tolist()))
    inside = [p for p in collector.passes if t0 <= p[1] <= t0 + seconds]
    gens = {}
    for g, a, b, _ in inside:
        n, total, longest = gens.get(g, (0, 0.0, 0.0))
        gens[g] = (n + 1, total + (b - a), max(longest, b - a))
    out["gc"] = {str(g): {"passes": n, "total_ms": 1e3 * t, "max_ms": 1e3 * mx}
                 for g, (n, t, mx) in sorted(gens.items())}
    out["gc_threads"] = sorted({p[3] for p in inside})
    out["tail_blocks"] = len(tail_blocks)
    out["tail_blocks_with_gc"] = sum(
        any(a < due[b] + last[b] and z > due[b] for _, a, z, _ in inside)
        for b in tail_blocks)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkout", default=str(HERE.parent),
                    help="the root of the checkout whose portbench runs")
    ap.add_argument("--blocks", help="a file for each window block's worst delivery")
    args = ap.parse_args()
    root = Path(args.checkout).resolve()
    sys.path[:0] = [str(root / "portbench"), str(root)]
    import run as run_py                         # that checkout's portbench/run.py
    t_start = run_py.process_start()
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    import torch
    from pbench.cell import load_cell, run_cell
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _, _, _, traffic, _, _ = load_cell(args.workload, root)
    realtime = traffic["pacing"] == "realtime"
    collector = Collector()
    gc.callbacks.append(collector)
    kept = {}

    def keep(drv):
        window = drv.window

        def timed(*a, **kw):
            before = scheduler("device-portbench")
            kept["t0"], traced = window(*a, **kw)
            after = scheduler("device-portbench")
            kept["sched"] = {k: after[k] - before[k] for k in after if k in before}
            return kept["t0"], traced
        drv.window = timed
        kept["drv"] = drv
    result = run_cell(args.workload, args.seed, args.seconds, False, "cuda", t_start,
                      root=root, hooks=keep)
    gc.callbacks.remove(collector)
    drv, t0 = kept["drv"], kept["t0"]
    split = pieces(drv, t0, args.seconds, realtime)
    due = {b: drv.source.handed[b][1] for b in set(split["block"])}
    info = result["_info"]
    line = {"checkout": str(root), "workload": args.workload, "seed": args.seed,
            "seconds": args.seconds, "correct": result["correct"],
            "checks": result["checks"], "values": info["values"],
            "timings": info["timings"], "late_s_max": info["late_s_max"],
            "split": summary(split, due, collector, t0, args.seconds),
            "scheduler": kept["sched"]}
    if args.blocks:
        worst = {}
        for i, b in enumerate(split["block"]):
            if b not in worst or split["latency"][i] > split["latency"][worst[b]]:
                worst[b] = i
        with open(args.blocks, "a") as f:
            for b, i in sorted(worst.items()):
                f.write(json.dumps({"seed": args.seed, "block": b, "due": due[b] - t0} |
                                   {k: split[k][i] for k in PIECES + ("latency",)}) + "\n")
    with open(args.out, "a") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps({k: line[k] for k in ("seed", "correct", "values")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
