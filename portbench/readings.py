"""The readings that the limits of ``pbench/check.py`` are set from: the
program's numbers on many seeds and the bfloat16 control's on a few, at
a cell's own size, in one process (set-up is paid once a seed).

    python3 portbench/readings.py --workload web8.rt --seconds 5 \\
        --seeds 1 2 3 --control-seeds 4 5 6 --out chiprun_out/readings.jsonl

A cell kept out of ``BENCHMARK.json`` runs with ``--config`` and
``--traffic`` (``--workload web64.rt --config hf8-web --traffic web64.rt``).

Each run appends one JSON line: the cell, the seed, whether it was the
control, its numbers and their limits, and its end-to-end values.  Not
part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", help="run a cell kept out of BENCHMARK.json: "
                    "its configuration (with --traffic)")
    ap.add_argument("--traffic")
    args = ap.parse_args()
    extra = None
    if args.config:
        extra = {"name": args.workload, "config": args.config,
                 "traffic": args.traffic or args.workload, "chips": 1}
    import torch
    from pbench.cell import run_cell
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    runs = [(s, False) for s in args.seeds] + [(s, True) for s in args.control_seeds]
    with open(args.out, "a") as out:
        for seed, control in runs:
            t = time.perf_counter()
            r = run_cell(args.workload, seed, args.seconds, False, "cuda", control=control,
                         extra=extra)
            line = {"workload": args.workload, "seed": seed, "control": control,
                    "correct": r["correct"], "checks": r["checks"],
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                    "info": r["_info"], "run_s": time.perf_counter() - t}
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps({k: line[k] for k in ("seed", "control", "correct", "checks")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
