"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload web64.rt --seed 7 --seconds 20 --trace 0

Runs on the card the process finds (it never falls back to the CPU),
prints each number of the correctness comparison beside its limit as the
last lines of standard error, and one JSON object as the last line of
standard output.  ``BENCHMARK.json`` at the root of the checkout names
the cells; ``portbench/configs``, ``portbench/traffic`` and
``portbench/metrics`` hold what each name stands for.
"""

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def process_start() -> float:
    """perf_counter() at the moment this process was created."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.perf_counter() - (uptime - start / ticks)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    # build and kernel caches stay inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(HERE), str(ROOT)]
    if not (ROOT / "BENCHMARK.json").exists():
        print("BENCHMARK.json not found beside portbench/", file=sys.stderr)
        return 2
    from pbench.cell import forbidden_modules, load_cell, run_cell
    try:
        _, cell, *_ = load_cell(args.workload, ROOT)
    except StopIteration:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    info = result.pop("_info")
    print(json.dumps({"info": info}), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"modules that must not load were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
