#!/usr/bin/env python3
"""ms/block of the port's 1024-channel USB bank in two checkouts, on one card.

Runs ``ChannelizedBank(49.152e6, 1024, mode="usb", compression="adpcm",
target_seconds=0.05)`` (BASELINE config #5) of this checkout and of another
checkout (``--other``, e.g. a parent commit unpacked with ``git archive``)
in alternating processes: other, this, this, other, other, this, ...
(``--pairs`` pairs).  Each process builds its checkout's kernels, assigns
every channel, feeds seeded device-resident noise, dispatches each block
before fetching the previous one to host numpy, and times ``--blocks``
blocks after 5 warm-up blocks on the host clock.  Every run is printed and
written to ``--out``; the medians are a summary, not a replacement for the
runs, because these host-bound times spread between processes.

Usage (from the root of a checkout, on a machine with a card)::

    python3 compare_bank_ms.py --other PATH [--pairs 10] [--blocks 40]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

FS = 49.152e6
M = 1024
WARMUP_BLOCKS = 5


def child(root: str, n_blocks: int) -> int:
    """Time the bank of the checkout at ``root`` and print one JSON line."""
    sys.path[0] = root                     # that checkout's package, not ours
    import torch
    if not torch.cuda.is_available():
        print("compare_bank_ms: no CUDA device available", file=sys.stderr)
        return 1
    from openwebrx_tpu_torch import kernels
    from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank

    for k in kernels.ALL:
        k.build()
    dev = torch.device("cuda", 0)
    bank = ChannelizedBank(FS, M, mode="usb", compression="adpcm",
                           target_seconds=0.05, device=dev)
    for i in range(M):
        bank.assign(float((i - M // 2) * FS / M))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    blocks = [torch.complex(torch.randn(bank.block, generator=gen, device=dev),
                            torch.randn(bank.block, generator=gen, device=dev)) * 0.2
              for _ in range(4)]

    def run(n):
        pending = None
        for b in range(n):
            nxt = bank.dispatch(blocks[b % len(blocks)])
            if pending is not None:
                bank.fetch(*pending)
            pending = nxt
        bank.fetch(*pending)
        torch.cuda.synchronize()

    run(WARMUP_BLOCKS)
    t0 = time.perf_counter()
    run(n_blocks)
    ms = (time.perf_counter() - t0) / n_blocks * 1e3
    print(json.dumps({"root": root, "ms_per_block": ms, "blocks": n_blocks,
                      "launches": {k.source.name: k.launches for k in kernels.ALL}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--blocks", type=int, default=40, help="timed blocks per run")
    ap.add_argument("--out", default="chiprun_out/compare_bank_ms.json")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.blocks)
    if not args.other:
        ap.error("--other is required")

    here = str(Path(__file__).resolve().parent)
    other = str(Path(args.other).resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[compare] {smi}: USB bank M={M}, {args.blocks} timed blocks per "
          f"run; other={other} this={here}", flush=True)
    runs = []
    for p in range(args.pairs):
        for root in ((other, here) if p % 2 == 0 else (here, other)):
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--child", root, "--blocks", str(args.blocks)],
                                 capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return out.returncode
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            rec["side"] = "this" if root == here else "other"
            runs.append(rec)
            print(f"[compare] run {len(runs):2d} {rec['side']:<5} "
                  f"{rec['ms_per_block']:.3f} ms/block", flush=True)
    summary = {}
    for side in ("other", "this"):
        ms = [r["ms_per_block"] for r in runs if r["side"] == side]
        summary[side] = {"median": statistics.median(ms), "min": min(ms),
                         "max": max(ms), "runs": ms}
    result = {"card": smi, "bank": f"usb M={M}", "other": other, "this": here,
              "summary": summary, "runs": runs}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"card": smi, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
