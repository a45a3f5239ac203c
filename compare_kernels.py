#!/usr/bin/env python3
"""Device times of the port's recurrence kernels in two checkouts, on one
card.

Runs ``agc.agc_apply``, ``adpcm.adpcm_encode``, ``iir.first_order_apply``,
``adpcm.adpcm_encode_seq`` and ``squelch.squelch_apply`` of this checkout
and of another (``--other``, e.g. a parent commit unpacked with ``git
archive`` into the git-ignored ``build/``) at the shapes the full-width
paths give them (``chip_smoke.AGC_PATH_CASES``, ``ADPCM_PATH_SHAPES``,
``IIR_PATH_CASES`` and ``SQUELCH_PATH_CASES``, on ``chip_smoke``'s seeded
inputs; the row encoder on the real config #2 and 49.152 MS/s waterfall
rows, on audio and on 16 rows; the squelch also on real (5, 4801) rows and
on (3, 40000) rows of 100 windows, with a plain device copy of each x,
``copy_``, timed cold beside it as the yardstick of what these sizes
allow), in alternating processes: other, this, this, other (``--rounds``
times).
Each process builds its checkout's kernels and times every function warm
(back-to-back launches on the same inputs) and cold (each launch on its own
copy of the inputs, with the L2 cache flushed first), with
``chip_smoke.time_cuda`` of this checkout.  Both sides compute the whole
function: for a checkout whose ``adpcm_encode`` is several launches, the
time covers all of them.  ``encode_strides`` (the recurrence alone on
explicit start states) is timed too, and the row encoder's adversarial test
inputs (``encode_seq_kernel`` with ``forced`` 1 and 2) on the 49.152 MS/s
row where the checkout has them; a checkout without them runs its
``adpcm_encode_seq`` on that row, whose time does not depend on the data.
Every run is printed and written to ``--out``.

Usage (from the root of a checkout, on a machine with a card)::

    python3 compare_kernels.py --other PATH [--rounds 1]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
WARM_ITERS = 50


def child(root: str) -> int:
    """Time the functions of the checkout at ``root``; print one JSON line."""
    sys.path[0] = root                     # that checkout's package, not ours
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from openwebrx_tpu_torch import kernels
    from openwebrx_tpu_torch.ops import adpcm, agc, iir, squelch

    for k in kernels.ALL:
        k.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.ones(smoke.L2_FLUSH_BYTES // 4, device=dev)

    def both(fn, args):
        warm = smoke.time_cuda(lambda: fn(*args), WARM_ITERS, torch)
        copies = [tuple(a.clone() for a in args) for _ in range(smoke.COLD_COPIES)]
        cold = smoke.time_cuda([lambda c=c: fn(*c) for c in copies],
                               smoke.COLD_COPIES, torch, flush)
        return {"ms": warm, "cold_ms": cold}

    out = {"root": root, "agc": {}, "adpcm_encode": {}}
    for label, (pname, shape, chunk) in smoke.AGC_PATH_CASES.items():
        st, x = smoke.agc_input(torch, gen, dev, shape)
        prof = getattr(agc, pname)
        out["agc"][label] = both(
            lambda g, h, x, prof=prof, chunk=chunk: agc.agc_apply(
                (g, h), prof, x, chunk, device=dev), (*st, x))
    for label, shape in smoke.ADPCM_PATH_SHAPES.items():
        if shape in [tuple(v["shape"]) for v in out["adpcm_encode"].values()]:
            continue                       # nfm: the same shape as usb
        st, (x,) = smoke.adpcm_input(torch, gen, dev, shape)
        out["adpcm_encode"][label] = dict(shape=list(shape), **both(
            lambda p0, i0, x: adpcm.adpcm_encode((p0, i0), x), (*st, x)))
    lanes = smoke.int16_audio(torch, gen, dev, 3072, 200)
    prev = torch.randint(-32768, 32767, (lanes.shape[0],), generator=gen,
                         device=dev, dtype=torch.int32)
    idxs = torch.randint(0, 89, (lanes.shape[0],), generator=gen, device=dev,
                         dtype=torch.int32)
    out["encode_strides"] = both(
        lambda s, p, i: adpcm.encode_strides(s, p, i, device=dev), (lanes, prev, idxs))
    out["iir"] = {}
    for label, shape in smoke.IIR_PATH_CASES.items():
        st, x = smoke.iir_input(torch, gen, dev, shape)
        co = (iir.dc_block_coeffs(12000.0) if label == "am"
              else iir.deemphasis_coeffs(48000.0, 150e-6))
        out["iir"][label] = dict(shape=list(shape), **both(
            lambda x0, y0, x, co=co: iir.first_order_apply((x0, y0), *co, x, device=dev),
            (*st, x)))
    seq = {}
    for label in smoke.SEQ_REAL_ROWS:      # one row each, the 8.192 MS/s rows two
        x = smoke.waterfall_row(torch, gen, dev, label)
        seq[label] = (adpcm.adpcm_init(tuple(x.shape[:-1]), device=dev), x)
    for label, rows in (("audio", 1), ("16 rows", 16)):
        seq[label] = ((torch.randint(-32768, 32767, (rows,), generator=gen, device=dev,
                                     dtype=torch.int32),
                       torch.randint(0, 89, (rows,), generator=gen, device=dev,
                                     dtype=torch.int32)),
                      smoke.int16_audio(torch, gen, dev, rows, smoke.SEQ_ROW))
    out["adpcm_encode_seq"] = {}
    for label, (st, x) in seq.items():
        out["adpcm_encode_seq"][label] = dict(shape=list(x.shape), **both(
            lambda p0, i0, x: adpcm.adpcm_encode_seq((p0, i0), x), (*st, x)))
    st, x = seq["wf row"]
    for forced in (1, 2):
        if hasattr(adpcm, "encode_seq_kernel"):
            fn = lambda p0, i0, x, f=forced: adpcm.encode_seq_kernel((p0, i0), x, f)
        else:
            fn = lambda p0, i0, x: adpcm.adpcm_encode_seq((p0, i0), x)
        out["adpcm_encode_seq"][f"wf row, forced {forced}"] = dict(
            shape=list(x.shape), **both(fn, (*st, x)))
    out["squelch"] = {}
    sq_in = {label: (*smoke.squelch_input(torch, gen, dev, shape, window), window)
             for label, (shape, window) in smoke.SQUELCH_PATH_CASES.items()}
    sq_in["real"] = (*smoke.squelch_input(torch, gen, dev, (5, 4801), 4801, torch.float32),
                     4801)
    sq_in["tiled"] = (*smoke.squelch_input(torch, gen, dev, (3, 40000), 400), 400)
    for label, (st, level, x, window) in sq_in.items():
        srcs = [x.clone() for _ in range(smoke.COLD_COPIES)]
        dsts = [torch.empty_like(x) for _ in range(smoke.COLD_COPIES)]
        copy_ms = smoke.time_cuda([lambda i=i: dsts[i].copy_(srcs[i])
                                   for i in range(smoke.COLD_COPIES)],
                                  smoke.COLD_COPIES, torch, flush)
        del srcs, dsts
        out["squelch"][label] = dict(shape=list(x.shape), window=window,
                                     copy_cold_ms=copy_ms, **both(
            lambda o, h, lv, x, window=window: squelch.squelch_apply((o, h), lv, x, window),
            (*st, level, x)))
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of other, this, this, other")
    ap.add_argument("--out", default="build/compare_kernels.json")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    if not args.other:
        ap.error("--other is required")
    here, other = str(HERE), str(Path(args.other).resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[compare] {smi}: other={other} this={here}", flush=True)
    runs = []
    for _ in range(args.rounds):
        for root in (other, here, here, other):
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--child", root], capture_output=True,
                                 text=True, timeout=900)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return res.returncode
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            rec["side"] = "this" if root == here else "other"
            runs.append(rec)
            print(f"[compare] run {len(runs)} {rec['side']}: " + json.dumps(
                {k: rec[k] for k in ("agc", "adpcm_encode", "encode_strides", "iir",
                                     "adpcm_encode_seq", "squelch")}),
                flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    print(json.dumps({"card": smi, "runs": len(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
