#!/usr/bin/env python3
"""Where the time of the port's 1024-channel bank goes, on one CUDA card.

Runs ``openwebrx_tpu_torch``'s ``ChannelizedBank(49.152e6, M, mode,
adpcm)`` on seeded device-resident IQ, every result fetched to host numpy.
The mode picks M and the audio rate as the JAX runtime sizes its banks at
49.152 MS/s: usb (BASELINE config #5) and nfm 1024 channels of 48 kHz; am,
sam and rawam 2048 of 24 kHz; wfm 128 of 384 kHz with 48 kHz audio.  It
reports per block:

* wall time (host clock around work ending in a synchronise);
* device busy time (the union of kernel and copy intervals that
  ``torch.profiler`` records) and the device's idle share;
* kernels launched;
* for the PFB and each chain stage: the time of its kernels, their span on
  the device timeline and the host time (``record_function`` ranges around
  each stage, added by this script; host times are inflated by the
  profiler);
* the kernels with the most device time.

Usage (from the root of a checkout, on a machine with a card)::

    python3 profile_torch_bank.py [--mode usb|nfm|am|sam|rawam|wfm] [--blocks N]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

FS = 49.152e6
# mode → (channels, audio rate)
BANKS = {"usb": (1024, 12000.0), "nfm": (1024, 12000.0),
         "am": (2048, 12000.0), "sam": (2048, 12000.0),
         "rawam": (2048, 12000.0), "wfm": (128, 48000.0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=sorted(BANKS), default="usb",
                    help="demodulator mode of the bank (default usb)")
    ap.add_argument("--blocks", type=int, default=10,
                    help="profiled blocks (after 3 warm-up blocks)")
    args = ap.parse_args()
    m, audio_rate = BANKS[args.mode]

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_bank: no CUDA device available", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from openwebrx_tpu_torch.models.stages import _flatten
    from openwebrx_tpu_torch.ops import channelizer
    from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    bank = ChannelizedBank(FS, m, mode=args.mode, audio_rate=audio_rate,
                           compression="adpcm", target_seconds=0.05,
                           device=dev)
    for i in range(m):
        bank.assign(float((i - m // 2) * FS / m))

    # one record_function range per stage (this script's instrumentation)
    def annotate(label, fn):
        def wrapped(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapped

    channelizer.channelize = annotate("stage:pfb", channelizer.channelize)
    stages = _flatten(bank.chain)
    for st in stages:
        st.apply = annotate(f"stage:{st.label}", st.apply)

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

    run(3)
    t0 = time.perf_counter()
    run(args.blocks)
    wall_plain = (time.perf_counter() - t0) / args.blocks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.blocks)
        wall_prof = (time.perf_counter() - t0) / args.blocks
    n = args.blocks
    evts = prof.events()
    on_device = [e for e in evts if e.device_type == DeviceType.CUDA]
    # device busy: union of kernel/copy intervals (annotation spans excluded)
    spans = sorted((e.time_range.start, e.time_range.end) for e in on_device
                   if not e.name.startswith("stage:"))
    busy_us, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    busy_ms = busy_us / n / 1e3
    launches = sum(1 for e in evts if e.name in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
        "cuLaunchKernelEx")) / n
    print(f"[profile] {smi}: {args.mode} bank, M={m}: {n} blocks of "
          f"{bank.block} samples")
    print(f"[profile] wall {wall_plain * 1e3:.3f} ms/block without the profiler, "
          f"{wall_prof * 1e3:.3f} ms/block under it")
    print(f"[profile] device busy {busy_ms:.3f} ms/block; idle share "
          f"{1 - busy_ms / (wall_prof * 1e3):.3f} of the profiled wall time; "
          f"{launches:.0f} kernel launches/block")

    # per stage: kernel time inside the range, its span on the device
    # timeline, and host time (under the profiler)
    order = ["pfb"] + [st.label for st in stages]
    table = {k: [0.0, 0.0, 0.0] for k in order}
    for e in evts:
        if not e.name.startswith("stage:") or e.name[6:] not in table:
            continue
        row = table[e.name[6:]]
        if e.device_type == DeviceType.CUDA:
            row[1] += e.time_range.elapsed_us()
        else:
            row[0] += e.device_time_total if hasattr(e, "device_time_total") \
                else e.cuda_time_total
            row[2] += e.cpu_time_total
    print(f"[profile] {'stage':<14} {'kernels ms':>10} {'span ms':>10} {'host ms':>10}")
    for label in order:
        k_us, span_us, cpu_us = table[label]
        print(f"[profile] {label:<14} {k_us / n / 1e3:>10.4f} "
              f"{span_us / n / 1e3:>10.4f} {cpu_us / n / 1e3:>10.4f}")
    per_kernel = {}
    for e in on_device:
        if not e.name.startswith("stage:"):
            t, c = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    print("[profile] top device kernels (ms/block, launches/block):")
    for name, (t, c) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile]   {t / n / 1e3:9.4f} {c / n:7.1f}  {name[:90]}")
    print(json.dumps({
        "card": smi, "mode": args.mode, "channels": m,
        "block_samples": bank.block,
        "wall_ms": wall_plain * 1e3, "wall_ms_profiled": wall_prof * 1e3,
        "device_busy_ms": busy_ms, "launches_per_block": launches,
        "stages": {k: {"kernels_ms": v[0] / n / 1e3, "span_ms": v[1] / n / 1e3,
                       "host_ms": v[2] / n / 1e3} for k, v in table.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
