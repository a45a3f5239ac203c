#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``openwebrx_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, PyTorch's device name;
2. build the four CUDA kernels from ``openwebrx_tpu_torch/csrc`` and a
   second build of ``adpcm.cu`` with shorter strides, which phase 6 times
   (one ``nvcc`` per build, all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the full-width paths give it: the polyphase fold and the first-order IIR
   within stated tolerances; the ADPCM encoder (the fused ``adpcm_encode``
   at every path's shape over four blocks with the state carried, strides
   built on every boundary of its index estimate, and ``encode_strides``)
   with bytes, stride states and carried state identical; the AGC at every
   path's shape, on all-zero rows, on a silence-to-full-scale step and on
   rows longer than one shared-memory tile, with gain, hang counters and
   audio identical;
4. small banks (M=64) on the card against the same banks on the CPU (plain
   versions), on the same input, in every mode: usb, nfm, am, rawam, sam
   and wfm (gathered, at 384 kHz slices);
5. the paths at full width, each fed seeded device-resident IQ with every
   result fetched to host numpy, each with its kernels' launch counters set
   to 0 just before it and checked against the expected counts just after:
   the 1024-channel USB bank (BASELINE config #5), the 1024-channel NFM
   bank, the 2048-channel AM bank, the 128-channel WFM bank (0.2 s blocks)
   and BASELINE config #1 (2.4 MS/s NFM through ``build_program``).  Each
   checks its outputs' shapes and dtypes, decodes its tones (≥ 15 dB SNR)
   and logs ms/block, MS/s, its real-time multiple and peak memory; the
   shapes the paths hand the AGC and the ADPCM encoder are recorded and
   must be the ones phase 3 checked;
6. kernel device times (CUDA events, launches queued ahead of the device)
   beside their bounds, the plain versions and, for the fold, one PyTorch
   call computing the same function; the AGC and the ADPCM encoder at every
   path's shape, warm and cold (each launch on its own copy of the inputs,
   none of them in the L2 cache), beside the time of their serial chain,
   measured as a per-step slope: the AGC on one row of 48 and of 96
   chunks, the ADPCM recurrence in lanes of 104 and of 200 nibbles (the
   shorter build, first checked against the plain recurrence and for the
   same main loop in its SASS).

The last lines are a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
name/power-limit line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

FS = 49.152e6          # BASELINE config #5: 49.152 MS/s wideband input
M = 1024               # 1024 PFB channels at 48 kHz
CFG1_FS = 2.4e6        # BASELINE config #1: 2.4 MS/s, one NFM listener
CFG1_OFFSET = 145000.0
WARMUP_BLOCKS = 3
TIMED_BLOCKS = 20
TONE_CHANNELS = (100, 517, 900)     # dials i (of the 1024) given a tone
TONE_AUDIO_HZ = 1000.0
FM_DEVIATION = {"nfm": 3000.0, "wfm": 75000.0}
TONE_SNR_MIN_DB = 15.0              # as tests/test_channelized_bank.py
FOLD_RTOL = 1e-5       # × max|v|: fp32 sums of P=16 terms, FMA vs mul+add
IIR_RTOL = 1e-5        # × max|y|: warp-scan order vs the plain doubling scan
SMALL_BANK_LSB = 4     # int16 audio, card vs CPU: cuFFT/cuDNN sum orders
SAM_RMS_LSB = 0.5      # sync AM: rms over a carrier channel (see phase 4)
RDS_RTOL = 1e-4        # × max|rds|: WFM's RDS aux, card vs CPU
# NVIDIA H100 SXM data sheet (700 W): HBM rate and non-tensor fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# 32-bit integer instructions per clock per SM at compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput)
INT32_PER_CLOCK_PER_SM = 64
SLEEP_CYCLES_PER_S = 2.0e9   # ≥ the H100's SM clock: sleeps err long
L2_FLUSH_BYTES = 256 << 20   # read before cold launches: 5x the 50 MB L2
COLD_COPIES = 20             # launches timed cold, each on its own inputs
STEP_ITERS = 200             # launches per time of a per-step slope
# A second build of adpcm.cu with 52-byte strides: its lanes run the
# kernel's main loop (4 words of 8 nibbles) 3 times in place of 6
SHORT_STRIDE = 52
ADPCM_LOOP_NIBBLES = 32

# The shapes the full-width paths give the AGC (profile, x, chunk) and the
# ADPCM encoder (samples), as phase 5 records them
AGC_PATH_CASES = {"usb": ("SLOW", (M, 600), 50), "nfm": ("FAST", (M, 2400), 50),
                  "am": ("SLOW", (2 * M, 600), 50), "cfg1": ("FAST", (4800,), 50)}
ADPCM_PATH_SHAPES = {"usb": (M, 600), "nfm": (M, 600), "am": (2 * M, 600),
                     "wfm": (128, 9600), "cfg1": (1200,)}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_cuda(fn, iters: int, torch, flush=None) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls,
    from CUDA events.  The stream is first held busy for longer than the
    host takes to enqueue the calls, so the events time the device alone
    and not the Python wrappers' launch rate.  ``fn`` may be a list of
    calls, one per launch: cold timing gives each its own copy of the
    inputs and a ``flush`` tensor (larger than the L2 cache) that is read
    before the timed launches, so no launch finds its inputs in L2."""
    fns = fn if isinstance(fn, list) else [fn] * iters
    fns[0]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in fns:
        f()
    enqueue_s = time.perf_counter() - t0
    if flush is not None:
        flush.sum()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2 * enqueue_s + 0.01) * SLEEP_CYCLES_PER_S))
    start.record()
    for f in fns:
        f()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / len(fns)


def int16_audio(torch, gen, dev, rows, n):
    """(rows, n) int16 of tone + noise, with clipped channels and
    full-scale square waves mixed in."""
    t = torch.arange(n, device=dev, dtype=torch.float32)
    f = torch.linspace(200.0, 5800.0, rows, device=dev)[:, None]
    audio = (0.6 * torch.sin(2 * np.pi * f * t / 12000.0)
             + 0.3 * torch.randn(rows, n, generator=gen, device=dev))
    audio[::7] *= 4.0                                   # clipped channels
    audio[3::11] = torch.where(audio[3::11] > 0, 1.0, -1.0)   # ±full scale
    return torch.clamp(audio * 32767.0, -32768, 32767).to(torch.int16)


def agc_input(torch, gen, dev, shape):
    """Seeded AGC input: x of ``shape`` with channel levels spread over
    80 dB, and a random (gain, hang) start state."""
    rows = int(np.prod(shape[:-1]))
    x = (torch.randn(rows, shape[-1], generator=gen, device=dev)
         * 10.0 ** (torch.rand(rows, 1, generator=gen, device=dev) * 4 - 3)
         ).reshape(shape)
    state = (torch.rand(shape[:-1], generator=gen, device=dev) * 100 + 0.01,
             torch.randint(0, 31, shape[:-1], generator=gen, device=dev,
                           dtype=torch.int32))
    return state, x


def adpcm_input(torch, gen, dev, shape, blocks=1):
    """Seeded ADPCM encoder input: a random (predictor, index) start state
    and ``blocks`` int16 audio blocks of ``shape``."""
    rows = int(np.prod(shape[:-1]))
    state = (torch.randint(-32768, 32767, shape[:-1], generator=gen,
                           device=dev, dtype=torch.int32),
             torch.randint(0, 89, shape[:-1], generator=gen, device=dev,
                           dtype=torch.int32))
    return state, [int16_audio(torch, gen, dev, rows, shape[-1]).reshape(shape)
                   for _ in range(blocks)]


def sass_loop_instructions(lib) -> int:
    """Instructions in the widest loop of the built library ``lib``: from
    the target of its widest predicated backward branch to that branch, in
    ``cuobjdump -sass`` (next to ``nvcc``)."""
    from openwebrx_tpu_torch.kernels import _nvcc
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    addrs, loops = [], []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass):
        a = int(m.group(1), 16)
        addrs.append(a)
        b = re.search(r"@!?U?P\w+\s+BRA(?:\.\S+)?\s+(0x[0-9a-f]+)", m.group(2))
        if b and int(b.group(1), 16) < a:
            loops.append((a - int(b.group(1), 16), int(b.group(1), 16), a))
    check(loops, f"no loop in the SASS of {lib}")
    _, lo, hi = max(loops)
    return sum(lo <= a <= hi for a in addrs)


def boundary_strides(table, stride):
    """(89, 6·stride) int16: per table value k, three strides whose sums
    of |differences| are (2·stride − 1)·k − 1, ·k and ·k + 1 — mean |dx|
    just below, at and just above every step of the index estimate."""
    n1 = 2 * stride - 1
    rows = []
    for k in table:
        row = []
        for total in (n1 * int(k) - 1, n1 * int(k), n1 * int(k) + 1):
            q, r = divmod(total, n1)
            d = np.full(n1, q)
            d[:r] += 1                              # steps of q or q + 1
            sign = np.where(np.arange(n1) % 2 == 0, 1, -1)
            row.append(-((q + 1) // 2) + np.concatenate([[0], np.cumsum(sign * d)]))
        rows.append(np.concatenate(row))
    out = np.stack(rows)
    assert np.abs(out).max() <= 32767
    return out.astype(np.int16)


def agc_bytes(shape):
    """x in, y out, (gain, hang) in and out."""
    n = int(np.prod(shape))
    return n * 8 + 4 * 4 * (n // shape[-1])


def adpcm_bytes(shape):
    """int16 samples and the (predictor, index) state in; bytes, stride
    states and the new state out."""
    n = int(np.prod(shape))
    channels = n // shape[-1]
    return n * 2 + n // 2 + 4 * (n // 200) + 4 * 4 * channels


def tone_snr(audio, f_tone, fs_audio):
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio)))) ** 2
    freqs = np.fft.rfftfreq(len(audio), 1 / fs_audio)
    band = (freqs > f_tone * 0.9) & (freqs < f_tone * 1.1)
    rest = (freqs > 50) & ~band
    return 10 * np.log10(spec[band].sum() / spec[rest].sum())


def decode_channel(blocks, adpcm):
    """ADPCM bytes + stride reseeds of one channel over consecutive blocks
    → int16 audio, each stride decoded from its reseed state."""
    out = []
    state = (0, 0)
    for data, strides in blocks:
        for k in range(len(strides)):
            chunk = bytes(data[k * adpcm.STATE_STRIDE:(k + 1) * adpcm.STATE_STRIDE])
            d, _ = adpcm.adpcm_decode_np(chunk, state)
            out.append(d)
            state = adpcm.unpack_codec_state(int(strides[k]))
    return np.concatenate(out)


def modulated(torch, n, fs, fc, kind, amp):
    """A carrier at fc (Hz) with a TONE_AUDIO_HZ tone on it, complex64:
    ``usb`` a tone fc + f above the dial, ``am`` 60 % AM, ``nfm``/``wfm``
    FM at that mode's deviation.  n: float64 sample indices."""
    fa = TONE_AUDIO_HZ
    t = n / fs
    two_pi = 2 * np.pi
    amp_t = torch.full_like(t, amp)
    if kind == "usb":
        ph = torch.remainder(n * ((fc + fa) / fs), 1.0) * two_pi
    elif kind == "am":
        ph = torch.remainder(n * (fc / fs), 1.0) * two_pi
        amp_t = amp * (1 + 0.6 * torch.sin(two_pi * fa * t))
    else:
        dev = FM_DEVIATION[kind]
        ph = (torch.remainder(n * (fc / fs), 1.0) * two_pi
              + (dev / fa) * (1 - torch.cos(two_pi * fa * t)))
    return torch.polar(amp_t, ph).to(torch.complex64)


def seeded_blocks(torch, gen, dev, fs, block, n_blocks, carriers, kind,
                  noise=0.2, amp=0.4):
    """Seeded noise plus one modulated carrier at each frequency, made on
    the device before a run (set-up), phase-continuous across blocks."""
    out = []
    for b in range(n_blocks):
        n = torch.arange(block, device=dev, dtype=torch.float64) + b * block
        x = torch.complex(torch.randn(block, generator=gen, device=dev),
                          torch.randn(block, generator=gen, device=dev)) * noise
        for fc in carriers:
            x = x + modulated(torch, n, fs, fc, kind, amp)
        out.append(x.contiguous())
    torch.cuda.synchronize()
    return out


def drive(label, dispatch, fetch, blocks, kernels, torch, dev):
    """Run one path: every kernel count set to 0 just before it and read
    just after; the next block is dispatched before the previous one is
    fetched; blocks after WARMUP_BLOCKS are timed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.ALL:
        k.launches = 0
    results, pending, t_start = [], None, None
    for b, x in enumerate(blocks):
        if b == WARMUP_BLOCKS:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        nxt = dispatch(x)
        if pending is not None:
            results.append(fetch(*pending))
        pending = nxt
    results.append(fetch(*pending))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {k.source.name: k.launches for k in kernels.ALL}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    log(f"[{label}] launches: {launches} (blocks fed: {len(blocks)})")
    check(len(results) == len(blocks), f"{label}: missing results")
    return results, wall, launches, peak_mib


def report(label, smi, wall, n_timed, block, fs, peak_mib):
    msps = n_timed * block / wall / 1e6
    log(f"[{label}] {smi}: {n_timed} blocks of {block} samples in "
        f"{wall * 1e3:.3f} ms (results fetched to host every block): "
        f"{msps:.3f} MS/s = {msps / (fs / 1e6):.3f}x real time; "
        f"{wall / n_timed * 1e3:.3f} ms/block; peak device memory "
        f"{peak_mib:.1f} MiB")
    return {"ms_per_block": wall / n_timed * 1e3, "msps": msps,
            "realtime_x": msps / (fs / 1e6), "peak_mib": peak_mib}


def check_launches(label, launches, expected):
    for name, want in expected.items():
        check(launches[name] == want,
              f"{label}: {name} launched {launches[name]} times, expected {want}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from openwebrx_tpu_torch import kernels
    from openwebrx_tpu_torch.models.receiver import (
        ClientDemodulatorChain, build_program)
    from openwebrx_tpu_torch.ops import adpcm, agc, channelizer, iir
    from openwebrx_tpu_torch.ops.fold import polyphase_fold, polyphase_fold_plain
    from openwebrx_tpu_torch.runtime.chain import tree_map
    from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi} | torch: {kind} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    # adpcm_short: the ADPCM kernel with shorter strides, timed in phase 6
    adpcm_short = kernels.CudaKernel("adpcm.cu", kernels.ADPCM.symbol,
                                     kernels.ADPCM.argtypes,
                                     defines=(f"ADPCM_STRIDE={SHORT_STRIDE}",))
    builds = (*kernels.ALL, adpcm_short)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        secs = list(pool.map(lambda k: k.build(), builds))
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; " + ", ".join(
        f"{k.library_path().name} {s:.1f} s" for k, s in zip(builds, secs)))
    for k in builds:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", k.build_log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", k.build_log))
        log(f"[build] {k.library_path().name}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}..{max(regs, default=0)}, spill bytes {spills}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # -- 3. kernels against their plain versions, main-path shapes -----------
    p_taps = 16
    block = 2400 * M                       # channel block 2400 at 48 kHz
    n_time = block // M + p_taps - 1       # rows of u the bank folds
    proto = torch.as_tensor(channelizer.design_prototype(M, p_taps), device=dev)
    bank2 = torch.flip(proto.reshape(p_taps, M), dims=(0, 1)).contiguous()
    u = torch.complex(torch.randn(n_time, M, generator=gen, device=dev),
                      torch.randn(n_time, M, generator=gen, device=dev)) * 0.2
    v_kernel = polyphase_fold(u, bank2, p_taps, device=dev)
    v_plain = polyphase_fold_plain(u, bank2, p_taps)
    torch.cuda.synchronize()
    fold_err = float((v_kernel - v_plain).abs().max())
    fold_tol = FOLD_RTOL * float(v_plain.abs().max())
    log(f"[check] fold u{tuple(u.shape)} -> v{tuple(v_kernel.shape)}: "
        f"max_abs_err {fold_err:.3e} (tolerance {fold_tol:.3e})")
    check(tuple(v_kernel.shape) == (block // M, M), "fold output shape")
    check(fold_err <= fold_tol, f"fold kernel disagrees: {fold_err} > {fold_tol}")

    # ADPCM.  encode_strides (the recurrence on explicit start states) at
    # the bank's 3072 lanes; then the fused adpcm_encode (one launch)
    # against its plain composition on the card at every path's shape, four
    # blocks with the state carried; strides on every boundary of the index
    # estimate; and the card against the all-plain CPU encode
    samples = int16_audio(torch, gen, dev, M, 600)
    lanes_in = samples.reshape(-1, 2 * adpcm.STATE_STRIDE).contiguous()
    prev = torch.randint(-32768, 32767, (lanes_in.shape[0],), generator=gen,
                         device=dev, dtype=torch.int32)
    idxs = torch.randint(0, 89, (lanes_in.shape[0],), generator=gen,
                         device=dev, dtype=torch.int32)
    b_kernel = adpcm.encode_strides(lanes_in, prev, idxs, device=dev)
    b_plain = adpcm.encode_strides_plain(lanes_in, prev, idxs)
    torch.cuda.synchronize()
    adpcm_mismatch = int((b_kernel != b_plain).sum())
    adpcm_err = int((b_kernel.to(torch.int32) - b_plain.to(torch.int32)).abs().max())
    log(f"[check] adpcm encode_strides lanes {tuple(lanes_in.shape)} -> bytes "
        f"{tuple(b_kernel.shape)}: {adpcm_mismatch} bytes differ (must be 0)")
    check(adpcm_mismatch == 0, "ADPCM kernel bytes differ from the plain version")

    adpcm_in = {}                  # label: (state, samples) timed in phase 6

    def adpcm_case(label, state, blocks):
        nonlocal adpcm_err
        kst = pst = state
        for x in blocks:
            kst, (kb, ks) = adpcm.adpcm_encode(kst, x)
            pst, (pb, ps) = adpcm.adpcm_encode_plain(pst, x)
            torch.cuda.synchronize()
            n_bytes = int((kb != pb).sum())
            adpcm_err = max(adpcm_err, int((kb.to(torch.int32)
                                            - pb.to(torch.int32)).abs().max()))
            same = (n_bytes == 0 and torch.equal(ks, ps)
                    and all(torch.equal(a, b) for a, b in zip(kst, pst)))
            check(same, f"adpcm_encode {label} {tuple(x.shape)}: kernel differs "
                  f"from the plain composition ({n_bytes} bytes differ)")
        log(f"[check] adpcm_encode {label} {tuple(blocks[0].shape)} "
            f"({blocks[0].numel() // 200} lanes), {len(blocks)} blocks carried: "
            f"bytes, stride states and state identical")

    for label, shape in ADPCM_PATH_SHAPES.items():
        if label == "nfm":           # the same shape as usb
            adpcm_in[label] = adpcm_in["usb"]
            continue
        state, blocks = adpcm_input(torch, gen, dev, shape, blocks=4)
        adpcm_case(label, state, blocks)
        adpcm_in[label] = (state, blocks[0])
    edge = torch.as_tensor(boundary_strides(adpcm.IMA_STEP_TABLE,
                                            adpcm.STATE_STRIDE), device=dev)
    adpcm_case("boundary strides", adpcm.adpcm_init((edge.shape[0],), device=dev),
               [edge, torch.flip(edge, dims=(0,)).contiguous()])
    state = adpcm_in["usb"][0]
    st_c, (by_c, sd_c) = adpcm.adpcm_encode(state, samples)
    st_h, (by_h, sd_h) = adpcm.adpcm_encode(tuple(s.cpu() for s in state),
                                            samples.cpu())
    same = (torch.equal(by_c.cpu(), by_h) and torch.equal(sd_c.cpu(), sd_h)
            and all(torch.equal(a.cpu(), b) for a, b in zip(st_c, st_h)))
    log(f"[check] adpcm_encode (1024, 600) card vs CPU: bytes, stride and "
        f"new_state identical = {same}")
    check(same, "adpcm_encode on the card differs from the CPU plain path")

    # first-order IIR at the NFM bank's de-emphasis: (1024, 2400) at 48 kHz
    deemph = iir.deemphasis_coeffs(48000.0, 150e-6)
    iir_x = torch.randn(M, 2400, generator=gen, device=dev) * 0.3
    iir_st = (torch.randn(M, generator=gen, device=dev),
              torch.randn(M, generator=gen, device=dev))
    (ix_k, iy_k), y_k = iir.first_order_apply(iir_st, *deemph, iir_x, device=dev)
    (ix_p, iy_p), y_p = iir.first_order_apply_plain(iir_st, *deemph, iir_x)
    torch.cuda.synchronize()
    iir_err = max(float((y_k - y_p).abs().max()), float((iy_k - iy_p).abs().max()))
    iir_tol = IIR_RTOL * float(y_p.abs().max())
    log(f"[check] iir x{tuple(iir_x.shape)}: max_abs_err {iir_err:.3e} "
        f"(tolerance {iir_tol:.3e}); x state identical = {torch.equal(ix_k, ix_p)}")
    check(iir_err <= iir_tol and torch.equal(ix_k, ix_p),
          f"IIR kernel disagrees: {iir_err} > {iir_tol}")

    # AGC at every path's shape, channel levels spread over 80 dB and random
    # start states; then all-zero rows and silence-to-full-scale steps from
    # the initial state, and rows longer than one shared-memory tile
    agc_cases = {**AGC_PATH_CASES, "long rows": ("FAST", (4, 20000), 50)}
    agc_in = {}                    # label: (profile, state, x, chunk)
    agc_err = 0.0
    for label, (pname, shape, chunk) in agc_cases.items():
        st, x = agc_input(torch, gen, dev, shape)
        agc_in[label] = (getattr(agc, pname), st, x, chunk)
    step = torch.zeros(8, 2400, device=dev)
    step[2:4, 2200:] = 1.0                         # silence, then full scale
    step[4:6, 600:650] = -1.0                      # a pulse: hang runs out
    step[6:] = torch.randn(2, 2400, generator=gen, device=dev) * 0.01
    agc_in["zeros and steps"] = (agc.FAST, agc.agc_init(agc.FAST, (8,), device=dev),
                                 step, 50)
    for label, (prof, st, x, chunk) in agc_in.items():
        (g_k, h_k), a_k = agc.agc_apply(st, prof, x, chunk, device=dev)
        (g_p, h_p), a_p = agc.agc_apply_plain(st, prof, x, chunk)
        torch.cuda.synchronize()
        state_same = torch.equal(g_k, g_p) and torch.equal(h_k, h_p)
        err = float((a_k - a_p).abs().max())
        agc_err = max(agc_err, err)
        log(f"[check] agc {label} x{tuple(x.shape)} chunk {chunk}: gain and hang "
            f"identical = {state_same}; audio identical = {torch.equal(a_k, a_p)} "
            f"(max_abs_err {err:.3e})")
        check(state_same, f"AGC kernel gain or hang differs ({label})")
        check(torch.equal(a_k, a_p), f"AGC kernel audio differs ({label})")
    (g_s, h_s), _ = agc.agc_apply(agc_in["zeros and steps"][1], agc.FAST, step, 50,
                                  device=dev)
    check(bool((g_s[:2] == agc.FAST.max_gain).all()) and bool((h_s[2:4] > 0).all())
          and bool((h_s[4:6] == 0).all()),
          f"AGC scene: zero rows at max gain, steps armed, pulses run out: "
          f"{g_s.tolist()} {h_s.tolist()}")

    # -- 4. small banks on the card against the CPU plain path ---------------
    # Every mode; usb and am are compared from block 0 on.  In the other
    # modes the card bank takes the CPU bank's state after block 0, whose
    # difference is only logged: at stream start the FFT bandpass's outputs
    # are ~1e-7 with ~1e-8 of absolute rounding noise, so the FM
    # discriminator's first samples are noise in any two float32
    # implementations, and an AGC without a DC blocker (rawam) or a carrier
    # estimate (sam) turns that noise into different startup gains
    small_modes = {                  # mode: (fs, m, capacity, audio_rate)
        "usb": (3.072e6, 64, None, 12000.0), "nfm": (3.072e6, 64, None, 12000.0),
        "am": (3.072e6, 64, None, 12000.0), "rawam": (3.072e6, 64, None, 12000.0),
        "sam": (3.072e6, 64, None, 12000.0), "wfm": (24.576e6, 64, 2, 48000.0)}
    carrier_slots = (5, 20, 40)
    for mode, (sfs, sm, scap, srate) in small_modes.items():
        dial_idx = range(sm) if scap is None else (20, 40)
        banks = {}
        for where in ("cpu", "cuda"):
            sb = ChannelizedBank(sfs, sm, mode=mode, compression="none",
                                 target_seconds=0.05, capacity=scap,
                                 audio_rate=srate, device=where)
            for i in dial_idx:
                sb.assign(float((i - sm // 2) * sfs / sm))
            banks[where] = sb
        carriers = [float((i - sm // 2) * sfs / sm)
                    for i in (carrier_slots if scap is None else (20, 40))]
        if mode == "usb":            # as in earlier runs: noise only
            carriers = []
        kind_of = {"usb": "usb", "nfm": "nfm", "wfm": "wfm"}.get(mode, "am")
        blocks = seeded_blocks(torch, gen, dev, sfs, banks["cpu"].block, 4,
                               carriers, kind_of, noise=0.1)
        handover = mode not in ("usb", "am")
        outs = {"cpu": [], "cuda": []}
        rds_out = {"cpu": [], "cuda": []}
        for b, x in enumerate(blocks):
            if b == 1 and handover:
                banks["cuda"].state = tree_map(lambda s: s.to(dev),
                                               banks["cpu"].state)
            ys = {}
            for where in ("cpu", "cuda"):
                y, aux = banks[where].process(x if where == "cuda" else x.cpu())
                ys[where] = y
                if b >= (1 if handover else 0):
                    outs[where].append(y)
                if mode == "wfm":
                    rds = aux["wfm.rds_tap.rds"]
                    check(rds.dtype == np.complex64 and np.isfinite(rds).all()
                          and rds.shape == (2, banks[where].channel_block * 250 // 384 // 16),
                          f"small wfm rds aux {rds.shape} {rds.dtype}")
                    if b >= 1:
                        rds_out[where].append(rds)
            if b == 0 and handover:
                d0 = np.abs(ys["cuda"].astype(np.int32) - ys["cpu"].astype(np.int32))
                log(f"[check] small bank {mode}: block 0 (before the state "
                    f"handover) card vs CPU max diff {int(d0.max())} LSB, not checked")
        a = np.concatenate(outs["cuda"], axis=-1).astype(np.float64)
        c = np.concatenate(outs["cpu"], axis=-1).astype(np.float64)
        diff = np.abs(a - c)
        if mode == "sam":
            # the block-wise carrier estimate (atan2 of a sum of rotations)
            # rounds differently at a few samples: rms over carrier channels
            rows = [banks["cpu"].channel_for(f)[0] for f in carriers]
            rms = np.sqrt(np.mean(diff[rows] ** 2, axis=-1))
            log(f"[check] small bank {mode} M={sm}: card vs CPU rms diff on "
                f"carrier channels {np.round(rms, 4).tolist()} LSB (tolerance "
                f"{SAM_RMS_LSB}); max {int(diff.max())} LSB")
            check(rms.max() <= SAM_RMS_LSB, f"small {mode} bank: card and CPU disagree")
        else:
            log(f"[check] small bank {mode} M={sm}{'' if scap is None else f' capacity {scap}'}"
                f": int16 audio card vs CPU max diff {int(diff.max())} LSB "
                f"(tolerance {SMALL_BANK_LSB}), mean {diff.mean():.4f}")
            check(diff.max() <= SMALL_BANK_LSB, f"small {mode} bank: card and CPU disagree")
        if mode == "wfm":
            # the RDS baseband (57 kHz mix, 16-fold FIR decimation) on the
            # card against the CPU, as the CPU tests hold it against JAX
            rc = np.concatenate(rds_out["cpu"], axis=-1)
            rds_err = float(np.abs(np.concatenate(rds_out["cuda"], axis=-1) - rc).max())
            rds_tol = RDS_RTOL * float(np.abs(rc).max())
            log(f"[check] small bank wfm rds aux card vs CPU: max_abs_err "
                f"{rds_err:.3e} (tolerance {rds_tol:.3e})")
            check(rds_err <= rds_tol, "small wfm bank: card and CPU rds disagree")

    # -- 5. the paths at full width ------------------------------------------
    # record the shapes the paths hand the AGC and the ADPCM encoder (the
    # stages call them through their modules)
    seen_agc, seen_adpcm = set(), set()
    agc_apply, adpcm_encode = agc.agc_apply, adpcm.adpcm_encode

    def agc_recorded(state, profile, x, chunk=agc.CHUNK, device="cuda"):
        seen_agc.add((profile, tuple(x.shape), chunk))
        return agc_apply(state, profile, x, chunk, device=device)

    def adpcm_recorded(state, x):
        seen_adpcm.add(tuple(x.shape))
        return adpcm_encode(state, x)

    agc.agc_apply, adpcm.adpcm_encode = agc_recorded, adpcm_recorded
    paths = {}
    launches_by_path = {}
    n_blocks = WARMUP_BLOCKS + TIMED_BLOCKS
    bank_paths = [
        # label, mode, m, audio rate, blocks timed, expected launches/block
        ("usb", "usb", 1024, 12000.0, TIMED_BLOCKS,
         {"fold.cu": 1, "adpcm.cu": 1, "iir.cu": 0, "agc.cu": 1}),
        ("nfm", "nfm", 1024, 12000.0, TIMED_BLOCKS,
         {"fold.cu": 1, "adpcm.cu": 1, "iir.cu": 1, "agc.cu": 1}),
        ("am", "am", 2048, 12000.0, TIMED_BLOCKS,
         {"fold.cu": 1, "adpcm.cu": 1, "iir.cu": 1, "agc.cu": 1}),
        ("wfm", "wfm", 128, 48000.0, 5,
         {"fold.cu": 1, "adpcm.cu": 1, "iir.cu": 1, "agc.cu": 0}),
    ]
    for label, mode, m, rate, n_timed, per_block in bank_paths:
        bank = ChannelizedBank(FS, m, mode=mode, audio_rate=rate,
                               compression="adpcm", target_seconds=0.05,
                               device=dev)
        for i in range(m):
            bank.assign(float((i - m // 2) * FS / m))
        carriers = [float((i * m // M - m // 2) * FS / m) for i in TONE_CHANNELS]
        tone_slots = [bank.channel_for(f)[0] for f in carriers]   # dense: slot k
        nb = WARMUP_BLOCKS + n_timed
        blocks = seeded_blocks(torch, gen, dev, FS, bank.block, nb, carriers,
                               mode)
        results, wall, launches, peak = drive(
            label, bank.dispatch, bank.fetch, blocks, kernels, torch, dev)
        launches_by_path[label] = launches
        check_launches(label, launches, {k: v * nb for k, v in per_block.items()})
        out_bytes = bank.channel_block * int(rate) // int(bank.channel_rate) // 2
        squelch = bank.chain.selector.squelch
        windows = squelch.block // squelch.window
        for y, aux in results:
            data, strides = y
            pdb = aux["selector.squelch.power_db"]
            check(data.shape == (m, out_bytes) and data.dtype == np.uint8,
                  f"{label}: bytes {data.shape} {data.dtype}")
            check(strides.shape == (m, out_bytes // adpcm.STATE_STRIDE)
                  and strides.dtype == np.int32, f"{label}: stride {strides.shape}")
            check(pdb.shape == (m, windows) and pdb.dtype == np.float32
                  and np.isfinite(pdb).all(), f"{label}: power_db {pdb.shape}")
            if mode == "wfm":
                rds = aux["wfm.rds_tap.rds"]
                check(rds.shape == (m, bank.channel_block * 250 // 384 // 16)
                      and rds.dtype == np.complex64 and np.isfinite(rds).all(),
                      f"wfm: rds aux {rds.shape} {rds.dtype}")
        for k in tone_slots:
            audio_k = decode_channel([(y[0][k], y[1][k]) for y, _ in results], adpcm)
            settled = audio_k[len(audio_k) // 2:].astype(np.float32) / 32767
            snr = tone_snr(settled, TONE_AUDIO_HZ, rate)
            log(f"[{label}] slot {k}: {mode} tone SNR {snr:.1f} dB "
                f"(minimum {TONE_SNR_MIN_DB})")
            check(snr > TONE_SNR_MIN_DB, f"{label}: channel {k} tone SNR {snr:.1f} dB")
        quiet = decode_channel([(y[0][5], y[1][5]) for y, _ in results], adpcm)
        check(np.isfinite(quiet).all(), f"{label}: quiet channel audio")
        paths[label] = report(label, smi, wall, n_timed, bank.block, FS, peak)
        del bank, blocks, results
        torch.cuda.empty_cache()

    # BASELINE config #1: 2.4 MS/s → NFM → 12 kHz ADPCM through Program
    chain = ClientDemodulatorChain(CFG1_FS, mode="nfm", compression="adpcm")
    chain.set_frequency_offset(CFG1_OFFSET)
    prog = build_program(chain, CFG1_FS, target_seconds=0.1, device=dev)
    blocks = seeded_blocks(torch, gen, dev, CFG1_FS, prog.block, n_blocks,
                           [CFG1_OFFSET], "nfm", noise=0.05)
    results, wall, launches, peak = drive(
        "cfg1", prog.dispatch, prog.fetch, blocks, kernels, torch, dev)
    launches_by_path["cfg1"] = launches
    check_launches("cfg1", launches, {"fold.cu": 0, "adpcm.cu": n_blocks,
                                      "iir.cu": n_blocks, "agc.cu": n_blocks})
    for y, aux in results:
        data, strides = y
        check(data.shape == (prog.out_block,) and data.dtype == np.uint8,
              f"cfg1: bytes {data.shape} {data.dtype}")
        check(strides.shape == (prog.out_block // adpcm.STATE_STRIDE,)
              and strides.dtype == np.int32, f"cfg1: stride {strides.shape}")
        pdb = aux["selector.squelch.power_db"]
        check(pdb.dtype == np.float32 and np.isfinite(pdb).all(), "cfg1: power_db")
    audio1 = decode_channel([y for y, _ in results], adpcm)
    snr = tone_snr(audio1[len(audio1) // 2:].astype(np.float32) / 32767,
                   TONE_AUDIO_HZ, 12000.0)
    log(f"[cfg1] NFM tone at {CFG1_OFFSET:.0f} Hz: SNR {snr:.1f} dB "
        f"(minimum {TONE_SNR_MIN_DB})")
    check(snr > TONE_SNR_MIN_DB, f"cfg1: tone SNR {snr:.1f} dB")
    paths["cfg1"] = report("cfg1", smi, wall, TIMED_BLOCKS, prog.block,
                           CFG1_FS, peak)
    agc.agc_apply, adpcm.adpcm_encode = agc_apply, adpcm_encode
    log(f"[shapes] agc on the paths: {sorted((s, c) for _, s, c in seen_agc)}; "
        f"adpcm_encode on the paths: {sorted(seen_adpcm)}")
    # phase 3 checked exactly these; an empty record fails here too
    path_agc = {(getattr(agc, p), s, c) for p, s, c in AGC_PATH_CASES.values()}
    check(seen_agc == path_agc, f"AGC shapes on the paths {seen_agc} are not "
          f"the expected {path_agc}")
    check(seen_adpcm == set(ADPCM_PATH_SHAPES.values()), f"ADPCM shapes on the "
          f"paths {seen_adpcm} are not the expected {set(ADPCM_PATH_SHAPES.values())}")
    print(json.dumps({"card": smi, "paths": paths}), flush=True)

    # -- 6. kernel timings at the main-path shapes ------------------------------
    iters = 50
    fold_ms = time_cuda(lambda: polyphase_fold(u, bank2, p_taps, device=dev), iters, torch)
    fold_plain_ms = time_cuda(lambda: polyphase_fold_plain(u, bank2, p_taps), iters, torch)
    # yardstick only, never on the port's path: depthwise conv1d over
    # (2, M, T) re/im planes computing the same v
    lhs = torch.view_as_real(u).permute(2, 1, 0).contiguous()     # (2, M, T)
    wconv = bank2.T.contiguous()[:, None, :]                       # (M, 1, P)
    import torch.nn.functional as F
    v_conv = F.conv1d(lhs, wconv, groups=M)
    conv_err = float((torch.complex(v_conv[0], v_conv[1]).T - v_plain).abs().max())
    fold_lib_ms = time_cuda(lambda: F.conv1d(lhs, wconv, groups=M), iters, torch)
    iir_ms = time_cuda(lambda: iir.first_order_apply(iir_st, *deemph, iir_x, device=dev),
                       iters, torch)
    iir_plain_ms = time_cuda(lambda: iir.first_order_apply_plain(iir_st, *deemph, iir_x),
                             iters, torch)
    fold_bytes = u.numel() * 8 + bank2.numel() * 4 + v_plain.numel() * 8
    fold_ops = 4 * p_taps * v_plain.numel()        # re+im: P mul-adds each
    # IIR: x in, y out, four (rows,) state vectors; per sample 2 mul + 1 add
    # for c[n] and one multiply-add for y[n]
    iir_bytes = iir_x.numel() * 8 + 4 * M * 4
    iir_ops = 5 * iir_x.numel()

    def bound(nbytes, nops, ops_per_s=FP32_OPS_PER_S):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    fold_bound, fold_by = bound(fold_bytes, fold_ops)
    iir_bound, iir_by = bound(iir_bytes, iir_ops)
    log(f"[time] {smi}: fold kernel {fold_ms:.5f} ms, bound {fold_bound:.5f} ms "
        f"({fold_by}: {fold_bytes} B, {fold_ops} flop), plain {fold_plain_ms:.5f} ms, "
        f"depthwise F.conv1d {fold_lib_ms:.5f} ms (max diff {conv_err:.2e})")
    log(f"[time] {smi}: iir kernel {iir_ms:.5f} ms, bound {iir_bound:.5f} ms "
        f"({iir_by}: {iir_bytes} B, {iir_ops} flop), plain {iir_plain_ms:.5f} ms")

    # the two recurrences at every path's shape, warm and cold, beside the
    # roofline bound (bytes or operations) and the time of their serial
    # chain: its time per step, measured below as a slope, times the steps
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_per_s = INT32_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6
    flush = torch.ones(L2_FLUSH_BYTES // 4, device=dev)

    def timed(label, name, fn, args, nbytes, nops, ops_per_s, chain):
        """fn(*args) timed warm, then cold: one copy of args per launch."""
        warm = time_cuda(lambda: fn(*args), iters, torch)
        copies = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                  for _ in range(COLD_COPIES)]
        cold = time_cuda([lambda c=c: fn(*c) for c in copies], COLD_COPIES,
                         torch, flush)
        del copies
        b, by = bound(nbytes, nops, ops_per_s)
        log(f"[time] {smi}: {name} {label}: warm {warm:.5f} ms, cold {cold:.5f} "
            f"ms; bound {b:.5f} ms ({by}: {nbytes} B, {nops} ops at "
            f"{ops_per_s:.4g}/s), chain {chain:.5f} ms; cold share of the bound "
            f"{b / cold:.3f}, of the chain {chain / cold:.3f}")
        return {"ms": warm, "cold_ms": cold, "bound_ms": b, "bound_by": by,
                "chain_bound_ms": chain}

    # the floor of any launch: an empty kernel, back to back
    launch_ms = time_cuda(lambda: torch.cuda._sleep(0), iters, torch)
    log(f"[time] {smi}: empty kernel (torch.cuda._sleep(0)) back to back "
        f"{launch_ms:.5f} ms")

    # AGC chain per chunk: one-row launches of 48 and 96 chunks.  One row's
    # parallel passes spread over a CTA, so the difference is 48 steps of
    # the recurrence plus those passes' small share: an upper estimate
    one_row = {}
    for n in (2400, 4800):
        st1, x1 = agc_input(torch, gen, dev, (n,))
        one_row[n] = time_cuda(lambda: agc.agc_apply(st1, agc.FAST, x1, 50, device=dev),
                               STEP_ITERS, torch)
    agc_step_ms = (one_row[4800] - one_row[2400]) / ((4800 - 2400) // 50)
    log(f"[time] {smi}: agc one row, FAST: 48 chunks {one_row[2400]:.5f} ms, "
        f"96 chunks {one_row[4800]:.5f} ms: {agc_step_ms * 1e3:.5f} us = "
        f"{agc_step_ms * clock_mhz * 1e3:.1f} cycles a chunk at {clock_mhz:.0f} MHz")

    agc_rows = {}
    for label in AGC_PATH_CASES:
        prof, st, x, chunk = agc_in[label]
        agc_rows[label] = dict(shape=list(x.shape), chunk=chunk, **timed(
            label, "agc kernel",
            lambda g, h, x, prof=prof, chunk=chunk: agc.agc_apply(
                (g, h), prof, x, chunk, device=dev), (*st, x),
            agc_bytes(tuple(x.shape)), 6 * x.numel(), FP32_OPS_PER_S,
            agc_step_ms * (x.shape[-1] // chunk)))
    prof, st, x, chunk = agc_in["nfm"]
    agc_plain_ms = time_cuda(lambda: agc.agc_apply_plain(st, prof, x, chunk), 5, torch)
    log(f"[time] {smi}: agc plain nfm {agc_plain_ms:.5f} ms")

    # ADPCM chain per nibble: the recurrence alone (explicit start states)
    # at the bank's 3072 lanes, in lanes of 200 nibbles and, in the short
    # build, of 104.  The slope holds only if both builds compiled the main
    # loop alike, and the short build must compute the plain recurrence
    lanes = lanes_in.shape[0]
    short_in = int16_audio(torch, gen, dev, lanes, 2 * SHORT_STRIDE)
    short_out = torch.empty((lanes, SHORT_STRIDE), dtype=torch.uint8, device=dev)

    def launch_short():
        adpcm_short.launch(short_in.data_ptr(), None, None, prev.data_ptr(),
                           idxs.data_ptr(), short_out.data_ptr(), None, None,
                           None, lanes, 1, kernels.stream_handle(dev))

    launch_short()
    check(torch.equal(short_out, adpcm.encode_strides_plain(short_in, prev, idxs)),
          f"ADPCM kernel with {SHORT_STRIDE}-byte strides differs from the plain "
          f"recurrence")
    loop_instrs = sass_loop_instructions(kernels.ADPCM.library_path())
    short_loop = sass_loop_instructions(adpcm_short.library_path())
    check(loop_instrs == short_loop, f"ADPCM builds differ in their main loop: "
          f"{loop_instrs} and {short_loop} instructions")
    short_ms = time_cuda(launch_short, iters, torch)
    strides_ms = time_cuda(
        lambda: adpcm.encode_strides(lanes_in, prev, idxs, device=dev), iters, torch)
    adpcm_step_ms = strides_ms - short_ms
    adpcm_step_ms /= 2 * (adpcm.STATE_STRIDE - SHORT_STRIDE)
    # operations: the instructions the build issues a nibble, counted in its
    # SASS, over the int32 issue rate, and 3 a sample in the estimate
    nibble_instrs = loop_instrs / ADPCM_LOOP_NIBBLES
    log(f"[time] {smi}: adpcm recurrence alone, {lanes} lanes: {2 * SHORT_STRIDE} "
        f"nibbles {short_ms:.5f} ms, 200 nibbles {strides_ms:.5f} ms (bytes "
        f"identical to the plain recurrence; main loop {loop_instrs} SASS "
        f"instructions in both builds, {nibble_instrs:.2f} a nibble): "
        f"{adpcm_step_ms * 1e6:.3f} ns = {adpcm_step_ms * clock_mhz * 1e3:.1f} "
        f"cycles a nibble at {clock_mhz:.0f} MHz")

    adpcm_rows = {}
    for label, shape in ADPCM_PATH_SHAPES.items():
        st, x = adpcm_in[label]
        if label == "nfm":                  # the same shape as usb
            adpcm_rows[label] = adpcm_rows["usb"]
            continue
        nibbles = x.numel()                 # a nibble per sample
        adpcm_rows[label] = dict(shape=list(shape), lanes=nibbles // (2 * adpcm.STATE_STRIDE), **timed(
            label, "adpcm_encode kernel",
            lambda p0, i0, x: adpcm.adpcm_encode((p0, i0), x), (*st, x),
            adpcm_bytes(shape), round(nibble_instrs * nibbles) + 3 * x.numel(),
            int32_per_s, adpcm_step_ms * 2 * adpcm.STATE_STRIDE))
    st, x = adpcm_in["usb"]
    adpcm_plain_ms = time_cuda(lambda: adpcm.adpcm_encode_plain(st, x), 3, torch)
    log(f"[time] {smi}: adpcm_encode plain (1024, 600) {adpcm_plain_ms:.5f} ms")
    agc_main, adpcm_main = agc_rows["nfm"], adpcm_rows["nfm"]

    def total(name):
        return sum(v[name] for v in launches_by_path.values())

    def by_path(name):
        return {p: v[name] for p, v in launches_by_path.items()}

    line = {"kernels": [
        {"name": "polyphase_fold", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/fold.cu",
         "replaces": "openwebrx_tpu/ops/pallas_fold.py:39",
         "launches": total("fold.cu"), "launches_by_path": by_path("fold.cu"),
         "max_abs_err": fold_err, "ms": fold_ms, "plain_ms": fold_plain_ms,
         "bound_ms": fold_bound, "bound_by": fold_by, "library_ms": fold_lib_ms},
        {"name": "adpcm_encode", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/adpcm.cu",
         "replaces": "openwebrx_tpu/ops/adpcm.py:131",
         "launches": total("adpcm.cu"), "launches_by_path": by_path("adpcm.cu"),
         "max_abs_err": float(adpcm_err), "ms": adpcm_main["ms"],
         "cold_ms": adpcm_main["cold_ms"], "plain_ms": adpcm_plain_ms,
         "bound_ms": adpcm_main["bound_ms"], "bound_by": adpcm_main["bound_by"],
         "chain_bound_ms": adpcm_main["chain_bound_ms"], "library_ms": None,
         "encode_strides_ms": strides_ms, "by_shape": adpcm_rows},
        {"name": "first_order_iir", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/iir.cu",
         "replaces": "openwebrx_tpu/ops/iir.py:18",
         "launches": total("iir.cu"), "launches_by_path": by_path("iir.cu"),
         "max_abs_err": iir_err, "ms": iir_ms, "plain_ms": iir_plain_ms,
         "bound_ms": iir_bound, "bound_by": iir_by, "library_ms": None},
        {"name": "agc_chunked", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/agc.cu",
         "replaces": "openwebrx_tpu/ops/agc.py:58",
         "launches": total("agc.cu"), "launches_by_path": by_path("agc.cu"),
         "max_abs_err": agc_err, "ms": agc_main["ms"],
         "cold_ms": agc_main["cold_ms"], "plain_ms": agc_plain_ms,
         "bound_ms": agc_main["bound_ms"], "bound_by": agc_main["bound_by"],
         "chain_bound_ms": agc_main["chain_bound_ms"], "library_ms": None,
         "by_shape": agc_rows},
    ]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
