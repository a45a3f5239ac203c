#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``openwebrx_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, PyTorch's device name;
2. build the six CUDA kernels from ``openwebrx_tpu_torch/csrc`` and a
   second build of ``adpcm.cu`` with shorter strides, which phase 6 times
   (one ``nvcc`` per build, all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the full-width paths give it: the polyphase fold (M = 1024, config #2's
   M = 64 and configs #3 and #6's M = 256) and the first-order IIR within stated tolerances; the ADPCM
   encoder (the fused ``adpcm_encode`` at every path's shape over four
   blocks with the state carried, strides built on every boundary of its
   index estimate, and ``encode_strides``) with bytes, stride states and
   carried state identical; the AGC at every path's shape, on all-zero
   rows, on a silence-to-full-scale step and on rows longer than one
   shared-memory tile, with gain, hang counters and audio identical; the
   squelch at every path's shape and on silent rows, NaN rows and a burst
   that arms the hang and runs it out, with power_db within
   SQUELCH_DB_TOL and gates, hang and output bit-identical wherever the
   power is not that close to the level; the exact IMA row encoder
   (``adpcm_encode_seq``) bit-identical at the waterfall's shape, on 16
   rows, on full-scale square waves and from random start states;
4. small banks (M=64) on the card against the same banks on the CPU (plain
   versions), on the same input, in every mode: usb, nfm, am, rawam, sam
   and wfm (gathered, at 384 kHz slices); the waterfall (``FftChain``,
   float and compressed rows); every secondary and digital-voice chain on
   two channels; a ``Fanout`` against its branches run alone; the
   runtime's ``SecondaryBank`` fed device chunks, its FFT rows encoded on
   the card, against the same bank on the CPU;
5. the paths at full width, each fed seeded device-resident IQ with every
   result fetched to host numpy, each with its kernels' launch counters set
   to 0 just before it and checked against the expected counts just after:
   the 1024-channel USB bank (BASELINE config #5), the 1024-channel NFM
   bank, the 2048-channel AM bank, the 128-channel WFM bank (0.2 s blocks),
   BASELINE config #1 (2.4 MS/s NFM through ``build_program``), config #2
   (a compressed 4096-bin waterfall, a PFB listener and a full-rate edge
   dial on one 2.4 MS/s block), config #4 (a ``Fanout`` of 16 BPSK31 and 16
   USB channels delivered in 6-block batches, checked against the CPU) and
   the USB bank beside a 4096-bin waterfall of its 49.152 MS/s input; then,
   through the port's ``DeviceRuntime`` fed uint8 wire blocks at 8.192 MS/s
   from a looped seeded source, BASELINE config #3 (64 background USB dials
   on one PFB bank, raw audio in 6-block batches, pipeline depth 2),
   config #6 (256 interactive ADPCM listeners with four retunes a block and
   an edge drag to the full-rate bank and back every 8th block, depth 3)
   and the threaded loop (``start()``, config #6's listeners and a
   compressed waterfall, ``stop()``), each failing on any ERROR record of
   the runtime's logger.  Each path checks its outputs' shapes and dtypes,
   decodes its tones (≥ 15 dB SNR; the waterfall's in their bins) and logs
   ms/block, MS/s, its real-time multiple and peak memory; the shapes the
   paths hand the AGC, the ADPCM encoders and the squelch are recorded and
   must be the ones phase 3 checked;
6. kernel device times (CUDA events, launches queued ahead of the device)
   beside their bounds, the plain versions and, for the fold, one PyTorch
   call computing the same function; the fold and the IIR warm and cold;
   the AGC, the ADPCM encoder and the squelch at every path's shape, warm
   and cold (each launch on its own copy of the inputs, none of them in the
   L2 cache); the recurrences beside the time of their serial chain,
   measured as a per-step slope: the AGC on one row of 48 and of 96
   chunks, the ADPCM recurrence in lanes of 104 and of 200 nibbles (the
   shorter build, first checked against the plain recurrence and for the
   same main loop in its SASS), the row encoder on one row of 2064 and of
   4112 nibbles.

The last lines are a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
name/power-limit line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
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

SQUELCH_DB_TOL = 1e-3  # power_db: window sums in another order, re²+im² vs hypot²
WF_DB_TOL = 1e-2       # waterfall rows card vs CPU, bins within 60 dB of the peak
NEAR_PEAK_DB = 60.0
CHAIN_RTOL = 1e-3      # × max|y|: secondary chains card vs CPU (cuFFT, cuDNN sums)
DIBIT_AGREE = 0.98     # DV dibits card vs CPU: slicer thresholds may flip
CFG2_FS = 2.4e6        # BASELINE config #2: 2.4 MS/s, waterfall + SSB
CFG2_LISTENER = -262000.0   # fits PFB channel 57 (centre −262.5 kHz)
CFG2_EDGE = 618000.0        # 18 kHz off its channel centre: served full rate
CFG4_CHANNELS = 16     # BASELINE config #4: BPSK31 ×16 + USB ×16
CFG4_BATCH = 6         # blocks per delivery batch
WF_SIZE = 4096
# rows of 2048 and 4096 bins (+10 pad, to a multiple of 8): the row
# encoder's time per nibble is the slope between them
SEQ_ROW = 4112
SEQ_SHORT_ROW = 2064

# The shapes the full-width paths give the AGC (profile, x, chunk), the
# ADPCM encoders (samples) and the squelch (x, window), as phase 5 records
# them
AGC_PATH_CASES = {"usb": ("SLOW", (M, 600), 50), "nfm": ("FAST", (M, 2400), 50),
                  "am": ("SLOW", (2 * M, 600), 50), "cfg1": ("FAST", (4800,), 50),
                  "cfg2": ("SLOW", (64, 600), 50), "cfg2 edge": ("SLOW", (16, 600), 50),
                  "cfg4": ("SLOW", (16, 1536), 48), "cfg3": ("SLOW", (64, 2400), 50),
                  "cfg6": ("SLOW", (256, 2400), 50), "cfg6 edge": ("SLOW", (16, 2400), 50)}
ADPCM_PATH_SHAPES = {"usb": (M, 600), "nfm": (M, 600), "am": (2 * M, 600),
                     "wfm": (128, 9600), "cfg1": (1200,), "cfg2": (64, 600),
                     "cfg2 edge": (16, 600), "cfg6": (256, 2400), "cfg6 edge": (16, 2400)}
SQUELCH_PATH_CASES = {"usb": ((M, 600), 600), "nfm": ((M, 2400), 2400),
                      "am": ((2 * M, 600), 600), "wfm": ((128, 50000), 12500),
                      "cfg1": ((4800,), 2400), "cfg2": ((64, 600), 600),
                      "cfg2 edge": ((16, 600), 600), "cfg4": ((16, 1536), 768),
                      "cfg3": ((64, 2400), 800), "cfg6": ((256, 2400), 800),
                      "cfg6 edge": ((16, 2400), 800)}
# one waterfall row a block; two at 8.192 MS/s (the threaded run)
ADPCM_SEQ_PATH_SHAPES = {(1, SEQ_ROW), (2, SEQ_ROW)}
# the first-order IIR (x) on the paths that run one: the NFM and WFM
# de-emphasis, the AM DC blocker, config #1's de-emphasis
IIR_PATH_CASES = {"nfm": (M, 2400), "am": (2 * M, 600), "wfm": (128, 9600),
                  "cfg1": (4800,)}
# the row encoder's real rows: config #2's waterfall (29 averaged frames of
# a 2.4 MS/s block) and the 49.152 MS/s one (600 frames), as (rate, block,
# frames a second, carriers)
SEQ_REAL_ROWS = {"cfg2 row": (2.4e6, 120000, 20.0, (-262000.0, 618000.0)),
                 "wf row": (49.152e6, 2457600, 9.0,
                            tuple(float((i - 512) * 48000) for i in (100, 517, 900))),
                 "8.192 rows": (8.192e6, 1638400, 9.0, (-1758500.0, 2000500.0))}
# BASELINE configs #3 and #6 through the port's DeviceRuntime: 8.192 MS/s
# of uint8 wire IQ, 0.2 s device blocks, 256 PFB channels of 32 kHz
RT_FS = 8.192e6
RT_LOOP_BLOCKS = 2          # the source's loop: 0.4 s, every tone continuous
RT_NOISE, RT_TONE_AMP = 0.03, 0.05
CFG3_DIALS, CFG3_WARM, CFG3_TIMED = 64, 13, 24   # warm: two 6-block deliveries + 1
CFG6_LISTENERS, CFG6_WARM, CFG6_TIMED = 256, 6, 24
CFG6_TONES = (200, 201, 202, 203)     # listeners the churn never moves
RT_DEADLINE_S = 120.0       # the threaded run waits at most this long
RT_THREADED_ROWS, RT_THREADED_FRAMES = 20, 10   # ... for this many rows and frames


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


def iir_input(torch, gen, dev, shape):
    """Seeded first-order IIR input: x of ``shape`` and a random
    (x_prev, y_prev) state."""
    return ((torch.randn(shape[:-1], generator=gen, device=dev),
             torch.randn(shape[:-1], generator=gen, device=dev)),
            torch.randn(shape, generator=gen, device=dev) * 0.3)


def waterfall_row(torch, gen, dev, label):
    """The row encoder's input for one block's real waterfall rows, (rows,
    SEQ_ROW) int16: the float dB rows that ``FftChain`` makes on the card
    from the second of two seeded blocks of SEQ_REAL_ROWS[label], through
    ``fft_row_samples``."""
    from openwebrx_tpu_torch.models.receiver import FftChain
    from openwebrx_tpu_torch.ops import adpcm
    from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
    from openwebrx_tpu_torch.runtime.chain import Program
    fs, block, fps, carriers = SEQ_REAL_ROWS[label]
    prog = Program(FftChain(WF_SIZE, fps, compress=False),
                   StreamSpec(Format.COMPLEX_FLOAT, fs), block, device=dev)
    rows = [prog.process(b)[0] for b in
            seeded_blocks(torch, gen, dev, fs, block, 2, carriers, "usb", noise=0.05)]
    return adpcm.fft_row_samples(torch.from_numpy(rows[-1]).to(dev))


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


def bits(torch, t):
    """A tensor's bit pattern: NaN samples an open squelch passes on compare
    equal, and +0.0 differs from −0.0."""
    return (torch.view_as_real(t) if t.is_complex() else t).view(torch.int32)


def squelch_input(torch, gen, dev, shape, window, dtype=None):
    """Seeded squelch input: rows over 40 dB of level with per-row
    thresholds within ±6 dB of it, a random (open, hang) start state, and
    (with four rows or more) a silent row and a row half NaN."""
    dtype = dtype or torch.complex64
    rows, n = int(np.prod(shape[:-1])), shape[-1]
    scale = 10.0 ** (torch.rand(rows, 1, generator=gen, device=dev) * 4 - 4)
    x = torch.randn(rows, n, generator=gen, device=dev, dtype=dtype) * scale
    if rows >= 4:
        x[0] = 0
        x[1, : n // 2] = float("nan")
    level = (10 * torch.log10(scale[:, 0] ** 2)
             + torch.rand(rows, generator=gen, device=dev) * 12 - 6)
    lead = tuple(shape[:-1])
    state = ((torch.rand(rows, generator=gen, device=dev) > 0.5).reshape(lead),
             torch.randint(0, 3, (rows,), generator=gen, device=dev,
                           dtype=torch.int32).reshape(lead))
    return state, level.reshape(lead).contiguous(), x.reshape(shape).contiguous()


def squelch_bytes(shape, window, complex_=True):
    """x in, y out, power_db out, the level and (open, hang) in and out."""
    n = int(np.prod(shape))
    rows = n // shape[-1]
    return (n * (8 if complex_ else 4) * 2 + rows * (shape[-1] // window) * 4
            + rows * (4 + 2 * (1 + 4)))


def seq_bytes(rows, ns):
    """int16 samples and the start state in; bytes, stride states and the
    final state out."""
    return rows * (ns * 2 + ns // 2 + 4 * (ns // 200) + 4 * 4)


def near_peak_err(got, ref):
    """max |got − ref| (dB) over the bins within NEAR_PEAK_DB of each row's
    peak."""
    ref, got = np.atleast_2d(ref), np.atleast_2d(got)
    mask = ref >= ref.max(axis=-1, keepdims=True) - NEAR_PEAK_DB
    return float(np.abs(got - ref)[mask].max())


def decoded_row(raw, nbytes, adpcm):
    """One compressed waterfall row (its wire bytes) → dB."""
    dec, _ = adpcm.adpcm_decode_np(bytes(raw[:nbytes]))
    return dec[adpcm.COMPRESS_FFT_PAD_N:].astype(np.float64) / 100.0


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


class LoopSource:
    """A duck-typed source for the port's DeviceRuntime (``id``,
    ``get_sample_rate``, ``block_size``, ``start``, ``read_block``): seeded
    complex noise plus a USB tone TONE_AUDIO_HZ above each dial, made once
    on the host when the runtime has set ``block_size``, as uint8 wire
    pairs (bias 127.4, ±128 full scale), RT_LOOP_BLOCKS blocks looped;
    ``read_block`` hands out the next block at once."""

    def __init__(self, label, fs, dials, seed):
        self.id, self.fs, self.dials, self.seed = label, fs, list(dials), seed
        self.block_size = 0
        self._wire, self._pos = None, 0

    def get_sample_rate(self):
        return self.fs

    def start(self):
        if self._wire is not None:
            return
        n = RT_LOOP_BLOCKS * self.block_size
        rng = np.random.default_rng(self.seed)
        x = RT_NOISE * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        t = np.arange(n, dtype=np.float64)
        for dial in self.dials:
            f = dial + TONE_AUDIO_HZ
            check(abs(f * n / self.fs - round(f * n / self.fs)) < 1e-6,
                  f"tone at {f} Hz is not continuous over the source's loop")
            x += RT_TONE_AMP * np.exp(2j * np.pi * np.remainder(t * (f / self.fs), 1.0))
        packed = np.stack([x.real, x.imag], axis=-1)
        self._wire = np.clip(packed * 128.0 + 127.4, 0, 255).astype(np.uint8)

    def read_block(self, timeout=1.0):
        blk = self._wire[self._pos:self._pos + self.block_size]
        self._pos = (self._pos + self.block_size) % len(self._wire)
        return blk


class ErrorRecords:
    """A logging handler that keeps every ERROR record (the runtime's loop
    logs a failed block and carries on)."""

    def __init__(self):
        import logging
        self.records = []
        self.handler = logging.Handler(logging.ERROR)
        self.handler.emit = self.records.append

    def check(self, label):
        check(not self.records, f"{label}: the runtime logged errors: "
              + "; ".join(r.getMessage() + (f" ({r.exc_info[1]!r})" if r.exc_info else "")
                          for r in self.records))


def decode_wire(frames, adpcm):
    """SYNC-framed IMA ADPCM wire bytes (a listener's audio) → int16."""
    data = b"".join(frames)
    out, pos, state = [], 0, (0, 0)
    while pos < len(data):
        if data[pos:pos + 4] == b"SYNC":
            idx, pred = np.frombuffer(data[pos + 4:pos + 8], "<i2")
            state = (int(pred), int(idx))
            pos += 8
        chunk = data[pos:pos + adpcm.SYNC_INTERVAL]
        pos += len(chunk)
        pcm, state = adpcm.adpcm_decode_np(chunk, state)
        out.append(pcm)
    return np.concatenate(out) if out else np.zeros(0, np.int16)


def pfb_dial(k, fs, m):
    """Channel k's centre (negative above fs/2) + 500 Hz, as bench.py
    places configs #3 and #6."""
    freq = k * fs / m
    return (freq - fs if freq >= fs / 2 else freq) + 500.0


def launches_per_block(fold=0, adpcm_=0, iir_=0, agc_=0, squelch_=0, seq=0):
    return {"fold.cu": fold, "adpcm.cu": adpcm_, "iir.cu": iir_, "agc.cu": agc_,
            "squelch.cu": squelch_, "adpcm_seq.cu": seq}


def secondary_bank_check(torch, dev):
    """Phase 4: the runtime's SecondaryBank on the card (two BPSK31 slots
    fed device chunks of another size than its block, the FFT rows of one
    encoded on the card) against the same bank on the CPU fed the same
    samples; the card takes the CPU bank's state after the first bank
    block.  The host text decoder is a stub: only the device side is
    compared (symbols, and the wire rows' count, length and peak bin)."""
    import types
    from openwebrx_tpu_torch.ops import adpcm
    from openwebrx_tpu_torch.runtime import device as rtdev
    from openwebrx_tpu_torch.runtime.chain import tree_map
    stub = types.SimpleNamespace(
        VaricodeDecoder=lambda: types.SimpleNamespace(decode=lambda bits: ""),
        dbpsk_bits=lambda symbols: symbols)
    fs, offsets = 48000.0, (1200.0, -2500.0)
    banks, got = {}, {}
    for where in ("cpu", dev):
        ns = types.SimpleNamespace(in_rate=fs, device=where, host=stub)
        banks[where] = rtdev.SecondaryBank(ns, "bpsk31", capacity=2)
        got[where] = {"y": [], "rows": []}
        for off in offsets:
            h = rtdev.SecondaryHandle(ns, "bpsk31", off, banks[where])
            h.fft_cb = got[where]["rows"].append if off > 0 else None

            def deliver(y, payloads, h=h, out=got[where]):
                if h.fft_cb is not None:
                    out["y"].append(y)
                rtdev.SecondaryHandle._deliver(h, y, payloads)
            h._deliver = deliver
    block = banks["cpu"].block
    rng = np.random.default_rng(31)
    n = np.arange(4 * block)
    sym = np.repeat(np.cumprod(np.where(rng.integers(0, 2, len(n) // 1536 + 1), 1, -1)),
                    1536)[: len(n)]
    x = sum(0.4 * sym * np.exp(2j * np.pi * o / fs * n) for o in offsets)
    x = (x + 0.02 * (rng.standard_normal(len(n)) + 1j * rng.standard_normal(len(n)))
         ).astype(np.complex64)
    xd = torch.from_numpy(x).to(dev)
    for where in ("cpu", dev):
        banks[where].feed(x[:block] if where == "cpu" else xd[:block])
    banks[dev].program.state = tree_map(lambda t: t.to(dev), banks["cpu"].program.state)
    step = block // 3 + 7
    for a in range(block, len(x), step):
        banks["cpu"].feed(x[a:a + step])
        banks[dev].feed(xd[a:a + step])
    yc, yd = got["cpu"]["y"], got[dev]["y"]
    check(len(yd) == len(yc) == 4, f"SecondaryBank: {len(yd)} card and {len(yc)} CPU blocks")
    err = max(float(np.abs(d - c).max() / np.abs(c).max()) for d, c in zip(yd[1:], yc[1:]))
    rc, rd = got["cpu"]["rows"], got[dev]["rows"]
    nb = adpcm.wire_bytes_per_row(2048)
    peaks = [(int(np.argmax(decoded_row(a, nb, adpcm))), int(np.argmax(decoded_row(b, nb, adpcm))))
             for a, b in zip(rd, rc)]
    log(f"[check] SecondaryBank bpsk31 (2 slots, device chunks of {step}) on the card vs "
        f"the CPU: symbols max diff {err:.2e} of max|y| from bank block 1 (tolerance "
        f"{CHAIN_RTOL}); {len(rd)} FFT rows encoded on the card, {len(rc)} on the CPU, "
        f"peak bins {peaks}")
    check(err <= CHAIN_RTOL and len(rd) == len(rc) > 0
          and all(len(r) == nb for r in rd + rc)
          and all(abs(a - b) <= 1 for a, b in peaks),
          "SecondaryBank on the card disagrees with the CPU")


def runtime_paths(torch, dev, smi, paths, launches_by_path):
    """BASELINE configs #3 and #6 and the threaded loop through the port's
    DeviceRuntime (phase 5): adds each path's report to ``paths`` and its
    kernel launches to ``launches_by_path``."""
    from openwebrx_tpu_torch import kernels
    from openwebrx_tpu_torch.ops import adpcm

    # uint8 wire blocks at 8.192 MS/s (0.2 s blocks); the runtime's logger
    # is watched for ERROR records
    from collections import deque
    from openwebrx_tpu_torch.runtime import device as rtdev
    errors = ErrorRecords()
    logging.getLogger(rtdev.__name__).addHandler(errors.handler)

    def runtime_drive(label, rt, src, n_warm, n_timed, before_block=None):
        """Warm-up blocks, then every count set to 0 and ``n_timed`` blocks
        through the runtime's own pipeline (dispatch, complete the oldest
        once ``pipeline_depth`` are in flight), ``before_block(i)`` ahead
        of each.  The host clock splits the timed blocks into the churn,
        dispatch (upload, parameters, launches), the wait for a block's
        copies and delivery (numpy, framing, callbacks); → (wall s,
        launches, peak MiB, host ms a block by part)."""
        pending = deque()
        src.start()
        for _ in range(n_warm):
            rt._pump(src.read_block(), pending)
        while pending:
            rt._complete_block(pending.popleft())
        spent = {"churn": 0.0, "dispatch": 0.0, "wait": 0.0, "deliver": 0.0}
        dispatch, complete = rt._dispatch_block, rt._complete_block

        def timed_dispatch(block):
            t0 = time.perf_counter()
            out = dispatch(block)
            spent["dispatch"] += time.perf_counter() - t0
            return out

        def timed_complete(pend):
            t0 = time.perf_counter()
            for p in [*pend["fft_pending"], *(q for ps in pend["bank_pending"].values()
                                                for q in ps)][:1]:
                if p.event is not None:      # one event for all of them
                    p.event.synchronize()
            t1 = time.perf_counter()
            complete(pend)
            spent["wait"] += t1 - t0
            spent["deliver"] += time.perf_counter() - t1

        rt._dispatch_block, rt._complete_block = timed_dispatch, timed_complete
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels.ALL:
            k.launches = 0
        t_start = time.perf_counter()
        for i in range(n_timed):
            if before_block is not None:
                t0 = time.perf_counter()
                before_block(i)
                spent["churn"] += time.perf_counter() - t0
            rt._pump(src.read_block(), pending)
        while pending:
            rt._complete_block(pending.popleft())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        del rt._dispatch_block, rt._complete_block
        launches = {k.source.name: k.launches for k in kernels.ALL}
        parts = {k: v / n_timed * 1e3 for k, v in spent.items()}
        log(f"[{label}] launches: {launches} ({n_timed} blocks, pipeline depth "
            f"{rt.pipeline_depth}); per block: " + ", ".join(
                f"{k} {v / n_timed:g}" for k, v in launches.items()))
        log(f"[{label}] {smi}: host ms a block: " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()))
        errors.check(label)
        return wall, launches, torch.cuda.max_memory_allocated(dev) / 2 ** 20, parts

    def service_snr(chunks):
        pcm = np.frombuffer(b"".join(chunks), np.int16)
        return tone_snr(pcm[len(pcm) // 2:].astype(np.float32) / 32767,
                        TONE_AUDIO_HZ, 12000.0)

    # config #3 (bench.py:347-402): 64 background USB dials on distinct
    # PFB channels, raw audio delivered in 6-block batches, depth 2
    m3 = 256
    dials3 = [pfb_dial((i * (m3 // 72) + 2) % m3, RT_FS, m3) for i in range(CFG3_DIALS)]
    tone3 = (0, 21, 42, 63)
    src3 = LoopSource("cfg3", RT_FS, [dials3[i] for i in tone3], seed=3)
    rt3 = rtdev.DeviceRuntime(src3, target_seconds=0.1, service_delivery_seconds=0.6,
                              pipeline_depth=2, device=dev)
    check(rt3._pfb_channels() == m3 and rt3.block == 1638400,
          f"config #3 plan: {rt3._pfb_channels()} channels, block {rt3.block}")
    audio3 = {i: [] for i in range(CFG3_DIALS)}
    for i, dial in enumerate(dials3):
        h = rt3.open_channel("usb", dial, service=True)
        h.audio_cb = lambda wire, hd=False, i=i: audio3[i].append(wire)
    bank3 = rt3.banks["pfb:ssb"]
    check({h.bucket_key for h in rt3.handles} == {"pfb:ssb"} and bank3.n_active == 64
          and bank3.delivery_stride == 6 and bank3.chunk_ratio == 1,
          f"config #3: dials in {sorted({h.bucket_key for h in rt3.handles})}, "
          f"stride {bank3.delivery_stride}")
    wall, launches, peak, parts = runtime_drive("cfg3", rt3, src3, CFG3_WARM, CFG3_TIMED)
    launches_by_path["cfg3"] = launches
    check_launches("cfg3", launches, {k: v * CFG3_TIMED for k, v in launches_per_block(
        fold=1, agc_=1, squelch_=1).items()})
    check(all(audio3.values()), "cfg3: audio missing on some dials")
    for i in tone3:
        snr = service_snr(audio3[i])
        log(f"[cfg3] dial {i} ({dials3[i]:.0f} Hz): USB tone SNR {snr:.1f} dB "
            f"(minimum {TONE_SNR_MIN_DB})")
        check(snr > TONE_SNR_MIN_DB, f"cfg3: dial {i} tone SNR {snr:.1f} dB")
    quiet = service_snr(audio3[10])
    log(f"[cfg3] all {CFG3_DIALS} dials in pfb:ssb, audio on all; a quiet dial's "
        f"1 kHz SNR {quiet:.1f} dB")
    check(quiet < TONE_SNR_MIN_DB, f"cfg3: a tone leaks into dial 10 ({quiet:.1f} dB)")
    paths["cfg3"] = dict(report("cfg3", smi, wall, CFG3_TIMED, rt3.block, RT_FS, peak),
                         host_ms=parts)
    del rt3, src3, bank3

    # config #6 (bench.py:498-583): 256 interactive listeners (ADPCM), four
    # retunes a block, every 8th block one listener dragged across a
    # channel edge (served full rate for a block) and back; depth 3
    def cfg6_runtime(label, seed):
        src = LoopSource(label, RT_FS, [], seed=seed)
        rt = rtdev.DeviceRuntime(src, target_seconds=0.1, capacity=16, pfb_capacity=256,
                                 pipeline_depth=3, device=dev)
        m = rt._pfb_m_for("ssb")
        dials = [pfb_dial((i * (m // 256) + i // 128) % m, RT_FS, m)
                 for i in range(CFG6_LISTENERS)]
        src.dials = [dials[i] for i in CFG6_TONES]
        frames = {i: [] for i in range(CFG6_LISTENERS)}
        handles = []
        for i, dial in enumerate(dials):
            h = rt.open_channel("usb", dial)
            h.audio_cb = lambda wire, hd=False, i=i: frames[i].append(wire)
            handles.append(h)
        check(m == 256 and {h.bucket_key for h in handles} == {"pfbi:ssb"},
              f"{label}: {m} channels, listeners in {sorted({h.bucket_key for h in handles})}")
        return rt, src, handles, frames

    rt6, src6, handles6, frames6 = cfg6_runtime("cfg6", seed=6)
    centers = np.fft.fftfreq(256, 1 / RT_FS)
    edge = RT_FS / 256 * 1.5 - 200.0           # straddles a channel edge

    def fitting_dial(j):
        return float(centers[(j * 7 + 3) % 256] + 600.0)

    handles6[0].set_offset(edge)               # the full-rate bank, built once
    check(handles6[0].bucket_key == "ssb", "cfg6: the edge dial is not served full rate")
    handles6[0].set_offset(fitting_dial(0))
    check(handles6[0].bucket_key == "pfbi:ssb", "cfg6: the edge dial did not come back")
    churn = {"retunes": 0, "migrations": 0, "full_rate_blocks": 0, "dragged": None}

    def cfg6_churn(i):
        if churn["dragged"] is not None:       # back from the edge
            h = churn["dragged"]
            h.set_offset(fitting_dial(i))
            check(h.bucket_key == "pfbi:ssb", f"cfg6: block {i}: the dragged dial "
                  f"is in {h.bucket_key}, not back in pfbi:ssb")
            churn["dragged"] = None
        for j in range(4):
            h = handles6[(i * 4 + j) % len(handles6)]
            h.set_offset(fitting_dial(i * 4 + j))
            churn["retunes"] += 1
        if i % 8 == 4:
            h = handles6[(i * 13) % len(handles6)]
            h.set_offset(edge)
            check(h.bucket_key == "ssb", f"cfg6: block {i}: the edge dial is in "
                  f"{h.bucket_key}, not served full rate")
            churn["dragged"] = h
            churn["migrations"] += 1
        churn["full_rate_blocks"] += int(rt6.banks["ssb"].n_active > 0)

    check(not any((i * 4 + j) % CFG6_LISTENERS in CFG6_TONES or (i * 13) % CFG6_LISTENERS
                  in CFG6_TONES for i in range(CFG6_TIMED) for j in range(4)),
          "cfg6: the churn would move a tone listener")
    wall, launches, peak, parts = runtime_drive("cfg6", rt6, src6, CFG6_WARM,
                                                CFG6_TIMED, cfg6_churn)
    launches_by_path["cfg6"] = launches
    full = churn["full_rate_blocks"]
    check(full == CFG6_TIMED // 8, f"cfg6: {full} blocks with a full-rate dial")
    check_launches("cfg6", launches, {
        "fold.cu": CFG6_TIMED, "adpcm.cu": CFG6_TIMED + full, "iir.cu": 0,
        "agc.cu": CFG6_TIMED + full, "squelch.cu": CFG6_TIMED + full, "adpcm_seq.cu": 0})
    heard = sum(1 for f in frames6.values() if f)
    check(heard >= 250, f"cfg6: audio on {heard} of {CFG6_LISTENERS} listeners")
    for i in CFG6_TONES:
        pcm = decode_wire(frames6[i], adpcm)
        snr = tone_snr(pcm[len(pcm) // 2:].astype(np.float32) / 32767, TONE_AUDIO_HZ,
                       12000.0)
        log(f"[cfg6] listener {i}: ADPCM wire decoded, {len(pcm)} samples, USB tone "
            f"SNR {snr:.1f} dB (minimum {TONE_SNR_MIN_DB})")
        check(snr > TONE_SNR_MIN_DB, f"cfg6: listener {i} tone SNR {snr:.1f} dB")
    log(f"[cfg6] {heard} of {CFG6_LISTENERS} listeners heard; {churn['retunes']} "
        f"retunes, {churn['migrations']} edge drags (pfbi:ssb -> ssb -> pfbi:ssb), "
        f"{full} blocks with the full-rate bank")
    paths["cfg6"] = dict(report("cfg6", smi, wall, CFG6_TIMED, rt6.block, RT_FS, peak),
                         retunes=churn["retunes"], edge_drags=churn["migrations"],
                         host_ms=parts)
    del rt6, src6, handles6, frames6

    # the threaded run: config #6's listeners and a waterfall subscriber
    # through start() and the loop thread, until audio and compressed rows
    # arrived, then stop()
    rtt, srct, handlest, framest = cfg6_runtime("threaded", seed=7)
    rows_t = []
    rtt.subscribe_waterfall(rows_t.append)
    nb_row = rtt.fft_chain.waterfall.wire_bytes_per_row
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.ALL:
        k.launches = 0
    t_start = time.perf_counter()
    rtt.start()
    t_loop = time.perf_counter()
    deadline = t_loop + RT_DEADLINE_S
    try:
        while time.perf_counter() < deadline and not (
                len(rows_t) >= RT_THREADED_ROWS
                and all(len(framest[i]) >= RT_THREADED_FRAMES for i in CFG6_TONES)):
            time.sleep(0.05)
    finally:
        rtt.stop()
    wall = time.perf_counter() - t_loop
    torch.cuda.synchronize()
    check(rtt._thread is None and not rtt._running, "threaded: the loop did not stop")
    launches = {k.source.name: k.launches for k in kernels.ALL}
    blocks_t = rtt.gauges["blocks"]
    built_first = (rtt.kernels_built_at is not None and rtt.first_block_at is not None
                   and rtt.kernels_built_at <= rtt.first_block_at)
    log(f"[threaded] launches: {launches} ({blocks_t} blocks); kernels.ALL built by "
        f"start() before the first block: {built_first} (start took "
        f"{(t_loop - t_start) * 1e3:.1f} ms); gauges {rtt.gauges}")
    errors.check("threaded")
    launches_by_path["threaded"] = launches
    check(built_first, "threaded: kernels.ALL was not built before the first block")
    check(blocks_t > 0 and len(rows_t) >= RT_THREADED_ROWS
          and all(len(framest[i]) >= RT_THREADED_FRAMES for i in CFG6_TONES),
          f"threaded: {blocks_t} blocks, {len(rows_t)} rows, audio frames "
          f"{[len(framest[i]) for i in CFG6_TONES]} before the deadline")
    check_launches("threaded", launches, {k: v * blocks_t for k, v in launches_per_block(
        fold=1, adpcm_=1, agc_=1, squelch_=1, seq=1).items()})
    check(all(len(r) == nb_row for r in rows_t) and len(rows_t) == 2 * blocks_t,
          f"threaded: waterfall rows of {sorted({len(r) for r in rows_t})} bytes "
          f"({len(rows_t)} for {blocks_t} blocks), expected {nb_row}")
    row = decoded_row(rows_t[-1], nb_row, adpcm)
    for f in srct.dials:
        f_t = f + TONE_AUDIO_HZ
        k = WF_SIZE // 2 + int(round(f_t / RT_FS * WF_SIZE))
        peak_bin = k - 4 + int(np.argmax(row[k - 4:k + 5]))
        rise = row[peak_bin] - np.median(row)
        log(f"[threaded] waterfall: tone at {f_t:.0f} Hz peaks in bin {peak_bin} "
            f"(expected {k} ± 1), {rise:.1f} dB above the median after decoding")
        check(abs(peak_bin - k) <= 1 and rise > 3.0,
              f"threaded: waterfall tone at {f_t} peaks in bin {peak_bin}, expected {k}")
    for i in CFG6_TONES:
        pcm = decode_wire(framest[i], adpcm)
        snr = tone_snr(pcm[len(pcm) // 2:].astype(np.float32) / 32767, TONE_AUDIO_HZ,
                       12000.0)
        check(snr > TONE_SNR_MIN_DB, f"threaded: listener {i} tone SNR {snr:.1f} dB")
    paths["threaded"] = dict(
        report("threaded", smi, wall, blocks_t, rtt.block, RT_FS,
               torch.cuda.max_memory_allocated(dev) / 2 ** 20),
        gauges=dict(rtt.gauges), kernels_built_before_first_block=built_first)
    logging.getLogger(rtdev.__name__).removeHandler(errors.handler)
    del rtt, srct, handlest, framest
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from openwebrx_tpu_torch import kernels
    from openwebrx_tpu_torch.models.digital_voice import DV_FACTORY
    from openwebrx_tpu_torch.models.receiver import (
        MODE_BANDPASS, ClientDemodulatorChain, FftChain, build_program)
    from openwebrx_tpu_torch.models.secondary import SECONDARY_FACTORY, PskChain
    from openwebrx_tpu_torch.models.stages import block_requirement, plan_block_size
    from openwebrx_tpu_torch.ops import adpcm, agc, channelizer, iir, squelch
    from openwebrx_tpu_torch.ops.fold import polyphase_fold, polyphase_fold_plain
    from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
    from openwebrx_tpu_torch.runtime.bank import ChannelBank
    from openwebrx_tpu_torch.runtime.chain import Fanout, Program, tree_map
    from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    device_kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi} | torch: {device_kind} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    # adpcm_short: the ADPCM kernel with shorter strides, timed in phase 6
    adpcm_short = kernels.CudaKernel("adpcm.cu", kernels.ADPCM.symbol,
                                     kernels.ADPCM.argtypes,
                                     defines=(f"ADPCM_STRIDE={SHORT_STRIDE}",))
    # seq_serial: the row encoder with one segment (one lane walks the row),
    # whose slope phase 6 times as the serial nibble step
    seq_serial = kernels.CudaKernel("adpcm_seq.cu", kernels.ADPCM_SEQ.symbol,
                                    kernels.ADPCM_SEQ.argtypes,
                                    defines=("ADPCM_SEQ_SEGMENTS=1", "ADPCM_SEQ_SPAN=1"))
    builds = (*kernels.ALL, adpcm_short, seq_serial)
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

    # the first-order IIR at every path's shape, each with the DC blocker's
    # coefficient (a1 near 1) and the de-emphasis' (a path uses one of
    # them), from random start states: y and y_last within IIR_RTOL of the
    # output scale, x_last identical
    iir_coeffs = {"dc block": iir.dc_block_coeffs(12000.0),
                  "de-emphasis": iir.deemphasis_coeffs(48000.0, 150e-6)}
    iir_in = {}                    # label: (state, x, coefficients) timed in phase 6
    iir_err = 0.0
    for label, shape in IIR_PATH_CASES.items():
        st, x = iir_input(torch, gen, dev, shape)
        for co_name, co in iir_coeffs.items():
            (ix_k, iy_k), y_k = iir.first_order_apply(st, *co, x, device=dev)
            (ix_p, iy_p), y_p = iir.first_order_apply_plain(st, *co, x)
            torch.cuda.synchronize()
            err = max(float((y_k - y_p).abs().max()), float((iy_k - iy_p).abs().max()))
            tol = IIR_RTOL * float(y_p.abs().max())
            iir_err = max(iir_err, err)
            log(f"[check] iir {label} x{tuple(x.shape)} {co_name} (a1 {co[2]:.6f}): "
                f"max_abs_err {err:.3e} (tolerance {tol:.3e}); x state identical = "
                f"{torch.equal(ix_k, ix_p)}")
            check(err <= tol and torch.equal(ix_k, ix_p),
                  f"IIR kernel disagrees ({label}, {co_name}): {err} > {tol}")
        iir_in[label] = (st, x, iir_coeffs["dc block" if label == "am" else "de-emphasis"])

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

    # the fold at config #2's listener bank: M = 64, 1875-sample channel block
    proto64 = torch.as_tensor(channelizer.design_prototype(64, p_taps), device=dev)
    bank64 = torch.flip(proto64.reshape(p_taps, 64), dims=(0, 1)).contiguous()
    u64 = torch.complex(torch.randn(1875 + p_taps - 1, 64, generator=gen, device=dev),
                        torch.randn(1875 + p_taps - 1, 64, generator=gen, device=dev))
    v64 = polyphase_fold(u64, bank64, p_taps, device=dev)
    v64_plain = polyphase_fold_plain(u64, bank64, p_taps)
    torch.cuda.synchronize()
    err64 = float((v64 - v64_plain).abs().max())
    tol64 = FOLD_RTOL * float(v64_plain.abs().max())
    log(f"[check] fold u{tuple(u64.shape)} (config #2, M=64): max_abs_err "
        f"{err64:.3e} (tolerance {tol64:.3e})")
    check(tuple(v64.shape) == (1875, 64) and err64 <= tol64,
          f"fold kernel disagrees at M=64: {err64} > {tol64}")
    fold_err = max(fold_err, err64)
    # and at configs #3 and #6: M = 256 at 8.192 MS/s, 6400-sample channel block
    proto256 = torch.as_tensor(channelizer.design_prototype(256, p_taps), device=dev)
    bank256 = torch.flip(proto256.reshape(p_taps, 256), dims=(0, 1)).contiguous()
    u256 = torch.complex(torch.randn(6400 + p_taps - 1, 256, generator=gen, device=dev),
                         torch.randn(6400 + p_taps - 1, 256, generator=gen, device=dev))
    v256 = polyphase_fold(u256, bank256, p_taps, device=dev)
    v256_plain = polyphase_fold_plain(u256, bank256, p_taps)
    torch.cuda.synchronize()
    err256 = float((v256 - v256_plain).abs().max())
    tol256 = FOLD_RTOL * float(v256_plain.abs().max())
    log(f"[check] fold u{tuple(u256.shape)} (configs #3 and #6, M=256): "
        f"max_abs_err {err256:.3e} (tolerance {tol256:.3e})")
    check(tuple(v256.shape) == (6400, 256) and err256 <= tol256,
          f"fold kernel disagrees at M=256: {err256} > {tol256}")
    fold_err = max(fold_err, err256)

    # squelch at every path's shape (rows over 40 dB, thresholds near them,
    # random start states, a silent and a half-NaN row), on real input, on
    # a row walked in tiles of many windows, and a burst scene from the
    # initial state: power_db within SQUELCH_DB_TOL, NaN where the plain
    # version has NaN; gates, hang and output bit-identical on the rows
    # whose every window lies farther than that from its level
    squelch_in = {}                  # label: (state, level, x, window)
    squelch_err = 0.0

    def squelch_case(label, st, level, x, window, expect=None):
        nonlocal squelch_err
        sk, yk, pk = squelch.squelch_apply(st, level, x, window)
        sp, yp, pp = squelch.squelch_apply_plain(st, level, x, window)
        torch.cuda.synchronize()
        nan_same = torch.equal(pk.isnan(), pp.isnan())
        fin = ~pp.isnan()
        err = float((pk[fin] - pp[fin]).abs().max()) if bool(fin.any()) else 0.0
        squelch_err = max(squelch_err, err)
        lvl = level.expand(pp.shape[:-1])[..., None]
        clear = (((pp - lvl).abs() > SQUELCH_DB_TOL) | pp.isnan()).all(dim=-1)
        same = (torch.equal(bits(torch, yk)[clear], bits(torch, yp)[clear])
                and torch.equal(sk[0][clear], sp[0][clear])
                and torch.equal(sk[1][clear], sp[1][clear]))
        share = float(clear.float().mean())
        log(f"[check] squelch {label} x{tuple(x.shape)} {str(x.dtype)[6:]} window "
            f"{window}: power_db max_abs_err {err:.3e} dB (tolerance "
            f"{SQUELCH_DB_TOL}), NaN where the plain has NaN = {nan_same}; "
            f"{share:.3f} of rows clear of the level, identical there = {same}")
        check(nan_same and err <= SQUELCH_DB_TOL and same and share >= 0.9,
              f"squelch kernel disagrees ({label})")
        if expect is not None:
            check(sk[0].tolist() == expect[0] and sk[1].tolist() == expect[1],
                  f"squelch scene: {sk[0].tolist()} {sk[1].tolist()}")

    for label, (shape, window) in SQUELCH_PATH_CASES.items():
        squelch_in[label] = (*squelch_input(torch, gen, dev, shape, window), window)
        squelch_case(label, *squelch_in[label])
    squelch_case("real", *squelch_input(torch, gen, dev, (5, 4801), 4801,
                                        torch.float32), 4801)
    squelch_case("tiled", *squelch_input(torch, gen, dev, (3, 40000), 400), 400)
    # the scene: 4 windows from the initial state, one threshold for all
    # rows; silence and NaN never open, a burst in window 1 holds the gate
    # two windows and runs out, one in window 2 is still held at the end
    scene = torch.zeros(8, 2400, dtype=torch.complex64, device=dev)
    scene[2:4] = float("nan")
    scene[4:6, 600:1200] = 1.0
    scene[6:8, 1200:1800] = 1.0
    squelch_case("scene", squelch.squelch_init((8,), device=dev),
                 torch.tensor(-20.0, device=dev), scene, 600,
                 expect=([False] * 6 + [True] * 2, [0] * 6 + [1] * 2))

    # the exact IMA row encoder: real waterfall rows (config #2's and the
    # 49.152 MS/s one, made by FftChain on the card), a random dB row, audio,
    # 16 rows from random states, full-scale square waves, rows with a tail
    # and short rows; each also with the adversarial test inputs (forced 1:
    # every guess at (-32768, 88); forced 2: no guessed run taken, the sweep
    # encodes the row itself); bytes, stride states and final state identical
    seq_err = 0
    seq_plain = {}

    def seq_case(label, st, x, forced=0):
        nonlocal seq_err
        diag = torch.zeros(x.shape[0], adpcm.SEQ_DIAG_WORDS, dtype=torch.int32,
                           device=dev)
        ks, (kb, kst) = adpcm.encode_seq_kernel(st, x, forced=forced, diag=diag)
        if label not in seq_plain:
            seq_plain[label] = adpcm.adpcm_encode_seq_plain(st, x)
        ps, (pb, pst) = seq_plain[label]
        torch.cuda.synchronize()
        n_bytes = int((kb != pb).sum())
        seq_err = max(seq_err, int((kb.to(torch.int32) - pb.to(torch.int32)).abs().max()))
        same = (n_bytes == 0 and torch.equal(kst, pst)
                and all(torch.equal(a, b) for a, b in zip(ks, ps)))
        d = diag.max(dim=0).values.tolist()
        log(f"[check] adpcm_encode_seq {label} {tuple(x.shape)} forced {forced}: "
            f"bytes, stride states {tuple(kst.shape)} and final state identical = "
            f"{same} ({n_bytes} bytes differ); most in a row: {d[0]} run ends "
            f"looked up, {d[1]} nibbles encoded by the sweep, first-pass run "
            f"{d[2]} nibbles")
        check(same, f"adpcm_encode_seq kernel differs ({label}, forced {forced})")
        return {"run_ends": d[0], "sweep_nibbles": d[1], "first_pass_nibbles": d[2],
                "cycles_total_setup_pass1_sweep_output": d[3:]}

    def random_seq_state(rows):
        return (torch.randint(-32768, 32767, (rows,), generator=gen, device=dev,
                              dtype=torch.int32),
                torch.randint(0, 89, (rows,), generator=gen, device=dev,
                              dtype=torch.int32))

    seq_in = {}
    for label in SEQ_REAL_ROWS:
        x = waterfall_row(torch, gen, dev, label)
        seq_in[label] = (adpcm.adpcm_init(tuple(x.shape[:-1]), device=dev), x)
    wf_rows_db = (torch.randn(1, WF_SIZE, generator=gen, device=dev) * 8 - 80)
    wf_rows_db[0, 1000:1004] = -10.0
    wf_samples = adpcm.fft_row_samples(wf_rows_db)
    check(all(tuple(x.shape) == (1, SEQ_ROW) for x in
              (wf_samples, seq_in["cfg2 row"][1], seq_in["wf row"][1]))
          and tuple(seq_in["8.192 rows"][1].shape) == (2, SEQ_ROW),
          f"waterfall rows {wf_samples.shape}")
    seq_in["random dB row"] = (adpcm.adpcm_init((1,), device=dev), wf_samples)
    seq_in["audio"] = (random_seq_state(1), int16_audio(torch, gen, dev, 1, SEQ_ROW))
    seq_in["16 rows"] = (random_seq_state(16), int16_audio(torch, gen, dev, 16, SEQ_ROW))
    t = torch.arange(SEQ_ROW, device=dev)
    square = torch.stack([torch.where((t // per) % 2 == 0, 32767, -32768)
                          for per in (1, 2, 7, 64)]).to(torch.int16)
    seq_in["square"] = (random_seq_state(4), square)
    seq_in["short row"] = (random_seq_state(1), int16_audio(torch, gen, dev, 1, SEQ_SHORT_ROW))
    seq_in["tail"] = (random_seq_state(3), int16_audio(torch, gen, dev, 3, 2058))
    seq_in["400 x 40"] = (random_seq_state(40), int16_audio(torch, gen, dev, 40, 400))
    seq_in["6"] = (random_seq_state(2), int16_audio(torch, gen, dev, 2, 6))
    seq_diag = {}
    for forced in (0, 1, 2):
        for label, (st, x) in seq_in.items():
            seq_diag[(label, forced)] = seq_case(label, st, x, forced)
    rows_host = wf_rows_db.cpu().numpy()
    card_wire = adpcm.compress_fft_rows(wf_rows_db, device=dev)
    check(card_wire == adpcm.compress_fft_rows(rows_host, device="cpu")
          and len(card_wire[0]) == adpcm.wire_bytes_per_row(WF_SIZE),
          "compress_fft_rows on the card differs from the CPU")
    log("[check] compress_fft_rows (1, 4096) card vs CPU: wire bytes identical")

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

    # the waterfall at config #2's shapes (2.4 MS/s, 0.05 s blocks, 4096
    # bins): float rows card vs CPU near the peak; the card's compressed
    # rows are the CPU encoding of the card's own float rows (identical
    # int16 input is the only fair bit-for-bit comparison)
    spec24 = StreamSpec(Format.COMPLEX_FLOAT, CFG2_FS)
    wf_blocks = seeded_blocks(torch, gen, dev, CFG2_FS, 120000, 2,
                              [CFG2_LISTENER, CFG2_EDGE], "usb", noise=0.05)
    wf_progs = {(where, comp): Program(FftChain(WF_SIZE, 20.0, compress=comp),
                                       spec24, 120000, device=where)
                for where in ("cpu", dev) for comp in (False, True)}
    wf_err = 0.0
    for x in wf_blocks:
        out = {k: p.process(x if k[0] == dev else x.cpu())[0]
               for k, p in wf_progs.items()}
        wf_err = max(wf_err, near_peak_err(out[(dev, False)], out[("cpu", False)]))
        raw = out[(dev, True)]
        nb = adpcm.wire_bytes_per_row(WF_SIZE)
        check(raw.shape == (1, SEQ_ROW // 2) and raw.dtype == np.uint8,
              f"compressed waterfall rows {raw.shape} {raw.dtype}")
        check([raw[0, :nb].tobytes()]
              == adpcm.compress_fft_rows(out[(dev, False)], device="cpu"),
              "compressed waterfall rows are not the encoding of the float rows")
    log(f"[check] FftChain(4096, 20) at 2.4 MS/s, 2 blocks: float rows card vs "
        f"CPU max diff {wf_err:.2e} dB within {NEAR_PEAK_DB:.0f} dB of the peak "
        f"(tolerance {WF_DB_TOL}); compressed rows = the encoding of the "
        f"card's float rows")
    check(wf_err <= WF_DB_TOL, "waterfall rows card vs CPU disagree")

    # every secondary and digital-voice chain, two channels, the card
    # against the CPU on the same blocks: an FM-wobbled carrier in each
    # channel's passband plus noise.  The card takes the CPU's state after
    # block 0 (FM discriminators see the filters' start-up ramp there,
    # whose rounding differs), block 1 is compared
    centre = {"fax": 1900.0, "sstv": 1900.0, "cwskimmer": 2000.0}
    wobble = {"fax": 300.0, "sstv": 300.0, "rtty450": 150.0}
    chain_cases = ([(k, 48000.0, f) for k, f in SECONDARY_FACTORY.items()]
                   + [(k, 240000.0, f) for k, f in DV_FACTORY.items()])
    chain_err = {}
    for name, cfs, make in chain_cases:
        offsets = np.array([-3000.0, 5000.0])
        progs = {}
        for where in ("cpu", dev):
            c = make(cfs)
            c.selector.shift.set_rate(-offsets / cfs)
            cspec = StreamSpec(Format.COMPLEX_FLOAT, cfs)
            progs[where] = Program(c, cspec, plan_block_size(c, cspec, 0.1),
                                   batch_shape=(2,), device=where)
        blk = progs["cpu"].block
        n = np.arange(2 * blk) / cfs
        dev_hz = wobble.get(name, 1500.0 if cfs > 48000.0 else 10.0)
        rng = np.random.default_rng(len(name))
        sig = sum(0.4 * np.exp(2j * np.pi * (o + centre.get(name, 0.0)) * n
                               + 1j * (dev_hz / 7.0) * np.sin(2 * np.pi * 7.0 * n))
                  for o in offsets)
        sig = (sig + 0.02 * (rng.standard_normal(len(n))
                             + 1j * rng.standard_normal(len(n)))).astype(np.complex64)
        for b in range(2):
            if b == 1:
                progs[dev].state = tree_map(lambda t: t.to(dev), progs["cpu"].state)
            x = sig[b * blk:(b + 1) * blk]
            (yc, ac), (yd, ad) = progs["cpu"].process(x), progs[dev].process(x)
        check(yd.shape == yc.shape and yd.dtype == yc.dtype,
              f"{name}: card y {yd.shape} {yd.dtype}, CPU {yc.shape} {yc.dtype}")
        if yc.dtype == np.uint8:
            agree = float(np.mean(yd == yc))
            chain_err[name] = 1.0 - agree
            ok = agree >= DIBIT_AGREE
        else:
            chain_err[name] = float(np.abs(yd - yc).max() / np.abs(yc).max())
            ok = chain_err[name] <= CHAIN_RTOL
        rows_err = near_peak_err(ad["secondary_fft.rows"], ac["secondary_fft.rows"])
        log(f"[check] {name} chain (2 channels, {blk}-sample blocks at {cfs:.0f} "
            f"S/s), card vs CPU on block 1: y {yd.shape} {yd.dtype}, "
            + (f"dibits differ {chain_err[name]:.4f} (at most {1 - DIBIT_AGREE:.2f})"
               if yc.dtype == np.uint8 else
               f"max diff {chain_err[name]:.2e} of max|y| (tolerance {CHAIN_RTOL})")
            + f"; secondary waterfall {rows_err:.2e} dB near the peak")
        check(ok and rows_err <= WF_DB_TOL, f"{name} chain: card and CPU disagree")

    # a Fanout on the card against its branches run alone on the card
    def fan_parts():
        a = ClientDemodulatorChain(240000.0, 12000.0, "usb", compression="none")
        b = ClientDemodulatorChain(240000.0, 12000.0, "am", compression="none")
        for c in (a, b):
            c.set_frequency_offset(30000.0)
        return {"usb": (a, (4,)), "am": (b, (2,)),
                "fft": (FftChain(1024, fps=1000.0), ())}

    spec240 = StreamSpec(Format.COMPLEX_FLOAT, 240000.0)
    parts = fan_parts()
    fan_prog = Program(Fanout([(k, c) for k, (c, _) in parts.items()],
                              batch_shapes={k: b for k, (_, b) in parts.items()}),
                       spec240, 24000, device=dev)
    solo = {k: Program(c, spec240, 24000, batch_shape=b, device=dev)
            for k, (c, b) in fan_parts().items()}
    fan_blocks = seeded_blocks(torch, gen, dev, 240000.0, 24000, 3, [30000.0], "am")
    fan_audio, fan_rows = 0, 0.0
    for x in fan_blocks:
        yf, af = fan_prog.process(x)
        for k, prog in solo.items():
            ys, as_ = prog.process(x)
            if k == "fft":
                fan_rows = max(fan_rows, near_peak_err(yf[k], ys))
            else:
                fan_audio = max(fan_audio, int(np.abs(yf[k].astype(np.int32)
                                                      - ys.astype(np.int32)).max()))
                check(np.abs(af[f"{k}.selector.squelch.power_db"]
                             - as_["selector.squelch.power_db"]).max() <= SQUELCH_DB_TOL,
                      f"fanout {k}: squelch powers differ from the branch alone")
    log(f"[check] Fanout(usb (4,), am (2,), fft ()) on the card vs each branch "
        f"alone: audio max diff {fan_audio} LSB (tolerance 2), rows "
        f"{fan_rows:.2e} dB")
    check(fan_audio <= 2 and fan_rows <= WF_DB_TOL, "Fanout differs from its branches")

    secondary_bank_check(torch, dev)

    # -- 5. the paths at full width ------------------------------------------
    # record the shapes the paths hand the AGC, the ADPCM encoders and the
    # squelch (the stages call them through their modules)
    seen_agc, seen_adpcm, seen_squelch, seen_seq, seen_iir = set(), set(), set(), set(), set()
    agc_apply, adpcm_encode = agc.agc_apply, adpcm.adpcm_encode
    squelch_apply, adpcm_encode_seq = squelch.squelch_apply, adpcm.adpcm_encode_seq
    first_order_apply = iir.first_order_apply

    def agc_recorded(state, profile, x, chunk=agc.CHUNK, device="cuda"):
        seen_agc.add((profile, tuple(x.shape), chunk))
        return agc_apply(state, profile, x, chunk, device=device)

    def adpcm_recorded(state, x):
        seen_adpcm.add(tuple(x.shape))
        return adpcm_encode(state, x)

    def squelch_recorded(state, level_db, x, window, hang_windows=2):
        seen_squelch.add((tuple(x.shape), window))
        return squelch_apply(state, level_db, x, window, hang_windows)

    def seq_recorded(state, x):
        seen_seq.add(tuple(x.shape))
        return adpcm_encode_seq(state, x)

    def iir_recorded(state, b0, b1, a1, x, device="cuda"):
        seen_iir.add(tuple(x.shape))
        return first_order_apply(state, b0, b1, a1, x, device=device)

    agc.agc_apply, adpcm.adpcm_encode = agc_recorded, adpcm_recorded
    squelch.squelch_apply, adpcm.adpcm_encode_seq = squelch_recorded, seq_recorded
    iir.first_order_apply = iir_recorded
    paths = {}
    launches_by_path = {}
    n_blocks = WARMUP_BLOCKS + TIMED_BLOCKS

    bank_paths = [
        # label, mode, m, audio rate, blocks timed, expected launches/block
        ("usb", "usb", 1024, 12000.0, TIMED_BLOCKS,
         launches_per_block(fold=1, adpcm_=1, agc_=1, squelch_=1)),
        ("nfm", "nfm", 1024, 12000.0, TIMED_BLOCKS,
         launches_per_block(fold=1, adpcm_=1, iir_=1, agc_=1, squelch_=1)),
        ("am", "am", 2048, 12000.0, TIMED_BLOCKS,
         launches_per_block(fold=1, adpcm_=1, iir_=1, agc_=1, squelch_=1)),
        ("wfm", "wfm", 128, 48000.0, 5,
         launches_per_block(fold=1, adpcm_=1, iir_=1, squelch_=1)),
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
        sq_stage = bank.chain.selector.squelch
        windows = sq_stage.block // sq_stage.window
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
    check_launches("cfg1", launches, {k: v * n_blocks for k, v in launches_per_block(
        adpcm_=1, iir_=1, agc_=1, squelch_=1).items()})
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
    del prog, blocks, results

    # BASELINE config #2: a 4096-bin compressed waterfall, one USB listener
    # on a 64-channel PFB bank and one edge dial on a full-rate ChannelBank,
    # all fed from one device-resident block per step
    lbank = ChannelizedBank(CFG2_FS, 64, mode="usb", compression="adpcm",
                            target_seconds=0.04, device=dev)
    lslot = lbank.assign(CFG2_LISTENER)
    ebank = ChannelBank(CFG2_FS, "usb", capacity=16, block=lbank.block, device=dev)
    check(lbank.block == 120000 and ebank.chunk_ratio == 1
          and not lbank.fits(CFG2_EDGE, *MODE_BANDPASS["usb"]),
          f"config #2 plan: block {lbank.block}, chunk ratio {ebank.chunk_ratio}")
    eslot = ebank.add_channel(CFG2_EDGE)
    wf2 = FftChain(WF_SIZE, 20.0, compress=True)
    wf2_prog = Program(wf2, spec24, lbank.block, device=dev)
    nb = wf2.waterfall.wire_bytes_per_row
    check((wf2.waterfall.rows, wf2.waterfall.averages, nb) == (1, 29, 2053),
          f"config #2 waterfall plan {wf2.waterfall.rows} {wf2.waterfall.averages} {nb}")
    blocks = seeded_blocks(torch, gen, dev, CFG2_FS, lbank.block, n_blocks,
                           [CFG2_LISTENER, CFG2_EDGE], "usb", noise=0.05)

    def cfg2_dispatch(x):
        return (wf2_prog.dispatch(x), lbank.dispatch(x), ebank.feed_dispatch(x))

    def cfg2_fetch(w, lb, eb):
        return wf2_prog.fetch(*w), lbank.fetch(*lb), ebank.program.fetch(*eb)

    results, wall, launches, peak = drive(
        "cfg2", cfg2_dispatch, cfg2_fetch, blocks, kernels, torch, dev)
    launches_by_path["cfg2"] = launches
    check_launches("cfg2", launches, {k: v * n_blocks for k, v in launches_per_block(
        fold=1, adpcm_=2, agc_=2, squelch_=2, seq=1).items()})
    bins = {f: WF_SIZE // 2 + int(round((f + TONE_AUDIO_HZ) / CFG2_FS * WF_SIZE))
            for f in (CFG2_LISTENER, CFG2_EDGE)}
    for (raw, _), (ly, la), (ey, ea) in results:
        check(raw.shape == (1, SEQ_ROW // 2) and raw.dtype == np.uint8,
              f"cfg2: waterfall rows {raw.shape} {raw.dtype}")
        check(ly[0].shape == (64, 300) and ey[0].shape == (16, 300)
              and la["selector.squelch.power_db"].shape == (64, 1)
              and ea["selector.squelch.power_db"].shape == (16, 1),
              "cfg2: listener outputs")
    row = decoded_row(results[-1][0][0][0], nb, adpcm)
    for f, k in bins.items():
        peak_bin = k - 4 + int(np.argmax(row[k - 4:k + 5]))
        rise = row[peak_bin] - np.median(row)
        log(f"[cfg2] waterfall: tone at {f + TONE_AUDIO_HZ:.0f} Hz peaks in bin "
            f"{peak_bin} (expected {k} ± 1), {rise:.1f} dB above the median")
        check(abs(peak_bin - k) <= 1 and rise > 20.0, f"cfg2: waterfall tone at {f}")
    for label, bank_out, slot in (("listener", 1, lslot), ("edge", 2, eslot)):
        audio = decode_channel([(r[bank_out][0][0][slot], r[bank_out][0][1][slot])
                                for r in results], adpcm)
        snr = tone_snr(audio[len(audio) // 2:].astype(np.float32) / 32767,
                       TONE_AUDIO_HZ, 12000.0)
        log(f"[cfg2] {label} slot {slot}: USB tone SNR {snr:.1f} dB (minimum "
            f"{TONE_SNR_MIN_DB})")
        check(snr > TONE_SNR_MIN_DB, f"cfg2: {label} tone SNR {snr:.1f} dB")
    paths["cfg2"] = report("cfg2", smi, wall, TIMED_BLOCKS, lbank.block, CFG2_FS, peak)
    del lbank, ebank, wf2_prog, blocks, results

    # BASELINE config #4: BPSK31 ×16 and USB audio ×16 in one Fanout,
    # delivered in 6-block batches; the first batch is checked against the
    # same Fanout on the CPU
    def cfg4_fanout():
        psk = PskChain(CFG2_FS, baud=31.25)
        psk.selector.shift.set_rate(
            -(np.arange(CFG4_CHANNELS, dtype=np.float32) * 5e3 + 50e3) / CFG2_FS)
        aud = ClientDemodulatorChain(CFG2_FS, 12000.0, "usb", "none")
        aud.selector.shift.set_rate(
            -(np.arange(CFG4_CHANNELS, dtype=np.float32) * 5e3 + 60e3) / CFG2_FS)
        return psk, aud, Fanout([("psk", psk), ("audio", aud)], batch_shapes={
            "psk": (CFG4_CHANNELS,), "audio": (CFG4_CHANNELS,)})

    psk4, aud4, fan4 = cfg4_fanout()
    ra, rb = block_requirement(psk4, spec24), block_requirement(aud4, spec24)
    req = ra * rb // int(np.gcd(ra, rb))
    block4 = (int(round(CFG2_FS * 0.1)) + req - 1) // req * req
    check(block4 == 307200, f"config #4 block {block4}")
    prog4 = Program(fan4, spec24, block4, device=dev)
    n4 = 4 * CFG4_BATCH
    blocks = seeded_blocks(torch, gen, dev, CFG2_FS, block4, n4, [60e3], "usb")
    torch.cuda.synchronize()
    for k in kernels.ALL:
        k.launches = 0
    results4, pend, batch, t_start = [], [], [], None
    for i, x in enumerate(blocks):
        if i == CFG4_BATCH:                       # after the first batch
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        batch.append(prog4.dispatch_quiet(x))
        if len(batch) == CFG4_BATCH:
            pend.append(prog4.join_pending(batch))
            batch = []
        if len(pend) >= 2:                        # two batches in flight
            results4 += prog4.fetch_many(*pend.pop(0))
    while pend:
        results4 += prog4.fetch_many(*pend.pop(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {k.source.name: k.launches for k in kernels.ALL}
    log(f"[cfg4] launches: {launches} (blocks fed: {n4})")
    launches_by_path["cfg4"] = launches
    check_launches("cfg4", launches, {k: v * n4 for k, v in launches_per_block(
        agc_=1, squelch_=1).items()})
    symbols = 0
    for y, aux in results4:
        check(y["psk"].shape == (CFG4_CHANNELS, int(block4 * 31.25 / CFG2_FS))
              and y["psk"].dtype == np.complex64
              and y["audio"].shape == (CFG4_CHANNELS, 1536)
              and y["audio"].dtype == np.int16
              and aux["psk.secondary_fft.rows"].shape == (CFG4_CHANNELS, 1, 2048)
              and aux["audio.selector.squelch.power_db"].shape == (CFG4_CHANNELS, 2),
              f"cfg4: output shapes {y['psk'].shape} {y['audio'].shape}")
        symbols += y["psk"].shape[-1]
    check(len(results4) == n4 and symbols == n4 * 4,
          f"cfg4: {len(results4)} results, {symbols} symbols a channel")
    _, _, fan4_cpu = cfg4_fanout()
    prog4_cpu = Program(fan4_cpu, spec24, block4, device="cpu")
    psk_err, aud_err, pdb_err = 0.0, 0, 0.0
    for x, (y, aux) in zip(blocks[:CFG4_BATCH], results4):
        yc, ac = prog4_cpu.process(x.cpu())
        psk_err = max(psk_err, float(np.abs(y["psk"] - yc["psk"]).max()
                                     / np.abs(yc["psk"]).max()))
        aud_err = max(aud_err, int(np.abs(y["audio"].astype(np.int32)
                                          - yc["audio"].astype(np.int32)).max()))
        key = "audio.selector.squelch.power_db"
        pdb_err = max(pdb_err, float(np.abs(aux[key] - ac[key]).max()))
    log(f"[cfg4] first batch card vs CPU: psk symbols max diff {psk_err:.2e} of "
        f"max|y| (tolerance {CHAIN_RTOL}), audio {aud_err} LSB (tolerance "
        f"{SMALL_BANK_LSB}), squelch power {pdb_err:.2e} dB; {symbols} symbols "
        f"a channel over {n4} blocks")
    check(psk_err <= CHAIN_RTOL and aud_err <= SMALL_BANK_LSB
          and pdb_err <= SQUELCH_DB_TOL, "cfg4: card and CPU disagree")
    audio4 = np.concatenate([y["audio"][0] for y, _ in results4])
    snr = tone_snr(audio4[len(audio4) // 2:].astype(np.float32) / 32767,
                   TONE_AUDIO_HZ, 12000.0)
    log(f"[cfg4] audio channel 0: USB tone SNR {snr:.1f} dB (minimum {TONE_SNR_MIN_DB})")
    check(snr > TONE_SNR_MIN_DB, f"cfg4: tone SNR {snr:.1f} dB")
    paths["cfg4"] = report("cfg4", smi, wall, n4 - CFG4_BATCH, block4, CFG2_FS,
                           torch.cuda.max_memory_allocated(dev) / 2 ** 20)
    del prog4, prog4_cpu, blocks, results4

    # the 1024-channel USB bank beside the waterfall a config #5 device
    # runs for its subscribers: FftChain(4096, 9) on the same 49.152 MS/s
    # block, 600 averaged frames a 0.05 s row; the waterfall alone, then both
    ubank = ChannelizedBank(FS, M, mode="usb", compression="adpcm",
                            target_seconds=0.05, device=dev)
    for i in range(M):
        ubank.assign(float((i - M // 2) * FS / M))
    wf5 = FftChain(WF_SIZE, 9.0, compress=True)
    wf5_prog = Program(wf5, StreamSpec(Format.COMPLEX_FLOAT, FS), ubank.block,
                       device=dev)
    check((wf5.waterfall.rows, wf5.waterfall.averages) == (1, 600),
          f"waterfall plan at 49.152 MS/s: {wf5.waterfall.rows} rows of "
          f"{wf5.waterfall.averages}")
    carriers = [float((i - M // 2) * FS / M) for i in TONE_CHANNELS]
    blocks = seeded_blocks(torch, gen, dev, FS, ubank.block, n_blocks, carriers, "usb")
    results, wall, launches, peak = drive(
        "wf", wf5_prog.dispatch, wf5_prog.fetch, blocks, kernels, torch, dev)
    launches_by_path["wf"] = launches
    check_launches("wf", launches, {k: v * n_blocks for k, v in launches_per_block(seq=1).items()})
    # 600 averages leave a floor smooth to ±0.2 dB, so the codec's step is
    # small when a tone's 37 dB peak arrives and the decoded peak comes out
    # ~25 dB low and a bin late (the reference encoder does the same; the
    # bytes are bit-identical to it): the tone must be there, ±1 bin
    row = decoded_row(results[-1][0][0], wf5.waterfall.wire_bytes_per_row, adpcm)
    for f in carriers:
        k = WF_SIZE // 2 + int(round((f + TONE_AUDIO_HZ) / FS * WF_SIZE))
        peak_bin = k - 4 + int(np.argmax(row[k - 4:k + 5]))
        rise = row[peak_bin] - np.median(row)
        log(f"[wf] waterfall: tone at {f + TONE_AUDIO_HZ:.0f} Hz peaks in bin "
            f"{peak_bin} (expected {k} ± 1), {rise:.1f} dB above the median "
            f"after decoding")
        check(abs(peak_bin - k) <= 1 and rise > 3.0,
              f"wf: tone at {f} peaks in bin {peak_bin}, expected {k}")
    paths["wf"] = report("wf", smi, wall, TIMED_BLOCKS, ubank.block, FS, peak)

    def both_dispatch(x):
        return wf5_prog.dispatch(x), ubank.dispatch(x)

    def both_fetch(w, b):
        return wf5_prog.fetch(*w), ubank.fetch(*b)

    results, wall, launches, peak = drive(
        "usb+wf", both_dispatch, both_fetch, blocks, kernels, torch, dev)
    launches_by_path["usb+wf"] = launches
    check_launches("usb+wf", launches, {k: v * n_blocks for k, v in launches_per_block(
        fold=1, adpcm_=1, agc_=1, squelch_=1, seq=1).items()})
    for k in [ubank.channel_for(f)[0] for f in carriers]:
        audio = decode_channel([(r[1][0][0][k], r[1][0][1][k]) for r in results], adpcm)
        snr = tone_snr(audio[len(audio) // 2:].astype(np.float32) / 32767,
                       TONE_AUDIO_HZ, 12000.0)
        check(snr > TONE_SNR_MIN_DB, f"usb+wf: channel {k} tone SNR {snr:.1f} dB")
    log(f"[usb+wf] tones decoded in slots {[ubank.channel_for(f)[0] for f in carriers]}")
    paths["usb+wf"] = report("usb+wf", smi, wall, TIMED_BLOCKS, ubank.block, FS, peak)
    del ubank, wf5_prog, blocks, results
    torch.cuda.empty_cache()

    runtime_paths(torch, dev, smi, paths, launches_by_path)

    agc.agc_apply, adpcm.adpcm_encode = agc_apply, adpcm_encode
    squelch.squelch_apply, adpcm.adpcm_encode_seq = squelch_apply, adpcm_encode_seq
    iir.first_order_apply = first_order_apply
    log(f"[shapes] agc on the paths: {sorted((s, c) for _, s, c in seen_agc)}; "
        f"adpcm_encode on the paths: {sorted(seen_adpcm)}; squelch on the "
        f"paths: {sorted(seen_squelch)}; adpcm_encode_seq on the paths: "
        f"{sorted(seen_seq)}; iir on the paths: {sorted(seen_iir)}")
    # phase 3 checked exactly these; an empty record fails here too
    path_agc = {(getattr(agc, p), s, c) for p, s, c in AGC_PATH_CASES.values()}
    check(seen_agc == path_agc, f"AGC shapes on the paths {seen_agc} are not "
          f"the expected {path_agc}")
    check(seen_adpcm == set(ADPCM_PATH_SHAPES.values()), f"ADPCM shapes on the "
          f"paths {seen_adpcm} are not the expected {set(ADPCM_PATH_SHAPES.values())}")
    path_squelch = {(s, w) for s, w in SQUELCH_PATH_CASES.values()}
    check(seen_squelch == path_squelch, f"squelch shapes on the paths "
          f"{seen_squelch} are not the expected {path_squelch}")
    check(seen_seq == ADPCM_SEQ_PATH_SHAPES, f"adpcm_encode_seq shapes on the "
          f"paths {seen_seq} are not the expected {ADPCM_SEQ_PATH_SHAPES}")
    check(seen_iir == set(IIR_PATH_CASES.values()), f"IIR shapes on the paths "
          f"{seen_iir} are not the expected {set(IIR_PATH_CASES.values())}")
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
    lhs64 = torch.view_as_real(u64).permute(2, 1, 0).contiguous()
    wconv64 = bank64.T.contiguous()[:, None, :]
    conv64_err = float((torch.complex(*F.conv1d(lhs64, wconv64, groups=64)).T
                        - v64_plain).abs().max())
    fold64_lib_ms = time_cuda(lambda: F.conv1d(lhs64, wconv64, groups=64), iters, torch)
    iir_st, iir_x, deemph = iir_in["nfm"]
    iir_ms = time_cuda(lambda: iir.first_order_apply(iir_st, *deemph, iir_x, device=dev),
                       iters, torch)
    iir_plain_ms = time_cuda(lambda: iir.first_order_apply_plain(iir_st, *deemph, iir_x),
                             iters, torch)
    fold_bytes = u.numel() * 8 + bank2.numel() * 4 + v_plain.numel() * 8
    fold_ops = 4 * p_taps * v_plain.numel()        # re+im: P mul-adds each

    def iir_bytes_ops(x):
        """x in, y out, four (rows,) state vectors; per sample 2 mul + 1 add
        for c[n] and one multiply-add for y[n]"""
        return x.numel() * 8 + 4 * 4 * (x.numel() // x.shape[-1]), 5 * x.numel()

    iir_bytes, iir_ops = iir_bytes_ops(iir_x)

    def bound(nbytes, nops, ops_per_s=FP32_OPS_PER_S):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    fold_bound, fold_by = bound(fold_bytes, fold_ops)
    iir_bound, iir_by = bound(iir_bytes, iir_ops)
    log(f"[time] {smi}: fold kernel {fold_ms:.5f} ms, bound {fold_bound:.5f} ms "
        f"({fold_by}: {fold_bytes} B, {fold_ops} flop), plain {fold_plain_ms:.5f} ms, "
        f"depthwise F.conv1d {fold_lib_ms:.5f} ms (max diff {conv_err:.2e}); at "
        f"u{tuple(u64.shape)} depthwise F.conv1d {fold64_lib_ms:.5f} ms (max diff "
        f"{conv64_err:.2e})")
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

    def timed(label, name, fn, args, nbytes, nops, ops_per_s, chain=None):
        """fn(*args) timed warm, then cold: one copy of args per launch."""
        warm = time_cuda(lambda: fn(*args), iters, torch)
        copies = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                  for _ in range(COLD_COPIES)]
        cold = time_cuda([lambda c=c: fn(*c) for c in copies], COLD_COPIES,
                         torch, flush)
        del copies
        b, by = bound(nbytes, nops, ops_per_s)
        chain_txt = ("" if chain is None else
                     f", chain {chain:.5f} ms, cold share of the chain {chain / cold:.3f}")
        log(f"[time] {smi}: {name} {label}: warm {warm:.5f} ms, cold {cold:.5f} "
            f"ms; bound {b:.5f} ms ({by}: {nbytes} B, {nops} ops at "
            f"{ops_per_s:.4g}/s); cold share of the bound {b / cold:.3f}{chain_txt}")
        return {"ms": warm, "cold_ms": cold, "bound_ms": b, "bound_by": by,
                "chain_bound_ms": chain}

    # the fold and the IIR cold too: their warm inputs stay in the L2
    fold_row = timed("(2415, 1024)", "fold kernel",
                     lambda u_, b_: polyphase_fold(u_, b_, p_taps, device=dev),
                     (u, bank2), fold_bytes, fold_ops, FP32_OPS_PER_S)
    fold64_row = timed("(1890, 64)", "fold kernel",
                       lambda u_, b_: polyphase_fold(u_, b_, p_taps, device=dev),
                       (u64, bank64), u64.numel() * 8 + bank64.numel() * 4
                       + v64.numel() * 8, 4 * p_taps * v64.numel(), FP32_OPS_PER_S)
    fold64_row["library_ms"] = fold64_lib_ms
    # the IIR at every path's shape, with that path's coefficients
    iir_rows = {}
    for label, (st, x, co) in iir_in.items():
        iir_rows[label] = dict(shape=list(x.shape), a1=co[2], **timed(
            label, "iir kernel",
            lambda x0, y0, x, co=co: iir.first_order_apply((x0, y0), *co, x, device=dev),
            (*st, x), *iir_bytes_ops(x), FP32_OPS_PER_S))
    iir_row = iir_rows["nfm"]

    # the squelch at every path's shape, warm and cold; bound by bytes (x
    # in, y out); no chain to speak of (a few windows a row)
    squelch_rows = {}
    for label, (st, level, x, window) in squelch_in.items():
        squelch_rows[label] = dict(shape=list(x.shape), window=window, **timed(
            label, "squelch kernel",
            lambda o, h, lv, x, window=window: squelch.squelch_apply(
                (o, h), lv, x, window), (*st, level, x),
            squelch_bytes(tuple(x.shape), window), 4 * x.numel(), FP32_OPS_PER_S))
    # device kernels a call launches (torch.profiler's kernel records, the
    # hand-written ones included): the plain version against the kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels_launched(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                   and "memcpy" not in e.name.lower() and "memset" not in e.name.lower())

    for label, (st, level, x, window) in squelch_in.items():
        squelch_rows[label]["plain_kernels"] = kernels_launched(
            lambda: squelch.squelch_apply_plain(st, level, x, window))
        squelch_rows[label]["kernels"] = kernels_launched(
            lambda: squelch.squelch_apply(st, level, x, window))
    log(f"[launches] squelch kernels per call, plain -> kernel: " + ", ".join(
        f"{k} {v['plain_kernels']} -> {v['kernels']}" for k, v in squelch_rows.items()))
    st, level, x, window = squelch_in["nfm"]
    squelch_plain_ms = time_cuda(
        lambda: squelch.squelch_apply_plain(st, level, x, window), 10, torch)
    log(f"[time] {smi}: squelch plain nfm {squelch_plain_ms:.5f} ms")

    # the row encoder.  Its serial nibble step, the one the sweep runs where
    # no candidate holds the truth: a build with one segment walks a row
    # with one lane, checked against the plain version, and the slope
    # between rows of SEQ_SHORT_ROW and SEQ_ROW samples is its time a
    # nibble (a runtime length: one build).  The operations bound counts the
    # SASS instructions a nibble of csrc/adpcm.cu's main loop (the same
    # nibble step) at the int32 issue rate
    def seq_serial_launch(st, x):
        rows_, ns = x.shape
        out = torch.empty(rows_, ns // 2, dtype=torch.uint8, device=dev)
        stride = torch.empty(rows_, ns // 200, dtype=torch.int32, device=dev)
        po, io = (torch.empty(rows_, dtype=torch.int32, device=dev) for _ in range(2))
        seq_serial.launch(dev, x.data_ptr(), st[0].data_ptr(), st[1].data_ptr(),
                          out.data_ptr(), stride.data_ptr(), po.data_ptr(),
                          io.data_ptr(), rows_, ns, 0, None)
        return (po, io), (out, stride)

    st, x = seq_in["audio"]
    ks, (kb, kst) = seq_serial_launch(st, x)
    ps, (pb, pst) = seq_plain["audio"]
    torch.cuda.synchronize()
    check(torch.equal(kb, pb) and torch.equal(kst, pst)
          and all(torch.equal(a, b) for a, b in zip(ks, ps)),
          "the one-segment build of adpcm_seq.cu differs from the plain version")
    seq_one = {}
    for ns in (SEQ_SHORT_ROW, SEQ_ROW):
        st1 = random_seq_state(1)
        x1 = int16_audio(torch, gen, dev, 1, ns)
        seq_one[ns] = time_cuda(lambda: seq_serial_launch(st1, x1), STEP_ITERS, torch)
    seq_step_ms = (seq_one[SEQ_ROW] - seq_one[SEQ_SHORT_ROW]) / (SEQ_ROW - SEQ_SHORT_ROW)
    seq_nibble_instrs = (sass_loop_instructions(kernels.ADPCM.library_path())
                         / ADPCM_LOOP_NIBBLES)
    log(f"[time] {smi}: adpcm_encode_seq serial step (one-segment build, bytes "
        f"identical to the plain version), one row: {SEQ_SHORT_ROW} nibbles "
        f"{seq_one[SEQ_SHORT_ROW]:.5f} ms, {SEQ_ROW} nibbles {seq_one[SEQ_ROW]:.5f} "
        f"ms: {seq_step_ms * 1e6:.3f} ns = {seq_step_ms * clock_mhz * 1e3:.1f} "
        f"cycles a nibble at {clock_mhz:.0f} MHz, {SEQ_ROW} x {seq_step_ms * 1e3:.5f} "
        f"us = {SEQ_ROW * seq_step_ms:.5f} ms serial; {seq_nibble_instrs:.2f} SASS "
        f"instructions a nibble")
    seq_rows = {}
    for label, forced in (("cfg2 row", 0), ("wf row", 0), ("audio", 0), ("16 rows", 0),
                          ("wf row", 1), ("wf row", 2)):
        st, x = seq_in[label]
        rows_, ns = x.shape
        key = f"{label}, forced {forced}" if forced else label
        seq_rows[key] = dict(shape=list(x.shape), forced=forced,
                             **seq_diag[(label, forced)], **timed(
            key, "adpcm_encode_seq kernel",
            lambda p0, i0, x, forced=forced: adpcm.encode_seq_kernel((p0, i0), x, forced),
            (*st, x), seq_bytes(rows_, ns), round(seq_nibble_instrs * x.numel()),
            int32_per_s, seq_step_ms * ns))
    log(f"[time] {smi}: adpcm_encode_seq SM cycles (most in a row, the check's "
        f"launch): total, set-up, first pass, sweep, output: " + "; ".join(
            f"{k} {v['cycles_total_setup_pass1_sweep_output']}" for k, v in seq_rows.items()))
    seq_main = seq_rows["cfg2 row"]
    st, x = seq_in["cfg2 row"]
    seq_plain_ms = time_cuda(lambda: adpcm.adpcm_encode_seq_plain(st, x), 2, torch)
    log(f"[time] {smi}: adpcm_encode_seq plain (1, {SEQ_ROW}) {seq_plain_ms:.5f} ms")

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
        adpcm_short.launch(dev, short_in.data_ptr(), None, None, prev.data_ptr(),
                           idxs.data_ptr(), short_out.data_ptr(), None, None,
                           None, lanes, 1)

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
         "max_abs_err": fold_err, "ms": fold_ms, "cold_ms": fold_row["cold_ms"],
         "plain_ms": fold_plain_ms, "bound_ms": fold_bound, "bound_by": fold_by,
         "library_ms": fold_lib_ms, "by_shape": {"cfg2 (1890, 64)": fold64_row}},
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
         "max_abs_err": iir_err, "ms": iir_ms, "cold_ms": iir_row["cold_ms"],
         "plain_ms": iir_plain_ms, "bound_ms": iir_bound, "bound_by": iir_by,
         "library_ms": None, "by_shape": iir_rows},
        {"name": "agc_chunked", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/agc.cu",
         "replaces": "openwebrx_tpu/ops/agc.py:58",
         "launches": total("agc.cu"), "launches_by_path": by_path("agc.cu"),
         "max_abs_err": agc_err, "ms": agc_main["ms"],
         "cold_ms": agc_main["cold_ms"], "plain_ms": agc_plain_ms,
         "bound_ms": agc_main["bound_ms"], "bound_by": agc_main["bound_by"],
         "chain_bound_ms": agc_main["chain_bound_ms"], "library_ms": None,
         "by_shape": agc_rows},
        {"name": "squelch_apply", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/squelch.cu",
         "replaces": "openwebrx_tpu/ops/squelch.py:25",
         "launches": total("squelch.cu"), "launches_by_path": by_path("squelch.cu"),
         "max_abs_err": squelch_err, "ms": squelch_rows["nfm"]["ms"],
         "cold_ms": squelch_rows["nfm"]["cold_ms"], "plain_ms": squelch_plain_ms,
         "bound_ms": squelch_rows["nfm"]["bound_ms"],
         "bound_by": squelch_rows["nfm"]["bound_by"], "library_ms": None,
         "by_shape": squelch_rows},
        {"name": "adpcm_encode_seq", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/adpcm_seq.cu",
         "replaces": "openwebrx_tpu/ops/adpcm.py:98",
         "launches": total("adpcm_seq.cu"), "launches_by_path": by_path("adpcm_seq.cu"),
         "max_abs_err": float(seq_err), "ms": seq_main["ms"],
         "cold_ms": seq_main["cold_ms"], "plain_ms": seq_plain_ms,
         "bound_ms": seq_main["bound_ms"], "bound_by": seq_main["bound_by"],
         "chain_bound_ms": seq_main["chain_bound_ms"],
         "cycles_per_nibble": seq_step_ms * clock_mhz * 1e3, "library_ms": None,
         "by_shape": seq_rows},
    ]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
