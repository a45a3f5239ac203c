#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``openwebrx_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, PyTorch's device name;
2. build both CUDA kernels from ``openwebrx_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the 1024-channel bank gives it: the polyphase fold within a stated
   tolerance, the ADPCM encoder byte-identical;
4. a small bank (M=64) on the card against the same bank on the CPU (plain
   versions), on the same input;
5. the main path: ``ChannelizedBank(49.152e6, 1024, usb, adpcm)`` with one
   dial per channel, fed seeded device-resident IQ, every result fetched to
   host numpy; launch counters must equal the blocks fed, outputs must be
   finite and of the right shape, and a tuned USB tone must come out clean;
6. kernel device times (CUDA events, launches queued ahead of the device)
   beside their bounds, the plain versions and, for the fold, one PyTorch
   call computing the same function.

The last lines are a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
name/power-limit line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import re
import subprocess
import sys
import time

import numpy as np

FS = 49.152e6          # BASELINE config #5: 49.152 MS/s wideband input
M = 1024               # 1024 PFB channels at 48 kHz
WARMUP_BLOCKS = 3
TIMED_BLOCKS = 20
TONE_CHANNELS = (100, 517, 900)     # dials i (of the 1024) given a USB tone
TONE_AUDIO_HZ = 1000.0
TONE_SNR_MIN_DB = 15.0              # as tests/test_channelized_bank.py
FOLD_RTOL = 1e-5       # × max|v|: fp32 sums of P=16 terms, FMA vs mul+add
SMALL_BANK_LSB = 4     # int16 audio, card vs CPU: cuFFT/cuDNN sum orders
# NVIDIA H100 SXM data sheet (700 W): HBM rate and non-tensor fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SLEEP_CYCLES_PER_S = 2.0e9   # ≥ the H100's SM clock: sleeps err long


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


def time_cuda(fn, iters: int, torch) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls,
    from CUDA events.  The stream is first held busy for longer than the
    host takes to enqueue the calls, so the events time the device alone
    and not the Python wrappers' launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2 * enqueue_s + 0.01) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from openwebrx_tpu_torch import kernels
    from openwebrx_tpu_torch.ops import adpcm, channelizer
    from openwebrx_tpu_torch.ops.fold import polyphase_fold, polyphase_fold_plain
    from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi} | torch: {kind} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels.ALL)) as pool:
        secs = list(pool.map(lambda k: k.build(), kernels.ALL))
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; " + ", ".join(
        f"{k.source.name} {s:.1f} s" for k, s in zip(kernels.ALL, secs)))
    for k in kernels.ALL:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", k.build_log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", k.build_log))
        log(f"[build] {k.source.name}: {len(regs)} kernels, registers "
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

    # ADPCM at the bank's shape: 1024 channels × 600 int16 samples of tone +
    # noise, with clipped extremes and full-scale steps mixed in
    t = torch.arange(600, device=dev, dtype=torch.float32)
    f = torch.linspace(200.0, 5800.0, M, device=dev)[:, None]
    audio = (0.6 * torch.sin(2 * np.pi * f * t / 12000.0)
             + 0.3 * torch.randn(M, 600, generator=gen, device=dev))
    audio[::7] *= 4.0                                   # clipped channels
    audio[3::11] = torch.where(audio[3::11] > 0, 1.0, -1.0)   # ±full scale
    samples = torch.clamp(audio * 32767.0, -32768, 32767).to(torch.int16)
    state = (torch.randint(-32768, 32767, (M,), generator=gen, device=dev,
                           dtype=torch.int32),
             torch.randint(0, 89, (M,), generator=gen, device=dev,
                           dtype=torch.int32))
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
    log(f"[check] adpcm lanes {tuple(lanes_in.shape)} -> bytes "
        f"{tuple(b_kernel.shape)}: {adpcm_mismatch} bytes differ (must be 0)")
    check(adpcm_mismatch == 0, "ADPCM kernel bytes differ from the plain version")
    # the whole encode (reseed states in PyTorch + kernel) on the card
    # against the all-plain encode on the CPU
    st_c, (by_c, sd_c) = adpcm.adpcm_encode(state, samples)
    st_h, (by_h, sd_h) = adpcm.adpcm_encode(tuple(s.cpu() for s in state),
                                            samples.cpu())
    same = (torch.equal(by_c.cpu(), by_h) and torch.equal(sd_c.cpu(), sd_h)
            and all(torch.equal(a.cpu(), b) for a, b in zip(st_c, st_h)))
    log(f"[check] adpcm_encode (1024, 600) card vs CPU: bytes, stride and "
        f"new_state identical = {same}")
    check(same, "adpcm_encode on the card differs from the CPU plain path")

    # -- 4. a small bank on the card against the CPU plain path --------------
    small = {}
    for where in ("cuda", "cpu"):
        sb = ChannelizedBank(3.072e6, 64, mode="usb", compression="none",
                             target_seconds=0.05, device=where)
        for i in range(64):
            sb.assign(float((i - 32) * 3.072e6 / 64))
        rng = np.random.default_rng(5)
        outs = []
        for _ in range(4):
            x = ((rng.standard_normal(sb.block) + 1j * rng.standard_normal(sb.block))
                 * 0.2).astype(np.complex64)
            y, aux = sb.process(x)
            outs.append(y)
        small[where] = np.concatenate(outs, axis=-1).astype(np.int32)
    small_diff = int(np.abs(small["cuda"] - small["cpu"]).max())
    log(f"[check] small bank M=64 int16 audio, card vs CPU: max diff "
        f"{small_diff} LSB (tolerance {SMALL_BANK_LSB}), mean "
        f"{np.abs(small['cuda'] - small['cpu']).mean():.4f}")
    check(small_diff <= SMALL_BANK_LSB, "small bank: card and CPU disagree")

    # -- 5. the main path -----------------------------------------------------
    bank = ChannelizedBank(FS, M, mode="usb", compression="adpcm",
                           target_seconds=0.05, device=dev)
    check(bank.block == block, f"bank block {bank.block} != {block}")
    for i in range(M):
        bank.assign(float((i - M // 2) * FS / M))
    n_blocks = WARMUP_BLOCKS + TIMED_BLOCKS
    # seeded device-resident IQ: noise plus a USB tone in a few channels,
    # phase-continuous across blocks (made before the run: set-up)
    iq = []
    for b in range(n_blocks):
        n = (torch.arange(block, device=dev, dtype=torch.float64)
             + b * block)
        x = torch.complex(torch.randn(block, generator=gen, device=dev),
                          torch.randn(block, generator=gen, device=dev)) * 0.2
        for i in TONE_CHANNELS:
            f_hz = (i - M // 2) * FS / M + TONE_AUDIO_HZ
            ph = torch.remainder(n * (f_hz / FS), 1.0) * (2 * np.pi)
            x = x + (0.4 * torch.polar(torch.ones_like(ph), ph)).to(torch.complex64)
        iq.append(x.contiguous())
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.ALL:
        k.launches = 0
    results = []
    pending = None
    t_start = None
    for b in range(n_blocks):
        if b == WARMUP_BLOCKS:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        nxt = bank.dispatch(iq[b])
        if pending is not None:
            results.append(bank.fetch(*pending))
        pending = nxt
    results.append(bank.fetch(*pending))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {k.source.name: k.launches for k in kernels.ALL}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    log(f"[main] launches during the main path: {launches} "
        f"(blocks fed: {n_blocks})")
    for k in kernels.ALL:
        check(k.launches == n_blocks,
              f"{k.source.name}: {k.launches} launches for {n_blocks} blocks")

    check(len(results) == n_blocks, "missing results")
    for y, aux in results:
        data, strides = y
        pdb = aux["selector.squelch.power_db"]
        check(data.shape == (M, 300) and data.dtype == np.uint8, f"bytes {data.shape} {data.dtype}")
        check(strides.shape == (M, 3) and strides.dtype == np.int32, f"stride {strides.shape}")
        check(pdb.shape == (M, 1) and np.isfinite(pdb).all(), "power_db")
    for i in TONE_CHANNELS:
        k = bank.channel_for(float((i - M // 2) * FS / M))[0]    # dense: slot k
        audio_k = decode_channel([(y[0][k], y[1][k]) for y, _ in results], adpcm)
        settled = audio_k[len(audio_k) // 2:].astype(np.float32) / 32767
        snr = tone_snr(settled, TONE_AUDIO_HZ, 12000.0)
        log(f"[main] dial {i} (slot {k}): USB tone SNR {snr:.1f} dB "
            f"(minimum {TONE_SNR_MIN_DB})")
        check(snr > TONE_SNR_MIN_DB, f"channel {k} tone SNR {snr:.1f} dB")
    quiet = decode_channel([(y[0][5], y[1][5]) for y, _ in results], adpcm)
    check(np.isfinite(quiet).all(), "quiet channel audio")

    msps = TIMED_BLOCKS * block / wall / 1e6
    log(f"[main] {smi}: {TIMED_BLOCKS} blocks of {block} samples in "
        f"{wall * 1e3:.3f} ms (results fetched to host every block): "
        f"{msps:.3f} MS/s = {msps / (FS / 1e6):.3f}x real time; "
        f"{wall / TIMED_BLOCKS * 1e3:.3f} ms/block; peak device memory "
        f"{peak_mib:.1f} MiB")

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
    adpcm_ms = time_cuda(lambda: adpcm.encode_strides(lanes_in, prev, idxs, device=dev),
                         iters, torch)
    adpcm_plain_ms = time_cuda(lambda: adpcm.encode_strides_plain(lanes_in, prev, idxs),
                               3, torch)

    fold_bytes = u.numel() * 8 + bank2.numel() * 4 + v_plain.numel() * 8
    fold_ops = 4 * p_taps * v_plain.numel()        # re+im: P mul-adds each
    lanes = lanes_in.shape[0]
    adpcm_bytes = lanes_in.numel() * 2 + 2 * lanes * 4 + lanes * adpcm.STATE_STRIDE
    adpcm_ops = 25 * 2 * adpcm.STATE_STRIDE * lanes  # ~25 int ops per nibble

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    fold_bound, fold_by = bound(fold_bytes, fold_ops)
    adpcm_bound, adpcm_by = bound(adpcm_bytes, adpcm_ops)
    log(f"[time] {smi}: fold kernel {fold_ms:.5f} ms, bound {fold_bound:.5f} ms "
        f"({fold_by}: {fold_bytes} B, {fold_ops} flop), plain {fold_plain_ms:.5f} ms, "
        f"depthwise F.conv1d {fold_lib_ms:.5f} ms (max diff {conv_err:.2e})")
    log(f"[time] {smi}: adpcm kernel {adpcm_ms:.5f} ms, bound {adpcm_bound:.5f} ms "
        f"({adpcm_by}: {adpcm_bytes} B, ~{adpcm_ops} int ops; serial chain of "
        f"{2 * adpcm.STATE_STRIDE} nibble steps per lane), plain {adpcm_plain_ms:.5f} ms")

    line = {"kernels": [
        {"name": "polyphase_fold", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/fold.cu",
         "replaces": "openwebrx_tpu/ops/pallas_fold.py:39",
         "launches": launches["fold.cu"], "max_abs_err": fold_err,
         "ms": fold_ms, "plain_ms": fold_plain_ms, "bound_ms": fold_bound,
         "bound_by": fold_by, "library_ms": fold_lib_ms},
        {"name": "adpcm_encode_strides", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/adpcm.cu",
         "replaces": "openwebrx_tpu/ops/adpcm.py:169",
         "launches": launches["adpcm.cu"], "max_abs_err": float(adpcm_err),
         "ms": adpcm_ms, "plain_ms": adpcm_plain_ms, "bound_ms": adpcm_bound,
         "bound_by": adpcm_by, "library_ms": None},
    ]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
