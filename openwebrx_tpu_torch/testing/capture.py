"""Deterministic synthetic "recorded" IQ captures for golden parity tests.

Stands in for recorded RTL-SDR captures (which cannot be committed): a
seeded numpy generator producing a realistic 2.4 MS/s band scene — NFM
voice, AM broadcast, USB two-tone, a CW carrier and band noise — bit-stable
across runs and platforms (pure numpy float64 math, fixed PCG64 seed).

Signal plan (offsets relative to center):

    +145.0 kHz   NFM, 5 kHz deviation, voice-like program
    −300.0 kHz   AM, 80 % depth, two-tone program
    +612.5 kHz   USB, two-tone audio (700 + 1900 Hz)
    −750.0 kHz   CW carrier keyed at ~8 wpm
    everywhere   complex AWGN floor

Used by tests/test_parity_golden.py and bench.py configs #1/#2.
"""

from __future__ import annotations

import numpy as np

FS = 2.4e6

NFM_OFFSET = 145_000.0
AM_OFFSET = -300_000.0
USB_OFFSET = 612_500.0
CW_OFFSET = -750_000.0

NFM_DEVIATION = 5_000.0


def voice_program(t: np.ndarray) -> np.ndarray:
    """Deterministic voice-like program: harmonically-rich tones with slow
    syllable-rate amplitude movement.  Peak |p| ≤ 1."""
    p = (0.55 * np.sin(2 * np.pi * 430.0 * t)
         + 0.30 * np.sin(2 * np.pi * 1120.0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * t))
         + 0.15 * np.sin(2 * np.pi * 2280.0 * t) * (0.5 + 0.5 * np.cos(2 * np.pi * 5.7 * t)))
    return p


def am_program(t: np.ndarray) -> np.ndarray:
    return 0.6 * np.sin(2 * np.pi * 800.0 * t) + 0.4 * np.sin(2 * np.pi * 1500.0 * t)


def cw_keying(t: np.ndarray) -> np.ndarray:
    """On/off keying pattern, ~80 ms dits."""
    dit = 0.080
    # fixed deterministic pattern: "CQ"-ish rhythm
    pattern = np.array([1, 0, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 0,
                        1, 1, 1, 0, 1, 1, 1, 0, 1, 0, 1, 1, 1], dtype=np.float64)
    idx = np.floor(t / dit).astype(np.int64) % len(pattern)
    return pattern[idx]


def make_capture(duration_s: float = 0.4, fs: float = FS, seed: int = 0x5D12,
                 noise_rms: float = 0.004) -> np.ndarray:
    """Return a complex64 capture of ``duration_s`` seconds at ``fs``."""
    n = int(round(duration_s * fs))
    t = np.arange(n, dtype=np.float64) / fs

    # NFM: phase = 2π·f_off·t + 2π·dev·∫program
    prog = voice_program(t)
    # cumulative integral of the program (trapezoid-free cumsum is fine for
    # a deterministic fixture; the oracle sees the same samples)
    integ = np.cumsum(prog) / fs
    nfm = 0.5 * np.exp(1j * (2 * np.pi * NFM_OFFSET * t
                             + 2 * np.pi * NFM_DEVIATION * integ))

    # AM
    am = 0.4 * (1.0 + 0.8 * am_program(t)) * np.exp(1j * 2 * np.pi * AM_OFFSET * t)

    # USB: analytic two-tone audio shifted up — exact analytic form
    usb = 0.3 * (0.6 * np.exp(1j * 2 * np.pi * (USB_OFFSET + 700.0) * t)
                 + 0.4 * np.exp(1j * 2 * np.pi * (USB_OFFSET + 1900.0) * t))

    cw = 0.25 * cw_keying(t) * np.exp(1j * 2 * np.pi * CW_OFFSET * t)

    rng = np.random.Generator(np.random.PCG64(seed))
    noise = noise_rms / np.sqrt(2) * (rng.standard_normal(n) + 1j * rng.standard_normal(n))

    return (nfm + am + usb + cw + noise).astype(np.complex64)
