"""Host-side FIR filter design (numpy).

Filter *design* runs on host at chain-build/param-change time; only the
*application* of filters runs on TPU.  Designs are standard windowed-sinc
(Hamming default), with the tap-count heuristic taps ≈ 4/transition_bw used
by classic SDR filter chains, so cutoff/transition semantics line up with
the reference's selector math (reference ``csdr/chain/selector.py:21-35``:
transition = 0.15·out/in, precompensated cutoff).

All frequencies are normalized to the sample rate (cycles/sample, so
Nyquist = 0.5).
"""

from __future__ import annotations

import numpy as np


def _odd(n: int) -> int:
    return n | 1


def lowpass_taps(cutoff: float, transition_bw: float, window: str = "hamming") -> np.ndarray:
    """Windowed-sinc lowpass. cutoff/transition_bw normalized to fs.

    Returns float32 taps, odd length, unity DC gain.
    """
    if cutoff <= 0 or cutoff >= 0.5:
        raise ValueError(f"cutoff must be in (0, 0.5), got {cutoff}")
    ntaps = _odd(max(9, int(np.ceil(4.0 / transition_bw))))
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= _window(window, ntaps)
    h /= np.sum(h)
    return h.astype(np.float32)


def bandpass_taps(low_cut: float, high_cut: float, transition_bw: float,
                  window: str = "hamming") -> np.ndarray:
    """Complex bandpass for complex (IQ) input: lowpass shifted to band center.

    low_cut/high_cut in (-0.5, 0.5) normalized; returns complex64 taps.
    Passband is [low_cut, high_cut] of the *complex* spectrum (asymmetric
    bands supported — how SSB sidebands are selected).
    """
    if not (-0.5 < low_cut < high_cut < 0.5):
        raise ValueError(f"need -0.5 < low ({low_cut}) < high ({high_cut}) < 0.5")
    bw2 = (high_cut - low_cut) / 2
    center = (high_cut + low_cut) / 2
    lp = lowpass_taps(max(bw2, transition_bw / 2 + 1e-6), transition_bw, window)
    n = np.arange(len(lp)) - (len(lp) - 1) / 2
    return (lp * np.exp(2j * np.pi * center * n)).astype(np.complex64)


def root_raised_cosine_taps(sps: float, alpha: float, span_symbols: int = 11) -> np.ndarray:
    """Root-raised-cosine pulse shaping filter (digital voice / PSK paths).

    Reference analog: digiham Narrow/WideRrcFilter (SURVEY §2.3-C).
    """
    ntaps = _odd(int(span_symbols * sps))
    t = (np.arange(ntaps) - (ntaps - 1) / 2) / sps
    h = np.empty_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-8:
            h[i] = 1.0 - alpha + 4 * alpha / np.pi
        elif abs(abs(4 * alpha * ti) - 1.0) < 1e-8:
            h[i] = (alpha / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha))
            )
        else:
            h[i] = (np.sin(np.pi * ti * (1 - alpha)) + 4 * alpha * ti * np.cos(np.pi * ti * (1 + alpha))) / (
                np.pi * ti * (1 - (4 * alpha * ti) ** 2)
            )
    h /= np.sqrt(np.sum(h**2))
    return h.astype(np.float32)


def freq_response(taps: np.ndarray, nfft: int) -> np.ndarray:
    """FFT-domain response of taps for overlap-save filtering (complex64)."""
    return np.fft.fft(taps, nfft).astype(np.complex64)


def bandpass_response(low_cut: float, high_cut: float, transition_bw: float,
                      nfft: int, window: str = "hamming") -> np.ndarray:
    """Frequency response of a complex bandpass, ready for overlap-save.

    This is the *dynamic parameter* of the FFT bandpass op — recomputed on
    host whenever the user drags the passband edges (reference: live
    ``Bandpass.setBandpass``, csdr/chain/selector.py:166) and fed to the
    jitted program as a traced array, so edge drags never recompile.
    """
    taps = bandpass_taps(low_cut, high_cut, transition_bw, window)
    return freq_response(taps, nfft)


def bandpass_ntaps(transition_bw: float) -> int:
    """Tap count the bandpass designer will use (needed for overlap sizing)."""
    return _odd(max(9, int(np.ceil(4.0 / transition_bw))))


def bandpass_response_batch(low_cut, high_cut, transition_bw: float,
                            nfft: int, window: str = "hamming") -> np.ndarray:
    """Vectorized ``bandpass_response`` over per-channel edge arrays.

    One numpy broadcast + one batched FFT instead of C python-loop design
    calls — a 1024-channel bank re-designs all passbands in milliseconds
    when its control arrays change (BandpassStage._recompute).
    Returns (C, nfft) complex64; rows match bandpass_response exactly.
    """
    low = np.atleast_1d(np.asarray(low_cut, np.float64))
    high = np.atleast_1d(np.asarray(high_cut, np.float64))
    if np.any(low >= high) or np.any(low <= -0.5) or np.any(high >= 0.5):
        raise ValueError("need -0.5 < low < high < 0.5 for every channel")
    ntaps = bandpass_ntaps(transition_bw)
    n = np.arange(ntaps) - (ntaps - 1) / 2
    bw2 = (high - low) / 2
    center = (high + low) / 2
    cut = np.maximum(bw2, transition_bw / 2 + 1e-6)[:, None]
    h = 2 * cut * np.sinc(2 * cut * n)
    h *= _window(window, ntaps)
    h /= h.sum(axis=-1, keepdims=True)
    taps = (h * np.exp(2j * np.pi * center[:, None] * n)).astype(np.complex64)
    return np.fft.fft(taps, nfft, axis=-1).astype(np.complex64)


def _window(kind: str, n: int) -> np.ndarray:
    if kind == "hamming":
        return np.hamming(n)
    if kind == "blackman":
        return np.blackman(n)
    if kind == "hann":
        return np.hanning(n)
    if kind == "boxcar":
        return np.ones(n)
    raise ValueError(f"unknown window {kind!r}")
