"""Numpy/scipy per-sample oracle of the reference csdr receive chains.

This is an *independent* implementation of the reference DSP path — plain
per-sample/scipy semantics, float64, no blocks, no JAX — built from the
reference's published design formulas so the TPU chains can be
parity-checked against it on recorded IQ:

- Decimator: integer FIR + optional fractional stage; transition bandwidth
  0.15·(outRate/inRate), cutoff precompensated to the *final* output
  Nyquist: f_c = 0.5·outRate/inRate of the input rate
  (/root/reference/csdr/chain/selector.py:21-35).
- Bandpass: transition 320/outRate, FFT filtering in the reference — plain
  linear convolution here (mathematically identical)
  (/root/reference/csdr/chain/selector.py:115-117).
- Shift: rate = −offset/inputRate (selector.py:132-140).
- Analog demods wired as csdr/chain/analog.py:11-182 (FmDemod quadrature
  discriminator scaled to ±1 at ±fs/2, Limit clipper, one-pole de-emphasis,
  AM envelope + DC block).

Filter *designs* are classic windowed-sinc (Hamming), tap count ≈
4/transition — the same heuristic family csdr's firdes uses — so responses
line up with the reference within the windowing family's tolerances; the
parity tests assert SNR bounds, not bit equality, exactly as BASELINE.md
specifies ("bit-exact-within-SNR").
"""

from __future__ import annotations

import numpy as np
from scipy import signal


# ------------------------------------------------------------ filter design
def _odd(n: int) -> int:
    return n | 1


def lowpass_taps(cutoff: float, transition: float) -> np.ndarray:
    """Windowed-sinc Hamming lowpass, cutoff/transition in cycles/sample."""
    ntaps = _odd(max(9, int(np.ceil(4.0 / transition))))
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = 2 * cutoff * np.sinc(2 * cutoff * n) * np.hamming(ntaps)
    return h / h.sum()


def lowpass_taps_remez(cutoff: float, transition: float) -> np.ndarray:
    """SECOND, fully independent design path: Parks-McClellan equiripple
    (scipy.signal.remez) with band edges a half-transition around the
    −6 dB cutoff.  Exists to kill shared-formula common-mode risk
    (VERDICT r4 item 3a): the repo's firdes and the windowed-sinc oracle
    share the classic design formula family, so an error in that formula
    could pass parity undetected — the equiripple design shares nothing
    with it but the spec."""
    ntaps = _odd(max(11, int(np.ceil(4.0 / transition))))
    lo = max(cutoff - transition / 2, 1e-4)
    hi = min(cutoff + transition / 2, 0.4999)
    h = signal.remez(ntaps, [0.0, lo, hi, 0.5], [1.0, 0.0])
    return h / h.sum()


def bandpass_taps(low: float, high: float, transition: float,
                  design: str = "hamming") -> np.ndarray:
    """Complex bandpass = lowpass shifted to band center (asymmetric OK)."""
    bw2 = (high - low) / 2
    center = (high + low) / 2
    make = lowpass_taps_remez if design == "remez" else lowpass_taps
    lp = make(max(bw2, transition / 2 + 1e-6), transition)
    n = np.arange(len(lp)) - (len(lp) - 1) / 2
    return lp * np.exp(2j * np.pi * center * n)


# ----------------------------------------------------------------- kernels
def shift(x: np.ndarray, rate: float) -> np.ndarray:
    """NCO mixer from zero phase (reference Shift; rate in cycles/sample)."""
    n = np.arange(len(x), dtype=np.float64)
    return x * np.exp(2j * np.pi * rate * n)


def fir_decimate(x: np.ndarray, decimation: int, taps: np.ndarray) -> np.ndarray:
    """Causal FIR from zero state + decimate: y[m] = (h*x)[m·D]."""
    y = signal.lfilter(taps, [1.0], x)
    return y[::decimation]


def fractional_decimate(x: np.ndarray, interpolation: int, decimation: int) -> np.ndarray:
    """Rational resampler (reference FractionalDecimator).  scipy polyphase
    with its own kaiser design — an independent implementation; parity
    bounds absorb the (tiny, in-band) response difference."""
    return signal.resample_poly(x, interpolation, decimation)


def fm_demod(x: np.ndarray) -> np.ndarray:
    """Quadrature discriminator, prev sample 0, scaled to ±1 at ±fs/2."""
    prev = np.concatenate([[0.0 + 0.0j], x[:-1]])
    d = x * np.conj(prev)
    y = np.angle(d) / np.pi
    y[np.abs(d) == 0] = 0.0
    return y


def am_demod(x: np.ndarray) -> np.ndarray:
    return np.abs(x)


def limit(x: np.ndarray, max_amplitude: float = 1.0) -> np.ndarray:
    return np.clip(x, -max_amplitude, max_amplitude)


def dc_block(x: np.ndarray, rate: float, cutoff_hz: float = 10.0) -> np.ndarray:
    r = np.exp(-2.0 * np.pi * cutoff_hz / rate)
    return signal.lfilter([1.0, -1.0], [1.0, -r], x)


def deemphasis(x: np.ndarray, rate: float, tau: float) -> np.ndarray:
    dt = 1.0 / rate
    alpha = dt / (tau + dt)
    return signal.lfilter([alpha], [1.0, -(1.0 - alpha)], x)


# ---------------------------------------------------------------- selector
def plan_decimation(in_rate: float, out_rate: float):
    """Reference Decimator._getDecimation (selector.py:48-52)."""
    d = int(in_rate / out_rate)
    fraction = (in_rate / d) / out_rate
    return d, fraction


def selector(x: np.ndarray, in_rate: float, out_rate: float,
             offset_hz: float, low_cut: float, high_cut: float,
             design: str = "hamming") -> np.ndarray:
    """Shift → Decimator → Bandpass, reference design constants throughout.

    design="remez" swaps every filter for the independent equiripple
    design (same cutoffs/transitions) — see lowpass_taps_remez."""
    make = lowpass_taps_remez if design == "remez" else lowpass_taps
    y = shift(x, -offset_hz / in_rate)
    d, fraction = plan_decimation(in_rate, out_rate)
    transition = 0.15 * (out_rate / in_rate)
    cutoff = 0.5 * out_rate / in_rate        # precompensated final Nyquist
    y = fir_decimate(y, d, make(cutoff, transition))
    if abs(fraction - 1.0) > 1e-9:
        # fraction = remaining decimation ratio (>1): rate ÷ fraction
        from fractions import Fraction
        f = Fraction(fraction).limit_denominator(10000)
        y = fractional_decimate(y, f.denominator, f.numerator)
    bp = bandpass_taps(low_cut / out_rate, high_cut / out_rate,
                       320.0 / out_rate, design=design)
    return signal.lfilter(bp, [1.0], y)


# ------------------------------------------------------------- full chains
def nfm_chain(x: np.ndarray, in_rate: float, if_rate: float, offset_hz: float,
              tau: float = 150e-6,
              low_cut: float = -4000.0, high_cut: float = 4000.0) -> np.ndarray:
    """Selector → FmDemod → Limit → NfmDeemphasis (pre-AGC audio at if_rate)."""
    iq = selector(x, in_rate, if_rate, offset_hz, low_cut, high_cut)
    return deemphasis(limit(fm_demod(iq)), if_rate, tau)


def am_chain(x: np.ndarray, in_rate: float, if_rate: float, offset_hz: float,
             low_cut: float = -4000.0, high_cut: float = 4000.0) -> np.ndarray:
    """Selector → AmDemod → DcBlock (pre-AGC audio at if_rate)."""
    iq = selector(x, in_rate, if_rate, offset_hz, low_cut, high_cut)
    return dc_block(am_demod(iq), if_rate)


def ssb_chain(x: np.ndarray, in_rate: float, if_rate: float, offset_hz: float,
              low_cut: float, high_cut: float) -> np.ndarray:
    """Selector (sideband-selecting bandpass) → RealPart (pre-AGC audio)."""
    iq = selector(x, in_rate, if_rate, offset_hz, low_cut, high_cut)
    return iq.real * 2.0


def wfm_chain(x: np.ndarray, in_rate: float, offset_hz: float,
              audio_rate: float = 48000.0, if_rate: float = 250000.0,
              tau: float = 50e-6) -> np.ndarray:
    """Selector(±75k) → FmDemod → Limit → resample IF→audio → WfmDeemphasis."""
    iq = selector(x, in_rate, if_rate, offset_hz, -75000.0, 75000.0)
    audio = limit(fm_demod(iq))
    from fractions import Fraction
    f = Fraction(int(audio_rate), int(if_rate))
    audio = fractional_decimate(audio, f.numerator, f.denominator)
    return deemphasis(audio, audio_rate, tau)


# ---------------------------------------------------------------- AGC ----
def agc(x: np.ndarray, reference: float = 0.8,
        max_gain: float = 65536.0) -> np.ndarray:
    """Independent per-sample AGC with the FAST-profile dynamics (same
    constants as ops/agc.py FAST — attack 0.9 / decay 0.01 per 50-sample
    chunk, 8-chunk hang — but a different mechanism: sliding-max envelope
    follower + per-sample gain recurrence, no chunking, no interpolation).
    Used to parity-check the full chain INCLUDING AGC without per-window
    gain fitting (VERDICT r4 item 3c)."""
    from scipy.ndimage import maximum_filter1d
    la = 1.0 - (1.0 - 0.9) ** (1.0 / 50.0)      # per-sample attack
    ld = 1.0 - (1.0 - 0.01) ** (1.0 / 50.0)     # per-sample decay
    hang_n = 8 * 50
    env = maximum_filter1d(np.abs(np.asarray(x, np.float64)), size=50,
                           mode="nearest")
    g, h = 1.0, 0
    gains = np.empty(len(x))
    for i in range(len(x)):
        target = reference / max(env[i], 1e-9)
        if target < g:
            g += la * (target - g)
            h = hang_n
        elif h > 0:
            h -= 1
        else:
            g += ld * (target - g)
        g = min(max(g, 1e-6), max_gain)
        gains[i] = g
    return np.asarray(x) * gains


# ------------------------------------------------------------- comparison
def align(ref: np.ndarray, test: np.ndarray, max_lag: int = 4096):
    """Align test to ref by cross-correlation over ±max_lag; returns
    (lag, ref_trimmed, test_trimmed)."""
    n = min(len(ref), len(test))
    a = np.asarray(ref[:n], np.float64)
    b = np.asarray(test[:n], np.float64)
    if np.iscomplexobj(ref) or np.iscomplexobj(test):
        a = np.abs(np.asarray(ref[:n])).astype(np.float64)
        b = np.abs(np.asarray(test[:n])).astype(np.float64)
    lags = np.arange(-max_lag, max_lag + 1)
    center = len(a) // 2
    span = min(len(a) // 4, 50000)
    seg_a = a[center - span:center + span]
    best_lag, best = 0, -np.inf
    for lag in lags:
        seg_b = b[center - span + lag:center + span + lag]
        if len(seg_b) != len(seg_a):
            continue
        c = float(np.dot(seg_a - seg_a.mean(), seg_b - seg_b.mean()))
        denom = (np.linalg.norm(seg_a - seg_a.mean()) * np.linalg.norm(seg_b - seg_b.mean()))
        c = c / denom if denom > 0 else 0.0
        if c > best:
            best, best_lag = c, lag
    lag = best_lag
    if lag >= 0:
        r, t = ref[:n - lag], test[lag:n]
    else:
        r, t = ref[-lag:n], test[:n + lag]
    return lag, np.asarray(r), np.asarray(t)


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """SNR of the parity error: 10·log10(‖ref‖² / ‖test − ref‖²)."""
    ref = np.asarray(ref, np.complex128 if np.iscomplexobj(ref) else np.float64)
    test = np.asarray(test, np.complex128 if np.iscomplexobj(test) else np.float64)
    err = test - ref
    p_ref = float(np.real(np.vdot(ref, ref)))
    p_err = float(np.real(np.vdot(err, err)))
    if p_err == 0:
        return np.inf
    return 10.0 * np.log10(p_ref / p_err)


def gain_matched_snr_db(ref: np.ndarray, test: np.ndarray, rate: float,
                        window_s: float = 0.025) -> float:
    """SNR after fitting one least-squares gain per window — the
    AGC-insensitive parity statement: 'waveforms equal up to a slowly
    varying gain'.  Window must be longer than the AGC attack so real
    waveform distortion cannot hide inside the fitted gain."""
    wlen = max(8, int(round(window_s * rate)))
    n = (min(len(ref), len(test)) // wlen) * wlen
    r = np.asarray(ref[:n], np.float64).reshape(-1, wlen)
    t = np.asarray(test[:n], np.float64).reshape(-1, wlen)
    g = (r * t).sum(axis=1) / np.maximum((t * t).sum(axis=1), 1e-12)
    return snr_db(r.ravel(), (t * g[:, None]).ravel())


def envelope_normalize(x: np.ndarray, rate: float, tc_s: float = 0.05) -> np.ndarray:
    """Divide by a smoothed |x| envelope — makes full-chain comparisons
    insensitive to AGC gain-trajectory differences while still end-to-end."""
    alpha = 1.0 / max(1.0, tc_s * rate)
    env = signal.lfilter([alpha], [1.0, -(1.0 - alpha)], np.abs(x))
    floor = 0.05 * np.median(env) + 1e-9
    return x / np.maximum(env, floor)
