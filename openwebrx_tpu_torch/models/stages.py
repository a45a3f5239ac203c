"""Stage wrappers for the DSP ops of the analog chains.

Counterpart of ``openwebrx_tpu/models/stages.py``: the stages of every
analog demodulator chain and the waterfall, with the same control surface
(live setters bump the params version) and the same block negotiation:
every stage declares ``ratio()`` and ``divisor()`` and
``plan_block_size`` picks the smallest block of about a target duration
that keeps every stage's shapes integral.
"""

from __future__ import annotations

from fractions import Fraction
from math import gcd

import numpy as np
import torch

from openwebrx_tpu_torch.ops import (adpcm, agc, bandpass, convert, demod,
                                     fftops, fir, firdes, iir, nco,
                                     noisefilter, squelch)
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.chain import Chain, Stage, digest


def best_chunk(block: int, target: int) -> int:
    """The divisor of ``block`` closest (log-scale) to ``target``: the soft
    cadence of squelch windows, AGC chunks and NR hops, adapted to the
    planned block instead of constraining it."""
    block = int(block)
    target = max(1, int(target))
    divs = []
    d = 1
    while d * d <= block:
        if block % d == 0:
            divs.append(d)
            divs.append(block // d)
        d += 1
    return min(divs, key=lambda v: abs(np.log(v / target)))


class OpStage(Stage):
    """Base with ratio/divisor defaults."""

    def ratio(self, in_spec: StreamSpec) -> Fraction:
        return Fraction(1)

    def divisor(self, in_spec: StreamSpec) -> int:
        return 1

    def apply(self, state, params, x):
        raise NotImplementedError

    def plan(self, in_spec: StreamSpec, block: int):
        self.in_spec = in_spec
        self.block = block
        r = self.ratio(in_spec)
        out_block = block * r
        if out_block.denominator != 1:
            raise ValueError(f"{self.label}: block {block} × ratio {r} not integral")
        return self._out_spec(in_spec), int(out_block)

    def _out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        return in_spec


# ------------------------------------------------------------------ shift --
class ShiftStage(OpStage):
    """NCO mixer; the rate is a live, per-channel control."""

    def __init__(self, rate=0.0, name: str = "shift"):
        self.name = name
        self._rate = rate

    def set_rate(self, rate):
        """Scalar or per-channel array of normalized rates."""
        self._rate = rate
        self._bump()

    def init_state(self, batch_shape, device):
        return nco.shift_init(batch_shape, device)

    def params(self, device):
        # host float64 → int32 fixed point: exact phase accumulation
        return torch.as_tensor(nco.rate_to_fixed(self._rate), device=device)

    def apply(self, state, params, x):
        state, y = nco.shift_apply(state, params, x)
        return state, y, {}

    def signature(self):
        return ("shift",)


# -------------------------------------------------------------- decimator --
class FirDecimateStage(OpStage):
    """Integer FIR decimation."""

    def __init__(self, decimation: int, transition_bw: float = 0.05,
                 cutoff: float | None = None, taps=None,
                 name: str = "fir_decimate"):
        self.name = name
        self.decimation = int(decimation)
        self.transition_bw = float(transition_bw)
        if taps is not None:
            self.taps = taps
        else:
            cutoff = cutoff if cutoff is not None else 0.5 / self.decimation - transition_bw / 2
            self.taps = firdes.lowpass_taps(max(cutoff, 1e-4), transition_bw)

    def ratio(self, in_spec):
        return Fraction(1, self.decimation)

    def divisor(self, in_spec):
        return self.decimation

    def _out_spec(self, in_spec):
        return in_spec.with_rate(in_spec.rate / self.decimation)

    def init_state(self, batch_shape, device):
        return fir.fir_init(len(self.taps), batch_shape,
                            complex_input=self.in_spec.format.is_complex,
                            device=device)

    def params(self, device):
        # the taps are a design-time constant; shipping them as a param
        # keeps the per-block path free of host→device copies
        return torch.as_tensor(self.taps, device=device)

    def apply(self, state, params, x):
        state, y = fir.fir_apply(state, params, x, self.decimation)
        return state, y, {}

    def signature(self):
        return ("fir_decimate", self.decimation, digest(self.taps))


class FractionalDecimatorStage(OpStage):
    """Rational L/M resampling as one polyphase strided conv."""

    def __init__(self, interpolation: int, decimation: int,
                 transition_bw: float | None = None, taps=None,
                 name: str = "fractional"):
        self.name = name
        self.interpolation = int(interpolation)
        self.decimation = int(decimation)
        if taps is None:
            # anti-alias at the upsampled rate: cutoff 0.5/max(L,M)
            cut = 0.45 / max(self.interpolation, self.decimation)
            tbw = transition_bw if transition_bw is not None else cut * 0.3
            taps = firdes.lowpass_taps(cut, tbw) * self.interpolation
        self.bank, self.tail_len, self.delay_groups = fir.polyphase_bank(
            taps, self.interpolation, self.decimation)

    def ratio(self, in_spec):
        return Fraction(self.interpolation, self.decimation)

    def divisor(self, in_spec):
        return self.decimation

    def _out_spec(self, in_spec):
        return in_spec.with_rate(in_spec.rate * self.interpolation
                                 / self.decimation)

    def init_state(self, batch_shape, device):
        return fir.resample_init(self.tail_len, batch_shape,
                                 complex_input=self.in_spec.format.is_complex,
                                 device=device)

    def params(self, device):
        return torch.as_tensor(self.bank, device=device)

    def apply(self, state, params, x):
        state, y = fir.resample_apply(state, params, x, self.interpolation,
                                      self.decimation)
        return state, y, {}

    def signature(self):
        return ("fractional", self.interpolation, self.decimation,
                digest(self.bank))


# --------------------------------------------------------------- bandpass --
class BandpassStage(OpStage):
    """Live-tunable FFT bandpass (transition 320 Hz at the stage's rate)."""

    def __init__(self, low_cut_hz=0.0, high_cut_hz=0.0, name: str = "bandpass"):
        self.name = name
        self._low = np.asarray(low_cut_hz, np.float64)
        self._high = np.asarray(high_cut_hz, np.float64)
        self._response = None
        self._response_dev = None

    def set_bandpass(self, low_cut_hz, high_cut_hz):
        """Scalars (shared) or per-channel arrays.  No-op when the edges
        equal the current ones: a bank pushes all its control arrays on any
        change, and redesigning an unchanged (C, nfft) response is costly."""
        # copies: banks mutate their control arrays in place and re-push
        low = np.array(low_cut_hz, np.float64, copy=True)
        high = np.array(high_cut_hz, np.float64, copy=True)
        if (low.shape == self._low.shape and high.shape == self._high.shape
                and np.array_equal(low, self._low)
                and np.array_equal(high, self._high)):
            return
        self._low = low
        self._high = high
        self._bump()
        if hasattr(self, "in_spec"):  # pre-plan: plan() will compute it
            self._recompute()

    def set_slot_bandpass(self, slot: int, low_cut_hz: float,
                          high_cut_hz: float):
        """One channel's passband in a per-channel bandpass."""
        lo, hi = np.array(self._low, copy=True), np.array(self._high, copy=True)
        lo[slot], hi[slot] = low_cut_hz, high_cut_hz
        self.set_bandpass(lo, hi)

    def plan(self, in_spec, block):
        self.transition = 320.0 / in_spec.rate
        self.ntaps = firdes.bandpass_ntaps(self.transition)
        self.nfft = bandpass.plan_nfft(self.ntaps, block)
        out = super().plan(in_spec, block)
        self._recompute()
        return out

    def _recompute(self):
        rate = self.in_spec.rate
        lo = np.clip(np.atleast_1d(self._low) / rate, -0.4999, 0.4999)
        hi = np.clip(np.atleast_1d(self._high) / rate,
                     lo + self.transition, 0.49999)
        rows = firdes.bandpass_response_batch(lo, hi, self.transition,
                                              self.nfft)
        self._response = rows[0] if self._low.ndim == 0 else rows
        self._response_dev = None        # device copy, rebuilt lazily

    def init_state(self, batch_shape, device):
        return bandpass.bandpass_init(self.ntaps, batch_shape, device)

    def params(self, device):
        # cached on the device: (C, nfft) complex64 is large for big banks
        if self._response_dev is None or self._response_dev.device != device:
            self._response_dev = torch.as_tensor(self._response, device=device)
        return self._response_dev

    def apply(self, state, params, x):
        state, y = bandpass.bandpass_apply(state, params, x, self.ntaps,
                                           self.nfft)
        return state, y, {}

    def signature(self):
        return ("bandpass", self.ntaps, self.nfft)


# ---------------------------------------------------------------- squelch --
class SquelchStage(OpStage):
    """Power squelch + s-meter tap (16 measurements/s, soft cadence)."""

    MEASUREMENTS_PER_S = 16

    def __init__(self, level_db=-150.0, name: str = "squelch"):
        self.name = name
        self._level = level_db

    def set_level(self, level_db):
        """Scalar or per-channel array of thresholds (dB)."""
        self._level = level_db
        self._bump()

    def plan(self, in_spec, block):
        self.window = best_chunk(
            block, int(round(in_spec.rate / self.MEASUREMENTS_PER_S)))
        return super().plan(in_spec, block)

    def init_state(self, batch_shape, device):
        return squelch.squelch_init(batch_shape, device)

    def params(self, device):
        # a copy: banks rewrite their level arrays in place
        return torch.tensor(np.asarray(self._level, np.float32), device=device)

    def apply(self, state, params, x):
        state, y, power_db = squelch.squelch_apply(state, params, x, self.window)
        return state, y, {"power_db": power_db}

    def signature(self):
        return ("squelch", self.window)


# ----------------------------------------------------------------- demods --
class FmDemodStage(OpStage):
    """Quadrature FM discriminator."""

    name = "fm_demod"

    def _out_spec(self, in_spec):
        return in_spec.with_format(Format.FLOAT)

    def init_state(self, batch_shape, device):
        return demod.fm_init(batch_shape, device)

    def apply(self, state, params, x):
        state, y = demod.fm_demod(state, x)
        return state, y, {}

    def signature(self):
        return ("fm_demod",)


class AmDemodStage(OpStage):
    """Envelope detector."""

    name = "am_demod"

    def _out_spec(self, in_spec):
        return in_spec.with_format(Format.FLOAT)

    def apply(self, state, params, x):
        return state, demod.am_demod(x), {}

    def signature(self):
        return ("am_demod",)


class SyncAmStage(OpStage):
    """Carrier-locked AM (block-wise carrier estimate)."""

    name = "sync_am"

    def _out_spec(self, in_spec):
        return in_spec.with_format(Format.FLOAT)

    def init_state(self, batch_shape, device):
        return demod.sync_am_init(batch_shape, device)

    def apply(self, state, params, x):
        state, y = demod.sync_am_demod(state, x)
        return state, y, {}

    def signature(self):
        return ("sync_am",)


class RealPartStage(OpStage):
    """SSB detector."""

    name = "real_part"

    def _out_spec(self, in_spec):
        return in_spec.with_format(Format.FLOAT)

    def apply(self, state, params, x):
        return state, demod.real_part(x), {}

    def signature(self):
        return ("real_part",)


class LimitStage(OpStage):
    """Clipper."""

    name = "limit"

    def __init__(self, max_amplitude: float = 1.0):
        self.max_amplitude = float(max_amplitude)

    def apply(self, state, params, x):
        return state, demod.limit(x, self.max_amplitude), {}

    def signature(self):
        return ("limit", self.max_amplitude)


class GainStage(OpStage):
    name = "gain"

    def __init__(self, g: float):
        self._g = float(g)

    def set_gain(self, g: float):
        self._g = float(g)
        self._bump()

    def params(self, device):
        return self._g          # a Python scalar: no device copy per block

    def apply(self, state, params, x):
        return state, demod.gain(x, params), {}

    def signature(self):
        return ("gain",)


# ---------------------------------------------------------------- IIR-ish --
class DcBlockStage(OpStage):
    """Single-pole DC blocker."""

    name = "dc_block"

    def plan(self, in_spec, block):
        self.coeffs = iir.dc_block_coeffs(in_spec.rate)
        return super().plan(in_spec, block)

    def init_state(self, batch_shape, device):
        return iir.first_order_init(batch_shape, device)

    def apply(self, state, params, x):
        b0, b1, a1 = self.coeffs
        state, y = iir.first_order_apply(state, b0, b1, a1, x, device=x.device)
        return state, y, {}

    def signature(self):
        return ("dc_block", self.coeffs)


class DeemphasisStage(OpStage):
    """One-pole de-emphasis with time constant ``tau``."""

    def __init__(self, tau: float, name: str = "deemphasis"):
        self.name = name
        self.tau = float(tau)

    def plan(self, in_spec, block):
        self.coeffs = iir.deemphasis_coeffs(in_spec.rate, self.tau)
        return super().plan(in_spec, block)

    def init_state(self, batch_shape, device):
        return iir.first_order_init(batch_shape, device)

    def apply(self, state, params, x):
        b0, b1, a1 = self.coeffs
        state, y = iir.first_order_apply(state, b0, b1, a1, x, device=x.device)
        return state, y, {}

    def signature(self):
        return ("deemphasis", self.coeffs)


class AgcStage(OpStage):
    """Chunked AGC (FAST/SLOW profiles)."""

    def __init__(self, profile: agc.AgcProfile = agc.FAST, name: str = "agc"):
        self.name = name
        self.profile = profile
        self.chunk = agc.CHUNK

    def plan(self, in_spec, block):
        self.chunk = best_chunk(block, agc.CHUNK)
        return super().plan(in_spec, block)

    def init_state(self, batch_shape, device):
        return agc.agc_init(self.profile, batch_shape, device)

    def apply(self, state, params, x):
        state, y = agc.agc_apply(state, self.profile, x, self.chunk,
                                 device=x.device)
        return state, y, {}

    def signature(self):
        return ("agc", self.profile, self.chunk)


# -------------------------------------------------------------- waterfall --
class WaterfallStage(OpStage):
    """Fft → LogAveragePower → FftSwap.  Terminal stage: y is (...,
    rows, fft_size) float32 dB rows, or with ``compress`` their ADPCM wire
    bytes, (..., rows, padded bytes) uint8, whose first
    ``wire_bytes_per_row`` bytes a row are the payload.  Any block size
    works: plan() fixes rows per block ≈ fps·block/rate and spaces the
    averaged frames uniformly inside the block."""

    def __init__(self, fft_size: int, fps: float, add_db: float = -70.0,
                 overlap_factor: float = 0.3, name: str = "waterfall",
                 compress: bool = False):
        self.name = name
        self.fft_size = int(fft_size)
        self.fps = float(fps)
        self.add_db = float(add_db)
        self.overlap_factor = overlap_factor
        # compress: dB×100 int16 rows, 10 pad samples, exact IMA from a
        # fresh codec per row (the client resets its codec per message)
        self.compress = bool(compress)
        self.wire_bytes_per_row = adpcm.wire_bytes_per_row(self.fft_size)
        self._window_dev = None
        self._codec0 = None

    def plan(self, in_spec, block):
        self.in_spec = in_spec
        self.block = block
        self.rows = max(1, round(self.fps * block / in_spec.rate))
        # average as many whole frames per row as fit
        self.averages = max(1, block // (self.fft_size * self.rows))
        nframes = self.rows * self.averages
        stride = block // nframes
        self.ends = ((np.arange(nframes) + 1) * stride).astype(np.int64)
        self.window = fftops.hann_window(self.fft_size)
        out_rate = in_spec.rate * self.rows / block
        return in_spec.with_format(Format.FLOAT).with_rate(out_rate), self.rows

    def _out_spec(self, in_spec):
        return in_spec.with_format(Format.FLOAT)

    def init_state(self, batch_shape, device):
        return fftops.fft_init(self.fft_size, self.fft_size, batch_shape, device)

    def params(self, device):
        # the window is a design-time constant, kept on the device
        if self._window_dev is None or self._window_dev.device != device:
            self._window_dev = torch.as_tensor(self.window, device=device)
        return self._window_dev

    def apply(self, state, params, x):
        state, p = fftops.fft_power_at(state, params, x, self.fft_size,
                                       self.ends)
        rows = fftops.fft_swap(fftops.log_average(p, self.averages,
                                                  self.add_db))
        if not self.compress:
            return state, rows, {}
        s = adpcm.fft_row_samples(rows)
        lead = tuple(s.shape[:-1])
        # the fresh codec state of every row, kept: the encoder only reads
        # it, and making it anew costs two launches a block
        if (self._codec0 is None or tuple(self._codec0[0].shape) != lead
                or self._codec0[0].device != s.device):
            self._codec0 = adpcm.adpcm_init(lead, device=s.device)
        _, (bytes_, _) = adpcm.adpcm_encode_seq(self._codec0, s)
        return state, bytes_, {}

    def signature(self):
        return ("waterfall", self.fft_size, self.rows, self.averages,
                self.add_db, self.compress)


# ------------------------------------------------------------------- rds --
class RdsTapStage(OpStage):
    """Pass-through RDS tap inside the WFM chain: the 57 kHz subcarrier of
    the FM composite is mixed to baseband, low-passed and decimated by 16
    for the whole channel batch, and emitted as the ``rds`` aux output
    (complex64, rate/16); the composite passes through unchanged."""

    DECIMATION = 16

    def __init__(self, name: str = "rds_tap"):
        self.name = name

    def divisor(self, in_spec):
        return self.DECIMATION

    def plan(self, in_spec, block):
        out = super().plan(in_spec, block)
        # ±3 kHz around the subcarrier holds the ±2.4 kHz RDS spectrum
        self.taps = firdes.lowpass_taps(3000.0 / in_spec.rate,
                                        2400.0 / in_spec.rate)
        self.rate_fixed = nco.rate_to_fixed(-57000.0 / in_spec.rate)
        return out

    def init_state(self, batch_shape, device):
        return (nco.shift_init(batch_shape, device),
                fir.fir_init(len(self.taps), batch_shape, complex_input=True,
                             device=device))

    def params(self, device):
        # design-time constants, shipped as params like the FIR's taps
        return (torch.as_tensor(self.rate_fixed, device=device),
                torch.as_tensor(self.taps, device=device))

    def apply(self, state, params, x):
        phase, tail = state
        rate, taps = params
        phase, mixed = nco.shift_apply(phase, rate, x.to(torch.complex64))
        tail, bb = fir.fir_apply(tail, taps, mixed, self.DECIMATION)
        return (phase, tail), x, {"rds": bb}

    def signature(self):
        return ("rds_tap", self.DECIMATION, digest(self.taps))


# ------------------------------------------------------------ client audio --
class NoiseFilterStage(OpStage):
    """Spectral NR; the threshold is a per-channel param (≤ −100 dB is
    practically a passthrough)."""

    name = "noise_filter"

    def __init__(self, threshold_db=-100.0):
        self._threshold = threshold_db
        self.hop = noisefilter.DEFAULT_HOP   # plan() adapts to the block

    def set_threshold(self, threshold_db):
        """Scalar or per-channel array (dB)."""
        self._threshold = threshold_db
        self._bump()

    def plan(self, in_spec, block):
        self.hop = best_chunk(block, noisefilter.DEFAULT_HOP)
        return super().plan(in_spec, block)

    def init_state(self, batch_shape, device):
        return noisefilter.nr_init(batch_shape, self.hop, device)

    def params(self, device):
        # a copy: banks rewrite their threshold arrays in place
        return torch.tensor(np.asarray(self._threshold, np.float32),
                            device=device)

    def apply(self, state, params, x):
        state, y = noisefilter.nr_apply(state, params, x, self.hop)
        return state, y, {}

    def signature(self):
        return ("noise_filter", self.hop)


class AdpcmEncodeStage(OpStage):
    """IMA ADPCM encode.  Input float [−1, 1]; output y is (bytes uint8
    (..., B/2), stride_states int32 (..., B/(2·STRIDE))), the packed reseed
    state at every STATE_STRIDE-th byte, which the host SyncFramer needs."""

    name = "adpcm"

    def divisor(self, in_spec):
        return 2 * adpcm.STATE_STRIDE

    def ratio(self, in_spec):
        return Fraction(1, 2)

    def _out_spec(self, in_spec):
        return in_spec.with_format(Format.CHAR).with_rate(in_spec.rate / 2)

    def init_state(self, batch_shape, device):
        return adpcm.adpcm_init(batch_shape, device)

    def apply(self, state, params, x):
        state, out = adpcm.adpcm_encode(state, convert.float_to_short(x))
        return state, out, {}

    def signature(self):
        return ("adpcm_encode",)


class FloatToShortStage(OpStage):
    """Float → int16 audio."""

    name = "to_short"

    def _out_spec(self, in_spec):
        return in_spec.with_format(Format.SHORT)

    def apply(self, state, params, x):
        return state, convert.float_to_short(x), {}

    def signature(self):
        return ("to_short",)


# ------------------------------------------------------- block size helper --
def _flatten(stage) -> list:
    if isinstance(stage, Chain):
        out = []
        for w in stage.workers:
            out.extend(_flatten(w))
        return out
    return [stage]


def block_requirement(stages_or_chain, in_spec: StreamSpec) -> int:
    """The divisor every block size must be a multiple of for this chain:
    a stage at cumulative ratio r requiring its input divisible by d needs
    block a multiple of denominator(r/d)."""
    if isinstance(stages_or_chain, Chain):
        stages = _flatten(stages_or_chain)
    else:
        stages = [s for w in stages_or_chain for s in _flatten(w)]
    req = 1
    r = Fraction(1)
    spec = in_spec
    for s in stages:
        d = s.divisor(spec)
        den = (r / d).denominator
        req = req * den // gcd(req, den)
        r *= s.ratio(spec)
        spec = s._out_spec(spec)
    return req


def plan_block_size(stages_or_chain, in_spec: StreamSpec, target_seconds: float,
                    extra_requirement: int = 1) -> int:
    """Smallest block ≈ target_seconds·rate satisfying the chain's (and any
    extra) divisibility requirements."""
    req = block_requirement(stages_or_chain, in_spec)
    req = req * extra_requirement // gcd(req, extra_requirement)
    want = max(1, int(round(in_spec.rate * target_seconds)))
    return ((want + req - 1) // req) * req
