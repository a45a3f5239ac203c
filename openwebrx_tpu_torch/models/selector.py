"""Selector: per-channel tuner (shift → decimate → bandpass → squelch).

Counterpart of ``plan_decimation``, ``Selector`` and ``SecondarySelector``
in ``openwebrx_tpu/models/selector.py``.  A rate pair that is not an integer
ratio gets a fractional resampling stage after the integer decimator.
"""

from __future__ import annotations

from fractions import Fraction

from openwebrx_tpu_torch.models.stages import (
    BandpassStage, FirDecimateStage, FractionalDecimatorStage, ShiftStage,
    SquelchStage,
)
from openwebrx_tpu_torch.runtime.chain import Chain


def plan_decimation(in_rate: float, out_rate: float):
    """Integer decimation + rational cleanup stage: out/in = L/M reduced,
    the fractional stage is L/m for the smallest divisor m of M with
    m ≥ L, and the integer stage is M//m (small block LCMs)."""
    if out_rate > in_rate:
        raise ValueError(f"cannot decimate {in_rate} → {out_rate}")
    total = (Fraction(out_rate).limit_denominator(10 ** 6)
             / Fraction(in_rate).limit_denominator(10 ** 6))
    if total.denominator > 10 ** 6:
        total = total.limit_denominator(10000)
    L, M = total.numerator, total.denominator
    m = M
    d = 1
    while d * d <= M:
        if M % d == 0:
            if d >= L:
                m = min(m, d)
            if M // d >= L:
                m = min(m, M // d)
        d += 1
    return M // m, Fraction(L, m)


class Selector(Chain):
    def __init__(self, in_rate: float, out_rate: float, with_squelch: bool = True,
                 name: str = "selector"):
        self.in_rate = float(in_rate)
        self.out_rate = float(out_rate)
        d, frac = plan_decimation(in_rate, out_rate)
        self.shift = ShiftStage()
        workers = [self.shift]
        if d > 1:
            # transition 0.15·out/in, cutoff at the final output Nyquist
            workers.append(FirDecimateStage(
                d, transition_bw=0.15 * self.out_rate / self.in_rate,
                cutoff=0.5 * self.out_rate / self.in_rate))
        if frac != 1:
            workers.append(FractionalDecimatorStage(frac.numerator,
                                                    frac.denominator))
        self.bandpass = BandpassStage(-out_rate / 2 * 0.95, out_rate / 2 * 0.95)
        workers.append(self.bandpass)
        self.squelch = SquelchStage() if with_squelch else None
        if self.squelch is not None:
            workers.append(self.squelch)
        super().__init__(workers, name=name)

    # -- live controls ----------------------------------------------------
    def set_frequency_offset(self, offset_hz: float):
        self.shift.set_rate(-offset_hz / self.in_rate)

    def set_bandpass(self, low_cut_hz, high_cut_hz):
        self.bandpass.set_bandpass(low_cut_hz, high_cut_hz)

    def set_squelch_level(self, level_db):
        if self.squelch is not None:
            self.squelch.set_level(level_db)


class SecondarySelector(Chain):
    """Digimode sub-tuner inside the audio channel: shift + narrow
    bandpass."""

    def __init__(self, sample_rate: float, bandwidth: float,
                 name: str = "secondary_selector"):
        self.sample_rate = float(sample_rate)
        self.shift = ShiftStage()
        self.bandpass = BandpassStage(-bandwidth / 2, bandwidth / 2)
        super().__init__([self.shift, self.bandpass], name=name)

    def set_frequency_offset(self, offset_hz: float):
        self.shift.set_rate(-offset_hz / self.sample_rate)
