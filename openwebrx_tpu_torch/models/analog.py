"""Analog demodulator chains: AM, raw AM, NFM, WFM, SSB, sync AM, empty.

Counterpart of ``openwebrx_tpu/models/analog.py``: each chain declares its
IF-rate policy (a fixed IF rate, a fixed audio rate, or the audio rate).
"""

from __future__ import annotations

from fractions import Fraction

from openwebrx_tpu_torch.models.stages import (
    AgcStage, AmDemodStage, DcBlockStage, DeemphasisStage, FmDemodStage,
    FractionalDecimatorStage, GainStage, LimitStage, RdsTapStage,
    RealPartStage, SyncAmStage,
)
from openwebrx_tpu_torch.ops import agc
from openwebrx_tpu_torch.runtime.chain import Chain

# de-emphasis time constants (50 µs EU / 75 µs US for WFM; NFM shorter)
NFM_TAU = 150e-6
WFM_TAU = 50e-6


class BaseDemodulatorChain(Chain):
    """IF/audio rate policy flags."""

    fixed_if_rate: float | None = None
    fixed_audio_rate: float | None = None

    def get_if_rate(self, audio_rate: float) -> float:
        return self.fixed_if_rate or audio_rate

    def supports_squelch(self) -> bool:
        return True


class Am(BaseDemodulatorChain):
    """AmDemod → DcBlock → SLOW AGC."""

    def __init__(self, name: str = "am"):
        super().__init__([AmDemodStage(), DcBlockStage(), AgcStage(agc.SLOW)],
                         name=name)


class RawAm(BaseDemodulatorChain):
    """AmDemod → SLOW AGC, no DC block (the carrier level is kept)."""

    def __init__(self, name: str = "raw_am"):
        super().__init__([AmDemodStage(), AgcStage(agc.SLOW)], name=name)


class NFm(BaseDemodulatorChain):
    """FmDemod → Limit → de-emphasis → FAST AGC, at an IF of at least
    48 kHz."""

    def __init__(self, if_rate: float = 48000, name: str = "nfm"):
        self._if_rate = float(if_rate)
        super().__init__([
            FmDemodStage(),
            LimitStage(),
            DeemphasisStage(NFM_TAU, name="nfm_deemphasis"),
            AgcStage(agc.FAST),
        ], name=name)

    def get_if_rate(self, audio_rate: float) -> float:
        return max(self._if_rate, audio_rate)


class WFm(BaseDemodulatorChain):
    """FmDemod → Limit → [RdsTap] → fractional resampler (IF → audio) →
    de-emphasis, at a fixed 250 kHz IF.  The RDS tap emits the 57 kHz
    subcarrier as a decimated complex aux stream for the host decoder."""

    fixed_if_rate = 250000.0

    def __init__(self, audio_rate: float = 48000, tau: float = WFM_TAU,
                 rds: bool = True, name: str = "wfm"):
        frac = Fraction(int(audio_rate), int(self.fixed_if_rate))
        stages = [FmDemodStage(), LimitStage()]
        if rds:
            stages.append(RdsTapStage())
        stages += [
            FractionalDecimatorStage(frac.numerator, frac.denominator),
            DeemphasisStage(tau, name="wfm_deemphasis"),
        ]
        super().__init__(stages, name=name)
        self.fixed_audio_rate = float(audio_rate)


class Ssb(BaseDemodulatorChain):
    """RealPart → ×2 → SLOW AGC; the Selector's asymmetric bandpass has
    already picked the sideband."""

    def __init__(self, name: str = "ssb"):
        super().__init__([RealPartStage(), GainStage(2.0), AgcStage(agc.SLOW)],
                         name=name)


class SAm(BaseDemodulatorChain):
    """Synchronous AM: carrier-locked coherent detector → DcBlock → SLOW
    AGC."""

    def __init__(self, name: str = "sam"):
        super().__init__([SyncAmStage(), DcBlockStage(), AgcStage(agc.SLOW)],
                         name=name)


class Empty(BaseDemodulatorChain):
    """Pass-through placeholder."""

    def __init__(self, name: str = "empty"):
        super().__init__([], name=name)
