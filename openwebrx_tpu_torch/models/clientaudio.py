"""Client audio chain: (rate convert) → NR → limit → ADPCM or int16.

Counterpart of ``openwebrx_tpu/models/clientaudio.py``.  Integer-ratio
rate conversion is ported; a fractional one raises NotImplementedError.
"""

from __future__ import annotations

from fractions import Fraction

from openwebrx_tpu_torch.models.stages import (
    AdpcmEncodeStage, FirDecimateStage, FloatToShortStage, LimitStage,
    NoiseFilterStage,
)
from openwebrx_tpu_torch.runtime.chain import Chain


class ClientAudioChain(Chain):
    def __init__(self, in_rate: float, audio_rate: float, compression: str = "adpcm",
                 name: str = "client_audio"):
        self.in_rate = float(in_rate)
        self.audio_rate = float(audio_rate)
        self.compression = compression
        workers = []
        if in_rate != audio_rate:
            frac = Fraction(int(audio_rate), int(in_rate))
            if frac.numerator != 1:
                raise NotImplementedError(
                    f"audio {in_rate} → {audio_rate} needs fractional "
                    "resampling, which the port does not have yet "
                    "(ROADMAP.md Queue 1: fir.resample_apply)")
            workers.append(FirDecimateStage(frac.denominator,
                                            transition_bw=0.15 * frac.denominator ** -1))
        self.noise_filter = NoiseFilterStage()
        workers.append(self.noise_filter)
        workers.append(LimitStage())
        if compression == "adpcm":
            workers.append(AdpcmEncodeStage())
        else:
            workers.append(FloatToShortStage())
        super().__init__(workers, name=name)
