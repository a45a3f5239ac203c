"""Client audio chain: (rate convert) → NR → limit → ADPCM or int16.

Counterpart of ``openwebrx_tpu/models/clientaudio.py``: an integer-ratio
rate conversion is a FIR decimator, any other a fractional resampler.
"""

from __future__ import annotations

from fractions import Fraction

from openwebrx_tpu_torch.models.stages import (
    AdpcmEncodeStage, FirDecimateStage, FloatToShortStage,
    FractionalDecimatorStage, LimitStage, NoiseFilterStage,
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
            if frac.numerator == 1:
                workers.append(FirDecimateStage(
                    frac.denominator,
                    transition_bw=0.15 * frac.denominator ** -1))
            else:
                workers.append(FractionalDecimatorStage(frac.numerator,
                                                        frac.denominator))
        self.noise_filter = NoiseFilterStage()
        workers.append(self.noise_filter)
        workers.append(LimitStage())
        if compression == "adpcm":
            workers.append(AdpcmEncodeStage())
        else:
            workers.append(FloatToShortStage())
        super().__init__(workers, name=name)
