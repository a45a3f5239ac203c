"""WEFAX (radiofax) and SSTV demodulator chain.

Counterpart of ``openwebrx_tpu/models/fax.py``: the chain recovers the
subcarrier's instantaneous frequency (1900 Hz ± 400 Hz over USB, 1500
black … 2300 white); the host maps frequency to brightness, finds the line
phasing and assembles the image.
"""

from __future__ import annotations

from openwebrx_tpu_torch.models.secondary import (
    AuxWaterfallStage, IF_RATE, RealToComplexStage,
)
from openwebrx_tpu_torch.models.selector import Selector
from openwebrx_tpu_torch.models.stages import (
    BandpassStage, FirDecimateStage, FmDemodStage, ShiftStage,
)
from openwebrx_tpu_torch.runtime.chain import Chain

CARRIER_HZ = 1900.0
DEVIATION_HZ = 400.0
PIXEL_RATE = 3000.0   # output sample rate (≈ pixels/s before line scaling)


class FaxChain(Chain):
    """Selector → shift(carrier) → bandpass → FM discriminator → decimate.

    y: float at PIXEL_RATE, the instantaneous frequency offset normalized
    to IF_RATE/2, so ±DEVIATION maps to ±DEVIATION/(IF_RATE/2).
    """

    def __init__(self, in_rate: float, carrier_hz: float = CARRIER_HZ,
                 deviation_hz: float = DEVIATION_HZ, name: str = "fax"):
        decim = int(round(IF_RATE / PIXEL_RATE))
        self.selector = Selector(in_rate, IF_RATE, with_squelch=False)
        self.fine_shift = ShiftStage(rate=-carrier_hz / IF_RATE,
                                     name="fax_carrier_shift")
        self.bandpass = BandpassStage(-(deviation_hz + 250), deviation_hz + 250,
                                      name="fax_bandpass")
        super().__init__([
            self.selector,
            AuxWaterfallStage(),
            self.fine_shift,
            self.bandpass,
            FmDemodStage(),
            RealToComplexStage(),   # the complex decimator machinery
            FirDecimateStage(decim, transition_bw=0.2 / decim, name="fax_decim"),
        ], name=name)

    def set_frequency_offset(self, offset_hz: float):
        self.selector.set_frequency_offset(offset_hz)

    def set_carrier(self, carrier_hz: float):
        self.fine_shift.set_rate(-carrier_hz / IF_RATE)
