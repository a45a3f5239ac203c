"""Digital-voice symbol front ends: DMR / YSF / D-Star / NXDN / M17.

Counterpart of ``Fsk4SliceStage``, ``DvSymbolChain``, ``DV_FACTORY`` and
``DV_DECODERS`` in ``openwebrx_tpu/models/digital_voice.py``: everything up
to the dibit stream is batched device DSP (discriminator, DC block, RRC
matched filter, feedforward timing recovery, adaptive 4FSK slicer); the
protocol frame decode and the vocoder stay outside, consuming one uint8
dibit per symbol.
All modes run a 48 kHz complex IF: 4800 baud → 10 samples/symbol, NXDN's
2400 baud → 20.
"""

from __future__ import annotations

import numpy as np
import torch

from openwebrx_tpu_torch.models.secondary import (
    AuxWaterfallStage, RealToComplexStage, TimingRecoveryStage,
)
from openwebrx_tpu_torch.models.selector import Selector
from openwebrx_tpu_torch.models.stages import (
    DcBlockStage, FirDecimateStage, FmDemodStage, OpStage,
)
from openwebrx_tpu_torch.ops import firdes, fsk
from openwebrx_tpu_torch.ops.formats import Format
from openwebrx_tpu_torch.runtime.chain import Chain

DV_IF_RATE = 48000.0


class Fsk4SliceStage(OpStage):
    """Terminal: complex symbol samples → real part → dibits (uint8)."""

    name = "fsk4_slice"

    def _out_spec(self, in_spec):
        return in_spec.with_format(Format.CHAR)

    def apply(self, state, params, x):
        return state, fsk.fsk4_slice(x.real.to(torch.float32)), {}

    def signature(self):
        return ("fsk4_slice",)


class DvSymbolChain(Chain):
    """Device IQ → dibit stream for one digital-voice mode."""

    def __init__(self, in_rate: float, baud: float = 4800.0,
                 rrc_alpha: float = 0.2, bandwidth: float = 6250.0,
                 name: str = "dv"):
        self.baud = baud
        sps = int(round(DV_IF_RATE / baud))
        self.selector = Selector(in_rate, DV_IF_RATE, with_squelch=False)
        # the mode's channel bandpass also keeps out-of-channel energy
        # away from the discriminator and the timing estimator
        self.selector.set_bandpass(-bandwidth, bandwidth)
        rrc = firdes.root_raised_cosine_taps(sps, rrc_alpha).astype(np.float32)
        super().__init__([
            self.selector,
            AuxWaterfallStage(),
            FmDemodStage(),
            DcBlockStage(),
            RealToComplexStage(),
            FirDecimateStage(1, taps=rrc, name="dv_rrc"),
            TimingRecoveryStage(sps=sps),
            Fsk4SliceStage(),
        ], name=name)

    def set_frequency_offset(self, offset_hz: float):
        self.selector.set_frequency_offset(offset_hz)

    def set_carrier(self, carrier_hz: float):
        pass  # DV modes are channelized; no fine cursor


# mode → chain factory (baud, RRC roll-off, channel half-width)
DV_FACTORY = {
    "dmr": lambda in_rate: DvSymbolChain(in_rate, 4800.0, 0.2, 6250.0, name="dmr"),
    "ysf": lambda in_rate: DvSymbolChain(in_rate, 4800.0, 0.2, 6250.0, name="ysf"),
    "dstar": lambda in_rate: DvSymbolChain(in_rate, 4800.0, 0.5, 3250.0, name="dstar"),
    "nxdn": lambda in_rate: DvSymbolChain(in_rate, 2400.0, 0.2, 3250.0, name="nxdn"),
    "m17": lambda in_rate: DvSymbolChain(in_rate, 4800.0, 0.5, 4500.0, name="m17"),
}

# mode → frame decoder + vocoder command (digiham binaries); {meta_fd} is
# substituted by the subprocess pipeline when a metadata callback is
# attached
DV_DECODERS = {
    "dmr": ["dmr_decoder", "--fifo", "/dev/fd/{meta_fd}"],
    "ysf": ["ysf_decoder", "--fifo", "/dev/fd/{meta_fd}"],
    "dstar": ["dstar_decoder", "--fifo", "/dev/fd/{meta_fd}"],
    "nxdn": ["nxdn_decoder", "--fifo", "/dev/fd/{meta_fd}"],
}
