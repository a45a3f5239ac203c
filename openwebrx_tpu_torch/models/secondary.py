"""Secondary (digimode) demodulator chains: PSK31/63, RTTY, CW, the CW
skimmer, and the FAX/SSTV chain's factory entries.

Counterpart of ``openwebrx_tpu/models/secondary.py``.  Each chain runs the
whole path from device IQ (a Selector to a 12 kHz complex IF, then the
mode's narrowband stages) so digimode listeners batch as audio listeners
do; the bits-to-text decode stays on the host, fed from the fixed-shape
symbol and envelope outputs of these chains.  Every chain emits the
secondary waterfall's rows as the aux ``secondary_fft.rows``.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from openwebrx_tpu_torch.models.selector import Selector
from openwebrx_tpu_torch.models.stages import (
    BandpassStage, FirDecimateStage, FmDemodStage, OpStage, ShiftStage,
    WaterfallStage,
)
from openwebrx_tpu_torch.ops import fftops, timing
from openwebrx_tpu_torch.ops.formats import Format
from openwebrx_tpu_torch.runtime.chain import Chain

IF_RATE = 12000.0


class TimingRecoveryStage(OpStage):
    """Feedforward symbol recovery (terminal): y = symbols (..., B/sps)."""

    name = "timing_recovery"

    def __init__(self, sps: int = timing.SPS):
        self.sps = int(sps)

    def divisor(self, in_spec):
        return self.sps

    def ratio(self, in_spec):
        return Fraction(1, self.sps)

    def _out_spec(self, in_spec):
        return in_spec.with_rate(in_spec.rate / self.sps)

    def init_state(self, batch_shape, device):
        return timing.timing_init(batch_shape, self.sps, device)

    def apply(self, state, params, x):
        state, symbols = timing.recover(state, x, self.sps)
        return state, symbols, {}

    def signature(self):
        return ("timing_recovery", self.sps)


class AuxWaterfallStage(OpStage):
    """Pass-through stage emitting waterfall rows of its input as the aux
    ``rows``: the secondary FFT shown above digimode panels."""

    name = "secondary_fft"

    def __init__(self, fft_size: int = 2048, fps: float = 9.0):
        self.waterfall = WaterfallStage(fft_size, fps, name="secondary_fft_inner")

    def plan(self, in_spec, block):
        self.waterfall.plan(in_spec, block)
        self.in_spec = in_spec
        self.block = block
        return in_spec, block

    def init_state(self, batch_shape, device):
        return self.waterfall.init_state(batch_shape, device)

    def params(self, device):
        return self.waterfall.params(device)

    def apply(self, state, params, x):
        state, rows, _ = self.waterfall.apply(state, params, x)
        return state, x, {"rows": rows}

    def signature(self):
        return ("aux_waterfall",) + self.waterfall.signature()


class RealToComplexStage(OpStage):
    """Real → complex (reuses the complex machinery on real streams)."""

    name = "real_to_complex"

    def _out_spec(self, in_spec):
        return in_spec.with_format(Format.COMPLEX_FLOAT)

    def apply(self, state, params, x):
        return state, x.to(torch.complex64), {}

    def signature(self):
        return ("real_to_complex",)


class EnvelopeStage(OpStage):
    """|x| (the keying envelope for CW)."""

    name = "envelope"

    def _out_spec(self, in_spec):
        return in_spec.with_format(Format.FLOAT)

    def apply(self, state, params, x):
        return state, x.abs().to(torch.float32), {}

    def signature(self):
        return ("envelope",)


class PskChain(Chain):
    """PSK31/63 from device IQ: Selector → shift(carrier) → bandpass →
    decimate to 4 samples/symbol → timing recovery.  y is the complex
    symbols; the host does DBPSK and varicode."""

    def __init__(self, in_rate: float, baud: float = 31.25, name: str = "psk"):
        self.baud = baud
        decim = int(round(IF_RATE / (timing.SPS * baud)))
        self.selector = Selector(in_rate, IF_RATE, with_squelch=False)
        # the selector's shift tunes coarsely; this one centers the PSK
        # carrier at 0 inside the IF
        self.fine_shift = ShiftStage(name="psk_fine_shift")
        self.bandpass = BandpassStage(-2.0 * baud, 2.0 * baud, name="psk_bandpass")
        super().__init__([
            self.selector,
            AuxWaterfallStage(),
            self.fine_shift,
            self.bandpass,
            FirDecimateStage(decim, transition_bw=0.2 / decim, name="psk_decim"),
            TimingRecoveryStage(),
        ], name=name)

    def set_frequency_offset(self, offset_hz: float):
        self.selector.set_frequency_offset(offset_hz)

    def set_carrier(self, carrier_hz: float):
        """Fine carrier position inside the IF (the secondary cursor)."""
        self.fine_shift.set_rate(-carrier_hz / IF_RATE)


class RttyChain(Chain):
    """RTTY from device IQ: Selector → shift(center between the tones) →
    bandpass → FM discriminator → decimate to 4 samples/symbol → timing
    recovery.  The sign of each symbol is the mark/space bit; the host
    frames ITA2."""

    def __init__(self, in_rate: float, baud: float = 45.45, shift_hz: float = 170.0,
                 name: str = "rtty"):
        self.baud = baud
        self.shift_hz = shift_hz
        decim = int(round(IF_RATE / (timing.SPS * baud)))
        self.selector = Selector(in_rate, IF_RATE, with_squelch=False)
        self.fine_shift = ShiftStage(name="rtty_fine_shift")
        self.bandpass = BandpassStage(-(shift_hz + 2 * baud), shift_hz + 2 * baud,
                                      name="rtty_bandpass")
        super().__init__([
            self.selector,
            AuxWaterfallStage(),
            self.fine_shift,
            self.bandpass,
            FmDemodStage(),
            RealToComplexStage(),
            FirDecimateStage(decim, transition_bw=0.2 / decim, name="rtty_decim"),
            TimingRecoveryStage(),
        ], name=name)

    def set_frequency_offset(self, offset_hz: float):
        self.selector.set_frequency_offset(offset_hz)

    def set_carrier(self, carrier_hz: float):
        self.fine_shift.set_rate(-carrier_hz / IF_RATE)


class CwChain(Chain):
    """CW from device IQ: Selector → shift(tone) → narrow bandpass →
    envelope → decimate to ENV_RATE.  y is the float envelope; the host
    decodes Morse adaptively."""

    ENV_RATE = 500.0

    def __init__(self, in_rate: float, name: str = "cw_decoder"):
        decim = int(round(IF_RATE / self.ENV_RATE))
        self.selector = Selector(in_rate, IF_RATE, with_squelch=False)
        self.fine_shift = ShiftStage(name="cw_fine_shift")
        self.bandpass = BandpassStage(-100.0, 100.0, name="cw_bandpass")
        super().__init__([
            self.selector,
            AuxWaterfallStage(),
            self.fine_shift,
            self.bandpass,
            EnvelopeStage(),
            FirDecimateStage(decim, transition_bw=0.2 / decim, name="cw_decim"),
        ], name=name)

    def set_frequency_offset(self, offset_hz: float):
        self.selector.set_frequency_offset(offset_hz)

    def set_carrier(self, carrier_hz: float):
        self.fine_shift.set_rate(-carrier_hz / IF_RATE)


class SkimmerStftStage(OpStage):
    """Complex IF → centered magnitude spectrogram frames, one every
    ``hop`` samples: the device side of the multi-channel CW skimmer."""

    name = "skimmer_stft"

    def __init__(self, fft_size: int = 256, hop: int = 48):
        self.fft_size = int(fft_size)
        self.hop = int(hop)
        self._window_dev = None

    def divisor(self, in_spec):
        return self.hop

    def ratio(self, in_spec):
        return Fraction(1, self.hop)

    def plan(self, in_spec, block):
        self.in_spec = in_spec
        self.block = block
        self.ends = ((np.arange(block // self.hop) + 1) * self.hop).astype(np.int64)
        self.window = fftops.hann_window(self.fft_size)
        return (in_spec.with_format(Format.FLOAT)
                .with_rate(in_spec.rate / self.hop), block // self.hop)

    def _out_spec(self, in_spec):
        return in_spec.with_format(Format.FLOAT)

    def init_state(self, batch_shape, device):
        return fftops.fft_init(self.fft_size, self.hop, batch_shape, device)

    def params(self, device):
        if self._window_dev is None or self._window_dev.device != device:
            self._window_dev = torch.as_tensor(self.window, device=device)
        return self._window_dev

    def apply(self, state, params, x):
        state, p = fftops.fft_power_at(state, params, x, self.fft_size, self.ends)
        mag = torch.sqrt(torch.clamp_min(p, 0.0))
        return state, fftops.fft_swap(mag), {}

    def signature(self):
        return ("skimmer_stft", self.fft_size, self.hop, len(self.ends))


class CwSkimmerChain(Chain):
    """Whole-passband CW skimmer: the Selector slices a 24 kHz slab, the
    STFT stage gives 93.75 Hz bins at 500 frames/s, and the host tracks
    active bins with one Morse decoder per signal."""

    SKIM_RATE = 24000.0
    FFT_SIZE = 256
    HOP = 48

    def __init__(self, in_rate: float, name: str = "cw_skimmer"):
        self.selector = Selector(in_rate, self.SKIM_RATE, with_squelch=False)
        super().__init__([
            self.selector,
            AuxWaterfallStage(),
            SkimmerStftStage(self.FFT_SIZE, self.HOP),
        ], name=name)

    @property
    def bin_hz(self) -> float:
        return self.SKIM_RATE / self.FFT_SIZE

    @property
    def env_rate(self) -> float:
        return self.SKIM_RATE / self.HOP

    def set_frequency_offset(self, offset_hz: float):
        self.selector.set_frequency_offset(offset_hz)

    def set_carrier(self, carrier_hz: float):
        pass                            # whole-passband mode has no carrier


def _fax_chain(in_rate: float, name: str) -> Chain:
    # lazy: models.fax imports from this module
    from openwebrx_tpu_torch.models.fax import FaxChain
    return FaxChain(in_rate, name=name)


SECONDARY_FACTORY = {
    "bpsk31": lambda in_rate: PskChain(in_rate, 31.25),
    "bpsk63": lambda in_rate: PskChain(in_rate, 62.5),
    "rtty170": lambda in_rate: RttyChain(in_rate, 45.45, 170.0),
    "rtty450": lambda in_rate: RttyChain(in_rate, 50.0, 450.0),
    "rtty85": lambda in_rate: RttyChain(in_rate, 50.0, 85.0),
    "cwdecoder": lambda in_rate: CwChain(in_rate),
    "cwskimmer": lambda in_rate: CwSkimmerChain(in_rate),
    # the maritime telex modes ride the RTTY pipeline at 100 Bd / 170 Hz;
    # their CCIR 476/493 layers are host side
    "sitorb": lambda in_rate: RttyChain(in_rate, 100.0, 170.0, name="sitorb"),
    "navtex": lambda in_rate: RttyChain(in_rate, 100.0, 170.0, name="navtex"),
    "dsc": lambda in_rate: RttyChain(in_rate, 100.0, 170.0, name="dsc"),
    # the image modes share the subcarrier-frequency chain (1900 Hz ± 400);
    # the host assembles the lines
    "sstv": lambda in_rate: _fax_chain(in_rate, "sstv"),
    "fax": lambda in_rate: _fax_chain(in_rate, "fax"),
}
