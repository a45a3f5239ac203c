"""Full receiver chains: the per-client demodulator (Selector → demodulator
→ client audio) and the per-device waterfall.

Counterpart of ``DEMOD_FACTORY``, ``MODE_BANDPASS``,
``ClientDemodulatorChain``, ``FftChain`` and ``build_program`` in
``openwebrx_tpu/models/receiver.py``.  An unknown mode raises KeyError and a
rate pair the chain cannot plan raises ValueError, as in the reference.
"""

from __future__ import annotations

from openwebrx_tpu_torch.models.analog import Am, NFm, RawAm, SAm, Ssb, WFm
from openwebrx_tpu_torch.models.clientaudio import ClientAudioChain
from openwebrx_tpu_torch.models.selector import Selector
from openwebrx_tpu_torch.models.stages import WaterfallStage, plan_block_size
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.chain import Chain, Program

# demodulator factory by mode string
DEMOD_FACTORY = {
    "nfm": lambda: NFm(),
    "wfm": lambda: WFm(audio_rate=48000),
    "am": lambda: Am(),
    "sam": lambda: SAm(),
    "lsb": lambda: Ssb(),
    "usb": lambda: Ssb(),
    "cw": lambda: Ssb(),
    "rawam": lambda: RawAm(),
    "rawsam": lambda: SAm(),
    "usbd": lambda: Ssb(),
}

# default passbands per mode (Hz), as in the reference
MODE_BANDPASS = {
    "nfm": (-4000, 4000),
    "wfm": (-75000, 75000),
    "am": (-4000, 4000),
    "sam": (-4000, 4000),
    "lsb": (-3000, -300),
    "usb": (300, 3000),
    "cw": (400, 900),
    "rawam": (-10000, 10000),
    "rawsam": (-10000, 10000),
    "usbd": (300, 12000),
}


class ClientDemodulatorChain(Chain):
    """Selector → demodulator → client audio."""

    def __init__(self, in_rate: float, audio_rate: float = 12000.0,
                 mode: str = "nfm", compression: str = "adpcm",
                 name: str = "client_demod"):
        self.in_rate = float(in_rate)
        self.audio_rate = float(audio_rate)
        self.mode = mode
        self.compression = compression
        demod = DEMOD_FACTORY[mode]()
        if_rate = demod.get_if_rate(audio_rate)
        self.selector = Selector(in_rate, if_rate)
        self.selector.set_bandpass(*MODE_BANDPASS[mode])
        self.demod = demod
        audio_in = demod.fixed_audio_rate or if_rate
        self.audio = ClientAudioChain(audio_in, audio_rate, compression)
        super().__init__([self.selector, self.demod, self.audio], name=name)

    # -- live controls ----------------------------------------------------
    def set_frequency_offset(self, offset_hz: float):
        self.selector.set_frequency_offset(offset_hz)

    def set_bandpass(self, low_hz: float, high_hz: float):
        self.selector.set_bandpass(low_hz, high_hz)

    def set_squelch_level(self, level_db: float):
        self.selector.set_squelch_level(level_db)

    def set_mode(self, mode: str):
        """Mode switch = rebuild the demod and audio legs."""
        if mode == self.mode:
            return
        self.__init__(self.in_rate, self.audio_rate, mode, self.compression,
                      name=self.name)


class FftChain(Chain):
    """Device waterfall: one WaterfallStage (``compress`` for ADPCM rows)."""

    def __init__(self, fft_size: int = 4096, fps: float = 9.0,
                 add_db: float = -70.0, name: str = "fft",
                 compress: bool = False):
        self.waterfall = WaterfallStage(fft_size, fps, add_db,
                                        compress=compress)
        super().__init__([self.waterfall], name=name)


def build_program(chain: Chain, in_rate: float, batch_shape=(),
                  target_seconds: float = 0.1, device="cuda") -> Program:
    """Plan a block size and build the chain into a streaming Program on
    ``device``."""
    spec = StreamSpec(Format.COMPLEX_FLOAT, in_rate)
    block = plan_block_size(chain, spec, target_seconds)
    return Program(chain, spec, block, batch_shape, device=device)
