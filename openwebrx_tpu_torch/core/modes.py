"""Mode registry: every demodulation mode the receiver offers.

Behavioral port of the reference's static mode table (reference
``owrx/modes.py:122-360``) — same modulation keys, display names,
bandpasses, underlying-mode links, service flags and fixed IF rates, so a
client of the reference finds the identical mode surface.  Availability is
gated by the feature detector: TPU-native kernels are always available;
modes that shell out to external decoder binaries probe for them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from openwebrx_tpu_torch.core.feature import FeatureDetector


@dataclasses.dataclass(frozen=True)
class Bandpass:
    low_cut: float
    high_cut: float


@dataclasses.dataclass(frozen=True)
class Mode:
    modulation: str
    name: str
    bandpass: Optional[Bandpass] = None
    if_rate: Optional[float] = None
    requirements: Sequence[str] = ()
    service: bool = False
    squelch: bool = True

    def is_available(self) -> bool:
        fd = FeatureDetector()
        return all(fd.is_available(r) for r in self.requirements)

    def is_service(self) -> bool:
        return self.service

    def get_bandpass(self) -> Optional[Bandpass]:
        return self.bandpass

    def get_modulation(self) -> str:
        return self.modulation


class AnalogMode(Mode):
    pass


@dataclasses.dataclass(frozen=True)
class DigitalMode(Mode):
    underlying: Sequence[str] = ()
    secondary_fft: bool = True

    def get_underlying_mode(self) -> Mode:
        mode = Modes.find_by_modulation(self.underlying[0]) if self.underlying else None
        return mode if mode is not None else EMPTY_MODE

    def get_bandpass(self):
        if self.bandpass is not None:
            return self.bandpass
        return self.get_underlying_mode().get_bandpass()

    def get_modulation(self):
        return self.get_underlying_mode().get_modulation()

    def for_underlying(self, underlying: str) -> "DigitalMode":
        if underlying not in self.underlying:
            raise ValueError(f"{underlying} is not a valid underlying mode for {self.modulation}")
        return dataclasses.replace(self, underlying=[underlying])


@dataclasses.dataclass(frozen=True)
class ServiceOnlyMode(DigitalMode):
    pass


@dataclasses.dataclass(frozen=True)
class AudioChopperMode(DigitalMode):
    """Interval-recorded modes decoded in batches (FT8 family / JS8);
    reference WsjtMode/Js8Mode (owrx/modes.py:88-120)."""

    interval: float = 15.0


def _a(mod, name, lo=None, hi=None, **kw):
    bp = Bandpass(lo, hi) if lo is not None else None
    return AnalogMode(mod, name, bandpass=bp, **kw)


def _d(mod, name, underlying, lo=None, hi=None, **kw):
    bp = Bandpass(lo, hi) if lo is not None else None
    return DigitalMode(mod, name, bandpass=bp, underlying=underlying, **kw)


def _wsjt(mod, name, interval, lo=300, hi=3000, **kw):
    # gated on the wsjt-x decoders like the reference WsjtMode
    # (owrx/modes.py: requirements=["wsjt-x"])
    kw.setdefault("requirements", ["wsjt-x"])
    return AudioChopperMode(mod, name, bandpass=Bandpass(lo, hi),
                            underlying=["usb"], service=True,
                            interval=interval, **kw)


EMPTY_MODE = Mode("empty", "Empty")

DIGIHAM = ["digital_voice_digiham"]


class Modes:
    """Same registry surface as the reference Modes class."""

    mappings = [
        _a("nfm", "FM", -5999, 5999),
        _a("wfm", "WFM", -124000, 124000),
        _a("am", "AM", -4700, 4700),
        _a("lsb", "LSB", -3000, -150),
        _a("usb", "USB", 150, 3000),
        _a("cw", "CW", 700, 900),
        _a("sam", "SAM", -4700, 4700),
        _a("usbd", "DATA", 0, 24000),
        _a("rawam", "RAM", -10000, 10000),
        _a("rawsam", "RSAM", -10000, 10000),
        _a("dmr", "DMR", -6250, 6250, requirements=DIGIHAM, squelch=False),
        _a("dstar", "D-Star", -3250, 3250, requirements=DIGIHAM, squelch=False),
        _a("nxdn", "NXDN", -3250, 3250, requirements=DIGIHAM, squelch=False),
        _a("ysf", "YSF", -6250, 6250, requirements=DIGIHAM, squelch=False),
        _a("m17", "M17", -6250, 6250, requirements=["digital_voice_m17"], squelch=False),
        _a("freedv", "FreeDV", 300, 3000, requirements=["digital_voice_freedv"], squelch=False),
        _a("drm", "DRM", -5000, 5000, requirements=["drm"], squelch=False),
        AnalogMode("dab", "DAB", if_rate=2048000, requirements=["dab"], squelch=False),
        _a("hdr", "HDR", -200000, 200000, requirements=["hdradio"], squelch=False),
        _d("bpsk31", "BPSK31", ["usb"]),
        _d("bpsk63", "BPSK63", ["usb"]),
        _d("rtty170", "RTTY-170 (45)", ["usb", "lsb"]),
        _d("rtty450", "RTTY-450 (50N)", ["usb", "lsb"]),
        _d("rtty85", "RTTY-85 (50N)", ["usb", "lsb"]),
        _d("sitorb", "SITOR-B", ["usb"]),
        _d("navtex", "NAVTEX", ["usb"], service=True),
        _d("dsc", "DSC", ["usb"], service=True),
        _wsjt("ft8", "FT8", 15),
        _wsjt("ft4", "FT4", 7.5),
        _wsjt("jt65", "JT65", 60),
        _wsjt("jt9", "JT9", 60),
        _wsjt("wspr", "WSPR", 120, 1350, 1650),
        _wsjt("fst4", "FST4", 15, requirements=["wsjt-x-2-3"]),
        _wsjt("fst4w", "FST4W", 120, 1350, 1650, requirements=["wsjt-x-2-3"]),
        _wsjt("q65", "Q65", 60, requirements=["wsjt-x-2-4"]),
        _d("msk144", "MSK144", ["usb"], requirements=["msk144"], service=True),
        AudioChopperMode("js8", "JS8Call", bandpass=Bandpass(300, 3000),
                         underlying=["usb"], service=True, interval=15,
                         requirements=["js8call"]),
        _d("packet", "Packet", ["empty"], -6250, 6250, requirements=["packet"],
           service=True, squelch=False),
        _d("ais", "AIS", ["empty"], -6250, 6250, requirements=["packet"],
           service=True, squelch=False),
        _d("page", "Page", ["empty"], -6000, 6000, requirements=["page"],
           service=True, squelch=False),
        _d("cwdecoder", "CW Decoder", ["usb", "lsb"]),
        _d("cwskimmer", "CW Skimmer", ["empty"], 0, 24000,
           requirements=["cwskimmer"], squelch=False),
        _d("sstv", "SSTV", ["usb", "lsb", "nfm"], service=True),
        _d("fax", "Fax", ["usb"], service=True),
        _d("selcall", "SelCall", ["nfm"], requirements=["selcall"]),
        _d("zvei", "Zvei", ["nfm"], requirements=["selcall"]),
        _d("eas", "EAS", ["nfm"], requirements=["eas"], service=True),
        DigitalMode("ism", "ISM", underlying=["empty"], if_rate=250000,
                    requirements=["ism"], service=True, squelch=False),
        _d("wmbus", "WMBus", ["empty"], -125000, 125000, requirements=["ism"],
           service=True, squelch=False),
        _d("hfdl", "HFDL", ["empty"], 0, 3000, requirements=["hfdl"],
           service=True, squelch=False),
        _d("vdl2", "VDL2", ["empty"], -12500, 12500, requirements=["vdl2"],
           service=True, squelch=False),
        _d("acars", "ACARS", ["am"], -6000, 6000, requirements=["acars"],
           service=True, squelch=False),
        DigitalMode("adsb", "ADSB", underlying=["empty"], if_rate=2400000,
                    requirements=["adsb"], service=True, squelch=False,
                    secondary_fft=False),
        ServiceOnlyMode("audio", "Audio Recorder",
                        underlying=["am", "usb", "lsb", "nfm", "sam", "cw"],
                        requirements=["mp3"], service=True),
        ServiceOnlyMode("noaa-apt-15", "NOAA-15 APT", underlying=["empty"],
                        bandpass=Bandpass(-25000, 25000), requirements=["wxsat"],
                        service=True, squelch=False, secondary_fft=False),
        ServiceOnlyMode("noaa-apt-19", "NOAA-19 APT", underlying=["empty"],
                        bandpass=Bandpass(-25000, 25000), requirements=["wxsat"],
                        service=True, squelch=False, secondary_fft=False),
        ServiceOnlyMode("meteor-lrpt", "Meteor-M2 LRPT", underlying=["empty"],
                        bandpass=Bandpass(-75000, 75000), requirements=["wxsat"],
                        service=True, squelch=False, secondary_fft=False),
        ServiceOnlyMode("elektro-lrit", "Elektro-L LRIT", underlying=["empty"],
                        bandpass=Bandpass(-200000, 200000), requirements=["wxsat"],
                        service=True, squelch=False, secondary_fft=False),
    ]

    @staticmethod
    def get_modes():
        return Modes.mappings

    @staticmethod
    def get_available_modes():
        return [m for m in Modes.mappings if m.is_available()]

    @staticmethod
    def get_available_client_modes():
        return [m for m in Modes.get_available_modes()
                if not isinstance(m, ServiceOnlyMode)]

    @staticmethod
    def get_available_services():
        return [m for m in Modes.get_available_modes() if m.is_service()]

    @staticmethod
    def find_by_modulation(modulation: str):
        for m in Modes.get_available_modes():
            if m.modulation == modulation:
                return m
        return None
