"""Feature detection: which capabilities this deployment offers.

Behavioral port of the reference's FeatureDetector (reference
``owrx/feature.py``: feature → requirement lists, ``has_*`` probes, TTL
cache).  The big difference from the reference: the entire csdr/digiham
DSP core is replaced by the port's PyTorch library and its hand-written
CUDA kernels, so the "core" feature only checks that ``torch`` imports.  External decoder binaries
(wsjt-x, direwolf, dump1090, …) are probed on PATH exactly like the
reference does, because they remain host subprocesses in this design
(SURVEY §2.3-H).
"""

from __future__ import annotations

import shutil
import subprocess
import time
from typing import Callable

CACHE_TTL = 2 * 60 * 60  # reference FeatureCache TTL (owrx/feature.py:22-48)


def _which(*names: str) -> Callable[[], bool]:
    return lambda: all(shutil.which(n) is not None for n in names)


def _has_torch() -> bool:
    try:
        import torch  # noqa: F401
        return True
    except ImportError:
        return False


class FeatureDetector:
    """Feature → requirement probes.  Each 'feature' a mode or device
    requires maps to a probe function; results are cached with a TTL."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._cache = {}
        return cls._instance

    PROBES: dict[str, Callable[[], bool]] = {
        # core DSP is PyTorch (hand-written CUDA kernels on the card) — no
        # csdr needed (reference requires csdr, owrx/feature.py:54)
        "core": _has_torch,
        # TPU-native digimode kernels (available once implemented in ops/)
        "digimodes": lambda: True,
        "cwdecoder": lambda: True,
        # external decoder binaries (reference owrx/feature.py:56-109)
        "wsjt-x": _which("jt9"),
        "wsjt-x-2-3": _which("jt9"),
        "wsjt-x-2-4": _which("jt9"),
        "msk144": _which("msk144decoder"),
        "js8call": _which("js8"),
        # native in-process decoders (digimodes/afsk.py, pocsag.py,
        # selcall.py) — no direwolf/multimon-ng needed; the external
        # binaries remain usable via use_external_decoders
        "packet": lambda: True,
        "page": lambda: True,
        "selcall": lambda: True,
        "eas": lambda: True,
        "ism": _which("rtl_433"),
        "hfdl": _which("dumphfdl"),
        "vdl2": _which("dumpvdl2"),
        "acars": _which("acarsdec"),
        "adsb": _which("dump1090"),
        # native multi-channel skimmer (models/secondary.py CwSkimmerChain)
        "cwskimmer": lambda: True,
        "digital_voice_digiham": _which("codecserver"),
        "digital_voice_m17": _which("m17-demod"),
        "digital_voice_freedv": _which("freedv_rx"),
        "drm": _which("dream"),
        "dab": _which("dablin"),    # audio rendering needs dablin
        "hdradio": _which("nrsc5"),
        "wxsat": _which("satdump"),
        "mp3": _which("lame"),
        "rigcontrol": _which("rigctl"),
        # SDR device families (owrx_connector daemons / SoapySDR)
        "rtl_sdr": _which("rtl_connector"),
        "rtl_tcp": _which("rtl_tcp_connector"),
        "soapy_connector": _which("soapy_connector"),
        "sddc_connector": _which("sddc_connector"),
        "hpsdr_connector": _which("hpsdr_connector"),
        "runds_connector": _which("runds_connector"),
        # direct/exec sources (stdout IQ, sources/direct.py)
        "fifi_sdr": _which("arecord"),
        "perseussdr": _which("perseustest"),
        "file_source": lambda: True,
        # natively-implemented capabilities the reference gates on
        # external tools (multimon-ng / redsea / paho / imagemagick):
        # always available here (digimodes/pocsag.py, digimodes/rds.py,
        # reporting/mqtt.py, services/fax.py convert_to_png via Pillow or
        # PPM fallback)
        "pocsag": lambda: True,
        "rds": lambda: True,
        "mqtt": lambda: True,
        "png": lambda: True,
        # per-device feature names the reference frontend/settings check
        # (owrx/feature.py device list); each resolves to its connector
        # family's availability — kept so reference-shaped configs and
        # clients see the names they expect
        "airspy": _which("soapy_connector"),
        "airspyhf": _which("soapy_connector"),
        "hackrf": _which("soapy_connector"),
        "sdrplay": _which("soapy_connector"),
        "lime_sdr": _which("soapy_connector"),
        "pluto_sdr": _which("soapy_connector"),
        "bladerf": _which("soapy_connector"),
        "uhd": _which("soapy_connector"),
        "fcdpp": _which("soapy_connector"),
        "mirics": _which("soapy_connector"),
        "hydrasdr": _which("soapy_connector"),
        "afedri": _which("soapy_connector"),
        "radioberry": _which("soapy_connector"),
        "rtl_sdr_soapy": _which("soapy_connector"),
        "soapy_remote": _which("soapy_connector"),
        "sddc_soapy": _which("soapy_connector"),
        "sddc": _which("sddc_connector"),
        "hpsdr": _which("hpsdr_connector"),
        "runds": _which("runds_connector"),
    }

    def is_available(self, feature: str) -> bool:
        now = time.time()
        hit = self._cache.get(feature)
        if hit is not None and now - hit[1] < CACHE_TTL:
            return hit[0]
        probe = self.PROBES.get(feature)
        result = bool(probe()) if probe is not None else False
        self._cache[feature] = (result, now)
        return result

    def get_failed_requirements(self, *features: str) -> list[str]:
        return [f for f in features if not self.is_available(f)]

    def feature_report(self) -> dict:
        """For the /features API page (reference owrx/feature.py report)."""
        return {f: self.is_available(f) for f in self.PROBES}

    @staticmethod
    def command_is_runnable(cmd: list[str]) -> bool:
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL,
                                    stdin=subprocess.DEVNULL)
            proc.wait(2)
            return True
        except (FileNotFoundError, subprocess.TimeoutExpired):
            return False
