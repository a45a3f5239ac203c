"""External-binary decode services: packet, paging, selcall, EAS, ACARS…

Reference: the PopenModule-based demod chains (``csdr/chain/digimodes.py``
PacketDemodulator, ``csdr/chain/toolbox.py`` MultimonDemodulator family,
``csdr/chain/aircraft.py`` AcarsDemodulator, ``owrx/aprs/direwolf.py``).

The TPU side supplies demodulated audio (a raw-audio service bank slot);
the external binary decodes it; parsers turn its output into client
messages / map updates.  Each mode entry declares the underlying analog
mode, the command line, and a parser factory — feature-gated like the
reference.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile

from openwebrx_tpu_torch.aprs import AprsParser, KissDeframer, parse_ax25_frame
from openwebrx_tpu_torch.services.pipeline import SubprocessPipeline
from openwebrx_tpu_torch.services.toolbox import (
    EasParser, PageParser, SelCallParser,
)

logger = logging.getLogger(__name__)

AUDIO_RATE = 12000


def direwolf_config(tmp_dir: str, kiss_port: int = 0) -> str:
    """Write a direwolf config for stdin audio (reference DirewolfModule,
    owrx/aprs/direwolf.py:150)."""
    path = os.path.join(tmp_dir, f"direwolf-{os.getpid()}.conf")
    with open(path, "w") as f:
        f.write(f"ADEVICE stdin null\nARATE {AUDIO_RATE}\nCHANNEL 0\n"
                f"MYCALL N0CALL\nAGWPORT 0\nKISSPORT {kiss_port}\n")
    return path


class NativeDecoderPipeline:
    """In-process replacement for a SubprocessPipeline: int16 audio bytes
    are demodulated by a native decoder object (``process(float_samples)``
    + optional ``close()``) whose output lines/frames the decoder itself
    forwards to the parser.  Used whenever a mode has a native
    implementation — this framework decodes packet/paging/selcall/EAS
    without any of the reference's external binaries."""

    def __init__(self, decoder):
        self.decoder = decoder

    def feed(self, data: bytes):
        import numpy as np
        samples = np.frombuffer(data, dtype=np.int16).astype(np.float64) \
            / 32768.0
        self.decoder.process(samples)

    def restart(self, commandline=None):
        pass

    def close(self):
        close = getattr(self.decoder, "close", None)
        if close is not None:
            close()


class ExecModeService:
    """One decoder attached to a service/listener audio feed.

    feed(audio_bytes) goes to the decoder (native in-process when the
    mode has a native implementation, otherwise the external binary's
    stdin); parsed events arrive at on_event(dict).  Config key
    ``use_external_decoders`` forces the reference-style subprocess path
    even when a native decoder exists.
    """

    def __init__(self, mode: str, on_event, tmp_dir: str | None = None,
                 command_override: list[str] | None = None):
        self.mode = mode
        self.on_event = on_event
        self.tmp_dir = tmp_dir or tempfile.gettempdir()
        spec = EXEC_MODES[mode]
        native = spec.get("native")
        if native is not None and command_override is None \
                and not _prefer_external():
            self.pipeline = NativeDecoderPipeline(native(self))
            return
        command = command_override or spec["command"]()
        parser = spec["parser"](self)
        line_based = spec.get("line_based", True)
        self.pipeline = SubprocessPipeline(command, parser,
                                           line_based=line_based)

    def feed(self, audio_bytes: bytes):
        self.pipeline.feed(audio_bytes)

    def close(self):
        self.pipeline.close()


def _prefer_external() -> bool:
    try:
        from openwebrx_tpu_torch.core.config import Config
        return bool(Config.get().get("use_external_decoders", False))
    except Exception:
        return False


def _emit_ax25(service: ExecModeService, frame: bytes, aprs: AprsParser):
    """Raw AX.25 frame → APRS event → client + map."""
    parsed = parse_ax25_frame(frame)
    if parsed is None:
        return
    event = aprs.parse(parsed) or parsed
    service.on_event({"mode": "APRS", **{
        k: v for k, v in event.items() if k != "data"}})
    if "lat" in event and "lon" in event:
        from openwebrx_tpu_torch.core.map import Map, LatLngLocation
        Map.shared().update_location(
            event["source"], LatLngLocation(event["lat"], event["lon"]),
            "APRS")


class PacketEventAdapter:
    """direwolf KISS/TEXT output → AX.25 → APRS events → map.

    When direwolf writes KISS to stdout (-k -), frames stream through the
    deframer; APRS positions go to the map and all packets to on_event.
    """

    def __init__(self, service: ExecModeService):
        self.service = service
        self.deframer = KissDeframer()
        self.aprs = AprsParser()

    def __call__(self, data: bytes):
        for frame in self.deframer.parse(data):
            _emit_ax25(self.service, frame, self.aprs)


class NativePacketDecoder:
    """Native Bell-202 path: NFM audio → AFSK1200 → HDLC → AX.25 → APRS
    (no direwolf; :mod:`openwebrx_tpu_torch.digimodes.afsk`)."""

    def __init__(self, service: ExecModeService):
        from openwebrx_tpu_torch.digimodes.afsk import Afsk1200Demodulator
        self.service = service
        self.demod = Afsk1200Demodulator(rate=AUDIO_RATE)
        self.aprs = AprsParser()

    def process(self, samples):
        for frame in self.demod.process(samples):
            _emit_ax25(self.service, frame, self.aprs)


def _native_page(svc: ExecModeService):
    from openwebrx_tpu_torch.digimodes.pocsag import PageDecoder
    from openwebrx_tpu_torch.services.toolbox import PageParser
    parser = PageParser(svc.on_event)
    return PageDecoder(rate=AUDIO_RATE,
                       on_line=lambda line: parser.parse(line.encode()))


def _native_selcall(svc: ExecModeService):
    from openwebrx_tpu_torch.digimodes.selcall import SelCallDecoder
    from openwebrx_tpu_torch.services.toolbox import SelCallParser
    parser = SelCallParser(svc.on_event)
    return SelCallDecoder(rate=AUDIO_RATE,
                          on_line=lambda line: parser.parse(line.encode()))


def _native_eas(svc: ExecModeService):
    from openwebrx_tpu_torch.digimodes.afsk import SameDecoder
    from openwebrx_tpu_torch.services.toolbox import EasParser
    parser = EasParser(svc.on_event)
    return SameDecoder(rate=AUDIO_RATE,
                       on_line=lambda line: parser.parse(line.encode()))


EXEC_MODES = {
    "packet": {
        "underlying": "nfm",
        "requirement": "packet",
        # stdout KISS stream (direwolf -k -): no TCP round-trip needed
        "command": lambda: ["direwolf", "-c", "/dev/null", "-r", str(AUDIO_RATE),
                            "-t", "0", "-q", "hd", "-a", "0", "-k", "-"],
        "parser": PacketEventAdapter,
        "line_based": False,
        "native": NativePacketDecoder,
    },
    "page": {
        "underlying": "nfm",
        "requirement": "page",
        "command": lambda: ["multimon-ng", "-a", "POCSAG512", "-a", "POCSAG1200",
                            "-a", "POCSAG2400", "-a", "FLEX_NEXT", "-t", "raw", "-"],
        "parser": lambda svc: PageParser(svc.on_event).parse,
        "native": _native_page,
    },
    "selcall": {
        "underlying": "nfm",
        "requirement": "selcall",
        "command": lambda: ["multimon-ng", "-a", "ZVEI1", "-a", "EEA",
                            "-a", "CCIR", "-t", "raw", "-"],
        "parser": lambda svc: SelCallParser(svc.on_event).parse,
        "native": _native_selcall,
    },
    # ZVEI variants only (reference ZveiDemodulator, toolbox.py:112)
    "zvei": {
        "underlying": "nfm",
        "requirement": "selcall",
        "command": lambda: ["multimon-ng", "-a", "ZVEI1", "-a", "ZVEI2",
                            "-a", "ZVEI3", "-a", "DZVEI", "-a", "PZVEI",
                            "-t", "raw", "-"],
        "parser": lambda svc: SelCallParser(svc.on_event).parse,
        "native": _native_selcall,
    },
    # AIS via direwolf's 9600 GMSK modem (reference PacketDemodulator with
    # ais=True, csdr/chain/digimodes.py:46-51); no native path — the
    # Bell-202 AFSK demod does not apply to AIS
    "ais": {
        "underlying": "nfm",
        "requirement": "packet",
        "command": lambda: ["direwolf", "-c", "/dev/null", "-r", str(AUDIO_RATE),
                            "-B", "AIS", "-t", "0", "-q", "hd", "-a", "0",
                            "-k", "-"],
        "parser": PacketEventAdapter,
        "line_based": False,
    },
    "eas": {
        "underlying": "nfm",
        "requirement": "eas",
        "command": lambda: ["multimon-ng", "-a", "EAS", "-t", "raw", "-"],
        "parser": lambda svc: EasParser(svc.on_event).parse,
        "native": _native_eas,
    },
    "msk144": {
        "underlying": "usb",
        "requirement": "msk144",
        "command": lambda: ["msk144decoder"],
        "parser": lambda svc: _msk144_parser(svc),
    },
    "acars": {
        "underlying": "am",
        "requirement": "acars",
        "command": lambda: ["acarsdec", "-j", "-", "-"],
        "parser": lambda svc: _acars_parser(svc),
    },
}


def _msk144_parser(svc):
    """msk144decoder prints jt9-style decode lines (reference
    Msk144Demodulator, csdr/module/msk144.py:11)."""
    from openwebrx_tpu_torch.services.wsjt import WsjtParser

    class _Msk144Profile:
        mode, interval = "MSK144", 15
        def timestamp_format(self):
            return "%H%M%S"

    parser = WsjtParser()
    profile = _Msk144Profile()

    def parse(line: bytes):
        spot = parser.parse(profile, 0, line)
        if spot:
            svc.on_event(spot)
    return parse


def _acars_parser(svc):
    import json

    from openwebrx_tpu_torch.services.aircraft import AcarsParser, AircraftCache
    cache = AircraftCache()
    parser = AcarsParser(cache)

    def parse(line: bytes):
        try:
            event = json.loads(line)
        except json.JSONDecodeError:
            return
        fields = parser.parse(event)
        if fields:
            svc.on_event(fields)
    return parse


# IQ-consuming decoders: fed from an IqServiceHandle at the given IF rate
# (reference csdr/chain/aircraft.py:14-103, toolbox.py IsmDemodulator)
IQ_EXEC_MODES = {
    "ism": {
        "if_rate": 250000, "wire": "cs16", "requirement": "ism",
        "command": lambda rate, dial: ["rtl_433", "-F", "json",
                                       "-r", f"cs16:-:{int(rate)}"],
        "parser": "ism",
    },
    # WMBus wants 1.2 MS/s, too high for the other ISM protocols
    # (reference owrx/dsp.py:762-765)
    "wmbus": {
        "if_rate": 1200000, "wire": "cs16", "requirement": "ism",
        "command": lambda rate, dial: ["rtl_433", "-F", "json",
                                       "-r", f"cs16:-:{int(rate)}"],
        "parser": "ism",
    },
    "hfdl": {
        "if_rate": 12000, "wire": "cs16", "requirement": "hfdl",
        "command": lambda rate, dial: ["dumphfdl", "--iq-file", "-",
                                       "--sample-format", "CS16",
                                       "--sample-rate", str(int(rate)),
                                       "--output", "decoded:json:file:path=-",
                                       str(int(dial / 1000))],
        "parser": "hfdl",
    },
    "vdl2": {
        "if_rate": 105000, "wire": "cs16", "requirement": "vdl2",
        "command": lambda rate, dial: ["dumpvdl2", "--iq-file", "-",
                                       "--sample-format", "S16",
                                       "--oversample", "1",
                                       "--output", "decoded:json:file:path=-"],
        "parser": "vdl2",
    },
    "adsb": {
        "if_rate": 2400000, "wire": "cs16", "requirement": "adsb",
        "command": lambda rate, dial: ["dump1090", "--ifile", "-",
                                       "--iformat", "SC16", "--raw"],
        "parser": "adsb",
    },
}


def _satdump_command(pipeline: str, rate: float, dial: float,
                     extra: dict | None = None) -> list[str]:
    """satdump live decode fed f32 IQ on stdin (reference
    csdr/module/satellite.py:7-30); products land in a timestamped
    folder under the temporary directory."""
    import time as _time

    from openwebrx_tpu_torch.core.config import CoreConfig
    out = os.path.join(CoreConfig.defaults["temporary_directory"], "satdump",
                       f"{pipeline}-{int(_time.time())}")
    os.makedirs(out, exist_ok=True)
    cmd = ["satdump", "live", pipeline, out,
           "--source", "file", "--file_path", "/dev/stdin",
           "--samplerate", str(int(rate)),
           "--frequency", str(int(dial)),
           "--baseband_format", "f32"]
    for key, value in (extra or {}).items():
        cmd += [f"--{key}", str(value)]
    return cmd


IQ_EXEC_MODES.update({
    "noaa-apt-15": {
        "if_rate": 50000, "wire": "cf32", "requirement": "wxsat",
        "command": lambda rate, dial: _satdump_command(
            "noaa_apt", rate, dial, {"satellite_number": 15}),
        "parser": "satdump",
    },
    "noaa-apt-18": {
        "if_rate": 50000, "wire": "cf32", "requirement": "wxsat",
        "command": lambda rate, dial: _satdump_command(
            "noaa_apt", rate, dial, {"satellite_number": 18}),
        "parser": "satdump",
    },
    "noaa-apt-19": {
        "if_rate": 50000, "wire": "cf32", "requirement": "wxsat",
        "command": lambda rate, dial: _satdump_command(
            "noaa_apt", rate, dial, {"satellite_number": 19}),
        "parser": "satdump",
    },
    "meteor-lrpt": {
        "if_rate": 150000, "wire": "cf32", "requirement": "wxsat",
        "command": lambda rate, dial: _satdump_command(
            "meteor_m2-x_lrpt", rate, dial),
        "parser": "satdump",
    },
})


def make_iq_parser(kind: str, on_event, cache=None):
    """Event parser factory for the IQ exec modes."""
    import json as _json

    from openwebrx_tpu_torch.services.aircraft import (
        AircraftCache, AdsbParser, HfdlParser, Vdl2Parser,
    )
    from openwebrx_tpu_torch.services.toolbox import IsmParser

    cache = cache or AircraftCache()
    if kind == "ism":
        p = IsmParser(on_event)
        def parse(line: bytes):
            try:
                p.parse(_json.loads(line))
            except _json.JSONDecodeError:
                pass
        return parse
    if kind in ("hfdl", "vdl2"):
        inner = HfdlParser(cache) if kind == "hfdl" else Vdl2Parser(cache)
        def parse(line: bytes):
            try:
                fields = inner.parse(_json.loads(line))
            except _json.JSONDecodeError:
                return
            if fields:
                on_event(fields)
        return parse
    if kind == "adsb":
        sbs = AdsbParser(cache)
        def parse(line: bytes):
            fields = sbs.parse(line)
            if fields:
                on_event(fields)
        return parse
    if kind == "satdump":
        # satdump logs progress to stdout; surface product/status lines
        # as events so the service metrics count decoder activity
        def parse(line: bytes):
            text = line.decode(errors="replace").strip()
            lowered = text.lower()
            if any(tag in lowered for tag in
                   ("saving", "saved", "finished", "done", ".png", ".cadu")):
                on_event({"mode": "WXSAT", "message": text})
        return parse
    raise KeyError(kind)


def mode_available(mode: str) -> bool:
    spec = EXEC_MODES.get(mode)
    if spec is not None:
        if spec.get("native") is not None:
            return True                  # decoded in-process, no binary
        return shutil.which(spec["command"]()[0]) is not None
    spec = IQ_EXEC_MODES.get(mode)
    if spec is not None:
        return shutil.which(spec["command"](0, 0)[0]) is not None
    return False
