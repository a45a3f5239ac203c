"""JS8Call mode profiles and decoder-output parser.

Reference: ``owrx/js8.py:19-148`` — four speed profiles mapping to the
``js8`` decoder's sub-modes (normal=A/15s, slow=E/30s, fast=B/10s,
turbo=C/6s) and a parser that classifies decoded frames, pushing
heartbeat/compound frames carrying a Maidenhead grid to the map and
spot reporters.  The reference delegates frame parsing to the external
``js8py`` package; here the decode-line format and the frame grammar
are parsed directly so no extra dependency is needed:

    231530 -11  0.5 1250 A  KN4CRD: @HB HEARTBEAT EM73
    231545  -3  0.2  750 A  OH8STN: KN4CRD SNR -12

Heartbeat frames ("@HB HEARTBEAT <grid>") and compound callsign+grid
frames yield ``callsign``/``locator`` keys, which the service engine
forwards to the map and reporting sinks (same flow as WSPR beacons).
"""

from __future__ import annotations

import re

from openwebrx_tpu_torch.services.wsjt import WsjtProfile, _parse_timestamp


class Js8Profile(WsjtProfile):
    """Base for the four JS8 speeds; ``sub_mode`` is the decoder's -b arg."""

    mode = "JS8"
    sub_mode = "A"

    def decoding_depth(self) -> int:
        from openwebrx_tpu_torch.core.config import Config
        return int(Config.get().get("js8_decoding_depth", 3))

    def decoder_commandline(self, file):
        return ["js8", "--js8", "-b", self.sub_mode,
                "-d", str(self.decoding_depth()), file]

    def make_parser(self):
        return Js8Parser()


class Js8NormalProfile(Js8Profile):
    interval, sub_mode = 15, "A"


class Js8SlowProfile(Js8Profile):
    interval, sub_mode = 30, "E"


class Js8FastProfile(Js8Profile):
    interval, sub_mode = 10, "B"


class Js8TurboProfile(Js8Profile):
    interval, sub_mode = 6, "C"


JS8_PROFILES = {
    "js8": Js8NormalProfile,
    "js8normal": Js8NormalProfile,
    "js8slow": Js8SlowProfile,
    "js8fast": Js8FastProfile,
    "js8turbo": Js8TurboProfile,
}

_DECODER_NOISE = re.compile(r" ?<Decode(Started|Debug|Finished)>")
# "KN4CRD: @HB HEARTBEAT EM73" (grid optional)
_HEARTBEAT = re.compile(
    r"^(?P<call>[A-Z0-9/]{2,}):\s+@(HB|ALLCALL)\s+HEARTBEAT"
    r"(\s+(?P<grid>[A-R]{2}[0-9]{2}))?")
# compound announce "KN4CRD: EM73" — callsign plus bare grid
_COMPOUND = re.compile(
    r"^(?P<call>[A-Z0-9/]{2,}):\s+(?P<grid>[A-R]{2}[0-9]{2})\b\s*$")
# directed "OH8STN: KN4CRD SNR -12"
_DIRECTED = re.compile(
    r"^(?P<from>[A-Z0-9/]{2,}):\s+(?P<to>@?[A-Z0-9/]{2,})\b")


class Js8Parser:
    """Parses ``js8`` decoder stdout into spot dicts."""

    def parse(self, profile: Js8Profile, dial_freq: int, raw_line: bytes):
        line = raw_line.decode(errors="replace").rstrip()
        if not line or _DECODER_NOISE.match(line) or \
                line.startswith(" EOF on input file"):
            return None
        try:
            rest, timestamp = _parse_timestamp(line, profile.timestamp_format())
            db = float(rest[0:3])
            dt = float(rest[4:8])
            freq = int(dial_freq) + int(rest[9:13])
            sub_mode = rest[14:15].strip() or profile.sub_mode
            msg = rest[17:].strip()
        except (ValueError, IndexError):
            return None
        out = {
            "mode": "JS8",
            "js8mode": sub_mode,
            "timestamp": timestamp,
            "db": db,
            "dt": dt,
            "freq": freq,
            "msg": msg,
        }
        m = _HEARTBEAT.match(msg) or _COMPOUND.match(msg)
        if m:
            out["thread_type"] = "heartbeat"
            out["callsign"] = m.group("call")
            grid = m.groupdict().get("grid")
            if grid:
                out["locator"] = grid
            return out
        m = _DIRECTED.match(msg)
        if m:
            out["thread_type"] = "directed"
            out["callsign"] = m.group("from")
            out["callee"] = m.group("to")
        return out
