"""WSJT-X mode profiles and output parsers.

Reference: ``owrx/wsjt.py:20-432`` — per-mode decoder command lines and
intervals (FT8 15 s `jt9 --ft8`, WSPR 120 s `wsprd`, JT65/JT9 60 s, FT4
7.5 s, FST4/FST4W configurable), and the jt9/wsprd stdout line formats:

    ft8:  '222100 -15 -0.0  508 ~  CQ EA7MJ IM66'
    jt65: '2352  -7  0.4 1801 #  R0WAS R2ABM KO85'
    wspr: '2600 -24  0.4   0.001492 -1  G8AXA JO01 33'

Parsed into {timestamp, db, dt, freq, msg} + callsign/locator extraction
for map and spot reporting.
"""

from __future__ import annotations

import re
from datetime import datetime, timezone


class WsjtProfile:
    """One decodable mode: interval + decoder command line."""

    mode: str = ""
    interval: float = 0

    def decoding_depth(self) -> int:
        from openwebrx_tpu_torch.core.config import Config
        config = Config.get()
        depths = config.get("wsjt_decoding_depths", {}) or {}
        key = self.mode.lower()
        if key in depths:
            return int(depths[key])
        return int(config.get("wsjt_decoding_depth", 3))

    def decoder_commandline(self, file: str) -> list[str]:
        raise NotImplementedError

    def timestamp_format(self) -> str:
        return "%H%M%S" if self.interval < 60 else "%H%M"

    def file_timestamp_format(self) -> str:
        return "%y%m%d_%H%M%S" if self.interval < 60 else "%y%m%d_%H%M"

    def make_parser(self):
        return WsjtParser()


class Ft8Profile(WsjtProfile):
    mode, interval = "FT8", 15

    def decoder_commandline(self, file):
        return ["jt9", "--ft8", "-d", str(self.decoding_depth()), file]


class Ft4Profile(WsjtProfile):
    mode, interval = "FT4", 7.5

    def decoder_commandline(self, file):
        return ["jt9", "--ft4", "-d", str(self.decoding_depth()), file]


class Jt65Profile(WsjtProfile):
    mode, interval = "JT65", 60

    def decoder_commandline(self, file):
        return ["jt9", "--jt65", "-d", str(self.decoding_depth()), file]


class Jt9Profile(WsjtProfile):
    mode, interval = "JT9", 60

    def decoder_commandline(self, file):
        return ["jt9", "--jt9", "-d", str(self.decoding_depth()), file]


class WsprProfile(WsjtProfile):
    mode, interval = "WSPR", 120

    def decoder_commandline(self, file):
        cmd = ["wsprd"]
        if self.decoding_depth() > 1:
            cmd.append("-d")
        cmd.append(file)
        return cmd


class Fst4Profile(WsjtProfile):
    mode = "FST4"
    available_intervals = [15, 30, 60, 120, 300, 900, 1800]

    def __init__(self, interval: int = 15):
        self.interval = interval

    def decoder_commandline(self, file):
        return ["jt9", "--fst4", "-p", str(self.interval),
                "-d", str(self.decoding_depth()), file]


class Fst4wProfile(WsjtProfile):
    mode = "FST4W"
    available_intervals = [120, 300, 900, 1800]

    def __init__(self, interval: int = 120):
        self.interval = interval

    def decoder_commandline(self, file):
        return ["jt9", "--fst4w", "-p", str(self.interval),
                "-d", str(self.decoding_depth()), file]


class Q65Profile(WsjtProfile):
    mode = "Q65"

    def __init__(self, interval: int = 60, mode_letter: str = "A"):
        self.interval = interval
        self.mode_letter = mode_letter

    def decoder_commandline(self, file):
        return ["jt9", "--q65", "-p", str(self.interval),
                "-b", self.mode_letter, "-d", str(self.decoding_depth()), file]


PROFILES = {
    "ft8": Ft8Profile, "ft4": Ft4Profile, "jt65": Jt65Profile,
    "jt9": Jt9Profile, "wspr": WsprProfile, "fst4": Fst4Profile,
    "fst4w": Fst4wProfile, "q65": Q65Profile,
}


def enabled_profiles(mode: str) -> list[WsjtProfile]:
    """All decoder profiles the config enables for a mode, possibly
    several (reference ConfigWiredProfileSource: fst4/fst4w intervals,
    q65 combinations — owrx/wsjt.py:39-87 — and js8 speeds).  Profiles
    sharing an interval share one recording; the service engine groups
    them per chopper."""
    from openwebrx_tpu_torch.core.config import Config
    config = Config.get()
    if mode == "fst4":
        intervals = config.get("fst4_enabled_intervals") or [15]
        return [Fst4Profile(i) for i in intervals
                if i in Fst4Profile.available_intervals]
    if mode == "fst4w":
        intervals = config.get("fst4w_enabled_intervals") or [120]
        return [Fst4wProfile(i) for i in intervals
                if i in Fst4wProfile.available_intervals]
    if mode == "q65":
        out = []
        for combo in config.get("q65_enabled_combinations") or ["A30"]:
            try:
                letter, interval = combo[0].upper(), int(combo[1:])
            except (ValueError, IndexError):
                continue
            out.append(Q65Profile(interval, letter))
        return out
    if mode.startswith("js8"):
        from openwebrx_tpu_torch.services.js8 import JS8_PROFILES
        names = config.get("js8_enabled_profiles") or ["normal"]
        out = []
        for name in names:
            cls = JS8_PROFILES.get(f"js8{name.lower()}")
            if cls is not None:
                out.append(cls())
        return out or [JS8_PROFILES["js8"]()]
    if mode in PROFILES:
        return [PROFILES[mode]()]
    return []

# QSO message: "... CALLSIGN LOCATOR" or "... CALLSIGN 73/RRR/RR73"
_QSO_RE = re.compile(r"^(.*)\s([A-Z0-9/]{2,})(\sR)?\s(([A-R]{2}[0-9]{2})|73|RRR)$")
_CALLEE_RE = re.compile(r"^([A-Z0-9/]{2,})(\s.*)?$")
# beacon message: "CALLSIGN LOCATOR DBM"
_BEACON_RE = re.compile(r"([A-Z0-9/]*)\s([A-R]{2}[0-9]{2})\s([0-9]+)")


def parse_qso_message(msg: str) -> dict:
    m = _QSO_RE.match(msg)
    if m is None:
        return {}
    out = {"callsign": m.group(2)}
    if m.group(4) not in ("RR73", "73", "RRR"):
        out["locator"] = m.group(4)
    else:
        # "73"-style signoff: the leading part names the callee
        m2 = _CALLEE_RE.match(m.group(1))
        if m2 is not None:
            out["callee"] = m2.group(1)
    return out


def parse_beacon_message(msg: str) -> dict:
    m = _BEACON_RE.match(msg)
    if m is None:
        return {}
    return {"callsign": m.group(1), "locator": m.group(2), "dbm": m.group(3)}


def _parse_timestamp(line: str, fmt: str):
    width = len(datetime(2000, 1, 1).strftime(fmt))
    rest = line[width + 1:]
    try:
        ts = datetime.strptime(line[:width], fmt)
        now = datetime.now(timezone.utc)
        combined = datetime.combine(now.date(), ts.time(), tzinfo=timezone.utc)
        return rest, int(combined.timestamp() * 1000)
    except ValueError:
        return rest, None


class WsjtParser:
    """Parses decoder stdout lines into spot dicts (reference WsjtParser,
    owrx/wsjt.py:261-312)."""

    def parse(self, profile: WsjtProfile, dial_freq: int, raw_line: bytes):
        line = raw_line.decode(errors="replace").rstrip()
        if not line or line.startswith("<DecodeFinished>") or \
                line.startswith(" EOF on input file"):
            return None
        try:
            if profile.mode in ("WSPR",):
                out = self._parse_wspr(line, profile, dial_freq)
            else:
                out = self._parse_jt9(line, profile, dial_freq)
        except (ValueError, IndexError):
            return None
        out["mode"] = profile.mode
        out["interval"] = profile.interval
        msg = out.get("msg", "")
        if profile.mode in ("WSPR", "FST4W"):
            out.update(parse_beacon_message(msg))
        else:
            out.update(parse_qso_message(msg))
        return out

    def _parse_jt9(self, line: str, profile, dial_freq):
        rest, timestamp = _parse_timestamp(line, profile.timestamp_format())
        return {
            "timestamp": timestamp,
            "db": float(rest[0:3]),
            "dt": float(rest[4:8]),
            "freq": int(dial_freq) + int(rest[9:13]),
            "msg": rest[17:53].strip(),
        }

    def _parse_wspr(self, line: str, profile, dial_freq):
        rest, timestamp = _parse_timestamp(line, profile.timestamp_format())
        return {
            "timestamp": timestamp,
            "db": float(rest[0:3]),
            "dt": float(rest[4:8]),
            "freq": int(dial_freq) + int(float(rest[10:20]) * 1e6),
            "drift": int(rest[20:23]),
            "msg": rest[24:].strip(),
        }
