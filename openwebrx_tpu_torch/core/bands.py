"""Bandplan: frequency allocations + per-band service dial frequencies.

Reference: ``owrx/bands.py`` (+ ``bands.json`` data).  The band data here
is the standard IARU/ITU amateur and broadcast allocation table (factual
public data, re-entered), with the digimode dial frequencies services tune
to.  Bookmarks live in ``bookmarks.py``.
"""

from __future__ import annotations

import threading


class Band:
    def __init__(self, name: str, low: float, high: float, tags=None,
                 frequencies: dict | None = None):
        self.name = name
        self.low = float(low)
        self.high = float(high)
        self.tags = tags or []
        # mode → dial frequency (or list of dial frequencies)
        self.frequencies = frequencies or {}

    def in_band(self, freq: float) -> bool:
        return self.low <= freq <= self.high

    def get_name(self):
        return self.name

    def get_bounds(self):
        return (self.low, self.high)

    def get_tags(self):
        return self.tags

    def get_dial_frequencies(self) -> list[dict]:
        out = []
        for mode, dial in self.frequencies.items():
            dials = dial if isinstance(dial, list) else [dial]
            for f in dials:
                out.append({"mode": mode, "frequency": f})
        return out


_HAM = "hamradio"
_BC = "broadcast"

BANDS = [
    Band("2200m", 135700, 137800, [_HAM], {"wspr": 136000}),
    Band("630m", 472000, 479000, [_HAM], {"wspr": 474200}),
    Band("160m", 1810000, 2000000, [_HAM],
         {"ft8": 1840000, "wspr": 1836600, "jt65": 1838000}),
    Band("80m", 3500000, 3800000, [_HAM],
         {"ft8": 3573000, "wspr": 3568600, "jt65": 3570000, "js8": 3578000,
          "ft4": 3575000}),
    Band("60m", 5351500, 5366500, [_HAM], {"ft8": 5357000, "wspr": 5364700}),
    Band("40m", 7000000, 7200000, [_HAM],
         {"ft8": 7074000, "wspr": 7038600, "jt65": 7076000, "js8": 7078000,
          "ft4": 7047500}),
    Band("30m", 10100000, 10150000, [_HAM],
         {"ft8": 10136000, "wspr": 10138700, "jt65": 10138000,
          "ft4": 10140000}),
    Band("20m", 14000000, 14350000, [_HAM],
         {"ft8": 14074000, "wspr": 14095600, "jt65": 14076000,
          "js8": 14078000, "ft4": 14080000}),
    Band("17m", 18068000, 18168000, [_HAM],
         {"ft8": 18100000, "wspr": 18104600, "jt65": 18102000,
          "ft4": 18104000}),
    Band("15m", 21000000, 21450000, [_HAM],
         {"ft8": 21074000, "wspr": 21094600, "jt65": 21076000,
          "ft4": 21140000}),
    Band("12m", 24890000, 24990000, [_HAM],
         {"ft8": 24915000, "wspr": 24924600, "jt65": 24917000}),
    Band("10m", 28000000, 29700000, [_HAM],
         {"ft8": 28074000, "wspr": 28124600, "jt65": 28076000,
          "ft4": 28180000}),
    Band("6m", 50030000, 51000000, [_HAM],
         {"ft8": 50313000, "wspr": 50293000, "jt65": 50310000}),
    Band("4m", 70150000, 70200000, [_HAM], {}),
    Band("2m", 144000000, 146000000, [_HAM],
         {"ft8": 144174000, "wspr": 144489000, "aprs": 144800000}),
    Band("70cm", 430000000, 440000000, [_HAM], {"pocsag": 439987500}),
    Band("23cm", 1240000000, 1300000000, [_HAM], {}),
    Band("120m bc", 2300000, 2495000, [_BC], {}),
    Band("90m bc", 3200000, 3400000, [_BC], {}),
    Band("75m bc", 3900000, 4000000, [_BC], {}),
    Band("49m bc", 5900000, 6200000, [_BC], {}),
    Band("41m bc", 7200000, 7450000, [_BC], {}),
    Band("31m bc", 9400000, 9900000, [_BC], {}),
    Band("25m bc", 11600000, 12100000, [_BC], {}),
    Band("22m bc", 13570000, 13870000, [_BC], {}),
    Band("19m bc", 15100000, 15830000, [_BC], {}),
    Band("16m bc", 17480000, 17900000, [_BC], {}),
    Band("13m bc", 21450000, 21850000, [_BC], {}),
    Band("11m bc", 25670000, 26100000, [_BC], {}),
    Band("MW bc", 526500, 1606500, [_BC], {}),
    Band("LW bc", 148500, 283500, [_BC], {}),
    Band("CB", 26965000, 27405000, [], {}),
    Band("FM bc", 87500000, 108000000, [_BC], {}),
    Band("Air band", 118000000, 137000000, [], {}),
]


def load_bands_file(path: str) -> list[Band]:
    """Parse a bands JSON file (same shape as the reference's bands.json /
    bands-r{1,2,3}.json: name, lower_bound, upper_bound, frequencies,
    tags — reference owrx/bands.py:73-90), so existing deployments' band
    files drop straight in."""
    import json
    with open(path) as f:
        raw = json.load(f)
    out = []
    for b in raw:
        freqs = {}
        for mode, v in (b.get("frequencies") or {}).items():
            if isinstance(v, dict):
                v = v.get("frequency")
            freqs[mode] = v
        out.append(Band(b["name"], b["lower_bound"], b["upper_bound"],
                        b.get("tags"), freqs))
    return out


REGIONS = ("r1", "r2", "r3")


def load_region(region: str) -> list[Band]:
    """ITU-region bandplan from the shipped data packs
    (data/bands-r{1,2,3}.json; public IARU/ITU allocation data —
    reference ships the same as bands-r1/r2/r3.json)."""
    import os
    if region not in REGIONS:
        raise KeyError(f"unknown bandplan region {region!r}")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "data", f"bands-{region}.json")
    return load_bands_file(path)


class Bandplan:
    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def shared() -> "Bandplan":
        with Bandplan._lock:
            if Bandplan._instance is None:
                Bandplan._instance = Bandplan()
            return Bandplan._instance

    def __init__(self, bands=None):
        if bands is None:
            bands = self._configured_bands()
        self.bands = bands if bands is not None else BANDS

    @staticmethod
    def _configured_bands():
        """Config-driven band set: ``bands_json`` (a file path, highest
        priority) or ``bandplan_region`` ("r1"/"r2"/"r3"); None → the
        built-in default table."""
        try:
            from openwebrx_tpu_torch.core.config import Config
            cfg = Config.get()
            path = cfg.get("bands_json")
            if path:
                return load_bands_file(path)
            region = cfg.get("bandplan_region")
            if region:
                return load_region(str(region))
        except Exception:
            return None
        return None

    def find_band(self, freq: float) -> Band | None:
        for band in self.bands:
            if band.in_band(freq):
                return band
        return None

    def find_bands_in_range(self, low: float, high: float) -> list[Band]:
        return [b for b in self.bands if b.low <= high and b.high >= low]

    def collect_dial_frequencies(self, low: float, high: float) -> list[dict]:
        out = []
        for band in self.find_bands_in_range(low, high):
            for d in band.get_dial_frequencies():
                if low <= d["frequency"] <= high:
                    out.append({**d, "name": band.name})
        return out
