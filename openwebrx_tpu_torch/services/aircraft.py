"""Aircraft decoders: HFDL/VDL2/ACARS/ADS-B parsing + aircraft cache.

Reference: ``owrx/aircraft.py`` (726 LoC) — JSON parsers for dumphfdl,
dumpvdl2 and acarsdec, a BaseStation/beast-style feed from dump1090, an
aircraft TTL cache keyed by ICAO id feeding the map, and mode-S CPR
position decoding for ADS-B.
"""

from __future__ import annotations

import math
import threading
import time


class AircraftCache:
    """ICAO/tail → merged aircraft state with TTL (reference TTL cache +
    map push)."""

    def __init__(self, ttl: float = 900.0):
        self.ttl = ttl
        self._cache: dict[str, dict] = {}
        self._lock = threading.Lock()
        self.subscribers: list = []

    def update(self, key: str, fields: dict):
        now = time.time()
        with self._lock:
            entry = self._cache.setdefault(key, {})
            entry.update({k: v for k, v in fields.items() if v is not None})
            entry["lastseen"] = now
            # derive tail number + country from the 24-bit address once
            # (reference owrx/icao.py enrichment of aircraft entries)
            icao_hex = entry.get("icao")
            if icao_hex and "country" not in entry \
                    and "registration" not in entry:
                from openwebrx_tpu_torch.services.icao import enrich
                for k, v in enrich(str(icao_hex)).items():
                    entry.setdefault(k, v)
            snapshot = dict(entry)
        for cb in list(self.subscribers):
            try:
                cb(key, snapshot)
            except Exception:
                pass
        return snapshot

    def expire(self):
        cutoff = time.time() - self.ttl
        with self._lock:
            self._cache = {k: v for k, v in self._cache.items()
                           if v["lastseen"] > cutoff}

    def all(self) -> dict:
        self.expire()
        with self._lock:
            return {k: dict(v) for k, v in self._cache.items()}


class HfdlParser:
    """dumphfdl --output decoded:json lines (reference HfdlParser)."""

    def __init__(self, cache: AircraftCache):
        self.cache = cache

    def parse(self, event: dict):
        hfdl = event.get("hfdl", event)
        lpdu = hfdl.get("lpdu", {})
        hfnpdu = lpdu.get("hfnpdu", hfdl.get("spdu", {}).get("hfnpdu", {}))
        flight = hfnpdu.get("flight_id")
        pos = hfnpdu.get("pos", {})
        icao = (lpdu.get("ac_info") or {}).get("icao")
        key = icao or flight
        if key is None:
            return None
        fields = {"mode": "HFDL", "flight": flight, "icao": icao}
        if pos.get("lat") is not None and abs(pos.get("lat", 0)) <= 90 \
                and (pos.get("lat") or pos.get("lon")):
            fields["lat"] = pos["lat"]
            fields["lon"] = pos["lon"]
        # HFDL detail columns (reference MessagePanel HFDL table): channel
        # frequency and signal level as reported by dumphfdl
        if hfdl.get("freq"):
            fields["freq_mhz"] = round(float(hfdl["freq"]) / 1e6, 3)
        if hfdl.get("sig_level") is not None:
            fields["sig_level"] = round(float(hfdl["sig_level"]), 1)
        return self.cache.update(str(key), fields)


class Vdl2Parser:
    """dumpvdl2 JSON lines (reference Vdl2Parser)."""

    def __init__(self, cache: AircraftCache):
        self.cache = cache

    def parse(self, event: dict):
        vdl2 = event.get("vdl2", event)
        avlc = vdl2.get("avlc", {})
        src = avlc.get("src", {})
        if src.get("type") != "Aircraft":
            return None
        icao = src.get("addr")
        if icao is None:
            return None
        fields = {"mode": "VDL2", "icao": icao}
        acars = avlc.get("acars")
        if acars:
            fields["flight"] = acars.get("flight")
            fields["tail"] = acars.get("reg")
            fields["message"] = acars.get("msg_text")
        xid = avlc.get("xid", {})
        for param in xid.get("vdl_params", []):
            if param.get("name") == "ac_location":
                loc = param.get("value", {}).get("loc", {})
                if loc:
                    fields["lat"] = loc.get("lat")
                    fields["lon"] = loc.get("lon")
        self.cache.update(str(icao), fields)
        return fields


class AcarsParser:
    """acarsdec -j JSON lines (reference AcarsParser)."""

    def __init__(self, cache: AircraftCache):
        self.cache = cache

    def parse(self, event: dict):
        tail = (event.get("tail") or "").strip(". ")
        flight = event.get("flight")
        key = tail or flight
        if not key:
            return None
        fields = {"mode": "ACARS", "tail": tail or None, "flight": flight,
                  "message": event.get("text"), "label": event.get("label")}
        self.cache.update(key, fields)
        return fields


# ---------------------------------------------------------------- ADS-B ----
def cpr_decode_global(even: tuple, odd: tuple, last_odd: bool):
    """Globally-unambiguous CPR decode from an even/odd frame pair
    (mode-S airborne position; reference adsb position handling).

    even/odd: (lat_cpr, lon_cpr) each scaled to [0,1).
    Returns (lat, lon) or None.
    """
    nz = 15
    dlat_e = 360 / (4 * nz)
    dlat_o = 360 / (4 * nz - 1)
    j = math.floor(59 * even[0] - 60 * odd[0] + 0.5)
    lat_e = dlat_e * ((j % 60) + even[0])
    lat_o = dlat_o * ((j % 59) + odd[0])
    if lat_e >= 270:
        lat_e -= 360
    if lat_o >= 270:
        lat_o -= 360
    if _nl(lat_e) != _nl(lat_o):
        return None
    lat = lat_o if last_odd else lat_e
    nl = _nl(lat)
    if last_odd:
        ni = max(nl - 1, 1)
        dlon = 360 / ni
        m = math.floor(even[1] * (nl - 1) - odd[1] * nl + 0.5)
        lon = dlon * ((m % ni) + odd[1])
    else:
        ni = max(nl, 1)
        dlon = 360 / ni
        m = math.floor(even[1] * (nl - 1) - odd[1] * nl + 0.5)
        lon = dlon * ((m % ni) + even[1])
    if lon >= 180:
        lon -= 360
    return lat, lon


def _nl(lat: float) -> int:
    """Number of longitude zones at a latitude (mode-S NL function)."""
    if abs(lat) >= 87:
        return 1 if abs(lat) >= 87.5 else 2
    if lat == 0:
        return 59
    a = 1 - math.cos(math.pi / 30)
    b = math.cos(math.pi / 180 * abs(lat)) ** 2
    return math.floor(2 * math.pi / math.acos(1 - a / b))


class AdsbParser:
    """SBS/BaseStation CSV lines from dump1090 --net-sbs-port (reference
    feeds dump1090 output to the aircraft cache)."""

    def __init__(self, cache: AircraftCache):
        self.cache = cache

    def parse(self, line: bytes):
        parts = line.decode(errors="replace").strip().split(",")
        if len(parts) < 11 or parts[0] != "MSG":
            return None
        icao = parts[4]
        if not icao:
            return None
        fields = {"mode": "ADSB", "icao": icao}
        if len(parts) > 10 and parts[10].strip():
            fields["flight"] = parts[10].strip()
        if len(parts) > 15 and parts[14] and parts[15]:
            try:
                fields["lat"] = float(parts[14])
                fields["lon"] = float(parts[15])
            except ValueError:
                pass
        if len(parts) > 11 and parts[11]:
            try:
                fields["altitude"] = int(parts[11])
            except ValueError:
                pass
        # further SBS fields (reference ADSB table columns): ground speed,
        # track, vertical rate, squawk
        for i, key, conv in ((12, "groundspeed", float), (13, "track", float),
                             (16, "vspeed", int), (17, "squawk", str)):
            if len(parts) > i and parts[i].strip():
                try:
                    fields[key] = conv(parts[i].strip())
                except ValueError:
                    pass
        return self.cache.update(icao, fields)
