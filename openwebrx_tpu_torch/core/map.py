"""Map backend: shared position store with TTL + incremental broadcast.

Reference: ``owrx/map.py:25-229`` — {callsign → location, mode, band,
timestamp} with TTL expiry, caller→callee lines, full dump on client join,
incremental updates broadcast to map clients.
"""

from __future__ import annotations

import threading
import time


class Location:
    def to_json(self) -> dict:
        raise NotImplementedError


class LatLngLocation(Location):
    def __init__(self, lat: float, lon: float):
        self.lat = float(lat)
        self.lon = float(lon)

    def to_json(self):
        return {"type": "latlon", "lat": self.lat, "lon": self.lon}


class LocatorLocation(Location):
    """Maidenhead locator → lat/lon (center of the square)."""

    def __init__(self, locator: str):
        self.locator = locator.strip().upper()
        if len(self.locator) < 4:
            raise ValueError(f"invalid locator {locator!r}")
        lon = (ord(self.locator[0]) - ord("A")) * 20 - 180
        lat = (ord(self.locator[1]) - ord("A")) * 10 - 90
        lon += int(self.locator[2]) * 2
        lat += int(self.locator[3]) * 1
        if len(self.locator) >= 6:
            lon += (ord(self.locator[4]) - ord("A")) * 2 / 24
            lat += (ord(self.locator[5]) - ord("A")) / 24
            lon += 1 / 24
            lat += 0.5 / 24
        else:
            lon += 1
            lat += 0.5
        self.lat, self.lon = lat, lon

    def to_json(self):
        return {"type": "locator", "locator": self.locator,
                "lat": self.lat, "lon": self.lon}


class Map:
    """Singleton position store (reference Map.getSharedInstance)."""

    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def shared() -> "Map":
        with Map._lock:
            if Map._instance is None:
                Map._instance = Map()
            return Map._instance

    def __init__(self):
        self.positions: dict[str, dict] = {}
        self.calls: list[dict] = []
        self.subscribers: list = []
        self._plock = threading.Lock()

    def retention_time(self) -> float:
        from openwebrx_tpu_torch.core.config import Config
        return float(Config.get().get("map_position_retention_time", 7200))

    def update_location(self, callsign: str, loc: Location, mode: str,
                        band=None, hops=None, timestamp_ms: float | None = None):
        """timestamp_ms far in the future makes the entry effectively
        permanent (reference Markers.updateMap, owrx/markers.py:200-207)."""
        record = {
            "callsign": callsign,
            "location": loc.to_json(),
            "mode": mode,
            "band": band,
            "lastseen": timestamp_ms if timestamp_ms is not None
                        else time.time() * 1000,
            "hops": hops or [],
        }
        with self._plock:
            self.positions[callsign] = record
        self._broadcast([record])

    def remove_location(self, callsign: str):
        with self._plock:
            self.positions.pop(callsign, None)

    def update_call(self, caller: str, callee: str, mode: str, band=None):
        record = {"caller": caller, "callee": callee, "mode": mode,
                  "band": band, "lastseen": time.time() * 1000}
        with self._plock:
            self.calls.append(record)
            cutoff = time.time() * 1000 - 5 * 60 * 1000
            self.calls = [c for c in self.calls if c["lastseen"] > cutoff][-50:]
        # call lines reach map clients like position updates do (reference
        # Map.updateCall → broadcast, owrx/map.py:168-178)
        self._broadcast([record])

    def expire(self):
        cutoff = (time.time() - self.retention_time()) * 1000
        with self._plock:
            self.positions = {k: v for k, v in self.positions.items()
                              if v["lastseen"] > cutoff}

    def full_dump(self) -> list[dict]:
        """Positions + recent call lines (call records carry a "caller"
        key, which is how clients tell them apart)."""
        self.expire()
        with self._plock:
            return list(self.positions.values()) + list(self.calls)

    def subscribe(self, cb):
        self.subscribers.append(cb)

    def unsubscribe(self, cb):
        if cb in self.subscribers:
            self.subscribers.remove(cb)

    def _broadcast(self, updates: list[dict]):
        for cb in list(self.subscribers):
            try:
                cb(updates)
            except Exception:
                pass
