"""Digital-voice metadata: enrichment of DMR/YSF/D-Star/NXDN talker info.

Reference: ``owrx/meta.py:20-242`` — digiham's decoders emit metadata
records (protocol, source id, talker alias, GPS position, D-Star DPRS
strings); a per-protocol enricher chain resolves radio IDs against the
radioid.net API (24 h cached, async so the UI isn't blocked), extracts
callsigns, and pushes positions to the map.  The digiham pipeline itself
is exec-gated (binaries absent in this image); the metadata path is wired
so any decoder emitting JSON metadata lines plugs in.

The radioid.net lookup function is injectable (``RadioIDCache.fetcher``)
— the default urllib fetch simply fails closed in a zero-egress
deployment and the cache remembers the miss.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time

logger = logging.getLogger(__name__)

CACHE_TTL_S = 86400


def _default_fetcher(mode: str, radio_id: int) -> dict | None:
    """Query radioid.net (reference owrx/meta.py:77-94).  Any network
    failure returns None, which is cached as a miss."""
    from urllib import request
    try:
        res = request.urlopen(
            f"https://www.radioid.net/api/{mode}/user/?id={radio_id}",
            timeout=30)
        if res.status != 200:
            return None
        data = json.loads(res.read().decode("utf-8"))
        for item in data.get("results", []):
            if item.get("id") == radio_id:
                return item
    except Exception as e:
        logger.debug("radioid lookup failed for %s/%s: %s", mode, radio_id, e)
    return None


class RadioIDCache:
    """24 h TTL cache over the radioid.net user API; misses are cached."""

    _instance = None
    fetcher = staticmethod(_default_fetcher)

    @staticmethod
    def shared() -> "RadioIDCache":
        if RadioIDCache._instance is None:
            RadioIDCache._instance = RadioIDCache()
        return RadioIDCache._instance

    def __init__(self):
        self.cache: dict[str, dict] = {}
        self._lock = threading.Lock()

    def get(self, mode: str, radio_id: int):
        """Returns (hit, value) — a cached miss is (True, None)."""
        with self._lock:
            entry = self.cache.get(f"{mode}-{radio_id}")
        if entry is None or entry["ts"] + CACHE_TTL_S < time.time():
            return False, None
        return True, entry["data"]

    def put(self, mode: str, radio_id: int, value):
        with self._lock:
            self.cache[f"{mode}-{radio_id}"] = {"ts": time.time(),
                                                "data": value}


class Enricher:
    def __init__(self, parser: "MetaParser"):
        self.parser = parser

    def enrich(self, meta: dict, callback) -> dict:
        return meta


class RadioIDEnricher(Enricher):
    """Async radio-id → callsign/name resolution.  On a cache miss the
    meta record goes out immediately and ``callback`` re-delivers it once
    the lookup lands (reference owrx/meta.py:96-121)."""

    def __init__(self, mode: str, parser: "MetaParser"):
        super().__init__(parser)
        self.mode = mode
        self._pending: dict[int, list] = {}
        self._lock = threading.Lock()

    def _lookup_enabled(self) -> bool:
        from openwebrx_tpu_torch.core.config import Config
        return bool(Config.get().get(
            f"digital_voice_{self.mode}_id_lookup", True))

    def enrich(self, meta, callback):
        if not self._lookup_enabled() or "source" not in meta:
            return meta
        try:
            radio_id = int(meta["source"])
        except (TypeError, ValueError):
            return meta
        cache = RadioIDCache.shared()
        hit, data = cache.get(self.mode, radio_id)
        if hit:
            if data is not None:
                meta["additional"] = data
            return meta

        def on_done(data):
            if data is not None:
                meta["additional"] = data
            callback(meta)

        with self._lock:
            if radio_id in self._pending:
                self._pending[radio_id].append(on_done)
                return meta
            self._pending[radio_id] = [on_done]

        def fill():
            data = RadioIDCache.fetcher(self.mode, radio_id)
            cache.put(self.mode, radio_id, data)
            with self._lock:
                callbacks = self._pending.pop(radio_id, [])
            for cb in callbacks:
                try:
                    cb(data)
                except Exception:
                    logger.exception("radioid callback failed")

        threading.Thread(target=fill, daemon=True,
                         name=f"radioid-{self.mode}-{radio_id}").start()
        return meta


class PositionMixin:
    def push_position(self, meta: dict, callsign: str | None, mode: str):
        for key in ("lat", "lon"):
            if key in meta:
                meta[key] = float(meta[key])
        if callsign and "lat" in meta and "lon" in meta:
            from openwebrx_tpu_torch.core.map import LatLngLocation, Map
            band = self.parser.band
            Map.shared().update_location(
                callsign, LatLngLocation(meta["lat"], meta["lon"]), mode,
                band.get_name() if band else None)
        return meta


_TALKER_ALIAS_RE = re.compile(r"^([A-Z0-9]+)(\s.*)?$")


class DmrEnricher(RadioIDEnricher, PositionMixin):
    def __init__(self, parser):
        super().__init__("dmr", parser)

    @staticmethod
    def callsign(meta) -> str | None:
        # DMR carries no explicit callsign: use radioid data, else the
        # leading token of the talker alias
        if "callsign" in meta.get("additional", {}):
            return meta["additional"]["callsign"]
        m = _TALKER_ALIAS_RE.match(meta.get("talkeralias", ""))
        return m.group(1) if m else None

    def enrich(self, meta, callback):
        def and_position(m):
            self.push_position(m, self.callsign(m), "DMR")
            callback(m)
        meta = super().enrich(meta, and_position)
        return self.push_position(meta, self.callsign(meta), "DMR")


class YsfEnricher(Enricher, PositionMixin):
    def enrich(self, meta, callback):
        return self.push_position(meta, meta.get("source"), "YSF")


class DStarEnricher(Enricher, PositionMixin):
    def enrich(self, meta, callback):
        meta = self.push_position(meta, meta.get("ourcall"), "D-Star")
        return self._parse_dprs(meta)

    def _parse_dprs(self, meta):
        if "dprs" not in meta:
            return meta
        try:
            from openwebrx_tpu_torch.aprs.parser import AprsParser, parse_tnc2
            frame = parse_tnc2(meta["dprs"])
            if frame is None:
                return meta
            event = AprsParser().parse(frame)
            if event and "lat" in event and "lon" in event:
                meta["lat"] = event["lat"]
                meta["lon"] = event["lon"]
                self.push_position(meta, meta.get("ourcall"), "DPRS")
        except Exception:
            logger.exception("error parsing DPRS data")
        return meta


class NxdnEnricher(RadioIDEnricher):
    def __init__(self, parser):
        super().__init__("nxdn", parser)


class MetaParser:
    """Routes decoder metadata records through per-protocol enrichers and
    delivers them via ``meta_cb(meta_dict)`` — possibly twice when an
    async radio-id lookup completes later (reference MetaParser,
    owrx/meta.py:212-242)."""

    def __init__(self, meta_cb):
        self.meta_cb = meta_cb
        self.band = None
        self._current = None
        self.enrichers = {
            "DMR": DmrEnricher(self),
            "YSF": YsfEnricher(self),
            "DSTAR": DStarEnricher(self),
            "NXDN": NxdnEnricher(self),
        }

    def set_dial_frequency(self, freq: float):
        from openwebrx_tpu_torch.core.bands import Bandplan
        self.band = Bandplan.shared().find_band(freq)

    def feed_line(self, raw: bytes):
        """One JSON metadata line from a decoder subprocess."""
        try:
            meta = json.loads(raw.decode(errors="replace"))
        except json.JSONDecodeError:
            return
        if isinstance(meta, dict):
            self.process(meta)

    def process(self, meta: dict) -> dict:
        # mark current BEFORE enriching: a fast async lookup may call back
        # before enrich() returns, and late delivery must not drop it
        self._current = meta
        enricher = self.enrichers.get(meta.get("protocol", ""))
        if enricher is not None:
            meta = enricher.enrich(meta, self._late_delivery)
            self._current = meta
        self.meta_cb(meta)
        return meta

    def _late_delivery(self, meta):
        # drop late lookup results if a newer transmission took over
        if meta is self._current:
            self.meta_cb(meta)
