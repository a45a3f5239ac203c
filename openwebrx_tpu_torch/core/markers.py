"""Map markers: static marker files + pluggable database loaders.

Reference: ``owrx/markers.py`` — loads marker JSON files (data directory
``markers.json`` plus every ``markers.d/*.json``), merges markers from
the receivers/repeaters/EIBI web databases, and pushes everything onto
the map with far-future timestamps (permanent), refreshing hourly.

The reference's database agents scrape public websites daily; in a
zero-egress deployment those loaders return nothing, so here they are a
pluggable registry (``Markers.loaders``) — a deployment with network (or
pre-seeded cache files) registers loaders returning
``{id: MarkerLocation}`` dicts and gets the same hourly refresh/expire
behavior.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from datetime import datetime, timedelta, timezone

from openwebrx_tpu_torch.core.map import Location, Map

logger = logging.getLogger(__name__)

PERMANENT_MS = (datetime.now(timezone.utc)
                + timedelta(weeks=500)).timestamp() * 1000


class MarkerLocation(Location):
    """A marker defined by an attribute dict (lat/lon/mode/id + extras)."""

    def __init__(self, attrs: dict):
        self.attrs = dict(attrs)
        self.attrs["type"] = "latlon"

    def get_id(self) -> str:
        return self.attrs["id"]

    def get_mode(self) -> str:
        return self.attrs.get("mode", "Stations")

    def to_json(self) -> dict:
        return self.attrs


class Markers:
    _instance = None
    _lock = threading.Lock()

    # name → callable() -> {id: MarkerLocation} | None; populated by
    # deployments that have database sources (receivers/repeaters/EIBI)
    loaders: dict = {}

    @staticmethod
    def shared() -> "Markers":
        with Markers._lock:
            if Markers._instance is None:
                Markers._instance = Markers()
            return Markers._instance

    @staticmethod
    def start():
        Markers.shared().start_thread()

    @staticmethod
    def stop():
        with Markers._lock:
            if Markers._instance is not None:
                Markers._instance.stop_thread()

    def __init__(self):
        self.event = threading.Event()
        self.thread: threading.Thread | None = None
        self.markers: dict[str, MarkerLocation] = {}
        self.db_markers: dict[str, dict[str, MarkerLocation]] = {}

    def _file_list(self) -> list[str]:
        from openwebrx_tpu_torch.core.config import CoreConfig
        data_dir = CoreConfig.defaults["data_directory"]
        files = [os.path.join(data_dir, "markers.json"),
                 "/etc/openwebrx/markers.json"]
        markers_d = os.path.join(data_dir, "markers.d")
        for d in (markers_d, "/etc/openwebrx/markers.d"):
            try:
                files += [os.path.join(d, f) for f in sorted(os.listdir(d))
                          if f.endswith(".json")]
            except OSError:
                pass
        return files

    @staticmethod
    def load_marker_file(path: str) -> dict[str, MarkerLocation]:
        try:
            with open(path) as f:
                db = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            logger.error("cannot load markers from %s: %s", path, e)
            return {}
        return {key: MarkerLocation(attrs) for key, attrs in db.items()}

    def refresh(self):
        """Load static files + run registered loaders, sync to the map."""
        loaded: dict[str, MarkerLocation] = {}
        for path in self._file_list():
            if os.path.isfile(path):
                loaded.update(self.load_marker_file(path))
        self._apply_update("static", loaded)
        for name, loader in list(self.loaders.items()):
            try:
                update = loader()
            except Exception:
                logger.exception("marker loader %s failed", name)
                continue
            if update is not None:
                self._apply_update(name, update)

    def _apply_update(self, group: str, update: dict[str, MarkerLocation]):
        current = self.db_markers.setdefault(group, {})
        map_ = Map.shared()
        for gone in [k for k in current if k not in update]:
            map_.remove_location(gone)
            del current[gone]
        for key, marker in update.items():
            ttl = marker.attrs.get("ttl")
            # a ttl marker should drop out of the map ttl ms from now;
            # Map.expire keeps entries for retention_time past lastseen
            ts = (time.time() * 1000 + ttl - map_.retention_time() * 1000) \
                if ttl is not None else PERMANENT_MS
            map_.update_location(marker.get_id(), marker, marker.get_mode(),
                                 timestamp_ms=ts)
            current[key] = marker
        if group == "static":
            self.markers = dict(update)

    def start_thread(self):
        if self.thread is None:
            self.event.clear()
            self.thread = threading.Thread(target=self._run, daemon=True,
                                           name="Markers")
            self.thread.start()

    def stop_thread(self):
        if self.thread is not None:
            self.event.set()
            self.thread.join(timeout=5)
            self.thread = None

    def _run(self):
        self.refresh()
        while not self.event.is_set():
            # refresh at the top of each hour (reference behavior)
            wait_s = (60 - datetime.utcnow().minute) * 60
            if self.event.wait(wait_s):
                break
            self.refresh()
        logger.info("marker thread stopped")
