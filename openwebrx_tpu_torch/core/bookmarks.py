"""Bookmark store: server-side named frequencies with change subscriptions.

Reference: ``owrx/bookmarks.py:14-228`` — JSON file store, range
subscriptions notifying clients whose view covers a changed bookmark,
SCANNABLE_MODES for the client-side scanner.
"""

from __future__ import annotations

import json
import os
import threading


def _packs_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "data", "bookmarks.d")

SCANNABLE_MODES = ["nfm", "wfm", "am", "sam", "lsb", "usb", "cw"]


class Bookmark:
    def __init__(self, data: dict):
        self.name = data.get("name", "")
        self.frequency = float(data.get("frequency", 0))
        self.modulation = data.get("modulation", "nfm")
        self.underlying = data.get("underlying", "")
        self.description = data.get("description", "")
        self.scannable = data.get("scannable", self.modulation in SCANNABLE_MODES)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "frequency": self.frequency,
            "modulation": self.modulation,
            "underlying": self.underlying,
            "description": self.description,
            "scannable": self.scannable,
        }


class Bookmarks:
    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def shared() -> "Bookmarks":
        with Bookmarks._lock:
            if Bookmarks._instance is None:
                from openwebrx_tpu_torch.core.config import CoreConfig
                path = os.path.join(CoreConfig.defaults["data_directory"],
                                    "bookmarks.json")
                Bookmarks._instance = Bookmarks(path)
            return Bookmarks._instance

    def __init__(self, path: str | None = None):
        self.path = path
        self.bookmarks: list[Bookmark] = []
        # read-only entries from the shipped packs (data/bookmarks.d/*,
        # the reference's bookmarks.d equivalent): merged into reads,
        # never written back to the user's bookmarks.json
        self.pack_bookmarks: list[Bookmark] = []
        self.subscriptions: list[tuple[tuple, object]] = []
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self.bookmarks = [Bookmark(b) for b in json.load(f)]
            except (OSError, json.JSONDecodeError, ValueError):
                self.bookmarks = []
        self._load_packs()

    @staticmethod
    def available_packs() -> list[str]:
        d = _packs_dir()
        try:
            return sorted(f[:-5] for f in os.listdir(d)
                          if f.endswith(".json"))
        except OSError:
            return []

    def _load_packs(self):
        """Packs selected by the ``bookmark_packs`` config key (a list of
        pack names, or "all")."""
        try:
            from openwebrx_tpu_torch.core.config import Config
            selected = Config.get().get("bookmark_packs")
        except Exception:
            selected = None
        if not selected:
            return
        if selected == "all":
            names = self.available_packs()
        elif isinstance(selected, str):
            # a bare pack name (string instead of list) — don't iterate
            # its characters
            names = [selected]
        else:
            names = selected
        for name in names:
            p = os.path.join(_packs_dir(), f"{os.path.basename(name)}.json")
            try:
                with open(p) as f:
                    self.pack_bookmarks += [Bookmark(b)
                                            for b in json.load(f)]
            except (OSError, json.JSONDecodeError, ValueError):
                continue

    def get_bookmarks(self, frequency_range=None) -> list[Bookmark]:
        allb = self.bookmarks + self.pack_bookmarks
        if frequency_range is None:
            return allb
        low, high = frequency_range
        return [b for b in allb if low <= b.frequency <= high]

    def add(self, bookmark: Bookmark):
        self.bookmarks.append(bookmark)
        self.store()
        self._notify(bookmark.frequency)

    def remove(self, name: str):
        before = len(self.bookmarks)
        removed = [b for b in self.bookmarks if b.name == name]
        self.bookmarks = [b for b in self.bookmarks if b.name != name]
        if len(self.bookmarks) != before:
            self.store()
            for b in removed:
                self._notify(b.frequency)

    def store(self):
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump([b.to_json() for b in self.bookmarks], f, indent=2)
        os.replace(tmp, self.path)

    def subscribe(self, frequency_range: tuple, cb) -> object:
        sub = (frequency_range, cb)
        self.subscriptions.append(sub)
        return sub

    def unsubscribe(self, sub):
        if sub in self.subscriptions:
            self.subscriptions.remove(sub)

    def _notify(self, freq: float):
        for (low, high), cb in list(self.subscriptions):
            if low <= freq <= high:
                try:
                    cb()
                except Exception:
                    pass
