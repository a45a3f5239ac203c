"""WSPRnet sink: HTTP spot upload.

Reference: ``owrx/reporting/wsprnet.py`` — POST to wsprnet.org/post with
form-encoded spot fields; WSPR/FST4W only.
"""

from __future__ import annotations

import logging
import threading
import urllib.parse
import urllib.request
from datetime import datetime, timezone
from queue import Queue, Full

from openwebrx_tpu_torch.reporting import Reporter

logger = logging.getLogger(__name__)

URL = "http://wsprnet.org/post/"


class WsprnetReporter(Reporter):
    def __init__(self, callsign: str, locator: str = ""):
        self.callsign = callsign
        self.locator = locator
        self._queue: Queue = Queue(maxsize=100)
        self._worker = threading.Thread(target=self._work, daemon=True,
                                        name="wsprnet")
        self._stop = False
        self._worker.start()

    def supports_mode(self, mode: str) -> bool:
        return mode in ("WSPR", "FST4W")

    def spot(self, spot: dict):
        try:
            self._queue.put_nowait(spot)
        except Full:
            logger.warning("wsprnet queue full, dropping spot")

    def encode(self, spot: dict) -> str:
        ts = datetime.fromtimestamp(spot.get("timestamp", 0) / 1000,
                                    tz=timezone.utc)
        return urllib.parse.urlencode({
            "function": "wspr",
            "rcall": self.callsign,
            "rgrid": self.locator,
            "rqrg": spot.get("freq", 0) / 1e6,
            "date": ts.strftime("%y%m%d"),
            "time": ts.strftime("%H%M"),
            "sig": int(round(spot.get("db", 0))),
            "dt": spot.get("dt", 0),
            "tqrg": spot.get("freq", 0) / 1e6,
            "tcall": spot.get("callsign", ""),
            "tgrid": spot.get("locator", ""),
            "dbm": spot.get("dbm", "0"),
            "version": "openwebrx_tpu",
            "mode": 2,
        })

    def _work(self):
        while not self._stop:
            spot = self._queue.get()
            if spot is None:
                return
            try:
                urllib.request.urlopen(URL, self.encode(spot).encode(),
                                       timeout=30).read()
            except Exception:
                logger.warning("wsprnet upload failed")

    def stop(self):
        self._stop = True
        try:
            self._queue.put_nowait(None)
        except Full:
            pass
