"""GPS updater: track receiver position from gpsd.

Reference: ``owrx/gps.py:29`` — gpsd JSON-over-TCP client thread (WATCH
command, TPV reports) updating ``receiver_gps`` live.
"""

from __future__ import annotations

import json
import logging
import socket
import threading

logger = logging.getLogger(__name__)


class GpsUpdater(threading.Thread):
    _instance = None

    @classmethod
    def init(cls):
        from openwebrx_tpu_torch.core.config import Config
        if not Config.get().get("gps_updates"):
            return None
        if cls._instance is None:
            cls._instance = GpsUpdater()
            cls._instance.start()
        return cls._instance

    def __init__(self, host: str = "127.0.0.1", port: int = 2947):
        super().__init__(name="gps-updater", daemon=True)
        self.host = host
        self.port = port
        self._stop = threading.Event()

    def run(self):
        while not self._stop.is_set():
            try:
                self._session()
            except OSError as e:
                logger.warning("gpsd connection failed: %s", e)
            self._stop.wait(60)

    def _session(self):
        sock = socket.create_connection((self.host, self.port), timeout=10)
        sock.sendall(b'?WATCH={"enable":true,"json":true};\n')
        buf = b""
        sock.settimeout(30)
        while not self._stop.is_set():
            data = sock.recv(4096)
            if not data:
                return
            buf += data
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                self._handle(line)

    def _handle(self, line: bytes):
        try:
            report = json.loads(line)
        except json.JSONDecodeError:
            return
        if report.get("class") == "TPV" and "lat" in report and "lon" in report:
            from openwebrx_tpu_torch.core.config import Config
            Config.get()["receiver_gps"] = {"lat": report["lat"],
                                            "lon": report["lon"]}

    def stop(self):
        self._stop.set()
