"""Status/metadata channels for external broadcast decoders.

The round-2 frontend grew DRM/DAB/HDR meta panels with no server-side
feeder (VERDICT r2 task 6); this module supplies the feeders, matching
the reference's mechanisms:

- **DRM**: dream ≥2.2 serves newline-delimited JSON status on a unix
  socket passed via ``--status-socket`` (reference
  ``csdr/module/drm.py`` socket setup, ``owrx/drm.py:11``
  DrmStatusMonitor reconnect loop).  ``DrmStatusMonitor`` here is the
  asyncio-free equivalent: a daemon thread with exponential backoff.
- **DAB**: the ETI frontend emits metadata including
  ``coarse_frequency_shift`` / ``fine_frequency_shift``; the reference
  nudges the pre-decoder Shift from them (AFC feedback loop,
  ``csdr/chain/dablin.py:16-57`` MetaProcessor).  ``DabAfc`` replicates
  the nudge arithmetic (deterministically — the reference scales the
  coarse step by ``random()``; we use the expected value, half the max
  step) and ``DabMetaParser`` forwards ensemble/service labels.
- **HDR**: nrsc5 reports station info as log lines (the reference binds
  libnrsc5 and translates events, ``csdr/module/nrsc5.py``; the CLI
  prints the same facts as ``Station name:`` / ``Title:`` … lines).

All three forward dicts with a ``mode`` key ("DRM"/"DAB"/"HDR") — the
shape the MetaPanel family consumes over the metadata websocket message.
"""

from __future__ import annotations

import json
import logging
import re
import socket
import threading
import time

logger = logging.getLogger(__name__)


class DrmStatusMonitor(threading.Thread):
    """Read newline-delimited JSON from dream's unix status socket.

    Reconnects with backoff while the decoder starts up (dream creates
    the socket only once it is running).  Forwards each status dict to
    ``on_meta`` with ``mode="DRM"`` (the decoder's own ``mode`` key —
    the DRM robustness mode A-D — is renamed ``drm_mode``, reference
    ``csdr/chain/drm.py:58-66``)."""

    def __init__(self, socket_path: str, on_meta):
        super().__init__(daemon=True, name="drm-status")
        self.socket_path = socket_path
        self.on_meta = on_meta
        self._stop = threading.Event()

    def run(self):
        delay = 0.5
        while not self._stop.is_set():
            sock = None
            try:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.settimeout(2.0)
                sock.connect(self.socket_path)
                delay = 0.5
                buf = b""
                while not self._stop.is_set():
                    try:
                        data = sock.recv(4096)
                    except socket.timeout:
                        continue
                    if not data:
                        break
                    buf += data
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        self._emit(line)
            except OSError:
                pass
            finally:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
            self._stop.wait(delay)
            delay = min(delay * 1.5, 10.0)

    def _emit(self, line: bytes):
        try:
            status = json.loads(line.decode("utf-8", "replace"))
        except json.JSONDecodeError:
            return
        if not isinstance(status, dict):
            return
        if "mode" in status:
            status["drm_mode"] = status["mode"]
        status["mode"] = "DRM"
        try:
            self.on_meta(status)
        except Exception:
            logger.exception("DRM status callback failed")

    def stop(self):
        self._stop.set()


class DabAfc:
    """AFC feedback from ETI-frontend metadata → IQ shift nudges.

    Reference arithmetic (``csdr/chain/dablin.py:16-57``): coarse shifts
    step the NCO by up to 32/2048000 of the rate against the reported
    direction (scaled by random() there; expected-value 16/2048000
    here), fine shifts >10 Hz-units step by −value/3/2048000, and the
    total is clamped to ±1 kHz (DAB carrier spacing).  ``nudge_hz``
    receives the ABSOLUTE shift in Hz to apply to the channel offset.
    """

    IF_RATE = 2048000.0
    COARSE_HZ = -16.0          # expected value of reference's random()*32
    FINE_HZ_PER_UNIT = -1.0 / 3.0
    MAX_SHIFT_HZ = 1000.0

    def __init__(self, nudge_hz):
        self.nudge_hz = nudge_hz
        self.shift_hz = 0.0

    def process(self, meta: dict) -> dict:
        """Consume AFC keys, apply nudges; return the passthrough keys."""
        out = {}
        for key, value in meta.items():
            if key == "coarse_frequency_shift":
                self._nudge(self.COARSE_HZ if value > 0 else -self.COARSE_HZ)
            elif key == "fine_frequency_shift":
                if abs(value) > 10:
                    self._nudge(self.FINE_HZ_PER_UNIT * value)
            else:
                out[key] = value
        return out

    def _nudge(self, amount_hz: float):
        self.shift_hz = max(-self.MAX_SHIFT_HZ,
                            min(self.MAX_SHIFT_HZ, self.shift_hz + amount_hz))
        try:
            self.nudge_hz(self.shift_hz)
        except Exception:
            logger.exception("DAB AFC nudge failed")

    def reset(self):
        self.shift_hz = 0.0
        try:
            self.nudge_hz(0.0)
        except Exception:
            pass


class DabMetaParser:
    """ETI-frontend / dablin metadata lines → MetaPanel dicts.

    JSON lines (csdr-eti style: ensemble_id/ensemble_label/services/
    AFC keys) pass through minus the AFC keys; dablin's human-readable
    stderr (``ENSEMBLE "label"``, ``Found audio service: SId 0xXXXX,
    'label'``, ``Playing service 'label'``) is parsed into the same
    shape."""

    _ENSEMBLE = re.compile(r'ENSEMBLE\s+"(?P<label>[^"]*)"')
    _SERVICE = re.compile(
        r"(?:Found audio service|audio service):?\s*SId\s*0x(?P<sid>[0-9A-Fa-f]+)"
        r"[ ,]*'(?P<label>[^']*)'")
    _PLAYING = re.compile(r"Playing service\s+'(?P<label>[^']*)'")

    def __init__(self, on_meta, afc: DabAfc | None = None):
        self.on_meta = on_meta
        self.afc = afc
        self._services: dict[str, str] = {}

    def feed_line(self, line: bytes):
        text = line.decode("utf-8", "replace").strip()
        if not text:
            return
        if text.startswith("{"):
            try:
                meta = json.loads(text)
            except json.JSONDecodeError:
                return
            if self.afc is not None:
                meta = self.afc.process(meta)
            if meta:
                self._emit(meta)
            return
        m = self._ENSEMBLE.search(text)
        if m:
            self._emit({"ensemble_label": m.group("label")})
            return
        m = self._SERVICE.search(text)
        if m:
            sid = m.group("sid").upper()
            self._services[sid] = m.group("label")
            self._emit({"services": [
                {"service_id": k, "label": v}
                for k, v in sorted(self._services.items())]})
            return
        m = self._PLAYING.search(text)
        if m:
            self._emit({"service_label": m.group("label")})

    def _emit(self, meta: dict):
        meta = dict(meta)
        meta["mode"] = "DAB"
        try:
            self.on_meta(meta)
        except Exception:
            logger.exception("DAB meta callback failed")


class HdrMetaParser:
    """nrsc5 CLI log lines → MetaPanel dicts (mode="HDR").

    Recognized facts (the same ones the reference extracts from libnrsc5
    events, ``csdr/module/hdradio.py``): station name/slogan, program
    title/artist/album, audio bit rate, synchronization state."""

    _FIELDS = {
        "Station name": "station",
        "Slogan": "slogan",
        "Title": "title",
        "Artist": "artist",
        "Album": "album",
        "Genre": "genre",
        "Message": "message",
    }
    _BITRATE = re.compile(r"Audio bit rate:\s*([\d.]+)\s*kbps")
    _LINE = re.compile(r"^(?:[\d:. -]*)?(?P<key>[A-Za-z ]+):\s*(?P<val>.+)$")

    def __init__(self, on_meta):
        self.on_meta = on_meta
        self.state: dict[str, object] = {}

    def feed_line(self, line: bytes):
        text = line.decode("utf-8", "replace").strip()
        if not text:
            return
        if "Synchronized" in text:
            self._update({"sync": "Lost" not in text})
            return
        m = self._BITRATE.search(text)
        if m:
            self._update({"bitrate_kbps": float(m.group(1))})
            return
        m = self._LINE.match(text)
        if m and m.group("key").strip() in self._FIELDS:
            self._update({self._FIELDS[m.group("key").strip()]:
                          m.group("val").strip()})

    def _update(self, fields: dict):
        self.state.update(fields)
        meta = dict(self.state)
        meta["mode"] = "HDR"
        try:
            self.on_meta(meta)
        except Exception:
            logger.exception("HDR meta callback failed")
