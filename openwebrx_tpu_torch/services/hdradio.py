"""HD Radio (NRSC-5) in-process decode via the public libnrsc5 C API.

Reference analog: ``csdr/module/nrsc5.py`` (644 LoC ctypes binding with a
Throttle).  This is a minimal original binding covering exactly what the
receiver consumes: pipe-mode input (IQ pushed from the TPU channel, cs16
at 744187.5 S/s FM), the event callback, and the AUDIO / ID3 / SIS /
SYNC / BER events that feed the client's audio path and meta panel.
Feature-gated on ``libnrsc5.so`` being loadable; without it the runtime
falls back to piping the ``nrsc5`` binary (ExecAudioHandle).

Structure layouts follow the public ``nrsc5.h`` event ABI (event id +
union); only the union members we read are declared — the library owns
the allocation, so a partial view is safe.
"""

from __future__ import annotations

import ctypes
import logging
import threading

logger = logging.getLogger(__name__)

# nrsc5.h public constants
MODE_FM = 0
MODE_AM = 1
EVENT_SYNC = 2
EVENT_LOST_SYNC = 3
EVENT_MER = 4
EVENT_BER = 5
EVENT_AUDIO = 7
EVENT_ID3 = 8
EVENT_SIS = 11
SAMPLE_RATE_CS16_FM = 744187.5
SAMPLE_RATE_AUDIO = 44100


class _AudioEvent(ctypes.Structure):
    _fields_ = [("program", ctypes.c_uint),
                ("data", ctypes.POINTER(ctypes.c_char)),
                ("count", ctypes.c_size_t)]


class _ID3Event(ctypes.Structure):
    _fields_ = [("program", ctypes.c_uint),
                ("title", ctypes.c_char_p),
                ("artist", ctypes.c_char_p),
                ("album", ctypes.c_char_p),
                ("genre", ctypes.c_char_p)]


class _BerEvent(ctypes.Structure):
    _fields_ = [("cber", ctypes.c_float)]


class _SisEvent(ctypes.Structure):
    _fields_ = [("country_code", ctypes.c_char_p),
                ("fcc_facility_id", ctypes.c_int),
                ("name", ctypes.c_char_p),
                ("slogan", ctypes.c_char_p),
                ("message", ctypes.c_char_p)]


class _EventUnion(ctypes.Union):
    _fields_ = [("audio", _AudioEvent),
                ("id3", _ID3Event),
                ("ber", _BerEvent),
                ("sis", _SisEvent),
                ("_pad", ctypes.c_char * 256)]   # cover larger ABI members


class _Event(ctypes.Structure):
    _fields_ = [("event", ctypes.c_uint), ("u", _EventUnion)]


_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.POINTER(_Event), ctypes.c_void_p)

_LIB = None
_LIB_TRIED = False


def load_library(path: str = "libnrsc5.so"):
    """Load libnrsc5 once; returns the CDLL or None (feature gate)."""
    global _LIB, _LIB_TRIED
    if _LIB is None and not _LIB_TRIED:
        _LIB_TRIED = True
        try:
            _LIB = ctypes.cdll.LoadLibrary(path)
        except OSError:
            logger.debug("libnrsc5 not available; HDR uses the exec path")
    return _LIB


def available() -> bool:
    return load_library() is not None


class HdRadioDecoder:
    """Pipe-mode NRSC-5 decoder: feed cs16 IQ at 744187.5 S/s, receive
    44.1 kHz s16 stereo audio + station metadata through callbacks.

    on_audio(bytes)  — stereo s16 PCM for the selected program
    on_meta(dict)    — {"mode": "HDR", ...} panel metadata updates
    """

    def __init__(self, on_audio, on_meta=None, program: int = 0,
                 mode: int = MODE_FM, lib=None):
        self._lib = lib or load_library()
        if self._lib is None:
            raise RuntimeError("libnrsc5 not available")
        self.on_audio = on_audio
        self.on_meta = on_meta
        self.program = int(program)
        self.radio = ctypes.c_void_p()
        self._lock = threading.Lock()
        self._synced = False
        if self._lib.nrsc5_open_pipe(ctypes.byref(self.radio)) != 0:
            raise RuntimeError("nrsc5_open_pipe failed")
        self._lib.nrsc5_set_mode(self.radio, mode)
        # the callback object must outlive the radio — keep a reference
        self._cb = _CALLBACK(self._on_event)
        self._lib.nrsc5_set_callback(self.radio, self._cb, None)
        self._lib.nrsc5_start(self.radio)

    def _on_event(self, evt_ptr, _opaque):
        try:
            evt = evt_ptr.contents
            kind = evt.event
            if kind == EVENT_AUDIO:
                a = evt.u.audio
                if a.program == self.program and self.on_audio is not None:
                    # count is in s16 samples (nrsc5.h)
                    self.on_audio(ctypes.string_at(a.data, a.count * 2))
            elif kind == EVENT_ID3 and self.on_meta is not None:
                i = evt.u.id3
                if i.program == self.program:
                    meta = {"mode": "HDR", "program": int(i.program)}
                    for key in ("title", "artist", "album", "genre"):
                        v = getattr(i, key)
                        if v:
                            meta[key] = v.decode(errors="replace")
                    self.on_meta(meta)
            elif kind == EVENT_SIS and self.on_meta is not None:
                s = evt.u.sis
                meta = {"mode": "HDR"}
                if s.name:
                    meta["station"] = s.name.decode(errors="replace")
                if s.slogan:
                    meta["slogan"] = s.slogan.decode(errors="replace")
                self.on_meta(meta)
            elif kind in (EVENT_SYNC, EVENT_LOST_SYNC):
                self._synced = kind == EVENT_SYNC
                if self.on_meta is not None:
                    self.on_meta({"mode": "HDR",
                                  "sync": bool(self._synced)})
            elif kind == EVENT_BER and self.on_meta is not None:
                self.on_meta({"mode": "HDR",
                              "ber": round(float(evt.u.ber.cber), 6)})
        except Exception:
            logger.exception("nrsc5 event handling failed")

    def set_program(self, program: int):
        self.program = int(program)

    def feed(self, cs16: bytes):
        """Push interleaved cs16 IQ (little-endian) into the decoder."""
        with self._lock:
            if self.radio:
                buf = ctypes.create_string_buffer(cs16, len(cs16))
                self._lib.nrsc5_pipe_samples_cs16(self.radio, buf,
                                                  len(cs16) // 2)

    def close(self):
        with self._lock:
            if self.radio:
                self._lib.nrsc5_stop(self.radio)
                self._lib.nrsc5_close(self.radio)
                self.radio = ctypes.c_void_p()
