"""ctypes bindings for the native IQ ingest library (native/iq_ingest.cpp).

Auto-builds the shared library with g++ on first use (no pybind11 in this
image; the C ABI + ctypes keeps the binding dependency-free).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libiq_ingest.so")

FORMAT_F32 = 0
FORMAT_S16 = 1
FORMAT_U8 = 2

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = os.path.join(_NATIVE_DIR, "iq_ingest.cpp")
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src)):
            logger.info("building native iq_ingest library")
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.iq_ring_create.restype = ctypes.c_void_p
        lib.iq_ring_create.argtypes = [ctypes.c_uint64]
        lib.iq_ring_connect.restype = ctypes.c_int
        lib.iq_ring_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int, ctypes.c_int]
        lib.iq_ring_start_fd.restype = ctypes.c_int
        lib.iq_ring_start_fd.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int]
        lib.iq_ring_read.restype = ctypes.c_uint64
        lib.iq_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_uint64, ctypes.c_int]
        lib.iq_ring_read_s16.restype = ctypes.c_uint64
        lib.iq_ring_read_s16.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_uint64, ctypes.c_int]
        lib.iq_ring_available.restype = ctypes.c_uint64
        lib.iq_ring_available.argtypes = [ctypes.c_void_p]
        lib.iq_ring_overruns.restype = ctypes.c_uint64
        lib.iq_ring_overruns.argtypes = [ctypes.c_void_p]
        lib.iq_ring_eof.restype = ctypes.c_int
        lib.iq_ring_eof.argtypes = [ctypes.c_void_p]
        lib.iq_ring_read_u8.restype = ctypes.c_uint64
        lib.iq_ring_read_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_uint64, ctypes.c_int]
        lib.iq_ring_set_blocking.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.iq_ring_stop.argtypes = [ctypes.c_void_p]
        lib.iq_ring_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class IqIngest:
    """Native ring-buffered IQ ingest (reference TcpSource + Buffer)."""

    def __init__(self, capacity_samples: int = 1 << 22):
        self._lib = _load()
        self._ring = self._lib.iq_ring_create(capacity_samples)
        self._closed = False
        self._pools: dict[str, list] = {}
        self._pool_idx: dict[str, int] = {}

    def connect(self, host: str, port: int, fmt: int = FORMAT_F32):
        if self._lib.iq_ring_connect(self._ring, host.encode(), port, fmt) != 0:
            raise ConnectionError(f"native connect to {host}:{port} failed")

    def start_fd(self, fd: int, fmt: int = FORMAT_F32):
        if self._lib.iq_ring_start_fd(self._ring, fd, fmt) != 0:
            raise RuntimeError("ingest already running")

    def set_blocking(self, blocking: bool = True):
        """Backpressure mode: when the ring is full the ingest thread
        WAITS instead of dropping oldest samples — for file replay and
        bench feeds, where the producer should stall (pipe backpressure)
        rather than burn CPU converting samples that get dropped.  Live
        SDR sources keep the default drop-oldest streaming semantics."""
        self._lib.iq_ring_set_blocking(self._ring, 1 if blocking else 0)

    _POOL = 8   # rotating output buffers; larger than any pipeline depth

    def _pooled(self, key, shape, dtype) -> np.ndarray:
        """Rotating pre-faulted output buffer.  A fresh np.empty per block
        costs first-touch page faults (~45 ms for a 13 MB block on this
        class of host — measured round 5, dominating the read); rotating
        through a small pool amortizes the faults to zero.  Pool depth 8
        exceeds every pipeline depth in the tree, so a buffer is never
        recycled while a device transfer may still reference it."""
        pool = self._pools.setdefault(key, [])
        if len(pool) < self._POOL:
            buf = np.zeros(shape, dtype)        # zeros → faulted now
            pool.append(buf)
            return buf
        idx = self._pool_idx.get(key, 0) % self._POOL
        self._pool_idx[key] = idx + 1
        buf = pool[idx]
        if buf.shape != shape:                  # block size changed:
            buf = np.zeros(shape, dtype)        # repair THIS slot (the
            pool[idx] = buf                     # one just read), so the
        return buf                              # rotation stays distinct

    def read_block(self, n_samples: int, timeout: float = 2.0) -> np.ndarray | None:
        """Blocking read of exactly n complex64 samples (None on timeout/EOF
        with no data)."""
        out = self._pooled("c64", (n_samples,), np.complex64)
        got = self._lib.iq_ring_read(
            self._ring, out.ctypes.data_as(ctypes.c_void_p), n_samples,
            int(timeout * 1000))
        if got == 0:
            return None
        if got < n_samples:
            out[got:] = 0
        return out

    def read_block_packed(self, n_samples: int,
                          timeout: float = 2.0) -> np.ndarray | None:
        """Blocking read of exactly n samples as packed (n, 2) int16 wire
        samples (±32767 ↔ ±1.0) — HALF the host→device bytes of complex64;
        the jit boundary converts to float on the accelerator
        (runtime/chain.py _unpack_leaf)."""
        out = self._pooled("s16", (n_samples, 2), np.int16)
        got = self._lib.iq_ring_read_s16(
            self._ring, out.ctypes.data_as(ctypes.c_void_p), n_samples,
            int(timeout * 1000))
        if got == 0:
            return None
        if got < n_samples:
            out[got:] = 0
        return out

    def read_block_packed_u8(self, n_samples: int,
                             timeout: float = 2.0) -> np.ndarray | None:
        """Blocking read of exactly n samples as packed (n, 2) uint8 wire
        samples (rtl-sdr convention, ±1.0 ↔ 127.4±128) — a QUARTER of the
        host→device bytes of complex64.  The right wire for 8-bit-native
        SDRs (rtl-sdr) and for transports where the input stream is the
        bandwidth bottleneck; the jit boundary converts to float on the
        accelerator (runtime/chain.py _unpack_leaf)."""
        out = self._pooled("u8", (n_samples, 2), np.uint8)
        got = self._lib.iq_ring_read_u8(
            self._ring, out.ctypes.data_as(ctypes.c_void_p), n_samples,
            int(timeout * 1000))
        if got == 0:
            return None
        if got < n_samples:
            out[got:] = 127
        return out

    @property
    def samples_available(self) -> int:
        return self._lib.iq_ring_available(self._ring)

    @property
    def overruns(self) -> int:
        return self._lib.iq_ring_overruns(self._ring)

    @property
    def eof(self) -> bool:
        return bool(self._lib.iq_ring_eof(self._ring))

    def stop(self):
        if not self._closed:
            self._lib.iq_ring_stop(self._ring)

    def close(self):
        if not self._closed:
            self._lib.iq_ring_destroy(self._ring)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
