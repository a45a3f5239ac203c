"""PSKReporter sink: batched spot upload over the IPFIX-style UDP protocol.

Reference: ``owrx/reporting/pskreporter.py:17-240`` — 5-minute batches,
in-batch dedupe by (callsign, frequency-band), UDP datagrams containing
receiver + sender information records with template descriptors.

NOTE: this container has zero egress; the wire encoder is exercised by
unit tests only.  Template field layout follows the public pskreporter.info
spec (receiverCallsign/locator/decoderSoftware; senderCallsign/frequency/
mode/SNR/locator/flowStartSeconds).
"""

from __future__ import annotations

import logging
import random
import socket
import struct
import threading
import time

from openwebrx_tpu_torch.reporting import Reporter

logger = logging.getLogger(__name__)

HOST = ("report.pskreporter.info", 4739)
INTERVAL = 300  # seconds between uploads (reference: 5-minute batches)

SUPPORTED_MODES = ["FT8", "FT4", "JT65", "JT9", "FST4", "FST4W", "WSPR",
                   "Q65", "JS8", "BPSK31", "BPSK63", "MSK144"]


def _padded(data: bytes, align: int = 4) -> bytes:
    pad = (-len(data)) % align
    return data + b"\x00" * pad


def _string_field(value: str) -> bytes:
    raw = value.encode()[:255]
    return bytes([len(raw)]) + raw


# IPFIX-ish template descriptors (option template 0x99E2 = receiver,
# template 0x99E3 = sender), per the public PSKReporter datagram spec
RECEIVER_TEMPLATE = bytes.fromhex(
    "0003002C99E20003000B"
    "80020FFE0000768F"   # receiverCallsign (var len)
    "80040FFE0000768F"   # receiverLocator
    "80080FFE0000768F"   # decoderSoftware
    "0000"
)
SENDER_TEMPLATE = bytes.fromhex(
    "0002003C99E30007"
    "80010FFE0000768F"   # senderCallsign
    "800500040000768F"   # frequency (uint32)
    "800600010000768F"   # sNR (int8)
    "800A0FFE0000768F"   # mode
    "80030FFE0000768F"   # senderLocator
    "800B00010000768F"   # informationSource (int8)
    "00960004"           # flowStartSeconds
)


class PskReporter(Reporter):
    def __init__(self, callsign: str, antenna: str = "", locator: str = ""):
        self.callsign = callsign
        self.antenna = antenna
        self.locator = locator
        self._spots: list[dict] = []
        self._keys: set = set()
        self._lock = threading.Lock()
        self._seq = 0
        self._rand_id = random.randint(0, 0xFFFFFFFF)
        self._timer: threading.Timer | None = None
        self._schedule()

    def supports_mode(self, mode: str) -> bool:
        return mode in SUPPORTED_MODES

    def spot(self, spot: dict):
        if "callsign" not in spot or "locator" not in spot:
            return
        # dedupe within the batch by callsign + ~coarse frequency
        key = (spot["callsign"], int(spot.get("freq", 0) / 1000))
        with self._lock:
            if key in self._keys:
                return
            self._keys.add(key)
            self._spots.append(spot)

    def _schedule(self):
        self._timer = threading.Timer(INTERVAL, self._upload)
        self._timer.daemon = True
        self._timer.start()

    def _upload(self):
        try:
            with self._lock:
                spots, self._spots = self._spots, []
                self._keys = set()
            if spots:
                for payload in self.encode_batches(spots):
                    self._send(payload)
        except Exception:
            logger.exception("pskreporter upload failed")
        finally:
            self._schedule()

    def _send(self, payload: bytes):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.sendto(payload, HOST)
        finally:
            s.close()

    # -- wire encoding (unit-tested; see tests/test_reporting.py) ---------
    def encode_batches(self, spots: list[dict], max_spots: int = 50):
        for i in range(0, len(spots), max_spots):
            yield self.encode(spots[i: i + max_spots])

    def encode(self, spots: list[dict]) -> bytes:
        self._seq += 1
        receiver = _padded(
            _string_field(self.callsign) + _string_field(self.locator) +
            _string_field("openwebrx_tpu"))
        receiver_set = struct.pack(">HH", 0x99E2, len(receiver) + 4) + receiver
        senders = b"".join(self._encode_spot(s) for s in spots)
        senders = _padded(senders)
        sender_set = struct.pack(">HH", 0x99E3, len(senders) + 4) + senders
        body = RECEIVER_TEMPLATE + SENDER_TEMPLATE + receiver_set + sender_set
        header = struct.pack(">HHIII", 0x000A, len(body) + 16,
                             int(time.time()), self._seq, self._rand_id)
        return header + body

    def _encode_spot(self, spot: dict) -> bytes:
        return (
            _string_field(spot["callsign"])
            + struct.pack(">I", int(spot.get("freq", 0)))
            + struct.pack(">b", int(round(spot.get("db", 0))))
            + _string_field(spot.get("mode", ""))
            + _string_field(spot.get("locator", ""))
            + struct.pack(">b", 1)
            + struct.pack(">I", int(spot.get("timestamp", time.time() * 1000) / 1000))
        )

    def stop(self):
        if self._timer is not None:
            self._timer.cancel()
