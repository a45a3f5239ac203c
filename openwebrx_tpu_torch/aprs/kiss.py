"""KISS protocol deframer (reference ``owrx/aprs/kiss.py:15``).

KISS frames are FEND-delimited with FESC escaping; data frames carry a
0x00 port/command byte before the AX.25 payload.
"""

from __future__ import annotations

FEND = 0xC0
FESC = 0xDB
TFEND = 0xDC
TFESC = 0xDD


class KissDeframer:
    """Streaming deframer: feed bytes, yields AX.25 frame payloads."""

    def __init__(self):
        self._buf = bytearray()
        self._escaped = False

    def parse(self, data: bytes):
        for b in data:
            if self._escaped:
                if b == TFEND:
                    self._buf.append(FEND)
                elif b == TFESC:
                    self._buf.append(FESC)
                # invalid escapes are dropped
                self._escaped = False
            elif b == FESC:
                self._escaped = True
            elif b == FEND:
                if len(self._buf) > 1 and self._buf[0] == 0x00:
                    yield bytes(self._buf[1:])
                self._buf = bytearray()
            else:
                self._buf.append(b)


def kiss_escape(payload: bytes) -> bytes:
    """Encode one KISS data frame (for tests and TNC control)."""
    out = bytearray([FEND, 0x00])
    for b in payload:
        if b == FEND:
            out += bytes([FESC, TFEND])
        elif b == FESC:
            out += bytes([FESC, TFESC])
        else:
            out.append(b)
    out.append(FEND)
    return bytes(out)
