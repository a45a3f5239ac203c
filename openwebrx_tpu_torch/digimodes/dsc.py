"""DSC (Digital Selective Calling) decoding, host side — CCIR 493.

Reference analogs: native ``DscDecoder`` / ``Ccir493Decoder``
(``csdr/chain/digimodes.py:320-322``, ``owrx/marine.py``).  HF DSC is
100 Bd FSK ±85 Hz (the RTTY device chain at those parameters feeds this).

CCIR 493 layer: 10-bit symbols = 7 data bits (LSB first) + 3-bit check
(the count of ZEROS in the 7 data bits); a call sequence carries symbols
twice (DX, then RX five symbols later).  The message body encodes format
specifier, addresses (MMSI as 5 symbol pairs), category, telecommands and
EOS.
"""

from __future__ import annotations

import numpy as np

# symbol values (0..127); selected service symbols
FMT_DISTRESS = 112
FMT_ALL_SHIPS = 116
FMT_GROUP = 114
FMT_SELECTIVE = 120
FMT_AREA = 102
FMT_AUTO = 123
EOS_REQ = 117
EOS_ACK = 122
EOS_NONE = 127

FORMATS = {
    FMT_DISTRESS: "distress", FMT_ALL_SHIPS: "all ships",
    FMT_GROUP: "group", FMT_SELECTIVE: "selective",
    FMT_AREA: "area", FMT_AUTO: "automatic",
}

CATEGORIES = {100: "routine", 108: "safety", 110: "urgency", 112: "distress"}

# nature of distress (ITU-R M.493 table: symbol 100..112)
NATURES = {100: "fire/explosion", 101: "flooding", 102: "collision",
           103: "grounding", 104: "listing", 105: "sinking",
           106: "disabled and adrift", 107: "undesignated",
           108: "abandoning ship", 109: "piracy/armed robbery",
           110: "man overboard", 112: "EPIRB emission"}


def encode_symbol(value: int) -> list[int]:
    """7 data bits LSB first + 3-bit zero-count check (MSB first)."""
    data = [(value >> i) & 1 for i in range(7)]
    zeros = 7 - sum(data)
    check = [(zeros >> 2) & 1, (zeros >> 1) & 1, zeros & 1]
    return data + check


def decode_symbol(bits) -> int | None:
    data = bits[:7]
    value = sum(b << i for i, b in enumerate(data))
    zeros = 7 - sum(data)
    check = (bits[7] << 2) | (bits[8] << 1) | bits[9]
    return value if check == zeros else None


def encode_call(fmt: int, address: str, category: int, body: list[int],
                eos: int = EOS_NONE) -> list[int]:
    """Build a DSC symbol stream (with DX/RX spread) for tests."""
    addr_symbols = [int(address[i: i + 2]) for i in range(0, 10, 2)] \
        if address else []
    seq = [fmt, fmt] + addr_symbols + [category] + body + [eos]
    # DX/RX: each symbol repeated 5 positions later (time diversity)
    out = []
    stream = seq + [EOS_NONE] * 5
    for i, s in enumerate(stream):
        out.append(s)
        out.append(stream[i - 5] if i >= 5 else EOS_NONE)
    bits = []
    for s in out:
        bits.extend(encode_symbol(s))
    return bits


class DscDecoder:
    """Feed bits; emits parsed call dicts via on_message."""

    def __init__(self, on_message=None):
        self.on_message = on_message
        self._bits: list[int] = []
        self._symbols: list[int | None] = []
        self._synced = False
        self._index = 0
        self._dx: dict[int, int | None] = {}
        self._seq: list[int | None] = []

    def feed_bits(self, bits: np.ndarray):
        for b in bits:
            self._bits.append(int(b))
            if not self._synced:
                # alignment lock needs TWO consecutive valid symbols at the
                # same 10-bit spacing: a single window validating by chance
                # (idle/noise before the call) must not freeze a wrong
                # boundary for the whole transmission
                if len(self._bits) >= 20:
                    first = decode_symbol(self._bits[-20:-10])
                    second = decode_symbol(self._bits[-10:])
                    if first is not None and second is not None:
                        self._synced = True
                        self._bits = []
                        self._push(first)
                        self._push(second)
                continue
            if len(self._bits) == 10:
                val = decode_symbol(self._bits)
                self._bits = []
                self._push(val)

    def _push(self, val: int | None):
        idx = self._index
        self._index += 1
        if idx % 2 == 0:
            self._dx[idx // 2] = val
            return
        char_pos = idx // 2 - 5
        dx = self._dx.pop(char_pos, None)
        chosen = dx if dx is not None else val
        self._seq.append(chosen)
        if chosen == EOS_NONE or chosen == EOS_REQ or chosen == EOS_ACK:
            self._finish(chosen)

    def _finish(self, eos: int):
        seq = [s for s in self._seq if s is not None]
        self._seq = []
        if len(seq) < 3:
            return
        # leading format specifier is doubled
        fmt = seq[0] if seq[0] == seq[1] else seq[0]
        body = seq[2:] if seq[0] == seq[1] else seq[1:]
        msg = {"mode": "DSC", "format": FORMATS.get(fmt, f"fmt{fmt}")}
        if fmt in (FMT_SELECTIVE, FMT_GROUP) and len(body) >= 5:
            msg["address"] = "".join(f"{s:02d}" for s in body[:5])
            body = body[5:]
        if fmt == FMT_DISTRESS and len(body) >= 11:
            # ITU-R M.493 distress call: self-id MMSI (5 symbols = 10
            # digits, MMSI is the first 9), nature of distress, distress
            # coordinates (5 symbols = 10 digits: quadrant, lat ddmm,
            # lon dddmm), UTC time — a decoded position puts the vessel
            # on the map (reference owrx/marine.py vessel flow)
            msg["src"] = "".join(f"{s:02d}" for s in body[:5])[:9]
            msg["mmsi"] = msg["src"]
            msg["nature"] = NATURES.get(body[5], str(body[5]))
            digits = "".join(f"{s:02d}" for s in body[6:11])
            if not digits.startswith("99"):      # 9… ⇒ position unknown
                quad = int(digits[0])
                lat = int(digits[1:3]) + int(digits[3:5]) / 60.0
                lon = int(digits[5:8]) + int(digits[8:10]) / 60.0
                if quad in (2, 3):
                    lat = -lat
                if quad in (1, 3):
                    lon = -lon
                if abs(lat) <= 90 and abs(lon) <= 180:
                    msg["lat"] = round(lat, 4)
                    msg["lon"] = round(lon, 4)
                    msg["position"] = f"{lat:.4f} {lon:.4f}"
            if len(body) >= 13:
                msg["time_utc"] = "".join(f"{s:02d}" for s in body[11:13])
            msg["category"] = "distress"
            body = []        # distress calls carry no category/body fields
        if body:
            msg["category"] = CATEGORIES.get(body[0], str(body[0]))
            msg["body"] = body[1:-1] if len(body) > 1 else []
        msg["eos"] = {EOS_REQ: "ack required", EOS_ACK: "acknowledgement",
                      EOS_NONE: "end"}.get(eos, str(eos))
        if self.on_message:
            self.on_message(msg)
