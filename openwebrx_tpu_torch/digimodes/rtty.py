"""RTTY: bit framing + ITA2 (Baudot) decoding (host side).

Reference analogs: RttyDecoder + BaudotDecoder (reference
``csdr/chain/digimodes.py:108-109``).  The device chain delivers hard bits
at the symbol rate (mark=1/space=0 from the FSK discriminator + timing
recovery); this module frames start/stop (1 start bit 0, 5 data bits LSB
first, ≥1.5 stop bits 1) and maps ITA2 letters/figures with shift state.
"""

from __future__ import annotations

import numpy as np

ITA2_LETTERS = [
    "\x00", "E", "\n", "A", " ", "S", "I", "U", "\r", "D", "R", "J", "N",
    "F", "C", "K", "T", "Z", "L", "W", "H", "Y", "P", "Q", "O", "B", "G",
    "\x0e", "M", "X", "V", "\x0f",
]
ITA2_FIGURES = [
    "\x00", "3", "\n", "-", " ", "'", "8", "7", "\r", "\x05", "4", "\x07",
    ",", "!", ":", "(", "5", "+", ")", "2", "£", "6", "0", "1", "9", "?",
    "&", "\x0e", ".", "/", "=", "\x0f",
]
LTRS = 0x1F
FIGS = 0x1B


class BaudotDecoder:
    """Streaming ITA2 with letters/figures shift state."""

    def __init__(self):
        self.figures = False

    def decode_code(self, code: int) -> str:
        if code == LTRS:
            self.figures = False
            return ""
        if code == FIGS:
            self.figures = True
            return ""
        table = ITA2_FIGURES if self.figures else ITA2_LETTERS
        ch = table[code & 0x1F]
        return ch if ch >= " " or ch in "\r\n" else ""


class RttyFramer:
    """Async start/stop framing: 1 start (0), 5 data LSB-first, stop (1)."""

    def __init__(self):
        self.baudot = BaudotDecoder()
        self._bits: list[int] = []
        self._in_char = False

    def decode(self, bits: np.ndarray) -> str:
        out = []
        for bit in bits:
            bit = int(bit)
            if not self._in_char:
                if bit == 0:  # start bit
                    self._in_char = True
                    self._bits = []
            else:
                self._bits.append(bit)
                if len(self._bits) == 6:  # 5 data + 1 stop
                    data, stop = self._bits[:5], self._bits[5]
                    self._in_char = False
                    if stop == 1:  # valid frame
                        code = sum(b << i for i, b in enumerate(data))
                        out.append(self.baudot.decode_code(code))
                    # stop==0 → framing error, resync on next 0→ start
        return "".join(out)
