"""PSK31/PSK63: DBPSK symbol decision + varicode text decoding (host side).

Reference analogs: DBPskDecoder + VaricodeDecoder (reference
``csdr/chain/digimodes.py:77-78``).  Varicode per the public PSK31 spec:
characters are variable-length bit patterns with no "00" inside, separated
by "00"; bit 1 = no phase reversal, bit 0 = reversal.
"""

from __future__ import annotations

import numpy as np

# public PSK31 varicode table (G3PLX), index = ASCII code.  Every code
# starts and ends with 1 and contains no "00" (the inter-character gap is
# the only place two zeros appear) — asserted below, because round 4
# shipped a corrupted 'I'..'a' region that silently mapped those letters
# to garbage (uppercase text and 'a' never decoded).
_VARICODE = [
    "1010101011", "1011011011", "1011101101", "1101110111", "1011101011",
    "1101011111", "1011101111", "1011111101", "1011111111", "11101111",
    "11101", "1101101111", "1011011101", "11111", "1101110101", "1110101011",
    "1011110111", "1011110101", "1110101101", "1110101111", "1101011011",
    "1101101011", "1101101101", "1101010111", "1101111011", "1101111101",
    "1110110111", "1101010101", "1101011101", "1110111011", "1011111011",
    "1101111111",
    "1",          # space
    "111111111", "101011111", "111110101", "111011011", "1011010101",
    "1010111011", "101111111", "11111011", "11110111", "101101111",
    "111011111", "1110101", "110101", "1010111", "110101111",
    "10110111", "10111101", "11101101", "11111111", "101110111",
    "101011011", "101101011", "110101101", "110101011", "110110111",
    "11110101", "110111101", "111101101", "1010101", "111010111",
    "1010101111", "1010111101",
    "1111101", "11101011", "10101101", "10110101", "1110111", "11011011",
    "11111101", "101010101", "1111111", "111111101", "101111101",
    "11010111", "10111011", "11011101", "10101011", "11010101",
    "111011101", "10101111", "1101111", "1101101", "101010111",
    "110110101", "101011101", "101110101", "101111011", "1010101101",
    "111110111", "111101111", "111111011", "1010111111", "101101101",
    "1011011111",
    "1011", "1011111", "101111", "101101", "11", "111101", "1011011",
    "101011", "1101", "111101011", "10111111", "11011", "111011", "1111",
    "111", "111111", "110111111", "10101", "10111", "101", "110111",
    "1111011", "1101011", "11011111", "1011101", "111010101",
    "1010110111", "110111011", "1010110101", "1011010111", "1110110101",
]
assert len(_VARICODE) == 128
assert all(c[0] == "1" and c[-1] == "1" and "00" not in c
           for c in _VARICODE)
assert len(set(_VARICODE)) == 128, "varicode entries must be unique"

_DECODE = {}
for code_point, bits in enumerate(_VARICODE):
    _DECODE.setdefault(bits, code_point)


def dbpsk_bits(symbols: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
    """Differential BPSK: bit = 1 if no phase reversal between consecutive
    symbols (|Δφ| < 90°), 0 on reversal.  Returns uint8 bits (n−1,)."""
    if valid is not None:
        symbols = symbols[np.asarray(valid, bool)]
    if len(symbols) < 2:
        return np.empty(0, np.uint8)
    d = symbols[1:] * np.conj(symbols[:-1])
    return (d.real > 0).astype(np.uint8)


class VaricodeDecoder:
    """Streaming varicode decoder: feed bits, get text."""

    def __init__(self):
        self._bits = ""
        self._zeros = 0

    def decode(self, bits: np.ndarray) -> str:
        out = []
        for b in bits:
            if b:
                self._bits += "1"
                self._zeros = 0
            else:
                self._zeros += 1
                if self._zeros >= 2:
                    # the first separator zero was appended to the code —
                    # codes always end in 1, so strip it
                    code = self._bits[:-1] if self._bits.endswith("0") else self._bits
                    if code:
                        cp = _DECODE.get(code)
                        if cp is not None and cp < 128:
                            out.append(chr(cp))
                    self._bits = ""
                    self._zeros = 0
                elif self._bits:
                    # codes start with 1 — a zero during idle is not a
                    # code bit, only an intra-code single zero is
                    self._bits += "0"
        # guard against unbounded garbage between characters
        if len(self._bits) > 16:
            self._bits = ""
        return "".join(out)
