"""SITOR-B / NAVTEX decoding (host side).

Reference analogs: native ``SitorBDecoder`` / ``Ccir476Decoder`` /
``NavtexDecoder`` (reference ``csdr/chain/digimodes.py:243-322``,
``owrx/marine.py``).  The device chain is the RTTY FSK pipeline at
100 Bd / 170 Hz shift; this module does the CCIR 476 layer:

- 7-bit codewords with a constant 4:3 mark/space ratio (35 valid words);
- FEC mode B: every character is sent twice, DX then RX five characters
  later; the receiver picks whichever copy validates;
- letters/figures shift to ITA2 text;
- NAVTEX message framing (ZCZC … NNNN).

NOTE: the codeword assignment uses a deterministic enumeration of the 35
weight-4 words (the structural property CCIR 476 requires).  Over-the-air
interop needs the exact Rec. 476-4 assignment table swapped in; the FEC
framing, DX/RX selection and NAVTEX layers are table-independent and are
what the tests cover.
"""

from __future__ import annotations

import numpy as np

from openwebrx_tpu_torch.digimodes.rtty import ITA2_LETTERS, ITA2_FIGURES

# the 35 valid 7-bit words with exactly four ones: 32 for ITA2 codes,
# 3 for the service signals (α idle, β idle, RQ repeat-request)
_WEIGHT4 = [w for w in range(128) if bin(w).count("1") == 4]
CCIR476 = {i: _WEIGHT4[i] for i in range(32)}
ALPHA, BETA, RQ = _WEIGHT4[32], _WEIGHT4[33], _WEIGHT4[34]

CODE_TO_ITA2 = {v: k for k, v in CCIR476.items()}

LTRS = 0x1F
FIGS = 0x1B


def weight(code: int) -> int:
    return bin(code & 0x7F).count("1")


def encode_fec(text: str) -> list[int]:
    """Encode text as a SITOR-B codeword stream (DX/RX interleaved) —
    used by tests and for loopback validation."""
    ita2 = []
    figures = False
    for ch in text.upper():
        if ch in ITA2_LETTERS:
            code = ITA2_LETTERS.index(ch)
            if figures:
                ita2.append(LTRS)
                figures = False
        elif ch in ITA2_FIGURES:
            code = ITA2_FIGURES.index(ch)
            if not figures:
                ita2.append(FIGS)
                figures = True
        else:
            continue
        ita2.append(code)
    words = [CCIR476[c] for c in ita2]
    # FEC interleave: DX stream with each char repeated 5 positions later
    out = []
    stream = words + [CCIR476[LTRS]] * 5
    for i, w in enumerate(stream):
        out.append(w)                      # DX
        rx = stream[i - 5] if i >= 5 else CCIR476[LTRS]
        out.append(rx)                     # RX (5 chars earlier)
    return out


class SitorBDecoder:
    """Feed bits (LSB first per codeword); emits ITA2 text."""

    def __init__(self, on_text=None):
        self.on_text = on_text
        self._bits: list[int] = []
        self._synced = False
        self._words: list[int] = []
        self._dx_backlog: dict[int, int] = {}
        self._index = 0
        self.figures = False
        self._out: list[str] = []

    def feed_bits(self, bits: np.ndarray) -> str:
        out = []
        for b in bits:
            self._bits.append(int(b))
            if not self._synced:
                # lock only on TWO consecutive valid codewords at the same
                # 7-bit spacing — a lone window validating by chance in
                # idle/noise would freeze a wrong boundary permanently
                if len(self._bits) >= 14:
                    w1 = self._pack(self._bits[-14:-7])
                    w2 = self._pack(self._bits[-7:])
                    if (weight(w1) == 4 and w1 in CODE_TO_ITA2
                            and weight(w2) == 4 and w2 in CODE_TO_ITA2):
                        self._synced = True
                        self._bits = []
                        out.append(self._accept(w1))
                        out.append(self._accept(w2))
                continue
            if len(self._bits) == 7:
                word = self._pack(self._bits)
                self._bits = []
                out.append(self._accept(word))
        text = "".join(out)
        if text and self.on_text:
            self.on_text(text)
        return text

    @staticmethod
    def _pack(bits) -> int:
        word = 0
        for i, b in enumerate(bits):
            word |= (b & 1) << i
        return word

    def _accept(self, word: int) -> str:
        """DX/RX selection: position parity alternates DX (even) / RX (odd);
        prefer a valid DX, fall back to the RX copy 5 chars later."""
        idx = self._index
        self._index += 1
        if idx % 2 == 0:           # DX slot
            self._dx_backlog[idx // 2] = word
            return ""
        char_pos = idx // 2 - 5    # RX carries the char from 5 earlier
        dx = self._dx_backlog.pop(char_pos, None)
        chosen = None
        if dx is not None and weight(dx) == 4 and dx in CODE_TO_ITA2:
            chosen = dx
        elif weight(word) == 4 and word in CODE_TO_ITA2:
            chosen = word
        if chosen is None:
            return "_"  # uncorrectable
        return self._emit(CODE_TO_ITA2[chosen])

    def _emit(self, code: int) -> str:
        if code == LTRS:
            self.figures = False
            return ""
        if code == FIGS:
            self.figures = True
            return ""
        table = ITA2_FIGURES if self.figures else ITA2_LETTERS
        ch = table[code & 0x1F]
        return ch if ch >= " " or ch in "\r\n" else ""


class NavtexDecoder:
    """NAVTEX framing on top of SITOR-B: ZCZC B1B2B3B4 … NNNN messages."""

    def __init__(self, on_message=None):
        self.sitor = SitorBDecoder(self._on_text)
        self.on_message = on_message
        self._buf = ""
        self._in_message = False
        self._header = None

    def feed_bits(self, bits):
        return self.sitor.feed_bits(bits)

    def _on_text(self, text: str):
        self._buf += text
        while True:
            if not self._in_message:
                idx = self._buf.find("ZCZC")
                if idx < 0:
                    self._buf = self._buf[-8:]
                    return
                self._buf = self._buf[idx + 4:]
                self._in_message = True
            end = self._buf.find("NNNN")
            if end < 0:
                return
            body = self._buf[:end]
            self._buf = self._buf[end + 4:]
            self._in_message = False
            header = body[:5].strip()
            message = {
                "mode": "NAVTEX",
                "header": header,
                "message": body[5:].strip(),
            }
            if len(header) >= 4:
                message["station"] = header[0]
                message["type"] = header[1]
                message["number"] = header[2:4]
            if self.on_message:
                self.on_message(message)
