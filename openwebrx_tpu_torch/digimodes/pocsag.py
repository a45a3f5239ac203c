"""Native POCSAG pager decoding (512/1200/2400 Bd).

Replaces the external ``multimon-ng -a POCSAGxxx`` dependency (reference
MultimonDemodulator, ``csdr/chain/toolbox.py:14-90``): the TPU chain's
NFM discriminator audio is bit-sliced on host, batch-synchronized on the
POCSAG frame sync codeword, BCH(31,21)-corrected (up to 2 bit errors per
codeword) and assembled into numeric/alpha messages.  Output lines use
the exact multimon-ng format so the existing
:class:`openwebrx_tpu_torch.services.toolbox.PageParser` consumes them
unchanged:

    POCSAG1200: Address: 1234567  Function: 3  Alpha:   message

Protocol: ITU-R M.584 — 32-bit codewords, sync 0x7CD215D8, idle
0x7A89C197, batches of 16 codewords = 8 address frames; address words
carry the 18 address MSBs (3 LSBs = frame index) + 2 function bits;
message words carry 20 payload bits (BCD numeric or 7-bit ASCII packed
LSB-first).
"""

from __future__ import annotations

import numpy as np

from openwebrx_tpu_torch.digimodes.afsk import BitSync

__all__ = ["PocsagDecoder", "PageDecoder", "bch_encode", "pocsag_modulate"]

SYNC = 0x7CD215D8
IDLE = 0x7A89C197
GENERATOR = 0x769            # x^10+x^9+x^8+x^6+x^5+x^3+1
NUMERIC_CHARSET = "0123456789*U -)("


def _bch_remainder(word31: int) -> int:
    """Remainder of the 31-bit codeword (parity bit stripped) mod g(x)."""
    rem = word31
    for shift in range(20, -1, -1):
        if rem & (1 << (shift + 10)):
            rem ^= GENERATOR << shift
    return rem & 0x3FF


def bch_encode(data21: int) -> int:
    """21 data bits → 32-bit codeword (BCH parity + even overall parity)."""
    word = data21 << 10
    word |= _bch_remainder(word)
    parity = bin(word).count("1") & 1
    return (word << 1) | parity


def _error_table() -> dict[int, int]:
    """syndrome → error mask over the 31 BCH-protected bits (≤2 errors)."""
    table: dict[int, int] = {}
    for i in range(31):
        e1 = 1 << i
        table[_bch_remainder(e1)] = e1
    for i in range(31):
        for j in range(i + 1, 31):
            e2 = (1 << i) | (1 << j)
            table.setdefault(_bch_remainder(e2), e2)
    return table


_ERRORS = _error_table()


def _correct(word32: int) -> int | None:
    """BCH-correct a received 32-bit codeword; None if uncorrectable."""
    word31 = word32 >> 1
    syndrome = _bch_remainder(word31)
    if syndrome:
        mask = _ERRORS.get(syndrome)
        if mask is None:
            return None
        word31 ^= mask
    corrected = word31 << 1 | (word32 & 1)
    if bin(word31).count("1") & 1 != (word32 & 1):
        # overall parity mismatch: flip the parity bit (it is the only
        # bit not covered by the BCH code)
        corrected ^= 1
    return corrected


class _Message:
    def __init__(self, address: int, function: int):
        self.address = address
        self.function = function
        self.payload_bits: list[int] = []

    def add_word(self, data20: int):
        for i in range(19, -1, -1):      # MSB of the codeword first
            self.payload_bits.append((data20 >> i) & 1)

    def render(self, protocol: str) -> str:
        base = (f"{protocol}: Address: {self.address:7d}  "
                f"Function: {self.function}")
        if not self.payload_bits:
            return base
        if self.function == 3:
            return base + "  Alpha:   " + self._alpha()
        return base + "  Numeric:  " + self._numeric()

    def _numeric(self) -> str:
        out = []
        bits = self.payload_bits
        for k in range(0, len(bits) - 3, 4):
            nibble = bits[k] | bits[k + 1] << 1 | bits[k + 2] << 2 \
                | bits[k + 3] << 3   # each BCD digit transmitted LSB-first
            out.append(NUMERIC_CHARSET[nibble])
        return "".join(out).rstrip(" ")

    def _alpha(self) -> str:
        out = []
        bits = self.payload_bits
        for k in range(0, len(bits) - 6, 7):
            code = 0
            for i in range(7):           # 7-bit ASCII, LSB first
                code |= bits[k + i] << i
            if code == 0x04:             # EOT pads the final word
                break
            if 32 <= code < 127 or code in (10, 13):
                out.append(chr(code))
        return "".join(out).rstrip()


class PocsagDecoder:
    """One baud rate: bit slicing + batch state machine → message lines."""

    def __init__(self, baud: int, rate: int = 12000, on_line=None):
        self.protocol = f"POCSAG{baud}"
        self.sync = BitSync(rate, baud)
        self.on_line = on_line
        self.rate = rate
        self._dc = 0.0
        self._shift = 0
        self._locked = False
        self._inverted = False
        self._bit_count = 0
        self._word_index = 0
        self._message: _Message | None = None
        self._lines: list[str] = []

    # -- sample path ----------------------------------------------------

    def process(self, audio: np.ndarray) -> list[str]:
        x = np.asarray(audio, dtype=np.float64)
        # slow DC tracker so the slicer survives discriminator offset
        alpha = min(1.0, len(x) / (0.5 * self.rate))
        dc = self._dc + (np.mean(x) - self._dc) * alpha if len(x) else self._dc
        self._dc = dc
        hard = (x > dc).astype(np.int8)
        for bit in self.sync.process(hard):
            self._bit(int(bit))
        lines, self._lines = self._lines, []
        if self.on_line is not None:
            for line in lines:
                self.on_line(line)
        return lines

    # -- bit path -------------------------------------------------------

    def _bit(self, bit: int):
        self._shift = ((self._shift << 1) | bit) & 0xFFFFFFFF
        if not self._locked:
            if self._shift == SYNC:
                self._lock(inverted=False)
            elif self._shift == SYNC ^ 0xFFFFFFFF:
                self._lock(inverted=True)
            return
        self._bit_count += 1
        if self._bit_count < 32:
            return
        self._bit_count = 0
        word = self._shift ^ (0xFFFFFFFF if self._inverted else 0)
        if self._word_index == 16:
            # batch boundary: expect another sync word
            if _hamming32(word, SYNC) <= 4:
                self._word_index = 0
            else:
                self._unlock()
            return
        frame = self._word_index // 2
        self._word_index += 1
        self._codeword(word, frame)

    def _lock(self, inverted: bool):
        self._locked = True
        self._inverted = inverted
        self._bit_count = 0
        self._word_index = 0

    def _unlock(self):
        self._flush()
        self._locked = False
        self._shift = 0

    def _codeword(self, word: int, frame: int):
        corrected = _correct(word)
        if corrected is None:
            self._flush()
            return
        if corrected == IDLE:
            self._flush()
            return
        if corrected & 0x80000000:       # message continuation word
            if self._message is not None:
                self._message.add_word((corrected >> 11) & 0xFFFFF)
            return
        # address word: emit any pending message, start the next
        self._flush()
        address = ((corrected >> 13) & 0x3FFFF) << 3 | frame
        function = (corrected >> 11) & 0x3
        self._message = _Message(address, function)

    def _flush(self):
        if self._message is not None:
            self._lines.append(self._message.render(self.protocol))
            self._message = None

    def close(self):
        self._flush()


class PageDecoder:
    """multimon-style multi-protocol pager frontend: POCSAG at all three
    bauds decoded concurrently from one audio feed."""

    def __init__(self, rate: int = 12000, on_line=None):
        self.decoders = [PocsagDecoder(baud, rate, on_line)
                         for baud in (512, 1200, 2400)]

    def process(self, audio) -> list[str]:
        lines: list[str] = []
        for dec in self.decoders:
            lines.extend(dec.process(audio))
        return lines

    def close(self):
        for dec in self.decoders:
            dec.close()


def _hamming32(a: int, b: int) -> int:
    return bin((a ^ b) & 0xFFFFFFFF).count("1")


# ------------------------------------------------- modulator (fixture)

def pocsag_modulate(messages, baud: int = 1200, rate: int = 12000,
                    amplitude: float = 0.8) -> np.ndarray:
    """[(address, function, text_or_None, kind)] → NRZ baseband samples.

    kind: 'alpha' | 'numeric' | None (tone-only page).  Builds preamble +
    batches exactly as a transmitter would; used by the tests and by the
    (niche) TX paths.
    """
    words: list[int] = []
    for address, function, text, kind in messages:
        frame = address & 0x7
        batch = [IDLE] * 16
        addr_data = ((address >> 3) & 0x3FFFF) << 2 | (function & 0x3)
        slot = frame * 2
        batch[slot] = bch_encode(addr_data)
        payload_words = _pack_payload(text, kind)
        pos = slot + 1
        for data20 in payload_words:
            if pos >= 16:
                words.extend([SYNC] + batch)
                batch = [IDLE] * 16
                pos = 0
            batch[pos] = bch_encode(1 << 20 | data20)
            pos += 1
        words.extend([SYNC] + batch)
    bits: list[int] = [1, 0] * 288                  # 576-bit preamble
    for word in words:
        bits.extend((word >> i) & 1 for i in range(31, -1, -1))
    spb = rate / baud
    edges = np.round(np.arange(len(bits) + 1) * spb).astype(int)
    levels = np.where(np.asarray(bits, dtype=bool), amplitude, -amplitude)
    return np.repeat(levels, np.diff(edges)).astype(np.float64)


def _pack_payload(text, kind) -> list[int]:
    if text is None:
        return []
    bits: list[int] = []
    if kind == "alpha":
        data = text + "\x04"
        for ch in data:
            code = ord(ch) & 0x7F
            bits.extend((code >> i) & 1 for i in range(7))
    else:
        padded = text + " " * (-len(text) % 5)       # pad to word boundary
        for ch in padded:
            nibble = NUMERIC_CHARSET.index(ch)
            bits.extend((nibble >> i) & 1 for i in range(4))
    words = []
    for k in range(0, len(bits), 20):
        chunk = bits[k: k + 20]
        chunk += [0] * (20 - len(chunk)) if kind != "alpha" else \
            ([1, 0, 1, 0] * 5)[: 20 - len(chunk)]
        data20 = 0
        for bit in chunk:
            data20 = (data20 << 1) | bit
        words.append(data20)
    return words
