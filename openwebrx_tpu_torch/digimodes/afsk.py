"""AFSK demodulation + HDLC deframing — native packet-radio decode.

Replaces the external ``direwolf`` dependency for receive (reference
``csdr/chain/digimodes.py:15`` PacketDemodulator pipes FM audio into
direwolf and reads KISS; ``owrx/aprs/direwolf.py:150``).  Here the NFM
audio that the TPU chain already produced is demodulated on host with
vectorized dual-tone correlators (the per-block math is a handful of
FFT-sized convolutions at 12 kHz — control-plane cheap, exactly like the
reference's subprocess decoders), then HDLC-deframed into AX.25 frames
for the existing APRS stack (``openwebrx_tpu/aprs``).

The same correlator core also decodes EAS/SAME (520.83 Bd AFSK, byte
framed, no HDLC) — see :class:`SameDecoder`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "DualToneCorrelator", "BitSync", "HdlcDeframer", "Afsk1200Demodulator",
    "SameDecoder", "afsk_modulate", "hdlc_frame", "crc16_x25",
]


# ----------------------------------------------------------------- CRC

def _crc16_x25_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
        table[byte] = crc
    return table


_CRC_TABLE = _crc16_x25_table()


def crc16_x25(data: bytes) -> int:
    """CRC-16/X.25 (reflected 0x1021, init/xorout 0xFFFF) — the AX.25 FCS."""
    crc = 0xFFFF
    for b in data:
        crc = (crc >> 8) ^ int(_CRC_TABLE[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFF


# ------------------------------------------------------- tone correlator

class DualToneCorrelator:
    """Streaming non-coherent mark/space discriminator.

    For each input sample the windowed complex correlation against the
    mark and space tones is computed (window = one bit period); the
    output is sign(|mark|² − |space|²) soft values, one per sample, with
    phase and window state carried across blocks so frames may span any
    block boundary.
    """

    def __init__(self, rate: float, baud: float, mark: float, space: float):
        self.rate = float(rate)
        self.window = max(2, int(round(rate / baud)))
        self.freqs = (float(mark), float(space))
        # oscillator phasors advance by exp(-2πj f/fs) per sample; the
        # running phase is carried as a unit phasor per tone
        self._phase = np.ones(2, dtype=np.complex128)
        self._step = np.exp(-2j * np.pi * np.asarray(self.freqs) / self.rate)
        self._tail = np.zeros(self.window - 1, dtype=np.float64)

    def process(self, samples: np.ndarray) -> np.ndarray:
        """float samples → one soft discriminator value per new sample."""
        samples = np.asarray(samples, dtype=np.float64)
        x = np.concatenate([self._tail, samples])
        n = np.arange(x.shape[0])
        powers = np.empty((2, samples.shape[0]))
        for i in range(2):
            osc = self._phase[i] * self._step[i] ** n
            z = x * osc
            c = np.cumsum(z)
            # windowed[j] = sum(z[j : j+window]) for each new sample j
            windowed = c[self.window - 1:].copy()
            windowed[1:] -= c[: samples.shape[0] - 1]
            powers[i] = np.abs(windowed) ** 2
        advance = samples.shape[0]
        self._phase *= self._step ** advance
        self._phase /= np.abs(self._phase)
        self._tail = x[-(self.window - 1):] if self.window > 1 else x[:0]
        return powers[0] - powers[1]


class BitSync:
    """DPLL bit-timing recovery over a hard-decision sample stream.

    The phase accumulator advances ``baud/rate`` per sample and emits a
    bit on wrap; each input transition nudges the phase toward mid-bit
    (gain 0.25), the classic early/late discipline the reference gets
    from ``pycsdr.modules.TimingRecovery``.
    """

    def __init__(self, rate: float, baud: float, gain: float = 0.25):
        self.incr = float(baud) / float(rate)
        self.gain = gain
        self.phase = 0.0
        self.last = 1

    def process(self, hard: np.ndarray) -> list[int]:
        bits: list[int] = []
        phase, last = self.phase, self.last
        incr, gain = self.incr, self.gain
        for s in hard:
            if s != last:
                phase += (0.5 - phase) * gain
                last = s
            phase += incr
            if phase >= 1.0:
                phase -= 1.0
                bits.append(int(s))
        self.phase, self.last = phase, last
        return bits


# ------------------------------------------------------------ HDLC

class HdlcDeframer:
    """NRZI decode + bit destuffing + flag framing + FCS check."""

    FLAG = 0x7E

    def __init__(self, min_len: int = 17, max_len: int = 400):
        self.min_len = min_len          # AX.25: 14 addr + ctrl + pid + FCS
        self.max_len = max_len
        self._last_nrzi = 1
        self._shift = 0                 # last 8 raw (stuffed) bits
        self._ones = 0
        self._bits: list[int] = []
        self._in_frame = False

    def feed(self, nrzi_bits) -> list[bytes]:
        frames: list[bytes] = []
        for raw in nrzi_bits:
            bit = 1 if raw == self._last_nrzi else 0     # NRZI: change = 0
            self._last_nrzi = raw
            self._shift = ((self._shift << 1) | bit) & 0xFF
            if self._shift == self.FLAG:
                frame = self._finish()
                if frame is not None:
                    frames.append(frame)
                continue
            if not self._in_frame:
                continue
            if bit:
                self._ones += 1
                if self._ones >= 7:     # seven ones: abort (a flag would
                    self._abort()       # have matched the shift register)
                    continue
                self._bits.append(1)
            else:
                if self._ones == 5:
                    self._ones = 0
                    continue            # stuffed zero — drop
                self._ones = 0
                self._bits.append(0)
            if len(self._bits) > self.max_len * 8:
                self._abort()
        return frames

    def _abort(self):
        self._bits = []
        self._in_frame = False

    def _finish(self) -> bytes | None:
        bits, self._bits = self._bits, []
        self._ones = 0
        self._in_frame = True
        # the closing flag's leading bits are part of the shift register;
        # the frame proper excludes the 7 bits consumed by the flag
        if len(bits) < 7:
            return None
        bits = bits[:-7]
        if len(bits) % 8 or len(bits) < self.min_len * 8:
            return None
        arr = np.asarray(bits, dtype=np.uint8).reshape(-1, 8)
        data = bytes(np.packbits(arr, axis=1, bitorder="little").ravel())
        if crc16_x25(data[:-2]) != data[-2] | (data[-1] << 8):
            return None
        return data[:-2]


class Afsk1200Demodulator:
    """Bell-202 AFSK → AX.25 frames (1200 Bd, mark 1200 Hz, space 2200 Hz)."""

    def __init__(self, rate: int = 12000):
        self.correlator = DualToneCorrelator(rate, 1200, 1200, 2200)
        self.sync = BitSync(rate, 1200)
        self.hdlc = HdlcDeframer()

    def process(self, audio: np.ndarray) -> list[bytes]:
        """float/int16 audio block → zero or more FCS-valid AX.25 frames."""
        soft = self.correlator.process(np.asarray(audio, dtype=np.float64))
        hard = (soft > 0).astype(np.int8)
        return self.hdlc.feed(self.sync.process(hard))


# ------------------------------------------------------------- EAS/SAME

class SameDecoder:
    """NOAA/EAS SAME: 520.83 Bd AFSK (mark 2083.3 Hz, space 1562.5 Hz),
    bytes LSB-first with a 0xAB preamble, ASCII payload (``ZCZC-…``,
    ``NNNN``).  Emits multimon-style ``EAS: <text>`` lines for the
    existing :class:`openwebrx_tpu_torch.services.toolbox.EasParser`.
    """

    PREAMBLE = 0xAB

    def __init__(self, rate: int = 12000, on_line=None):
        baud = 520.0 + 5.0 / 6.0
        self.correlator = DualToneCorrelator(rate, baud, 2083.0 + 1.0 / 3.0,
                                             1562.5)
        self.sync = BitSync(rate, baud)
        self.on_line = on_line
        self._bits: list[int] = []
        self._aligned = False
        self._text: list[str] = []
        self._idle = 0

    def process(self, audio: np.ndarray) -> list[str]:
        soft = self.correlator.process(np.asarray(audio, dtype=np.float64))
        hard = (soft > 0).astype(np.int8)
        lines: list[str] = []
        for bit in self.sync.process(hard):
            self._bits.append(int(bit))
            if not self._aligned:
                if len(self._bits) >= 8:
                    word = sum(b << i for i, b in enumerate(self._bits[-8:]))
                    if word == self.PREAMBLE:
                        self._aligned = True
                        self._bits = []
                continue
            if len(self._bits) == 8:
                byte = sum(b << i for i, b in enumerate(self._bits))
                self._bits = []
                line = self._byte(byte)
                if line is not None:
                    lines.append(line)
        if self.on_line is not None:
            for line in lines:
                self.on_line(line)
        return lines

    def _byte(self, byte: int) -> str | None:
        if byte == self.PREAMBLE and not self._text:
            return None                 # still in preamble
        ch = chr(byte)
        if 32 <= byte < 127:
            self._text.append(ch)
            self._idle = 0
            return None
        # non-printable: message over
        return self._flush()

    def flush(self) -> str | None:
        return self._flush()

    def _flush(self) -> str | None:
        text = "".join(self._text).strip()
        self._text = []
        self._aligned = False
        if len(text) >= 4:
            return "EAS: " + text
        return None


# ------------------------------------------------- modulators (fixtures)

def afsk_modulate(bits, rate: float, baud: float, mark: float,
                  space: float, amplitude: float = 0.8) -> np.ndarray:
    """Continuous-phase AFSK modulator (test fixture / TX side)."""
    spb = rate / baud
    freqs = np.where(np.asarray(bits, dtype=bool), mark, space)
    edges = np.round(np.arange(len(freqs) + 1) * spb).astype(int)
    inst = np.repeat(freqs, np.diff(edges))
    phase = 2 * np.pi * np.cumsum(inst) / rate
    return (amplitude * np.sin(phase)).astype(np.float64)


def hdlc_frame(payload: bytes, flags: int = 8) -> list[int]:
    """payload → NRZI bit stream with FCS, stuffing and flanking flags."""
    fcs = crc16_x25(payload)
    data = payload + bytes([fcs & 0xFF, fcs >> 8])
    bits: list[int] = []
    flag = [0, 1, 1, 1, 1, 1, 1, 0]
    for _ in range(flags):
        bits.extend(flag)
    ones = 0
    for byte in data:
        for i in range(8):
            bit = (byte >> i) & 1
            bits.append(bit)
            ones = ones + 1 if bit else 0
            if ones == 5:
                bits.append(0)
                ones = 0
    for _ in range(flags):
        bits.extend(flag)
    # NRZI encode: 0 toggles, 1 holds
    out, level = [], 1
    for bit in bits:
        if bit == 0:
            level ^= 1
        out.append(level)
    return out
