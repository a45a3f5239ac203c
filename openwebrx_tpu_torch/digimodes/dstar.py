"""Native D-Star link layer: bit stream → header callsigns + slow data.

Host-side counterpart of models/digital_voice.py's GMSK symbol path for
Icom D-Star — the frame work the reference delegates to the external
digiham ``dstar_decoder`` binary (/root/reference/csdr/chain/digiham.py:
78-99): radio-header FEC (rate-1/2 K=3 convolutional + block interleave
+ LFSR scrambler + CRC), callsign field extraction (MY/UR/RPT1/RPT2),
and the slow-data channel riding the voice frames (20-character message
assembly) — so the MetaPanel shows the talker with no binary installed
(the AMBE vocoder stays external).

Built from the published JARL D-STAR specification.  As with the other
native DV layers, no off-air capture exists in this image: coding layers
are validated by encode→corrupt→decode round trips (tests/test_dstar.py).

Radio header (JARL spec §2):
  41 bytes = flags(3) + RPT2(8) + RPT1(8) + UR(8) + MY(8) + suffix(4)
  + CRC-16 (CCITT, bit-reversed I/O) = 328 bits + 2 flush
  → rate-1/2 K=3 convolutional (G 7,5) = 660 bits
  → block interleave (24 rows × 28 columns, written row-wise, read
    column-wise, the last 12 slots unused)
  → LFSR scrambler x⁷+x⁴+1 (all-ones init).
Frame sync (after the 101010… preamble): 0x55 0x2D 0x16.
Voice frames: 72 AMBE bits + 24 slow-data bits; every 21st frame the
slow-data field carries the sync pattern 0x55 0x2D 0x16; other frames'
3 bytes are XOR-scrambled with 0x70 0x4F 0x93.  Message blocks (type
0x40-0x43) carry 5 chars each → a 20-char free-text message.
"""

from __future__ import annotations

import numpy as np

from openwebrx_tpu_torch.digimodes import fec

HEADER_BITS = 660
SYNC = np.unpackbits(np.asarray([0x55, 0x2D, 0x16], np.uint8))  # 24 bits
_SLOW_XOR = np.asarray([0x70, 0x4F, 0x93], np.uint8)

# 24×28 block interleaver, last 12 slots unused (672 − 660)
_ROWS, _COLS = 24, 28


def _interleave_tables():
    # slot (r, c) is read at position c*ROWS + r; keep slots < 660
    flat = np.arange(_ROWS * _COLS).reshape(_ROWS, _COLS).T.reshape(-1)
    return np.asarray([s for s in flat if s < HEADER_BITS])


_READ = _interleave_tables()          # transmitted i carries matrix[READ[i]]


def interleave(bits660: np.ndarray) -> np.ndarray:
    return np.asarray(bits660, np.uint8)[_READ]


def deinterleave(bits660: np.ndarray) -> np.ndarray:
    out = np.empty(HEADER_BITS, np.uint8)
    out[_READ] = np.asarray(bits660, np.uint8)
    return out


def scramble(bits: np.ndarray) -> np.ndarray:
    """LFSR x⁷+x⁴+1, all-ones init (self-inverse XOR stream)."""
    reg = 0x7F
    out = np.empty(len(bits), np.uint8)
    b = np.asarray(bits, np.uint8)
    for i in range(len(b)):
        s = ((reg >> 6) ^ (reg >> 3)) & 1
        out[i] = b[i] ^ s
        reg = ((reg << 1) | s) & 0x7F
    return out


def crc16_dstar(data: bytes) -> int:
    """CCITT CRC with reflected bit order (the D-Star header checksum)."""
    crc = 0xFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
    return (~crc) & 0xFFFF


def _cs(text: str, n: int) -> bytes:
    return text.upper().ljust(n)[:n].encode("ascii", "replace")


def header_encode(my: str, suffix: str = "", ur: str = "CQCQCQ  ",
                  rpt1: str = "DIRECT  ", rpt2: str = "DIRECT  ",
                  flags: bytes = b"\x00\x00\x00") -> np.ndarray:
    """Header fields → 660 transmitted bits."""
    by = bytearray()
    by += flags[:3].ljust(3, b"\x00")
    by += _cs(rpt2, 8)
    by += _cs(rpt1, 8)
    by += _cs(ur, 8)
    by += _cs(my, 8)
    by += _cs(suffix, 4)
    crc = crc16_dstar(bytes(by))
    by += bytes([crc & 0xFF, (crc >> 8) & 0xFF])
    bits = np.unpackbits(np.frombuffer(bytes(by), np.uint8))   # 328
    enc = fec.conv_encode_k3(np.concatenate(
        [bits, np.zeros(2, np.uint8)])).reshape(-1)            # 660
    return scramble(interleave(enc))


def header_decode(bits660: np.ndarray) -> dict | None:
    """660 received bits → header dict (None on CRC failure)."""
    de = deinterleave(scramble(bits660))
    dec = fec.viterbi_decode_k3(de.reshape(-1, 2), 328)
    by = np.packbits(dec).tobytes()
    crc = int(by[39]) | (int(by[40]) << 8)
    if crc16_dstar(by[:39]) != crc:
        return None
    def f(a, b):
        return by[a:b].decode("ascii", "replace").rstrip()
    meta = {
        "protocol": "DSTAR",
        "flags": list(by[:3]),
        "destination_rptr": f(3, 11),
        "departure": f(11, 19),
        "target": f(19, 27),         # UR / yourcall
        "source": f(27, 35),         # MY / ourcall
        "ourcall": f(27, 35),
        "yourcall": f(19, 27),
    }
    sfx = f(35, 39)
    if sfx:
        meta["suffix"] = sfx
    return meta


# ------------------------------------------------------------ slow data ---
class SlowDataAssembler:
    """The 24-bit per-voice-frame data channel: descramble (XOR 0x70 0x4F
    0x93), collect 0x40-0x43 message blocks into the 20-char free text."""

    def __init__(self):
        self._chars = [" "] * 20
        self._got = set()

    def feed_pair(self, first3: np.ndarray, second3: np.ndarray):
        """A slow-data segment spans TWO voice frames (3+3 bytes): type +
        5 payload bytes."""
        a = np.packbits(np.asarray(first3, np.uint8))[:3] ^ _SLOW_XOR
        b = np.packbits(np.asarray(second3, np.uint8))[:3] ^ _SLOW_XOR
        t = int(a[0])
        if 0x40 <= t <= 0x43:
            payload = bytes(a[1:3]) + bytes(b[:3])
            idx = (t & 3) * 5
            for k, ch in enumerate(payload):
                if 32 <= ch < 127:
                    self._chars[idx + k] = chr(ch)
            self._got.add(t & 3)

    @property
    def message(self) -> str | None:
        if len(self._got) == 4:
            return "".join(self._chars).rstrip()
        return None


# --------------------------------------------------------------- decoder --
class DstarDecoder:
    """Streaming BIT consumer (from the GMSK discriminator: the 4FSK
    slicer's dibit>>1 gives the hard bit; both polarities are searched).
    meta_cb(dict) receives the decoded header and, when the slow-data
    message completes, a follow-up with ``message``."""

    SYNC_TOLERANCE = 2
    VOICE_FRAME_BITS = 96

    def __init__(self, meta_cb=None):
        self.meta_cb = meta_cb
        self._buf = np.zeros(0, np.uint8)
        self._inverted = False
        self._slow = SlowDataAssembler()
        self._pending_slow = None
        self._in_voice = False
        self._frame_no = 0
        self._last = None

    def feed_dibits(self, dibits: np.ndarray) -> list[dict]:
        return self.feed_bits((np.asarray(dibits, np.uint8) >> 1) & 1)

    # DigitalVoiceHandle feed surface (same as DmrDecoder/YsfDecoder)
    feed = feed_dibits

    def feed_bits(self, bits: np.ndarray) -> list[dict]:
        events: list[dict] = []

        def emit(m):
            events.append(m)
            if self.meta_cb:
                self.meta_cb(m)
        self._buf = np.concatenate([self._buf,
                                    np.asarray(bits, np.uint8) & 1])
        buf = self._buf
        pos = 0
        need = len(SYNC) + HEADER_BITS
        if self._in_voice:
            # an open transmission: keep walking voice frames (the slow
            # data channel) until the 21-frame sync cadence is lost
            pos = self._voice(buf, pos, emit)
            if self._in_voice:
                self._buf = buf[pos:]
                return events
        while len(buf) - pos >= need:
            hit = self._find_sync(buf, pos)
            if hit is None:
                pos = len(buf) - need + 1
                break
            at, inv = hit
            if at + need > len(buf):
                pos = at
                break
            hdr_bits = buf[at + len(SYNC):at + need]
            if inv:
                hdr_bits = hdr_bits ^ 1
            hdr = header_decode(hdr_bits)
            if hdr is not None:
                self._inverted = inv
                self._slow = SlowDataAssembler()
                self._in_voice = True
                self._frame_no = 0
                self._last = hdr
                emit(hdr)
                pos = at + need
                # voice frames follow; consume what's already buffered
                pos = self._voice(buf, pos, emit)
            else:
                pos = at + 1
        self._buf = buf[pos:]
        return events

    def _voice(self, buf: np.ndarray, pos: int, emit) -> int:
        """Walk voice frames (72 AMBE + 24 data bits) after a header,
        assembling slow data; drops out of voice mode when the 21-frame
        sync cadence is lost (end of transmission / signal lost)."""
        while len(buf) - pos >= self.VOICE_FRAME_BITS:
            frame = buf[pos:pos + self.VOICE_FRAME_BITS]
            if self._inverted:
                frame = frame ^ 1
            # a frame-sync pattern at the frame START means the previous
            # transmission was cut and a NEW one began here: leave voice
            # mode so the header search catches it (staying in cadence
            # would swallow the new call's header)
            head = buf[pos:pos + len(SYNC)]
            if self._frame_no % 21 != 0 and (
                    int((head ^ SYNC).sum()) <= self.SYNC_TOLERANCE or
                    int((head ^ SYNC ^ 1).sum()) <= self.SYNC_TOLERANCE):
                self._in_voice = False
                if self._last is not None:
                    emit(dict(self._last, end=True))
                    self._last = None
                return pos
            data = frame[72:]
            if self._frame_no % 21 == 0:
                if self._frame_no > 0 and int((data ^ SYNC).sum()) > 6:
                    # cadence lost: end of transmission
                    self._in_voice = False
                    if self._last is not None:
                        emit(dict(self._last, end=True))
                        self._last = None
                    return pos
                self._pending_slow = None      # sync frame, resets pairing
            elif self._pending_slow is None:
                self._pending_slow = data
            else:
                self._slow.feed_pair(self._pending_slow, data)
                self._pending_slow = None
                msg = self._slow.message
                if msg and self._last is not None and \
                        self._last.get("message") != msg:
                    self._last = dict(self._last, message=msg)
                    emit(self._last)
            self._frame_no += 1
            pos += self.VOICE_FRAME_BITS
        return pos

    def _find_sync(self, buf: np.ndarray, pos: int):
        hi = len(buf) - len(SYNC)
        if hi <= pos:
            return None
        windows = np.lib.stride_tricks.sliding_window_view(
            buf[pos:], len(SYNC))
        best = None
        for inv in (False, True):
            pat = SYNC ^ 1 if inv else SYNC
            dist = (windows ^ pat).sum(axis=1)
            ok = np.flatnonzero(dist <= self.SYNC_TOLERANCE)
            if len(ok) and (best is None or int(ok[0]) < best[0]):
                best = (int(ok[0]), inv)
        if best is None:
            return None
        return pos + best[0], best[1]
