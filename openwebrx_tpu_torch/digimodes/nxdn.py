"""Native NXDN link layer: dibit stream → LICH + SACCH call metadata.

Host-side counterpart of models/digital_voice.py's 4FSK symbol path for
NXDN — the frame work the reference delegates to the external digiham
``nxdn_decoder`` binary (/root/reference/csdr/chain/digiham.py:101-120):
frame sync, LICH decode, SACCH FEC (K=5 convolutional, punctured, with
CRC-6), and VCALL source/destination unit-ID extraction across the
4-segment SACCH superframe — so the MetaPanel shows the talker with no
binary installed (the AMBE vocoder stays external).

Structured after the public NXDN TS 1-A common air interface.  Interop
caveat (same as the YSF layer): the puncture/interleave tables are
reproduced from the spec's STRUCTURE and validated by
encode→corrupt→decode round trips only — no off-air NXDN capture exists
in this image (tests/test_nxdn.py).

Frame (4800 bits/s, 2400 sym/s): FSW (20 bits = 10 dibits, 0xCDF59) +
LICH (16 bits: 8 info bits, each sent as the pair (b, ¬b)) + 2×SACCH
... here the 60-bit SACCH field per frame: 26 info + CRC-6 + 4 tail
→ rate-1/2 K=5 convolutional (G 0x19/0x17) = 72 bits → punctured to 60
(drop every 6th bit).  A VCALL's source/destination unit IDs span the
4-part SACCH superframe (structure field counts 3…0).
"""

from __future__ import annotations

import numpy as np

from openwebrx_tpu_torch.digimodes import fec

FSW = 0xCDF59                 # 20-bit frame sync word
FSW_DIBITS = 10
LICH_DIBITS = 8               # 16 bits
SACCH_DIBITS = 30             # 60 bits
FRAME_DIBITS = 192            # 384 bits / 80 ms at 2400 sym/s

MSG_VCALL = 0x01
MSG_TX_REL = 0x08


def _word_dibits(word: int, nbits: int) -> np.ndarray:
    bits = [(word >> (nbits - 1 - i)) & 1 for i in range(nbits)]
    return np.asarray([(bits[2 * i] << 1) | bits[2 * i + 1]
                       for i in range(nbits // 2)], np.uint8)


_FSW = _word_dibits(FSW, 20)

# puncture: drop every 6th encoded bit (72 → 60)
_KEEP = np.asarray([i % 6 != 5 for i in range(72)], bool)


def crc6(bits: np.ndarray) -> int:
    """CRC-6 (poly x⁶+x+1 = 0x43, init all-ones) over a bit array."""
    crc = 0x3F
    for b in np.asarray(bits, np.uint8):
        top = (crc >> 5) & 1
        crc = ((crc << 1) & 0x3F) | int(b)
        if top:
            crc ^= 0x03
    return crc & 0x3F


# ---------------------------------------------------------------- LICH ----
def lich_encode(lich8: int) -> np.ndarray:
    """8 LICH bits → 16 transmitted bits: each bit as the pair (b, ¬b)."""
    out = np.empty(16, np.uint8)
    for i in range(8):
        b = (lich8 >> (7 - i)) & 1
        out[2 * i] = b
        out[2 * i + 1] = b ^ 1
    return out


def lich_decode(bits16: np.ndarray) -> int | None:
    """Tolerates up to 2 violated pairs (channel errors): the first bit
    of a violated pair is still the best estimate."""
    b = np.asarray(bits16, np.uint8)
    val = 0
    violations = 0
    for i in range(8):
        pair = (int(b[2 * i]), int(b[2 * i + 1]))
        if pair[0] == pair[1]:
            violations += 1
        val = (val << 1) | pair[0]
    return val if violations <= 2 else None


# --------------------------------------------------------------- SACCH ----
def sacch_encode(structure: int, payload18: int) -> np.ndarray:
    """SACCH segment → 60 transmitted bits.  Info = structure(2) +
    ran(6)=0 + payload(18) = 26 bits + CRC-6."""
    info = np.zeros(26, np.uint8)
    info[0] = (structure >> 1) & 1
    info[1] = structure & 1
    for i in range(18):
        info[8 + i] = (payload18 >> (17 - i)) & 1
    c = crc6(info)
    full = np.concatenate([info,
                           np.asarray([(c >> (5 - i)) & 1
                                       for i in range(6)], np.uint8),
                           np.zeros(4, np.uint8)])        # 36 incl. tail
    enc = fec.conv_encode(full).reshape(-1)               # 72
    return enc[_KEEP]


def sacch_decode(bits60: np.ndarray):
    """60 bits → (structure, payload18) or None on CRC failure."""
    full = np.zeros(72, np.uint8)
    full[_KEEP] = np.asarray(bits60, np.uint8)
    erased = ~_KEEP
    dec = fec.viterbi_decode(full.reshape(-1, 2), 32,
                             erasures=erased.reshape(-1, 2))
    info, crc_bits = dec[:26], dec[26:32]
    got = 0
    for b in crc_bits:
        got = (got << 1) | int(b)
    if crc6(info) != got:
        return None
    structure = (int(info[0]) << 1) | int(info[1])
    payload = 0
    for i in range(18):
        payload = (payload << 1) | int(info[8 + i])
    return structure, payload


# ------------------------------------------------------------ superframe --
def vcall_segments(src: int, dst: int) -> list[tuple[int, int]]:
    """A VCALL spread over the 4-part SACCH superframe: 72 payload bits =
    msg type(8) + src(16) + dst(16) + options — packed here as
    segment0: type(8)+src_hi(10); 1: src_lo(6)+dst(12 hi);
    2: dst_lo(4)+zero; 3: zero (18 bits each, structure counts 3→0)."""
    blob = (MSG_VCALL << 64) | ((src & 0xFFFF) << 48) | \
        ((dst & 0xFFFF) << 32)
    segs = []
    for i in range(4):
        part = (blob >> (72 - 18 * (i + 1))) & 0x3FFFF
        segs.append((3 - i, part))
    return segs


class SuperframeAssembler:
    def __init__(self):
        self._parts: dict[int, int] = {}

    def feed(self, structure: int, payload18: int):
        """structure 3..0 indexes the remaining segments.  structure==3
        STARTS a superframe: stale fragments of a previous (partially
        lost) call are dropped, or segments of different calls would
        merge into chimeric unit IDs."""
        if structure == 3:
            self._parts = {}
        self._parts[3 - structure] = payload18
        if len(self._parts) == 4 and set(self._parts) == {0, 1, 2, 3}:
            blob = 0
            for i in range(4):
                blob = (blob << 18) | self._parts[i]
            self._parts = {}
            msg = (blob >> 64) & 0xFF
            if msg == MSG_VCALL:
                return {"protocol": "NXDN", "type": "vcall",
                        "source": (blob >> 48) & 0xFFFF,
                        "target": (blob >> 32) & 0xFFFF}
            if msg == MSG_TX_REL:
                return {"protocol": "NXDN", "end": True}
        return None


def build_frame(lich8: int, structure: int, payload18: int) -> np.ndarray:
    """One NXDN frame's dibits (voice payload zeroed — vocoder external)."""
    bits = np.concatenate([
        lich_encode(lich8),
        sacch_encode(structure, payload18),
        np.zeros(2 * (FRAME_DIBITS - FSW_DIBITS - LICH_DIBITS
                      - SACCH_DIBITS), np.uint8)])
    dib = (bits[0::2] << 1) | bits[1::2]
    return np.concatenate([_FSW, dib])


class NxdnDecoder:
    """Streaming dibit consumer.  meta_cb(dict) receives VCALL
    source/target unit IDs and end-of-call events — what the reference's
    MetaParser/NxdnEnricher consume (owrx/meta.py:209)."""

    SYNC_TOLERANCE = 2

    def __init__(self, meta_cb=None):
        self.meta_cb = meta_cb
        self._buf = np.zeros(0, np.uint8)
        self._sf = SuperframeAssembler()

    def feed(self, dibits: np.ndarray) -> list[dict]:
        events: list[dict] = []

        def emit(m):
            events.append(m)
            if self.meta_cb:
                self.meta_cb(m)
        self._buf = np.concatenate([self._buf,
                                    np.asarray(dibits, np.uint8)])
        buf = self._buf
        pos = 0
        while len(buf) - pos >= FRAME_DIBITS:
            hit = self._find_sync(buf, pos)
            if hit is None:
                pos = len(buf) - FRAME_DIBITS + 1
                break
            if hit + FRAME_DIBITS > len(buf):
                pos = hit
                break
            if self._frame(buf[hit:hit + FRAME_DIBITS], emit):
                pos = hit + FRAME_DIBITS
            else:
                # false FSW match (20 bits, tolerance 2): advancing a
                # whole frame would swallow a REAL frame starting inside
                # this span — step one dibit instead
                pos = hit + 1
        self._buf = buf[pos:]
        return events

    def _find_sync(self, buf: np.ndarray, pos: int):
        hi = len(buf) - FSW_DIBITS
        if hi <= pos:
            return None
        windows = np.lib.stride_tricks.sliding_window_view(
            buf[pos:], FSW_DIBITS)
        x = windows ^ _FSW
        dist = ((x & 1) + (x >> 1)).sum(axis=1)
        ok = np.flatnonzero(dist <= self.SYNC_TOLERANCE)
        return pos + int(ok[0]) if len(ok) else None

    def _frame(self, frame: np.ndarray, emit) -> bool:
        """Returns True when the frame decoded (LICH + SACCH valid)."""
        payload = frame[FSW_DIBITS:]
        bits = np.empty(2 * len(payload), np.uint8)
        bits[0::2] = payload >> 1
        bits[1::2] = payload & 1
        lich = lich_decode(bits[:16])
        if lich is None:
            return False
        sacch = sacch_decode(bits[16:16 + 60])
        if sacch is None:
            return False
        structure, payload18 = sacch
        meta = self._sf.feed(structure, payload18)
        if meta is not None:
            meta["lich"] = lich
            emit(meta)
        return True
