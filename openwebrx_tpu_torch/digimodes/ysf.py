"""Native System Fusion (YSF) frame layer: dibit stream → FICH + callsigns.

Host-side counterpart of models/digital_voice.py's C4FM symbol path for
Yaesu System Fusion — the frame/FEC work the reference delegates to the
external digiham ``ysf_decoder`` binary
(/root/reference/csdr/chain/digiham.py:58-76).

Frame (100 ms, 4800 symbols/s → 480 dibits = 960 bits):
  40-bit frame sync (0xD471C9634D) | FICH (200 bits) | 5 × 144-bit
  V/D blocks (40 bits DCH + 104 bits VCH each).

FICH coding: 32 FICH bits + CRC-16 → 4 × Golay(24,12) blocks (96 bits)
+ 4 flush bits → rate-1/2 K=5 convolutional → 200 bits → block
interleave → 100 dibits.  The per-frame data channel (DCH, 5×40 bits)
carries 10 bytes (80 bits + CRC-16 + 4 flush → conv → 200 bits →
interleave): the CSD source/destination callsigns in the early frame
numbers.

Interop caveat (honest): the Yaesu interleave tables and CSD schedule
are reproduced here from the public spec's STRUCTURE; with no off-air
capture available in this image, byte-exact wire interop is untested —
all coding layers are validated by encode→corrupt→decode round trips
(tests/test_dmr_ysf.py), same as the DMR side.
"""

from __future__ import annotations

import numpy as np

from openwebrx_tpu_torch.digimodes import fec

FRAME_SYNC = 0xD471C9634D           # 40 bits
SYNC_DIBITS = 20
FICH_DIBITS = 100
FRAME_DIBITS = 480

FI_NAMES = {0: "header", 1: "communication", 2: "terminator", 3: "test"}
DT_NAMES = {0: "vd_mode1", 1: "data_fr", 2: "vd_mode2", 3: "voice_fr"}

_SYNC = np.asarray(
    [((FRAME_SYNC >> (39 - 2 * i - 1)) & 1) | (((FRAME_SYNC >> (39 - 2 * i)) & 1) << 1)
     for i in range(20)], np.uint8)

# (20, 5) block interleaver over 100 dibits
_ILV = np.asarray([(i % 20) * 5 + i // 20 for i in range(100)])
_DILV = np.argsort(_ILV)


def _conv_block_encode(bits96: np.ndarray) -> np.ndarray:
    """96 payload bits (+4 flush) → 100 interleaved dibits."""
    bits = np.concatenate([np.asarray(bits96, np.uint8),
                           np.zeros(4, np.uint8)])
    sym = fec.conv_encode(bits)                 # (100, 2)
    dib = (sym[:, 0] << 1) | sym[:, 1]
    return dib[_ILV]


def _conv_block_decode(dibits100: np.ndarray) -> np.ndarray:
    """100 interleaved dibits → 96 decoded bits."""
    d = np.asarray(dibits100, np.uint8)[_DILV]
    sym = np.stack([d >> 1, d & 1], axis=1)
    return fec.viterbi_decode(sym, 96)


# ---------------------------------------------------------------- FICH ----
def fich_encode(fi: int, cs: int, cm: int, bn: int, bt: int, fn: int,
                ft: int, dt: int, sql: int = 0, sq: int = 0) -> np.ndarray:
    """FICH fields → 100 transmitted dibits."""
    b = np.zeros(4, np.uint8)
    b[0] = ((fi & 3) << 6) | ((cs & 3) << 4) | ((cm & 3) << 2) | (bn & 3)
    b[1] = ((bt & 3) << 6) | ((fn & 7) << 3) | (ft & 7)
    b[2] = ((dt & 3))                       # (reserved/dev/mr bits zero)
    b[3] = ((sql & 1) << 7) | (sq & 0x7F)
    bits32 = np.unpackbits(b)
    crc = fec.crc16_ccitt(bits32)
    bits48 = np.concatenate([bits32, np.unpackbits(
        np.asarray([crc >> 8, crc & 0xFF], np.uint8))])
    golay = np.concatenate([
        fec.golay_24_12_encode(int(
            np.packbits(bits48[i * 12:(i + 1) * 12].tolist() + [0] * 4)
            .view(np.uint16).byteswap()[0]) >> 4)
        for i in range(4)])
    return _conv_block_encode(golay)


def fich_decode(dibits100: np.ndarray) -> dict | None:
    """100 dibits → FICH fields (None on CRC failure)."""
    bits96 = _conv_block_decode(dibits100)
    out = np.zeros(48, np.uint8)
    ok = True
    for i in range(4):
        word = bits96[i * 24:(i + 1) * 24]
        data12, dist = fec.golay_24_12_decode(word)
        ok &= dist <= 3
        out[i * 12:(i + 1) * 12] = [(data12 >> (11 - j)) & 1
                                    for j in range(12)]
    if not ok:
        return None
    bits32, crc_bits = out[:32], out[32:]
    crc = (int(np.packbits(crc_bits[:8])[0]) << 8) | \
        int(np.packbits(crc_bits[8:])[0])
    if fec.crc16_ccitt(bits32) != crc:
        return None
    b = np.packbits(bits32)
    return {
        "fi": (int(b[0]) >> 6) & 3, "cs": (int(b[0]) >> 4) & 3,
        "cm": (int(b[0]) >> 2) & 3, "bn": int(b[0]) & 3,
        "bt": (int(b[1]) >> 6) & 3, "fn": (int(b[1]) >> 3) & 7,
        "ft": int(b[1]) & 7, "dt": int(b[2]) & 3,
        "sql": (int(b[3]) >> 7) & 1, "sq": int(b[3]) & 0x7F,
    }


# ----------------------------------------------------------------- DCH ----
def dch_encode(payload10: bytes) -> np.ndarray:
    """10 payload bytes → the frame's 5×20-dibit DCH fields (100 dibits)."""
    data = np.frombuffer(payload10.ljust(10)[:10].encode()
                         if isinstance(payload10, str) else
                         bytes(payload10).ljust(10)[:10], np.uint8)
    bits80 = np.unpackbits(data)
    crc = fec.crc16_ccitt(bits80)
    bits96 = np.concatenate([bits80, np.unpackbits(
        np.asarray([crc >> 8, crc & 0xFF], np.uint8))])
    return _conv_block_encode(bits96)


def dch_decode(dibits100: np.ndarray) -> bytes | None:
    bits96 = _conv_block_decode(dibits100)
    crc = (int(np.packbits(bits96[80:88])[0]) << 8) | \
        int(np.packbits(bits96[88:96])[0])
    if fec.crc16_ccitt(bits96[:80]) != crc:
        return None
    return np.packbits(bits96[:80]).tobytes()


# --------------------------------------------------------------- frames ---
def build_frame(fich: dict, dch_payload: bytes | None) -> np.ndarray:
    """Assemble one YSF frame's dibits (tests/fixtures).  The 5 VCH
    sections are zero-filled (vocoder payload is out of scope)."""
    frame = np.zeros(FRAME_DIBITS, np.uint8)
    frame[:SYNC_DIBITS] = _SYNC
    frame[SYNC_DIBITS:SYNC_DIBITS + FICH_DIBITS] = fich_encode(**fich)
    if dch_payload is not None:
        dch = dch_encode(dch_payload)
        base = SYNC_DIBITS + FICH_DIBITS
        for s in range(5):
            # per section: 20 dibits DCH then 52 dibits VCH (40+104 bits)
            frame[base + s * 72: base + s * 72 + 20] = dch[s * 20:(s + 1) * 20]
    return frame


class YsfDecoder:
    """Streaming dibit consumer: frame sync → FICH → CSD callsigns.

    meta_cb(dict) receives {"protocol": "YSF", "mode", "source"/"target"
    (callsigns, from the CSD in frame numbers 1/2), "fi", ...} — the
    events the reference's MetaParser forwards to the MetaPanel
    (owrx/meta.py:154-175)."""

    SYNC_TOLERANCE = 3

    def __init__(self, meta_cb=None):
        self.meta_cb = meta_cb
        self._buf = np.zeros(0, np.uint8)
        self.in_sync = False
        self._source = None
        self._target = None

    def feed(self, dibits: np.ndarray) -> list[dict]:
        events: list[dict] = []
        cb = self.meta_cb

        def emit(m):
            events.append(m)
            if cb:
                cb(m)
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
            self._frame(buf[hit:hit + FRAME_DIBITS], emit)
            pos = hit + FRAME_DIBITS
        self._buf = buf[pos:]
        return events

    def _find_sync(self, buf: np.ndarray, pos: int):
        hi = len(buf) - SYNC_DIBITS
        if hi <= pos:
            return None
        windows = np.lib.stride_tricks.sliding_window_view(
            buf[pos:], SYNC_DIBITS)
        x = windows ^ _SYNC
        dist = ((x & 1) + (x >> 1)).sum(axis=1)
        ok = np.flatnonzero(dist <= self.SYNC_TOLERANCE)
        return pos + int(ok[0]) if len(ok) else None

    def _frame(self, frame: np.ndarray, emit):
        fich = fich_decode(frame[SYNC_DIBITS:SYNC_DIBITS + FICH_DIBITS])
        if fich is None:
            return
        if not self.in_sync:
            self.in_sync = True
            emit({"protocol": "YSF", "sync": True})
        meta = {"protocol": "YSF",
                "mode": DT_NAMES.get(fich["dt"], "?"),
                "fi": FI_NAMES.get(fich["fi"], "?"),
                "fn": fich["fn"]}
        # CSD: source callsign rides FN=1, destination FN=2
        dch = np.concatenate([
            frame[SYNC_DIBITS + FICH_DIBITS + s * 72:
                  SYNC_DIBITS + FICH_DIBITS + s * 72 + 20]
            for s in range(5)])
        payload = dch_decode(dch)
        if payload is not None:
            text = payload.decode("ascii", "replace").strip()
            if fich["fn"] == 1 and text:
                self._source = text
            elif fich["fn"] == 2 and text:
                self._target = text
        if self._source:
            meta["source"] = self._source
        if self._target:
            meta["target"] = self._target
        if fich["fi"] == 2:
            meta["end"] = True
            self._source = self._target = None
        emit(meta)
