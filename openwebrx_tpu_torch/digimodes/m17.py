"""Native M17 frame layer: dibit stream → link setup metadata.

The reference decodes M17 only through the external ``m17-demod`` binary
(/root/reference/csdr/chain/m17.py); here the link-layer control plane is
native: frame sync, P1 depuncture + K=5 Viterbi, the QPP interleaver and
decorrelator, LSF CRC, base-40 callsign codec, and LICH chunk reassembly
from stream frames (Golay(24,12)) — so the MetaPanel shows src/dest
callsigns and the channel access number with no binary installed (the
Codec 2 voice payload stays external).

Built from the public M17 specification (spec.m17project.org).  As with
the DMR/YSF layers, no off-air capture exists in this image: every coding
layer is validated by encode→corrupt→decode round trips
(tests/test_m17.py); the decorrelator byte sequence is reproduced from
the spec and exercised only against this module's own encoder.

Frame structure (4800 sym/s, 40 ms frames = 192 symbols = 384 bits):
  16-bit sync word + 368 payload bits.
  LSF: DST(48) SRC(48) TYPE(16) META(112) CRC(16) = 240 bits + 4 flush
       → rate-1/2 K=5 convolutional (G1=0x19, G2=0x17) = 488 bits
       → P1 puncture (46-of-61 pattern) = 368 bits
       → QPP interleave π(x) = (45x + 92x²) mod 368 → decorrelate.
  Stream frames: LICH chunk (48 bits → 4×Golay(24,12) = 96 bits; six
       40-bit LSF fragments + 3-bit counter) + FN/payload (not decoded
       here — voice).
"""

from __future__ import annotations

import numpy as np

from openwebrx_tpu_torch.digimodes import fec

SYNC_LSF = 0x55F7
SYNC_STREAM = 0xFF5D
SYNC_PACKET = 0x75FF
FRAME_DIBITS = 192          # 384 bits
SYNC_DIBITS = 8
PAYLOAD_BITS = 368

# base-40 callsign alphabet (spec §2.4)
_B40 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-/."

# P1 puncture pattern: [1] + [1,1,1,0]×15 (61 entries, 46 kept);
# 8 periods cover the 488 encoded bits → 368 transmitted (spec §4.4)
_P1 = np.asarray([1] + [1, 1, 1, 0] * 15, bool)

# QPP interleaver (spec §4.5)
_QPP = (45 * np.arange(368) + 92 * np.arange(368) ** 2) % 368

# decorrelator / randomizer bytes (spec §4.6)
_DECOR = np.unpackbits(np.asarray([
    0xD6, 0xB5, 0xE2, 0x30, 0x82, 0xFF, 0x84, 0x62, 0xBA, 0x4E,
    0x96, 0x90, 0xD8, 0x98, 0xDD, 0x5D, 0x0C, 0xC8, 0x52, 0x43,
    0x91, 0x1D, 0xF8, 0x6E, 0x68, 0x2F, 0x35, 0xDA, 0x14, 0xEA,
    0xCD, 0x76, 0x19, 0x8D, 0xD5, 0x80, 0xD1, 0x33, 0x87, 0x13,
    0x57, 0x18, 0x2D, 0x29, 0x78, 0xC3], np.uint8))


def encode_callsign(call: str) -> int:
    """Callsign → 48-bit base-40 address (spec §2.4).  '@ALL' is the
    broadcast address 0xFFFFFFFFFFFF."""
    if call == "@ALL":
        return 0xFFFFFFFFFFFF
    v = 0
    for ch in reversed(call.upper()[:9]):
        idx = _B40.find(ch)
        v = v * 40 + (idx if idx >= 0 else 0)
    return v


def decode_callsign(addr: int) -> str:
    if addr == 0xFFFFFFFFFFFF:
        return "@ALL"
    if addr >= 40 ** 9:
        return f"#{addr:012X}"         # reserved space
    out = []
    while addr:
        out.append(_B40[addr % 40])
        addr //= 40
    return "".join(out) or " "


def _crc16_m17(data: bytes) -> int:
    """M17 CRC-16 (poly 0x5935, init 0xFFFF, no reflection; spec §2.5)."""
    crc = 0xFFFF
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x5935 if crc & 0x8000 else crc << 1) \
                & 0xFFFF
    return crc


# ----------------------------------------------------------------- LSF ----
def lsf_encode(dst: str, src: str, type_bits: int = 0x0005,
               meta: bytes = b"\x00" * 14) -> np.ndarray:
    """LSF fields → 240 bits (with valid CRC)."""
    by = bytearray()
    by += int(encode_callsign(dst)).to_bytes(6, "big")
    by += int(encode_callsign(src)).to_bytes(6, "big")
    by += int(type_bits).to_bytes(2, "big")
    by += bytes(meta[:14].ljust(14, b"\x00"))
    by += _crc16_m17(bytes(by)).to_bytes(2, "big")
    return np.unpackbits(np.frombuffer(bytes(by), np.uint8))


def lsf_decode(bits240: np.ndarray) -> dict | None:
    by = np.packbits(np.asarray(bits240, np.uint8)).tobytes()
    if _crc16_m17(by[:28]) != int.from_bytes(by[28:30], "big"):
        return None
    type_bits = int.from_bytes(by[12:14], "big")
    return {
        "protocol": "M17",
        "target": decode_callsign(int.from_bytes(by[:6], "big")),
        "source": decode_callsign(int.from_bytes(by[6:12], "big")),
        "type_bits": type_bits,
        "mode": "stream" if type_bits & 1 else "packet",
        "can": (type_bits >> 7) & 0xF,
    }


def _puncture(bits: np.ndarray) -> np.ndarray:
    keep = np.resize(_P1, len(bits))
    return bits[keep]


def _depuncture(bits368: np.ndarray):
    """368 received bits → (488-bit array with zeros at punctured slots,
    boolean erasure mask)."""
    keep = np.resize(_P1, 488)
    full = np.zeros(488, np.uint8)
    full[keep] = np.asarray(bits368, np.uint8)
    return full, ~keep


def lsf_to_payload(bits240: np.ndarray) -> np.ndarray:
    """LSF bits → the frame's 368 transmitted payload bits."""
    enc = fec.conv_encode(np.concatenate([np.asarray(bits240, np.uint8),
                                          np.zeros(4, np.uint8)]))
    serial = enc.reshape(-1)           # 488 bits, (G1,G2) interleaved
    tx = _puncture(serial)
    out = np.empty(PAYLOAD_BITS, np.uint8)
    out[_QPP] = tx                     # interleave
    return out ^ _DECOR[:PAYLOAD_BITS]


def payload_to_lsf(bits368: np.ndarray) -> dict | None:
    """368 received payload bits → LSF dict (None on CRC failure)."""
    de = (np.asarray(bits368, np.uint8) ^ _DECOR[:PAYLOAD_BITS])[_QPP]
    full, erased = _depuncture(de)
    sym = full.reshape(-1, 2)
    dec = fec.viterbi_decode(sym, 240, erasures=erased.reshape(-1, 2))
    return lsf_decode(dec)


# ---------------------------------------------------------------- LICH ----
def lich_chunks(bits240: np.ndarray) -> list[np.ndarray]:
    """LSF → six 96-bit Golay-encoded LICH chunks (spec §4.7): each
    carries a 40-bit LSF fragment + 3-bit counter + 5 pad bits."""
    out = []
    bits = np.asarray(bits240, np.uint8)
    for i in range(6):
        frag = bits[i * 40:(i + 1) * 40]
        cnt = [(i >> 2) & 1, (i >> 1) & 1, i & 1]
        chunk48 = np.concatenate([frag, np.asarray(cnt, np.uint8),
                                  np.zeros(5, np.uint8)])
        golay = np.concatenate([
            fec.golay_24_12_encode(int("".join(
                map(str, chunk48[j * 12:(j + 1) * 12])), 2))
            for j in range(4)])
        out.append(golay)
    return out


def decode_lich(bits96: np.ndarray):
    """96 LICH bits → (fragment_index, 40 LSF bits) or None."""
    out = np.zeros(48, np.uint8)
    for j in range(4):
        data12, dist = fec.golay_24_12_decode(
            np.asarray(bits96, np.uint8)[j * 24:(j + 1) * 24])
        if dist > 3:
            return None
        out[j * 12:(j + 1) * 12] = [(data12 >> (11 - b)) & 1
                                    for b in range(12)]
    idx = (int(out[40]) << 2) | (int(out[41]) << 1) | int(out[42])
    if idx > 5:
        return None
    return idx, out[:40]


# --------------------------------------------------------------- frames ---
def _sync_dibits(word16: int) -> np.ndarray:
    bits = [(word16 >> (15 - i)) & 1 for i in range(16)]
    return np.asarray([(bits[2 * i] << 1) | bits[2 * i + 1]
                       for i in range(8)], np.uint8)


_LSF_SYNC = _sync_dibits(SYNC_LSF)
_STREAM_SYNC = _sync_dibits(SYNC_STREAM)


def build_lsf_frame(dst: str, src: str, **kw) -> np.ndarray:
    bits = lsf_to_payload(lsf_encode(dst, src, **kw))
    dib = (bits[0::2] << 1) | bits[1::2]
    return np.concatenate([_LSF_SYNC, dib])


def build_stream_frame(lsf_bits240: np.ndarray, chunk_idx: int) -> np.ndarray:
    """Stream frame carrying LICH chunk `chunk_idx` (voice payload zeroed
    — out of scope, the vocoder is external)."""
    lich = lich_chunks(lsf_bits240)[chunk_idx]
    rest = np.zeros(PAYLOAD_BITS - 96, np.uint8)
    bits = np.concatenate([lich, rest]) ^ _DECOR[:PAYLOAD_BITS]
    dib = (bits[0::2] << 1) | bits[1::2]
    return np.concatenate([_STREAM_SYNC, dib])


class M17Decoder:
    """Streaming dibit consumer: LSF frames decode directly; stream
    frames accumulate LICH fragments until the full LSF reassembles.
    meta_cb(dict) receives {"protocol": "M17", "source", "target",
    "can", "mode"} — what the reference's MetaParser forwards from
    m17-demod (owrx/meta.py)."""

    SYNC_TOLERANCE = 1

    def __init__(self, meta_cb=None):
        self.meta_cb = meta_cb
        self._buf = np.zeros(0, np.uint8)
        self._lich = {}                 # fragment idx → 40 bits

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
            at, kind = hit
            if at + FRAME_DIBITS > len(buf):
                pos = at
                break
            self._frame(buf[at + SYNC_DIBITS:at + FRAME_DIBITS], kind, emit)
            pos = at + FRAME_DIBITS
        self._buf = buf[pos:]
        return events

    def _find_sync(self, buf: np.ndarray, pos: int):
        """Earliest sync BY POSITION across both patterns (a later LSF
        must not shadow earlier stream frames in the same chunk — their
        LICH fragments would be lost)."""
        hi = len(buf) - SYNC_DIBITS
        if hi <= pos:
            return None
        windows = np.lib.stride_tricks.sliding_window_view(
            buf[pos:], SYNC_DIBITS)
        best = None
        for pat, kind in ((_LSF_SYNC, "lsf"), (_STREAM_SYNC, "stream")):
            x = windows ^ pat
            dist = ((x & 1) + (x >> 1)).sum(axis=1)
            ok = np.flatnonzero(dist <= self.SYNC_TOLERANCE)
            if len(ok) and (best is None or int(ok[0]) < best[0]):
                best = (int(ok[0]), kind)
        if best is None:
            return None
        return pos + best[0], best[1]

    def _frame(self, payload_dibits: np.ndarray, kind: str, emit):
        bits = np.empty(PAYLOAD_BITS, np.uint8)
        bits[0::2] = payload_dibits >> 1
        bits[1::2] = payload_dibits & 1
        if kind == "lsf":
            lsf = payload_to_lsf(bits)
            if lsf is not None:
                emit(lsf)
            return
        # stream frame: harvest the LICH fragment (first 96 bits after
        # decorrelation)
        lich = decode_lich((bits ^ _DECOR[:PAYLOAD_BITS])[:96])
        if lich is None:
            return
        idx, frag = lich
        self._lich[idx] = frag
        if len(self._lich) == 6:
            full = np.concatenate([self._lich[i] for i in range(6)])
            self._lich = {}
            lsf = lsf_decode(full)
            if lsf is not None:
                lsf["via"] = "lich"
                emit(lsf)
