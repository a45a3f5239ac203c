"""Native DMR frame layer: dibit stream → talker metadata.

The TPU symbol path (models/digital_voice.py: discriminator → RRC →
timing recovery → 4FSK slicer) delivers one dibit per symbol; this module
does the host-side frame work the reference delegates to the external
digiham ``dmr_decoder`` binary (/root/reference/csdr/chain/digiham.py:
15-56): burst sync search, slot type (Golay(20,8)), BPTC(196,96)
de-interleave + Hamming grid, full link control with the RS(12,9)
checksum, and LC field extraction (talkgroup / source / call type) —
so the MetaPanel gets talker metadata with ZERO external binaries.
(The AMBE vocoder itself stays external/gated: voice payload decode
needs codec licenses this project does not ship.)

Frame structure (ETSI TS 102 361-1 §4/§6, appendix B):
  burst = 98 payload bits | 10 slot-type | 48 sync/embedded | 10 slot-type
          | 98 payload bits                                  (264 bits)
  data-burst payload (196 bits) = BPTC(196,96) → 96 bits
  voice LC header / terminator: 96 bits = 72-bit LC + RS(12,9) parity
  (3 bytes) XOR-masked 0x96,0x96,0x96 (header) / 0x99,0x99,0x99 (term.)

Dibit mapping: MSB-first per ETSI §4.2 symbol map (dibit value 0..3 →
bit pair 01,00,10,11 ordered by deviation); digiham's convention of
(bit1, bit0) = (dibit >> 1, dibit & 1) is used here.
"""

from __future__ import annotations

import numpy as np

from openwebrx_tpu_torch.digimodes import fec

# 48-bit sync patterns (ETSI TS 102 361-1 §9.1.1)
SYNC_PATTERNS = {
    0x755FD7DF75F7: ("bs", "voice"),
    0xDFF57D75DF5D: ("bs", "data"),
    0x7F7D5DD57DFD: ("ms", "voice"),
    0xD5D7F77FD757: ("ms", "data"),
}

DATA_TYPES = {
    0: "pi_header", 1: "voice_lc_header", 2: "terminator_with_lc",
    3: "csbk", 4: "mbc_header", 5: "mbc_continuation", 6: "data_header",
    7: "rate_1_2_data", 8: "rate_3_4_data", 9: "idle", 10: "rate_1_data",
}

BURST_DIBITS = 132          # 264 bits
SYNC_DIBITS = 24
HALF_PAYLOAD_DIBITS = 54    # 98 payload + 10 slot-type bits = 108 bits

_LC_MASKS = {"voice_lc_header": 0x96, "terminator_with_lc": 0x99}


def _pattern_dibits(pattern48: int) -> np.ndarray:
    bits = [(pattern48 >> (47 - i)) & 1 for i in range(48)]
    return np.asarray([(bits[2 * i] << 1) | bits[2 * i + 1]
                       for i in range(24)], np.uint8)


_SYNC_DIBITS = {p: _pattern_dibits(p) for p in SYNC_PATTERNS}


def dibits_to_bits(dibits: np.ndarray) -> np.ndarray:
    d = np.asarray(dibits, np.uint8)
    out = np.empty(2 * len(d), np.uint8)
    out[0::2] = d >> 1
    out[1::2] = d & 1
    return out


def bits_to_dibits(bits: np.ndarray) -> np.ndarray:
    b = np.asarray(bits, np.uint8)
    return (b[0::2] << 1) | b[1::2]


# ------------------------------------------------------ BPTC(196,96) ------
def bptc_deinterleave(bits196: np.ndarray) -> np.ndarray:
    """Deinterleave: transmitted index i carried matrix index (i·181)%196
    (ETSI B.1.1)."""
    out = np.empty(196, np.uint8)
    r = np.asarray(bits196, np.uint8)
    idx = (np.arange(196) * 181) % 196
    out[idx] = r
    return out


def bptc_interleave(bits196: np.ndarray) -> np.ndarray:
    idx = (np.arange(196) * 181) % 196
    return np.asarray(bits196, np.uint8)[idx]


def bptc_decode(bits196: np.ndarray) -> tuple[np.ndarray, bool]:
    """196 transmitted bits → (96 info bits, ok).

    After de-interleaving, bit 0 pads and bits 1..195 form a 13×15 grid:
    rows 0-8 are Hamming(15,11,3) codewords, every column a
    Hamming(13,9,3) codeword.  Info = row0 bits 3-10 (8; bits 0-2 are
    reserved R) + rows 1-8 bits 0-10 (88)."""
    d = bptc_deinterleave(bits196)
    grid = d[1:].reshape(13, 15).copy()
    ok = True
    for _ in range(2):              # row/column iteration heals crossings
        for c in range(15):
            col, cok = fec.hamming_13_9_decode(grid[:, c])
            grid[:9, c] = col
            ok &= cok
        for r in range(9):
            row, rok = fec.hamming_15_11_decode(grid[r])
            grid[r, :11] = row
            ok &= rok
    info = np.concatenate([grid[0, 3:11]] +
                          [grid[r, :11] for r in range(1, 9)])
    return info, bool(ok)


def bptc_encode(info96: np.ndarray) -> np.ndarray:
    """96 info bits → 196 transmitted bits (for tests/fixtures)."""
    info = np.asarray(info96, np.uint8)
    grid = np.zeros((13, 15), np.uint8)
    grid[0, 3:11] = info[:8]
    for r in range(1, 9):
        grid[r, :11] = info[8 + (r - 1) * 11: 8 + r * 11]
    for r in range(9):
        grid[r] = fec.hamming_15_11_encode(grid[r, :11])
    for c in range(15):
        grid[:, c] = fec.hamming_13_9_encode(grid[:9, c])
    out = np.zeros(196, np.uint8)
    out[1:] = grid.reshape(-1)
    return bptc_interleave(out)


# ------------------------------------------------------------- LC ---------
def decode_lc(info96: np.ndarray, data_type: str) -> dict | None:
    """96 BPTC info bits of a voice LC header / terminator → LC fields.

    LC (72 bits): PF(1) R(1) FLCO(6) | FID(8) | ServiceOptions(8) |
    dest(24) | source(24); + RS(12,9) parity XOR-masked by data type
    (ETSI §7.1.1, B.3.5)."""
    bits = np.asarray(info96, np.uint8)
    by = np.packbits(bits)
    mask = _LC_MASKS.get(data_type, 0)
    word = by.copy()
    word[9:12] ^= mask
    if not fec.rs_12_9_check(word):
        return None
    flco = int(by[0]) & 0x3F
    fid = int(by[1])
    opts = int(by[2])
    dest = (int(by[3]) << 16) | (int(by[4]) << 8) | int(by[5])
    src = (int(by[6]) << 16) | (int(by[7]) << 8) | int(by[8])
    return {
        "protocol": "DMR",
        "flco": flco,
        "type": "group" if flco == 0 else
                ("direct" if flco == 3 else f"flco{flco}"),
        "feature_set": fid,
        "service_options": opts,
        "target": dest,            # talkgroup (group) / radio id (direct)
        "source": src,
    }


def encode_lc(flco: int, fid: int, opts: int, dest: int, src: int,
              data_type: str) -> np.ndarray:
    """LC fields → 96 info bits (tests/fixtures)."""
    by = np.zeros(12, np.uint8)
    by[0] = flco & 0x3F
    by[1] = fid
    by[2] = opts
    by[3:6] = [(dest >> 16) & 0xFF, (dest >> 8) & 0xFF, dest & 0xFF]
    by[6:9] = [(src >> 16) & 0xFF, (src >> 8) & 0xFF, src & 0xFF]
    by[9:12] = fec.rs_12_9_parity(by[:9]) ^ _LC_MASKS.get(data_type, 0)
    return np.unpackbits(by)


# ---------------------------------------------------------- decoder -------
class DmrDecoder:
    """Streaming dibit consumer: sync search → burst parse → metadata.

    ``meta_cb(dict)`` fires on every decoded voice LC header / terminator
    (talkgroup, source, slot info) and on sync acquisition/loss — the
    events the reference's MetaParser turns into MetaPanel updates
    (owrx/meta.py; services/meta.py here)."""

    SYNC_TOLERANCE = 4              # bit errors accepted in 48-bit sync

    def __init__(self, meta_cb=None):
        self.meta_cb = meta_cb
        self._buf = np.zeros(0, np.uint8)
        self.in_sync = False
        self.color_code = None
        # embedded-LC collection (bursts B-E after a voice-sync burst)
        self._frag_expect = 0
        self._frags: list[np.ndarray] = []
        self._cont = False          # buffer start is mid-superframe
        self._last_embedded = None

    def _emit(self, meta: dict):
        if self.meta_cb is not None:
            self.meta_cb(meta)

    def feed(self, dibits: np.ndarray) -> list[dict]:
        """Consume dibits; returns the metadata events decoded."""
        events: list[dict] = []
        cb, self.meta_cb = self.meta_cb, (lambda m: (events.append(m),
                                                     cb and cb(m)))
        try:
            self._buf = np.concatenate(
                [self._buf, np.asarray(dibits, np.uint8)])
            self._scan()
        finally:
            self.meta_cb = cb
        return events

    def _scan(self):
        buf = self._buf
        pos = 0
        n = len(buf)
        # continuation: the previous feed ended mid voice superframe with
        # the buffer trimmed on a burst boundary — bursts B-E carry no
        # sync, so the sync search alone would skip their fragments
        resume = self._cont and self._frag_expect > 0
        self._cont = False                  # _follow may set it again
        if resume:
            pos = self._follow(buf, pos)
        while n - pos >= BURST_DIBITS:
            hit = self._find_sync(buf, pos)
            if hit is None:
                # keep one burst of tail for a sync straddling the edge
                pos = n - BURST_DIBITS + 1
                break
            sync_at, station, kind = hit
            burst_start = sync_at - HALF_PAYLOAD_DIBITS
            if burst_start < pos:
                pos = sync_at + 1
                continue
            if burst_start + BURST_DIBITS > n:
                pos = burst_start
                break
            self._burst(buf[burst_start:burst_start + BURST_DIBITS],
                        station, kind)
            pos = burst_start + BURST_DIBITS
            if self._frag_expect > 0:
                pos = self._follow(buf, pos)
        self._buf = buf[pos:]

    def _follow(self, buf: np.ndarray, pos: int) -> int:
        """Consume CONTIGUOUS unsynced bursts following a voice burst —
        bursts B-E carry the embedded-LC fragments in the sync field.
        (Continuous-transmission cadence: one burst every 132 dibits; a
        TDMA base-station stream interleaves the other slot's bursts,
        which DO carry syncs and therefore fall back to the main loop.)"""
        n = len(buf)
        while self._frag_expect > 0:
            if n - pos < BURST_DIBITS:
                self._cont = True            # resume on the next feed
                break
            seg = buf[pos:pos + BURST_DIBITS]
            center = seg[HALF_PAYLOAD_DIBITS:
                         HALF_PAYLOAD_DIBITS + SYNC_DIBITS]
            if self._is_sync(center):
                self._frag_expect = 0        # next synced burst: main loop
                break
            bits = dibits_to_bits(seg)
            self._frags.append(bits[116:148])  # 32 embedded-data bits
            self._frag_expect -= 1
            pos += BURST_DIBITS
            if len(self._frags) == 4:
                lc = embedded_lc_decode(np.concatenate(self._frags))
                self._frags = []
                self._frag_expect = 0
                if lc is not None and lc != self._last_embedded:
                    # store the UNDECORATED decode for dedup; decorating
                    # the stored dict would make every later identical
                    # superframe compare unequal and re-emit
                    self._last_embedded = dict(lc)
                    if self.color_code is not None:
                        lc = dict(lc, color_code=self.color_code)
                    self._emit(lc)
        return pos

    def _is_sync(self, center24: np.ndarray) -> bool:
        for pd in _SYNC_DIBITS.values():
            x = center24 ^ pd
            if ((x & 1) + (x >> 1)).sum() <= self.SYNC_TOLERANCE:
                return True
        return False

    def _find_sync(self, buf: np.ndarray, pos: int):
        """EARLIEST dibit index ≥ pos+54 where any of the 4 sync patterns
        matches within tolerance.  Earliest-by-position across patterns
        matters: scanning pattern-by-pattern would let a later voice sync
        shadow an earlier data burst in the same chunk, dropping its LC."""
        lo = pos + HALF_PAYLOAD_DIBITS
        hi = len(buf) - SYNC_DIBITS - 10
        if hi <= lo:
            return None
        windows = np.lib.stride_tricks.sliding_window_view(
            buf[lo:hi + SYNC_DIBITS], SYNC_DIBITS)
        best = None
        for pattern, (station, kind) in SYNC_PATTERNS.items():
            pd = _SYNC_DIBITS[pattern]
            # bit distance between dibits = popcount of 2-bit xor
            x = windows ^ pd
            dist = ((x & 1) + (x >> 1)).sum(axis=1)
            ok = np.flatnonzero(dist <= self.SYNC_TOLERANCE)
            if len(ok) and (best is None or int(ok[0]) < best[0]):
                best = (int(ok[0]), station, kind)
        if best is None:
            return None
        return lo + best[0], best[1], best[2]

    def _burst(self, burst: np.ndarray, station: str, kind: str):
        bits = dibits_to_bits(burst)            # 264
        if not self.in_sync:
            self.in_sync = True
            self._emit({"protocol": "DMR", "sync": f"{station} {kind}"})
        if kind != "data":
            # voice burst A: the next 4 contiguous bursts (B-E) carry the
            # embedded LC fragments
            self._frag_expect = 4
            self._frags = []
            return
        # slot type: 10 bits before + 10 bits after the sync field
        st_bits = np.concatenate([bits[98:108], bits[156:166]])
        st, dist = fec.golay_20_8_decode(st_bits)
        if dist > 3:
            return
        self.color_code = (st >> 4) & 0xF
        data_type = DATA_TYPES.get(st & 0xF, f"dt{st & 0xF}")
        payload = np.concatenate([bits[:98], bits[166:264]])   # 196
        if data_type in _LC_MASKS:
            info, ok = bptc_decode(payload)
            if not ok:
                return
            lc = decode_lc(info, data_type)
            if lc is not None:
                # NOT "slot": the frontend parses meta.slot as the numeric
                # TDMA timeslot (MetaPanel.js); the burst's data type is a
                # different fact.  The TDMA slot needs CACH TACT decoding,
                # which single-frequency captures don't carry reliably —
                # omitted rather than guessed.
                lc["frame_type"] = data_type
                lc["color_code"] = self.color_code
                if data_type == "terminator_with_lc":
                    lc["end"] = True
                self._emit(lc)
        elif data_type == "idle":
            pass


def build_burst(data_type: str, lc_info96: np.ndarray,
                color_code: int = 1) -> np.ndarray:
    """Assemble one BS data burst (dibits) for tests/fixtures."""
    payload = bptc_encode(lc_info96)
    dt = {v: k for k, v in DATA_TYPES.items()}[data_type]
    st = fec.golay_20_8_encode(((color_code & 0xF) << 4) | dt)
    sync = dibits_to_bits(_SYNC_DIBITS[0xDFF57D75DF5D])
    bits = np.concatenate([
        payload[:98], st[:10], sync, st[10:], payload[98:]])
    assert len(bits) == 264
    return bits_to_dibits(bits)


# --------------------------------------------------------- embedded LC ----
# Voice bursts B-E carry the full LC in 4×32-bit embedded fragments so a
# receiver joining MID-CALL still learns the talker (ETSI TS 102 361-1
# §9.1.2 / B.2): 72 LC bits + a 5-bit checksum (sum of the 9 LC bytes
# mod 31) fill an 8-row × 16-column matrix COLUMN-wise, each row a
# Hamming(16,11,4) codeword; transmission order is row-major.
def _lc_checksum(lc_bytes: np.ndarray) -> int:
    return int(np.sum(lc_bytes.astype(np.int64)) % 31)


def embedded_lc_encode(info72: np.ndarray) -> np.ndarray:
    """72 LC bits → 128 embedded bits (4 fragments × 32)."""
    bits = np.asarray(info72, np.uint8)
    cs = _lc_checksum(np.packbits(bits))
    info = np.concatenate([bits,
                           np.asarray([(cs >> (4 - i)) & 1
                                       for i in range(5)], np.uint8),
                           np.zeros(11, np.uint8)])        # 88 = 8×11
    grid = np.zeros((8, 16), np.uint8)
    # fill column-wise: column c gets info[c*8:(c+1)*8] over rows
    grid[:, :11] = info.reshape(11, 8).T
    for r in range(8):
        grid[r] = fec.hamming_16_11_encode(grid[r, :11])
    return grid.reshape(-1)                                # row-major


def embedded_lc_decode(bits128: np.ndarray) -> dict | None:
    grid = np.asarray(bits128, np.uint8).reshape(8, 16).copy()
    rows = np.zeros((8, 11), np.uint8)
    for r in range(8):
        data, ok = fec.hamming_16_11_decode(grid[r])
        if not ok:
            return None
        rows[r] = data
    info = rows.T.reshape(-1)                              # 88
    lc_bits, cs_bits = info[:72], info[72:77]
    cs = 0
    for b in cs_bits:
        cs = (cs << 1) | int(b)
    by = np.packbits(lc_bits)
    if _lc_checksum(by) != cs:
        return None
    flco = int(by[0]) & 0x3F
    return {
        "protocol": "DMR",
        "flco": flco,
        "type": "group" if flco == 0 else
                ("direct" if flco == 3 else f"flco{flco}"),
        "feature_set": int(by[1]),
        "service_options": int(by[2]),
        "target": (int(by[3]) << 16) | (int(by[4]) << 8) | int(by[5]),
        "source": (int(by[6]) << 16) | (int(by[7]) << 8) | int(by[8]),
        "via": "embedded",
    }


def lc_info_bits(flco: int, fid: int, opts: int, dest: int,
                 src: int) -> np.ndarray:
    """The bare 72 LC bits (no RS) — the embedded fragments' payload."""
    by = np.zeros(9, np.uint8)
    by[0] = flco & 0x3F
    by[1] = fid
    by[2] = opts
    by[3:6] = [(dest >> 16) & 0xFF, (dest >> 8) & 0xFF, dest & 0xFF]
    by[6:9] = [(src >> 16) & 0xFF, (src >> 8) & 0xFF, src & 0xFF]
    return np.unpackbits(by)


def build_voice_superframe(info72: np.ndarray,
                           rng=None) -> np.ndarray:
    """Bursts A-F of a voice superframe (dibits, contiguous): A carries
    the BS voice sync; B-E carry the embedded LC fragments in the centre
    field; payloads are random AMBE stand-ins (tests/fixtures)."""
    if rng is None:
        rng = np.random.default_rng(0)
    frags = embedded_lc_encode(info72).reshape(4, 32)
    bursts = []
    for i in range(6):
        payload = rng.integers(0, 2, 196).astype(np.uint8)
        if i == 0:
            center = dibits_to_bits(_SYNC_DIBITS[0x755FD7DF75F7])
        else:
            emb = rng.integers(0, 2, 8).astype(np.uint8)
            data32 = frags[i - 1] if 1 <= i <= 4 else \
                np.zeros(32, np.uint8)
            center = np.concatenate([emb, data32, emb])
        st = rng.integers(0, 2, 20).astype(np.uint8)   # no slot type here
        bits = np.concatenate([payload[:98], st[:10], center,
                               st[10:], payload[98:]])
        bursts.append(bits_to_dibits(bits))
    return np.concatenate(bursts)
