"""Host-side FEC primitives for digital-voice frame decoding.

The block codes DMR and System Fusion use around their control data —
small, bursty, per-frame — are host work (numpy), not TPU work: the TPU
symbol path delivers dibits (models/digital_voice.py) and these codes run
on a few hundred bits per 60 ms frame.

Reference analog: the digiham library the reference pipes through
(/root/reference/csdr/chain/digiham.py:15-143 wires dmr_decoder /
ysf_decoder binaries; their internals implement these same codes).
Implemented from the public specs (ETSI TS 102 361-1 appendix B for DMR;
the Yaesu System Fusion spec for YSF).  In this offline image there is no
off-air capture to validate against, so every code here is exercised by
encode→corrupt→decode round-trip tests (tests/test_dmr_ysf.py).

Codes:
  * Hamming(15,11,3) / Hamming(13,9,3)  — BPTC(196,96) rows / columns
  * extended Golay(24,12,8)             — YSF FICH blocks
  * Golay(20,8,7)                       — DMR slot type (the (24,12) code
                                          shortened by its 4 high data bits)
  * rate-1/2 K=5 convolutional + Viterbi — YSF FICH/DCH
  * CRC-16-CCITT                        — YSF FICH checksum
  * RS(12,9) over GF(2^8)               — DMR full link control checksum
"""

from __future__ import annotations

import numpy as np

# ------------------------------------------------------------- Hamming ----
# Parity equations per ETSI TS 102 361-1 B.3.2/B.3.3 (as implemented by
# the public digiham/MMDVM decoders the reference wraps).
_H15_ROWS = [
    (0, 1, 2, 3, 5, 7, 8),          # c11
    (1, 2, 3, 4, 6, 8, 9),          # c12
    (2, 3, 4, 5, 7, 9, 10),         # c13
    (0, 1, 2, 4, 6, 7, 10),         # c14
]
_H13_ROWS = [
    (0, 1, 3, 5, 6),                # c9
    (0, 1, 2, 4, 6, 7),             # c10
    (0, 1, 2, 3, 5, 7, 8),          # c11
    (0, 2, 4, 5, 8),                # c12
]


def _hamming_encode(data: np.ndarray, rows) -> np.ndarray:
    par = [np.bitwise_xor.reduce(data[list(r)]) for r in rows]
    return np.concatenate([data, np.asarray(par, np.uint8)])


def _hamming_decode(word: np.ndarray, rows, k: int):
    """Single-error-correcting decode → (data, ok)."""
    word = np.asarray(word, np.uint8).copy()
    syndrome = tuple(
        int(np.bitwise_xor.reduce(word[list(r)]) ^ word[k + i])
        for i, r in enumerate(rows))
    if not any(syndrome):
        return word[:k], True
    # find the (unique) bit whose flip clears the syndrome
    n = k + len(rows)
    for b in range(n):
        trial = word.copy()
        trial[b] ^= 1
        s = tuple(
            int(np.bitwise_xor.reduce(trial[list(r)]) ^ trial[k + i])
            for i, r in enumerate(rows))
        if not any(s):
            return trial[:k], True
    return word[:k], False


def hamming_15_11_encode(d):
    return _hamming_encode(np.asarray(d, np.uint8), _H15_ROWS)


def hamming_15_11_decode(w):
    return _hamming_decode(w, _H15_ROWS, 11)


def hamming_13_9_encode(d):
    return _hamming_encode(np.asarray(d, np.uint8), _H13_ROWS)


def hamming_13_9_decode(w):
    return _hamming_decode(w, _H13_ROWS, 9)


# -------------------------------------------------------------- Golay -----
# Extended binary Golay (24,12,8) built from the (23,12) perfect code with
# generator polynomial g(x) = x^11+x^10+x^6+x^5+x^4+x^2+1 (0xC75) plus an
# overall parity bit.  Decode = minimum distance over all 4096 codewords
# (a 4096×24 xor+popcount — microseconds in numpy), correcting ≤3 errors.
_GOLAY_POLY = 0xC75


def _golay23_parity(data12: int) -> int:
    """11 parity bits of the (23,12) cyclic Golay for 12 data bits."""
    reg = data12 << 11
    for i in range(22, 10, -1):
        if reg & (1 << i):
            reg ^= _GOLAY_POLY << (i - 11)
    return reg & 0x7FF


def _golay24_word(data12: int) -> int:
    """24-bit extended codeword: [12 data | 11 parity | overall parity]."""
    par = _golay23_parity(data12)
    w = (data12 << 12) | (par << 1)
    w |= bin(w).count("1") & 1
    return w


_GOLAY_TABLE = np.array([_golay24_word(d) for d in range(4096)],
                        np.uint32)
_GOLAY_BITS = np.unpackbits(
    _GOLAY_TABLE.astype(">u4").view(np.uint8).reshape(-1, 4),
    axis=1)[:, 8:]        # (4096, 24)


def golay_24_12_encode(data12: int) -> np.ndarray:
    """12-bit int → 24 bits (MSB first)."""
    return _GOLAY_BITS[data12 & 0xFFF].copy()


def golay_24_12_decode(bits24) -> tuple[int, int]:
    """24 bits → (data12, distance).  distance ≤ 3 ⇒ corrected."""
    r = np.asarray(bits24, np.uint8)
    dist = (_GOLAY_BITS ^ r).sum(axis=1)
    best = int(np.argmin(dist))
    return best, int(dist[best])


def golay_20_8_encode(data8: int) -> np.ndarray:
    """DMR slot-type code: the (24,12) extended Golay restricted to data
    words with the 4 high bits zero, those 4 positions removed →
    (20,8,7) (ETSI TS 102 361-1 B.3.1)."""
    return golay_24_12_encode(data8 & 0xFF)[4:]


def golay_20_8_decode(bits20) -> tuple[int, int]:
    r = np.concatenate([np.zeros(4, np.uint8),
                        np.asarray(bits20, np.uint8)])
    sub = _GOLAY_BITS[:256]          # data words 0..255 have high bits 0
    dist = (sub ^ r).sum(axis=1)
    best = int(np.argmin(dist))
    return best, int(dist[best])


# --------------------------------------------------- convolutional --------
# Rate-1/2, K=5 feed-forward code with generators G1=0x19 (11001) and
# G2=0x17 (10111) — the YSF FICH/DCH code (Yaesu spec; same polynomials
# as the public MMDVM/digiham implementations the reference wraps).
_G1, _G2 = 0x19, 0x17


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """bits (n,) → symbol dibits (n, 2); encoder is zero-flushed by the
    caller appending 4 tail zeros."""
    bits = np.asarray(bits, np.uint8)
    reg = 0
    out = np.empty((len(bits), 2), np.uint8)
    for i, b in enumerate(bits):
        reg = ((reg << 1) | int(b)) & 0x1F
        out[i, 0] = bin(reg & _G1).count("1") & 1
        out[i, 1] = bin(reg & _G2).count("1") & 1
    return out


def viterbi_decode(symbols: np.ndarray, n_bits: int,
                   erasures: np.ndarray | None = None) -> np.ndarray:
    """Hard-decision Viterbi over (n,2) received dibits → n_bits decoded
    bits (the encoder's zero tail is decoded too; caller slices).

    ``erasures`` (n,2) bool marks PUNCTURED positions (M17 P1/P2 rate
    matching): erased bits contribute zero branch cost."""
    symbols = np.asarray(symbols, np.uint8)
    n = len(symbols)
    NSTATES = 16
    metrics = np.full(NSTATES, 1 << 30, np.int64)
    metrics[0] = 0
    paths = np.zeros((n, NSTATES), np.uint8)
    # precompute branch outputs: state (4 bits) + input bit → reg 5 bits
    out0 = np.empty((NSTATES, 2, 2), np.uint8)
    for s in range(NSTATES):
        for b in range(2):
            reg = ((s << 1) | b) & 0x1F
            out0[s, b, 0] = bin(reg & _G1).count("1") & 1
            out0[s, b, 1] = bin(reg & _G2).count("1") & 1
    for i in range(n):
        new = np.full(NSTATES, 1 << 30, np.int64)
        prev = np.zeros(NSTATES, np.uint8)
        r = symbols[i]
        e0 = e1 = False
        if erasures is not None:
            e0, e1 = bool(erasures[i, 0]), bool(erasures[i, 1])
        for s in range(NSTATES):
            if metrics[s] >= (1 << 30):
                continue
            for b in range(2):
                ns = ((s << 1) | b) & 0xF
                cost = (0 if e0 else int(out0[s, b, 0] ^ r[0])) + \
                       (0 if e1 else int(out0[s, b, 1] ^ r[1]))
                m = metrics[s] + cost
                if m < new[ns]:
                    new[ns] = m
                    prev[ns] = (s << 1) | b   # pack predecessor + bit? no:
        # store chosen predecessor state per next-state (bit = ns & 1 of
        # the shifted-in input, predecessor = prev >> 1 ... we packed
        # (s<<1)|b which equals (pred_state<<1)|input)
        paths[i] = prev
        metrics = new
    # chain back from the best final state
    state = int(np.argmin(metrics))
    bits = np.zeros(n, np.uint8)
    for i in range(n - 1, -1, -1):
        packed = int(paths[i, state])
        bits[i] = packed & 1
        state = (packed >> 1) & 0xF
    return bits[:n_bits]


# ------------------------------------------------------------- CRC --------
def crc16_ccitt(bits: np.ndarray, init: int = 0xFFFF) -> int:
    """Bitwise CRC-16-CCITT (poly 0x1021) over a bit array, MSB first."""
    crc = init
    for b in np.asarray(bits, np.uint8):
        crc ^= int(b) << 15
        crc = ((crc << 1) ^ 0x1021 if crc & 0x8000 else crc << 1) & 0xFFFF
    return crc


# --------------------------------------------------------- RS(12,9) -------
# DMR full-LC checksum: shortened Reed-Solomon RS(12,9) over GF(2^8) with
# field polynomial x^8+x^4+x^3+x^2+1 (0x11D) and generator
# g(x) = (x−α^0)(x−α^1)(x−α^2) (ETSI TS 102 361-1 B.3.5).  The three
# parity bytes are XOR-masked per data type (CRC mask) by the caller.
_EXP = np.zeros(512, np.int64)
_LOG = np.zeros(256, np.int64)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
_EXP[255:510] = _EXP[:255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


# g(x) coefficients, low degree first: (x+1)(x+α)(x+α²)
_G_RS = [1]
for _r in range(3):
    _alpha = int(_EXP[_r])
    _new = [0] * (len(_G_RS) + 1)
    for _i, _c in enumerate(_G_RS):
        _new[_i] ^= _gf_mul(_c, _alpha)
        _new[_i + 1] ^= _c
    _G_RS = _new
_G_RS = _G_RS[::-1]                  # high degree first, monic


def rs_12_9_parity(data9: np.ndarray) -> np.ndarray:
    """9 data bytes → 3 parity bytes (systematic encoder: remainder of
    data·x³ mod g(x))."""
    rem = [0, 0, 0]
    for d in np.asarray(data9, np.uint8):
        factor = int(d) ^ rem[0]
        rem = [rem[1] ^ _gf_mul(factor, _G_RS[1]),
               rem[2] ^ _gf_mul(factor, _G_RS[2]),
               _gf_mul(factor, _G_RS[3])]
    return np.asarray(rem, np.uint8)


def rs_12_9_check(word12: np.ndarray) -> bool:
    """True when the 12-byte word (9 data + 3 parity) is a codeword."""
    return bool(np.all(rs_12_9_parity(np.asarray(word12[:9], np.uint8))
                       == np.asarray(word12[9:], np.uint8)))


# ----------------------------------------------- K=3 convolutional --------
# Rate-1/2, K=3 feed-forward code with generators G1=0b111, G2=0b101
# (octal 7,5) — the D-Star radio-header code (JARL D-STAR spec).
_G1_K3, _G2_K3 = 0b111, 0b101


def conv_encode_k3(bits: np.ndarray) -> np.ndarray:
    """bits (n,) → (n, 2) symbol bits; caller appends 2 flush zeros."""
    bits = np.asarray(bits, np.uint8)
    reg = 0
    out = np.empty((len(bits), 2), np.uint8)
    for i, b in enumerate(bits):
        reg = ((reg << 1) | int(b)) & 0x7
        out[i, 0] = bin(reg & _G1_K3).count("1") & 1
        out[i, 1] = bin(reg & _G2_K3).count("1") & 1
    return out


def viterbi_decode_k3(symbols: np.ndarray, n_bits: int) -> np.ndarray:
    """Hard-decision Viterbi (4 states) over (n,2) received bit pairs."""
    symbols = np.asarray(symbols, np.uint8)
    n = len(symbols)
    NS = 4
    metrics = np.full(NS, 1 << 30, np.int64)
    metrics[0] = 0
    paths = np.zeros((n, NS), np.uint8)
    out0 = np.empty((NS, 2, 2), np.uint8)
    for s in range(NS):
        for b in range(2):
            reg = ((s << 1) | b) & 0x7
            out0[s, b, 0] = bin(reg & _G1_K3).count("1") & 1
            out0[s, b, 1] = bin(reg & _G2_K3).count("1") & 1
    for i in range(n):
        new = np.full(NS, 1 << 30, np.int64)
        prev = np.zeros(NS, np.uint8)
        r = symbols[i]
        for s in range(NS):
            if metrics[s] >= (1 << 30):
                continue
            for b in range(2):
                ns = ((s << 1) | b) & 0x3
                cost = int(out0[s, b, 0] ^ r[0]) + int(out0[s, b, 1] ^ r[1])
                m = metrics[s] + cost
                if m < new[ns]:
                    new[ns] = m
                    prev[ns] = (s << 1) | b
        paths[i] = prev
        metrics = new
    state = int(np.argmin(metrics))
    bits = np.zeros(n, np.uint8)
    for i in range(n - 1, -1, -1):
        packed = int(paths[i, state])
        bits[i] = packed & 1
        state = (packed >> 1) & 0x3
    return bits[:n_bits]


def hamming_16_11_encode(d):
    """Hamming(16,11,4): the (15,11) code + overall even parity — the
    DMR embedded-message row code (ETSI TS 102 361-1 B.3.4)."""
    w = hamming_15_11_encode(np.asarray(d, np.uint8))
    return np.concatenate([w, [np.bitwise_xor.reduce(w)]])


def hamming_16_11_decode(w):
    """SECDED decode → (data11, ok): corrects 1 error, DETECTS 2.

    Extended-Hamming logic: clean (15,11) syndrome + good overall parity
    ⇒ clean; clean syndrome + bad parity ⇒ only the parity bit flipped;
    dirty syndrome + bad parity ⇒ single correctable error; dirty
    syndrome + GOOD parity ⇒ double error — reject (a bare (15,11)
    decode would silently miscorrect it)."""
    w = np.asarray(w, np.uint8)
    parity_ok = int(np.bitwise_xor.reduce(w)) == 0
    syndrome_clean = np.array_equal(hamming_15_11_encode(w[:11]), w[:15])
    if syndrome_clean:
        return w[:11].copy(), True          # parity-bit-only flip is fine
    if parity_ok:
        return w[:11].copy(), False         # double error detected
    return hamming_15_11_decode(w[:15])     # single error: correct it
