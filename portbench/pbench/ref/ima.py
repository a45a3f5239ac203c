"""IMA ADPCM as the OpenWebRX browser client decodes it, and the cells
that judge an encoded stream.

Audio arrives framed: "SYNC", int16le step index, int16le predictor, then
codec bytes, two nibbles a byte, low nibble first; every header reseeds
the decoder.  A waterfall row is one stream from a fresh codec.

The judge never re-encodes the reference's audio and compares bytes (an
encoder's decision near a cell edge would make two correct streams
diverge).  It decodes the program's stream, so that it knows the codec
state before each nibble, and asks of each sample the reference worked
out: how far does it lie outside the interval of inputs that would have
given the program's nibble from that state (``cells``)?
"""

from __future__ import annotations

import numpy as np

INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8] * 2, np.int64)
STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41,
    45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190,
    209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724,
    796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272,
    2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132,
    7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500,
    20350, 22385, 24623, 27086, 29794, 32767], np.int64)
SYNC = b"SYNC"
BIG = 1 << 40


def split_frames(wire: bytes, stride: int = 100):
    """A framed audio stream → (states (S, 2) [index, predictor], nibbles
    (S, 2·stride) with −1 past a short last segment).  Raises ValueError
    when a header is missing where one is due."""
    states, segs = [], []
    pos, n = 0, len(wire)
    while pos < n:
        if wire[pos:pos + 4] != SYNC:
            raise ValueError(f"no SYNC header at byte {pos}")
        idx, pred = np.frombuffer(wire[pos + 4:pos + 8], "<i2")
        body = np.frombuffer(wire[pos + 8:pos + 8 + stride], np.uint8)
        pos += 8 + len(body)
        nib = np.full(2 * stride, -1, np.int64)
        nib[0:2 * len(body):2] = body & 0x0F
        nib[1:2 * len(body):2] = body >> 4
        states.append((int(idx), int(pred)))
        segs.append(nib)
    return np.array(states, np.int64).reshape(-1, 2), np.array(segs).reshape(len(segs), -1)


def row_nibbles(payload: bytes) -> np.ndarray:
    b = np.frombuffer(payload, np.uint8).astype(np.int64)
    out = np.empty(2 * len(b), np.int64)
    out[0::2], out[1::2] = b & 0x0F, b >> 4
    return out


def cells(states: np.ndarray, nibbles: np.ndarray):
    """Decode every segment from its start state, one sample position at a
    time for all segments at once → (lo, hi) (S, L) int64: the least and
    greatest int16 encoder input that gives each nibble from the state
    before it (−BIG/BIG where open), and ``valid`` where a nibble is."""
    s, length = nibbles.shape
    idx = np.clip(states[:, 0], 0, 88).astype(np.int64)
    pred = states[:, 1].astype(np.int64)
    lo = np.full((s, length), -BIG)
    hi = np.full((s, length), BIG)
    for i in range(length):
        nib = nibbles[:, i]
        ok = nib >= 0
        nb = np.where(ok, nib, 0)
        step = STEP_TABLE[idx]
        t1, t2 = step >> 1, step >> 2
        b4, b2, b1 = (nb & 4) > 0, (nb & 2) > 0, (nb & 1) > 0
        low = b4 * step + b2 * t1 + b1 * t2
        # each bit not taken bounds |diff| from above by the bits taken
        # before it plus that bit's threshold
        up = np.full(s, BIG)
        up = np.where(~b1, b4 * step + b2 * t1 + t2 - 1, up)
        up = np.where(~b2, np.minimum(up, b4 * step + t1 - 1), up)
        up = np.where(~b4, np.minimum(up, step - 1), up)
        neg = (nb & 8) > 0
        # diff = sample − pred; sign set ⇔ diff < 0 and |diff| = −diff
        d_lo = np.where(neg, -up, low)
        d_hi = np.where(neg, -np.maximum(low, 1), up)
        lo[:, i] = np.where(ok, np.maximum(pred + d_lo, -32768), -BIG)
        hi[:, i] = np.where(ok, np.minimum(pred + d_hi, 32767), BIG)
        # the decoder's own step
        diff = (step >> 3) + b1 * t2 + b2 * t1 + b4 * step
        pred = np.where(ok, np.clip(pred + np.where(neg, -diff, diff), -32768, 32767), pred)
        idx = np.where(ok, np.clip(idx + INDEX_TABLE[nb], 0, 88), idx)
    return lo, hi, nibbles >= 0


def truncation_gap(value: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                   scale_clip: tuple[int, int] = (-32768, 32767)) -> np.ndarray:
    """How far each float ``value`` (already scaled to int16 units) lies
    outside the inputs whose clip-and-truncate-toward-zero lands in the
    integer cell [lo, hi]; 0 inside."""
    cmin, cmax = scale_clip
    # trunc(v) = s ⇔ v ∈ [s, s+1) for s > 0, (s−1, s] for s < 0, (−1, 1) for 0
    v_lo = np.where(lo > 0, lo, lo - 1).astype(np.float64)
    v_hi = np.where(hi >= 0, hi + 1, hi).astype(np.float64)
    v_lo = np.where(lo <= cmin, -np.inf, v_lo)
    v_hi = np.where(hi >= cmax, np.inf, v_hi)
    return np.maximum(0.0, np.maximum(v_lo - value, value - v_hi))


def encode(samples: np.ndarray, state=(0, 0)):
    """Sequential IMA encode of int16 ``samples`` (S, L) from (index,
    predictor), one pair or one a row → nibbles (S, L) and each row's
    final state; for the control, whose output takes the program's
    place."""
    s, length = samples.shape
    st = np.broadcast_to(np.asarray(state, np.int64).reshape(-1, 2), (s, 2))
    idx, pred = st[:, 0].copy(), st[:, 1].copy()
    out = np.empty((s, length), np.int64)
    for i in range(length):
        step = STEP_TABLE[idx]
        diff = samples[:, i].astype(np.int64) - pred
        neg = diff < 0
        d = np.abs(diff)
        nib = np.zeros(s, np.int64)
        delta = step >> 3
        for val, bit in ((step, 4), (step >> 1, 2), (step >> 2, 1)):
            take = d >= val
            nib |= np.where(take, bit, 0)
            d = np.where(take, d - val, d)
            delta = np.where(take, delta + val, delta)
        pred = np.clip(pred + np.where(neg, -delta, delta), -32768, 32767)
        nib |= np.where(neg, 8, 0)
        idx = np.clip(idx + INDEX_TABLE[nib], 0, 88)
        out[:, i] = nib
    return out, np.stack([idx, pred], 1)
