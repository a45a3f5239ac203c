"""Native RDS (Radio Data System) decoding for WFM.

Replaces the external ``redsea`` dependency (reference RdsDemodulator,
``csdr/chain/toolbox.py:100-130``, and RdsParser ``owrx/toolbox.py:88``).
The device side of the split lives in
:class:`openwebrx_tpu_torch.models.stages.RdsTapStage`: inside the jitted WFM
bank program the 57 kHz subcarrier is mixed to baseband, low-passed and
decimated for every channel at once; this module takes that compact
complex baseband on host and recovers groups:

    BPSK carrier sync (z² phase estimate) → biphase matched filter →
    bit timing → differential decode → 26-bit block sync (CRC with
    offset words A/B/C/C'/D) → group parse (PI, PS, RadioText, PTY,
    TA/TP, clock time)

Events are redsea-style dicts consumed unchanged by
:class:`openwebrx_tpu_torch.services.toolbox.RdsParser`.

RDS spec: IEC 62106 — 1187.5 bps, differential + biphase coding,
g(x) = x¹⁰+x⁸+x⁷+x⁵+x⁴+x³+1, offsets A=0x0FC B=0x198 C=0x168
C'=0x350 D=0x1B4.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RdsDecoder", "RdsBitDecoder", "rds_checkword", "make_group",
           "rds_bitstream", "rds_modulate", "PTY_EU"]

BIT_RATE = 1187.5
GENERATOR = 0x5B9                       # degree-10
OFFSETS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "C'": 0x350, "D": 0x1B4}
SEQUENCE = ("A", "B", "C", "D")         # C' substitutes for C in B-version

PTY_EU = [
    "", "News", "Current affairs", "Information", "Sport", "Education",
    "Drama", "Culture", "Science", "Varied", "Pop music", "Rock music",
    "Easy listening", "Light classical", "Serious classical", "Other music",
    "Weather", "Finance", "Children's programmes", "Social affairs",
    "Religion", "Phone-in", "Travel", "Leisure", "Jazz music",
    "Country music", "National music", "Oldies music", "Folk music",
    "Documentary", "Alarm test", "Alarm",
]


def rds_checkword(info16: int) -> int:
    """10-bit CRC of a 16-bit information word (before offset XOR)."""
    rem = info16 << 10
    for shift in range(15, -1, -1):
        if rem & (1 << (shift + 10)):
            rem ^= GENERATOR << shift
    return rem & 0x3FF


def make_group(a: int, b: int, c: int, d: int,
               version_b: bool = False) -> list[int]:
    """Four 16-bit words → 104 transmitted bits (with offset checkwords)."""
    offsets = ["A", "B", "C'" if version_b else "C", "D"]
    bits: list[int] = []
    for info, off in zip((a, b, c, d), offsets):
        block = (info << 10) | (rds_checkword(info) ^ OFFSETS[off])
        bits.extend((block >> i) & 1 for i in range(25, -1, -1))
    return bits


# ---------------------------------------------------------------- physical

class RdsBitDecoder:
    """Complex 57 kHz baseband → data bits (carrier, symbol timing,
    differential decode).  Streaming with state carried across blocks."""

    def __init__(self, rate: float):
        self.rate = float(rate)
        self.spb = self.rate / BIT_RATE
        n = int(round(self.spb))
        half = self.spb / 2.0
        k = np.arange(n) + 0.5
        self._kernel = np.where(k < half, 1.0, -1.0)
        self._kernel[np.abs(k - half) < 0.5] = 0.0   # straddling tap
        self._tail = np.zeros(0, dtype=np.complex128)
        self._theta = 0.0
        self._pos = 0.0                 # next sampling instant (samples)
        self._last_level = 0
        self._have_phase = False

    def process(self, baseband: np.ndarray) -> list[int]:
        z = np.concatenate([self._tail,
                            np.asarray(baseband, dtype=np.complex128)])
        if z.shape[0] < 4 * self._kernel.shape[0]:
            self._tail = z
            return []
        # ---- carrier phase: BPSK ⇒ z² concentrates at angle 2θ
        power = np.mean(z * z)
        if np.abs(power) > 1e-12:
            theta = 0.5 * np.angle(power)
            if self._have_phase:
                # resolve the π ambiguity toward the previous estimate
                theta = min((theta, theta + np.pi, theta - np.pi),
                            key=lambda c: abs(c - self._theta))
                self._theta += 0.2 * (theta - self._theta)
            else:
                self._theta = theta
                self._have_phase = True
        v = np.real(z * np.exp(-1j * self._theta))
        # ---- biphase matched filter
        mf = np.convolve(v, self._kernel, mode="valid")
        usable = mf.shape[0]
        if usable < 2:
            self._tail = z
            return []
        # ---- timing: pick the fractional offset (within one bit) that
        # maximizes |mf| at bit-spaced samples, smoothed across blocks
        grid = np.arange(0.0, self.spb, self.spb / 8.0)
        best, best_score = self._pos % self.spb, -1.0
        for p0 in grid:
            idx = np.arange(p0, usable - 1, self.spb)
            score = float(np.sum(np.abs(mf[idx.astype(int)])))
            if score > best_score:
                best_score, best = score, p0
        # keep fractional continuity unless the new estimate is far off
        d = (self._pos - best) % self.spb
        pos = self._pos if min(d, self.spb - d) < self.spb / 4 else best
        bits: list[int] = []
        while pos < usable - 1:
            i = int(pos)
            frac = pos - i
            sample = mf[i] * (1 - frac) + mf[i + 1] * frac
            level = 1 if sample > 0 else 0
            bits.append(level ^ self._last_level)   # differential decode
            self._last_level = level
            pos += self.spb
        consumed = usable - 1
        self._pos = pos - consumed
        self._tail = z[consumed:]
        return bits


# ----------------------------------------------------------------- logical

class _GroupAssembler:
    """26-bit block sync + group state (PI/PS/RT/PTY/CT)."""

    def __init__(self, on_event):
        self.on_event = on_event
        self._bits = 0
        self._nbits = 0
        self._synced = False
        self._expect = 0                # index into SEQUENCE
        self._blocks: list[int] = []
        self._bad = 0
        self.pi: int | None = None
        self._ps = [" "] * 8
        self._ps_seen = 0
        self._rt = [" "] * 64
        self._rt_ab: int | None = None

    def feed(self, bits) -> None:
        for bit in bits:
            self._bits = ((self._bits << 1) | int(bit)) & 0x3FFFFFF
            self._nbits += 1
            if not self._synced:
                if self._nbits >= 26 and self._offset_of(self._bits) == "A":
                    self._synced = True
                    self._expect = 1
                    self._blocks = [self._bits >> 10]
                    self._nbits = 0
                continue
            if self._nbits < 26:
                continue
            self._nbits = 0
            block = self._bits
            want = SEQUENCE[self._expect]
            got = self._offset_of(block)
            ok = got == want or (want == "C" and got == "C'")
            if not ok:
                self._bad += 1
                if self._bad > 6:
                    self._synced = False
                    self._bad = 0
                    self._nbits = 26    # let the sliding search resume
                else:
                    # keep cadence, drop the group containing the bad block
                    self._expect = (self._expect + 1) % 4
                    if self._expect == 0:
                        self._blocks = []
                    else:
                        self._blocks.append(-1)
                continue
            self._bad = 0
            self._blocks.append(block >> 10
                                if got != "C'" else -(block >> 10) - 2)
            self._expect = (self._expect + 1) % 4
            if self._expect == 0:
                blocks, self._blocks = self._blocks, []
                if -1 not in blocks and len(blocks) == 4:
                    self._group(blocks)

    @staticmethod
    def _offset_of(block26: int) -> str | None:
        info, check = block26 >> 10, block26 & 0x3FF
        syndrome = rds_checkword(info) ^ check
        for name, off in OFFSETS.items():
            if syndrome == off:
                return name
        return None

    # -- group semantics --------------------------------------------------

    def _group(self, blocks):
        a, b, c, d = blocks
        version_b = c < 0
        if version_b:
            c = -c - 2
        if self.pi != a:
            self.pi = a
            self._ps = [" "] * 8
            self._ps_seen = 0
            self._rt = [" "] * 64
        event = {"pi": f"0x{a:04X}"}
        gtype = (b >> 12) & 0xF
        pty = (b >> 5) & 0x1F
        event["prog_type"] = PTY_EU[pty] if pty < len(PTY_EU) else str(pty)
        event["tp"] = bool((b >> 10) & 1)
        if gtype == 0:
            seg = b & 0x3
            event["ta"] = bool((b >> 4) & 1)
            self._ps[2 * seg] = chr((d >> 8) & 0x7F)
            self._ps[2 * seg + 1] = chr(d & 0x7F)
            self._ps_seen |= 1 << seg
            ps = "".join(self._ps)
            if self._ps_seen == 0xF:
                event["ps"] = ps.strip()
            else:
                event["partial_ps"] = ps
        elif gtype == 2:
            seg = b & 0xF
            ab = (b >> 4) & 1
            if self._rt_ab is not None and ab != self._rt_ab:
                self._rt = [" "] * 64
            self._rt_ab = ab
            chars = [] if version_b else [(c >> 8) & 0x7F, c & 0x7F]
            chars += [(d >> 8) & 0x7F, d & 0x7F]
            base = seg * (2 if version_b else 4)
            for i, code in enumerate(chars):
                if base + i < 64:
                    self._rt[base + i] = chr(code) if code >= 32 else "\r"
            text = "".join(self._rt)
            if "\r" in text:
                text = text[: text.index("\r")]
            event["radiotext"] = text.rstrip()
        elif gtype == 4 and not version_b:
            mjd = ((b & 0x3) << 15) | ((c >> 1) & 0x7FFF)
            hour = ((c & 1) << 4) | ((d >> 12) & 0xF)
            minute = (d >> 6) & 0x3F
            if mjd > 15079 and hour < 24 and minute < 60:
                yp = int((mjd - 15078.2) / 365.25)
                mp = int((mjd - 14956.1 - int(yp * 365.25)) / 30.6001)
                day = mjd - 14956 - int(yp * 365.25) - int(mp * 30.6001)
                k = 1 if mp in (14, 15) else 0
                year = 1900 + yp + k
                month = mp - 1 - k * 12
                event["clock_time"] = (f"{year:04d}-{month:02d}-{day:02d}T"
                                       f"{hour:02d}:{minute:02d}")
        self.on_event(event)


class RdsDecoder:
    """Complete host-side decoder: complex baseband blocks in, redsea-style
    event dicts out (``on_event``)."""

    def __init__(self, rate: float, on_event):
        self.bits = RdsBitDecoder(rate)
        self.groups = _GroupAssembler(on_event)

    def process(self, baseband: np.ndarray):
        self.groups.feed(self.bits.process(baseband))


# --------------------------------------------------------------- fixtures

def rds_bitstream(groups) -> np.ndarray:
    """[(a,b,c,d) or (a,b,c,d,version_b)] → transmitted bit array."""
    bits: list[int] = []
    for g in groups:
        bits.extend(make_group(*g))
    return np.asarray(bits, dtype=np.uint8)


def rds_modulate(groups, rate: float, level: float = 0.3,
                 theta: float = 0.4) -> np.ndarray:
    """Groups → real 57 kHz RDS subcarrier waveform at ``rate`` (test
    fixture / exciter): differential encode → biphase shape → DSB mix."""
    bits = rds_bitstream(groups)
    diff = np.zeros(len(bits), dtype=np.uint8)
    prev = 0
    for i, b in enumerate(bits):
        prev = b ^ prev
        diff[i] = prev
    spb = rate / BIT_RATE
    total = int(round(len(diff) * spb))
    t = np.arange(total)
    pos = (t / spb).astype(int).clip(max=len(diff) - 1)
    frac = (t / spb) - (t / spb).astype(int)
    symbol = np.where(diff[pos] > 0, 1.0, -1.0)
    shape = np.where(frac < 0.5, 1.0, -1.0)
    baseband = symbol * shape
    carrier = np.cos(2 * np.pi * 57000.0 * t / rate + theta)
    return (level * baseband * carrier).astype(np.float64)
