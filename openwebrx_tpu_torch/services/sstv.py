"""SSTV decoder (Martin / Scottie / Robot families), host side.

Reference: ``SstvDemodulator`` + native ``SstvDecoder`` + ``owrx/sstv.py``
(binary line protocol → BMP → storage; mode/width/height announced from
the VIS header, reference owrx/sstv.py:65-226).  The device chain
(models/fax.py FaxChain with SSTV subcarrier parameters) delivers the
instantaneous frequency of the 1100–2300 Hz subcarrier; this module

  1. detects the VIS calibration header (1900 Hz leader → 1200 Hz start
     bit → 7 data bits LSB-first at 30 ms, 1100 Hz = 1 / 1300 Hz = 0 →
     even parity → stop bit) and announces the detected mode,
  2. slices sync-anchored lines per mode family (Martin GBR scans,
     Scottie's mid-line sync with R before the next line's G/B, Robot36
     4:2:0 YCrCb with alternating chroma lines), and
  3. assembles RGB rows via on_row(np.uint8 (width, 3)).

Frequencies: sync 1200 Hz, black 1500 Hz, white 2300 Hz.
"""

from __future__ import annotations

import numpy as np

from openwebrx_tpu_torch.models.secondary import IF_RATE

SSTV_CARRIER = 1700.0   # chain shifts this to 0
SSTV_DEV = 600.0        # ±600 ⇒ 1100..2300 Hz

# name: family geometry (ms timings), width/height, VIS code
MODES = {
    "martin_m1": {"family": "martin", "vis": 44, "width": 320, "height": 256,
                  "sync_ms": 4.862, "separator_ms": 0.572, "scan_ms": 146.432,
                  "order": "GBR"},
    "martin_m2": {"family": "martin", "vis": 40, "width": 320, "height": 256,
                  "sync_ms": 4.862, "separator_ms": 0.572, "scan_ms": 73.216,
                  "order": "GBR"},
    "scottie_s1": {"family": "scottie", "vis": 60, "width": 320, "height": 256,
                   "sync_ms": 9.0, "separator_ms": 1.5, "scan_ms": 138.24},
    "scottie_s2": {"family": "scottie", "vis": 56, "width": 320, "height": 256,
                   "sync_ms": 9.0, "separator_ms": 1.5, "scan_ms": 88.064},
    "robot36": {"family": "robot36", "vis": 8, "width": 320, "height": 240,
                "sync_ms": 9.0, "porch_ms": 3.0, "y_ms": 88.0,
                "sep_ms": 4.5, "chroma_porch_ms": 1.5, "chroma_ms": 44.0},
}

VIS_TO_MODE = {spec["vis"]: name for name, spec in MODES.items()}

VIS_BIT_MS = 30.0


class SstvDecoder:
    """Feed normalized-frequency samples (from the SSTV chain at
    sample_rate); emits RGB rows via on_row(np.uint8 (width, 3)).

    mode=None (the default) auto-detects the mode from the VIS header and
    calls on_mode(name, width, height) when found; an explicit mode skips
    the VIS wait (fixed-mode decode, the pre-r4 behavior)."""

    def __init__(self, mode: str | None = None, sample_rate: float = 3000.0,
                 on_row=None, on_mode=None):
        self.rate = sample_rate
        self.on_row = on_row
        self.on_mode = on_mode
        self.mode = None
        self.width = 0
        self.height = 0
        self._buf = np.empty(0, np.float32)
        self.rows: list[np.ndarray] = []
        self._pending_gb = None        # scottie: G/B of the next row
        self._robot_prev = None        # robot36: (y_row, chroma, is_red)
        self._auto = mode is None
        self._sync_misses = 0
        if mode is not None:
            self._set_mode(mode)
        else:
            self._spec = None

    def _set_mode(self, mode: str):
        spec = MODES[mode]
        self.mode = mode
        self._spec = spec
        self.width = spec["width"]
        self.height = spec["height"]
        ms = lambda v: v / 1000.0 * self.rate
        self.sync_len = int(ms(spec["sync_ms"]))
        fam = spec["family"]
        if fam in ("martin", "scottie"):
            self.sep_len = int(ms(spec["separator_ms"]))
            self.scan_len = ms(spec["scan_ms"])
            if fam == "martin":
                self.line_len = int(round(self.sync_len + 3 * self.sep_len +
                                          3 * self.scan_len))
            else:      # scottie: [sync][porch R][sep G][sep B] until next sync
                self.line_len = int(round(self.sync_len + 3 * self.sep_len +
                                          3 * self.scan_len))
        else:          # robot36: [sync][porch][Y][sep][porch][chroma]
            self.porch_len = int(ms(spec["porch_ms"]))
            self.y_len = ms(spec["y_ms"])
            self.sep_len = int(ms(spec["sep_ms"]))
            self.cporch_len = int(ms(spec["chroma_porch_ms"]))
            self.chroma_len = ms(spec["chroma_ms"])
            self.line_len = int(round(self.sync_len + self.porch_len +
                                      self.y_len + self.sep_len +
                                      self.cporch_len + self.chroma_len))
        if self.on_mode is not None:
            self.on_mode(self.mode, self.width, self.height)

    # frequency helpers: chain output is (f − carrier)/(IF_RATE/2)
    def _to_hz(self, x: np.ndarray) -> np.ndarray:
        return SSTV_CARRIER + x * (IF_RATE / 2)

    def feed(self, samples: np.ndarray):
        samples = np.asarray(samples)
        if np.iscomplexobj(samples):
            samples = samples.real
        self._buf = np.concatenate([self._buf, samples.astype(np.float32)])
        if self._spec is None:
            self._detect_vis()
        if self._spec is not None:
            self._consume()

    # ----------------------------------------------------------- VIS ----
    def _detect_vis(self):
        """Search the buffer for leader + VIS; on success set the mode and
        consume through the stop bit."""
        hz = self._to_hz(self._buf)
        bit = int(VIS_BIT_MS / 1000.0 * self.rate)
        leader_need = int(0.150 * self.rate)       # ≥150 ms of 1900 Hz
        if len(hz) < leader_need + 10 * bit:
            return
        is_leader = np.abs(hz - 1900.0) < 120.0
        is_start = np.abs(hz - 1200.0) < 120.0
        # candidate start-bit onsets: 1200 Hz window preceded by leader
        lead_score = np.convolve(is_leader.astype(np.float32),
                                 np.ones(leader_need), mode="valid")
        start_score = np.convolve(is_start.astype(np.float32),
                                  np.ones(bit), mode="valid")
        limit = len(hz) - 10 * bit
        for pos in np.flatnonzero(start_score > 0.8 * bit):
            if pos < leader_need or pos > limit:
                continue
            if lead_score[pos - leader_need] < 0.7 * leader_need:
                continue
            # sample the 8 bits (7 data + parity) at their centers
            bits = []
            for k in range(8):
                center = pos + bit + k * bit + bit // 2
                seg = hz[center - bit // 4: center + bit // 4]
                bits.append(1 if np.median(seg) < 1200.0 else 0)
            data = bits[:7]
            code = sum(b << i for i, b in enumerate(data))
            if sum(bits) % 2 != 0:          # even parity over 8 bits
                continue
            if code not in VIS_TO_MODE:
                continue
            # stop bit: 30 ms of 1200 Hz
            stop = hz[pos + 9 * bit: pos + 10 * bit]
            if np.mean(np.abs(stop - 1200.0) < 150.0) < 0.6:
                continue
            self._set_mode(VIS_TO_MODE[code])
            self._buf = self._buf[pos + 10 * bit:]
            return
        # keep a tail (leader + VIS worth) and drop the rest
        keep = leader_need + 12 * bit
        if len(self._buf) > 4 * keep:
            self._buf = self._buf[-2 * keep:]

    # ---------------------------------------------------------- lines ----
    def _find_sync(self, hz: np.ndarray) -> int | None:
        """Locate the end of a 1200 Hz sync pulse near the buffer start."""
        is_sync = hz < 1350.0
        kernel = np.ones(self.sync_len)
        score = np.convolve(is_sync.astype(np.float32), kernel, mode="valid")
        hits = np.flatnonzero(score > 0.8 * self.sync_len)
        if len(hits) == 0:
            return None
        return int(hits[0]) + self.sync_len

    def _consume(self):
        while True:
            if len(self._buf) < self.line_len + 2 * self.sync_len:
                return
            hz = self._to_hz(self._buf)
            start = self._find_sync(hz[: self.line_len + self.sync_len])
            if start is None:
                # no sync in a whole line: drop most of it and rescan.  In
                # auto mode, a run of missed syncs means the transmission
                # ended mid-frame — re-arm the VIS detector so the NEXT
                # image's header locks a fresh mode instead of its
                # start/stop bits decoding as garbage lines
                self._sync_misses += 1
                if self._auto and self._sync_misses >= 4:
                    self._spec = None
                    self.mode = None
                    self._pending_gb = None
                    self._robot_prev = None
                    self._sync_misses = 0
                    return
                self._buf = self._buf[self.line_len // 2:]
                continue
            self._sync_misses = 0
            if len(self._buf) < start + self.line_len:
                return
            line_hz = hz[start: start + self.line_len]
            fam = self._spec["family"]
            if fam == "martin":
                self._decode_martin(line_hz)
            elif fam == "scottie":
                self._decode_scottie(line_hz)
            else:
                self._decode_robot36(line_hz)
            self._buf = self._buf[start + self.line_len - self.sync_len:]

    def _scan_to_pixels(self, seg: np.ndarray) -> np.ndarray:
        idx = np.minimum((np.arange(self.width) * len(seg) / self.width
                          ).astype(int), len(seg) - 1)
        return np.clip((seg[idx] - 1500.0) / 800.0 * 255.0, 0, 255)

    def _emit(self, row: np.ndarray):
        row = row.astype(np.uint8)
        self.rows.append(row)
        if self.on_row is not None:
            self.on_row(row)

    def _decode_martin(self, line_hz: np.ndarray):
        """[sync] sep G sep B sep R (reference Martin family timing)."""
        pos = 0.0
        channels = {}
        for ch in self._spec["order"]:
            pos += self.sep_len
            seg = line_hz[int(pos): int(pos + self.scan_len)]
            pos += self.scan_len
            channels[ch] = self._scan_to_pixels(seg)
        self._emit(np.stack([channels["R"], channels["G"], channels["B"]],
                            axis=-1))

    def _decode_scottie(self, line_hz: np.ndarray):
        """Scottie's sync sits MID-line, before the red scan: anchored at
        a sync, the wire reads [porch R_n][sep G_{n+1}][sep B_{n+1}] — the
        red scan belongs to the row whose G/B arrived BEFORE this sync."""
        pos = 0.0
        segs = []
        for _ in range(3):
            pos += self.sep_len
            seg = line_hz[int(pos): int(pos + self.scan_len)]
            pos += self.scan_len
            segs.append(self._scan_to_pixels(seg))
        r, g_next, b_next = segs
        if self._pending_gb is not None:
            g, b = self._pending_gb
            self._emit(np.stack([r, g, b], axis=-1))
        self._pending_gb = (g_next, b_next)

    def _decode_robot36(self, line_hz: np.ndarray):
        """Robot 36: [sync][porch][Y 88 ms][sep][porch][chroma 44 ms]; even
        lines carry R−Y, odd lines B−Y (4:2:0 — each chroma pair covers two
        rows).  The separator tone distinguishes them: 1500 Hz before R−Y,
        2300 Hz before B−Y."""
        pos = self.porch_len
        y_seg = line_hz[int(pos): int(pos + self.y_len)]
        pos += self.y_len
        sep_seg = line_hz[int(pos): int(pos + self.sep_len)]
        pos += self.sep_len + self.cporch_len
        c_seg = line_hz[int(pos): int(pos + self.chroma_len)]
        y = self._scan_to_pixels(y_seg)
        c = self._scan_to_pixels(c_seg)
        is_red = bool(np.median(sep_seg) < 1900.0)   # 1500 ⇒ R−Y line
        if is_red:
            self._robot_prev = (y, c)
            return
        if self._robot_prev is None:
            return
        y0, cr = self._robot_prev
        cb = c
        self._robot_prev = None
        for yy in (y0, y):
            r = yy + 1.402 * (cr - 128.0)
            b = yy + 1.772 * (cb - 128.0)
            g = (yy - 0.299 * r - 0.114 * b) / 0.587
            self._emit(np.clip(np.stack([r, g, b], axis=-1), 0, 255))

    def image(self) -> np.ndarray | None:
        return np.stack(self.rows) if self.rows else None


def synthesize_vis(mode: str, fs: float) -> np.ndarray:
    """Instantaneous-frequency trace (Hz) of the calibration header + VIS
    for a mode — shared by tests and demo transmitters."""
    spec = MODES[mode]
    code = spec["vis"]
    bits = [(code >> i) & 1 for i in range(7)]
    bits.append(sum(bits) % 2)              # even parity
    def tone(freq, ms):
        return np.full(int(fs * ms / 1000.0), float(freq))
    parts = [tone(1900, 300), tone(1200, 10), tone(1900, 300),
             tone(1200, VIS_BIT_MS)]        # leader, break, leader, start
    for b in bits:
        parts.append(tone(1100 if b else 1300, VIS_BIT_MS))
    parts.append(tone(1200, VIS_BIT_MS))    # stop
    return np.concatenate(parts)
