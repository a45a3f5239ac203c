"""Native selective-call (SELCALL) tone-sequence decoding.

Replaces ``multimon-ng -a ZVEI1 -a EEA -a CCIR`` (reference
MultimonDemodulator, ``csdr/chain/toolbox.py:60-100``): a Goertzel bank
over 10 ms hops detects the dominant tone, runs of stable tones become
digits, and completed sequences are emitted as multimon-style lines
(``ZVEI1: 12345``) for :class:`openwebrx_tpu_torch.services.toolbox.SelCallParser`.

Tone tables per ETSI/CCIR selective-call conventions; EEA and CCIR share
frequencies and are told apart by tone duration (40 ms vs 100 ms).
"""

from __future__ import annotations

import numpy as np

__all__ = ["SelCallDecoder", "selcall_modulate", "TONE_TABLES"]

_CCIR_FREQS = {
    "0": 1981, "1": 1124, "2": 1197, "3": 1275, "4": 1358, "5": 1446,
    "6": 1540, "7": 1640, "8": 1747, "9": 1860, "R": 1055,
}

TONE_TABLES = {
    "ZVEI1": ({
        "0": 2400, "1": 1060, "2": 1160, "3": 1270, "4": 1400, "5": 1530,
        "6": 1670, "7": 1830, "8": 2000, "9": 2200, "R": 2600,
    }, 0.070),
    "EEA": (_CCIR_FREQS, 0.040),
    "CCIR": (_CCIR_FREQS, 0.100),
}

HOP = 0.010                       # analysis hop/window (s)


class _ProtocolState:
    def __init__(self, name: str, table: dict, duration: float, hop: float):
        self.name = name
        self.freqs = table
        self.symbols = list(table.keys())
        self.min_hops = max(2, int(round(duration / hop * 0.6)))
        self.max_hops = max(3, int(round(duration / hop * 1.8)))
        self.gap_hops = max(3, int(round(duration / hop * 3)))
        self.reset()

    def reset(self):
        self.current: str | None = None
        self.run = 0
        self.digits: list[str] = []
        self.idle = 0

    def step(self, symbol: str | None) -> str | None:
        """One hop with the detected symbol (None = no tone). Returns a
        completed sequence line or None."""
        line = None
        if symbol == self.current and symbol is not None:
            self.run += 1
            self.idle = 0
            if self.run == self.min_hops:
                self._emit_symbol(symbol)
            elif self.run > self.max_hops and self.digits \
                    and self.digits[-1] != "…":
                # tone held far beyond a digit slot: treat as non-selcall
                self.digits.append("…")
            return None
        # symbol changed (or silence)
        if symbol is None:
            self.idle += 1
            if self.idle >= self.gap_hops and self.digits:
                line = self.render()
                self.reset()
        else:
            self.idle = 0
        self.current = symbol
        self.run = 1 if symbol is not None else 0
        return line

    def _emit_symbol(self, symbol: str):
        if symbol == "R":
            if self.digits:
                self.digits.append(self.digits[-1])
        else:
            self.digits.append(symbol)

    def render(self) -> str | None:
        digits = [d for d in self.digits if d != "…"]
        if len(digits) < 3 or "…" in self.digits:
            return None
        return f"{self.name}: {''.join(digits)}"


class SelCallDecoder:
    """Streaming decoder running all three protocol tables concurrently."""

    def __init__(self, rate: int = 12000, on_line=None,
                 protocols=("ZVEI1", "EEA", "CCIR")):
        self.rate = rate
        self.on_line = on_line
        self.hop = int(round(rate * HOP))
        self.states = [
            _ProtocolState(name, *TONE_TABLES[name], hop=HOP)
            for name in protocols
        ]
        # one shared Goertzel bank over the union of tone frequencies
        freqs = sorted({f for name in protocols
                        for f in TONE_TABLES[name][0].values()})
        self.bank = np.asarray(freqs, dtype=np.float64)
        k = np.arange(self.hop)
        self._osc = np.exp(-2j * np.pi * self.bank[:, None] * k / rate)
        self._window = np.hanning(self.hop)
        self._tail = np.zeros(0)

    def process(self, audio: np.ndarray) -> list[str]:
        x = np.concatenate([self._tail,
                            np.asarray(audio, dtype=np.float64)])
        n_hops = len(x) // self.hop
        self._tail = x[n_hops * self.hop:]
        lines: list[str] = []
        for h in range(n_hops):
            seg = x[h * self.hop: (h + 1) * self.hop] * self._window
            power = np.abs(self._osc @ seg) ** 2
            total = float(np.dot(seg, seg)) + 1e-12
            best = int(np.argmax(power))
            # dominant single tone: the winning bin must hold most of the
            # windowed energy (tone SNR gate)
            freq = self.bank[best] if power[best] > 0.12 * total * self.hop \
                else None
            for state in self.states:
                symbol = None
                if freq is not None:
                    for sym, f in state.freqs.items():
                        if abs(f - freq) < 1e-6:
                            symbol = sym
                            break
                line = state.step(symbol)
                if line:
                    lines.append(line)
        if self.on_line is not None:
            for line in lines:
                self.on_line(line)
        return lines

    def close(self):
        for state in self.states:
            line = state.render()
            if line and self.on_line is not None:
                self.on_line(line)
            state.reset()


def selcall_modulate(protocol: str, digits: str, rate: int = 12000,
                     amplitude: float = 0.7) -> np.ndarray:
    """Tone-sequence generator (test fixture): repeated digits become the
    repeat tone, as a transmitter would encode them."""
    table, duration = TONE_TABLES[protocol]
    n = int(round(rate * duration))
    t = np.arange(n) / rate
    out = [np.zeros(rate // 10)]
    prev = None
    for d in digits:
        sym = "R" if d == prev else d
        prev = d
        out.append(amplitude * np.sin(2 * np.pi * table[sym] * t))
    out.append(np.zeros(rate // 2))
    return np.concatenate(out)
