"""CW (Morse) decoder (host side).

Reference analog: CwDecoder (reference ``csdr/chain/digimodes.py:133``).
Device side delivers the keying envelope (magnitude at a modest rate);
this module thresholds adaptively, measures mark/space runs, classifies
dit/dah against a tracked dit length, and maps Morse to text.
"""

from __future__ import annotations

import numpy as np

MORSE = {
    ".-": "A", "-...": "B", "-.-.": "C", "-..": "D", ".": "E", "..-.": "F",
    "--.": "G", "....": "H", "..": "I", ".---": "J", "-.-": "K", ".-..": "L",
    "--": "M", "-.": "N", "---": "O", ".--.": "P", "--.-": "Q", ".-.": "R",
    "...": "S", "-": "T", "..-": "U", "...-": "V", ".--": "W", "-..-": "X",
    "-.--": "Y", "--..": "Z",
    "-----": "0", ".----": "1", "..---": "2", "...--": "3", "....-": "4",
    ".....": "5", "-....": "6", "--...": "7", "---..": "8", "----.": "9",
    ".-.-.-": ".", "--..--": ",", "..--..": "?", "-..-.": "/", "-...-": "=",
    ".--.-.": "@", "-.--.": "(", "-.--.-": ")", ".-.-.": "+", "-....-": "-",
}


class CwDecoder:
    """Streaming Morse decoder over envelope samples."""

    def __init__(self, env_rate: float, wpm_hint: float = 20.0):
        self.env_rate = env_rate
        self.dit = env_rate * 1.2 / wpm_hint  # samples per dit (PARIS timing)
        self.level = 0.0
        self._state = False
        self._run = 0
        self._symbol = ""
        self._text: list[str] = []
        self._idle = 0

    def decode(self, envelope: np.ndarray) -> str:
        out = []
        env = np.asarray(envelope, np.float32)
        # adaptive threshold: track a slow average of peaks
        peak = float(env.max()) if len(env) else 0.0
        self.level = max(0.9 * self.level, peak)
        thresh = self.level * 0.5
        keyed = env > max(thresh, 1e-6)
        for k in keyed:
            if k == self._state:
                self._run += 1
                if not k and self._run > 7 * self.dit and self._symbol:
                    out.append(self._flush(word_break=True))
                continue
            # transition: classify the completed run
            run, self._run, prev = self._run, 1, self._state
            self._state = bool(k)
            if prev:  # mark ended: dit or dah
                if run > 2 * self.dit:
                    self._symbol += "-"
                else:
                    self._symbol += "."
                    self.dit = 0.9 * self.dit + 0.1 * run  # track speed
            else:     # space ended
                if run > 2 * self.dit and self._symbol:
                    out.append(self._flush(word_break=run > 5 * self.dit))
        return "".join(out)

    def _flush(self, word_break: bool = False) -> str:
        ch = MORSE.get(self._symbol, "")
        self._symbol = ""
        return ch + (" " if word_break and ch else "")


class CwSkimmer:
    """Multi-signal CW skimmer over spectrogram frames (the host side of
    :class:`openwebrx_tpu_torch.models.secondary.CwSkimmerChain`; replaces the
    external csdr-cwskimmer binary, reference csdr/module/toolbox.py:62).

    frames: (n, bins) centered magnitudes.  Active bins (local maxima with
    sufficient SNR over the per-frame median noise floor) each get a
    streaming CwDecoder; results are (freq_offset_hz, text) pairs, with
    freq relative to the passband center.  Decoders idle out after
    ``idle_seconds`` without keying.
    """

    def __init__(self, bin_hz: float, env_rate: float,
                 max_decoders: int = 16, snr: float = 5.0,
                 idle_seconds: float = 15.0):
        self.bin_hz = float(bin_hz)
        self.env_rate = float(env_rate)
        self.max_decoders = max_decoders
        self.snr = snr
        self.idle_frames = idle_seconds * env_rate
        self.decoders: dict[int, list] = {}   # bin → [CwDecoder, idle]

    def process(self, frames: np.ndarray) -> list[tuple[float, str]]:
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 2 or frames.shape[0] == 0:
            return []
        n, bins = frames.shape
        # noise floor: per-frame median across bins, floored at a fraction
        # of the strongest signal so leakage sidelobes (Hann: −31 dB)
        # never register as signals on an otherwise quiet band
        gmax = float(frames.max()) + 1e-12
        floor = np.maximum(np.median(frames, axis=1, keepdims=True),
                           0.02 * gmax)
        snr = frames / floor
        peak = snr.max(axis=0)
        on_frames = (snr > self.snr).sum(axis=0)
        # candidates: local maxima above the SNR gate (≥ both neighbors)
        # that stay keyed for at least a dit-scale duration — key clicks
        # splatter single hot frames across the whole passband and must
        # not allocate decoders
        min_on = max(4, int(0.016 * self.env_rate))
        cand = np.flatnonzero(
            (peak > self.snr) & (on_frames >= min_on)
            & (peak >= np.roll(peak, 1)) & (peak >= np.roll(peak, -1)))
        for b in cand:
            b = int(b)
            if b in self.decoders:
                continue
            if len(self.decoders) >= self.max_decoders:
                break
            self.decoders[b] = [CwDecoder(self.env_rate), 0.0]
        out: list[tuple[float, str]] = []
        drop = []
        for b, slot in self.decoders.items():
            dec, idle = slot
            env = frames[:, b]
            text = dec.decode(env)
            slot[1] = 0.0 if peak[b] > self.snr else idle + n
            if slot[1] > self.idle_frames:
                drop.append(b)
                continue
            if text:
                out.append((self.freq_of(b, bins), text))
        for b in drop:
            del self.decoders[b]
        return out

    def freq_of(self, b: int, bins: int) -> float:
        return (b - bins // 2) * self.bin_hz
