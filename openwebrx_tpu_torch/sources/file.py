"""File replay + synthetic test sources.

The reference gets replay via connector binaries reading recordings; here
file replay is first-class (it is also the golden-test and benchmark
harness, SURVEY §4).  Supports complex64 ('cf32'), interleaved int16
('cs16') and unsigned 8-bit ('cu8', RTL-SDR style) raw captures, looped,
delivered in real time (or faster with throttle=False).
"""

from __future__ import annotations

import time

import numpy as np

from openwebrx_tpu_torch.ops.convert import complex_short_to_complex, uint8_iq_to_complex
from openwebrx_tpu_torch.sources.base import SdrSource


class FileSource(SdrSource):
    """props: file_path, file_format (cf32|cs16|cu8), samp_rate, throttle."""

    def _run_stream(self):
        path = self.props["file_path"]
        fmt = self.props.get("file_format", "cf32")
        throttle = bool(self.props.get("throttle", True))
        rate = self.get_sample_rate()
        block = self.block_size
        if block <= 0:
            raise ValueError("block_size not set before start")

        raw = np.fromfile(path, dtype={"cf32": np.complex64,
                                       "cs16": np.int16,
                                       "cu8": np.uint8}[fmt])
        if fmt == "cs16":
            iq = complex_short_to_complex(raw)
        elif fmt == "cu8":
            iq = uint8_iq_to_complex(raw)
        else:
            iq = raw.astype(np.complex64)
        if len(iq) < block:
            iq = np.tile(iq, int(np.ceil(block / max(len(iq), 1))))

        pos = 0
        block_seconds = block / rate
        next_deadline = time.monotonic()
        while not self._stop_requested:
            if pos + block <= len(iq):
                chunk = iq[pos: pos + block]
                pos += block
            else:
                head = iq[pos:]
                pos = block - len(head)
                chunk = np.concatenate([head, iq[:pos]])
            self._deliver(chunk)
            if throttle:
                next_deadline += block_seconds
                delay = next_deadline - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                else:
                    next_deadline = time.monotonic()


def _psk_waveform(sig: dict, rate: float) -> np.ndarray:
    """Looping BPSK31-style baseband waveform carrying sig['text']."""
    from openwebrx_tpu_torch.digimodes.psk import _VARICODE

    baud = float(sig.get("baud", 31.25))
    text = sig.get("text", "cq cq cq de openwebrx tpu ")
    bits = [0] * 16
    for ch in text:
        code = _VARICODE[ord(ch)] if ord(ch) < 128 else "1"
        bits.extend(int(b) for b in code)
        bits.extend([0, 0])
    bits.extend([0] * 16)
    phase = 1.0
    phases = []
    for b in bits:
        phase = phase * (1.0 if b else -1.0)
        phases.append(phase)
    sps = int(round(rate / baud))
    return np.repeat(np.asarray(phases, np.complex64), sps)


def _packet_waveform(sig: dict, rate: float) -> np.ndarray:
    """Looping FM-baseband waveform of an AFSK1200 AX.25 beacon (complex,
    at carrier offset 0 — the mixer applies the offset)."""
    from openwebrx_tpu_torch.digimodes.afsk import afsk_modulate, hdlc_frame

    def addr(call: str, last: bool) -> bytes:
        call, _, ssid = call.partition("-")
        raw = bytes((ord(c) << 1) for c in call.ljust(6))
        return raw + bytes([0x60 | (int(ssid or 0) << 1) | (1 if last else 0)])

    source = sig.get("source", "N0CALL-1")
    info = sig.get("info", "!4903.50N/07201.75W-test beacon").encode()
    frame = addr(sig.get("dest", "APRS"), False) + addr(source, True) \
        + b"\x03\xf0" + info
    nrzi = hdlc_frame(frame, flags=16)
    audio = afsk_modulate(np.asarray(nrzi, bool), rate, 1200, 1200, 2200)
    audio = np.concatenate([audio, np.zeros(int(rate * 0.3))])
    dev = float(sig.get("deviation", 3000.0))
    phase = 2 * np.pi * np.cumsum(dev * audio) / rate
    return np.exp(1j * phase).astype(np.complex64)


class SignalSource(SdrSource):
    """Synthetic multi-signal generator (tests/demos without hardware).

    props: signals = [{kind: nfm|am|usb|psk|packet|tone, offset_hz,
    f_audio, deviation, amplitude}], noise (float), samp_rate.
    """

    def _run_stream(self):
        rate = self.get_sample_rate()
        block = self.block_size
        throttle = bool(self.props.get("throttle", True))
        signals = self.props.get("signals", [])
        noise = float(self.props.get("noise", 1e-4))
        rng = np.random.default_rng(0)
        n0 = 0
        phases = [0.0] * len(signals)
        # precompute looping baseband waveforms for symbol-based kinds
        waveforms = {}
        for i, sig in enumerate(signals):
            if sig.get("kind") == "psk":
                waveforms[i] = _psk_waveform(sig, rate)
            elif sig.get("kind") == "packet":
                waveforms[i] = _packet_waveform(sig, rate)
        block_seconds = block / rate
        next_deadline = time.monotonic()
        while not self._stop_requested:
            n = n0 + np.arange(block)
            out = (rng.standard_normal(block) + 1j * rng.standard_normal(block)
                   ).astype(np.complex64) * noise
            for i, sig in enumerate(signals):
                kind = sig.get("kind", "tone")
                off = float(sig.get("offset_hz", 0.0))
                amp = float(sig.get("amplitude", 0.5))
                f_audio = float(sig.get("f_audio", 1000.0))
                if kind == "nfm":
                    dev = float(sig.get("deviation", 3000.0))
                    mod = np.sin(2 * np.pi * f_audio / rate * n)
                    phase_inc = 2 * np.pi * (off + dev * mod) / rate
                    ph = phases[i] + np.cumsum(phase_inc)
                    phases[i] = float(ph[-1] % (2 * np.pi))
                    out += (amp * np.exp(1j * ph)).astype(np.complex64)
                elif kind == "am":
                    depth = float(sig.get("depth", 0.6))
                    env = 1.0 + depth * np.sin(2 * np.pi * f_audio / rate * n)
                    out += (amp * env * np.exp(2j * np.pi * off / rate * n)
                            ).astype(np.complex64)
                elif kind == "usb":
                    out += (amp * np.exp(2j * np.pi * (off + f_audio) / rate * n)
                            ).astype(np.complex64)
                elif kind in ("psk", "packet"):
                    wf = waveforms[i]
                    idx = n % len(wf)
                    out += (amp * wf[idx] * np.exp(2j * np.pi * off / rate * n)
                            ).astype(np.complex64)
                else:  # tone
                    out += (amp * np.exp(2j * np.pi * off / rate * n)
                            ).astype(np.complex64)
            n0 += block
            self._deliver(out.astype(np.complex64))
            if throttle:
                next_deadline += block_seconds
                delay = next_deadline - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                else:
                    next_deadline = time.monotonic()
