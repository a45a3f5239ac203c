"""Audio chopper: interval-aligned WAV recording + decode scheduling.

Reference: ``owrx/audio/chopper.py`` + ``owrx/audio/wav.py:17-133`` — the
demodulated 12 kHz SHORT audio is written to a master WAV per interval;
at each interval boundary (+1 s skew so files never miss the tail) the
file is closed, handed to the DecoderQueue with the profile's command
line, and decoder output lines go to the parser.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import wave
from datetime import datetime, timezone

from openwebrx_tpu_torch.services.queue import DecoderQueue, QueueJob
from openwebrx_tpu_torch.services.wsjt import WsjtParser, WsjtProfile

logger = logging.getLogger(__name__)

AUDIO_RATE = 12000


class WaveRecording:
    def __init__(self, tmp_dir: str, writer_id: str):
        self.timestamp = datetime.now(timezone.utc)
        self.filename = os.path.join(
            tmp_dir, f"openwebrx-chopper-{writer_id}-"
                     f"{self.timestamp.strftime('%y%m%d_%H%M%S')}.wav")
        self._wave = wave.open(self.filename, "wb")
        self._wave.setnchannels(1)
        self._wave.setsampwidth(2)
        self._wave.setframerate(AUDIO_RATE)

    def write(self, data: bytes):
        self._wave.writeframes(data)

    def close(self):
        self._wave.close()

    def unlink(self):
        try:
            os.unlink(self.filename)
        except OSError:
            pass


class AudioChopper:
    """Feed int16 audio bytes; files rotate at interval boundaries and are
    decoded through the queue.  on_spot(spot_dict) receives parsed decodes."""

    def __init__(self, profile, dial_freq: int, tmp_dir: str,
                 on_spot, writer_id: str | None = None, skew: float = 1.0):
        # one recording interval, one or more profiles decoding the same
        # file (reference groups profiles by interval and decodes the
        # master WAV once per profile — owrx/audio/chopper.py:45-56)
        self.profiles = list(profile) if isinstance(profile, (list, tuple)) \
            else [profile]
        assert len({p.interval for p in self.profiles}) == 1, \
            "profiles sharing a chopper must share the interval"
        self.profile = self.profiles[0]
        self.dial_freq = dial_freq
        self.tmp_dir = tmp_dir
        self.on_spot = on_spot
        self.skew = skew
        self.writer_id = writer_id or f"{id(self):x}"
        self.parsers = [p.make_parser() for p in self.profiles]
        self.parser = self.parsers[0]
        self._lock = threading.Lock()
        self._current: WaveRecording | None = None
        self._boundary = self._next_boundary()
        os.makedirs(tmp_dir, exist_ok=True)

    def _next_boundary(self) -> float:
        interval = self.profile.interval
        now = time.time()
        # boundaries at multiples of the interval, +skew so the decoder
        # never sees a file cut mid-transmission (reference: +1 s,
        # owrx/audio/chopper.py:63-71)
        return (now // interval + 1) * interval + self.skew

    def write(self, audio_bytes: bytes):
        with self._lock:
            if self._current is None:
                self._current = WaveRecording(self.tmp_dir, self.writer_id)
            self._current.write(audio_bytes)
            if time.time() >= self._boundary:
                self._rotate()

    def _rotate(self):
        recording, self._current = self._current, None
        self._boundary = self._next_boundary()
        if recording is None:
            return
        recording.close()
        dial = self.dial_freq
        remaining = [len(self.profiles)]

        def done():
            remaining[0] -= 1
            if remaining[0] <= 0:
                recording.unlink()

        for profile, parser in zip(self.profiles, self.parsers):
            def on_line(line: bytes, profile=profile, parser=parser):
                spot = parser.parse(profile, dial, line)
                if spot is not None:
                    self.on_spot(spot)

            job = QueueJob(profile.decoder_commandline(recording.filename),
                           recording.filename, on_line, on_done=done)
            DecoderQueue.shared().put(job)

    def close(self):
        with self._lock:
            if self._current is not None:
                self._current.close()
                self._current.unlink()
                self._current = None


class ChopperSecondary:
    """Interactive WSJT/JS8 listener: the client's dial gets a raw-audio
    service slot whose 12 kHz stream is chopped into interval WAVs and
    decoded through the shared queue; parsed spots go to on_spot (the
    connection forwards them to the panel and to map/reporting).

    Reference: AudioChopperDemodulator as a secondary demodulator
    (csdr/chain/digimodes.py:15, owrx/dsp.py:682-797).
    """

    def __init__(self, device, mode: str, offset_hz: float, on_spot,
                 tmp_dir: str | None = None):
        from openwebrx_tpu_torch.core.config import CoreConfig
        from openwebrx_tpu_torch.services.wsjt import enabled_profiles

        profiles = enabled_profiles(mode)
        if not profiles:
            raise KeyError(f"no decoder profiles for {mode}")
        self.device = device
        self.mode = mode
        self._center = device.source.get_center_freq()
        tmp = tmp_dir or CoreConfig.defaults["temporary_directory"]
        groups: dict[float, list] = {}
        for p in profiles:
            groups.setdefault(p.interval, []).append(p)
        self.choppers = [
            AudioChopper(group, int(self._center + offset_hz), tmp, on_spot)
            for group in groups.values()
        ]
        self.handle = device.open_channel("usb", offset_hz, service=True)
        self.handle.audio_cb = lambda wire, hd=False: [
            c.write(wire) for c in self.choppers]

    def set_offset(self, offset_hz: float):
        self.handle.set_offset(offset_hz)
        dial = int(self._center + offset_hz)
        for chopper in self.choppers:
            chopper.dial_freq = dial

    def set_carrier(self, carrier_hz: float):
        pass                     # decoders scan the whole audio passband

    def close(self):
        self.handle.close()
        for chopper in self.choppers:
            chopper.close()
