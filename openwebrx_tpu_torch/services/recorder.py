"""Audio recorder service: squelched MP3 recordings of a channel.

Reference: ``AudioRecorder`` chain (SnrSquelch → lame,
``csdr/chain/toolbox.py:177``) + the 'audio' ServiceOnlyMode.  A service
bank slot supplies raw s16 audio; recording starts when audio is present
(simple level gate standing in for the reference's SNR squelch — the bank
squelch already gates upstream) and stops after a hang time, piping
through lame into the shared storage.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import time
from datetime import datetime, timezone

import numpy as np

from openwebrx_tpu_torch.core.storage import Storage

logger = logging.getLogger(__name__)

AUDIO_RATE = 12000


class AudioRecorder:
    """feed(s16 bytes); writes MP3 (lame) or WAV fallback into Storage."""

    def __init__(self, name_prefix: str = "rec", squelch_level: float = 0.005,
                 hang_time: float = 1.0, storage: Storage | None = None):
        self.name_prefix = name_prefix
        self.squelch_level = squelch_level
        self.hang_time = hang_time
        self.storage = storage or Storage.shared()
        self._proc: subprocess.Popen | None = None
        self._last_audio = 0.0
        self._path: str | None = None

    def feed(self, audio_bytes: bytes):
        samples = np.frombuffer(audio_bytes, np.int16)
        level = float(np.abs(samples).mean()) / 32768.0
        now = time.time()
        if level > self.squelch_level:
            self._last_audio = now
            if self._proc is None:
                self._start()
        if self._proc is not None:
            try:
                self._proc.stdin.write(audio_bytes)
            except (BrokenPipeError, OSError):
                self._stop()
                return
            if now - self._last_audio > self.hang_time:
                self._stop()

    def _start(self):
        stamp = datetime.now(timezone.utc).strftime("%y%m%d_%H%M%S")
        if shutil.which("lame"):
            self._path = self.storage.new_file(f"{self.name_prefix}-{stamp}.mp3")
            cmd = ["lame", "-r", "-s", str(AUDIO_RATE / 1000.0), "--bitwidth",
                   "16", "--signed", "--little-endian", "-m", "m", "-",
                   self._path]
        else:
            # WAV fallback keeps recordings working without lame
            self._path = self.storage.new_file(f"{self.name_prefix}-{stamp}.wav")
            cmd = ["sh", "-c", f"cat > {self._path}"]
        logger.info("recording to %s", self._path)
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL)

    def _stop(self):
        proc, self._proc = self._proc, None
        if proc is not None:
            try:
                proc.stdin.close()
            except OSError:
                pass
            proc.wait(timeout=10)
            self.storage.cleanup()

    def close(self):
        self._stop()
