"""Host-side fax image assembly from the FaxChain's frequency stream.

Reference: ``owrx/fax.py`` (line protocol from the native decoder, BMP
assembly, storage, ImageMagick PNG conversion).  Here the chain delivers
normalized frequency samples; this module converts to brightness, aligns
line phase via the phasing-pulse correlation, assembles rows, and writes a
PGM (plus PNG via ImageMagick when available — feature-gated like the
reference).
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess

import numpy as np

from openwebrx_tpu_torch.models.fax import DEVIATION_HZ, PIXEL_RATE
from openwebrx_tpu_torch.models.secondary import IF_RATE

logger = logging.getLogger(__name__)


class FaxDecoder:
    """Feed normalized-frequency samples; emits image rows via on_row
    (uint8 arrays) and finished files via on_complete(path)."""

    def __init__(self, lpm: float = 120.0, on_row=None, on_complete=None,
                 max_lines: int = 1500, tmp_dir: str = "/tmp"):
        self.samples_per_line = int(round(PIXEL_RATE * 60.0 / lpm))
        self.on_row = on_row
        self.on_complete = on_complete
        self.max_lines = max_lines
        self.tmp_dir = tmp_dir
        self._buf = np.empty(0, np.float32)
        self._rows: list[np.ndarray] = []
        self._phase_locked = False
        self._offset = 0

    def feed(self, samples: np.ndarray):
        samples = np.asarray(samples)
        if np.iscomplexobj(samples):  # chain routes through complex decimator
            samples = samples.real
        self._buf = np.concatenate([self._buf,
                                    samples.astype(np.float32)])
        if not self._phase_locked and len(self._buf) >= 4 * self.samples_per_line:
            self._lock_phase()
        if self._phase_locked:
            self._consume_lines()

    def _brightness(self, chunk: np.ndarray) -> np.ndarray:
        # normalized freq ∈ ±DEVIATION/(IF_RATE/2): −dev = black, +dev = white
        scale = DEVIATION_HZ / (IF_RATE / 2)
        return np.clip((chunk / scale + 1.0) * 127.5, 0, 255).astype(np.uint8)

    def _lock_phase(self):
        """WEFAX phasing lines: white with a ~5% black pulse at line start —
        find the black pulse position by folding brightness at the line
        period."""
        n = (len(self._buf) // self.samples_per_line) * self.samples_per_line
        folded = self._brightness(self._buf[:n]).reshape(-1, self.samples_per_line)
        profile = folded.mean(axis=0)
        # smooth with the expected pulse width and find the darkest spot
        pulse = max(3, int(0.025 * self.samples_per_line))
        kernel = np.ones(pulse) / pulse
        smoothed = np.convolve(profile, kernel, mode="same")
        # drop samples so every line starts at the black phasing pulse
        self._buf = self._buf[int(np.argmin(smoothed)):]
        self._phase_locked = True

    def _consume_lines(self):
        spl = self.samples_per_line
        while len(self._buf) >= spl:
            line, self._buf = self._buf[:spl], self._buf[spl:]
            row = self._brightness(line)
            self._rows.append(row)
            if self.on_row is not None:
                self.on_row(row)
            if len(self._rows) >= self.max_lines:
                self.finish()

    def finish(self) -> str | None:
        if not self._rows:
            return None
        img = np.stack(self._rows)
        self._rows = []
        path = os.path.join(self.tmp_dir, "fax.pgm")
        write_pgm(path, img)
        png = convert_to_png(path)
        if self.on_complete is not None:
            self.on_complete(png or path)
        return png or path


def write_pgm(path: str, img: np.ndarray):
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def convert_to_png(pgm_path: str) -> str | None:
    """BMP/PGM → PNG via ImageMagick, like the reference
    (owrx/storage.py:118-141); returns None if `convert` is unavailable."""
    if shutil.which("convert") is None:
        return None
    png_path = os.path.splitext(pgm_path)[0] + ".png"
    try:
        subprocess.run(["convert", pgm_path, png_path], check=True,
                       capture_output=True, timeout=60)
        return png_path
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
