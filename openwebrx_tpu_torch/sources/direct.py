"""Direct/exec sources: driver writes IQ to stdout, restart on retune.

Reference: ``owrx/source/direct.py:9-75`` — DirectSource devices
(fifi_sdr via an alsa ``arecord`` pipeline, perseussdr) have no control
socket; any relevant property change stops and restarts the subprocess.
The reference pipes stdout through ``nmux`` (a TCP ring-buffer
multiplexer, SURVEY §2.3-G) so several chains can read the same stream;
here that multiplexer is architecturally obsolete — the device runtime
fans a single block stream out to the shared waterfall and all channel
banks on device, so the subprocess's stdout feeds the block queue
directly.
"""

from __future__ import annotations

import logging
import shlex
import subprocess
import threading

import numpy as np

from openwebrx_tpu_torch.sources.base import SdrSource

logger = logging.getLogger(__name__)

_CONVERTERS = {
    # wire sample format → complex64 block
    "f32": lambda b: np.frombuffer(b, "<f4").astype(np.float32)
    .view(np.complex64),
    "s16": lambda b: (np.frombuffer(b, "<i2").astype(np.float32) / 32768.0)
    .view(np.complex64),
    "u8": lambda b: ((np.frombuffer(b, np.uint8).astype(np.float32) - 127.4)
                     / 128.0).view(np.complex64),
}
_ITEMSIZE = {"f32": 8, "s16": 4, "u8": 2}


class DirectSource(SdrSource):
    """props: command (template with {center_freq}/{samp_rate}/{rf_gain}),
    iq_format (f32/s16/u8), restart_keys."""

    RESTART_KEYS = ("center_freq", "samp_rate", "rf_gain", "device")

    def __init__(self, source_id, props):
        super().__init__(source_id, props)
        self._process: subprocess.Popen | None = None
        self._restart = threading.Event()
        restart_keys = tuple(self.props.get("restart_keys",
                                            self.RESTART_KEYS))
        # reference DirectSource: property change → subprocess restart
        # (owrx/source/direct.py:14-18)
        self.props.subscribe(lambda changes: self._restart.set()
                             if any(k in restart_keys for k in changes)
                             else None)

    def set_center_freq(self, freq: float):
        self.props["center_freq"] = freq

    def _build_command(self) -> str:
        template = self.props.get("command")
        if not template:
            from openwebrx_tpu_torch.sources.devices import build_command
            template = build_command(self.props.get("type", ""), self.props)
        if not template:
            raise ValueError(f"direct source {self.id} has no command")
        try:
            return template.format(**{k: self.props.get(k, "") for k in
                                      ("center_freq", "samp_rate", "rf_gain",
                                       "ppm", "device")})
        except (KeyError, IndexError):
            return template

    def _run_stream(self):
        fmt = self.props.get("iq_format", "s16")
        convert = _CONVERTERS[fmt]
        frame = _ITEMSIZE[fmt]
        want = max(self.block_size, 4096) * frame
        while not self._stop_requested:
            self._restart.clear()
            cmd = self._build_command()
            logger.info("starting direct source: %s", cmd)
            self._process = subprocess.Popen(
                cmd if isinstance(cmd, list) else shlex.split(cmd),
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
            try:
                self._pump(self._process.stdout, convert, want)
            finally:
                self._terminate()
            if self._stop_requested:
                return
            if not self._restart.is_set():
                # driver exited on its own → let the retry budget decide
                raise RuntimeError(f"direct source {self.id} driver exited")

    def _pump(self, pipe, convert, want: int):
        buf = b""
        while not self._stop_requested and not self._restart.is_set():
            chunk = pipe.read(want - len(buf))
            if not chunk:
                return
            buf += chunk
            if len(buf) < want:
                continue
            block = convert(buf)
            buf = b""
            n = self.block_size
            if n and len(block) >= n:
                for k in range(0, len(block) - n + 1, n):
                    self._deliver(block[k: k + n])

    def _terminate(self):
        proc, self._process = self._process, None
        if proc is None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=3)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    def stop(self):
        self._restart.clear()
        super().stop()
        self._terminate()
