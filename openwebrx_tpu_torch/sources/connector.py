"""Connector-protocol source: external driver process + TCP IQ + control.

Speaks the owrx_connector protocol the reference devices use (reference
``owrx/source/connector.py:18-78`` and SURVEY §2.3-B): the driver serves
float32 IQ on one TCP port and accepts ``prop:value\\n`` control messages
(center_freq, rf_gain, ppm, …) on a second port, so retuning never
restarts the driver.  This class can either spawn the driver itself
(command template from the device description) or attach to an already
running one (rtl_tcp style).
"""

from __future__ import annotations

import logging
import shlex
import socket
import subprocess
import time

import numpy as np

from openwebrx_tpu_torch.sources.base import SdrSource, SdrSourceState

logger = logging.getLogger(__name__)

CONTROL_PROPS = ("center_freq", "rf_gain", "ppm", "if_gain", "bb_gain",
                 "antenna", "bias_tee", "direct_sampling")


class ConnectorSource(SdrSource):
    """props: command (template), host, port, control_port, samp_rate, …"""

    def __init__(self, source_id, props):
        super().__init__(source_id, props)
        self._process: subprocess.Popen | None = None
        self._control: socket.socket | None = None
        # live retune: forward property changes to the control socket
        # (reference ConnectorSource.onPropertyChange, connector.py:37-56)
        self.props.subscribe(self._forward_control)

    # -- control channel --------------------------------------------------
    def _forward_control(self, changes: dict):
        if self._control is None:
            return
        payload = "".join(f"{k}:{v}\n" for k, v in changes.items()
                          if k in CONTROL_PROPS)
        if not payload:
            return
        try:
            self._control.sendall(payload.encode())
        except OSError:
            logger.warning("control send failed for %s", self.id)

    def set_center_freq(self, freq: float):
        self.props["center_freq"] = freq

    # -- streaming --------------------------------------------------------
    def _spawn_driver(self):
        template = self.props.get("command")
        if not template:
            # derive from the device description (sources/devices.py)
            from openwebrx_tpu_torch.sources.devices import build_command
            template = build_command(self.props.get("type", ""), self.props)
        if not template:
            return
        try:
            cmd = template.format(**{k: self.props.get(k, "") for k in
                                     ("port", "control_port", "center_freq",
                                      "samp_rate", "rf_gain", "ppm", "device")})
        except (KeyError, IndexError):
            cmd = template
        logger.info("starting driver: %s", cmd)
        self._process = subprocess.Popen(shlex.split(cmd))

    def _connect(self, port, retries=40, interval=0.25) -> socket.socket:
        host = self.props.get("host", "127.0.0.1")
        last = None
        for _ in range(retries):
            if self._stop_requested:
                raise InterruptedError
            try:
                return socket.create_connection((host, int(port)), timeout=2)
            except OSError as e:
                last = e
                time.sleep(interval)
        raise ConnectionError(f"driver port {port} never came up: {last}")

    def _run_stream(self):
        self._spawn_driver()
        try:
            ctrl_port = self.props.get("control_port")
            host = self.props.get("host", "127.0.0.1")
            port = int(self.props.get("port", 4950))
            if ctrl_port:
                self._control = self._connect(ctrl_port)
            from openwebrx_tpu_torch import native
            if native.available() and not self.props.get("force_python_ingest"):
                self._run_native(host, port)
            else:
                self._run_python(host, port)
        finally:
            self._teardown()

    def _run_native(self, host: str, port: int):
        """Native ring-buffered ingest (native/iq_ingest.cpp): the socket is
        drained off-GIL; we pull fixed blocks for the device runtime."""
        from openwebrx_tpu_torch import native
        fmt = {"f32": native.FORMAT_F32, "s16": native.FORMAT_S16,
               "u8": native.FORMAT_U8}[self.props.get("iq_format", "f32")]
        ingest = native.IqIngest(max(self.block_size * 8, 1 << 22))
        last = None
        for _ in range(40):
            if self._stop_requested:
                return
            try:
                ingest.connect(host, port, fmt)
                break
            except ConnectionError as e:
                last = e
                time.sleep(0.25)
        else:
            raise ConnectionError(f"driver port {port} never came up: {last}")
        # packed (n, 2) int16 / uint8 wire samples halve / quarter the
        # host→device transfer bytes (the jit boundary converts to float
        # on the accelerator, runtime/chain.py _unpack_leaf) — LOSSLESS
        # for s16/u8-native SDRs.  u8-native drivers (rtl-sdr) ride the
        # 2-byte wire; f32 drivers (decimated output can exceed 16
        # effective bits) keep the full-precision float path unless the
        # deployment explicitly opts in with iq_wire='s16'/'u8'
        # (ADVICE r3: don't silently quantize).
        wire_fmt = self.props.get("iq_format", "f32")
        iq_wire = self.props.get("iq_wire")
        u8_ok = wire_fmt == "u8" or iq_wire == "u8"
        packed_ok = wire_fmt in ("s16", "u8") or iq_wire == "s16"
        try:
            while not self._stop_requested:
                if u8_ok:
                    block = ingest.read_block_packed_u8(self.block_size,
                                                        timeout=2.0)
                elif packed_ok:
                    block = ingest.read_block_packed(self.block_size,
                                                     timeout=2.0)
                else:
                    block = ingest.read_block(self.block_size, timeout=2.0)
                if block is None:
                    if ingest.eof:
                        raise ConnectionError("driver closed IQ stream")
                    continue
                self._deliver(block)
        finally:
            ingest.close()

    def _run_python(self, host: str, port: int):
        data_sock = self._connect(port)
        buf = bytearray()
        want = self.block_size * 8  # complex64
        data_sock.settimeout(2.0)
        try:
            while not self._stop_requested:
                try:
                    chunk = data_sock.recv(1 << 18)
                except socket.timeout:
                    continue
                if not chunk:
                    raise ConnectionError("driver closed IQ stream")
                buf += chunk
                while len(buf) >= want:
                    block = np.frombuffer(bytes(buf[:want]), dtype=np.complex64)
                    del buf[:want]
                    self._deliver(block)
        finally:
            data_sock.close()

    def _teardown(self):
        if self._control is not None:
            try:
                self._control.close()
            except OSError:
                pass
            self._control = None
        if self._process is not None:
            self._process.terminate()
            try:
                self._process.wait(timeout=3)
            except subprocess.TimeoutExpired:
                self._process.kill()
            self._process = None
