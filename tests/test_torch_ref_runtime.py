"""The reference's own runtime and server tests that run the device path,
carried onto the port: tests/test_service_engine.py, test_passband.py and
test_connector.py.

Each reference file is one outer class here, named after it
(``test_service_engine.py`` → ``TestServiceEngine``), holding the
reference's classes and cases under their own names, with the reference's
inputs, assertions and bounds.  Only what the port's API forces differs:
``DeviceRuntime`` gets ``device=``, the server's runtimes run on
``SdrService.device``, and every module is the port's (the reference's
host modules, copied).  As in tests/test_torch_server.py, the port's
settings, users and caches live in a temporary data directory.
``WsTestClient`` is tests/test_server.py's.  Every case runs on ``device``
"cpu" (the plain versions) and "cuda" (the card; the ``cuda`` marker,
skipped without a card).  The file imports no jax and nothing of
``openwebrx_tpu``.

Reference cases left out, each because it runs no device code of the port
(tests/test_torch_ref_coverage.py keeps this list):

* test_connector.py ``test_connector_stream_and_control`` (2 cases) and
  ``test_connector_s16_wire_optin``: ``ConnectorSource`` over TCP and the
  host numpy helper ``host_as_complex64``; the source is a host module held
  to the reference by tests/test_torch_host_copy.py.
"""

import asyncio
import base64
import json
import os
import stat
import struct
import time

import numpy as np
import pytest

from openwebrx_tpu_torch.core.bands import Band, Bandplan
from openwebrx_tpu_torch.core.config import Config, CoreConfig
from openwebrx_tpu_torch.core.map import Map
from openwebrx_tpu_torch.core.metrics import Metrics
from openwebrx_tpu_torch.core.property import PropertyLayer
from openwebrx_tpu_torch.ops.adpcm import SYNC_INTERVAL, adpcm_decode_np
from openwebrx_tpu_torch.reporting import Reporter, ReportingEngine
from openwebrx_tpu_torch.runtime.device import DeviceRuntime
from openwebrx_tpu_torch.sdr import SdrService
from openwebrx_tpu_torch.services import engine as svc_engine
from openwebrx_tpu_torch.services import exec_modes
from openwebrx_tpu_torch.services.queue import DecoderQueue
from openwebrx_tpu_torch.services.wsjt import PROFILES, Ft8Profile
from openwebrx_tpu_torch.sources.file import SignalSource
from openwebrx_tpu_torch.web.http import HttpServer
from openwebrx_tpu_torch.web.server import build_router
from torch_ref_device import card_report, device  # noqa: F401  (fixtures)


@pytest.fixture(autouse=True)
def port_data_dir(tmp_path, monkeypatch):
    """The port's settings, users and caches in a temporary directory."""
    monkeypatch.setitem(CoreConfig.defaults, "data_directory", str(tmp_path))
    monkeypatch.setitem(CoreConfig.defaults, "temporary_directory", str(tmp_path))


# ---------------------------------------------------- tests/test_service_engine.py
@pytest.fixture()
def fake_env(tmp_path, monkeypatch):
    Config.reset()
    DecoderQueue.reset()
    ReportingEngine.reset()
    Map._instance = None
    config = Config.get()
    config["services_enabled"] = True
    config["services_decoders"] = ["ft8"]
    monkeypatch.setitem(CoreConfig.defaults, "temporary_directory", str(tmp_path))

    script = tmp_path / "fake_jt9"
    script.write_text("#!/bin/sh\n"
                      "echo '222100 -15 -0.0  508 ~  CQ EA7MJ IM66'\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)

    class FastFt8(Ft8Profile):
        interval = 1

        def decoder_commandline(self, file):
            return [str(script), file]

    monkeypatch.setitem(PROFILES, "ft8", FastFt8)
    # bandplan with one FT8 dial inside the test passband
    monkeypatch.setattr(Bandplan, "_instance", Bandplan(
        [Band("test", 14000000, 14350000, ["hamradio"], {"ft8": 14074000})]))
    yield tmp_path
    svc_engine.Services.stop()
    DecoderQueue.reset()
    ReportingEngine.reset()
    Config.reset()


@pytest.fixture()
def iq_env(tmp_path, monkeypatch):
    Config.reset()
    DecoderQueue.reset()
    ReportingEngine.reset()
    Map._instance = None
    config = Config.get()
    config["services_enabled"] = True
    config["services_decoders"] = ["ism"]

    script = tmp_path / "fake_rtl433"
    script.write_text(
        "#!/usr/bin/env python3\n"
        "import sys\n"
        "sys.stdin.buffer.read(4096)\n"
        "print('{\"model\": \"Fake-Sensor\", \"temperature_C\": 21.5}', flush=True)\n"
        "sys.stdin.buffer.read()\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)

    monkeypatch.setitem(exec_modes.IQ_EXEC_MODES, "ism", {
        "if_rate": 24000, "wire": "cs16", "requirement": "ism",
        "command": lambda rate, dial: [str(script)],
        "parser": "ism",
    })
    monkeypatch.setattr(Bandplan, "_instance", Bandplan(
        [Band("ism-test", 433000000, 434000000, [], {"ism": 433920000})]))
    yield
    svc_engine.Services.stop()
    DecoderQueue.reset()
    ReportingEngine.reset()
    Config.reset()


class TestServiceEngine:
    class TestServiceEngine:
        def test_ft8_service_spots(self, fake_env, device):
            props = PropertyLayer(
                samp_rate=240000, center_freq=14100000, throttle=False, noise=1e-4,
                signals=[{"kind": "usb", "offset_hz": -26000.0, "f_audio": 1000.0,
                          "amplitude": 0.4}])
            src = SignalSource("svc-test", props)
            rt = DeviceRuntime(src, capacity=4, target_seconds=0.1, device=device)
            spots = []

            class CaptureReporter(Reporter):
                def spot(self, spot):
                    spots.append(spot)

            ReportingEngine.shared().add(CaptureReporter())
            handler = svc_engine.ServiceHandler(rt)
            rt.start()
            try:
                deadline = time.time() + 20
                while not spots and time.time() < deadline:
                    time.sleep(0.25)
            finally:
                handler.shutdown()
                rt.stop()
                src.stop()
            assert handler.services == []  # stopped cleanly
            assert spots, "no spots reported"
            assert spots[0]["callsign"] == "EA7MJ"
            # the spot also landed on the map
            dump = Map.shared().full_dump()
            assert any(p["callsign"] == "EA7MJ" for p in dump)

    class TestIqExecService:
        def test_ism_service_events(self, iq_env, device):
            props = PropertyLayer(
                samp_rate=240000, center_freq=433900000, throttle=False, noise=1e-3,
                signals=[])
            src = SignalSource("ism-test", props)
            rt = DeviceRuntime(src, capacity=4, target_seconds=0.1, device=device)
            handler = svc_engine.ServiceHandler(rt)
            rt.start()
            try:
                deadline = time.time() + 20
                metric = None
                while time.time() < deadline:
                    metric = Metrics.shared().get("services.events.ISM")
                    if metric is not None and metric.get_value()["count"] > 0:
                        break
                    time.sleep(0.25)
                assert metric is not None and metric.get_value()["count"] > 0, \
                    "no ISM events counted"
            finally:
                handler.shutdown()
                rt.stop()
                src.stop()


# ----------------------------------------------------------- tests/test_passband.py
class WsTestClient:
    """Tiny RFC6455 client for protocol tests (tests/test_server.py's)."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer

    @classmethod
    async def connect(cls, port, path="/ws/"):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write((f"GET {path} HTTP/1.1\r\nHost: localhost\r\n"
                      "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        assert b"101" in head.split(b"\r\n")[0]
        return cls(reader, writer)

    async def send_text(self, text: str):
        await self._send(0x1, text.encode())

    async def _send(self, opcode, payload):
        mask = os.urandom(4)
        head = bytearray([0x80 | opcode])
        n = len(payload)
        if n < 126:
            head.append(0x80 | n)
        else:
            head.append(0x80 | 126)
            head += struct.pack(">H", n)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        self.writer.write(bytes(head) + mask + masked)
        await self.writer.drain()

    async def receive(self):
        while True:
            head = await self.reader.readexactly(2)
            opcode = head[0] & 0x0F
            length = head[1] & 0x7F
            if length == 126:
                length, = struct.unpack(">H", await self.reader.readexactly(2))
            elif length == 127:
                length, = struct.unpack(">Q", await self.reader.readexactly(8))
            payload = await self.reader.readexactly(length) if length else b""
            if opcode == 0x9:  # ping
                await self._send(0xA, payload)
                continue
            return opcode, payload

    async def expect_json(self, msg_type, timeout=10):
        async def _wait():
            while True:
                opcode, payload = await self.receive()
                if opcode == 0x1:
                    msg = json.loads(payload)
                    if msg.get("type") == msg_type:
                        return msg
        return await asyncio.wait_for(_wait(), timeout)

    async def collect_binary(self, prefix, count, timeout=30):
        frames = []

        async def _wait():
            while len(frames) < count:
                opcode, payload = await self.receive()
                if opcode == 0x2 and payload and payload[0] == prefix:
                    frames.append(payload[1:])
            return frames
        return await asyncio.wait_for(_wait(), timeout)

    async def close(self):
        self.writer.close()


@pytest.fixture()
def usb_tone_config(device):
    Config.reset()
    SdrService.device = device
    config = Config.get()
    config["sdrs"] = {
        "demo": {
            "name": "PB", "type": "signal",
            "samp_rate": 240000, "center_freq": 14100000,
            "throttle": False, "noise": 2e-4,
            # USB signal: tone lands at 1500 Hz audio
            "signals": [{"kind": "usb", "offset_hz": 14500.0,
                         "f_audio": 1500.0, "amplitude": 0.5}],
            "profiles": {"default": {
                "name": "PB", "center_freq": 14100000, "samp_rate": 240000,
                "start_freq": 14114500, "start_mod": "usb"}},
        }
    }
    yield config
    SdrService.stop_all()
    SdrService.device = "cuda"
    Config.reset()


def decode_wire(frames: list[bytes]) -> np.ndarray:
    """Decode 0x02 wire bytes (SYNC-framed IMA ADPCM) to int16 PCM."""
    data = b"".join(frames)
    out = []
    pos = 0
    state = (0, 0)
    while pos < len(data):
        if data[pos:pos + 4] == b"SYNC":
            idx, pred = np.frombuffer(data[pos + 4:pos + 8], "<i2")
            state = (int(pred), int(idx))
            pos += 8
        chunk = data[pos:pos + SYNC_INTERVAL]
        pos += len(chunk)
        pcm, state = adpcm_decode_np(chunk, state)
        out.append(pcm)
    return np.concatenate(out) if out else np.zeros(0, np.int16)


def tone_power_ratio(pcm: np.ndarray, f_tone: float, fs: float = 12000.0):
    """Power in ±60 Hz of f_tone relative to total, in dB."""
    x = pcm.astype(np.float32)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    band = (freqs > f_tone - 60) & (freqs < f_tone + 60)
    total = spec[(freqs > 50)].sum()
    return 10 * np.log10(spec[band].sum() / max(total, 1e-12) + 1e-12)


class TestPassband:
    @pytest.mark.usefixtures("usb_tone_config")
    class TestPassbandProtocol:
        def test_asymmetric_cuts_applied(self, device):
            asyncio.run(self._session())

        async def _session(self):
            SdrService.load()
            server = HttpServer(build_router(), port=0, host="127.0.0.1")
            await server.start()
            port = server._server.sockets[0].getsockname()[1]
            try:
                client = await WsTestClient.connect(port)
                await client.receive()
                await client.send_text("SERVER DE CLIENT client=t type=receiver")
                await client.expect_json("config")
                await client.send_text(json.dumps(
                    {"type": "dspcontrol", "action": "start"}))
                await client.send_text(json.dumps(
                    {"type": "dspcontrol",
                     "params": {"offset_freq": 14500, "mod": "usb",
                                "squelch_level": -150,
                                "low_cut": 0.0, "high_cut": 3000.0}}))
                # settle, then measure: tone at 1500 Hz inside the passband.
                # The channel's AGC re-normalizes whatever survives the
                # bandpass, so audio spectra can't see the cut on a clean
                # tone — the SQUELCH POWER (s-meter) taps the signal right
                # after the bandpass and shows it directly.
                await client.collect_binary(0x02, 3)
                pcm = decode_wire(await client.collect_binary(0x02, 4))
                assert tone_power_ratio(pcm, 1500.0) > -6.0, "tone missing"

                async def smeter_db(n=3):
                    vals = []
                    for _ in range(n):
                        msg = await client.expect_json("smeter", timeout=10)
                        vals.append(msg["value"])
                    return float(np.median(vals))

                open_db = await smeter_db()

                # drag the high cut below the tone: [0, 900] removes ~all of
                # the channel power (the tone was the only signal)
                await client.send_text(json.dumps(
                    {"type": "dspcontrol",
                     "params": {"low_cut": 0.0, "high_cut": 900.0}}))
                await client.collect_binary(0x02, 2)   # transient flush
                cut_db = await smeter_db()
                assert cut_db < open_db - 25.0, \
                    f"high_cut not applied: {open_db:.1f} → {cut_db:.1f} dB"

                # asymmetric window that still contains the tone: [1200, 3000]
                await client.send_text(json.dumps(
                    {"type": "dspcontrol",
                     "params": {"low_cut": 1200.0, "high_cut": 3000.0}}))
                await client.collect_binary(0x02, 2)
                back_db = await smeter_db()
                assert back_db > cut_db + 20.0, \
                    f"tone did not come back: {cut_db:.1f} → {back_db:.1f} dB"
                assert abs(back_db - open_db) < 6.0
                await client.close()
            finally:
                await server.stop()
                SdrService.stop_all()
