"""The reference's own server protocol tests, carried onto the port:
tests/test_server.py.

The reference file is one outer class here, ``TestServer``, holding its
classes and cases under their own names, with its sources, messages,
assertions and bounds: the port's server is booted on a synthetic source,
a real WebSocket client completes the reference handshake, and the JSON
messages, the waterfall (0x01) and ADPCM audio (0x02) frames, PSK31 text,
APRS, FT8 spots and ISM events are read over the protocol.  Only what the
port forces differs:

* the server's runtimes run on ``SdrService.device``, set to the case's
  device and restored after it, and every module is the port's (the
  reference's host modules, copied); the port's settings, users and caches
  live in a temporary data directory;
* on the CPU, the scenes that read no waterfall take float rows
  (``fft_compression: none``): there the waterfall's row encoder is its
  plain per-nibble loop, about 1 s a 4096-bin row, which would hold the
  block loop to about a row a second.  On the card every scene keeps the
  reference's compressed waterfall;
* every wait on the protocol has the safety net ``WAIT_S`` where the
  reference's is 10 to 90 s: a case ends when its message arrives, and the
  plain versions on a loaded CPU run slower than its compiled programs.

``WsTestClient`` is the reference's, shared from tests/torch_ref_helpers.py.
Every case runs on ``device`` "cpu" (the plain versions) and "cuda" (the
card; the ``cuda`` marker, skipped without a card).  The file imports no
jax and nothing of ``openwebrx_tpu``.
"""

import asyncio
import json
import stat
import sys

import numpy as np
import pytest

from openwebrx_tpu_torch.core.clients import ClientRegistry
from openwebrx_tpu_torch.core.config import Config, CoreConfig
from openwebrx_tpu_torch.core.map import Map
from openwebrx_tpu_torch.ops.adpcm import COMPRESS_FFT_PAD_N, adpcm_decode_np
from openwebrx_tpu_torch.sdr import SdrService
from openwebrx_tpu_torch.services import exec_modes
from openwebrx_tpu_torch.services import wsjt as wsjt_mod
from openwebrx_tpu_torch.services.queue import DecoderQueue
from openwebrx_tpu_torch.services.wsjt import Ft8Profile
from openwebrx_tpu_torch.web.http import HttpServer
from openwebrx_tpu_torch.web.server import build_router
from torch_ref_device import card_report, device  # noqa: F401  (fixtures)
from torch_ref_helpers import WsTestClient

WAIT_S = 300


@pytest.fixture(autouse=True)
def port_server(device, tmp_path, monkeypatch):
    """The port's settings, users and caches in a temporary directory; the
    server's runtimes on the case's device."""
    monkeypatch.setitem(CoreConfig.defaults, "data_directory", str(tmp_path))
    monkeypatch.setitem(CoreConfig.defaults, "temporary_directory", str(tmp_path))
    monkeypatch.setattr(SdrService, "device", device)


def _float_rows_on_cpu(device):
    """Float waterfall rows on the CPU (see the module docstring)."""
    if device == "cpu":
        Config.get()["fft_compression"] = "none"


@pytest.fixture()
def demo_config(tmp_path):
    Config.reset()
    config = Config.get()
    config["sdrs"] = {
        "demo": {
            "name": "Test Demo", "type": "signal",
            "samp_rate": 240000, "center_freq": 145000000,
            "throttle": False, "noise": 1e-4,
            "signals": [
                {"kind": "nfm", "offset_hz": 14500.0, "f_audio": 1000.0,
                 "amplitude": 0.5},
            ],
            "profiles": {
                "default": {"name": "Demo", "center_freq": 145000000,
                            "samp_rate": 240000, "start_freq": 145014500,
                            "start_mod": "nfm"},
            },
        }
    }
    yield config
    SdrService.stop_all()
    Config.reset()


class TestServer:
    @pytest.mark.usefixtures("demo_config")
    class TestServerEndToEnd:
        def test_full_session(self, device):
            asyncio.run(self._session())

        async def _session(self):
            SdrService.load()
            server = HttpServer(build_router(), port=0, host="127.0.0.1")
            await server.start()
            port = server._server.sockets[0].getsockname()[1]

            def mark(s):
                # progress marks surface in pytest output on hang/failure
                print("STEP:", s, file=sys.stderr, flush=True)
            try:
                client = await WsTestClient.connect(port)
                opcode, payload = await client.receive()
                assert payload.decode().startswith("CLIENT DE SERVER")
                await client.send_text("SERVER DE CLIENT client=test type=receiver")

                mark("handshake")
                details = await client.expect_json("receiver_details", timeout=WAIT_S)
                assert "receiver_name" in details["value"]
                modes = await client.expect_json("modes", timeout=WAIT_S)
                mods = [m["modulation"] for m in modes["value"]]
                assert {"nfm", "am", "usb", "lsb", "cw", "sam", "wfm"} <= set(mods)
                profiles = await client.expect_json("profiles", timeout=WAIT_S)
                assert profiles["value"][0]["id"] == "demo|default"
                mark("got modes+profiles")
                config = await client.expect_json("config", timeout=WAIT_S)
                assert config["value"]["samp_rate"] == 240000
                assert config["value"]["center_freq"] == 145000000

                await client.send_text(json.dumps(
                    {"type": "dspcontrol", "action": "start"}))
                await client.send_text(json.dumps(
                    {"type": "dspcontrol",
                     "params": {"offset_freq": 14500, "squelch_level": -150}}))

                mark("start sent")
                # binary waterfall + audio + smeter must flow
                fft_frames = await client.collect_binary(0x01, 3, timeout=WAIT_S)
                assert all(len(f) > 1000 for f in fft_frames)
                mark("fft collected")
                audio = await client.collect_binary(0x02, 2, timeout=WAIT_S)
                # SYNC headers recur every 1001 data bytes — not per frame
                assert b"SYNC" in b"".join(audio)
                mark("audio collected")
                smeter = await client.expect_json("smeter", timeout=WAIT_S)
                assert isinstance(smeter["value"], float)

                mark("smeter ok")
                # decode one ADPCM-compressed FFT row and find the tone
                row_i16, _ = adpcm_decode_np(bytes(fft_frames[-1]))
                row = row_i16[COMPRESS_FFT_PAD_N:].astype(np.float32) / 100
                assert len(row) >= 4096
                peak = int(np.argmax(row[:4096]))
                expected = 2048 + round(14500 / 240000 * 4096)
                # FM deviation 3 kHz spreads the carrier ±51 bins at this rate
                assert abs(peak - expected) <= 60

                mark("peak ok")
                # live mode switch via dspcontrol params
                await client.send_text(json.dumps(
                    {"type": "dspcontrol", "params": {"mod": "am"}}))
                audio2 = await client.collect_binary(0x02, 2, timeout=WAIT_S)
                assert audio2
                mark("all ok")
                await client.close()
            finally:
                await server.stop()
                SdrService.stop_all()

    @pytest.mark.usefixtures("demo_config")
    class TestSecondaryDemod:
        def test_psk31_text_over_protocol(self, device):
            asyncio.run(self._session(device))

        async def _session(self, device):
            # add a PSK31 signal to the demo source config
            cfg = Config.get()
            sdrs = dict(cfg["sdrs"])
            sdrs["demo"]["signals"].append(
                {"kind": "psk", "offset_hz": -60000.0, "amplitude": 0.5,
                 "text": "cq de tpu "})
            cfg["sdrs"] = sdrs
            _float_rows_on_cpu(device)
            SdrService.load()
            server = HttpServer(build_router(), port=0, host="127.0.0.1")
            await server.start()
            port = server._server.sockets[0].getsockname()[1]
            try:
                client = await WsTestClient.connect(port)
                await client.receive()  # CLIENT DE SERVER
                await client.send_text("SERVER DE CLIENT client=test type=receiver")
                await client.expect_json("config", timeout=WAIT_S)
                await client.send_text(json.dumps(
                    {"type": "dspcontrol", "action": "start"}))
                await client.send_text(json.dumps(
                    {"type": "dspcontrol",
                     "params": {"offset_freq": -60000, "mod": "bpsk31"}}))
                await client.expect_json("secondary_config", timeout=WAIT_S)
                # collect decoded text until the message appears
                text = ""

                async def gather():
                    nonlocal text
                    while "cq de tpu" not in text:
                        msg = await client.expect_json("secondary_demod", timeout=WAIT_S)
                        text += msg["value"]
                await asyncio.wait_for(gather(), WAIT_S)
                assert "cq de tpu" in text
                await client.close()
            finally:
                await server.stop()
                SdrService.stop_all()

    @pytest.mark.usefixtures("demo_config")
    class TestChatAndClients:
        def test_chat_broadcast_between_clients(self, device):
            asyncio.run(self._session(device))

        async def _session(self, device):
            ClientRegistry.reset()
            _float_rows_on_cpu(device)
            SdrService.load()
            server = HttpServer(build_router(), port=0, host="127.0.0.1")
            await server.start()
            port = server._server.sockets[0].getsockname()[1]
            try:
                a = await WsTestClient.connect(port)
                b = await WsTestClient.connect(port)
                for c in (a, b):
                    await c.receive()
                    await c.send_text("SERVER DE CLIENT client=test type=receiver")
                    await c.expect_json("config", timeout=WAIT_S)
                # both see the listener count reach 2
                await a.expect_json("clients", timeout=WAIT_S)
                await a.send_text(json.dumps(
                    {"type": "sendmessage", "text": "hello all", "name": "op"}))
                msg = await b.expect_json("chat_message", timeout=WAIT_S)
                assert msg["text"] == "hello all" and msg["name"] == "op"
                msg_a = await a.expect_json("chat_message", timeout=WAIT_S)
                assert msg_a["text"] == "hello all"
                await a.close()
                await b.close()
            finally:
                await server.stop()
                SdrService.stop_all()
                ClientRegistry.reset()

    class TestPacketModeOverProtocol:
        """Interactive packet listening: NFM bank slot → native AFSK/HDLC →
        APRS events on the secondary_demod stream (no direwolf binary)."""

        def test_aprs_beacon_decoded(self, device):
            asyncio.run(self._session(device))

        async def _session(self, device):
            Config.reset()
            cfg = Config.get()
            cfg["sdrs"] = {
                "demo": {
                    "name": "Packet Demo", "type": "signal",
                    "samp_rate": 240000, "center_freq": 144800000,
                    "throttle": False, "noise": 1e-4,
                    "signals": [
                        {"kind": "packet", "offset_hz": 14500.0,
                         "amplitude": 0.5, "source": "W1TST-9",
                         "info": "!4903.50N/07201.75W-protocol test"},
                    ],
                    "profiles": {
                        "default": {"name": "Demo", "center_freq": 144800000,
                                    "samp_rate": 240000,
                                    "start_freq": 144814500,
                                    "start_mod": "nfm"},
                    },
                }
            }
            _float_rows_on_cpu(device)
            SdrService.load()
            server = HttpServer(build_router(), port=0, host="127.0.0.1")
            await server.start()
            port = server._server.sockets[0].getsockname()[1]
            try:
                client = await WsTestClient.connect(port)
                await client.receive()
                await client.send_text("SERVER DE CLIENT client=test type=receiver")
                await client.expect_json("config", timeout=WAIT_S)
                await client.send_text(json.dumps(
                    {"type": "dspcontrol", "action": "start"}))
                await client.send_text(json.dumps(
                    {"type": "dspcontrol",
                     "params": {"offset_freq": 14500, "mod": "packet"}}))
                text = ""

                async def gather():
                    nonlocal text
                    while "W1TST-9" not in text:
                        msg = await client.expect_json("secondary_demod", timeout=WAIT_S)
                        text += msg["value"]
                await asyncio.wait_for(gather(), WAIT_S)
                event = json.loads([line for line in text.splitlines()
                                    if "W1TST-9" in line][0])
                assert event["mode"] == "APRS"
                assert event["source"] == "W1TST-9"
                assert abs(event.get("lat", 0) - 49.0583) < 0.01
                # switching back to the underlying analog mode must detach the
                # decoder and resume bank audio (the effective-mode check, not
                # handle.mode, gates the switch)
                await client.send_text(json.dumps(
                    {"type": "dspcontrol",
                     "params": {"offset_freq": 14500, "mod": "nfm"}}))
                audio = await client.collect_binary(0x02, 3, timeout=WAIT_S)
                assert len(audio) == 3
                await client.close()
            finally:
                await server.stop()
                SdrService.stop_all()
                Config.reset()

    class TestInteractiveFt8:
        """Interactive chopper listener: secondary_mod=ft8 attaches an interval
        chopper on the client's dial; decoder-queue spots stream to the panel
        as JSON and reach the map."""

        def test_ft8_spots_over_protocol(self, device, tmp_path, monkeypatch):
            script = tmp_path / "fake_jt9"
            script.write_text(
                "#!/bin/sh\n"
                "echo '222100 -15 -0.0  508 ~  CQ EA7MJ IM66'\n"
                "echo '<DecodeFinished>  0  1'\n")
            script.chmod(script.stat().st_mode | stat.S_IEXEC)

            class FastProfile(Ft8Profile):
                interval = 1

                def decoder_commandline(self, file):
                    return [str(script), file]

            monkeypatch.setattr(wsjt_mod, "enabled_profiles",
                                lambda mode: [FastProfile()] if mode == "ft8" else [])
            asyncio.run(self._session(device))

        async def _session(self, device):
            Config.reset()
            cfg = Config.get()
            cfg["sdrs"] = {
                "demo": {
                    "name": "FT8 Demo", "type": "signal",
                    "samp_rate": 240000, "center_freq": 14074000,
                    "throttle": False, "noise": 1e-4,
                    "signals": [
                        {"kind": "usb", "offset_hz": 0.0, "f_audio": 800.0,
                         "amplitude": 0.3},
                    ],
                    "profiles": {
                        "default": {"name": "Demo", "center_freq": 14074000,
                                    "samp_rate": 240000, "start_freq": 14074000,
                                    "start_mod": "usb"},
                    },
                }
            }
            _float_rows_on_cpu(device)
            DecoderQueue.reset()
            SdrService.load()
            server = HttpServer(build_router(), port=0, host="127.0.0.1")
            await server.start()
            port = server._server.sockets[0].getsockname()[1]
            try:
                client = await WsTestClient.connect(port)
                await client.receive()
                await client.send_text("SERVER DE CLIENT client=test type=receiver")
                await client.expect_json("config", timeout=WAIT_S)
                await client.send_text(json.dumps(
                    {"type": "dspcontrol", "action": "start"}))
                await client.send_text(json.dumps(
                    {"type": "dspcontrol",
                     "params": {"mod": "usb", "secondary_mod": "ft8",
                                "offset_freq": 0}}))
                await client.expect_json("secondary_config", timeout=WAIT_S)
                text = ""

                async def gather():
                    nonlocal text
                    while "EA7MJ" not in text:
                        msg = await client.expect_json("secondary_demod", timeout=WAIT_S)
                        text += msg["value"]
                await asyncio.wait_for(gather(), WAIT_S)
                spot = json.loads([line for line in text.splitlines()
                                   if "EA7MJ" in line][0])
                assert spot["callsign"] == "EA7MJ"
                assert spot["locator"] == "IM66"
                assert spot["mode"] == "FT8"
                assert spot["freq"] == 14074508
                # the spot also lands on the shared map (report_spot runs in
                # the decoder-queue worker right after the panel push — poll)
                for _ in range(100):
                    if "EA7MJ" in Map.shared().positions:
                        break
                    await asyncio.sleep(0.05)
                assert "EA7MJ" in Map.shared().positions
                # detach cleanly
                await client.send_text(json.dumps(
                    {"type": "dspcontrol", "params": {"secondary_mod": ""}}))
                await client.close()
            finally:
                await server.stop()
                SdrService.stop_all()
                DecoderQueue.reset()
                Config.reset()

    class TestInteractiveIqExec:
        """Interactive IQ-exec mode (ISM): complex-IF tap feeds the external
        decoder's stdin; its JSON events stream to the panel."""

        def test_ism_events_over_protocol(self, device, tmp_path, monkeypatch):
            script = tmp_path / "fake_rtl433"
            script.write_text(
                "#!/bin/sh\n"
                "head -c 4096 > /dev/null\n"           # consume some IQ
                'echo \'{"model":"Acurite-Tower","id":1234,"temperature_C":21.5}\'\n'
                "cat > /dev/null\n")
            script.chmod(script.stat().st_mode | stat.S_IEXEC)

            spec = dict(exec_modes.IQ_EXEC_MODES["ism"])
            spec["command"] = lambda rate, dial: [str(script)]
            monkeypatch.setitem(exec_modes.IQ_EXEC_MODES, "ism", spec)
            asyncio.run(self._session(device))

        async def _session(self, device):
            Config.reset()
            cfg = Config.get()
            cfg["sdrs"] = {
                "demo": {
                    "name": "ISM Demo", "type": "signal",
                    "samp_rate": 1200000, "center_freq": 433920000,
                    "throttle": False, "noise": 1e-3,
                    "signals": [],
                    "profiles": {
                        "default": {"name": "Demo", "center_freq": 433920000,
                                    "samp_rate": 1200000,
                                    "start_freq": 433920000,
                                    "start_mod": "nfm"},
                    },
                }
            }
            _float_rows_on_cpu(device)
            SdrService.load()
            server = HttpServer(build_router(), port=0, host="127.0.0.1")
            await server.start()
            port = server._server.sockets[0].getsockname()[1]
            try:
                client = await WsTestClient.connect(port)
                await client.receive()
                await client.send_text("SERVER DE CLIENT client=test type=receiver")
                await client.expect_json("config", timeout=WAIT_S)
                await client.send_text(json.dumps(
                    {"type": "dspcontrol", "action": "start"}))
                await client.send_text(json.dumps(
                    {"type": "dspcontrol",
                     "params": {"offset_freq": 0, "mod": "ism"}}))
                text = ""

                async def gather():
                    nonlocal text
                    while "Acurite" not in text:
                        msg = await client.expect_json("secondary_demod", timeout=WAIT_S)
                        text += msg["value"]
                await asyncio.wait_for(gather(), WAIT_S)
                ev = json.loads([line for line in text.splitlines()
                                 if "Acurite" in line][0])
                assert ev["mode"] == "ISM"
                await client.close()
            finally:
                await server.stop()
                SdrService.stop_all()
                Config.reset()
