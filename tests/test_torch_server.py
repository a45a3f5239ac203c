"""The port's web server (``openwebrx_tpu_torch.web``) on the CPU.

The reference's own scenes of tests/test_server.py run on both devices in
tests/test_torch_ref_server.py.  Here the port's runtimes are built on
``SdrService.device = "cpu"`` for tests/test_settings_api.py's
device/profile lifecycle, the profile and metrics endpoints, the CLI's
start-up refusals, and one scripted session through the JAX server and the
port's server in this process, compared message for message, waterfall
peak for peak and tone for tone.

On the CPU the port's waterfall row encoder is its plain per-nibble loop
(about 1 s a 4096-bin row), so the metrics scene, which reads no
waterfall, takes float rows (``fft_compression: none``); the parity
session keeps the compressed 4096-bin waterfall.  Every port test keeps
its settings, users and caches in a temporary data directory.
"""

import asyncio
import contextlib
import copy
import importlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_settings_api import http
from torch_ref_helpers import WsTestClient

from openwebrx_tpu_torch.core.config import Config, CoreConfig
from openwebrx_tpu_torch.ops.adpcm import (
    COMPRESS_FFT_PAD_N, SYNC_INTERVAL, adpcm_decode_np)
from openwebrx_tpu_torch.sdr import SdrService

REPO = Path(__file__).resolve().parents[1]
# tone SNR of the JAX server's and the port's decoded audio, as the
# runtime parity test of tests/test_torch_device.py
SNR_DB_TOL = 1.0
PEAK_BINS_TOL = 1

# tests/test_server.py's demo receiver
DEMO = {
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


@pytest.fixture(autouse=True)
def port_data_dir(tmp_path, monkeypatch):
    """The port's settings, users and caches live in a temporary data
    directory; its runtimes run on the CPU."""
    monkeypatch.setitem(CoreConfig.defaults, "data_directory", str(tmp_path))
    monkeypatch.setitem(CoreConfig.defaults, "temporary_directory", str(tmp_path))
    Config.reset()
    SdrService.device = "cpu"
    yield tmp_path
    SdrService.stop_all()
    SdrService.device = "cuda"
    Config.reset()


@pytest.fixture()
def demo_config():
    config = Config.get()
    config["sdrs"] = {"demo": copy.deepcopy(DEMO)}
    return config


@pytest.fixture()
def admin_user(tmp_path, monkeypatch):
    from openwebrx_tpu_torch.core import users as users_mod
    ul = users_mod.UserList(str(tmp_path / "users.json"))
    ul.add_user("admin", "secret")
    monkeypatch.setattr(users_mod.UserList, "shared", staticmethod(lambda: ul))
    monkeypatch.setattr(users_mod.SessionStorage, "_instance", None)


@contextlib.asynccontextmanager
async def serving(pkg="openwebrx_tpu_torch"):
    """``pkg``'s server on a free port, its sources loaded → the port."""
    sdr = importlib.import_module(f"{pkg}.sdr")
    server_mod = importlib.import_module(f"{pkg}.web.server")
    http_mod = importlib.import_module(f"{pkg}.web.http")
    sdr.SdrService.load()
    server = http_mod.HttpServer(server_mod.build_router(), port=0,
                                 host="127.0.0.1")
    await server.start()
    try:
        yield server._server.sockets[0].getsockname()[1]
    finally:
        await server.stop()
        sdr.SdrService.stop_all()


async def receiver(port):
    """A connected client past the handshake."""
    client = await WsTestClient.connect(port)
    opcode, payload = await client.receive()
    assert payload.decode().startswith("CLIENT DE SERVER")
    await client.send_text("SERVER DE CLIENT client=test type=receiver")
    return client


def decoded_row(payload: bytes) -> np.ndarray:
    row_i16, _ = adpcm_decode_np(bytes(payload))
    return row_i16[COMPRESS_FFT_PAD_N:].astype(np.float32) / 100


def decode_audio(data: bytes) -> np.ndarray:
    """A listener's ADPCM stream as the browser decodes it: from each SYNC
    header (codec state) the next SYNC_INTERVAL bytes, then the next
    header found (htdocs/lib/AudioEngine.js decodeWithSync)."""
    out, pos = [], data.find(b"SYNC")
    while 0 <= pos < len(data) - 8:
        idx, pred = np.frombuffer(data[pos + 4:pos + 8], "<i2")
        chunk = data[pos + 8:pos + 8 + SYNC_INTERVAL]
        out.append(adpcm_decode_np(chunk, (int(pred), int(idx)))[0])
        pos = data.find(b"SYNC", pos + 8 + len(chunk))
    return np.concatenate(out) if out else np.zeros(0, np.int16)


def tone_snr(pcm, f_tone, fs=12000.0):
    """Power within ±10 % of f_tone against the rest above 50 Hz, dB."""
    x = pcm.astype(np.float32)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    band = (freqs > f_tone * 0.9) & (freqs < f_tone * 1.1)
    rest = (freqs > 50) & ~band
    return 10 * np.log10(spec[band].sum() / spec[rest].sum())


# ------------------------------------------- settings, profile and metrics --
@pytest.mark.usefixtures("admin_user")
class TestSdrCrud:
    """tests/test_settings_api.py's device/profile lifecycle against the
    port's settings API and SdrService."""

    def test_device_profile_lifecycle(self):
        asyncio.run(self._run())

    async def _run(self):
        SdrService.reset()
        async with serving() as port:
            _, _, cookie = await http(port, "POST", "/login",
                                      {"username": "admin", "password": "secret"})
            status, body, _ = await http(port, "GET", "/api/sdrs/schema",
                                         cookie=cookie)
            assert status == 200
            schema = json.loads(body)
            assert "rtl_sdr" in schema and "sddc_soapy" in schema
            keys = [f["key"] for f in schema["rtl_sdr"]["device_fields"]]
            assert "name" in keys and "ppm" in keys and "bias_tee" in keys
            pkeys = [f["key"] for f in schema["rtl_sdr"]["profile_fields"]]
            assert "center_freq" in pkeys and "samp_rate" in pkeys

            status, _, _ = await http(port, "POST", "/api/sdrs",
                                      {"type": "signal", "name": "x"})
            assert status == 401

            status, body, _ = await http(
                port, "POST", "/api/sdrs",
                {"type": "signal", "name": "Test Signal", "enabled": True},
                cookie=cookie)
            assert status == 200, body
            sdr_id = json.loads(body)["id"]
            sdrs = Config.get()["sdrs"]
            entry = dict(sdrs[sdr_id].items()) if hasattr(
                sdrs[sdr_id], "items") else sdrs[sdr_id]
            assert entry["name"] == "Test Signal"

            status, _, _ = await http(port, "POST", "/api/sdrs",
                                      {"type": "warp_drive", "name": "x"},
                                      cookie=cookie)
            assert status == 400
            status, _, _ = await http(port, "POST", "/api/sdrs",
                                      {"type": "signal"}, cookie=cookie)
            assert status == 400

            status, body, _ = await http(port, "GET", "/api/sdrs", cookie=cookie)
            listing = json.loads(body)
            assert sdr_id in listing and "state" in listing[sdr_id]

            status, body, _ = await http(port, "POST", f"/api/sdrs/{sdr_id}",
                                         {"name": "Renamed"}, cookie=cookie)
            assert status == 200
            status, _, _ = await http(port, "POST", f"/api/sdrs/{sdr_id}",
                                      {"nonsense_key": 1}, cookie=cookie)
            assert status == 400

            status, _, _ = await http(port, "POST",
                                      f"/api/sdrs/{sdr_id}/profiles",
                                      {"name": "2m"}, cookie=cookie)
            assert status == 400
            status, body, _ = await http(
                port, "POST", f"/api/sdrs/{sdr_id}/profiles",
                {"name": "2m", "center_freq": 145000000,
                 "samp_rate": 2400000, "start_mod": "nfm"}, cookie=cookie)
            assert status == 200, body
            pid = json.loads(body)["id"]

            status, _, _ = await http(
                port, "POST", f"/api/sdrs/{sdr_id}/profiles/{pid}",
                {"start_mod": "nope"}, cookie=cookie)
            assert status == 400
            status, _, _ = await http(
                port, "POST", f"/api/sdrs/{sdr_id}/profiles/{pid}",
                {"start_freq": 145500000}, cookie=cookie)
            assert status == 200

            src = SdrService.get_sources().get(sdr_id)
            assert src is not None
            assert pid in src.get_profiles()

            status, _, _ = await http(
                port, "POST", f"/api/sdrs/{sdr_id}/profiles/{pid}/delete",
                cookie=cookie)
            assert status == 200
            status, _, _ = await http(port, "POST", f"/api/sdrs/{sdr_id}/delete",
                                      cookie=cookie)
            assert status == 200
            sdrs = Config.get()["sdrs"]
            contains = (sdr_id in dict(sdrs.items())) if hasattr(
                sdrs, "items") else (sdr_id in sdrs)
            assert not contains
            assert sdr_id not in SdrService.get_sources()
        SdrService.reset()


@pytest.mark.usefixtures("admin_user")
class TestProfileEndpoint:
    def test_profile_returns_a_trace(self):
        asyncio.run(self._run())

    async def _run(self):
        async with serving() as port:
            status, _, _ = await http(port, "POST", "/api/profile?seconds=0.2")
            assert status == 401
            _, _, cookie = await http(port, "POST", "/login",
                                      {"username": "admin", "password": "secret"})
            status, body, _ = await http(port, "POST", "/api/profile?seconds=0.2",
                                         cookie=cookie)
            assert status == 200, body
            out = json.loads(body)
            assert out["seconds"] == 0.2
            trace = Path(out["trace_dir"]) / "trace.json"
            try:
                assert "traceEvents" in json.loads(trace.read_text())
            finally:
                shutil.rmtree(out["trace_dir"], ignore_errors=True)


@pytest.mark.usefixtures("demo_config")
class TestMetrics:
    def test_device_gauges_on_metrics(self):
        """After a few blocks of the loop the runtime's gauges are on
        /metrics (Prometheus) and /metrics.json, as the reference's are, and
        its spans' counts and seconds beside them."""
        Config.get()["fft_compression"] = "none"
        asyncio.run(self._run())

    async def _run(self):
        async with serving() as port:
            client = await receiver(port)
            await client.expect_json("config")
            await client.send_text(json.dumps(
                {"type": "dspcontrol", "action": "start"}))
            await client.collect_binary(0x02, 3, timeout=60)
            status, body, _ = await http(port, "GET", "/metrics")
            assert status == 200
            lines = body.decode().splitlines()
            assert any(line.startswith("device_demo_realtime_factor ")
                       for line in lines)
            assert "# TYPE device_demo_span_dispatch summary" in lines
            assert any(line.startswith("device_demo_span_deliver_sum ") for line in lines)
            status, body, _ = await http(port, "GET", "/metrics.json")
            gauges = json.loads(body)["device"]["demo"]
            assert gauges["blocks"]["count"] >= 3
            assert gauges["realtime_factor"] > 0 and gauges["proc_block_ms"] > 0
            assert gauges["span"]["dispatch"]["count"] >= 3
            assert gauges["span"]["deliver"]["sum"] > 0
            await client.close()


class TestCommandLine:
    """``python -m openwebrx_tpu_torch`` serves on the device it is given
    and refuses what it cannot serve before it listens."""

    @staticmethod
    def _env():
        return {**os.environ, "PYTHONPATH": str(REPO)}

    def _run(self, *args):
        return subprocess.run(
            [sys.executable, "-m", "openwebrx_tpu_torch", *args], cwd=REPO,
            env=self._env(), capture_output=True, text=True, timeout=120)

    def test_default_device_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        proc = self._run("--signal-demo", "--port", "0")
        assert proc.returncode != 0
        assert "--device cpu" in proc.stderr
        assert "ready on" not in proc.stderr

    def test_several_processes_need_a_coordinator(self):
        proc = self._run("--device", "cpu", "--signal-demo", "--port", "0",
                         "--num-processes", "2")
        assert proc.returncode != 0
        assert "coordinator" in proc.stderr
        assert "ready on" not in proc.stderr

    def test_two_processes_join_a_cluster(self, tmp_path):
        """Two servers on --device cpu join one gloo cluster as hosts 0 and
        1, each serves its own port, and SIGTERM stops both cleanly."""
        settings = tmp_path / "settings.json"
        settings.write_text(json.dumps({"version": 8, "web_agents_enabled": False}))
        ports = []
        for _ in range(3):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                ports.append(s.getsockname()[1])
        coordinator, web = ports[0], ports[1:]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "openwebrx_tpu_torch", "--device", "cpu",
             "--signal-demo", "--port", str(web[i]), "--config", str(settings),
             "--coordinator", f"127.0.0.1:{coordinator}",
             "--num-processes", "2", "--process-id", str(i)],
            cwd=REPO, env=self._env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for i in range(2)]
        try:
            deadline = time.monotonic() + 90
            for port, proc in zip(web, procs):
                up = False
                while not up and time.monotonic() < deadline \
                        and proc.poll() is None:
                    try:
                        up = asyncio.run(http(port, "GET", "/status.json"))[0] == 200
                    except OSError:
                        time.sleep(0.2)
                assert up, proc.stderr.read() if proc.poll() is not None else ""
            errs = []
            for proc in procs:
                proc.send_signal(signal.SIGTERM)
            for proc in procs:
                _, err = proc.communicate(timeout=60)
                assert proc.returncode == 0, err
                errs.append(err)
            for i, err in enumerate(errs):
                assert f"joined cluster: host {i}/2" in err
                assert "ready on" in err and "shutting down" in err
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()

    def test_serves_on_the_cpu(self, tmp_path):
        """The whole start-up (settings file, sources, services, markers,
        routes) with --device cpu; /status.json answers; SIGTERM stops it
        cleanly.  The settings file turns the web agents off: they would
        fetch their databases from the network."""
        settings = tmp_path / "settings.json"
        settings.write_text(json.dumps({"version": 8, "web_agents_enabled": False}))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        proc = subprocess.Popen(
            [sys.executable, "-m", "openwebrx_tpu_torch", "--device", "cpu",
             "--signal-demo", "--port", str(port), "--config", str(settings)],
            cwd=REPO, env=self._env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            status = None
            deadline = time.monotonic() + 60
            while status is None and time.monotonic() < deadline \
                    and proc.poll() is None:
                try:
                    code, body, _ = asyncio.run(http(port, "GET", "/status.json"))
                    status = json.loads(body) if code == 200 else None
                except OSError:
                    time.sleep(0.2)
            assert status is not None, proc.stderr.read() if proc.poll() is not None else ""
            assert [s["id"] for s in status["sdrs"]] == ["demo"]
            proc.send_signal(signal.SIGTERM)
            _, err = proc.communicate(timeout=60)
            assert proc.returncode == 0, err
            assert "ready on" in err and "shutting down" in err
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


# ----------------------------------------------- parity with the JAX server --
# the demo receiver plus an AM carrier for the second tuning
PARITY_AM = {"kind": "am", "offset_hz": -60000.0, "f_audio": 800.0,
             "amplitude": 0.4}
PARITY_AUDIO_BYTES = 3600      # 0.6 s of 12 kHz ADPCM (7200 samples)
TONE_SNR_MIN_DB = 15.0
# a chat message sent after a listener's dspcontrol: the server handles a
# client's messages in order, so its echo marks where the new parameters
# have taken effect, and the frames after it are the new tuning's
PARAMS_MARK = {"type": "sendmessage", "text": "parameters sent", "name": "parity"}
# a safety net: each listen ends when its audio and rows are in
LISTEN_WAIT_S = 300


def bin_of(offset_hz):
    return 2048 + round(offset_hz / 240000 * 4096)


async def scripted_session(pkg):
    """Two listeners on ``pkg``'s server, one after the other: the first
    takes the handshake messages and listens to the demo's NFM dial with
    the squelch open, the second to the AM carrier → (the four handshake
    messages, decoded waterfall rows, NFM pcm, AM pcm).  Each listener
    keeps only the frames after the echo of ``PARAMS_MARK``."""
    async with serving(pkg) as port:
        async def listen(params, n_bytes, rows, hello=()):
            client = await receiver(port)
            messages = [(await client.expect_json(t))["value"] for t in hello]
            await client.send_text(json.dumps({"type": "dspcontrol", "action": "start"}))
            await client.send_text(json.dumps({"type": "dspcontrol", "params": params}))
            await client.send_text(json.dumps(PARAMS_MARK))
            audio, got_rows, marked = bytearray(), [], False

            async def collect():
                nonlocal marked
                while not marked or len(audio) < n_bytes or len(got_rows) < rows:
                    opcode, payload = await client.receive()
                    if opcode == 0x1:
                        msg = json.loads(payload)
                        marked |= (msg.get("type") == "chat_message"
                                   and msg.get("text") == PARAMS_MARK["text"])
                    elif marked and opcode == 0x2 and payload and payload[0] == 0x02:
                        audio.extend(payload[1:])
                    elif marked and opcode == 0x2 and payload and payload[0] == 0x01:
                        got_rows.append(decoded_row(payload[1:]))
            await asyncio.wait_for(collect(), LISTEN_WAIT_S)
            await client.close()
            return messages, decode_audio(bytes(audio)), got_rows

        hello, nfm, rows = await listen(
            {"offset_freq": 14500, "squelch_level": -150}, PARITY_AUDIO_BYTES, 3,
            ("receiver_details", "modes", "profiles", "config"))
        _, am, _ = await listen({"mod": "am", "offset_freq": -60000},
                                2 * PARITY_AUDIO_BYTES, 0)
    return hello, rows, nfm, am


class TestParityWithJaxServer:
    def test_same_session_same_answers(self, tmp_path, monkeypatch):
        import openwebrx_tpu.core.config as jax_config
        import openwebrx_tpu.sdr as jax_sdr
        monkeypatch.setitem(jax_config.CoreConfig.defaults, "data_directory",
                            str(tmp_path / "jax"))
        sides = {}
        for pkg, config in (("openwebrx_tpu", jax_config.Config), ("openwebrx_tpu_torch", Config)):
            config.reset()
            demo = copy.deepcopy(DEMO)
            demo["signals"].append(PARITY_AM)
            # paced at its sample rate, as a receiver's source is: both
            # servers read the same samples, and the JAX server's compiled
            # loop cannot outrun the client sharing this event loop (it
            # would be dropped 100 messages behind as a slow client)
            demo["throttle"] = True
            config.get()["sdrs"] = {"demo": demo}
            try:
                sides[pkg] = asyncio.run(scripted_session(pkg))
            finally:
                jax_sdr.SdrService.stop_all()
                config.reset()
        (hj, rows_j, nfm_j, am_j), (hp, rows_p, nfm_p, am_p) = (
            sides["openwebrx_tpu"], sides["openwebrx_tpu_torch"])
        assert hp == hj
        # every row of both servers peaks on one of the NFM carrier's two
        # strongest lines (index 3: J2 at ±2 kHz, equal in power, so a row
        # may peak on either); the compressed rows smear the AM carrier's
        # single bin (the reference codec), so it is not the peak
        lines = (bin_of(14500 - 2000), bin_of(14500 + 2000))
        for rows in (rows_j, rows_p):
            assert len(rows) >= 3
            for row in rows:
                peak = int(np.argmax(row[:4096]))
                assert min(abs(peak - k) for k in lines) <= PEAK_BINS_TOL, peak
        # the AM listener's last 0.6 s (its first 0.1 s is the AGC's
        # attack on the new carrier)
        tail = 2 * PARITY_AUDIO_BYTES
        for pcm_j, pcm_p, f_tone in ((nfm_j, nfm_p, 1000.0),
                                     (am_j[-tail:], am_p[-tail:], 800.0)):
            assert min(len(pcm_j), len(pcm_p)) >= tail
            snr_j, snr_p = tone_snr(pcm_j, f_tone), tone_snr(pcm_p, f_tone)
            assert snr_p >= TONE_SNR_MIN_DB, (f_tone, snr_p)
            assert abs(snr_p - snr_j) <= SNR_DB_TOL, (f_tone, snr_j, snr_p)
