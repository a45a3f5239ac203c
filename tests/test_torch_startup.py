"""The port's start-up warm-up (``runtime.device.warm_up``,
``SdrService.warm``, ``web.server.warm_sources``) on the CPU, and the
port's systemd unit.

On a card the server runs one silent block through a throwaway runtime of
every configured source before it listens, so that a listener's first
block on a bank new to the process finds the process's one-time costs
paid.  Here the warm function is called directly on the CPU at 240 kS/s:
it must leave the runtime that ``SdrService.get_device`` hands out with no
bank, route every dial as without it (and as the JAX runtime does), and
change no byte a listener receives.  A failure inside it stops the server
before it listens; on ``--device cpu`` the server does not warm at all.
"""

import asyncio
import shlex
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from openwebrx_tpu.core.property import PropertyLayer as JaxPropertyLayer
from openwebrx_tpu.runtime.device import DeviceRuntime as JaxRuntime
from openwebrx_tpu.sources.file import SignalSource as JaxSignalSource
from openwebrx_tpu_torch.core.config import Config, CoreConfig
from openwebrx_tpu_torch.core.property import PropertyLayer
from openwebrx_tpu_torch.runtime import device as device_mod
from openwebrx_tpu_torch.runtime.device import DeviceRuntime, warm_up
from openwebrx_tpu_torch.sdr import SdrService
from openwebrx_tpu_torch.sources.file import SignalSource
from openwebrx_tpu_torch.web import server

REPO = Path(__file__).resolve().parents[1]
UNIT = REPO / "deploy" / "systemd" / "openwebrx-tpu-torch.service"
RATE = 240000
SOURCE = {
    "name": "Startup", "type": "signal", "samp_rate": RATE,
    "center_freq": 145000000, "throttle": False, "noise": 1e-4,
    "signals": [
        {"kind": "nfm", "offset_hz": 30000.0, "f_audio": 1000.0, "amplitude": 0.5},
        {"kind": "usb", "offset_hz": -30000.0, "f_audio": 1500.0, "amplitude": 0.3},
    ],
}
# the settings get_device reads (the plain row encoder walks a 4096-bin
# row in about 1 s on the CPU, so the waterfall takes 1024 bins)
SETTINGS = {"fft_size": 1024, "fft_compression": "adpcm", "audio_compression": "adpcm",
            "tpu_channel_capacity": 4, "tpu_block_seconds": 0.1}
# (name, mode, dial, service) at 240 kS/s (8 channels of 30 kHz): dials the
# filterbanks take, dials at a channel edge (full-rate banks), services of
# both kinds, and a second dial in a bank already open
OPENS = [
    ("a", "nfm", 30_000.0, False),
    ("b", "usb", -30_000.0, False),
    ("c", "am", 45_000.0, False),
    ("d", "usb", 45_000.0, True),
    ("e", "usb", 60_000.0, True),
    ("f", "lsb", -30_000.0, False),
]
BLOCKS = 4


@pytest.fixture()
def sdr_config(tmp_path, monkeypatch):
    """One signal source at RATE in SdrService, on the CPU, with the
    settings, users and caches in a temporary data directory."""
    monkeypatch.setitem(CoreConfig.defaults, "data_directory", str(tmp_path))
    monkeypatch.setitem(CoreConfig.defaults, "temporary_directory", str(tmp_path))
    Config.reset()
    SdrService.stop_all()
    config = Config.get()
    for key, value in SETTINGS.items():
        config[key] = value
    config["sdrs"] = {"startup": SOURCE}
    SdrService.device = "cpu"
    yield config
    SdrService.stop_all()
    SdrService.device = "cuda"
    Config.reset()


def _blocks():
    """BLOCKS blocks of the seeded source, read once for every run."""
    src = SignalSource("blocks", PropertyLayer(**SOURCE))
    src.block_size = SdrService._new_runtime(src).block
    src.start()
    try:
        blocks = [src.read_block(timeout=60) for _ in range(BLOCKS)]
    finally:
        src.shutdown()
    assert all(b is not None for b in blocks)
    return blocks


def _open_all(rt):
    return {name: rt.open_channel(mode, dial, service=service)
            for name, mode, dial, service in OPENS}


def _routes(rt, handles):
    out = {}
    for name, h in handles.items():
        bank = rt.banks[h.bucket_key]
        chan = (int(bank._chan[h.slot]) if h.bucket_key.startswith(("pfb:", "pfbi:"))
                else None)
        out[name] = (h.bucket_key, h.slot, chan)
    return out


def _listen(rt, blocks, monkeypatch):
    """Open OPENS on ``rt`` and run ``blocks`` through its block path →
    (wire bytes each handle received, every bank result fetched, waterfall
    payloads)."""
    handles = _open_all(rt)
    wire = {name: [] for name in handles}
    for name, h in handles.items():
        h.audio_cb = lambda data, hd, out=wire[name]: out.append(bytes(data))
    rows = []
    rt.subscribe_waterfall(rows.append)
    fetched = []
    orig = device_mod.finish_fetch

    def recording(pending):
        y, aux = orig(pending)
        fetched.append((y, aux))
        return y, aux
    monkeypatch.setattr(device_mod, "finish_fetch", recording)
    for block in blocks:
        rt._process_block(block)
    monkeypatch.setattr(device_mod, "finish_fetch", orig)
    return wire, fetched, rows


def _same_tree(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


class TestWarmUp:
    def test_warm_up_pays_every_bucket_on_a_runtime_of_its_own(self, sdr_config):
        """warm_up builds, on the runtime it is given, a listener bank and
        a service bank in every bucket the rate offers, runs each to a
        delivery, and leaves no thread of its own behind."""
        src = SignalSource("throwaway", PropertyLayer(**SOURCE))
        rt = SdrService._new_runtime(src)
        delivered = []
        orig = rt._complete_block
        rt._complete_block = lambda pending: (delivered.append(set(pending["bank_pending"])),
                                              orig(pending))[1]
        warm_up(rt)
        assert not [t for t in threading.enumerate() if t.name.startswith("warm-up")]
        for bucket in rt.available_buckets:
            listener = {f"pfbi:{bucket}", bucket} & set(rt.banks)
            service = {f"pfb:{bucket}", f"svc:{bucket}"} & set(rt.banks)
            assert listener and service, bucket
        assert set().union(*delivered) == set(rt.banks)
        assert rt.waterfall_subscribers

    def test_real_runtime_has_no_bank_and_routes_as_without_it(self, sdr_config):
        """After SdrService.warm the runtime get_device hands out has no
        bank and no handle; the same opens give each dial the bucket_key,
        slot and PFB channel a runtime built without the warm-up gives,
        and the same banks, as a set, as the JAX runtime's."""
        plain = SdrService._new_runtime(SignalSource("plain", PropertyLayer(**SOURCE)))
        want = _routes(plain, _open_all(plain))
        assert SdrService.warm() > 0
        rt = SdrService.get_device("startup")
        assert rt.banks == {} and rt.handles == [] and rt.secondary_banks == {}
        got = _routes(rt, _open_all(rt))
        assert got == want
        jrt = JaxRuntime(JaxSignalSource("jax", JaxPropertyLayer(**SOURCE)),
                         fft_size=SETTINGS["fft_size"],
                         capacity=SETTINGS["tpu_channel_capacity"],
                         target_seconds=SETTINGS["tpu_block_seconds"])
        assert _routes(jrt, _open_all(jrt)) == got
        assert set(rt.banks) == set(jrt.banks)

    def test_listener_bytes_are_bit_identical(self, sdr_config, monkeypatch):
        """Every listener's wire bytes, every bank's fetched results (audio
        bytes, stride states, squelch power) and the waterfall payloads
        after the warm-up equal, bit for bit, a run without it."""
        blocks = _blocks()
        plain = _listen(SdrService._new_runtime(SignalSource("plain", PropertyLayer(**SOURCE))),
                        blocks, monkeypatch)
        SdrService.warm()
        warmed = _listen(SdrService.get_device("startup"), blocks, monkeypatch)
        for name in plain[0]:
            assert plain[0][name], name
            assert warmed[0][name] == plain[0][name], name
        assert len(warmed[1]) == len(plain[1]) > 0
        for a, b in zip(plain[1], warmed[1]):
            _same_tree(a, b)
        assert warmed[2] == plain[2] and plain[2]

    def test_a_failure_inside_propagates(self, sdr_config, monkeypatch):
        """An error raised on the warm-up's thread comes out of warm_up and
        SdrService.warm, not swallowed."""
        def fail(self, block):
            raise RuntimeError("block failed")
        monkeypatch.setattr(DeviceRuntime, "_process_block", fail)
        with pytest.raises(RuntimeError, match="block failed"):
            warm_up(SdrService._new_runtime(SignalSource("x", PropertyLayer(**SOURCE))))
        with pytest.raises(RuntimeError, match="block failed"):
            SdrService.warm()


class _Listening(Exception):
    """Raised by the fake HttpServer: the server got as far as listening."""


def _start_server(monkeypatch, device, warm, calls):
    """server.main_async with --signal-demo, ``open_device`` returning
    ``device`` and ``SdrService.warm`` replaced by ``warm`` (each call
    appended to ``calls``); the HTTP server is a fake whose start raises
    _Listening."""
    def counted():
        calls.append("warm")
        return warm()

    class FakeHttpServer:
        def __init__(self, *a, **k):
            self.ssl_context = None

        async def start(self):
            calls.append("listen")
            raise _Listening

    monkeypatch.setattr(server, "open_device", lambda name: torch.device(device))
    monkeypatch.setattr(SdrService, "warm", staticmethod(counted))
    monkeypatch.setattr(server, "HttpServer", FakeHttpServer)
    from openwebrx_tpu_torch.parallel import cluster
    monkeypatch.setattr(cluster, "init_cluster", lambda *a, **k: types.SimpleNamespace(
        num_processes=1))
    Config.get()["web_agents_enabled"] = False
    args = types.SimpleNamespace(device=device, signal_demo=True, port=0,
                                 coordinator=None, num_processes=None, process_id=None)
    try:
        asyncio.run(server.main_async(args))
    finally:
        from openwebrx_tpu_torch.core.markers import Markers
        from openwebrx_tpu_torch.services.engine import Services
        Markers.stop()
        Services.stop()


class TestServerStart:
    def test_warm_up_failure_stops_the_server_before_it_listens(
            self, sdr_config, monkeypatch, caplog):
        def fail():
            raise RuntimeError("cuFFT plan failed")
        calls = []
        with pytest.raises(SystemExit) as exc:
            _start_server(monkeypatch, "cuda", fail, calls)
        assert calls == ["warm"]
        # a string code: the interpreter prints it and exits with status 1
        assert isinstance(exc.value.code, str)
        assert "warm-up" in exc.value.code and "cuFFT plan failed" in exc.value.code
        assert "warm-up failed" in caplog.text

    def test_warms_on_a_card_before_listening(self, sdr_config, monkeypatch, caplog):
        caplog.set_level("INFO", logger=server.logger.name)
        calls = []
        with pytest.raises(_Listening):
            _start_server(monkeypatch, "cuda", lambda: 1.25, calls)
        assert calls == ["warm", "listen"]
        assert "warmed in 1.2 s" in caplog.text

    def test_no_warm_up_on_the_cpu(self, sdr_config, monkeypatch, caplog):
        caplog.set_level("INFO", logger=server.logger.name)
        calls = []
        with pytest.raises(_Listening):
            _start_server(monkeypatch, "cpu", lambda: 1.25, calls)
        assert calls == ["listen"]
        assert "warmed" not in caplog.text


class TestSystemdUnit:
    def _exec_start(self):
        lines = [ln.split("=", 1)[1] for ln in UNIT.read_text().splitlines()
                 if ln.startswith("ExecStart=")]
        assert len(lines) == 1
        return shlex.split(lines[0])

    def test_runs_the_port_on_the_card_by_default(self):
        argv = self._exec_start()
        assert Path(argv[0]).name.startswith("python3")
        assert argv[1:3] == ["-m", "openwebrx_tpu_torch"]
        assert "--device" not in argv

    def test_exec_start_answers_help(self):
        """The unit's command, with this interpreter in place of the
        unit's python3, answers --help from the checkout."""
        argv = self._exec_start()
        proc = subprocess.run([sys.executable, *argv[1:], "--help"], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.startswith("usage: openwebrx_tpu_torch")
        assert "--device" in proc.stdout and "--signal-demo" in proc.stdout
