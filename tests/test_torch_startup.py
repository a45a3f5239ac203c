"""The port's start-up warm-up (``runtime.device.warm_up``,
``SdrService.warm``, ``web.server.warm_sources``) on the CPU, and the
port's systemd unit.

On a card the server runs silent blocks through a throwaway runtime of
every configured source before it listens: a listener and a service bank
of every bucket, the waterfall, and the secondary (digimode),
digital-voice and IQ-tap programs of ``WARM_MODES``, so that a first block
on a bank or program new to the process finds the process's one-time
costs paid.  Here the warm function is called directly on the
CPU at 240 kS/s: it must start no subprocess, leave the runtime that
``SdrService.get_device`` hands out with no bank, handle or secondary,
route every dial as without it (and as the JAX runtime does), and change
no byte a listener, a PSK31 secondary or a DMR program gives.  A failure
inside it stops the server before it listens; on ``--device cpu`` the
server does not warm at all.
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
from openwebrx_tpu_torch import sdr as sdr_mod
from openwebrx_tpu_torch.core.config import Config, CoreConfig
from openwebrx_tpu_torch.core.property import PropertyLayer
from openwebrx_tpu_torch.digimodes.psk import _VARICODE
from openwebrx_tpu_torch.ops.firdes import root_raised_cosine_taps
from openwebrx_tpu_torch.runtime import device as device_mod
from openwebrx_tpu_torch.runtime.device import (
    PORT_HOST, WARM_MODES, DeviceRuntime, DigitalVoiceHandle, ExecAudioHandle, warm_up)
from openwebrx_tpu_torch.sdr import SdrService
from openwebrx_tpu_torch.services import pipeline as pipeline_mod
from openwebrx_tpu_torch.services.exec_modes import IQ_EXEC_MODES
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
# the secondary and DV scene: a PSK31 message and a C4FM burst of seeded
# dibits, each at its dial, long enough for the PSK31 text to decode
SCENE_BLOCKS = 16
PSK_DIAL, PSK_TEXT = 30_000.0, "cq cq de tpu "
DMR_DIAL = -60_000.0


def _configure(tmp, mp):
    """One signal source at RATE in SdrService, on the CPU, with the
    settings, users and caches in the data directory ``tmp``."""
    mp.setitem(CoreConfig.defaults, "data_directory", str(tmp))
    mp.setitem(CoreConfig.defaults, "temporary_directory", str(tmp))
    Config.reset()
    SdrService.stop_all()
    config = Config.get()
    for key, value in SETTINGS.items():
        config[key] = value
    config["sdrs"] = {"startup": SOURCE}
    SdrService.device = "cpu"
    return config


def _unconfigure():
    SdrService.stop_all()
    SdrService.device = "cuda"
    Config.reset()


@pytest.fixture()
def sdr_config(tmp_path, monkeypatch):
    yield _configure(tmp_path, monkeypatch)
    _unconfigure()


def _source(name):
    return SignalSource(name, PropertyLayer(**SOURCE))


def _blocks():
    """BLOCKS blocks of the seeded source, read once for every run."""
    src = _source("blocks")
    src.block_size = SdrService._new_runtime(src).block
    src.start()
    try:
        blocks = [src.read_block(timeout=60) for _ in range(BLOCKS)]
    finally:
        src.shutdown()
    assert all(b is not None for b in blocks)
    return blocks


def _scene_blocks(block):
    """SCENE_BLOCKS blocks of ``block`` samples: PSK31 (DBPSK at 31.25 Bd)
    carrying PSK_TEXT at PSK_DIAL, C4FM of seeded dibits at DMR's 4800 Bd
    and ±648/±1944 Hz (RRC-shaped frequency pulses) at DMR_DIAL, and
    noise."""
    rng = np.random.default_rng(14)
    n = SCENE_BLOCKS * block
    t = np.arange(n)
    bits = [0] * 8
    for ch in PSK_TEXT:
        bits += [int(b) for b in _VARICODE[ord(ch)]] + [0, 0]
    phases = np.cumprod(np.where(np.asarray(bits) == 1, 1.0, -1.0))   # 1 keeps, 0 flips
    psk = np.resize(np.repeat(phases, int(RATE / 31.25)), n) * np.exp(
        2j * np.pi * PSK_DIAL / RATE * t)
    sps = RATE // 4800
    impulses = np.zeros(n)
    impulses[::sps] = np.array([1.0, 3.0, -1.0, -3.0])[rng.integers(0, 4, len(t[::sps]))]
    taps = root_raised_cosine_taps(sps, 0.2)
    freq = np.convolve(impulses, taps * sps / taps.sum(), mode="same") * 648.0 + DMR_DIAL
    c4fm = np.exp(2j * np.pi * np.cumsum(freq) / RATE)
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return np.split((0.3 * psk + 0.3 * c4fm + 0.01 * noise).astype(np.complex64),
                    SCENE_BLOCKS)


class _Pipe:
    """A SubprocessPipeline that starts nothing: it keeps what it is fed."""

    def __init__(self, *args, **kwargs):
        self.fed = bytearray()

    def feed(self, data):
        self.fed += data

    def close(self):
        pass


def _scene(rt, blocks, mp):
    """A PSK31 secondary at PSK_DIAL (text and FFT payloads) and a DMR
    listener's program at DMR_DIAL (its dibits, as its vocoder pipeline
    gets them) on ``rt``, fed ``blocks`` through its block path, then
    closed → (text, FFT payloads, dibits)."""
    text, fft = [], []
    sec = rt.open_secondary("bpsk31", PSK_DIAL)
    sec.text_cb, sec.fft_cb = text.append, fft.append
    mp.setattr(pipeline_mod, "SubprocessPipeline", _Pipe)
    dv = DigitalVoiceHandle(rt, "dmr", DMR_DIAL)
    for block in blocks:
        rt._process_block(block)
    rt.release_secondary(sec)
    dv.close()
    assert rt.secondary_banks == {} and rt.secondary_handles == []
    return "".join(text), fft, bytes(dv.pipeline.fed)


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


def _listen(rt, blocks, mp):
    """Open OPENS on ``rt`` and run ``blocks`` through its block path →
    (wire bytes each handle received, every bank result fetched, waterfall
    payloads, each handle's route)."""
    handles = _open_all(rt)
    routes = _routes(rt, handles)
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
    mp.setattr(device_mod, "finish_fetch", recording)
    for block in blocks:
        rt._process_block(block)
    mp.setattr(device_mod, "finish_fetch", orig)
    return wire, fetched, rows, routes


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


def _jax_runtime(name):
    return JaxRuntime(JaxSignalSource(name, JaxPropertyLayer(**SOURCE)),
                      fft_size=SETTINGS["fft_size"],
                      capacity=SETTINGS["tpu_channel_capacity"],
                      target_seconds=SETTINGS["tpu_block_seconds"])


@pytest.fixture(scope="module")
def warmed(tmp_path_factory):
    """ONE ``SdrService.warm`` (its warm-up is the costly part of this
    file), with what TestWarmUp compares taken around it: before it, the
    scene (``_scene``) and the listeners (``_listen``) on a runtime built
    as ``get_device`` builds one; during it, with ``subprocess.Popen``
    raising, the warm-up's runtime, the banks each of its blocks
    delivered, and the programs it ran; after it, the threads alive, the
    state of the runtime ``get_device`` hands out, the same scene and
    listeners on it, and the JAX runtime's routes and PSK31 text."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _configure(tmp_path_factory.mktemp("warm"), mp)
        try:
            blocks = _blocks()
            plain = SdrService._new_runtime(_source("plain"))
            scene = _scene_blocks(plain.block)
            out["plain_scene"] = _scene(plain, scene, mp)
            out["plain"] = _listen(plain, blocks, mp)

            popen = out["popen"] = []

            def no_popen(*args, **kwargs):
                popen.append(args)
                raise AssertionError("the warm-up started a subprocess")

            def recording(rt):
                delivered = out["delivered"] = []
                orig = rt._complete_block
                rt._complete_block = lambda pending: (
                    delivered.append(set(pending["bank_pending"])), orig(pending))[1]
                out["runtime"] = rt
                out["programs"] = warm_up(rt)
                return out["programs"]
            with pytest.MonkeyPatch.context() as during:
                during.setattr(subprocess, "Popen", no_popen)
                during.setattr(sdr_mod, "warm_up", recording)
                out["seconds"] = SdrService.warm()
            out["threads"] = [t.name for t in threading.enumerate()]

            rt = SdrService.get_device("startup")
            out["real_state"] = (rt.banks.copy(), list(rt.handles),
                                 rt.secondary_banks.copy(), list(rt.secondary_handles))
            out["real_scene"] = _scene(rt, scene, mp)
            out["real"] = _listen(rt, blocks, mp)
            out["real_banks"] = set(rt.banks)

            jrt = _jax_runtime("jax")
            out["jax_routes"] = _routes(jrt, _open_all(jrt))
            out["jax_banks"] = set(jrt.banks)
            jpsk = _jax_runtime("jax-psk")
            assert jpsk.block == plain.block
            text = []
            jpsk.open_secondary("bpsk31", PSK_DIAL).text_cb = text.append
            for block in scene:
                jpsk._process_block(block)
            out["jax_text"] = "".join(text)
        finally:
            _unconfigure()
    return out


def _host_without_processes():
    """The port's host objects, but a SubprocessPipeline and a DRM status
    monitor that start nothing and no in-process HD Radio (its IQ tap is
    the piped one's)."""
    host = {name: getattr(PORT_HOST, name) for name in device_mod.HOST_NAMES
            if name != "hdradio"}

    class Monitor:
        def __init__(self, *args):
            pass

        start = stop = lambda self: None
    host.update(SubprocessPipeline=_Pipe, DrmStatusMonitor=Monitor)
    return types.SimpleNamespace(**host)


class TestWarmUp:
    def test_warm_up_pays_every_bucket_on_a_runtime_of_its_own(self, warmed):
        """warm_up builds, on the runtime it is given, a listener bank and
        a service bank in every bucket the rate offers, runs each to a
        delivery, and leaves no thread of its own behind."""
        rt = warmed["runtime"]
        assert not [t for t in warmed["threads"] if t.startswith("warm-up")]
        for bucket in rt.available_buckets:
            listener = {f"pfbi:{bucket}", bucket} & set(rt.banks)
            service = {f"pfb:{bucket}", f"svc:{bucket}"} & set(rt.banks)
            assert listener and service, bucket
        assert set().union(*warmed["delivered"]) == set(rt.banks)
        assert rt.waterfall_subscribers

    def test_warm_up_runs_every_program_of_warm_modes(self, warmed):
        """Besides the banks, warm_up ran one program of every mode of
        WARM_MODES (at 240 kS/s every IF of them fits), each to a
        delivery."""
        programs = warmed["programs"]
        assert sorted((p.kind, p.mode) for p in programs) == sorted(
            (kind, mode) for kind, modes in WARM_MODES.items() for mode in modes)
        assert all(p.delivered > 0 for p in programs), [
            (p.mode, p.delivered) for p in programs]

    def test_warm_up_starts_no_subprocess_and_leaves_no_thread(self, warmed):
        """With subprocess.Popen raising, the warm-up ran every program
        (the DV and exec modes' external decoders are never started), and
        its thread has ended."""
        assert warmed["popen"] == [] and warmed["programs"]
        assert warmed["seconds"] > 0
        assert not [t for t in warmed["threads"] if t.startswith("warm-up")]

    def test_warm_programs_are_the_handles_programs(self, sdr_config, warmed):
        """Each warm-up program has the chain class and structure, input
        rate, block and batch of the program a listener of its mode gets: a
        secondary through open_secondary, a DV listener's
        DigitalVoiceHandle, an exec audio mode's IQ tap through
        ExecAudioHandle, an IQ exec mode's tap through open_iq_channel."""
        rt = SdrService._new_runtime(_source("handles"))
        rt.host = _host_without_processes()

        def shape(program):
            return (type(program.chain), program.in_spec.rate, program.block,
                    program.batch_shape, program.chain.signature())
        for p in warmed["programs"]:
            if p.kind == "secondary":
                got = rt.open_secondary(p.mode, 1000.0).bank.program
            elif p.kind == "dv":
                got = DigitalVoiceHandle(rt, p.mode, 1000.0).program
            elif p.mode in ExecAudioHandle.MODES:
                got = ExecAudioHandle(rt, p.mode, 1000.0).iq.program
            else:
                spec = IQ_EXEC_MODES[p.mode]
                got = rt.open_iq_channel(spec["if_rate"], 1000.0, spec["wire"]).program
            assert shape(got) == shape(p.program), p.mode
        assert {p.kind for p in warmed["programs"]} == set(WARM_MODES)

    def test_a_mode_the_runtime_would_refuse_is_left_out(self, sdr_config, monkeypatch,
                                                         caplog):
        """A secondary mode whose host decoder the runtime's host lacks (the
        LookupError its handle raises) and an IQ mode whose IF is above the
        source's rate are left out of warm_programs, each logged by name;
        the other programs are still built."""
        caplog.set_level("INFO", logger=device_mod.logger.name)
        monkeypatch.setitem(WARM_MODES, "iq", ("freedv", "hdr"))
        rt = SdrService._new_runtime(_source("refused"))
        host = vars(_host_without_processes())
        host.pop("CwDecoder")
        rt.host = types.SimpleNamespace(**host)
        programs = device_mod.warm_programs(rt)
        assert sorted((p.kind, p.mode) for p in programs) == [
            ("dv", "dmr"), ("iq", "freedv"), ("secondary", "bpsk31"),
            ("secondary", "cwskimmer")]
        assert "warm-up leaves out cwdecoder" in caplog.text
        assert "warm-up leaves out hdr" in caplog.text

    def test_real_runtime_has_no_bank_and_routes_as_without_it(self, warmed):
        """After SdrService.warm the runtime get_device hands out has no
        bank, no handle, no secondary bank and no secondary handle; the same
        opens give each dial the bucket_key, slot and PFB channel a runtime
        built without the warm-up gives, and the same banks, as a set, as
        the JAX runtime's."""
        banks, handles, secondary_banks, secondary_handles = warmed["real_state"]
        assert banks == {} and handles == []
        assert secondary_banks == {} and secondary_handles == []
        got = warmed["real"][3]
        assert got == warmed["plain"][3]
        assert warmed["jax_routes"] == got
        assert warmed["real_banks"] == warmed["jax_banks"]

    def test_listener_bytes_are_bit_identical(self, warmed):
        """Every listener's wire bytes, every bank's fetched results (audio
        bytes, stride states, squelch power) and the waterfall payloads
        after the warm-up equal, bit for bit, a run without it."""
        plain, warm = warmed["plain"], warmed["real"]
        for name in plain[0]:
            assert plain[0][name], name
            assert warm[0][name] == plain[0][name], name
        assert len(warm[1]) == len(plain[1]) > 0
        for a, b in zip(plain[1], warm[1]):
            _same_tree(a, b)
        assert warm[2] == plain[2] and plain[2]

    def test_secondary_and_dv_bytes_are_bit_identical(self, warmed):
        """A PSK31 secondary's text and secondary-FFT payloads and a DMR
        listener's dibits on the seeded scene, on the runtime get_device
        hands out after the warm-up, equal a run without it."""
        plain, warm = warmed["plain_scene"], warmed["real_scene"]
        assert plain[0].startswith(PSK_TEXT[:2]), plain[0]
        assert warm[0] == plain[0]
        assert len(plain[1]) >= SCENE_BLOCKS // 2
        assert all(len(p) == (2048 + 10 + 1) // 2 for p in plain[1])
        assert warm[1] == plain[1]
        assert len(plain[2]) > 0 and set(plain[2]) <= {0, 1, 2, 3}
        assert warm[2] == plain[2]

    def test_psk31_text_equals_the_jax_runtime(self, warmed):
        """The PSK31 text on the warmed process's runtime equals the JAX
        DeviceRuntime's on the same blocks."""
        assert warmed["real_scene"][0] == warmed["jax_text"]
        assert warmed["jax_text"].startswith(PSK_TEXT[:2])

    def test_a_failure_inside_propagates(self, sdr_config, monkeypatch):
        """An error raised on the warm-up's thread comes out of warm_up and
        SdrService.warm, not swallowed."""
        def fail(self, block):
            raise RuntimeError("block failed")
        monkeypatch.setattr(DeviceRuntime, "_process_block", fail)
        with pytest.raises(RuntimeError, match="block failed"):
            warm_up(SdrService._new_runtime(_source("x")))
        with pytest.raises(RuntimeError, match="block failed"):
            SdrService.warm()

    def test_a_program_failure_propagates(self, sdr_config, monkeypatch):
        """An error a secondary program raises inside the warm-up comes out
        of warm_up; the runtime's loop would log it and go on, the warm-up
        does not."""
        def fail(self, block):
            raise RuntimeError("secondary program failed")
        monkeypatch.setattr(device_mod.SecondaryBank, "feed", fail)
        with pytest.raises(RuntimeError, match="secondary program failed"):
            warm_up(SdrService._new_runtime(_source("y")))


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
