"""The port's DeviceRuntime (openwebrx_tpu_torch.runtime.device) on the CPU.

The reference's SignalSource is the duck-typed source and the reference's
host decoders come in through ``host=`` (``reference_host``).  The tests
mirror tests/test_pfb_serving.py, tests/test_pfb_interactive.py and
tests/test_secondary_bank.py, one DigitalVoiceHandle and two
ExecAudioHandle scenes, and hold the port against the JAX runtime:

* routing: one scripted sequence of opens, retunes, mode switches and
  releases gives the same block plan and, after every step, the same
  (bucket_key, slot, PFB channel) for every handle in both runtimes;
* output: the audio and waterfall bytes a handle or subscriber receives
  are bit-identical to the port's banks and FftChain program fed the same
  blocks directly, and a tone dial decodes to the same tone SNR as through
  the JAX runtime, within 1 dB.

The waterfall's plain row encoder walks a row in Python (~1 s a 4096-bin
row on the CPU), so scenes with a waterfall subscriber use 1024 bins.
"""

import importlib
import stat
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from openwebrx_tpu.core.property import PropertyLayer
from openwebrx_tpu.runtime.device import DeviceRuntime as JaxRuntime
from openwebrx_tpu.sources.file import SignalSource
from openwebrx_tpu_torch.models.receiver import MODE_BANDPASS, FftChain
from openwebrx_tpu_torch.ops.adpcm import SYNC_INTERVAL, SyncFramer, adpcm_decode_np
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.bank import ChannelBank
from openwebrx_tpu_torch.runtime.chain import Program
from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank
from openwebrx_tpu_torch.runtime.device import (
    BUCKET_CHAIN_MODE, HOST_NAMES, DeviceRuntime, DigitalVoiceHandle,
    ExecAudioHandle, M17MetaTap, SecondaryBank, SecondaryHandle)

RATE = 3.072e6          # → 128 PFB channels of 24 kHz for SSB
CPU = "cpu"
# tone SNR of one dial through the port's runtime and the JAX runtime
SNR_DB_TOL = 1.0


def reference_host():
    """The reference package's host objects under HOST_NAMES."""
    ns = {}
    for name, module in HOST_NAMES.items():
        mod = importlib.import_module(f"openwebrx_tpu.{module}")
        ns[name] = mod if module.endswith("." + name) else getattr(mod, name)
    return types.SimpleNamespace(**ns)


HOST = reference_host()


def _source(signals, noise=2e-3, rate=RATE, name="torch-rt"):
    props = PropertyLayer(samp_rate=int(rate), center_freq=14_100_000,
                          throttle=False, noise=noise, signals=signals)
    return SignalSource(name, props)


def _make_runtime(signals, noise=2e-3, **kw):
    src = _source(signals, noise)
    kw.setdefault("capacity", 8)
    kw.setdefault("target_seconds", 0.05)
    return DeviceRuntime(src, host=HOST, device=CPU, **kw), src


def _pump(rt, src, blocks):
    """Drive the runtime synchronously for N device blocks."""
    src.start()
    for _ in range(blocks):
        b = src.read_block(timeout=5.0)
        assert b is not None
        rt._process_block(b)


def decode_wire(frames):
    """SYNC-framed IMA ADPCM wire bytes → int16 PCM."""
    data = b"".join(frames)
    out, pos, state = [], 0, (0, 0)
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


def tone_power_ratio(pcm, f_tone, fs=12000.0):
    """Power within ±60 Hz of f_tone against the total above 50 Hz, dB."""
    x = pcm.astype(np.float32)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    band = (freqs > f_tone - 60) & (freqs < f_tone + 60)
    total = spec[freqs > 50].sum()
    return 10 * np.log10(spec[band].sum() / max(total, 1e-12) + 1e-12)


class TestPfbServing:
    def test_64_dials_one_program(self):
        """64 background USB dials all serve from ONE ChannelizedBank;
        audio flows on every one, and the tone decodes in its owner's
        channel, ≥ 30 dB above its line in a far channel."""
        m = 128
        centers = np.fft.fftfreq(m, 1 / RATE)
        ks = ([k for k in range(2, m // 2 - 2)]
              + [k for k in range(m // 2 + 2, m - 2)])[:64]
        dials = [float(centers[k] + 500.0) for k in ks]
        rt, src = _make_runtime([{"kind": "usb", "offset_hz": dials[10],
                                  "f_audio": 1000.0, "amplitude": 0.4}])
        audio = {i: [] for i in range(len(dials))}
        try:
            handles = []
            for i, dial in enumerate(dials):
                h = rt.open_channel("usb", dial, service=True)
                h.audio_cb = lambda wire, hd=False, i=i: audio[i].append(wire)
                handles.append(h)
            assert {h.bucket_key for h in handles} == {"pfb:ssb"}
            bank = rt.banks["pfb:ssb"]
            assert bank.n_active == 64 and bank.m == m
            assert "svc:ssb" not in rt.banks
            assert bank.delivery_stride == 6 and bank.compression == "none"
            _pump(rt, src, 24)              # four 6-block deliveries
        finally:
            src.stop()
        assert all(audio[i] for i in audio), "audio missing on some dials"
        pcm = np.frombuffer(b"".join(audio[10]), np.int16).astype(np.float32)
        assert len(pcm) == 24 * 600
        spec = np.abs(np.fft.rfft(pcm[1200:]))
        freqs = np.fft.rfftfreq(len(pcm) - 1200, 1 / 12000.0)
        assert abs(freqs[np.argmax(spec[3:]) + 3] - 1000.0) < 30.0
        tone_ratio = spec[(freqs > 950) & (freqs < 1050)].max() / np.median(spec[3:])
        other = np.frombuffer(b"".join(audio[40]), np.int16).astype(np.float32)
        spec_o = np.abs(np.fft.rfft(other[1200:]))
        other_ratio = spec_o[(freqs > 950) & (freqs < 1050)].max() / np.median(spec_o[3:])
        assert tone_ratio > 31.6 * other_ratio, (tone_ratio, other_ratio)

    def test_edge_dial_falls_back_to_full_rate(self):
        rt, src = _make_runtime([])
        edge = rt.open_channel("usb", 11_800.0, service=True)
        assert edge.bucket_key == "svc:ssb"
        mid = rt.open_channel("usb", 48_000.0 + 500.0, service=True)
        assert mid.bucket_key == "pfb:ssb"
        dup = rt.open_channel("usb", 48_000.0 + 900.0, service=True)
        assert dup.bucket_key == "pfb:ssb"
        bank = rt.banks["pfb:ssb"]
        assert int(bank._chan[mid.slot]) == int(bank._chan[dup.slot])
        assert mid.slot != dup.slot

    def test_pfb_retune_and_release(self):
        rt, src = _make_runtime([])
        h = rt.open_channel("usb", 48_500.0, service=True)
        assert h.bucket_key == "pfb:ssb"
        bank = rt.banks["pfb:ssb"]
        s0 = h.slot
        assert int(bank._chan[s0]) == 2
        h.set_offset(48_900.0)
        assert h.slot == s0 and int(bank._chan[s0]) == 2
        h.set_offset(72_500.0)
        assert h.slot == s0 and int(bank._chan[s0]) == 3
        h.close()
        assert bank.n_active == 0

    def test_listener_services_waterfall_share_device(self):
        """A listener, a waterfall subscriber and a PFB service bank on one
        runtime, through the threaded loop (start/stop, 60 s deadline)."""
        rt, src = _make_runtime(
            [{"kind": "usb", "offset_hz": 48_500.0, "f_audio": 900.0, "amplitude": 0.4},
             {"kind": "nfm", "offset_hz": -200_000.0, "f_audio": 700.0, "amplitude": 0.4}],
            fft_size=1024)
        rows, got = [], {"listener": 0, "svc": 0}
        rt.subscribe_waterfall(lambda payload: rows.append(len(payload)))
        listener = rt.open_channel("nfm", -200_000.0)
        listener.audio_cb = lambda w, hd=False: got.__setitem__("listener", got["listener"] + 1)
        svc = rt.open_channel("usb", 48_500.0, service=True)
        svc.audio_cb = lambda w, hd=False: got.__setitem__("svc", got["svc"] + 1)
        assert svc.bucket_key == "pfb:ssb" and listener.bucket_key == "pfbi:nfm"
        try:
            rt.start()
            deadline = time.time() + 60
            while time.time() < deadline and not (
                    got["listener"] >= 3 and got["svc"] >= 3 and len(rows) >= 3):
                time.sleep(0.1)
        finally:
            rt.stop()
            src.stop()
        assert rt._thread is None
        assert got["listener"] >= 3 and got["svc"] >= 3, got
        assert len(rows) >= 3 and set(rows) == {(1024 + 10 + 1) // 2}
        assert rt.gauges["blocks"] >= 3 and rt.gauges["proc_block_ms"] > 0

    def test_service_retune_migrates_on_edge(self):
        rt, src = _make_runtime([])
        h = rt.open_channel("usb", 48_500.0, service=True)
        assert h.bucket_key == "pfb:ssb"
        h.set_offset(11_800.0)
        assert h.bucket_key == "svc:ssb" and h.slot is not None
        h2 = rt.open_channel("usb", 48_600.0, service=True)
        assert h2.bucket_key == "pfb:ssb"


class TestInteractivePfb:
    def test_listener_rides_pfb_with_adpcm_audio(self):
        rt, src = _make_runtime([{"kind": "usb", "offset_hz": 48_500.0,
                                  "f_audio": 1000.0, "amplitude": 0.4}])
        frames = []
        try:
            h = rt.open_channel("usb", 48_500.0)
            assert h.bucket_key == "pfbi:ssb"
            bank = rt.banks["pfbi:ssb"]
            assert bank.compression == "adpcm" and bank.delivery_stride == 1
            h.audio_cb = lambda wire, hd=False: frames.append(wire)
            _pump(rt, src, 8)
        finally:
            src.stop()
        pcm = decode_wire(frames)
        assert len(pcm) >= 4000
        assert tone_power_ratio(pcm[1200:], 1000.0) > -6.0

    def test_same_station_listeners_share_channel(self):
        rt, src = _make_runtime([])
        a = rt.open_channel("usb", 48_500.0)
        b = rt.open_channel("usb", 48_500.0)
        c = rt.open_channel("usb", 48_700.0)
        assert {a.bucket_key, b.bucket_key, c.bucket_key} == {"pfbi:ssb"}
        bank = rt.banks["pfbi:ssb"]
        assert len({int(bank._chan[h.slot]) for h in (a, b, c)}) == 1
        assert len({a.slot, b.slot, c.slot}) == 3

    def test_edge_dial_full_rate_and_nfm_gets_wider_slices(self):
        rt, src = _make_runtime([])
        assert rt.open_channel("usb", 11_800.0).bucket_key == "ssb"
        nfm = rt.open_channel("nfm", -192_000.0 + 2_000.0)
        assert nfm.bucket_key == "pfbi:nfm" and rt.banks["pfbi:nfm"].m == 64

    def test_migration_and_readmit_with_audio_continuity(self):
        """PFB → full rate → PFB mid-stream, decodable audio in every
        phase; each migration resets the framer."""
        rt, src = _make_runtime(
            [{"kind": "usb", "offset_hz": 48_500.0, "f_audio": 1000.0, "amplitude": 0.4},
             {"kind": "usb", "offset_hz": 11_800.0, "f_audio": 1500.0, "amplitude": 0.4}])
        phases = {"pfb": [], "full": [], "back": []}
        current = ["pfb"]
        try:
            h = rt.open_channel("usb", 48_500.0)
            assert h.bucket_key == "pfbi:ssb"
            h.audio_cb = lambda wire, hd=False: phases[current[0]].append(wire)
            _pump(rt, src, 6)
            h.set_offset(11_800.0)
            assert h.bucket_key == "ssb" and h.slot is not None
            current[0] = "full"
            _pump(rt, src, 6)
            h.set_offset(48_500.0)
            assert h.bucket_key == "pfbi:ssb"
            current[0] = "back"
            _pump(rt, src, 6)
        finally:
            src.stop()
        pcm = {k: decode_wire(v) for k, v in phases.items()}
        assert all(len(p) >= 3000 for p in pcm.values())
        assert tone_power_ratio(pcm["pfb"][1200:], 1000.0) > -6.0
        assert tone_power_ratio(pcm["full"][1200:], 1500.0) > -6.0
        assert tone_power_ratio(pcm["back"][1200:], 1000.0) > -6.0
        assert "ssb" in rt.banks and "pfbi:ssb" in rt.banks

    def test_smeter_on_pfb_path(self):
        rt, src = _make_runtime([{"kind": "usb", "offset_hz": 48_500.0,
                                  "f_audio": 800.0, "amplitude": 0.5}])
        vals = []
        try:
            h = rt.open_channel("usb", 48_500.0)
            assert h.bucket_key == "pfbi:ssb"
            h.smeter_cb = vals.append
            _pump(rt, src, 8)
        finally:
            src.stop()
        assert len(vals) >= 2 and all(np.isfinite(v) for v in vals)

    def test_mode_switch_stays_channelized(self):
        rt, src = _make_runtime([])
        h = rt.open_channel("usb", 48_500.0)
        h.set_mode("lsb")
        assert h.bucket_key == "pfbi:ssb" and h.mode == "lsb" and h.slot is not None
        assert float(rt.banks["pfbi:ssb"]._low[h.slot]) == -3000.0


class TestOneFetchPerBlock:
    """The waterfall and every bank of a block are dispatched before any
    fetch, and their host copies start together (behind one event on a
    card); bank membership may change between dispatch and complete."""

    def test_waterfall_and_banks_dispatched_together(self):
        rt, src = _make_runtime([{"kind": "usb", "offset_hz": 48_500.0,
                                  "f_audio": 1000.0, "amplitude": 0.4}],
                                fft_size=1024)
        rows, frames = [], []
        rt.subscribe_waterfall(lambda p: rows.append(len(p)))
        h = rt.open_channel("usb", 48_500.0)
        h.audio_cb = lambda wire, hd=False: frames.append(wire)
        try:
            src.start()
            pend = rt._dispatch_block(src.read_block(timeout=5.0))
            assert len(pend["fft_pending"]) == 1
            assert list(pend["bank_pending"]) == ["pfbi:ssb"]
            assert not rows and not frames          # nothing delivered yet
            rt._complete_block(pend)
            assert rows and frames
        finally:
            src.stop()
        assert len(decode_wire(frames)) > 0

    def test_single_program(self):
        rt, src = _make_runtime([])
        h = rt.open_channel("usb", 48_500.0)
        h.audio_cb = lambda wire, hd=False: None
        try:
            src.start()
            pend = rt._dispatch_block(src.read_block(timeout=5.0))
            assert pend["fft_pending"] == [] and list(pend["bank_pending"]) == ["pfbi:ssb"]
            rt._complete_block(pend)
        finally:
            src.stop()

    def test_bank_added_between_dispatch_and_complete(self):
        rt, src = _make_runtime([{"kind": "usb", "offset_hz": 48_500.0,
                                  "f_audio": 900.0, "amplitude": 0.4}])
        got = {"a": 0, "b": 0}
        a = rt.open_channel("usb", 48_500.0)
        a.audio_cb = lambda w, hd=False: got.__setitem__("a", got["a"] + 1)
        try:
            src.start()
            pend = rt._dispatch_block(src.read_block(timeout=5.0))
            b = rt.open_channel("am", -96_000.0)
            b.audio_cb = lambda w, hd=False: got.__setitem__("b", got["b"] + 1)
            rt._complete_block(pend)
            assert got == {"a": 1, "b": 0}
            rt._process_block(src.read_block(timeout=5.0))
            assert got == {"a": 2, "b": 1}
        finally:
            src.stop()

    def test_uint8_wire_block_through_runtime(self):
        rt, src = _make_runtime([{"kind": "usb", "offset_hz": 48_500.0,
                                  "f_audio": 1000.0, "amplitude": 0.4}])
        frames = []
        h = rt.open_channel("usb", 48_500.0)
        h.audio_cb = lambda wire, hd=False: frames.append(wire)
        try:
            src.start()
            for _ in range(6):
                blk = src.read_block(timeout=5.0)
                packed = np.stack([blk.real, blk.imag], axis=-1)
                rt._process_block(np.clip(packed * 128.0 + 127.4, 0, 255).astype(np.uint8))
        finally:
            src.stop()
        pcm = decode_wire(frames)
        assert len(pcm) >= 3000
        assert tone_power_ratio(pcm[1200:], 1000.0) > -6.0

    def test_parameters_set_after_dispatch_leave_the_block(self):
        """A retune, a new slot and a passband change between dispatch and
        complete do not change the dispatched block's audio."""
        blocks = []
        src = _source([{"kind": "usb", "offset_hz": 48_500.0, "f_audio": 1000.0,
                        "amplitude": 0.4}])
        src.block_size = DeviceRuntime(src, target_seconds=0.05, device=CPU).block
        src.start()
        try:
            blocks = [src.read_block(timeout=5.0) for _ in range(2)]
        finally:
            src.stop()
        out = {}
        for churn in (False, True):
            rt = DeviceRuntime(_source([]), capacity=8, target_seconds=0.05,
                               host=HOST, device=CPU)
            frames = []
            h = rt.open_channel("usb", 48_500.0)
            e = rt.open_channel("usb", 11_800.0)          # full rate
            h.audio_cb = lambda w, hd=False: frames.append(w)
            e.audio_cb = lambda w, hd=False: frames.append(w)
            pend = [rt._dispatch_block(b) for b in blocks]
            if churn:
                h.set_offset(48_900.0)
                h.set_bandpass(500.0, 2500.0)
                e.set_squelch(20.0)
                e.set_nr(6.0)
                rt.open_channel("usb", 48_600.0)
            for p in pend:
                rt._complete_block(p)
            out[churn] = frames
        assert out[True] == out[False] and len(out[False]) == 4


# ------------------------------------------------------- secondary banks --
FS = 48000.0


def varicode_encode(text):
    from openwebrx_tpu.digimodes import psk as pskmod
    bits = []
    for ch in text:
        bits.extend(int(b) for b in pskmod._VARICODE[ord(ch)])
        bits.extend([0, 0])
    return bits


def psk31_iq(text, f0, amplitude=0.4):
    baud = 31.25
    bits = [0] * 24 + varicode_encode(text) + [0] * 16
    phases = [1.0]
    for b in bits:
        phases.append(phases[-1] * (1.0 if b else -1.0))
    sym = np.repeat(phases, int(FS / baud))
    n = np.arange(len(sym))
    return (amplitude * sym * np.exp(2j * np.pi * f0 / FS * n)).astype(np.complex64)


def _sec_runtime(rate=FS):
    return types.SimpleNamespace(in_rate=rate, device=CPU, host=HOST)


class TestSecondaryBank:
    def test_two_listeners_one_program(self):
        runtime = _sec_runtime()
        bank = SecondaryBank(runtime, "bpsk31", capacity=2)
        a = SecondaryHandle(runtime, "bpsk31", 1200.0, bank)
        b = SecondaryHandle(runtime, "bpsk31", 3000.0, bank)
        assert a.bank is b.bank and a.bank.program is b.bank.program
        assert a.slot != b.slot
        got = {"a": [], "b": []}
        a.text_cb, b.text_cb = got["a"].append, got["b"].append
        xa, xb = psk31_iq("cq de alpha", 1200.0), psk31_iq("cq de bravo", 3000.0)
        x = np.zeros(max(len(xa), len(xb)), np.complex64)
        x[:len(xa)] += xa
        x[:len(xb)] += xb
        for i in range(0, len(x), 1 << 14):
            bank.feed(x[i:i + (1 << 14)])
        ta, tb = "".join(got["a"]), "".join(got["b"])
        assert "cq de alpha" in ta and "cq de bravo" in tb, (ta, tb)
        assert "bravo" not in ta and "alpha" not in tb

    def test_fft_rows_equal_compress_fft_rows(self):
        """The secondary FFT rows a handle receives (encoded where the
        chain ran) equal the reference codec's bytes of the chain's rows."""
        from openwebrx_tpu.ops.adpcm import compress_fft_rows as jax_compress
        runtime = _sec_runtime()
        bank = SecondaryBank(runtime, "bpsk31", capacity=1)
        h = SecondaryHandle(runtime, "bpsk31", 1500.0, bank)
        rows = []
        h.fft_cb = rows.append
        x = psk31_iq("test", 1500.0)[: 2 * bank.block]
        direct = Program(SecondaryBank(runtime, "bpsk31", capacity=1).chain,
                         StreamSpec(Format.COMPLEX_FLOAT, FS), bank.block,
                         batch_shape=(1,), device=CPU)
        direct.chain.selector.shift.set_rate(np.array([-1500.0 / FS], np.float32))
        direct.chain.fine_shift.set_rate(np.zeros(1, np.float32))
        want = []
        for blk in np.split(x, 2):
            bank.feed(blk)
            _, aux = direct.process(blk)
            want += jax_compress(aux["secondary_fft.rows"][0])
        assert rows == want and len(rows) >= 2
        assert set(map(len, rows)) == {(2048 + 10 + 1) // 2}

    def test_grow_recompiles_and_keeps_members(self):
        runtime = _sec_runtime()
        bank = SecondaryBank(runtime, "bpsk31", capacity=1)
        a = SecondaryHandle(runtime, "bpsk31", 1000.0, bank)
        prog1 = bank.program
        b = SecondaryHandle(runtime, "bpsk31", 2000.0, bank)
        assert bank.capacity == 2 and bank.program is not prog1
        assert bank.members[a.slot] is a and bank.members[b.slot] is b
        bank.detach(a)
        bank.detach(b)
        assert bank._active.sum() == 0

    def test_runtime_shares_bank_across_open_secondary(self):
        props = PropertyLayer(samp_rate=240000, center_freq=14_100_000,
                              throttle=False, noise=1e-4, signals=[])
        rt = DeviceRuntime(SignalSource("secbank", props), capacity=4,
                           target_seconds=0.05, host=HOST, device=CPU)
        h1 = rt.open_secondary("bpsk31", 1000.0)
        h2 = rt.open_secondary("bpsk31", 2000.0)
        h3 = rt.open_secondary("rtty170", 1500.0)
        assert h1.bank is h2.bank and h3.bank is not h1.bank
        assert set(rt.secondary_banks) == {"bpsk31", "rtty170"}
        assert rt.secondary_handles.count(h1.bank) == 1
        rt.release_secondary(h1)
        assert "bpsk31" in rt.secondary_banks
        rt.release_secondary(h2)
        assert "bpsk31" not in rt.secondary_banks
        assert h1.bank not in rt.secondary_handles

    def test_missing_host_name_is_named_when_opened(self):
        rt = DeviceRuntime(_source([], rate=240000), target_seconds=0.05,
                           host=types.SimpleNamespace(RttyFramer=HOST.RttyFramer),
                           device=CPU)
        with pytest.raises(LookupError, match="VaricodeDecoder, dbpsk_bits"):
            rt.open_secondary("bpsk31", 1000.0)
        assert "bpsk31" not in rt.secondary_banks and rt.secondary_handles == []
        rt.open_secondary("rtty170", 1500.0)
        ch = rt.open_channel("usb", 20_000.0)          # channels need no host
        with pytest.raises(LookupError, match="RdsDecoder"):
            ch.rds_cb = print
        with pytest.raises(LookupError, match="SubprocessPipeline"):
            ExecAudioHandle(rt, "freedv", 0.0, command_override=["cat"])

    def test_default_device_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceRuntime(_source([]))


# ------------------------------------------- digital voice and exec audio --
class TestDigitalVoiceAndExec:
    def test_native_dstar_header_from_iq(self):
        """2-level FSK IQ of a D-Star header → the port's symbol chain →
        the host header decoder → callsign metadata (pipeline: cat)."""
        sys.path.insert(0, "tests")
        from test_digital_voice import FS as DV_FS, c4fm_waveform
        from openwebrx_tpu.digimodes import dstar
        rng = np.random.default_rng(21)
        bits = np.concatenate([rng.integers(0, 2, 128).astype(np.uint8),
                               dstar.SYNC, dstar.header_encode("KD8XYZ", ur="CQCQCQ")])
        dibits = np.concatenate([(bits << 1)] * 3)
        x = c4fm_waveform(dibits, baud=4800.0, dev_hz=1200.0, rrc_alpha=0.5)
        runtime = types.SimpleNamespace(in_rate=DV_FS, device=CPU, host=HOST,
                                        _lock=threading.RLock(), secondary_handles=[])
        handle = DigitalVoiceHandle(runtime, "dstar", 0.0, command_override=["cat"])
        assert runtime.secondary_handles == [handle]
        metas = []
        handle.meta_cb = metas.append
        try:
            n = len(x) // handle.block
            for blk in np.split(x[: n * handle.block], n):
                handle.feed(blk)
        finally:
            handle.pipeline.close()
        hdrs = [m for m in metas if m.get("source")]
        assert hdrs and hdrs[0]["source"] == "KD8XYZ" and hdrs[0]["protocol"] == "DSTAR"

    @pytest.mark.parametrize("wire", ["cs16", "cf32"])
    def test_iq_wire_bytes(self, wire):
        """An IQ tap's wire bytes are the reference's encoding of its IQ:
        the same Selector run directly, then interleaved int16 at ±32767
        (clipped) or complex64 bytes."""
        from openwebrx_tpu_torch.models.selector import Selector
        rt = DeviceRuntime(_source([], rate=240000), target_seconds=0.1, host=HOST,
                           device=CPU)
        tap = rt.open_iq_channel(48000, 12_000.0, wire)
        got = []
        tap.iq_cb = got.append
        chain = Selector(240000.0, 48000.0, with_squelch=False)
        chain.set_frequency_offset(12_000.0)
        direct = Program(chain, StreamSpec(Format.COMPLEX_FLOAT, 240000.0), tap.block,
                         device=CPU)
        rng = np.random.default_rng(8)
        n = np.arange(2 * tap.block)
        x = (1.5 * np.exp(2j * np.pi * 12_500.0 / 240000.0 * n)
             + 0.1 * (rng.standard_normal(len(n)) + 1j * rng.standard_normal(len(n)))
             ).astype(np.complex64)          # clips: |x| reaches past full scale
        for part in np.split(x, 3):          # blocks of another size than the tap's
            tap.feed(part)
        want = []
        for blk in np.split(x, 2):
            iq, _ = direct.process(blk)
            if wire == "cs16":
                inter = np.empty(2 * len(iq), np.int16)
                scaled = np.clip(iq * 32767.0, -32768, 32767)
                inter[0::2] = scaled.real.astype(np.int16)
                inter[1::2] = scaled.imag.astype(np.int16)
                want.append(inter.tobytes())
            else:
                want.append(iq.astype(np.complex64).tobytes())
        assert got == want and tap in rt.secondary_handles

    def test_exec_audio_fake_decoder_roundtrip(self, tmp_path):
        """cs16 IQ from the runtime's loop → a fake decoder script → s16
        audio back (threaded, 30 s deadline)."""
        script = tmp_path / "fake_dream"
        script.write_text(
            "#!/usr/bin/env python3\n"
            "import sys\n"
            "while True:\n"
            "    data = sys.stdin.buffer.read(4096)\n"
            "    if not data:\n"
            "        break\n"
            "    sys.stdout.buffer.write(b'\\x34\\x12' * 256)\n"
            "    sys.stdout.buffer.flush()\n")
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
        src = _source([], noise=1e-3, rate=240000, name="exec-audio")
        rt = DeviceRuntime(src, capacity=4, target_seconds=0.1, host=HOST, device=CPU)
        audio = []
        handle = ExecAudioHandle(rt, "drm", 10000.0, command_override=[str(script)])
        handle.audio_cb = lambda data, hd: audio.append(data)
        rt.start()
        try:
            deadline = time.time() + 30
            while not audio and time.time() < deadline:
                time.sleep(0.2)
        finally:
            handle.close()
            rt.stop()
            src.stop()
        assert audio and np.frombuffer(audio[0], np.int16)[0] == 0x1234

    def test_m17_metadata_beside_external_decoder(self, tmp_path):
        """The M17 exec handle feeds the same cs16 IF stream to the
        subprocess and to the native link layer: callsigns arrive with the
        binary stubbed."""
        from openwebrx_tpu.digimodes import m17
        sys.path.insert(0, "tests")
        from test_digital_voice import c4fm_waveform
        sink = tmp_path / "sink"
        sink.write_text("#!/bin/sh\ncat > /dev/null\n")
        sink.chmod(sink.stat().st_mode | stat.S_IEXEC)
        src = _source([], noise=1e-3, rate=240000, name="m17-exec")
        rt = DeviceRuntime(src, capacity=4, target_seconds=0.1, host=HOST, device=CPU)
        handle = ExecAudioHandle(rt, "m17", 0.0, command_override=[str(sink)])
        assert isinstance(handle._m17_tap, M17MetaTap)
        metas = []
        handle.meta_cb = metas.append
        try:
            frame = m17.build_lsf_frame("N0CALL", "SP5WWP")
            idle = np.random.default_rng(5).integers(0, 4, 150).astype(np.uint8)
            x = c4fm_waveform(np.concatenate([idle, frame, frame, frame, idle]),
                              baud=4800.0, dev_hz=800.0, fs=M17MetaTap.IF_RATE,
                              rrc_alpha=0.5)
            inter = np.empty(2 * len(x), np.int16)
            inter[0::2] = np.clip(x.real * 32767, -32768, 32767)
            inter[1::2] = np.clip(x.imag * 32767, -32768, 32767)
            handle.iq.iq_cb(inter.tobytes())
            deadline = time.time() + 10
            while not metas and time.time() < deadline:
                time.sleep(0.1)
        finally:
            handle.close()
            src.stop()
        lsfs = [m for m in metas if m.get("source")]
        assert lsfs and lsfs[0]["source"] == "SP5WWP" and lsfs[0]["protocol"] == "M17"


# ------------------------------------------------ parity with the reference --
ROUTING_SCRIPT = [
    ("open", "a", "usb", 48_500.0, False),      # pfbi:ssb
    ("open", "b", "usb", 48_700.0, False),      # the same PFB channel
    ("open", "c", "usb", 11_800.0, False),      # straddles an edge: full rate
    ("open", "d", "usb", 96_500.0, True),       # pfb:ssb service
    ("open", "e", "nfm", -190_000.0, False),    # pfbi:nfm, wider slices
    ("open", "f", "am", 11_800.0, True),        # svc:am edge dial
    ("open", "g", "wfm", 400_000.0, False),     # WFM: the filterbank or full rate
    ("retune", "a", 49_000.0),                  # within its channel
    ("retune", "a", 11_900.0),                  # across an edge → full rate
    ("retune", "a", 48_500.0),                  # re-admitted
    ("retune", "c", 72_400.0),                  # full rate → re-admitted
    ("retune", "d", 11_800.0),                  # service → svc:ssb
    ("retune", "d", 12_100.0),                  # fails the 0.35 margin: stays
    ("retune", "d", 120_400.0),                 # re-admitted to pfb:ssb
    ("mode", "b", "lsb"),                       # same bucket, PFB
    ("mode", "e", "am"),                        # another bucket's filterbank
    ("mode", "c", "nfm"),
    ("mode", "f", "usb"),                       # service switch
    ("release", "b"),
    ("open", "h", "usb", 48_500.0, False),
    ("mode", "g", "usb"),
    ("release", "a"),
    ("release", "e"),
]


def _route(rt, handle):
    bank = rt.banks[handle.bucket_key]
    chan = int(bank._chan[handle.slot]) if handle.bucket_key.startswith(("pfb:", "pfbi:")) \
        and handle.slot is not None else None
    return handle.bucket_key, handle.slot, chan


class TestParityWithJax:
    @pytest.mark.parametrize("rate,target", [(3.072e6, 0.05), (8.192e6, 0.1)])
    def test_routing_decisions_match_jax(self, rate, target):
        """The same script through both runtimes: the same block plan, the
        same per-bucket channel counts, and after every step the same
        (bucket_key, slot, PFB channel) for every open handle."""
        rts = {}
        for side, cls in (("jax", JaxRuntime), ("port", DeviceRuntime)):
            kw = {} if side == "jax" else {"host": HOST, "device": CPU}
            rts[side] = cls(_source([], rate=rate, name=f"route-{side}"),
                            capacity=8, target_seconds=target, **kw)
        jrt, trt = rts["jax"], rts["port"]
        assert trt.block == jrt.block
        assert trt.available_buckets == jrt.available_buckets
        for bucket in BUCKET_CHAIN_MODE:
            assert trt._pfb_m_for(bucket) == jrt._pfb_m_for(bucket), bucket
        handles = {"jax": {}, "port": {}}
        for step in ROUTING_SCRIPT:
            for side, rt in rts.items():
                hs = handles[side]
                if step[0] == "open":
                    _, name, mode, dial, service = step
                    hs[name] = rt.open_channel(mode, dial, service=service)
                elif step[0] == "retune":
                    hs[step[1]].set_offset(step[2])
                elif step[0] == "mode":
                    hs[step[1]].set_mode(step[2])
                else:
                    hs.pop(step[1]).close()
            got = {n: _route(trt, h) for n, h in handles["port"].items()}
            want = {n: _route(jrt, h) for n, h in handles["jax"].items()}
            assert got == want, step
        assert trt._pfbi_infeasible == jrt._pfbi_infeasible
        assert set(trt.banks) == set(jrt.banks)

    def test_runtime_output_equals_banks_fed_directly(self):
        """Audio of a PFB listener, a PFB service (6-block deliveries) and
        a full-rate edge listener, and the waterfall payloads, are
        bit-identical to the port's banks and FftChain program fed the
        same blocks directly."""
        sig = [{"kind": "usb", "offset_hz": 48_500.0, "f_audio": 1000.0, "amplitude": 0.4},
               {"kind": "usb", "offset_hz": 11_800.0, "f_audio": 1500.0, "amplitude": 0.4}]
        rt, src = _make_runtime(sig, fft_size=1024)
        got = {"pfbi": [], "pfb": [], "full": [], "wf": []}
        for key, dial, service in (("pfbi", 48_500.0, False), ("pfb", 96_500.0, True),
                                   ("full", 11_800.0, False)):
            h = rt.open_channel("usb", dial, service=service)
            h.audio_cb = lambda w, hd=False, key=key: got[key].append(w)
        rt.subscribe_waterfall(got["wf"].append)
        assert [h.bucket_key for h in rt.handles] == ["pfbi:ssb", "pfb:ssb", "ssb"]
        src.start()
        try:
            blocks = [src.read_block(timeout=5.0) for _ in range(6)]
        finally:
            src.stop()
        for b in blocks:
            rt._process_block(b)

        lo, hi = MODE_BANDPASS["usb"]
        want = {k: [] for k in got}
        pfbi = ChannelizedBank(RATE, 128, "usb", compression="adpcm", block=rt.block,
                               capacity=64, device=CPU)
        pfb = ChannelizedBank(RATE, 128, "usb", compression="none", block=rt.block,
                              capacity=64, delivery_stride=6, device=CPU)
        full = ChannelBank(RATE, "usb", capacity=8, compression="adpcm",
                           block=rt.block, device=CPU)
        slots = {"pfbi": pfbi.assign(48_500.0), "pfb": pfb.assign(96_500.0),
                 "full": full.add_channel(11_800.0)}
        for bank, key in ((pfbi, "pfbi"), (pfb, "pfb"), (full, "full")):
            bank.set_bandpass(slots[key], lo, hi)
        framers = {"pfbi": SyncFramer(), "full": SyncFramer()}
        wf = Program(FftChain(1024, 9.0, compress=True),
                     StreamSpec(Format.COMPLEX_FLOAT, RATE), rt.block, device=CPU)
        nb = wf.chain.waterfall.wire_bytes_per_row
        for b in blocks:
            for key, bank in (("pfbi", pfbi), ("full", full)):
                (data, strides), _ = bank.process(b)
                want[key].append(framers[key].frame(data[slots[key]], strides[slots[key]]))
            y, _ = pfb.process(b)
            want["pfb"].append(y[slots["pfb"]].tobytes())
            rows, _ = wf.process(b)
            want["wf"] += [r[:nb].tobytes() for r in rows]
        assert len(got["pfb"]) == 6 and len(got["wf"]) == 6
        for key in got:
            assert got[key] == want[key], key
        assert tone_power_ratio(decode_wire(got["pfbi"])[1200:], 1000.0) > -6.0

    def test_tone_snr_matches_jax_runtime(self):
        """One USB tone listener through the JAX runtime and the port's, on
        the same blocks: the decoded tones' SNR within SNR_DB_TOL."""
        sig = [{"kind": "usb", "offset_hz": 48_500.0, "f_audio": 1000.0, "amplitude": 0.4}]
        snr = {}
        for side, cls in (("jax", JaxRuntime), ("port", DeviceRuntime)):
            kw = {} if side == "jax" else {"host": HOST, "device": CPU}
            src = _source(sig, name=f"snr-{side}")
            rt = cls(src, capacity=8, target_seconds=0.05, **kw)
            frames = []
            h = rt.open_channel("usb", 48_500.0)
            assert h.bucket_key == "pfbi:ssb"
            h.audio_cb = lambda w, hd=False: frames.append(w)
            try:
                _pump(rt, src, 10)
            finally:
                src.stop()
            snr[side] = tone_power_ratio(decode_wire(frames)[1200:], 1000.0)
        assert snr["port"] > -6.0
        assert abs(snr["port"] - snr["jax"]) <= SNR_DB_TOL, snr
