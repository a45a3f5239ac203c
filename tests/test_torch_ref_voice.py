"""The reference's own digital-voice and external-decoder tests that run the
device path, carried onto the port: tests/test_digital_voice.py,
test_dmr_ysf.py, test_dstar.py, test_nxdn.py, test_m17.py, test_meta.py,
test_exec_meta.py and test_exec_audio.py.

Each reference file is one outer class here, named after it
(``test_dmr_ysf.py`` → ``TestDmrYsf``), holding the reference's classes and
cases under their own names, with the reference's inputs, seeds, assertions
and bounds; metadata is decoded by the port's own host decoders.  Only what
the port's API forces differs: the fake runtime ``DigitalVoiceHandle`` is
given carries the port's ``device`` and ``host`` (``PORT_HOST``),
``Program``, ``M17MetaTap`` and ``DeviceRuntime`` get ``device=``, the
slicer's input is a tensor on the case's device, and the sources and
property layers are the port's.  Every case runs on ``device`` "cpu" (the
plain versions) and "cuda" (the card; the ``cuda`` marker, skipped without
a card).  The file imports no jax and nothing of ``openwebrx_tpu``.

The reference's DMR, D-Star, NXDN and M17 files draw their idle symbols
from one module-level generator (seeds 42, 21, 31 and 11); a case here
starts its own generator from that seed, which is what the reference case
gets when it runs alone.  ``c4fm_waveform`` is tests/test_digital_voice.py's.

Reference cases left out, each because it runs no device code of the port
(tests/test_torch_ref_coverage.py keeps this list; the host modules they
test are held to the reference by tests/test_torch_host_copy.py):

* test_digital_voice.py ``TestDvChain::test_chain_modes_present``: the
  factory's keys and a chain's class, no tensor.
* test_dmr_ysf.py: ``TestFec`` (6), ``TestBptc`` (1), ``TestDmrDecoder``
  (3), ``TestYsf`` (4), ``TestSyncOrdering`` (1), ``TestEmbeddedLc`` (3) and
  ``test_embedded_lc_dedup_with_color_code``: the host frame layer fed
  dibits.
* test_dstar.py: ``TestHeader`` (5), ``TestStream`` (3),
  ``TestCutTransmission`` (1): the host frame layer fed bits.
* test_nxdn.py: ``TestCodes`` (3), ``TestStream`` ``test_vcall_ids_across_
  superframe`` and ``test_tx_release_ends_call``, ``TestSuperframeIsolation``
  (1): the host frame layer fed dibits.
* test_m17.py: ``TestCallsigns`` (2), ``TestLsf`` (3), ``TestLich`` (2),
  ``TestStream`` (2): the host link layer fed dibits.
* test_meta.py ``TestMetaParser`` (5): the host metadata parser.
* test_exec_meta.py ``TestDrmStatusMonitor`` (1), ``TestDabMeta`` (3),
  ``TestHdrMeta`` (1) and ``TestExecHandleMetaIntegration::
  test_pipeline_stderr_feeds_dab_parser``: host parsers and a subprocess.
"""

import socket
import stat
import threading
import time
import types

import numpy as np
import torch

from openwebrx_tpu_torch.core.property import PropertyLayer
from openwebrx_tpu_torch.digimodes import dmr, dstar, m17, nxdn
from openwebrx_tpu_torch.models.digital_voice import DV_FACTORY
from openwebrx_tpu_torch.models.stages import plan_block_size
from openwebrx_tpu_torch.ops import fsk
from openwebrx_tpu_torch.ops.firdes import root_raised_cosine_taps
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.chain import Program
from openwebrx_tpu_torch.runtime.device import (
    PORT_HOST, DeviceRuntime, DigitalVoiceHandle, ExecAudioHandle, M17MetaTap)
from openwebrx_tpu_torch.sources.file import SignalSource
from torch_ref_device import card_report, device  # noqa: F401  (fixtures)

FS = 240000.0  # device rate (decimates to the 48 kHz DV IF)


def c4fm_waveform(dibits, baud=4800.0, dev_hz=648.0, fs=FS, offset_hz=0.0,
                  rrc_alpha=0.2):
    """4FSK at ±dev, ±3·dev with transmitter RRC pulse shaping (C4FM per
    ETSI TS 102 361-1: the frequency pulses are RRC-shaped, so the
    receiver's matched RRC yields an ISI-free raised-cosine eye)."""
    level = {0b00: 1.0, 0b01: 3.0, 0b10: -1.0, 0b11: -3.0}
    sps = int(fs / baud)
    impulses = np.zeros(len(dibits) * sps)
    impulses[::sps] = [level[d] for d in dibits]
    taps = root_raised_cosine_taps(sps, rrc_alpha)
    taps = taps * sps / taps.sum()  # unit gain for an impulse-per-symbol train
    freqs = np.convolve(impulses, taps, mode="same") * dev_hz
    phase = 2 * np.pi * np.cumsum(freqs + offset_hz) / fs
    return (0.5 * np.exp(1j * phase)).astype(np.complex64)


def run_chain(chain, x, device):
    spec = StreamSpec(Format.COMPLEX_FLOAT, FS)
    block = plan_block_size(chain, spec, 0.1)
    prog = Program(chain, spec, block, device=device)
    outs = []
    n = len(x) // block
    for blk in np.split(x[: n * block], n):
        y, _ = prog.process(blk)
        outs.append(np.asarray(y))
    return np.concatenate(outs)


def fake_runtime(device):
    """The reference's fake runtime, with the port's device and host."""
    return types.SimpleNamespace(in_rate=FS, _lock=threading.RLock(),
                                 secondary_handles=[], device=device,
                                 host=PORT_HOST)


def run_handle(handle, x):
    """Feed whole handle blocks; close the vocoder pipeline after."""
    metas = []
    handle.meta_cb = metas.append
    try:
        n = len(x) // handle.block
        for blk in np.split(x[: n * handle.block], n):
            handle.feed(blk)
    finally:
        handle.pipeline.close()
    return metas


def executable(path, text):
    path.write_text(text)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return path


# ------------------------------------------------------ tests/test_digital_voice.py
def _slice(y, device):
    return fsk.fsk4_slice(torch.as_tensor(y, device=device)).cpu().numpy()


class TestDigitalVoice:
    class TestFsk4Slice:
        def test_levels_map_to_dibits(self, device):
            y = np.array([3.0, 1.0, -1.0, -3.0, 2.9, -0.9], np.float32)
            out = _slice(y, device)
            assert list(out) == [0b01, 0b00, 0b10, 0b11, 0b01, 0b10]

        def test_scale_invariance(self, device):
            rng = np.random.default_rng(1)
            dibits = rng.integers(0, 4, 500)
            level = np.array([1.0, 3.0, -1.0, -3.0])[dibits]
            for gain in (0.01, 1.0, 250.0):
                out = _slice((level * gain).astype(np.float32), device)
                assert np.array_equal(out, _slice(level.astype(np.float32), device))

    class TestDvChain:
        def _run(self, mode, baud, dev, device):
            rng = np.random.default_rng(7)
            dibits = rng.integers(0, 4, 2400)
            x = c4fm_waveform(dibits, baud=baud, dev_hz=dev)
            chain = DV_FACTORY[mode](FS)
            chain.set_frequency_offset(0.0)
            out = run_chain(chain, x, device)
            # the chain is causal (selector bandpass + RRC group delay ≈ 35
            # symbols), so the output LAGS the transmitted dibits: align by
            # trimming the head of `out`.  score past the filter warm-up.
            best = 0.0
            for lag in range(0, 80):
                b = out[lag:]
                n = min(len(dibits), len(b))
                if n < 500:
                    continue
                agree = np.mean(dibits[200:n] == b[200:n])
                best = max(best, agree)
            return best

        def test_dmr_symbols_recovered(self, device):
            agree = self._run("dmr", 4800.0, 648.0, device)
            assert agree > 0.95, f"symbol agreement {agree:.3f}"

        def test_nxdn_symbols_recovered(self, device):
            agree = self._run("nxdn", 2400.0, 350.0, device)
            assert agree > 0.95, f"symbol agreement {agree:.3f}"


# ------------------------------------------------------------ tests/test_dmr_ysf.py
class TestDmrYsf:
    class TestEndToEnd:
        def test_native_dmr_metadata_from_c4fm_iq(self, device):
            """Full path: C4FM IQ → symbol chain → native DMR frame layer
            → talkgroup metadata, no external binary.  The vocoder pipeline
            is stubbed with `cat`."""
            rng = np.random.default_rng(42)
            info = dmr.encode_lc(flco=0, fid=0, opts=0, dest=91, src=3100123,
                                 data_type="voice_lc_header")
            burst = dmr.build_burst("voice_lc_header", info, color_code=1)
            idle = rng.integers(0, 4, 200).astype(np.uint8)
            stream = np.concatenate([idle, burst, burst, burst, burst, idle])
            x = c4fm_waveform(stream, baud=4800.0, dev_hz=648.0)

            handle = DigitalVoiceHandle(fake_runtime(device), "dmr", 0.0,
                                        command_override=["cat"])
            metas = run_handle(handle, x)
            lcs = [m for m in metas if m.get("target")]
            assert lcs, f"no native LC metadata: {metas}"
            assert lcs[0]["target"] == 91
            assert lcs[0]["source"] == 3100123


# -------------------------------------------------------------- tests/test_dstar.py
class TestDstar:
    class TestEndToEnd:
        def test_native_dstar_header_from_iq(self, device):
            """2-level FSK IQ of a D-Star header → symbol chain → native
            header decode → callsign metadata through DigitalVoiceHandle
            (no external binary)."""
            rng = np.random.default_rng(21)
            bits = np.concatenate([
                rng.integers(0, 2, 128).astype(np.uint8),
                dstar.SYNC, dstar.header_encode("KD8XYZ", ur="CQCQCQ")])
            # bit → 2-level dibit (0 → +1 ↔ 0b00, 1 → −1 ↔ 0b10); repeat the
            # whole thing 3× so the timing estimator has runway
            dibits = np.concatenate([(bits << 1), (bits << 1), (bits << 1)])
            x = c4fm_waveform(dibits, baud=4800.0, dev_hz=1200.0,
                              rrc_alpha=0.5)
            handle = DigitalVoiceHandle(fake_runtime(device), "dstar", 0.0,
                                        command_override=["cat"])
            metas = run_handle(handle, x)
            hdrs = [m for m in metas if m.get("source")]
            assert hdrs, f"no header decoded: {metas}"
            assert hdrs[0]["source"] == "KD8XYZ"
            assert hdrs[0]["protocol"] == "DSTAR"


# --------------------------------------------------------------- tests/test_nxdn.py
class TestNxdn:
    class TestStream:
        def test_native_nxdn_from_c4fm_iq(self, device):
            """4FSK IQ at 2400 baud → symbol chain → native NXDN layer →
            unit IDs, through DigitalVoiceHandle (no binary)."""
            rng = np.random.default_rng(31)
            segs = nxdn.vcall_segments(src=42, dst=777)
            frames = []
            for st, pl in segs:
                f = nxdn.build_frame(0x40, st, pl)
                # random voice payload: a constant zeroed field starves the
                # adaptive 4FSK slicer of the outer levels
                f[48:] = rng.integers(0, 4, len(f) - 48)
                frames.append(f)
            idle = rng.integers(0, 4, 120).astype(np.uint8)
            stream = np.concatenate([idle] + frames + frames + [idle])
            x = c4fm_waveform(stream, baud=2400.0, dev_hz=350.0,
                              rrc_alpha=0.2)
            handle = DigitalVoiceHandle(fake_runtime(device), "nxdn", 0.0,
                                        command_override=["cat"])
            metas = run_handle(handle, x)
            calls = [m for m in metas if m.get("type") == "vcall"]
            assert calls, f"no VCALL decoded: {metas}"
            assert calls[0]["source"] == 42 and calls[0]["target"] == 777


# ---------------------------------------------------------------- tests/test_m17.py
def m17_cs16(x):
    """complex64 → the interleaved int16 IQ wire bytes."""
    interleaved = np.empty(2 * len(x), np.int16)
    interleaved[0::2] = np.clip(x.real * 32767, -32768, 32767)
    interleaved[1::2] = np.clip(x.imag * 32767, -32768, 32767)
    return interleaved.tobytes()


class TestM17:
    class TestEndToEnd:
        def test_native_m17_metadata_from_c4fm_iq(self, device):
            """C4FM IQ of an LSF frame at the 48 kHz IF → cs16 wire bytes →
            symbol chain → native M17 link layer → callsign metadata."""
            rng = np.random.default_rng(11)
            frame = m17.build_lsf_frame("N0CALL", "SP5WWP")
            idle = rng.integers(0, 4, 150).astype(np.uint8)
            stream = np.concatenate([idle, frame, frame, frame, idle])
            x = c4fm_waveform(stream, baud=4800.0, dev_hz=800.0,
                              fs=M17MetaTap.IF_RATE, rrc_alpha=0.5)

            metas = []
            tap = M17MetaTap(metas.append, device=device)
            wire = m17_cs16(x)
            step = 4096 * 4
            for i in range(0, len(wire), step):
                tap.feed_cs16(wire[i:i + step])
            lsfs = [m for m in metas if m.get("source")]
            assert lsfs, f"no LSF decoded: {metas}"
            assert lsfs[0]["source"] == "SP5WWP"
            assert lsfs[0]["target"] == "N0CALL"


# --------------------------------------------------------------- tests/test_meta.py
def signal_source(name, center_freq):
    props = PropertyLayer(samp_rate=240000, center_freq=center_freq,
                          throttle=False, noise=1e-3, signals=[])
    return SignalSource(name, props)


class TestMeta:
    class TestDigitalVoiceHandle:
        def test_dibits_to_decoder_and_meta_back(self, tmp_path, device):
            """Fake decoder echoes dibit count as audio and writes one meta
            JSON line to the side fd — full DigitalVoiceHandle loop."""
            script = executable(
                tmp_path / "fake_dmr",
                "#!/usr/bin/env python3\n"
                "import json, os, sys\n"
                "meta_fd = int(sys.argv[1])\n"
                "data = sys.stdin.buffer.read(480)\n"
                "os.write(meta_fd, (json.dumps({'protocol': 'DMR',\n"
                "    'talkeralias': 'KN4CRD'}) + '\\n').encode())\n"
                "sys.stdout.buffer.write(b'\\x01\\x02' * len(data))\n"
                "sys.stdout.flush()\n"
                "sys.stdin.buffer.read()\n")
            src = signal_source("dv-test", 439000000)
            rt = DeviceRuntime(src, capacity=4, target_seconds=0.1, device=device)
            audio, metas = [], []
            handle = DigitalVoiceHandle(
                rt, "dmr", 0.0,
                command_override=[str(script), "{meta_fd}"])
            handle.audio_cb = lambda data, hd: audio.append(data)
            handle.meta_cb = metas.append
            rt.start()
            try:
                deadline = time.time() + 15
                while (not audio or not metas) and time.time() < deadline:
                    time.sleep(0.1)
            finally:
                handle.close()
                rt.stop()
                src.stop()
            assert audio, "no audio back from decoder"
            assert metas and metas[0]["talkeralias"] == "KN4CRD"


# ---------------------------------------------------------- tests/test_exec_meta.py
FAKE_DREAM = ("#!/usr/bin/env python3\n"
              "import sys\n"
              "while True:\n"
              "    data = sys.stdin.buffer.read(4096)\n"
              "    if not data:\n"
              "        break\n"
              "    sys.stdout.buffer.write(b'\\x34\\x12' * {n})\n"
              "    sys.stdout.buffer.flush()\n")


class TestExecMeta:
    class TestExecHandleMetaIntegration:
        def test_stub_drm_socket_feeds_meta_panel(self, tmp_path, device):
            """End-to-end through ExecAudioHandle: a stub 'dream' plus a
            status-socket server drive {"mode": "DRM"} metadata to meta_cb."""
            script = executable(tmp_path / "fake_dream", FAKE_DREAM.replace("{n}", "64"))
            src = signal_source("exec-meta", 6000000)
            rt = DeviceRuntime(src, capacity=4, target_seconds=0.1, device=device)
            metas, audio = [], []
            handle = ExecAudioHandle(rt, "drm", 0.0,
                                     command_override=[str(script)])
            handle.meta_cb = metas.append
            handle.audio_cb = lambda data, hd: audio.append(data)
            # the monitor polls the socket path ExecAudioHandle allocated —
            # stand in for dream 2.2's --status-socket server
            server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            server.bind(handle._drm_socket_path)
            server.listen(1)

            def serve():
                conn, _ = server.accept()
                conn.sendall(b'{"mode": "B", "snr": 21.0, '
                             b'"service": "TPU DRM"}\n')
                time.sleep(0.5)
                conn.close()

            threading.Thread(target=serve, daemon=True).start()
            rt.start()
            try:
                deadline = time.time() + 15
                while (not metas or not audio) and time.time() < deadline:
                    time.sleep(0.2)
            finally:
                handle.close()
                rt.stop()
                src.stop()
                server.close()
            assert audio
            assert metas and metas[0]["mode"] == "DRM"
            assert metas[0]["drm_mode"] == "B"
            assert metas[0]["service"] == "TPU DRM"


# --------------------------------------------------------- tests/test_exec_audio.py
class TestExecAudio:
    class TestExecAudio:
        def test_fake_decoder_roundtrip(self, tmp_path, device):
            # fake 'dream': consumes cs16 IQ, emits a recognizable s16 pattern
            script = executable(tmp_path / "fake_dream", FAKE_DREAM.replace("{n}", "256"))
            src = signal_source("exec-audio", 100000000)
            rt = DeviceRuntime(src, capacity=4, target_seconds=0.1, device=device)
            audio = []
            handle = ExecAudioHandle(rt, "drm", 10000.0,
                                     command_override=[str(script)])
            handle.audio_cb = lambda data, hd: audio.append(data)
            rt.start()
            try:
                deadline = time.time() + 15
                while not audio and time.time() < deadline:
                    time.sleep(0.2)
            finally:
                handle.close()
                rt.stop()
                src.stop()
            assert audio, "no audio from exec decoder"
            samples = np.frombuffer(audio[0], np.int16)
            assert samples[0] == 0x1234

    class TestM17MetaTap:
        def test_native_metadata_beside_external_decoder(self, tmp_path, device):
            """An M17 listener's ExecAudioHandle feeds the SAME cs16 IF stream
            to the external decoder AND the native link layer — the MetaPanel
            gets callsigns even with the binary stubbed."""
            sink = executable(tmp_path / "sink", "#!/bin/sh\ncat > /dev/null\n")
            src = signal_source("m17-exec", 145000000)
            rt = DeviceRuntime(src, capacity=4, target_seconds=0.1, device=device)
            handle = ExecAudioHandle(rt, "m17", 0.0,
                                     command_override=[str(sink)])
            metas = []
            handle.meta_cb = metas.append
            try:
                # inject wire bytes straight at the tap feed point (the IQ
                # channel callback), proving the _feed_both wiring
                assert handle._m17_tap is not None
                frame = m17.build_lsf_frame("N0CALL", "SP5WWP")
                rng = np.random.default_rng(5)
                idle = rng.integers(0, 4, 150).astype(np.uint8)
                x = c4fm_waveform(
                    np.concatenate([idle, frame, frame, frame, idle]),
                    baud=4800.0, dev_hz=800.0, fs=M17MetaTap.IF_RATE,
                    rrc_alpha=0.5)
                handle.iq.iq_cb(m17_cs16(x))
                deadline = time.time() + 10
                while not metas and time.time() < deadline:
                    time.sleep(0.1)
            finally:
                handle.close()
                src.stop()
            lsfs = [m for m in metas if m.get("source")]
            assert lsfs and lsfs[0]["source"] == "SP5WWP"
            assert lsfs[0]["protocol"] == "M17"

