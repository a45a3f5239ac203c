"""The reference's own tests of the serving path, carried onto the port:
tests/test_pfb_serving.py, test_pfb_interactive.py, test_secondary_bank.py
and test_fanout.py.

Each reference file is one outer class here, named after it
(``test_pfb_serving.py`` → ``TestPfbServing``), holding the reference's
classes and cases under their own names, with the reference's inputs,
seeds, assertions and bounds.  Only what the port's API forces differs:
``DeviceRuntime``, ``Program`` and the runtime namespace a
``SecondaryBank`` is built on get ``device=`` (the namespace also the
port's ``host``), and every module is the port's.  ``decode_wire`` and
``tone_power_ratio`` are tests/test_passband.py's, shared from
tests/torch_ref_helpers.py.  The threaded cases wait on their condition;
their deadline is a safety net of ``WAIT_S`` (the reference's 25 and
30 s), since the plain versions on a loaded CPU run slower than the
reference's compiled programs.  Every case runs on ``device`` "cpu" (the
plain versions) and "cuda" (the card; the ``cuda`` marker, skipped without
a card).  The file imports no jax and nothing of ``openwebrx_tpu``.

Reference cases left out (tests/test_torch_ref_coverage.py keeps this
list):

* test_pfb_interactive.py ``TestCrossProgramJoin::
  test_waterfall_and_banks_share_one_transfer`` and
  ``::test_single_program_skips_join``: they read the JAX runtime's fused
  transfer (``pend["joined"]``, ``pend["segs"]``), a workaround for a
  device behind a network tunnel that the port does not have; their port
  analogues are tests/test_torch_device.py ``TestOneFetchPerBlock``.
"""

import time
import types

import numpy as np

from openwebrx_tpu_torch.core.property import PropertyLayer
from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain, FftChain
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.chain import Fanout, Program
from openwebrx_tpu_torch.runtime.device import (
    PORT_HOST, DeviceRuntime, SecondaryBank, SecondaryHandle)
from openwebrx_tpu_torch.sources.file import SignalSource
from torch_ref_device import card_report, device  # noqa: F401  (fixtures)
from torch_ref_helpers import decode_wire, psk31_iq, pump, tone_power_ratio

RATE = 3.072e6          # → 128 PFB channels of 24 kHz
WAIT_S = 300


# ------------------------------------------------------- tests/test_pfb_serving.py
def _make_runtime(name, noise, signals, device):
    """test_pfb_serving.py's and test_pfb_interactive.py's ``_make_runtime``
    (source name and noise floor differ between the two)."""
    props = PropertyLayer(samp_rate=int(RATE), center_freq=14_100_000,
                          throttle=False, noise=noise, signals=signals)
    src = SignalSource(name, props)
    rt = DeviceRuntime(src, capacity=8, target_seconds=0.05, device=device)
    return rt, src


def _make_serving_runtime(signals, device):
    return _make_runtime("pfb-test", 1e-4, signals, device)


class TestPfbServing:
    class TestPfbServing:
        def test_64_dials_one_program(self, device):
            """64 background USB dials (the FT8/WSPR service shape) all serve
            from ONE ChannelizedBank program; audio flows on every one, and a
            test tone decodes in its owner's channel only."""
            m = 128
            centers = np.fft.fftfreq(m, 1 / RATE)  # channel k center = k·fs/m
            # 64 dials on distinct channel centers (+500 Hz fine offset so the
            # fine shift does real work), skipping DC and the band edges
            ks = [k for k in range(2, m // 2 - 2)] + \
                 [k for k in range(m // 2 + 2, m - 2)]
            ks = ks[:64]
            dials = [float(centers[k] + 500.0) for k in ks]
            tone_dial = dials[10]
            # noise at −54 dBFS: the PFB prototype's stopband (~−55 dB) puts
            # any cross-channel tone leakage BELOW the per-channel noise floor,
            # as in a real receiver (an unrealistically quiet floor would
            # expose the finite stopband as a fake "leak")
            rt, src = _make_serving_runtime(
                [{"kind": "usb", "offset_hz": tone_dial, "f_audio": 1000.0,
                  "amplitude": 0.4}], device)
            rt.source.props["noise"] = 2e-3
            audio: dict[int, list] = {i: [] for i in range(len(dials))}
            handles = []
            try:
                for i, dial in enumerate(dials):
                    h = rt.open_channel("usb", dial, service=True)
                    h.audio_cb = (lambda wire, hd=False, i=i:
                                  audio[i].append(wire))
                    handles.append(h)
                # every dial landed in the SAME pfb bank (one program)
                assert {h.bucket_key for h in handles} == {"pfb:ssb"}
                bank = rt.banks["pfb:ssb"]
                assert bank.n_active == 64
                assert bank.m == m
                assert "svc:ssb" not in rt.banks
                rt.start()
                deadline = time.time() + WAIT_S
                while time.time() < deadline:
                    if all(audio[i] for i in audio) and \
                            sum(len(b) for b in audio[10]) > 24000:
                        break
                    time.sleep(0.1)
            finally:
                rt.stop()
                src.stop()
            assert all(audio[i] for i in audio), "audio missing on some dials"
            # the tone channel hears 1 kHz…
            pcm = np.frombuffer(b"".join(audio[10]), np.int16).astype(np.float32)
            spec = np.abs(np.fft.rfft(pcm[1200:]))
            freqs = np.fft.rfftfreq(len(pcm) - 1200, 1 / 12000.0)
            peak = freqs[np.argmax(spec[3:]) + 3]
            assert abs(peak - 1000.0) < 30.0, f"tone at {peak} Hz"
            # …and a far-away channel is isolated: its residual 1 kHz line
            # (the prototype's ~−55 dB stopband; a coherent leak always pokes
            # above PER-BIN noise) must sit ≥ 30 dB below the owner channel's
            # tone, measured as tone-band-to-median-bin ratio in each channel
            tone_ratio = spec[(freqs > 950) & (freqs < 1050)].max() / \
                np.median(spec[3:])
            other = np.frombuffer(b"".join(audio[40]), np.int16).astype(np.float32)
            spec_o = np.abs(np.fft.rfft(other[1200:]))
            freqs_o = np.fft.rfftfreq(len(other) - 1200, 1 / 12000.0)
            other_ratio = spec_o[(freqs_o > 950) & (freqs_o < 1050)].max() / \
                np.median(spec_o[3:])
            assert tone_ratio > 31.6 * other_ratio, \
                f"PFB channel isolation too low: {tone_ratio:.1f} vs {other_ratio:.1f}"

        def test_edge_dial_falls_back_to_full_rate(self, device):
            """A dial whose passband straddles a PFB channel edge cannot serve
            from the critically-sampled filterbank — it takes a full-rate
            'svc:' slot instead."""
            rt, src = _make_serving_runtime([], device)
            try:
                # channel width is RATE/128 = 24 kHz; +11.8 kHz sits on the
                # boundary between channels 0 and 1 → usb passband (0..3 kHz)
                # cannot fit either slice
                edge = rt.open_channel("usb", 11_800.0, service=True)
                assert edge.bucket_key == "svc:ssb"
                # a centered dial still prefers the PFB
                mid = rt.open_channel("usb", 48_000.0 + 500.0, service=True)
                assert mid.bucket_key == "pfb:ssb"
                # second dial in the SAME channel SHARES it: both serve from
                # the filterbank with independent fine shifts
                dup = rt.open_channel("usb", 48_000.0 + 900.0, service=True)
                assert dup.bucket_key == "pfb:ssb"
                bank = rt.banks["pfb:ssb"]
                assert int(bank._chan[mid.slot]) == int(bank._chan[dup.slot])
                assert mid.slot != dup.slot
            finally:
                src.stop()

        def test_pfb_retune_and_release(self, device):
            rt, src = _make_serving_runtime([], device)
            try:
                h = rt.open_channel("usb", 48_500.0, service=True)
                assert h.bucket_key == "pfb:ssb"
                bank = rt.banks["pfb:ssb"]
                s0 = h.slot
                assert int(bank._chan[s0]) == 2       # 48.5 kHz → channel 2
                # retune within the same channel keeps slot and channel
                h.set_offset(48_900.0)
                assert h.slot == s0 and int(bank._chan[s0]) == 2
                # retune into another channel keeps the slot, remaps the channel
                h.set_offset(72_500.0)
                assert h.slot == s0 and int(bank._chan[s0]) == 3
                h.close()
                assert bank.n_active == 0
            finally:
                src.stop()

    class TestMixedLoad:
        def test_listener_services_waterfall_share_device(self, device):
            """An interactive listener, a waterfall subscriber and a PFB
            service bank all run on one DeviceRuntime block loop — audio
            flows on all of them concurrently."""
            rt, src = _make_serving_runtime(
                [{"kind": "usb", "offset_hz": 48_500.0, "f_audio": 900.0,
                  "amplitude": 0.4},
                 {"kind": "nfm", "offset_hz": -200_000.0, "f_audio": 700.0,
                  "amplitude": 0.4}], device)
            rows = []
            got = {"listener": 0, "svc": 0}
            rt.subscribe_waterfall(lambda payload: rows.append(len(payload)))
            listener = rt.open_channel("nfm", -200_000.0)
            listener.audio_cb = (lambda w, hd=False:
                                 got.__setitem__("listener", got["listener"] + 1))
            svc = rt.open_channel("usb", 48_500.0, service=True)
            svc.audio_cb = (lambda w, hd=False:
                            got.__setitem__("svc", got["svc"] + 1))
            assert svc.bucket_key == "pfb:ssb"
            # interactive listeners ride the filterbank too; NFM gets its
            # own 48 kHz-slice bank (its IF needs ≥48 kHz)
            assert listener.bucket_key == "pfbi:nfm"
            try:
                rt.start()
                deadline = time.time() + WAIT_S
                while time.time() < deadline:
                    if got["listener"] >= 3 and got["svc"] >= 3 and len(rows) >= 3:
                        break
                    time.sleep(0.1)
            finally:
                rt.stop()
                src.stop()
            assert got["listener"] >= 3, got
            assert got["svc"] >= 3, got
            assert len(rows) >= 3

        def test_service_retune_migrates_on_edge(self, device):
            """Retuning a PFB service onto a channel edge migrates it to a
            full-rate slot with audio still flowing."""
            rt, src = _make_serving_runtime([], device)
            try:
                h = rt.open_channel("usb", 48_500.0, service=True)
                assert h.bucket_key == "pfb:ssb"
                # 11.8 kHz sits on the channel-0/1 boundary: cannot fit
                h.set_offset(11_800.0)
                assert h.bucket_key == "svc:ssb"
                assert h.slot is not None
                # and a second service can now take the vacated PFB channel
                h2 = rt.open_channel("usb", 48_600.0, service=True)
                assert h2.bucket_key == "pfb:ssb"
            finally:
                src.stop()


# --------------------------------------------------- tests/test_pfb_interactive.py
def _make_interactive_runtime(signals, device):
    return _make_runtime("pfbi-test", 2e-3, signals, device)


class TestPfbInteractive:
    class TestInteractivePfb:
        def test_listener_rides_pfb_with_adpcm_audio(self, device):
            """An interactive USB listener lands in the 'pfbi:' bank, its
            ADPCM wire audio decodes, and the tone comes through."""
            rt, src = _make_interactive_runtime(
                [{"kind": "usb", "offset_hz": 48_500.0, "f_audio": 1000.0,
                  "amplitude": 0.4}], device)
            frames = []
            try:
                h = rt.open_channel("usb", 48_500.0)
                assert h.bucket_key == "pfbi:ssb"
                bank = rt.banks["pfbi:ssb"]
                assert bank.compression == "adpcm"
                assert bank.delivery_stride == 1
                h.audio_cb = lambda wire, hd=False: frames.append(wire)
                pump(rt, src, 8)
            finally:
                src.stop()
            pcm = decode_wire(frames)
            assert len(pcm) >= 4000          # 8 × 50 ms blocks at 12 kHz
            assert tone_power_ratio(pcm[1200:], 1000.0) > -6.0

        def test_same_station_listeners_share_channel(self, device):
            """Two listeners on the SAME station both ride the filterbank
            (slot-gathered banks accept duplicate channel indices) — the
            many-users-one-frequency shape."""
            rt, src = _make_interactive_runtime([], device)
            try:
                a = rt.open_channel("usb", 48_500.0)
                b = rt.open_channel("usb", 48_500.0)
                c = rt.open_channel("usb", 48_700.0)   # same channel, other dial
                assert {a.bucket_key, b.bucket_key, c.bucket_key} == {"pfbi:ssb"}
                bank = rt.banks["pfbi:ssb"]
                ks = {int(bank._chan[h.slot]) for h in (a, b, c)}
                assert len(ks) == 1                      # one PFB channel…
                assert len({a.slot, b.slot, c.slot}) == 3  # …three slots
            finally:
                src.stop()

        def test_edge_dial_full_rate_and_nfm_gets_wider_slices(self, device):
            rt, src = _make_interactive_runtime([], device)
            try:
                # 11.8 kHz straddles the 24 kHz channel-0/1 boundary → full rate
                edge = rt.open_channel("usb", 11_800.0)
                assert edge.bucket_key == "ssb"
                # NFM cannot run at 24 kHz channel rate (48 kHz IF) — it gets
                # its own 64-channel / 48 kHz-slice bank
                nfm = rt.open_channel("nfm", -192_000.0 + 2_000.0)
                assert nfm.bucket_key == "pfbi:nfm"
                assert rt.banks["pfbi:nfm"].m == 64
            finally:
                src.stop()

        def test_migration_and_readmit_with_audio_continuity(self, device):
            """Drag across a channel edge mid-stream: PFB → full-rate → PFB,
            with decodable audio flowing in every phase."""
            rt, src = _make_interactive_runtime(
                [{"kind": "usb", "offset_hz": 48_500.0, "f_audio": 1000.0,
                  "amplitude": 0.4},
                 {"kind": "usb", "offset_hz": 11_800.0, "f_audio": 1500.0,
                  "amplitude": 0.4}], device)
            phases = {"pfb": [], "full": [], "back": []}
            current = ["pfb"]
            try:
                h = rt.open_channel("usb", 48_500.0)
                assert h.bucket_key == "pfbi:ssb"
                h.audio_cb = lambda wire, hd=False: phases[current[0]].append(wire)
                pump(rt, src, 6)

                # drag onto the edge: migrates to the full-rate listener bank
                h.set_offset(11_800.0)
                assert h.bucket_key == "ssb"
                assert h.slot is not None
                current[0] = "full"
                for _ in range(6):
                    b = src.read_block(timeout=5.0)
                    rt._process_block(b)

                # drag back to a centered dial: re-admitted to the filterbank
                h.set_offset(48_500.0)
                assert h.bucket_key == "pfbi:ssb"
                current[0] = "back"
                for _ in range(6):
                    b = src.read_block(timeout=5.0)
                    rt._process_block(b)
            finally:
                src.stop()
            # audio flowed and decodes in every phase; each migration resets
            # the framer so the first frame re-syncs the codec
            pcm_pfb = decode_wire(phases["pfb"])
            pcm_full = decode_wire(phases["full"])
            pcm_back = decode_wire(phases["back"])
            assert len(pcm_pfb) >= 3000 and len(pcm_full) >= 3000 \
                and len(pcm_back) >= 3000     # 6 × 50 ms blocks at 12 kHz
            assert tone_power_ratio(pcm_pfb[1200:], 1000.0) > -6.0
            assert tone_power_ratio(pcm_full[1200:], 1500.0) > -6.0
            assert tone_power_ratio(pcm_back[1200:], 1000.0) > -6.0
            # the migrations actually happened through distinct banks
            assert "ssb" in rt.banks and "pfbi:ssb" in rt.banks

        def test_smeter_on_pfb_path(self, device):
            rt, src = _make_interactive_runtime(
                [{"kind": "usb", "offset_hz": 48_500.0, "f_audio": 800.0,
                  "amplitude": 0.5}], device)
            vals = []
            try:
                h = rt.open_channel("usb", 48_500.0)
                assert h.bucket_key == "pfbi:ssb"
                h.smeter_cb = vals.append
                pump(rt, src, 8)
            finally:
                src.stop()
            assert len(vals) >= 2
            assert all(np.isfinite(v) for v in vals)

        def test_mode_switch_stays_channelized(self, device):
            """usb → lsb on a PFB listener re-routes through open_channel and
            stays in the filterbank when the new passband fits."""
            rt, src = _make_interactive_runtime([], device)
            try:
                h = rt.open_channel("usb", 48_500.0)
                assert h.bucket_key == "pfbi:ssb"
                h.set_mode("lsb")
                assert h.bucket_key == "pfbi:ssb"
                assert h.mode == "lsb"
                assert h.slot is not None
                bank = rt.banks["pfbi:ssb"]
                assert float(bank._low[h.slot]) == -3000.0
            finally:
                src.stop()

    class TestCrossProgramJoin:
        """Bank membership may change between dispatch and complete."""

        def test_bank_added_between_dispatch_and_complete(self, device):
            """A listener opening mid-block must not corrupt the in-flight
            completion (snapshot semantics)."""
            rt, src = _make_interactive_runtime(
                [{"kind": "usb", "offset_hz": 48_500.0, "f_audio": 900.0,
                  "amplitude": 0.4}], device)
            got = {"a": 0, "b": 0}
            a = rt.open_channel("usb", 48_500.0)
            a.audio_cb = lambda w, hd=False: got.__setitem__("a", got["a"] + 1)
            try:
                src.start()
                pend = rt._dispatch_block(src.read_block(timeout=5.0))
                # new AM bank appears while the block is in flight
                b = rt.open_channel("am", -96_000.0)
                b.audio_cb = lambda w, hd=False: got.__setitem__("b", got["b"] + 1)
                rt._complete_block(pend)               # old snapshot: only a
                assert got["a"] == 1 and got["b"] == 0
                rt._process_block(src.read_block(timeout=5.0))
                assert got["a"] == 2 and got["b"] == 1
            finally:
                src.stop()

        def test_uint8_wire_block_through_runtime(self, device):
            """A packed (n,2) uint8 device block (rtl-sdr wire) decodes the
            same tone as the float path."""
            rt, src = _make_interactive_runtime(
                [{"kind": "usb", "offset_hz": 48_500.0, "f_audio": 1000.0,
                  "amplitude": 0.4}], device)
            frames = []
            h = rt.open_channel("usb", 48_500.0)
            h.audio_cb = lambda wire, hd=False: frames.append(wire)
            try:
                src.start()
                for _ in range(6):
                    blk = src.read_block(timeout=5.0)      # complex64
                    packed = np.stack([blk.real, blk.imag], axis=-1)
                    u8 = np.clip(packed * 128.0 + 127.4, 0, 255).astype(np.uint8)
                    rt._process_block(u8)
            finally:
                src.stop()
            pcm = decode_wire(frames)
            assert len(pcm) >= 3000
            assert tone_power_ratio(pcm[1200:], 1000.0) > -6.0


# ---------------------------------------------------- tests/test_secondary_bank.py
FS = 48000.0


def _sec_runtime(device):
    return types.SimpleNamespace(in_rate=FS, device=device, host=PORT_HOST)


class TestSecondaryBank:
    class TestSecondaryBank:
        def test_two_listeners_one_program(self, device):
            """Two BPSK31 cursors at different dials decode their own text
            through ONE shared Program; output identical to what each would
            decode alone."""
            runtime = _sec_runtime(device)
            bank = SecondaryBank(runtime, "bpsk31", capacity=2)
            a = SecondaryHandle(runtime, "bpsk31", 1200.0, bank)
            b = SecondaryHandle(runtime, "bpsk31", 3000.0, bank)
            assert a.bank is b.bank
            assert a.bank.program is b.bank.program      # ONE program
            assert a.slot != b.slot
            got = {"a": [], "b": []}
            a.text_cb = got["a"].append
            b.text_cb = got["b"].append

            xa = psk31_iq("cq de alpha", 1200.0)
            xb = psk31_iq("cq de bravo", 3000.0)
            n = max(len(xa), len(xb))
            x = np.zeros(n, np.complex64)
            x[:len(xa)] += xa
            x[:len(xb)] += xb
            step = 1 << 14
            for i in range(0, n, step):
                bank.feed(x[i:i + step])
            ta, tb = "".join(got["a"]), "".join(got["b"])
            assert "cq de alpha" in ta, f"a decoded: {ta!r}"
            assert "cq de bravo" in tb, f"b decoded: {tb!r}"
            # and no cross-talk: each heard only its own signal
            assert "bravo" not in ta and "alpha" not in tb

        def test_grow_recompiles_and_keeps_members(self, device):
            runtime = _sec_runtime(device)
            bank = SecondaryBank(runtime, "bpsk31", capacity=1)
            a = SecondaryHandle(runtime, "bpsk31", 1000.0, bank)
            prog1 = bank.program
            b = SecondaryHandle(runtime, "bpsk31", 2000.0, bank)   # forces grow
            assert bank.capacity == 2
            assert bank.program is not prog1
            assert bank.members[a.slot] is a and bank.members[b.slot] is b
            # detach both → bank empties (runtime drop hook absent → no-op)
            bank.detach(a)
            bank.detach(b)
            assert bank._active.sum() == 0

        def test_runtime_shares_bank_across_open_secondary(self, device):
            """DeviceRuntime.open_secondary folds same-mode handles into one
            bank and removes it when the last one closes."""
            props = PropertyLayer(samp_rate=240000, center_freq=14_100_000,
                                  throttle=False, noise=1e-4, signals=[])
            src = SignalSource("secbank", props)
            rt = DeviceRuntime(src, capacity=4, target_seconds=0.05, device=device)
            try:
                h1 = rt.open_secondary("bpsk31", 1000.0)
                h2 = rt.open_secondary("bpsk31", 2000.0)
                h3 = rt.open_secondary("rtty170", 1500.0)
                assert h1.bank is h2.bank
                assert h3.bank is not h1.bank
                assert set(rt.secondary_banks) == {"bpsk31", "rtty170"}
                # feed path registers each bank once
                assert rt.secondary_handles.count(h1.bank) == 1
                rt.release_secondary(h1)
                assert "bpsk31" in rt.secondary_banks     # h2 still attached
                rt.release_secondary(h2)
                assert "bpsk31" not in rt.secondary_banks
                assert h1.bank not in rt.secondary_handles
            finally:
                src.stop()


# ----------------------------------------------------------- tests/test_fanout.py
FANOUT_FS = 240000.0


def make_fanout():
    a = ClientDemodulatorChain(FANOUT_FS, 12000.0, "usb", compression="none")
    b = ClientDemodulatorChain(FANOUT_FS, 12000.0, "am", compression="none")
    fft = FftChain(1024, fps=1000.0, compress=False)
    return a, b, fft, Fanout(
        [("usb", a), ("am", b), ("fft", fft)],
        batch_shapes={"usb": (4,), "am": (2,), "fft": ()})


class TestFanout:
    class TestFanout:
        def test_branches_keyed_and_batched(self, device):
            a, b, fft, fan = make_fanout()
            spec = StreamSpec(Format.COMPLEX_FLOAT, FANOUT_FS)
            prog = Program(fan, spec, 24000, device=device)
            x = (np.random.default_rng(0).standard_normal(24000)
                 + 1j * np.random.default_rng(1).standard_normal(24000)
                 ).astype(np.complex64) * 0.2
            y, aux = prog.process(x)
            assert set(y) == {"usb", "am", "fft"}
            assert np.asarray(y["usb"]).shape[0] == 4      # per-branch batch
            assert np.asarray(y["am"]).shape[0] == 2
            assert np.asarray(y["fft"]).ndim >= 1          # waterfall rows
            # aux keys are branch-prefixed
            assert any(k.startswith("usb.") for k in aux)
            assert any(k.startswith("am.") for k in aux)

        def test_branch_outputs_match_standalone(self, device):
            """A branch inside a Fanout must produce the same audio as the
            same chain run alone (fusion is an execution detail)."""
            rng = np.random.default_rng(2)
            x = (rng.standard_normal(24000)
                 + 1j * rng.standard_normal(24000)).astype(np.complex64) * 0.2

            solo_chain = ClientDemodulatorChain(FANOUT_FS, 12000.0, "usb",
                                                compression="none")
            solo_chain.set_frequency_offset(15000.0)
            spec = StreamSpec(Format.COMPLEX_FLOAT, FANOUT_FS)
            solo = Program(solo_chain, spec, 24000, batch_shape=(2,), device=device)
            y_solo, _ = solo.process(x)

            fan_chain = ClientDemodulatorChain(FANOUT_FS, 12000.0, "usb",
                                               compression="none")
            fan_chain.set_frequency_offset(15000.0)
            other = ClientDemodulatorChain(FANOUT_FS, 12000.0, "am", compression="none")
            fan = Fanout([("usb", fan_chain), ("am", other)],
                         batch_shapes={"usb": (2,), "am": (2,)})
            prog = Program(fan, spec, 24000, device=device)
            y_fan, _ = prog.process(x)
            np.testing.assert_allclose(np.asarray(y_fan["usb"]),
                                       np.asarray(y_solo), atol=2)

        def test_live_params_flow_per_branch(self, device):
            """Retuning one branch's chain affects only that branch and does
            not rebuild the program (params version bump)."""
            a, b, fft, fan = make_fanout()
            spec = StreamSpec(Format.COMPLEX_FLOAT, FANOUT_FS)
            prog = Program(fan, spec, 24000, device=device)
            n = np.arange(24000)
            tone = (0.4 * np.exp(2j * np.pi * (20000 + 800) / FANOUT_FS * n)
                    ).astype(np.complex64)
            a.set_frequency_offset(20000.0)
            for _ in range(3):
                y, _ = prog.process(tone)
            usb = np.asarray(y["usb"])[0].astype(np.float32)
            spec_u = np.abs(np.fft.rfft(usb))
            peak = np.fft.rfftfreq(len(usb), 1 / 12000.0)[np.argmax(spec_u[3:]) + 3]
            assert abs(peak - 800.0) < 40.0
            # retune away: tone disappears from branch a
            a.set_frequency_offset(60000.0)
            for _ in range(3):
                y, _ = prog.process(tone)
            usb2 = np.asarray(y["usb"])[0].astype(np.float32)
            s2 = np.abs(np.fft.rfft(usb2))
            band = (np.fft.rfftfreq(len(usb2), 1 / 12000.0) > 700) & \
                   (np.fft.rfftfreq(len(usb2), 1 / 12000.0) < 900)
            assert s2[band].max() < 0.2 * spec_u.max()
