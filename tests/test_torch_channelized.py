"""The port's ChannelizedBank against the JAX bank, and the port's guards.

The M=16 banks of both packages get the same numpy IQ blocks.  int16 audio
and squelch powers must agree within the tolerances stated below; ADPCM
bytes may differ where float drift upstream moved a sample by one LSB, so
the decoded audio is compared instead.
"""

import ast
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from openwebrx_tpu.ops import adpcm as jadpcm
from openwebrx_tpu.runtime.chain import _unpack_leaf
from openwebrx_tpu.runtime.channelized import ChannelizedBank as JaxBank
from openwebrx_tpu_torch.from_jax import bank_state_from_numpy
from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank

REPO = pathlib.Path(__file__).resolve().parents[1]
FS, M = 1.92e6, 16
OFFSETS = (250000.0, -430000.0, 610000.0)
F_AUDIO = (1100.0, 700.0, 1500.0)
POWER_KEY = "selector.squelch.power_db"
# int16 audio: the port and the reference differ only in fp32 summation
# order and sincos/FFT rounding (1 LSB measured at these sizes)
AUDIO_LSB = 2
# power_db: fp32 mean of |x|² over one window, in dB
POWER_DB_ATOL = 1e-3


def tone_snr(audio, f_tone, fs_audio):
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio)))) ** 2
    freqs = np.fft.rfftfreq(len(audio), 1 / fs_audio)
    band = (freqs > f_tone * 0.9) & (freqs < f_tone * 1.1)
    rest = (freqs > 50) & ~band
    return 10 * np.log10(spec[band].sum() / spec[rest].sum())


def _iq(block, nblocks, seed=0):
    rng = np.random.default_rng(seed)
    n = np.arange(block * nblocks)
    x = sum(0.4 * np.exp(2j * np.pi * (o + fa) / FS * n)
            for o, fa in zip(OFFSETS, F_AUDIO))
    x = x + 0.05 * (rng.standard_normal(len(n)) + 1j * rng.standard_normal(len(n)))
    return np.split(x.astype(np.complex64), nblocks)


def _banks(compression, capacity=None):
    kw = dict(mode="usb", compression=compression, target_seconds=0.05,
              capacity=capacity)
    return JaxBank(FS, M, **kw), ChannelizedBank(FS, M, device="cpu", **kw)


def _decode(blocks):
    """Per-slot ADPCM bytes + stride reseeds over blocks → int16 audio."""
    out, state = [], (0, 0)
    for data, strides in blocks:
        for k in range(len(strides)):
            chunk = bytes(data[k * 100:(k + 1) * 100])
            d, _ = jadpcm.adpcm_decode_np(chunk, state)
            out.append(d)
            state = jadpcm.unpack_codec_state(int(strides[k]))
    return np.concatenate(out).astype(np.int32)


def _jax_state_numpy(bank):
    """The JAX bank's (tail, chain_state) with complex leaves as complex64."""
    return jax.tree.map(lambda v, c: np.asarray(_unpack_leaf(v, c)),
                        bank.state, bank._s_mask)


class TestBankParity:
    @pytest.mark.parametrize("capacity", [None, 4])
    def test_int16_audio_with_retune(self, capacity):
        jb, tb = _banks("none", capacity)
        slots = [(jb.assign(o, -150.0), tb.assign(o, -150.0)) for o in OFFSETS]
        assert all(a == b for a, b in slots)
        jb.set_squelch(slots[1][0], -40.0)
        tb.set_squelch(slots[1][1], -40.0)
        for i, blk in enumerate(_iq(jb.block, 5)):
            if i == 2:     # retune mid-stream; dense mode moves the slot
                s_j = jb.retune(slots[0][0], 370000.0)
                s_t = tb.retune(slots[0][1], 370000.0)
                assert s_j == s_t
                jb.set_nr(s_j, -10.0)
                tb.set_nr(s_t, -10.0)
            yj, aj = jb.process(blk)
            yt, at = tb.process(blk)
            assert yt.dtype == np.int16 and yt.shape == np.asarray(yj).shape
            d = np.abs(yt.astype(np.int32) - np.asarray(yj).astype(np.int32))
            assert d.max() <= AUDIO_LSB, (i, d.max())
            assert set(at) == set(aj) == {POWER_KEY}
            assert at[POWER_KEY].dtype == np.float32
            np.testing.assert_allclose(at[POWER_KEY], aj[POWER_KEY],
                                       rtol=0, atol=POWER_DB_ATOL)

    @pytest.mark.parametrize("mode", ["lsb", "cw"])
    def test_other_ssb_modes_and_bandpass(self, mode):
        kw = dict(mode=mode, compression="none", target_seconds=0.05)
        jb, tb = JaxBank(FS, M, **kw), ChannelizedBank(FS, M, device="cpu", **kw)
        for o in OFFSETS:
            assert jb.assign(o) == tb.assign(o)
        s = jb.channel_for(OFFSETS[2])[0]
        for i, blk in enumerate(_iq(jb.block, 3, seed=4)):
            if i == 1:     # a listener drags its passband
                jb.set_bandpass(s, -2500.0, -200.0)
                tb.set_bandpass(s, -2500.0, -200.0)
            yj, aj = jb.process(blk)
            yt, at = tb.process(blk)
            d = np.abs(yt.astype(np.int32) - np.asarray(yj).astype(np.int32))
            assert d.max() <= AUDIO_LSB, (i, d.max())
            np.testing.assert_allclose(at[POWER_KEY], aj[POWER_KEY],
                                       rtol=0, atol=POWER_DB_ATOL)

    def test_adpcm_decoded_audio(self):
        jb, tb = _banks("adpcm")
        for o in OFFSETS:
            jb.assign(o)
            tb.assign(o)
        jout, tout = [], []
        for blk in _iq(jb.block, 4, seed=1):
            (jbytes, jstride), _ = jb.process(blk)
            (tbytes, tstride), _ = tb.process(blk)
            assert tbytes.dtype == np.uint8 and tbytes.shape == (M, 300)
            assert tstride.dtype == np.int32 and tstride.shape == (M, 3)
            jout.append((np.asarray(jbytes), np.asarray(jstride)))
            tout.append((tbytes, tstride))
        same = np.mean([np.mean(a[0] == b[0]) for a, b in zip(jout, tout)])
        assert same > 0.99
        for k in range(M):
            a = _decode([(b[k], s[k]) for b, s in tout])
            b = _decode([(b[k], s[k]) for b, s in jout])
            # a one-LSB input difference can flip a nibble; the decoder
            # then drifts until the next stride reseed (≤ 200 samples)
            err = np.sqrt(np.mean((a - b) ** 2))
            ref = np.sqrt(np.mean(b.astype(np.float64) ** 2)) + 1.0
            assert err / ref < 0.05, (k, err, ref)

    def test_state_handover(self):
        """JAX bank runs 2 blocks, hands its state over, both continue."""
        jb, tb = _banks("none", capacity=4)
        for o in OFFSETS:
            jb.assign(o)
            tb.assign(o)
        blocks = _iq(jb.block, 4, seed=2)
        for blk in blocks[:2]:
            jb.process(blk)
        tb.state = bank_state_from_numpy(_jax_state_numpy(jb), "cpu")
        for blk in blocks[2:]:
            yj, aj = jb.process(blk)
            yt, at = tb.process(blk)
            d = np.abs(yt.astype(np.int32) - np.asarray(yj).astype(np.int32))
            assert d.max() <= AUDIO_LSB
            np.testing.assert_allclose(at[POWER_KEY], aj[POWER_KEY],
                                       rtol=0, atol=POWER_DB_ATOL)

    def test_state_handover_rejects_foreign_dtypes(self):
        with pytest.raises(TypeError):
            bank_state_from_numpy((np.zeros(3, np.complex128), ()), "cpu")


class TestPortBank:
    def test_two_usb_channels(self):
        bank = ChannelizedBank(FS, M, mode="usb", compression="none",
                               target_seconds=0.05, device="cpu")
        offs, f_audio = [250000.0, -430000.0], [1100.0, 700.0]
        slots = [bank.assign(o) for o in offs]
        assert len(set(slots)) == 2
        n = np.arange(bank.block * 6)
        x = sum(0.4 * np.exp(2j * np.pi * (o + fa) / FS * n)
                for o, fa in zip(offs, f_audio)).astype(np.complex64)
        audio = np.concatenate([bank.process(blk)[0] for blk in np.split(x, 6)],
                               axis=-1).astype(np.float32) / 32767
        settled = audio[:, audio.shape[1] // 2:]
        for slot, fa in zip(slots, f_audio):
            assert tone_snr(settled[slot], fa, 12000.0) > 15

    def test_channel_mapping_and_controls(self):
        bank = ChannelizedBank(FS, M, mode="usb", target_seconds=0.05,
                               capacity=2, device="cpu")
        k, fine = bank.channel_for(250000.0)
        assert k == 2 and abs(fine - 10000.0) < 1e-6
        assert bank.fits(250000.0, 300, 3000)
        assert not bank.fits(250000.0 + 45000.0, 300, 3000)
        s0 = bank.assign(250000.0)
        s1 = bank.assign(250000.0)
        assert (s0, s1) == (0, 1) and not bank.has_free_slot()
        with pytest.raises(ValueError):
            bank.assign(0.0)
        bank.release(s1)
        assert bank.n_active == 1 and bank.channel_in_use(2)

    def test_streaming_surface(self):
        """feed_dispatch with a device chunk of half the bank block and
        delivery batching returns what process() returns."""
        kw = dict(mode="usb", compression="adpcm", device="cpu")
        ref = ChannelizedBank(FS, M, target_seconds=0.05, **kw)
        bank = ChannelizedBank(FS, M, block=ref.block // 2, delivery_stride=2, **kw)
        assert bank.block == ref.block and bank.chunk_ratio == 2
        for b in (ref, bank):
            b.assign(250000.0)
        blocks = _iq(ref.block, 2, seed=3)
        want = [ref.process(b) for b in blocks]
        got = None
        for blk in blocks:
            for half in np.split(bank.pack_input(blk), 2):
                r = bank.feed_dispatch(half)
                if r is not None:
                    got = bank.fetch_many(*r)
        assert got is not None and len(got) == 2
        for (yg, ag), (yw, aw) in zip(got, want):
            for a, b in zip(yg, yw):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ag[POWER_KEY], aw[POWER_KEY])

    def test_wrong_block_size_raises(self):
        bank = ChannelizedBank(FS, M, target_seconds=0.05, device="cpu")
        with pytest.raises(ValueError):
            bank.process(np.zeros(bank.block - M, np.complex64))

    def test_unknown_mode_raises_key_error(self):
        with pytest.raises(KeyError):
            JaxBank(FS, M, mode="dmr")
        with pytest.raises(KeyError):
            ChannelizedBank(FS, M, mode="dmr", device="cpu")

    def test_infeasible_wfm_rate_raises_value_error(self):
        """120 kHz slices cannot carry WFM's 250 kHz IF, in either package
        (the runtime's bucket probe halves M on this error)."""
        with pytest.raises(ValueError):
            JaxBank(FS, M, mode="wfm", audio_rate=48000.0)
        with pytest.raises(ValueError):
            ChannelizedBank(FS, M, mode="wfm", audio_rate=48000.0, device="cpu")


# WFM needs ≥ 250 kHz slices: 4.8 MS/s over 16 channels gives 300 kHz
WFM_FS = 4.8e6
WFM_OFFSETS = (600000.0, -1500000.0)
RDS_KEY = "wfm.rds_tap.rds"


def _analog_iq(mode, fs, offsets, block, nblocks, seed=0):
    """An FM (75 kHz deviation for WFM, 3 kHz for NFM) or AM carrier with a
    tone at each offset, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(block * nblocks) / fs
    x = np.zeros(len(t), np.complex128)
    for o, fa in zip(offsets, F_AUDIO):
        audio = np.sin(2 * np.pi * fa * t)
        if mode in ("nfm", "wfm"):
            dev = 75000.0 if mode == "wfm" else 3000.0
            x += 0.4 * np.exp(1j * (2 * np.pi * o * t
                                    + 2 * np.pi * dev * np.cumsum(audio) / fs))
        else:
            x += 0.3 * (1 + 0.6 * audio) * np.exp(2j * np.pi * o * t)
    x += 0.02 * (rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)))
    return np.split(x.astype(np.complex64), nblocks)


class TestAnalogBanks:
    """Bank parity against the JAX bank in every analog mode.

    AM is compared from block 0 on with no state handed over.  In the other
    modes both banks run block 0, then the port takes the JAX bank's state
    (``bank_state_from_numpy``) and both run on; their block 0 is checked
    for shapes.  At stream start the FFT bandpass's outputs are ~1e-7 with
    ~1e-8 of absolute rounding noise, so the FM discriminator's first
    samples are noise in any two float32 implementations, and an AGC fed
    no DC blocker flips attack against hang on near-equal startup
    envelopes and remembers it for blocks.  Without the handover, block 0
    differs by up to 13828 LSB (nfm), 12854 (wfm), 90 (rawam, 43 in
    block 1) and 993 (rawsam); sam's carrier rms reaches 0.53 LSB; am
    stays within 1 LSB on every block."""

    # int16 audio: float32 drift through the demodulator, IIR and AGC gain
    AUDIO_LSB = 4
    # modes whose stream start is rounding noise (see above)
    HANDOVER = ("nfm", "rawam", "sam", "rawsam", "wfm")

    @pytest.mark.parametrize("mode", ["nfm", "am", "rawam", "sam", "rawsam", "wfm"])
    def test_parity(self, mode):
        if mode == "wfm":
            fs, offsets = WFM_FS, WFM_OFFSETS
            kw = dict(audio_rate=48000.0, capacity=2)
        else:
            fs, offsets, kw = FS, OFFSETS, {}
        kw.update(mode=mode, compression="none", target_seconds=0.05)
        jb, tb = JaxBank(fs, M, **kw), ChannelizedBank(fs, M, device="cpu", **kw)
        assert (tb.block, tb.channel_block) == (jb.block, jb.channel_block)
        slots = [(jb.assign(o), tb.assign(o)) for o in offsets]
        assert all(a == b for a, b in slots)
        blocks = _analog_iq(mode, fs, offsets, jb.block, 4, seed=len(mode))
        handover = mode in self.HANDOVER
        for i, blk in enumerate(blocks):
            if i == 1 and handover:
                tb.state = bank_state_from_numpy(_jax_state_numpy(jb), "cpu")
            yj, aj = jb.process(blk)
            yt, at = tb.process(blk)
            yj = np.asarray(yj)
            assert yt.dtype == np.int16 and yt.shape == yj.shape
            assert set(at) == set(aj)
            assert at[POWER_KEY].dtype == np.float32
            if i == 0 and handover:
                continue
            diff = yt.astype(np.float64) - yj.astype(np.float64)
            if mode in ("sam", "rawsam"):
                # the carrier estimate (atan2 of a sum of rotations, a phase
                # snap per block) rounds differently at a few samples; on a
                # channel without a carrier it is the angle of noise
                rms = np.sqrt(np.mean(diff ** 2, axis=-1))
                ref = np.sqrt(np.mean(yj.astype(np.float64) ** 2, axis=-1))
                carriers = [sj for sj, _ in slots]
                assert rms[carriers].max() <= 0.5, (mode, i, rms)
                assert (rms <= 0.02 * ref + 0.5).all(), (mode, i, rms, ref)
            else:
                assert np.abs(diff).max() <= self.AUDIO_LSB, (mode, i)
            np.testing.assert_allclose(at[POWER_KEY], aj[POWER_KEY],
                                       rtol=0, atol=POWER_DB_ATOL)
            if mode == "wfm":
                # the RDS baseband: 57 kHz mix, 16-fold FIR decimation
                rj, rt = np.asarray(aj[RDS_KEY]), at[RDS_KEY]
                assert rt.dtype == np.complex64 and rt.shape == rj.shape
                assert rt.shape == (2, jb.channel_block * 250 // 300 // 16)
                np.testing.assert_allclose(rt, rj, rtol=0,
                                           atol=1e-4 * np.abs(rj).max())
        rate = 48000.0 if mode == "wfm" else 12000.0
        for (s, _), fa in zip(slots, F_AUDIO):
            assert tone_snr(yt[s].astype(np.float32), fa, rate) > 15, (mode, s)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


class TestControlsFromAnotherThread:
    def test_no_control_change_is_lost(self):
        """A listener's controls change on the server's thread while the
        device loop rebuilds the bank's params for a dispatch.  In each of
        40 rounds four rebuilding threads run against one setter, with the
        interpreter switching threads every microsecond; once they stop,
        the params in use must equal params rebuilt from the controls (a
        change made during a rebuild would otherwise be lost until the
        next change)."""
        import torch
        bank = ChannelizedBank(FS, M, mode="usb", capacity=4, target_seconds=0.05,
                               device="cpu")
        slots = [bank.assign(k * FS / M + 500.0) for k in range(1, 5)]
        old = sys.getswitchinterval()
        stale = 0
        for rnd in range(40):
            stop = threading.Event()

            def rebuild():
                while not stop.is_set():
                    bank._params()

            threads = [threading.Thread(target=rebuild) for _ in range(4)]
            sys.setswitchinterval(1e-6)
            try:
                for th in threads:
                    th.start()
                for i in range(200):
                    s = slots[i % 4]
                    bank.set_squelch(s, -100.0 - (i + rnd) % 37)
                    bank.retune(s, (1 + i % 4) * FS / M + 100.0 + (7 * i + rnd) % 300)
            finally:
                stop.set()
                for th in threads:
                    th.join(timeout=30)
                sys.setswitchinterval(old)
            assert not any(th.is_alive() for th in threads)
            in_use = _leaves(bank._params())
            bank._params_dirty = True
            fresh = _leaves(bank._params())
            assert len(in_use) == len(fresh)
            stale += not all(
                torch.equal(a, b) if isinstance(a, torch.Tensor)
                else np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(in_use, fresh))
        assert stale == 0, f"{stale} of 40 rounds ended with a change lost"


class TestGuards:
    def test_no_jax_imports(self):
        """No module of the port (its host modules and its golden-parity
        harness too), nor chip_smoke.py, profile_torch_bank.py,
        compare_bank_ms.py, compare_kernels.py or the card-only and golden
        test files, imports jax or the JAX package (an AST scan: this
        process has jax loaded already)."""
        files = sorted((REPO / "openwebrx_tpu_torch").rglob("*.py"))
        for rel in ("ops/iir.py", "ops/squelch.py", "ops/adpcm.py", "ops/fftops.py",
                    "ops/convert.py", "ops/timing.py", "ops/fsk.py",
                    "models/stages.py", "models/receiver.py", "models/secondary.py",
                    "models/fax.py", "models/digital_voice.py",
                    "runtime/chain.py", "runtime/bank.py", "runtime/device.py",
                    "core/config.py", "core/feature.py", "sources/file.py",
                    "aprs/parser.py", "digimodes/psk.py", "reporting/mqtt.py",
                    "services/engine.py", "web/server.py", "web/settings.py",
                    "web/connection.py", "native.py", "sdr.py", "__main__.py",
                    "parallel/mesh.py", "parallel/halo.py", "parallel/pfb.py",
                    "parallel/pod.py", "parallel/cluster.py",
                    "testing/capture.py", "testing/oracle.py"):
            assert REPO / "openwebrx_tpu_torch" / rel in files, rel
        files += [REPO / "chip_smoke.py", REPO / "profile_torch_bank.py",
                  REPO / "compare_bank_ms.py", REPO / "compare_kernels.py",
                  REPO / "tests" / "test_torch_golden.py",
                  REPO / "tests" / "test_torch_card.py"]
        assert len(files) > 20
        bad = []
        for f in files:
            for node in ast.walk(ast.parse(f.read_text())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    root = n.split(".")[0]
                    if root in ("jax", "jaxlib", "openwebrx_tpu"):
                        bad.append(f"{f.relative_to(REPO)}: {n}")
        assert not bad, bad

    def test_bank_default_device_needs_a_card(self):
        """Without device= the bank targets CUDA; without a card it raises."""
        import torch
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        with pytest.raises(RuntimeError):
            ChannelizedBank(FS, M, target_seconds=0.05)

    @pytest.mark.parametrize("alone", [False, True])
    def test_chip_smoke_fails_without_card_or_repo(self, tmp_path, alone):
        import torch
        if torch.cuda.is_available() and not alone:
            pytest.skip("a card is present: chip_smoke.py would run")
        cwd = REPO
        if alone:
            (tmp_path / "chip_smoke.py").write_bytes(
                (REPO / "chip_smoke.py").read_bytes())
            cwd = tmp_path
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
