"""The reference's own op and chain tests, carried onto the port:
tests/test_ops_basic.py, test_ops_fft.py, test_ops_fir.py,
test_nr_schedule.py, test_channelizer.py, test_channelized_bank.py and
test_chains.py.

Each reference file is one outer class here, named after it
(``test_ops_basic.py`` → ``TestOpsBasic``), holding the reference's classes
and cases under their own names, with the reference's inputs, seeds,
assertions and bounds.  Only what the port's API forces differs: numpy goes
in as a tensor on the case's device (``torch.as_tensor``), results come out
through ``.cpu().numpy()``, ``device=`` is passed, a float NCO rate goes in
as the int32 fixed-point rate (``nco.rate_to_fixed``) and a squelch level
or NR threshold as a tensor, and ``compress_fft_rows`` gets ``device=``.
Every case runs on ``device`` "cpu" (the
plain versions) and "cuda" (the hand-written kernels; the ``cuda`` marker,
skipped without a card).  The file imports no jax and nothing of
``openwebrx_tpu``.

Reference cases left out, each because it runs no device code of the port
(tests/test_torch_ref_coverage.py keeps this list):

* test_ops_basic.py ``TestIir::test_deemphasis_response``: host float math
  (``deemphasis_coeffs``) against ``scipy.signal.freqz``; no tensor.
* test_ops_fft.py ``TestWaterfall::test_params_math``: host arithmetic
  (``waterfall_params``), held equal to the reference by
  tests/test_torch_waterfall.py ``test_tone_bin_level_and_params``.
* test_nr_schedule.py ``TestSchedules`` (4 cases): the service scheduler,
  a host module held to the reference by tests/test_torch_host_copy.py.
* test_chains.py ``TestLiveControls::test_retune_no_recompile``: it counts
  the entries of JAX's jit cache (``prog._step._cache_size()``); the port
  runs its stages eagerly and compiles nothing a retune could add to.

test_channelizer.py's four cases used to be run on the CPU only by
tests/test_torch_ops.py ``TestChannelize``; they live here now, on both
devices.
"""

import numpy as np
import pytest
import scipy.signal as sig
import torch

from openwebrx_tpu_torch.ops import (adpcm, agc, bandpass, channelizer as pfb, demod,
                                     fftops, fir, firdes, iir, nco, squelch)
from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain, FftChain, build_program
from openwebrx_tpu_torch.models.selector import Selector
from openwebrx_tpu_torch.models.stages import plan_block_size
from openwebrx_tpu_torch.ops import noisefilter as nr
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.chain import Program, host_pack_complex
from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank
from torch_ref_device import card_report, device  # noqa: F401  (fixtures)


def _t(a, device):
    """numpy → a tensor on ``device``."""
    return torch.as_tensor(np.asarray(a), device=device)


def _fixed(rate, device):
    """A float rate (cycles/sample) → the port's int32 fixed-point rate."""
    return _t(nco.rate_to_fixed(rate), device)


def _level(db, device):
    return torch.tensor(db, dtype=torch.float32, device=device)


# ------------------------------------------------------ tests/test_ops_basic.py
class TestOpsBasic:
    class TestShift:
        def test_shift_moves_tone(self, device):
            fs = 48000.0
            n = np.arange(4800)
            tone = np.exp(2j * np.pi * 5000 / fs * n).astype(np.complex64)
            phase = nco.shift_init(device=device)
            _, y = nco.shift_apply(phase, _fixed(-5000 / fs, device), _t(tone, device))
            y = y.cpu().numpy()
            # after shifting by −5 kHz the tone sits at DC
            assert np.abs(np.mean(y)) > 0.999

        def test_streaming_phase_continuity(self, device):
            rate = 0.01237  # awkward fraction of 2π per block
            x = np.ones(4096, np.complex64)
            phase = nco.shift_init(device=device)
            outs = []
            for blk in np.split(x, 8):
                phase, y = nco.shift_apply(phase, _fixed(rate, device), _t(blk, device))
                outs.append(y.cpu().numpy())
            y_stream = np.concatenate(outs)
            _, y_whole = nco.shift_apply(nco.shift_init(device=device), _fixed(rate, device),
                                         _t(x, device))
            np.testing.assert_allclose(y_stream, y_whole.cpu().numpy(), atol=2e-3)

        def test_batched_rates(self, device):
            x = np.ones((4, 1024), np.complex64)
            rates = np.array([0.1, -0.1, 0.25, 0.0], np.float32)
            phase = nco.shift_init((4,), device=device)
            _, y = nco.shift_apply(phase, _fixed(rates, device), _t(x, device))
            y = y.cpu().numpy()
            for c in range(4):
                _, yc = nco.shift_apply(nco.shift_init(device=device),
                                        _fixed(rates[c], device), _t(x[c], device))
                np.testing.assert_allclose(y[c], yc.cpu().numpy(), atol=1e-5)

    class TestIir:
        def test_first_order_matches_lfilter(self, device):
            rng = np.random.default_rng(0)
            x = rng.standard_normal(4000).astype(np.float32)
            b0, b1, a1 = 0.3, -0.2, 0.9
            state = iir.first_order_init(device=device)
            _, y = iir.first_order_apply(state, b0, b1, a1, _t(x, device), device=device)
            golden = sig.lfilter([b0, b1], [1.0, -a1], x)
            np.testing.assert_allclose(y.cpu().numpy(), golden, rtol=1e-3, atol=1e-4)

        def test_streaming_equals_batch(self, device):
            rng = np.random.default_rng(1)
            x = rng.standard_normal(4000).astype(np.float32)
            b0, b1, a1 = iir.dc_block_coeffs(12000.0)
            state = iir.first_order_init(device=device)
            outs = []
            for blk in np.split(x, 10):
                state, y = iir.first_order_apply(state, b0, b1, a1, _t(blk, device),
                                                 device=device)
                outs.append(y.cpu().numpy())
            y_stream = np.concatenate(outs)
            _, y_whole = iir.first_order_apply(iir.first_order_init(device=device),
                                               b0, b1, a1, _t(x, device), device=device)
            np.testing.assert_allclose(y_stream, y_whole.cpu().numpy(), rtol=1e-3, atol=1e-4)

        def test_dc_block_removes_dc(self, device):
            x = (np.ones(12000) * 0.7).astype(np.float32)
            b0, b1, a1 = iir.dc_block_coeffs(12000.0)
            _, y = iir.first_order_apply(iir.first_order_init(device=device), b0, b1, a1,
                                         _t(x, device), device=device)
            assert abs(y.cpu().numpy()[-100:].mean()) < 1e-3

    class TestFmDemod:
        def test_tone(self, device):
            fs = 48000.0
            f_mod = 1000.0
            deviation = 5000.0
            n = np.arange(9600)
            # FM: phase = 2π·dev/f_mod·... integrate modulating sine
            mod = np.sin(2 * np.pi * f_mod / fs * n)
            phase = 2 * np.pi * deviation / fs * np.cumsum(mod)
            x = np.exp(1j * phase).astype(np.complex64)
            prev = demod.fm_init(device=device)
            _, y = demod.fm_demod(prev, _t(x, device))
            y = y.cpu().numpy()[100:]
            # output ≈ (2·dev/fs)·mod (instantaneous freq / (fs/2))
            # phase[n] − phase[n−1] = 2π·dev/fs·mod[n] ⇒ y[n] aligns with mod[n]
            expected = 2 * deviation / fs * mod[100:]
            assert np.corrcoef(y, expected)[0, 1] > 0.999
            np.testing.assert_allclose(y.max(), 2 * deviation / fs, rtol=0.05)

        def test_am(self, device):
            n = np.arange(4800)
            env = 1.0 + 0.5 * np.sin(2 * np.pi * 0.01 * n)
            x = (env * np.exp(2j * np.pi * 0.1 * n)).astype(np.complex64)
            y = demod.am_demod(_t(x, device)).cpu().numpy()
            np.testing.assert_allclose(y, env, rtol=1e-3)

        def test_sync_am_locks(self, device):
            fs = 12000.0
            n = np.arange(24000)
            carrier_off = 37.0  # Hz residual carrier
            audio = 0.3 * np.sin(2 * np.pi * 400 / fs * n)
            x = ((1 + audio) * np.exp(2j * np.pi * carrier_off / fs * n)).astype(np.complex64)
            state = demod.sync_am_init(device=device)
            outs = []
            for blk in np.split(x, 20):
                state, y = demod.sync_am_demod(state, _t(blk, device))
                outs.append(y.cpu().numpy())
            y = np.concatenate(outs)[-6000:]
            # after lock, output ≈ 1 + audio: correlate AC component
            ac = y - y.mean()
            ref = audio[-6000:]
            assert np.corrcoef(ac, ref)[0, 1] > 0.99

    class TestAgc:
        def test_scales_to_reference(self, device):
            x = (0.01 * np.sin(2 * np.pi * 0.01 * np.arange(4000))).astype(np.float32)
            state = agc.agc_init(agc.FAST, device=device)
            for _ in range(6):
                state, y = agc.agc_apply(state, agc.FAST, _t(x, device), device=device)
            peak = np.abs(y.cpu().numpy()).max()
            assert 0.4 < peak < 1.2  # near the 0.8 reference

        def test_attack_prevents_clipping_growth(self, device):
            loud = np.ones(4000, np.float32) * 5.0
            state = agc.agc_init(agc.FAST, device=device)
            state, y = agc.agc_apply(state, agc.FAST, _t(loud, device), device=device)
            # gain must come down within the first block
            assert np.abs(y.cpu().numpy()[-512:]).max() < 1.5

    class TestSquelch:
        def test_gates_noise_passes_signal(self, device):
            rng = np.random.default_rng(0)
            window = 750
            quiet = (rng.standard_normal(1500) * 1e-4).astype(np.complex64)
            loud = (rng.standard_normal(1500) * 1.0).astype(np.complex64)
            state = squelch.squelch_init(device=device)
            state, gq, pq = squelch.squelch_apply(state, _level(-40.0, device),
                                                  _t(quiet, device), window)
            # hang keeps it open briefly after signal; from cold start gate closed
            assert np.abs(gq.cpu().numpy()).max() == 0.0
            state, gl, pl = squelch.squelch_apply(state, _level(-40.0, device),
                                                  _t(loud, device), window)
            assert np.abs(gl.cpu().numpy()).max() > 0.1
            assert pl.cpu().numpy().mean() > pq.cpu().numpy().mean() + 30

        def test_level_off_passes_everything(self, device):
            rng = np.random.default_rng(1)
            x = (rng.standard_normal(1500) * 1e-4).astype(np.complex64)
            state = squelch.squelch_init(device=device)
            _, g, _ = squelch.squelch_apply(state, _level(-150.0, device), _t(x, device), 750)
            np.testing.assert_allclose(g.cpu().numpy(), x, atol=1e-7)


# -------------------------------------------------------- tests/test_ops_fft.py
def _decode_with_sync(data: bytes) -> np.ndarray:
    """Reimplementation of the browser decodeWithSync state machine
    (reference htdocs/lib/AudioEngine.js:449-487) for wire-format tests."""
    out = []
    phase, synced, counter = 0, 0, 0
    sync_buf = bytearray()
    pred, idx = 0, 0
    i = 0
    state = (0, 0)
    while i < len(data):
        b = data[i]
        if phase == 0:
            synced = synced + 1 if b == b"SYNC"[synced] else 0
            if synced == 4:
                sync_buf = bytearray()
                phase = 1
                synced = 0
        elif phase == 1:
            sync_buf.append(b)
            if len(sync_buf) == 4:
                idx, pred = np.frombuffer(bytes(sync_buf), "<i2")
                state = (int(pred), int(idx))
                counter = adpcm.SYNC_INTERVAL - 1
                phase = 2
        else:
            samples, state = adpcm.adpcm_decode_np(bytes([b]), state)
            out.append(samples)
            counter -= 1
            if counter < 0:
                phase = 0
        i += 1
    return np.concatenate(out) if out else np.empty(0, np.int16)


class TestOpsFft:
    class TestWaterfall:
        def test_tone_lands_in_right_bin(self, device):
            fs, size = 48000.0, 1024
            n = np.arange(size * 8)
            f = 6000.0
            x = np.exp(2j * np.pi * f / fs * n).astype(np.complex64)
            hist = fftops.fft_init(size, size, device=device)
            w = _t(fftops.hann_window(size), device)
            _, p = fftops.fft_power(hist, w, _t(x, device), size, size)
            rows = fftops.log_average(p, averages=8)
            row = fftops.fft_swap(rows).cpu().numpy()[0]
            peak_bin = int(np.argmax(row))
            expected = size // 2 + int(round(f / fs * size))
            assert abs(peak_bin - expected) <= 1

        def test_level_calibration(self, device):
            # full-scale tone → ~(0 + add_db) dB after window loss (~−6 dB hann)
            fs, size = 48000.0, 1024
            x = np.exp(2j * np.pi * 0.1 * np.arange(size * 4)).astype(np.complex64)
            hist = fftops.fft_init(size, size, device=device)
            _, p = fftops.fft_power(hist, _t(fftops.hann_window(size), device),
                                    _t(x, device), size, size)
            rows = fftops.log_average(p, averages=4, add_db=0.0).cpu().numpy()
            assert -8.0 < rows[0].max() < -4.0

        def test_streaming_continuity(self, device):
            rng = np.random.default_rng(0)
            size = 256
            x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
            w = _t(fftops.hann_window(size), device)
            hist = fftops.fft_init(size, size, device=device)
            _, p_whole = fftops.fft_power(hist, w, _t(x, device), size, size)
            rows = []
            hist = fftops.fft_init(size, size, device=device)
            for blk in np.split(x, 4):
                hist, p = fftops.fft_power(hist, w, _t(blk, device), size, size)
                rows.append(p.cpu().numpy())
            np.testing.assert_allclose(np.concatenate(rows, axis=0),
                                       p_whole.cpu().numpy(), rtol=1e-3, atol=1e-2)

    class TestBandpassFft:
        def test_matches_time_domain(self, device):
            rng = np.random.default_rng(1)
            x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
            lo, hi, tbw = -0.1, 0.2, 0.02
            taps = firdes.bandpass_taps(lo, hi, tbw)
            ntaps = len(taps)
            nfft = bandpass.plan_nfft(ntaps, 1024)
            resp = _t(firdes.bandpass_response(lo, hi, tbw, nfft), device)
            tail = bandpass.bandpass_init(ntaps, device=device)
            outs = []
            for blk in np.split(x, 4):
                tail, y = bandpass.bandpass_apply(tail, resp, _t(blk, device), ntaps, nfft)
                outs.append(y.cpu().numpy())
            y = np.concatenate(outs)
            golden = sig.lfilter(taps, [1.0], x)
            np.testing.assert_allclose(y, golden, rtol=1e-3, atol=1e-3)

        def test_rejects_out_of_band(self, device):
            fs = 12000.0
            n = np.arange(12000)
            inband = np.exp(2j * np.pi * 1000 / fs * n)
            outband = np.exp(2j * np.pi * 4000 / fs * n)
            x = (inband + outband).astype(np.complex64)
            lo, hi, tbw = 300 / fs, 2700 / fs, 320 / fs
            ntaps = firdes.bandpass_ntaps(tbw)
            nfft = bandpass.plan_nfft(ntaps, 3000)
            resp = _t(firdes.bandpass_response(lo, hi, tbw, nfft), device)
            tail = bandpass.bandpass_init(ntaps, device=device)
            outs = []
            for blk in np.split(x, 4):
                tail, y = bandpass.bandpass_apply(tail, resp, _t(blk, device), ntaps, nfft)
                outs.append(y.cpu().numpy())
            y = np.concatenate(outs)[2000:]
            spec = np.abs(np.fft.fft(y))
            freqs = np.fft.fftfreq(len(y), 1 / fs)
            pin = spec[np.argmin(np.abs(freqs - 1000))]
            pout = spec[np.argmin(np.abs(freqs - 4000))]
            assert 20 * np.log10(pin / max(pout, 1e-12)) > 40

    class TestAdpcm:
        def test_roundtrip_snr(self, device):
            """Wire-contract roundtrip: each STATE_STRIDE-byte stride decodes
            from its exported reseed state (what the sync headers deliver)."""
            fs = 12000
            n = np.arange(fs)
            audio = (0.5 * np.sin(2 * np.pi * 440 / fs * n)).astype(np.float32)
            state = adpcm.adpcm_init(device=device)
            samples = (audio * 32767).astype(np.int16)
            state, (bytes_, stride) = adpcm.adpcm_encode(state, _t(samples, device))
            data = bytes_.cpu().numpy()
            stride = stride.cpu().numpy()
            decoded = []
            st = (0, 0)
            for k in range(len(data) // adpcm.STATE_STRIDE):
                chunk = bytes(data[k * adpcm.STATE_STRIDE:(k + 1) * adpcm.STATE_STRIDE])
                d, _ = adpcm.adpcm_decode_np(chunk, st)
                decoded.append(d)
                st = adpcm.unpack_codec_state(int(stride[k]))
            decoded = np.concatenate(decoded)
            m = len(decoded)
            err = decoded.astype(np.float32) / 32767 - audio[:m]
            snr = 10 * np.log10(np.mean(audio[:m] ** 2) / np.mean(err**2))
            assert snr > 25, f"ADPCM SNR {snr:.1f} dB"

        def test_seq_state_snapshots_match_decoder(self, device):
            """The sequential (waterfall-row) encoder keeps the exact-IMA
            invariant: exported stride state == continuous decoder state."""
            rng = np.random.default_rng(2)
            audio = (rng.standard_normal(2000) * 8000).astype(np.int16)
            state = adpcm.adpcm_init(device=device)
            state, (bytes_, stride) = adpcm.adpcm_encode_seq(state, _t(audio, device))
            data = bytes(bytes_.cpu().numpy())
            stride = stride.cpu().numpy()
            for k in (200, 400, 1000):
                _, (pred, idx) = adpcm.adpcm_decode_np(data[:k])
                spred, sidx = adpcm.unpack_codec_state(stride[k // adpcm.STATE_STRIDE - 1])
                assert pred == spred
                assert idx == sidx

        def test_strided_reseed_is_exact_predictor(self, device):
            """The strided encoder's exported reseeds: predictor equals the raw
            sample just before the stride, so the decoder restarts with zero
            predictor discontinuity."""
            rng = np.random.default_rng(9)
            audio = (rng.standard_normal(1000) * 8000).astype(np.int16)
            _, (_b, stride) = adpcm.adpcm_encode(adpcm.adpcm_init(device=device),
                                                 _t(audio, device))
            stride = stride.cpu().numpy()
            for k in range(len(stride)):
                pred, idx = adpcm.unpack_codec_state(int(stride[k]))
                assert pred == int(audio[(k + 1) * 2 * adpcm.STATE_STRIDE - 1])
                assert 0 <= idx <= 88

        def test_sync_framer_stream(self, device):
            rng = np.random.default_rng(3)
            framer = adpcm.SyncFramer()
            state = adpcm.adpcm_init(device=device)
            wire = bytearray()
            original = []
            for _ in range(4):
                audio = (rng.standard_normal(1200) * 8000).astype(np.int16)
                original.append(audio)
                state, (b, stride) = adpcm.adpcm_encode(state, _t(audio, device))
                wire += framer.frame(b.cpu().numpy(), stride.cpu().numpy())
            decoded = _decode_with_sync(bytes(wire))
            orig = np.concatenate(original)
            err = (decoded.astype(np.float32) - orig.astype(np.float32)) / 32767
            snr = 10 * np.log10(np.mean((orig / 32767.0) ** 2) / np.mean(err**2))
            assert snr > 10


# -------------------------------------------------------- tests/test_ops_fir.py
def _stream(apply_fn, init, x, nblocks, device):
    """Run apply_fn over nblocks equal blocks, concatenate outputs."""
    state = init
    outs = []
    for blk in np.split(x, nblocks):
        state, y = apply_fn(state, _t(blk, device))
        outs.append(y.cpu().numpy())
    return np.concatenate(outs, axis=-1)


class TestOpsFir:
    class TestFirDecimate:
        @pytest.mark.parametrize("decim", [1, 4, 10])
        def test_matches_scipy_real(self, decim, device):
            rng = np.random.default_rng(0)
            taps = firdes.lowpass_taps(0.4 / max(decim, 2), 0.05)
            x = rng.standard_normal(4000).astype(np.float32)
            tail = fir.fir_init(len(taps), complex_input=False, device=device)
            _, y = fir.fir_apply(tail, _t(taps, device), _t(x, device), decim)
            # zero-filled initial tail ⇒ causal filtering from zero state:
            # out[m] = lfilter(taps, 1, x)[m*D]
            golden = sig.lfilter(taps, [1.0], x)[::decim]
            np.testing.assert_allclose(y.cpu().numpy(), golden, rtol=1e-4, atol=1e-5)

        def test_streaming_equals_batch(self, device):
            rng = np.random.default_rng(1)
            taps = firdes.lowpass_taps(0.1, 0.02)
            x = (rng.standard_normal(8000) + 1j * rng.standard_normal(8000)).astype(np.complex64)
            decim = 5
            h = _t(taps, device)

            whole_tail = fir.fir_init(len(taps), device=device)
            _, y_whole = fir.fir_apply(whole_tail, h, _t(x, device), decim)

            y_stream = _stream(lambda s, b: fir.fir_apply(s, h, b, decim),
                               fir.fir_init(len(taps), device=device), x, 8, device)
            np.testing.assert_allclose(y_stream, y_whole.cpu().numpy(), rtol=1e-4, atol=1e-5)

        def test_batch_channels(self, device):
            rng = np.random.default_rng(2)
            taps = firdes.lowpass_taps(0.1, 0.05)
            h = _t(taps, device)
            x = (rng.standard_normal((3, 1000))
                 + 1j * rng.standard_normal((3, 1000))).astype(np.complex64)
            tail = fir.fir_init(len(taps), batch_shape=(3,), device=device)
            _, y = fir.fir_apply(tail, h, _t(x, device), 2)
            y = y.cpu().numpy()
            for c in range(3):
                _, yc = fir.fir_apply(fir.fir_init(len(taps), device=device), h,
                                      _t(x[c], device), 2)
                np.testing.assert_allclose(y[c], yc.cpu().numpy(), rtol=1e-4, atol=1e-5)

    class TestFractionalResampler:
        @pytest.mark.parametrize("lm", [(2, 3), (3, 2), (15, 16), (24, 125)])
        def test_matches_scipy_upfirdn(self, lm, device):
            interp, decim = lm
            rng = np.random.default_rng(3)
            cut = 0.45 / max(interp, decim)
            taps = firdes.lowpass_taps(cut, cut * 0.5) * interp
            bank, tail_len, delay_groups = fir.polyphase_bank(taps, interp, decim)
            x = rng.standard_normal(decim * 1600).astype(np.float32)  # B % M == 0

            tail = fir.resample_init(tail_len, complex_input=False, device=device)
            _, y = fir.resample_apply(tail, _t(bank, device), _t(x, device), interp, decim)
            y = y.cpu().numpy()
            assert y.shape[-1] == x.shape[-1] * interp // decim

            golden = sig.upfirdn(taps, x, up=interp, down=decim)
            d = delay_groups * interp  # whole-sample output delay of the stream
            n = len(y) - d
            np.testing.assert_allclose(y[d:], golden[:n], rtol=1e-4, atol=1e-4)
            if d:
                np.testing.assert_allclose(y[:d], 0, atol=1e-6)

        def test_streaming_equals_batch(self, device):
            interp, decim = 15, 16
            taps = firdes.lowpass_taps(0.028, 0.01) * interp
            bank, tail_len, _ = fir.polyphase_bank(taps, interp, decim)
            bank = _t(bank, device)
            rng = np.random.default_rng(4)
            x = (rng.standard_normal(6400) + 1j * rng.standard_normal(6400)).astype(np.complex64)
            _, y_whole = fir.resample_apply(
                fir.resample_init(tail_len, complex_input=True, device=device),
                bank, _t(x, device), interp, decim)
            y_stream = _stream(lambda s, b: fir.resample_apply(s, bank, b, interp, decim),
                               fir.resample_init(tail_len, complex_input=True, device=device),
                               x, 4, device)
            np.testing.assert_allclose(y_stream, y_whole.cpu().numpy(), rtol=1e-4, atol=1e-5)


# ----------------------------------------------------- tests/test_nr_schedule.py
class TestNrSchedule:
    class TestNoiseFilter:
        def test_improves_tone_snr(self, device):
            fs = 12000
            n = np.arange(fs * 2)
            rng = np.random.default_rng(0)
            tone = 0.3 * np.sin(2 * np.pi * 800 / fs * n)
            noise = 0.1 * rng.standard_normal(len(n))
            x = (tone + noise).astype(np.float32)  # 24000 = 8 x 3000, HOP-divisible

            state = nr.nr_init(device=device)
            outs = []
            for blk in np.split(x, 8):
                state, y = nr.nr_apply(state, _level(6.0, device), _t(blk, device))
                outs.append(y.cpu().numpy())
            y = np.concatenate(outs)[len(x) // 2:]  # settled second half

            def snr(sig):
                spec = np.abs(np.fft.rfft(sig * np.hanning(len(sig)))) ** 2
                f = np.fft.rfftfreq(len(sig), 1 / fs)
                band = (f > 700) & (f < 900)
                rest = (f > 50) & ~band
                return 10 * np.log10(spec[band].sum() / spec[rest].sum())

            improvement = snr(y) - snr(x[fs:])
            assert improvement > 5, f"NR improved SNR by only {improvement:.1f} dB"

        def test_streaming_shapes(self, device):
            state = nr.nr_init(device=device)
            x = np.zeros(2500, np.float32)
            state, y = nr.nr_apply(state, _level(3.0, device), _t(x, device))
            assert y.cpu().numpy().shape == x.shape


# ------------------------------------------------------ tests/test_channelizer.py
def _channelize(proto, x, m, device):
    tail = pfb.channelizer_init(m, len(proto) // m, device=device)
    return pfb.channelize(tail, proto, _t(x, device), m, device=device)


class TestChannelizer:
    class TestChannelizer:
        def test_tones_land_in_their_channels(self, device):
            m, fs = 16, 160000.0
            proto = pfb.design_prototype(m)
            freqs = pfb.channel_frequencies(m, fs)
            # tones at channel centers 2, 5, and 13 (negative)
            n = np.arange(m * 2000)
            x = sum(np.exp(2j * np.pi * freqs[k] / fs * n) for k in (2, 5, 13))
            x = x.astype(np.complex64)
            _, y = _channelize(proto, x, m, device)
            y = y.cpu().numpy()
            assert y.shape == (m, len(n) // m)
            power = np.mean(np.abs(y) ** 2, axis=1)
            hot = set(np.flatnonzero(power > 0.2))
            assert hot == {2, 5, 13}, f"hot channels {hot}"
            # isolation: quiet channels at least 40 dB down
            quiet = np.delete(power, [2, 5, 13])
            assert 10 * np.log10(quiet.max() / power[2]) < -40

        def test_offset_tone_appears_at_offset(self, device):
            m, fs = 8, 80000.0
            proto = pfb.design_prototype(m)
            delta = 1200.0  # Hz inside channel 3 (center 30 kHz)
            n = np.arange(m * 4000)
            x = np.exp(2j * np.pi * (30000 + delta) / fs * n).astype(np.complex64)
            _, y = _channelize(proto, x, m, device)
            ch = y.cpu().numpy()[3][500:]
            ch_rate = fs / m
            spec = np.abs(np.fft.fft(ch * np.hanning(len(ch))))
            f = np.fft.fftfreq(len(ch), 1 / ch_rate)
            peak_f = f[np.argmax(spec)]
            assert abs(peak_f - delta) < ch_rate / len(ch) * 2

        def test_streaming_continuity(self, device):
            m = 8
            proto = pfb.design_prototype(m)
            rng = np.random.default_rng(0)
            x = (rng.standard_normal(8 * 3000) + 1j * rng.standard_normal(8 * 3000)
                 ).astype(np.complex64)
            _, y_whole = _channelize(proto, x, m, device)
            tail = pfb.channelizer_init(m, len(proto) // m, device=device)
            outs = []
            for blk in np.split(x, 3):
                tail, y = pfb.channelize(tail, proto, _t(blk, device), m, device=device)
                outs.append(y.cpu().numpy())
            y_stream = np.concatenate(outs, axis=1)
            np.testing.assert_allclose(y_stream, y_whole.cpu().numpy(), atol=1e-4)

        def test_matches_direct_downconversion(self, device):
            """Channel k of the PFB ≈ shift(−f_k) → lowpass → decimate M of the
            same stream (within the filters' passband difference)."""
            m, fs = 8, 96000.0
            proto = pfb.design_prototype(m)
            rng = np.random.default_rng(1)
            # narrowband signal inside channel 2
            base = rng.standard_normal(2000) + 1j * rng.standard_normal(2000)
            lp = sig.firwin(101, 0.04)
            nb = sig.lfilter(lp, 1, np.repeat(base, 12))[: m * 2800]
            f2 = pfb.channel_frequencies(m, fs)[2]
            n = np.arange(len(nb))
            x = (nb * np.exp(2j * np.pi * f2 / fs * n)).astype(np.complex64)

            _, y = _channelize(proto, x, m, device)
            ch = y.cpu().numpy()[2]

            direct = x * np.exp(-2j * np.pi * f2 / fs * n)
            direct = sig.lfilter(np.asarray(proto, np.float64), 1, direct)[::m]

            # compare settled region; the stream delay may shift alignment by
            # ±1 channel sample — take the best small lag
            best = None
            for lag in (-2, -1, 0, 1, 2):
                a, b = ch[200:2500], direct[200:2500]
                if lag > 0:
                    a, b = a[lag:], b[: len(a) - lag]
                elif lag < 0:
                    b, a = b[-lag:], a[: len(b) + lag]
                n2 = min(len(a), len(b))
                err = np.abs(a[:n2] - b[:n2]).max()
                best = min(best, err) if best is not None else err
            assert best < 5e-2, f"PFB vs direct max err {best}"


# ------------------------------------------------- tests/test_channelized_bank.py
def tone_snr(audio, f_tone, fs_audio):
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio)))) ** 2
    freqs = np.fft.rfftfreq(len(audio), 1 / fs_audio)
    band = (freqs > f_tone * 0.9) & (freqs < f_tone * 1.1)
    rest = (freqs > 50) & ~band
    return 10 * np.log10(spec[band].sum() / spec[rest].sum())


class TestChannelizedBank:
    class TestChannelizedBank:
        def test_two_usb_channels(self, device):
            fs, m = 1.92e6, 16  # channel rate 120 kHz
            bank = ChannelizedBank(fs, m, mode="usb", compression="none",
                                   target_seconds=0.05, device=device)
            # two USB signals at arbitrary offsets (tone = offset + f_audio)
            offs = [250000.0, -430000.0]
            f_audio = [1100.0, 700.0]
            slots = [bank.assign(o) for o in offs]
            assert len(set(slots)) == 2

            n = np.arange(bank.block * 6)
            x = sum(0.4 * np.exp(2j * np.pi * (o + fa) / fs * n)
                    for o, fa in zip(offs, f_audio)).astype(np.complex64)
            outs = []
            for blk in np.split(x, 6):
                y, aux = bank.process(blk)
                outs.append(np.asarray(y))
            audio = np.concatenate(outs, axis=-1).astype(np.float32) / 32767
            settled = audio[:, audio.shape[1] // 2:]
            for slot, fa in zip(slots, f_audio):
                snr = tone_snr(settled[slot], fa, 12000.0)
                assert snr > 15, f"channel {slot} tone SNR {snr:.1f} dB"

        def test_channel_mapping(self, device):
            bank = ChannelizedBank(1.92e6, 16, mode="usb", compression="none",
                                   target_seconds=0.05, device=device)
            k, fine = bank.channel_for(250000.0)
            # channel spacing 120 kHz: 250 kHz → channel 2 (240 kHz) + 10 kHz
            assert k == 2 and abs(fine - 10000.0) < 1e-6
            k, fine = bank.channel_for(-430000.0)
            assert abs(fine) <= 60000.0


# ----------------------------------------------------------- tests/test_chains.py
FS = 2400000.0  # 2.4 MS/s RTL-SDR rate (BASELINE config #1)


def make_nfm_signal(fs, duration, offset_hz, f_audio=1000.0, deviation=3000.0,
                    amplitude=0.5):
    n = np.arange(int(fs * duration))
    mod = np.sin(2 * np.pi * f_audio / fs * n)
    phase = 2 * np.pi * deviation / fs * np.cumsum(mod)
    return (amplitude * np.exp(1j * (2 * np.pi * offset_hz / fs * n + phase))
            ).astype(np.complex64)


def make_am_signal(fs, duration, offset_hz, f_audio=800.0, depth=0.6):
    n = np.arange(int(fs * duration))
    env = 1.0 + depth * np.sin(2 * np.pi * f_audio / fs * n)
    return (0.4 * env * np.exp(2j * np.pi * offset_hz / fs * n)).astype(np.complex64)


def run_chain(chain, x, fs, device, target_seconds=0.1):
    prog = build_program(chain, fs, target_seconds=target_seconds, device=device)
    n = len(x) // prog.block
    assert n >= 1, f"signal shorter than one block ({prog.block})"
    outs = []
    for blk in np.split(x[: n * prog.block], n):
        y, aux = prog.process(blk)
        outs.append(y)
    return outs, prog


class TestChains:
    class TestNfmEndToEnd:
        def test_nfm_recovers_tone(self, device):
            offset = 145000.0
            x = make_nfm_signal(FS, 0.5, offset)
            chain = ClientDemodulatorChain(FS, mode="nfm", compression="none")
            chain.set_frequency_offset(offset)
            chain.set_squelch_level(-150.0)
            outs, prog = run_chain(chain, x, FS, device)
            audio = np.concatenate([np.asarray(o) for o in outs]).astype(np.float32) / 32767
            assert prog.out_spec.rate == 12000.0
            # drop the first block (filter/AGC settle)
            settled = audio[len(audio) // 3:]
            snr = tone_snr(settled, 1000.0, 12000.0)
            assert snr > 20, f"NFM tone SNR {snr:.1f} dB"

        def test_smeter_reports_present(self, device):
            x = make_nfm_signal(FS, 0.2, 0.0)
            chain = ClientDemodulatorChain(FS, mode="nfm", compression="none")
            outs, prog = run_chain(chain, x, FS, device)
            y, aux = prog.process(x[: prog.block])
            keys = [k for k in aux if "power_db" in k]
            assert keys, f"no s-meter tap in {list(aux)}"
            power = np.asarray(aux[keys[0]])
            assert power.shape[-1] >= 1

        def test_squelch_closes_on_noise(self, device):
            rng = np.random.default_rng(0)
            x = (rng.standard_normal(int(FS * 0.2)) * 1e-5 +
                 1j * rng.standard_normal(int(FS * 0.2)) * 1e-5).astype(np.complex64)
            chain = ClientDemodulatorChain(FS, mode="nfm", compression="none")
            chain.set_squelch_level(-40.0)
            outs, prog = run_chain(chain, x, FS, device)
            audio = np.concatenate([np.asarray(o) for o in outs])
            assert np.abs(audio).max() == 0

    class TestAmSsbEndToEnd:
        def test_am_recovers_tone(self, device):
            offset = -200000.0
            x = make_am_signal(FS, 0.5, offset)
            chain = ClientDemodulatorChain(FS, mode="am", compression="none")
            chain.set_frequency_offset(offset)
            outs, prog = run_chain(chain, x, FS, device)
            audio = np.concatenate([np.asarray(o) for o in outs]).astype(np.float32) / 32767
            settled = audio[len(audio) // 2:]
            snr = tone_snr(settled, 800.0, 12000.0)
            assert snr > 15, f"AM tone SNR {snr:.1f} dB"

        def test_usb_recovers_tone(self, device):
            offset = 7000000 % 100000  # arbitrary
            f_audio = 1500.0
            n = np.arange(int(FS * 0.5))
            # USB: audio tone appears offset+f_audio in RF
            x = (0.3 * np.exp(2j * np.pi * (offset + f_audio) / FS * n)).astype(np.complex64)
            chain = ClientDemodulatorChain(FS, mode="usb", compression="none")
            chain.set_frequency_offset(offset)
            outs, prog = run_chain(chain, x, FS, device)
            audio = np.concatenate([np.asarray(o) for o in outs]).astype(np.float32) / 32767
            settled = audio[len(audio) // 2:]
            snr = tone_snr(settled, f_audio, 12000.0)
            assert snr > 20, f"USB tone SNR {snr:.1f} dB"

        def test_lsb_bandpass_rejects_usb_signal(self, device):
            # selector-level absolute rejection (the full chain would re-AGC the
            # residual): a +1.5 kHz tone must be crushed by an LSB passband
            f_audio = 1500.0
            n = np.arange(int(FS * 0.25))
            x = (0.5 * np.exp(2j * np.pi * f_audio / FS * n)).astype(np.complex64)
            sel = Selector(FS, 12000)
            sel.set_bandpass(-3000.0, -300.0)
            prog = Program(sel, StreamSpec(Format.COMPLEX_FLOAT, FS),
                           plan_block_size(sel, StreamSpec(Format.COMPLEX_FLOAT, FS), 0.1),
                           device=device)
            y, _ = prog.process(x[: prog.block])
            y, _ = prog.process(x[prog.block: 2 * prog.block])
            out_rms = np.sqrt(np.mean(np.abs(np.asarray(y)) ** 2))
            assert out_rms < 0.5 * 10 ** (-40 / 20), f"LSB leak RMS {out_rms:.2e}"

    class TestLiveControls:
        def test_mode_switch_rebuild(self, device):
            chain = ClientDemodulatorChain(FS, mode="nfm", compression="none")
            prog = build_program(chain, FS, target_seconds=0.05, device=device)
            x = make_am_signal(FS, 0.1, 0.0)
            prog.process(x[: prog.block])
            chain.set_mode("am")
            prog.rebuild()
            y, _ = prog.process(x[: prog.block])
            assert np.asarray(y).shape[-1] == prog.out_block

    class TestWaterfallChain:
        def test_waterfall_rows(self, device):
            chain = FftChain(fft_size=4096, fps=9)
            spec = StreamSpec(Format.COMPLEX_FLOAT, FS)
            block = plan_block_size(chain, spec, 0.2)
            prog = Program(chain, spec, block, device=device)
            n = np.arange(block)
            x = np.exp(2j * np.pi * 0.13 * n).astype(np.complex64)
            rows, _ = prog.process(x)
            rows = np.asarray(rows)
            assert rows.ndim == 2 and rows.shape[1] == 4096
            peak = rows[-1].argmax()
            expected = 4096 // 2 + int(round(0.13 * 4096))
            assert abs(int(peak) - expected) <= 1

        def test_compressed_waterfall_matches_host_encoder(self, device):
            """WaterfallStage(compress=True) must emit byte-identical wire
            payloads to the host-side compress_fft_rows path (the browser
            decoder is shared; reference FftAdpcm, csdr/chain/fft.py:44)."""
            spec = StreamSpec(Format.COMPLEX_FLOAT, FS)
            plain = FftChain(fft_size=512, fps=20)
            packed = FftChain(fft_size=512, fps=20, compress=True)
            block = plan_block_size(plain, spec, 0.2)
            rng = np.random.default_rng(3)
            x = ((rng.standard_normal(block) + 1j * rng.standard_normal(block))
                 * 0.2).astype(np.complex64)
            rows, _ = Program(plain, spec, block, device=device).process(x)
            words, _ = Program(packed, spec, block, device=device).process(x)
            ref = adpcm.compress_fft_rows(np.asarray(rows), device=device)
            nb = packed.waterfall.wire_bytes_per_row
            raw = np.atleast_2d(np.asarray(words))
            raw = raw.view(np.uint8).reshape(raw.shape[0], -1)
            assert raw.shape[0] == len(ref)
            for i, expected in enumerate(ref):
                assert raw[i, :nb].tobytes() == expected

    def test_uint8_wire_input_matches_float_path(self, device):
        """Packed (n,2) uint8 wire samples through a Program match the float
        path within 8-bit quantization (the rtl-sdr wire)."""
        fs = 96000.0
        sel = Selector(fs, 12000.0, with_squelch=False)
        sel.set_frequency_offset(10000.0)
        spec = StreamSpec(Format.COMPLEX_FLOAT, fs)
        prog = Program(sel, spec, 9600, device=device)
        rng = np.random.default_rng(3)
        x = (rng.standard_normal(9600) + 1j * rng.standard_normal(9600)) \
            .astype(np.complex64) * 0.3
        y_f, _ = Program(sel, spec, 9600, device=device).process(host_pack_complex(x))
        packed = host_pack_complex(x)
        u8 = np.clip(packed * 128.0 + 127.4, 0, 255).astype(np.uint8)
        y_u, _ = prog.process(u8)
        err = np.abs(np.asarray(y_u) - np.asarray(y_f))
        assert float(err.max()) < 0.02       # 8-bit quantization, filtered
