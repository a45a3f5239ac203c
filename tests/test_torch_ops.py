"""The port's ops (openwebrx_tpu_torch.ops) against the JAX reference.

Same numpy inputs, made from a seed, go through the JAX function and the
port's function on the CPU.  Integer outputs (NCO phase, squelch gates,
int16 audio) must be equal; float outputs match within the tolerance each
test states.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from openwebrx_tpu.ops import (agc as jagc, bandpass as jbp, channelizer as jpfb,
                               convert as jconv, demod as jdemod, fir as jfir,
                               firdes as jfirdes, formats as jformats, nco as jnco,
                               noisefilter as jnr, squelch as jsq)
from openwebrx_tpu_torch.ops import (agc as tagc, bandpass as tbp, channelizer as tpfb,
                                     convert as tconv, demod as tdemod, fir as tfir,
                                     firdes as tfirdes, formats as tformats,
                                     nco as tnco, noisefilter as tnr, squelch as tsq)

CPU = "cpu"


def _cplx(rng, *shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestHostCopies:
    def test_filter_designs_identical(self):
        """The port's numpy copies design the same 'weights', bit for bit."""
        for m, p in ((16, 16), (1024, 16), (64, 25)):
            np.testing.assert_array_equal(tpfb.design_prototype(m, p),
                                          jpfb.design_prototype(m, p))
        np.testing.assert_array_equal(tfirdes.lowpass_taps(0.125, 0.0375),
                                      jfirdes.lowpass_taps(0.125, 0.0375))
        lo, hi = np.array([0.025, -0.25]), np.array([0.25, -0.025])
        np.testing.assert_array_equal(
            tfirdes.bandpass_response_batch(lo, hi, 0.0267, 1024),
            jfirdes.bandpass_response_batch(lo, hi, 0.0267, 1024))
        np.testing.assert_array_equal(tpfb.channel_frequencies(16, 1.92e6),
                                      jpfb.channel_frequencies(16, 1.92e6))
        assert ([f.value for f in tformats.Format]
                == [f.value for f in jformats.Format])


class TestChannelize:
    def _run_port(self, proto, x, m, blocks=1):
        tail = tpfb.channelizer_init(m, len(proto) // m, device=CPU)
        outs = []
        for blk in np.split(x, blocks):
            tail, y = tpfb.channelize(tail, proto, _t(blk), m, device=CPU)
            outs.append(y.numpy())
        return np.concatenate(outs, axis=1)

    def test_matches_jax_with_carried_tail(self):
        # tolerance: fp32 fold and FFT sums in another order than XLA's conv
        m, p = 32, 16
        proto = tpfb.design_prototype(m, p)
        x = _cplx(np.random.default_rng(0), m * 400)
        jtail = jpfb.channelizer_init(m, p)
        ref = []
        for blk in np.split(x, 4):
            jtail, y = jpfb.channelize(jtail, proto, jnp.asarray(blk), m)
            ref.append(np.asarray(y))
        got = self._run_port(proto, x, m, blocks=4)
        np.testing.assert_allclose(got, np.concatenate(ref, axis=1),
                                   rtol=0, atol=2e-6)

    def test_tones_land_in_their_channels(self):
        m, fs = 16, 160000.0
        proto = tpfb.design_prototype(m)
        freqs = tpfb.channel_frequencies(m, fs)
        n = np.arange(m * 2000)
        x = sum(np.exp(2j * np.pi * freqs[k] / fs * n) for k in (2, 5, 13))
        y = self._run_port(proto, x.astype(np.complex64), m)
        assert y.shape == (m, len(n) // m)
        power = np.mean(np.abs(y) ** 2, axis=1)
        assert set(np.flatnonzero(power > 0.2)) == {2, 5, 13}
        quiet = np.delete(power, [2, 5, 13])
        assert 10 * np.log10(quiet.max() / power[2]) < -40

    def test_offset_tone_appears_at_offset(self):
        m, fs = 8, 80000.0
        proto = tpfb.design_prototype(m)
        delta = 1200.0
        n = np.arange(m * 4000)
        x = np.exp(2j * np.pi * (30000 + delta) / fs * n).astype(np.complex64)
        ch = self._run_port(proto, x, m)[3][500:]
        ch_rate = fs / m
        spec = np.abs(np.fft.fft(ch * np.hanning(len(ch))))
        f = np.fft.fftfreq(len(ch), 1 / ch_rate)
        assert abs(f[np.argmax(spec)] - delta) < ch_rate / len(ch) * 2

    def test_streaming_continuity(self):
        m = 8
        proto = tpfb.design_prototype(m)
        x = _cplx(np.random.default_rng(0), 8 * 3000)
        np.testing.assert_allclose(self._run_port(proto, x, m, blocks=3),
                                   self._run_port(proto, x, m), atol=1e-4)

    def test_matches_direct_downconversion(self):
        import scipy.signal as sig

        m, fs = 8, 96000.0
        proto = tpfb.design_prototype(m)
        rng = np.random.default_rng(1)
        base = rng.standard_normal(2000) + 1j * rng.standard_normal(2000)
        nb = sig.lfilter(sig.firwin(101, 0.04), 1, np.repeat(base, 12))[: m * 2800]
        f2 = tpfb.channel_frequencies(m, fs)[2]
        n = np.arange(len(nb))
        x = (nb * np.exp(2j * np.pi * f2 / fs * n)).astype(np.complex64)
        ch = self._run_port(proto, x, m)[2]
        direct = sig.lfilter(np.asarray(proto, np.float64), 1,
                             x * np.exp(-2j * np.pi * f2 / fs * n))[::m]
        best = None
        for lag in (-2, -1, 0, 1, 2):
            a, b = ch[200:2500], direct[200:2500]
            if lag > 0:
                a, b = a[lag:], b[: len(a) - lag]
            elif lag < 0:
                b, a = b[-lag:], a[: len(b) + lag]
            n2 = min(len(a), len(b))
            err = np.abs(a[:n2] - b[:n2]).max()
            best = err if best is None else min(best, err)
        assert best < 5e-2


class TestNco:
    def test_phase_bit_exact_and_output_close(self):
        """Negative rates, rates near ±0.5 and near 0, over 50 blocks."""
        rates = [0.0, 0.1234567, -0.3, 0.4999999, -0.4999999, 1e-9, -1e-9, 0.25]
        rng = np.random.default_rng(5)
        fixed = jnco.rate_to_fixed(np.array(rates))
        np.testing.assert_array_equal(tnco.rate_to_fixed(np.array(rates)), fixed)
        c = len(rates)
        jph = jnco.shift_init((c,))
        tph = tnco.shift_init((c,), device=CPU)
        for _ in range(50):
            x = _cplx(rng, c, 2400)
            jph, jy = jnco.shift_apply(jph, jnp.asarray(fixed), jnp.asarray(x))
            tph, ty = tnco.shift_apply(tph, _t(fixed), _t(x))
            np.testing.assert_array_equal(tph.numpy(), np.asarray(jph))
        # float32 sincos in two libraries: a few ulp on unit phasors
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=5e-6)

    def test_scalar_rate_broadcasts(self):
        fixed = jnco.rate_to_fixed(-0.2)
        x = _cplx(np.random.default_rng(1), 3, 600)
        jph, jy = jnco.shift_apply(jnco.shift_init((3,)), jnp.asarray(fixed), jnp.asarray(x))
        tph, ty = tnco.shift_apply(tnco.shift_init((3,), device=CPU), _t(fixed), _t(x))
        np.testing.assert_array_equal(tph.numpy(), np.asarray(jph))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=5e-6)


class TestFilters:
    def test_fir_decimate_complex_and_real(self):
        # tolerance: 107-tap fp32 dot products summed in another order
        rng = np.random.default_rng(2)
        taps = tfirdes.lowpass_taps(0.125, 0.0375)
        jt = jfir.fir_init(len(taps), (3,))
        tt = tfir.fir_init(len(taps), (3,), device=CPU)
        jr = jfir.fir_init(len(taps), (2,), complex_input=False)
        tr = tfir.fir_init(len(taps), (2,), complex_input=False, device=CPU)
        for _ in range(3):
            x = _cplx(rng, 3, 2400)
            jt, jy = jfir.fir_apply(jt, taps, jnp.asarray(x), 4)
            tt, ty = tfir.fir_apply(tt, _t(taps), _t(x), 4)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=2e-6)
            xr = rng.standard_normal((2, 600)).astype(np.float32)
            jr, jyr = jfir.fir_apply(jr, taps, jnp.asarray(xr), 1)
            tr, tyr = tfir.fir_apply(tr, _t(taps), _t(xr), 1)
            np.testing.assert_allclose(tyr.numpy(), np.asarray(jyr), rtol=0, atol=2e-6)
        assert ty.shape == (3, 600)

    def test_bandpass_per_channel_response(self):
        # tolerance: fp32 FFT round trip of unit-scale data, nfft 1024
        rng = np.random.default_rng(3)
        ntaps, block = 151, 600
        nfft = tbp.plan_nfft(ntaps, block)
        assert nfft == jbp.plan_nfft(ntaps, block) == 1024
        resp = jfirdes.bandpass_response_batch(
            np.array([0.025, -0.25, 0.0]), np.array([0.25, -0.025, 0.3]),
            320 / 12000, nfft)
        jt, tt = jbp.bandpass_init(ntaps, (3,)), tbp.bandpass_init(ntaps, (3,), device=CPU)
        for _ in range(3):
            x = _cplx(rng, 3, block)
            jt, jy = jbp.bandpass_apply(jt, jnp.asarray(resp), jnp.asarray(x), ntaps, nfft)
            tt, ty = tbp.bandpass_apply(tt, _t(resp), _t(x), ntaps, nfft)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=3e-6)


class TestSquelch:
    def test_gates_exact_and_no_negative_zero(self):
        """Gates and hang state equal the reference; a closed window
        outputs +0.0 even where its input is −0.0 (where, not a multiply)."""
        rng = np.random.default_rng(4)
        c, nw, window = 3, 6, 100
        level = np.array([-150.0, -20.0, -3.0], np.float32)
        js, ts = jsq.squelch_init((c,)), tsq.squelch_init((c,), device=CPU)
        neg_zero = np.complex64(complex(-0.0, -0.0))
        gated_neg_zero = 0
        for _ in range(6):
            loud = rng.random((c, nw, 1)) < 0.4
            x = np.where(loud, _cplx(rng, c, nw, window), neg_zero
                         ).reshape(c, -1).astype(np.complex64)
            js, jy, jp = jsq.squelch_apply(js, jnp.asarray(level), jnp.asarray(x), window)
            ts, ty, tp = tsq.squelch_apply(ts, _t(level), _t(x), window)
            for a, b in zip(ts, js):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            y, yj = ty.numpy(), np.asarray(jy)
            np.testing.assert_array_equal(y, yj)
            np.testing.assert_array_equal(np.signbit(y.view(np.float32)),
                                          np.signbit(yj.view(np.float32)))
            gated_neg_zero += int((np.signbit(x.view(np.float32))
                                   & ~np.signbit(y.view(np.float32))).sum())
            # power in dB: fp32 mean of |x|² then log10
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-4)
        assert gated_neg_zero > 0


class TestAudioOps:
    def test_agc_slow_and_fast(self):
        # tolerance: identical fp32 step arithmetic; the one difference is
        # fp32 max/abs of the chunk envelope (exact) and the divide
        rng = np.random.default_rng(6)
        for prof_j, prof_t in ((jagc.SLOW, tagc.SLOW), (jagc.FAST, tagc.FAST)):
            js, ts = jagc.agc_init(prof_j, (3,)), tagc.agc_init(prof_t, (3,), device=CPU)
            for blk in range(4):
                scale = np.array([[1.0], [0.01], [3.0]]) * (1 + blk)
                x = (rng.standard_normal((3, 600)) * scale).astype(np.float32)
                js, jy = jagc.agc_apply(js, prof_j, jnp.asarray(x), 50)
                ts, ty = tagc.agc_apply(ts, prof_t, _t(x), 50, device=CPU)
                np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
                np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), rtol=1e-5)
                np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)

    def test_noise_filter(self):
        # tolerance: rfft/irfft of 1024 points in fp32 and the 25th
        # percentile (same linear interpolation) of the magnitudes
        rng = np.random.default_rng(7)
        hop = 300
        thr = np.array([-100.0, 0.0, 6.0], np.float32)
        js, ts = jnr.nr_init((3,), hop), tnr.nr_init((3,), hop, device=CPU)
        for _ in range(4):
            t = np.arange(600)
            x = (0.3 * np.sin(2 * np.pi * 700 / 12000 * t)
                 + 0.05 * rng.standard_normal((3, 600))).astype(np.float32)
            js, jy = jnr.nr_apply(js, jnp.asarray(thr), jnp.asarray(x), hop)
            ts, ty = tnr.nr_apply(ts, _t(thr), _t(x), hop)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=2e-6)
            for a, b in zip(ts, js):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)

    def test_noise_filter_chunked_quantile(self, monkeypatch):
        """A spectrum above the quantile limit goes through torch.quantile
        in chunks of whole channels: with the limit lowered, a 5-channel
        bank chunks (2 channels a chunk), bit-identical to the unchunked
        port, and against JAX within test_noise_filter's tolerance."""
        rng = np.random.default_rng(17)
        hop = 300
        thr = np.array([-100.0, 0.0, 6.0, 3.0, -6.0], np.float32)
        per_channel = 2 * 513                  # 600 / hop frames of 513 bins
        js = jnr.nr_init((5,), hop)
        whole, chunked = (tnr.nr_init((5,), hop, device=CPU) for _ in range(2))
        calls = []
        quantile = torch.quantile

        def counted(t, *a, **kw):
            calls.append(tuple(t.shape))
            return quantile(t, *a, **kw)

        for _ in range(3):
            t = np.arange(600)
            x = (0.3 * np.sin(2 * np.pi * 700 / 12000 * t)
                 + 0.05 * rng.standard_normal((5, 600))).astype(np.float32)
            js, jy = jnr.nr_apply(js, jnp.asarray(thr), jnp.asarray(x), hop)
            whole, wy = tnr.nr_apply(whole, _t(thr), _t(x), hop)
            with monkeypatch.context() as mp:
                mp.setattr(tnr, "QUANTILE_LIMIT", 2 * per_channel)
                mp.setattr(torch, "quantile", counted)
                chunked, cy = tnr.nr_apply(chunked, _t(thr), _t(x), hop)
            assert torch.equal(cy, wy)
            assert all(torch.equal(a, b) for a, b in zip(chunked, whole))
            np.testing.assert_allclose(cy.numpy(), np.asarray(jy), rtol=0, atol=2e-6)
            np.testing.assert_allclose(chunked[2].numpy(), np.asarray(js[2]),
                                       rtol=1e-5, atol=1e-7)
        assert calls == [(2, 2, 513), (2, 2, 513), (1, 2, 513)] * 3
        with monkeypatch.context() as mp:
            mp.setattr(tnr, "QUANTILE_LIMIT", per_channel - 1)
            with pytest.raises(ValueError, match="one channel"):
                tnr.nr_apply(whole, _t(thr), _t(x), hop)

    def test_quantile_equals_percentile(self):
        mag = np.abs(np.random.default_rng(8).standard_normal((5, 2, 513))).astype(np.float32)
        np.testing.assert_array_equal(
            torch.quantile(_t(mag), 0.25, dim=-1, interpolation="linear").numpy(),
            np.asarray(jnp.percentile(jnp.asarray(mag), 25.0, axis=-1)))

    def test_float_to_short_exact(self):
        rng = np.random.default_rng(9)
        x = np.concatenate([
            rng.uniform(-1.2, 1.2, 5000),
            [1.0, -1.0, 1.5, -1.5, 0.0, -0.0, 0.99999, -0.99999,
             0.5 / 32767, -0.5 / 32767, 1.5 / 32767, -1.5 / 32767],
        ]).astype(np.float32)
        ref = np.asarray(jconv.float_to_short(jnp.asarray(x)))
        got = tconv.float_to_short(_t(x)).numpy()
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, ref)

    def test_ssb_detector_ops(self):
        rng = np.random.default_rng(10)
        x = _cplx(rng, 3, 100, scale=1.5)
        np.testing.assert_array_equal(tdemod.real_part(_t(x)).numpy(),
                                      np.asarray(jdemod.real_part(jnp.asarray(x))))
        r = x.real.astype(np.float32)
        np.testing.assert_array_equal(tdemod.limit(_t(r)).numpy(),
                                      np.asarray(jdemod.limit(jnp.asarray(r))))
        np.testing.assert_array_equal(tdemod.gain(_t(r), 2.0).numpy(),
                                      np.asarray(jdemod.gain(jnp.asarray(r), jnp.float32(2.0))))
