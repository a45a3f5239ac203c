"""The port's analog modes (openwebrx_tpu_torch) against the JAX reference.

Same numpy inputs, made from a seed, go through the JAX function and the
port's on the CPU, where the port's kernel wrappers run their plain
versions: the first-order IIR, the demodulators, the rational resampler,
the AGC, every new stage, the analog chains through ``Program`` (with a
mode switch), and the reference's oracle parity scenes through the port.
Each test states its tolerance.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from openwebrx_tpu.models import stages as jst
from openwebrx_tpu.models.receiver import (
    ClientDemodulatorChain as JaxClient, build_program as jax_build)
from openwebrx_tpu.ops import agc as jagc, demod as jdemod, fir as jfir, iir as jiir
from openwebrx_tpu.ops.formats import Format as JFormat, StreamSpec as JSpec
from openwebrx_tpu.runtime.chain import _unpack_leaf
from openwebrx_tpu.testing import capture as cap, oracle
from openwebrx_tpu_torch.from_jax import bank_state_from_numpy
from openwebrx_tpu_torch.models import stages as tst
from openwebrx_tpu_torch.models.analog import NFM_TAU, WFm
from openwebrx_tpu_torch.models.receiver import (
    ClientDemodulatorChain, build_program)
from openwebrx_tpu_torch.models.selector import Selector
from openwebrx_tpu_torch.ops import (agc as tagc, demod as tdemod, fir as tfir,
                                     firdes as tfirdes, iir as tiir)
from openwebrx_tpu_torch.ops.formats import Format as TFormat, StreamSpec as TSpec
from openwebrx_tpu_torch.runtime.chain import Chain, choose_block_size

CPU = "cpu"


def _cplx(rng, *shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, rel, what=""):
    """max |got − ref| ≤ rel · max |ref| (plus a floor for silent blocks)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    tol = rel * (float(np.max(np.abs(ref))) if ref.size else 0.0) + 1e-7
    assert err <= tol, (what, err, tol)


# ---------------------------------------------------------------- IIR --
class TestIir:
    @pytest.mark.parametrize("n", [1, 7, 256, 600, 2400])
    def test_linear_recurrence(self, n):
        # tolerance: a doubling scan against the reference's associative
        # scan tree, two float32 orders of ~log2(n) rounded steps each
        rng = np.random.default_rng(n)
        c = rng.standard_normal((3, n)).astype(np.float32)
        y0 = rng.standard_normal(3).astype(np.float32)
        for a in (0.99478, np.array([0.5, 0.878, -0.9], np.float32)):
            ref = jiir.linear_recurrence(
                jnp.asarray(a) if np.ndim(a) == 0 else jnp.asarray(a)[:, None],
                jnp.asarray(c), jnp.asarray(y0))
            got = tiir.linear_recurrence(
                a if np.ndim(a) == 0 else _t(a)[:, None], _t(c), _t(y0))
            _close(got.numpy(), ref, 2e-5, a)

    @pytest.mark.parametrize("coeffs", [
        jiir.dc_block_coeffs(12000.0),           # AM/SAM DC block
        jiir.deemphasis_coeffs(48000.0, 150e-6),  # NFM de-emphasis
        jiir.deemphasis_coeffs(48000.0, 50e-6),   # WFM de-emphasis
    ])
    def test_first_order_streamed_three_blocks(self, coeffs):
        """State (x_prev, y_prev) carried over three blocks."""
        # tolerance: the DC blocker's pole at 0.995 sums ~200 terms per
        # output; 1e-5 of the output scale covers both scan orders
        b0, b1, a1 = coeffs
        rng = np.random.default_rng(3)
        js = jiir.first_order_init((4,))
        ts = tiir.first_order_init((4,), device=CPU)
        for blk in range(3):
            x = (rng.standard_normal((4, 600)) + 0.3 * blk).astype(np.float32)
            js, jy = jiir.first_order_apply(js, b0, b1, a1, jnp.asarray(x))
            ts, ty = tiir.first_order_apply(ts, b0, b1, a1, _t(x), device=CPU)
            _close(ty.numpy(), jy, 1e-5, blk)
            np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js[0]))
            _close(ts[1].numpy(), js[1], 1e-5, "y_prev")

    def test_coefficients_identical(self):
        assert tiir.dc_block_coeffs(12000.0) == jiir.dc_block_coeffs(12000.0)
        assert (tiir.deemphasis_coeffs(48000.0, NFM_TAU)
                == jiir.deemphasis_coeffs(48000.0, NFM_TAU))


# ------------------------------------------------------------- demods --
class TestDemod:
    def test_fm_demod_with_silent_block(self):
        # tolerance: float32 complex product and atan2 in two libraries
        rng = np.random.default_rng(1)
        js, ts = jdemod.fm_init((3,)), tdemod.fm_init((3,), device=CPU)
        for blk in range(3):
            x = (_cplx(rng, 3, 480) if blk != 1
                 else np.zeros((3, 480), np.complex64))
            js, jy = jdemod.fm_demod(js, jnp.asarray(x))
            ts, ty = tdemod.fm_demod(ts, _t(x))
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=2e-6)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            assert ty.dtype == torch.float32
            if blk == 1:       # the zero-vector guard: silence stays silent
                assert not ty.numpy().any()

    def test_am_demod(self):
        # tolerance: float32 |x| (hypot) in two libraries, a few ulp
        x = _cplx(np.random.default_rng(2), 3, 600, scale=2.0)
        np.testing.assert_allclose(tdemod.am_demod(_t(x)).numpy(),
                                   np.asarray(jdemod.am_demod(jnp.asarray(x))),
                                   rtol=1e-6, atol=0)

    def test_sync_am_demod_streamed(self):
        """An AM carrier 30 Hz off centre, tracked over three blocks."""
        # tolerance: float32 sums of 600 rotations, sincos and atan2 in two
        # libraries; the carrier phase grows with the block index
        rng = np.random.default_rng(3)
        fs, b = 12000.0, 600
        js, ts = jdemod.sync_am_init((2,)), tdemod.sync_am_init((2,), device=CPU)
        for blk in range(3):
            n = np.arange(b) + blk * b
            env = 1.0 + 0.5 * np.sin(2 * np.pi * 400 * n / fs)
            car = np.exp(1j * (2 * np.pi * np.array([[30.0], [-55.0]]) * n / fs + 0.7))
            x = (0.4 * env * car + _cplx(rng, 2, b, scale=0.01)).astype(np.complex64)
            js, jy = jdemod.sync_am_demod(js, jnp.asarray(x))
            ts, ty = tdemod.sync_am_demod(ts, _t(x))
            _close(ty.numpy(), jy, 2e-5, blk)
            for a, r in zip(ts, js):
                np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=2e-6)


# ---------------------------------------------------------- resampler --
_RATES = [(24, 125), (125, 192), (3, 2)]


def _frac_taps(lgd, dec):
    """The taps FractionalDecimatorStage designs."""
    cut = 0.45 / max(lgd, dec)
    return tfirdes.lowpass_taps(cut, cut * 0.3) * lgd


class TestResample:
    @pytest.mark.parametrize("lgd,dec", _RATES)
    def test_polyphase_bank_identical(self, lgd, dec):
        taps = _frac_taps(lgd, dec)
        jb, jt, jd = jfir.polyphase_bank(taps, lgd, dec)
        tb, tt, td = tfir.polyphase_bank(taps, lgd, dec)
        np.testing.assert_array_equal(tb, jb)
        assert (tt, td) == (jt, jd) and tb.dtype == np.float32

    @pytest.mark.parametrize("complex_input", [False, True])
    @pytest.mark.parametrize("lgd,dec", _RATES)
    def test_resample_streamed(self, lgd, dec, complex_input):
        # tolerance: P-tap float32 dot products summed in another order
        bank, tail_len, _ = tfir.polyphase_bank(_frac_taps(lgd, dec), lgd, dec)
        rng = np.random.default_rng(lgd + dec)
        c, b = 2, dec * 8
        js = jfir.resample_init(tail_len, (c,), complex_input)
        ts = tfir.resample_init(tail_len, (c,), complex_input, device=CPU)
        for _ in range(3):
            x = (_cplx(rng, c, b) if complex_input
                 else rng.standard_normal((c, b)).astype(np.float32))
            js, jy = jfir.resample_apply(js, bank, jnp.asarray(x), lgd, dec)
            ts, ty = tfir.resample_apply(ts, _t(bank), _t(x), lgd, dec)
            assert ty.shape == (c, b * lgd // dec) and ty.dtype == (
                torch.complex64 if complex_input else torch.float32)
            _close(ty.numpy(), jy, 3e-6)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------- AGC --
class TestAgc:
    @pytest.mark.parametrize("profile", ["FAST", "SLOW"])
    def test_plain_matches_jax(self, profile):
        """At the NFM bank's block (2400 samples, 48 chunks of 50)."""
        # tolerance: identical float32 step arithmetic; the hang counters
        # are equal, the gains within the divide's rounding
        pj, pt = getattr(jagc, profile), getattr(tagc, profile)
        rng = np.random.default_rng(6)
        js, ts = jagc.agc_init(pj, (3,)), tagc.agc_init(pt, (3,), device=CPU)
        for blk in range(3):
            scale = np.array([[1.0], [0.01], [3.0]]) * (1 + blk)
            x = (rng.standard_normal((3, 2400)) * scale).astype(np.float32)
            js, jy = jagc.agc_apply(js, pj, jnp.asarray(x), 50)
            ts, ty = tagc.agc_apply(ts, pt, _t(x), 50, device=CPU)
            np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
            np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), rtol=1e-5)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- stages --
def _stage_pairs():
    return {
        "fractional": (lambda: jst.FractionalDecimatorStage(24, 125),
                       lambda: tst.FractionalDecimatorStage(24, 125),
                       True, 250000.0),
        "fm_demod": (jst.FmDemodStage, tst.FmDemodStage, True, 48000.0),
        "am_demod": (jst.AmDemodStage, tst.AmDemodStage, True, 12000.0),
        "sync_am": (jst.SyncAmStage, tst.SyncAmStage, True, 12000.0),
        "dc_block": (jst.DcBlockStage, tst.DcBlockStage, False, 12000.0),
        "deemphasis": (lambda: jst.DeemphasisStage(NFM_TAU),
                       lambda: tst.DeemphasisStage(NFM_TAU), False, 48000.0),
        "rds_tap": (jst.RdsTapStage, tst.RdsTapStage, False, 250000.0),
    }


class TestStages:
    @pytest.mark.parametrize("kind", sorted(_stage_pairs()))
    def test_stage_matches_jax(self, kind):
        # tolerance: the op tests' float32 orders, 3e-5 of the output scale;
        # sync AM mixes with a float32 phase ramp that reaches ~125 rad in
        # this block (ulp 7.6e-6 rad), where a last-bit difference in the
        # estimated frequency grows 2000-fold: 3e-4
        rel = 3e-4 if kind == "sync_am" else 3e-5
        mk_j, mk_t, cplx, rate = _stage_pairs()[kind]
        sj, stt = mk_j(), mk_t()
        block = 2000
        spec_j = JSpec(JFormat.COMPLEX_FLOAT if cplx else JFormat.FLOAT, rate)
        spec_t = TSpec(TFormat.COMPLEX_FLOAT if cplx else TFormat.FLOAT, rate)
        out_j, ob_j = sj.plan(spec_j, block)
        out_t, ob_t = stt.plan(spec_t, block)
        assert (ob_t, out_t.rate, out_t.format.value) == (ob_j, out_j.rate, out_j.format.value)
        assert stt.signature() == sj.signature()
        assert stt.label == sj.label
        assert (stt.ratio(spec_t), stt.divisor(spec_t)) == (sj.ratio(spec_j), sj.divisor(spec_j))
        rng = np.random.default_rng(len(kind))
        js, ts = sj.init_state((2,)), stt.init_state((2,), torch.device("cpu"))
        pj, pt = sj.params(), stt.params(torch.device("cpu"))
        n = np.arange(block)
        for blk in range(2):
            tone = np.exp(2j * np.pi * (0.01 * n + blk * block * 0.01))
            x = 0.5 * tone + _cplx(rng, 2, block, scale=0.05)
            x = (x if cplx else x.real).astype(np.complex64 if cplx else np.float32)
            js, jy, ja = sj.apply(js, pj, jnp.asarray(x))
            ts, ty, ta = stt.apply(ts, pt, _t(x))
            _close(ty.numpy(), jy, rel, kind)
            assert set(ta) == set(ja)
            for k in ja:
                assert ta[k].dtype == torch.complex64
                _close(ta[k].numpy(), ja[k], 3e-5, k)


    def test_secondary_selector_matches_jax(self):
        """SecondarySelector (shift + narrow bandpass) on two channels, two
        blocks; the stage tests' tolerance."""
        from openwebrx_tpu.models.selector import SecondarySelector as JaxSec
        from openwebrx_tpu_torch.models.selector import SecondarySelector
        rate, block = 12000.0, 1200
        sj, stt = JaxSec(rate, 500.0), SecondarySelector(rate, 500.0)
        for s in (sj, stt):
            s.set_frequency_offset(np.array([1500.0, -900.0]))
        sj.plan(JSpec(JFormat.COMPLEX_FLOAT, rate), block)
        stt.plan(TSpec(TFormat.COMPLEX_FLOAT, rate), block)
        assert stt.signature() == sj.signature() and stt.label == sj.label
        js, ts = sj.init_state((2,)), stt.init_state((2,), torch.device(CPU))
        pj, pt = sj.params(), stt.params(torch.device(CPU))
        rng = np.random.default_rng(31)
        n = np.arange(block)
        for blk in range(2):
            x = (0.5 * np.exp(2j * np.pi * 1600.0 / rate * (n + blk * block))
                 + _cplx(rng, 2, block, scale=0.05)).astype(np.complex64)
            js, jy, _ = sj.apply(js, pj, jnp.asarray(x))
            ts, ty, _ = stt.apply(ts, pt, _t(x))
            _close(ty.numpy(), jy, 3e-5, "secondary selector")

    def test_set_slot_bandpass_matches_jax(self):
        """One slot of a batched bandpass changed: the response and a
        block through the stage equal the JAX stage's (stage tolerance)."""
        rate, block = 24000.0, 2400
        sj = jst.BandpassStage(np.array([-3000.0, 300.0, -5000.0]),
                               np.array([-300.0, 3000.0, 5000.0]))
        stt = tst.BandpassStage(np.array([-3000.0, 300.0, -5000.0]),
                                np.array([-300.0, 3000.0, 5000.0]))
        sj.plan(JSpec(JFormat.COMPLEX_FLOAT, rate), block)
        stt.plan(TSpec(TFormat.COMPLEX_FLOAT, rate), block)
        for s in (sj, stt):
            s.set_slot_bandpass(1, 500.0, 2500.0)
        np.testing.assert_array_equal(stt._low, [-3000.0, 500.0, -5000.0])
        np.testing.assert_array_equal(stt._high, sj._high)
        np.testing.assert_array_equal(stt._response, sj._response)
        js, ts = sj.init_state((3,)), stt.init_state((3,), torch.device(CPU))
        x = _cplx(np.random.default_rng(32), 3, block, scale=0.3)
        _, jy, _ = sj.apply(js, sj.params(), jnp.asarray(x))
        _, ty, _ = stt.apply(ts, stt.params(torch.device(CPU)), _t(x))
        _close(ty.numpy(), jy, 3e-5, "slot bandpass")

# ------------------------------------------------------------- chains --
def _tone_iq(fs, block, nblocks, offset, mode, seed=0):
    """One modulated carrier at ``offset`` plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(block * nblocks) / fs
    audio = np.sin(2 * np.pi * 700 * t)
    if mode in ("nfm", "wfm"):
        dev = 75000.0 if mode == "wfm" else 3000.0
        x = 0.5 * np.exp(1j * (2 * np.pi * offset * t
                               + 2 * np.pi * dev * np.cumsum(audio) / fs))
    else:
        x = 0.4 * (1 + 0.6 * audio) * np.exp(2j * np.pi * offset * t)
    x = x + 0.01 * (rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)))
    return np.split(x.astype(np.complex64), nblocks)


def _jax_state_numpy(obj):
    """A JAX Program's or bank's state with complex leaves as complex64."""
    return jax.tree.map(lambda v, c: np.asarray(_unpack_leaf(v, c)),
                        obj.state, obj._s_mask)


class TestChainsThroughProgram:
    # int16 audio after AGC and the client-audio legs: float32 drift of the
    # ops above, amplified by the AGC gain, stays within a few LSB
    AUDIO_LSB = 4

    @pytest.mark.parametrize("mode,fs", [("nfm", 240000.0), ("am", 240000.0),
                                         ("sam", 240000.0), ("wfm", 500000.0)])
    def test_chain_and_mode_switch(self, mode, fs):
        """Block 0 on both sides, then the JAX Program's state handed to the
        port's, then three more blocks of ``mode`` and, after
        set_mode('am') + rebuild() on both sides (the selector's state
        carries over), two blocks of AM.

        The handover is what makes the FM modes comparable: at stream start
        the FFT bandpass's outputs are ~1e-7 with absolute rounding noise of
        ~1e-8, so the discriminator's first samples are noise in any two
        float32 implementations, and the FAST AGC keeps the different
        startup peaks in its gain for seconds."""
        jc = JaxClient(fs, mode=mode, compression="none")
        tc = ClientDemodulatorChain(fs, mode=mode, compression="none")
        for c in (jc, tc):
            c.set_frequency_offset(20000.0)
        jp = jax_build(jc, fs, target_seconds=0.05)
        tp = build_program(tc, fs, target_seconds=0.05, device=CPU)
        assert tp.block == jp.block and tp.out_block == jp.out_block
        blocks = _tone_iq(fs, tp.block, 6, 20000.0, mode)
        jp.process(blocks[0])
        y0, _ = tp.process(blocks[0])
        assert y0.dtype == np.int16 and y0.shape == (tp.out_block,)
        tp.state = bank_state_from_numpy(_jax_state_numpy(jp), CPU)
        for i, blk in enumerate(blocks[1:], start=1):
            if i == 4:
                for c, p in ((jc, jp), (tc, tp)):
                    c.set_mode("am")
                    c.set_frequency_offset(20000.0)
                    p.rebuild()
            yj, aj = jp.process(blk)
            yt, at = tp.process(blk)
            yj = np.asarray(yj)
            assert yt.dtype == np.int16 and yt.shape == yj.shape
            d = np.abs(yt.astype(np.int32) - yj.astype(np.int32)).max()
            assert d <= self.AUDIO_LSB, (mode, i, d)
            assert set(at) == set(aj)
            for k in aj:
                if np.iscomplexobj(aj[k]):
                    _close(at[k], aj[k], 1e-4, k)
                else:
                    np.testing.assert_allclose(at[k], np.asarray(aj[k]), rtol=0, atol=1e-3)
        assert np.abs(yt).max() > 1000            # the tone came through

    def test_wfm_rds_aux_shape(self):
        tc = ClientDemodulatorChain(500000.0, mode="wfm", compression="adpcm")
        tp = build_program(tc, 500000.0, target_seconds=0.05, device=CPU)
        (data, strides), aux = tp.process(_tone_iq(500000.0, tp.block, 1, 0.0, "wfm")[0])
        rds = aux["wfm.rds_tap.rds"]
        assert rds.dtype == np.complex64 and rds.shape == (tp.block // 2 // 16,)
        assert data.dtype == np.uint8 and data.shape == (tp.out_block,)
        assert np.isfinite(rds).all()

    def test_modes_rates_and_errors(self):
        from openwebrx_tpu.models.receiver import DEMOD_FACTORY as JF
        from openwebrx_tpu_torch.models.receiver import DEMOD_FACTORY as TF
        assert set(TF) == set(JF)
        for mode in TF:
            c = ClientDemodulatorChain(500000.0, mode=mode, compression="none")
            assert c.mode == mode
        with pytest.raises(KeyError):
            ClientDemodulatorChain(500000.0, mode="dmr")
        with pytest.raises(ValueError):
            ClientDemodulatorChain(200000.0, mode="wfm")

    @pytest.mark.parametrize("rate,target,divisors", [
        (2.4e6, 0.1, (50, 4)), (48000.0, 0.05, (125, 192, 0)), (250000.0, 0.2, ())])
    def test_choose_block_size(self, rate, target, divisors):
        from openwebrx_tpu.runtime.chain import choose_block_size as jchoose
        got = choose_block_size(rate, target, *divisors)
        assert got == jchoose(rate, target, *divisors)
        assert all(got % d == 0 for d in divisors if d > 0)

    def test_program_checks_block(self):
        tp = build_program(ClientDemodulatorChain(240000.0, mode="nfm"),
                           240000.0, target_seconds=0.05, device=CPU)
        with pytest.raises(ValueError):
            tp.process(np.zeros(tp.block - 1, np.complex64))


# --------------------------------------------- oracle parity (golden) --
def _run_port(chain, x, in_rate=cap.FS, target_seconds=0.1):
    prog = build_program(chain, in_rate, target_seconds=target_seconds, device=CPU)
    n = (len(x) // prog.block) * prog.block
    outs = [prog.process(x[i:i + prog.block])[0] for i in range(0, n, prog.block)]
    return np.concatenate([np.asarray(o).reshape(-1) for o in outs])


def _sel(offset, out_rate, low, high):
    sel = Selector(cap.FS, out_rate, with_squelch=False)
    sel.set_frequency_offset(offset)
    sel.set_bandpass(low, high)
    return sel


def _settled(y, rate, skip_s=0.06):
    return y[int(skip_s * rate):]


@pytest.fixture(scope="module")
def scene():
    return cap.make_capture(duration_s=0.4)


class TestOracleParity:
    """The scenes and bounds of tests/test_parity_golden.py, run through the
    port: selector IQ ≥ 45 dB, NFM and AM pre-AGC ≥ 35 dB, WFM ≥ 25 dB."""

    def test_selector_iq(self, scene):
        ours = _run_port(_sel(cap.NFM_OFFSET, 48000.0, -4000.0, 4000.0), scene)
        ref = oracle.selector(np.asarray(scene, np.complex128), cap.FS, 48000.0,
                              cap.NFM_OFFSET, -4000.0, 4000.0)
        n = min(len(ours), len(ref))
        snr = oracle.snr_db(_settled(ref[:n], 48000), _settled(ours[:n], 48000))
        assert snr >= 45.0, snr

    def test_nfm_pre_agc(self, scene):
        chain = Chain([_sel(cap.NFM_OFFSET, 48000.0, -4000.0, 4000.0),
                       tst.FmDemodStage(), tst.LimitStage(),
                       tst.DeemphasisStage(NFM_TAU, name="deemph")], name="nfm_parity")
        ours = _run_port(chain, scene)
        ref = oracle.nfm_chain(np.asarray(scene, np.complex128), cap.FS, 48000.0,
                               cap.NFM_OFFSET, tau=NFM_TAU)
        n = min(len(ours), len(ref))
        snr = oracle.snr_db(_settled(ref[:n], 48000), _settled(ours[:n], 48000))
        assert snr >= 35.0, snr

    def test_am_pre_agc(self, scene):
        chain = Chain([_sel(cap.AM_OFFSET, 12000.0, -4000.0, 4000.0),
                       tst.AmDemodStage(), tst.DcBlockStage()], name="am_parity")
        ours = _run_port(chain, scene)
        ref = oracle.am_chain(np.asarray(scene, np.complex128), cap.FS, 12000.0,
                              cap.AM_OFFSET)
        n = min(len(ours), len(ref))
        snr = oracle.snr_db(_settled(ref[:n], 12000), _settled(ours[:n], 12000))
        assert snr >= 35.0, snr

    def test_wfm_audio(self, scene):
        sel = Selector(cap.FS, 250000.0, with_squelch=False)
        sel.set_frequency_offset(cap.NFM_OFFSET)
        sel.set_bandpass(-75000.0, 75000.0)
        chain = Chain([sel, WFm(audio_rate=48000, rds=False)], name="wfm_parity")
        ours = _run_port(chain, scene)
        ref = oracle.wfm_chain(np.asarray(scene, np.complex128), cap.FS, cap.NFM_OFFSET)
        _, r, t = oracle.align(_settled(ref, 48000), _settled(ours, 48000),
                               max_lag=512)
        assert oracle.snr_db(r, t) >= 25.0
