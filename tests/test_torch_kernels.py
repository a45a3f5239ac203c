"""The port's kernels (openwebrx_tpu_torch): polyphase fold, ADPCM encode,
first-order IIR, AGC and squelch.

On the CPU the wrappers run their plain PyTorch versions, which are held
against the JAX reference on the same numpy inputs.  The CUDA kernels are
held against those plain versions on a card in tests/test_torch_card.py,
which also makes the inputs both files share.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from openwebrx_tpu.ops import adpcm as jadpcm
from openwebrx_tpu.ops import channelizer as jpfb
from openwebrx_tpu.ops.pallas_fold import polyphase_fold as jax_fold
from openwebrx_tpu.ops import agc as jagc
from openwebrx_tpu.ops import iir as jiir
from openwebrx_tpu.ops import squelch as jsq
from openwebrx_tpu_torch import kernels
from openwebrx_tpu_torch.ops import adpcm as tadpcm
from openwebrx_tpu_torch.ops import agc as tagc
from openwebrx_tpu_torch.ops import iir as tiir
from openwebrx_tpu_torch.ops import channelizer as tpfb
from openwebrx_tpu_torch.ops import squelch as tsq
from openwebrx_tpu_torch.ops.fold import polyphase_fold

from test_torch_card import (SQUELCH_DB_ATOL, _audio_int16, _boundary_strides,
                             _fold_inputs, _squelch_scene, _state)


class TestFold:
    # tolerance: the plain version adds the same P products in the same
    # order as the interpreted Pallas kernel; 1e-6 of the output scale
    # leaves room for a fused multiply-add on either side
    @pytest.mark.parametrize("m,p,n_time", [
        (128, 16, 271),    # n_out 256: one Pallas tile exactly
        (64, 25, 324),     # P at the kernel's limit, n_out 300 (ragged)
        (16, 16, 100),     # n_out 85, narrow M
    ])
    def test_plain_matches_pallas_interpret(self, m, p, n_time):
        u, bank2 = _fold_inputs(m, p, n_time, seed=m + p)
        ref = np.asarray(jax_fold(jnp.asarray(u), jnp.asarray(bank2), p,
                                  interpret=True))
        got = polyphase_fold(torch.from_numpy(u), torch.from_numpy(bank2), p,
                             device="cpu").numpy()
        assert got.shape == (n_time - p + 1, m) == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())

    def test_fold_fft_twiddle_is_channelize(self):
        """The fold on channelize's own slice and bank, then FFT and twiddle,
        is the JAX channelize (its conv path)."""
        m, p = 32, 16
        rng = np.random.default_rng(3)
        x = (rng.standard_normal(m * 40) + 1j * rng.standard_normal(m * 40)
             ).astype(np.complex64)
        tail = jpfb.channelizer_init(m, p)
        _, ref = jpfb.channelize(tail, jpfb.design_prototype(m, p), jnp.asarray(x), m)
        xe = np.concatenate([np.zeros(p * m, np.complex64), x])
        nf = len(xe) // m
        up = xe[1:1 + (nf - 1) * m].reshape(nf - 1, m)
        bank2 = np.ascontiguousarray(tpfb.design_prototype(m, p).reshape(p, m)[::-1, ::-1])
        v = polyphase_fold(torch.from_numpy(up), torch.from_numpy(bank2), p,
                           device="cpu")
        tw = np.exp(-2j * np.pi * np.arange(m) / m).astype(np.complex64)
        got = (torch.fft.fft(v, dim=-1).numpy() * tw).T
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-6)

    def test_rejects_bad_shapes(self):
        u = torch.zeros(40, 16, dtype=torch.complex64)
        with pytest.raises(ValueError):
            polyphase_fold(u, torch.zeros(16, 8), 16, device="cpu")
        with pytest.raises(ValueError):
            polyphase_fold(u, torch.zeros(26, 16), 26, device="cpu")
        with pytest.raises(ValueError):
            polyphase_fold(u.real, torch.zeros(16, 16), 16, device="cpu")

    def test_default_device_needs_a_card(self):
        """Without device= the wrapper targets CUDA and never falls back:
        without a card it raises, with one it refuses CPU tensors."""
        u = torch.zeros(40, 16, dtype=torch.complex64)
        with pytest.raises((RuntimeError, ValueError)):
            polyphase_fold(u, torch.zeros(16, 16), 16)



class TestAdpcm:
    @pytest.mark.parametrize("channels,n", [(3, 600), (2, 1200)])
    def test_encode_bit_exact_across_blocks(self, channels, n):
        rng = np.random.default_rng(channels * n)
        jstate = jadpcm.adpcm_init((channels,))
        tstate = tadpcm.adpcm_init((channels,), device="cpu")
        for _ in range(4):
            x = _audio_int16(rng, channels, n)
            jstate, (jb, js) = jadpcm.adpcm_encode(jstate, jnp.asarray(x))
            tstate, (tb, ts) = tadpcm.adpcm_encode(tstate, torch.from_numpy(x))
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            for a, b in zip(tstate, jstate):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert tb.dtype == torch.uint8 and ts.dtype == torch.int32

    def test_sync_framer_stream_identical(self):
        rng = np.random.default_rng(11)
        jf, tf = jadpcm.SyncFramer(), tadpcm.SyncFramer()
        jstate = jadpcm.adpcm_init()
        tstate = tadpcm.adpcm_init(device="cpu")
        jwire, twire = bytearray(), bytearray()
        for _ in range(5):
            x = _audio_int16(rng, 1, 1200)[0]
            jstate, (jb, js) = jadpcm.adpcm_encode(jstate, jnp.asarray(x))
            tstate, (tb, ts) = tadpcm.adpcm_encode(tstate, torch.from_numpy(x))
            jwire += jf.frame(np.asarray(jb), np.asarray(js))
            twire += tf.frame(tb.numpy(), ts.numpy())
        assert bytes(twire) == bytes(jwire)
        assert twire.count(b"SYNC") == 5 * 6

    def test_decoder_matches_reference(self):
        rng = np.random.default_rng(4)
        data = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
        for state in ((0, 0), (-1200, 40), (32000, 88)):
            a, sa = tadpcm.adpcm_decode_np(data, state)
            b, sb = jadpcm.adpcm_decode_np(data, state)
            np.testing.assert_array_equal(a, b)
            assert sa == sb

    def test_encode_boundary_strides_match_jax(self):
        """Every table boundary of the index estimate (mean |dx| at, just
        below and just above each step value): bytes, stride states and
        carried state equal the reference's over two blocks."""
        x = _boundary_strides()
        jstate = jadpcm.adpcm_init((x.shape[0],))
        tstate = tadpcm.adpcm_init((x.shape[0],), device="cpu")
        for blk in (x, x[::-1].copy()):
            jstate, (jb, js) = jadpcm.adpcm_encode(jstate, jnp.asarray(blk))
            tstate, (tb, ts) = tadpcm.adpcm_encode(tstate, torch.from_numpy(blk))
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            for a, b in zip(tstate, jstate):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the estimates cover the whole table: index k at 199 k, k + 1 above
        est = ts.numpy() & 0xFFFF
        assert est.min() == 0 and est.max() == 88

    @pytest.mark.parametrize("n", [104, 200, 392])
    def test_plain_recurrence_matches_jax_sequential_encode(self, n):
        """The plain recurrence on lanes of any even length (chip_smoke.py
        times a build of the kernel with 52-byte strides against it) equals
        the reference's exact sequential encode from the same states."""
        rng = np.random.default_rng(n)
        x = _audio_int16(rng, 6, n)
        prev = rng.integers(-32768, 32767, 6, dtype=np.int32)
        idxs = rng.integers(0, 89, 6, dtype=np.int32)
        _, (jb, _) = jadpcm.adpcm_encode_seq(
            (jnp.asarray(prev), jnp.asarray(idxs)), jnp.asarray(x))
        tb = tadpcm.encode_strides_plain(torch.from_numpy(x), torch.from_numpy(prev),
                                         torch.from_numpy(idxs))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))

    def test_build_defines_name_their_own_library(self):
        short = kernels.CudaKernel("adpcm.cu", kernels.ADPCM.symbol,
                                   kernels.ADPCM.argtypes,
                                   defines=("ADPCM_STRIDE=52",))
        assert short.flags == [*kernels.NVCC_FLAGS, "-DADPCM_STRIDE=52"]
        assert kernels.ADPCM.flags == kernels.NVCC_FLAGS
        assert short.library_path() != kernels.ADPCM.library_path()

    def test_encode_rejects_bad_shapes(self):
        st = tadpcm.adpcm_init((2,), device="cpu")
        with pytest.raises(ValueError):
            tadpcm.adpcm_encode(st, torch.zeros(2, 300, dtype=torch.int16))
        with pytest.raises(ValueError):
            tadpcm.adpcm_encode(st, torch.zeros(3, 200, dtype=torch.int16))
        with pytest.raises(ValueError):
            tadpcm.adpcm_encode(st, torch.zeros(2, 200, dtype=torch.int32))

    def test_default_device_needs_a_card(self):
        s = torch.zeros(3, 200, dtype=torch.int16)
        z = torch.zeros(3, dtype=torch.int32)
        with pytest.raises((RuntimeError, ValueError)):
            tadpcm.encode_strides(s, z, z)



class TestIir:
    def test_plain_section_matches_jax(self):
        """The wrapper on CPU tensors is the plain version: the JAX
        section within 1e-5 of the output scale (two scan orders)."""
        b0, b1, a1 = jiir.dc_block_coeffs(12000.0)
        rng = np.random.default_rng(12)
        x = rng.standard_normal((5, 600)).astype(np.float32)
        x0, y0 = rng.standard_normal((2, 5)).astype(np.float32)
        (jx, jy_last), jy = jiir.first_order_apply(
            (jnp.asarray(x0), jnp.asarray(y0)), b0, b1, a1, jnp.asarray(x))
        (tx, ty_last), ty = tiir.first_order_apply(
            (torch.from_numpy(x0), torch.from_numpy(y0)), b0, b1, a1,
            torch.from_numpy(x), device="cpu")
        scale = np.abs(np.asarray(jy)).max()
        assert np.abs(ty.numpy() - np.asarray(jy)).max() <= 1e-5 * scale
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        assert abs(float(ty_last[0]) - float(jy_last[0])) <= 1e-5 * scale

    @pytest.mark.parametrize("shape,coeffs", [
        ((4800,), jiir.deemphasis_coeffs(48000.0, 150e-6)),   # config #1's one row
        ((4, 9600), jiir.deemphasis_coeffs(48000.0, 50e-6)),  # WFM-like rows
        ((3, 4801), jiir.dc_block_coeffs(48000.0)),           # DC blocker, a1 ≈ 0.9987
    ])
    def test_plain_matches_jax_on_long_rows(self, shape, coeffs):
        """Long rows, where the scan orders differ most: within 1e-5 of the
        output scale (float32 sums in another order), x_last identical."""
        b0, b1, a1 = coeffs
        rng = np.random.default_rng(sum(shape))
        x = rng.standard_normal(shape).astype(np.float32)
        x0, y0 = (np.asarray(v) for v in
                  rng.standard_normal((2,) + shape[:-1]).astype(np.float32))
        (jx, jy_last), jy = jiir.first_order_apply(
            (jnp.asarray(x0), jnp.asarray(y0)), b0, b1, a1, jnp.asarray(x))
        (tx, ty_last), ty = tiir.first_order_apply_plain(
            (torch.from_numpy(x0), torch.from_numpy(y0)), b0, b1, a1,
            torch.from_numpy(x))
        scale = np.abs(np.asarray(jy)).max()
        assert np.abs(ty.numpy() - np.asarray(jy)).max() <= 1e-5 * scale
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        assert np.abs(ty_last.numpy() - np.asarray(jy_last)).max() <= 1e-5 * scale

    def test_rejects_bad_shapes(self):
        z = torch.zeros(3)
        with pytest.raises(ValueError):
            tiir.first_order_apply((z, z), 1.0, 0.0, 0.5, torch.zeros(2, 8),
                                     device="cpu")
        with pytest.raises(ValueError):
            tiir.first_order_apply((z, z), 1.0, 0.0, 0.5,
                                     torch.zeros(3, 8, dtype=torch.float64),
                                     device="cpu")

    def test_default_device_needs_a_card(self):
        """Without device= the wrapper targets CUDA and never falls back."""
        z = torch.zeros(2)
        with pytest.raises((RuntimeError, ValueError)):
            tiir.first_order_apply((z, z), 1.0, -1.0, 0.9, torch.zeros(2, 8))



class TestAgc:
    def test_plain_section_matches_jax(self):
        rng = np.random.default_rng(13)
        x = (rng.standard_normal((4, 2400)) * [[0.01], [1.0], [5.0], [0.2]]).astype(np.float32)
        js, jy = jagc.agc_apply(jagc.agc_init(jagc.FAST, (4,)), jagc.FAST,
                                jnp.asarray(x), 50)
        ts, ty = tagc.agc_apply(tagc.agc_init(tagc.FAST, (4,), device="cpu"),
                                tagc.FAST, torch.from_numpy(x), 50, device="cpu")
        np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
        np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), rtol=1e-5)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)

    def test_plain_zero_rows_and_hang_step_match_jax(self):
        """All-zero rows (the gain runs to max_gain) and a silence to full
        scale step (attack arms the hang, which then counts down)."""
        x = np.zeros((3, 4800), np.float32)
        x[1, 2400:] = np.sin(np.arange(2400) * 0.3).astype(np.float32)
        x[2, 1000:1500] = 1.0
        for prof_j, prof_t in ((jagc.FAST, tagc.FAST), (jagc.SLOW, tagc.SLOW)):
            js, jy = jagc.agc_apply(jagc.agc_init(prof_j, (3,)), prof_j,
                                    jnp.asarray(x), 50)
            ts, ty = tagc.agc_apply(tagc.agc_init(prof_t, (3,), device="cpu"),
                                    prof_t, torch.from_numpy(x), 50, device="cpu")
            np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
            np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), rtol=1e-5)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
            assert float(ts[0][0]) == prof_t.max_gain       # silent row
            assert int(ts[1][1]) > 0         # the step armed the hang
            assert int(ts[1][2]) == 0        # it ran out after the pulse

    def test_rejects_bad_shapes(self):
        st = tagc.agc_init(tagc.SLOW, (2,), device="cpu")
        with pytest.raises(ValueError):
            tagc.agc_apply(st, tagc.SLOW, torch.zeros(2, 120), 50, device="cpu")
        with pytest.raises(ValueError):
            tagc.agc_apply(st, tagc.SLOW, torch.zeros(3, 100), 50, device="cpu")

    def test_default_device_needs_a_card(self):
        st = tagc.agc_init(tagc.FAST, (2,), device="cpu")
        with pytest.raises((RuntimeError, ValueError)):
            tagc.agc_apply(st, tagc.FAST, torch.zeros(2, 100), 50)



class TestSquelch:
    @pytest.mark.parametrize("dtype,n,window", [
        (np.complex64, 2400, 600),     # four windows a row
        (np.float32, 1200, 300),       # real input
        (np.complex64, 600, 600),      # one window, as the USB bank
    ])
    def test_plain_matches_jax(self, dtype, n, window):
        x, level = _squelch_scene(6, n, window, seed=n, dtype=dtype)
        rng = np.random.default_rng(1)
        st = _state(rng, 6)
        js, jy, jp = jsq.squelch_apply(tuple(jnp.asarray(v.numpy()) for v in st),
                                       jnp.asarray(level), jnp.asarray(x), window)
        ts, ty, tp = tsq.squelch_apply(st, torch.from_numpy(level),
                                       torch.from_numpy(x), window)
        jp = np.asarray(jp)
        finite = np.isfinite(jp)
        np.testing.assert_array_equal(np.isnan(tp.numpy()), np.isnan(jp))
        assert np.abs(tp.numpy()[finite] - jp[finite]).max() <= SQUELCH_DB_ATOL
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the gated output is +0.0 where closed, never −0.0
        closed = ty.numpy() == 0
        assert not np.signbit(ty.numpy().real[closed]).any()
        if n // window >= 4:
            # burst in window 1: open there and 2 windows on, closed in 3 of 4
            assert int(ts[1][2]) == 0 and not bool(ts[0][2])

    def test_plain_scalar_level_and_zero_dim_state(self):
        """One threshold for all rows, and config #1's 0-dim state."""
        x, _ = _squelch_scene(3, 1200, 300, seed=5)
        for xs, st in ((x, tsq.squelch_init((3,), device="cpu")),
                       (x[2], tsq.squelch_init((), device="cpu"))):
            js, jy, jp = jsq.squelch_apply(tuple(jnp.asarray(v.numpy()) for v in st),
                                           jnp.asarray(-30.0, jnp.float32),
                                           jnp.asarray(xs), 300)
            ts, ty, tp = tsq.squelch_apply(st, torch.tensor(-30.0),
                                           torch.from_numpy(xs), 300)
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
            assert tp.shape == jp.shape
            for a, b in zip(ts, js):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_rejects_bad_shapes(self):
        st = tsq.squelch_init((2,), device="cpu")
        lvl = torch.tensor(-150.0)
        with pytest.raises(ValueError):
            tsq.squelch_apply(st, lvl, torch.zeros(2, 500, dtype=torch.complex64), 300)
        with pytest.raises(ValueError):
            tsq.squelch_apply(st, lvl, torch.zeros(3, 600, dtype=torch.complex64), 300)
        with pytest.raises(ValueError):
            tsq.squelch_apply((st[0], st[1].to(torch.int64)), lvl,
                              torch.zeros(2, 600, dtype=torch.complex64), 300)

    def test_default_device_needs_a_card(self):
        """squelch_init's default device is CUDA: without a card it
        raises; the stage hands the apply its tensors' device."""
        with pytest.raises((RuntimeError, ValueError)):
            tsq.squelch_init((2,))



# The squelch kernel's launch plan at the shapes the paths give it
# (chip_smoke.SQUELCH_PATH_CASES) and at its check shapes: real rows of an
# odd length, 100-window rows, rows for the re-read branch, windows that
# straddle CTAs, one-sample windows, x at an unaligned address
PLAN_CASES = {"usb": (1024, 600, 600, 2), "nfm": (1024, 2400, 2400, 2),
              "am": (2048, 600, 600, 2), "wfm": (128, 50000, 12500, 2),
              "cfg1": (1, 4800, 2400, 2), "cfg2": (64, 600, 600, 2),
              "cfg2 edge": (16, 600, 600, 2), "cfg4": (16, 1536, 768, 2),
              "cfg3": (64, 2400, 800, 2), "cfg6": (256, 2400, 800, 2),
              "cfg6 edge": (16, 2400, 800, 2), "server nfm": (64, 9600, 3200, 2),
              "pod2": (512, 600, 600, 2), "real": (5, 4801, 4801, 1),
              "tiled": (3, 40000, 400, 2), "re-read": (2, 300000, 30000, 2),
              "straddle": (12, 15000, 5000, 2), "window 1": (16, 4800, 1, 2),
              "unaligned": (64, 2400, 800, 2, False), "ragged": (1023, 600, 600, 2),
              "million windows": (1, 1_000_000, 1, 2),
              "long row, long windows": (1, 17_000_000, 17000, 2),
              "longest window": (1, 29_050_000, 29050, 2),
              "real walked": (2, 300003, 3, 1), "past 2^31 floats": (65540, 16384, 16384, 2)}


class TestSquelchPlan:
    @pytest.mark.parametrize("label", list(PLAN_CASES))
    def test_plan_covers_each_sample_once(self, label):
        """Every float of every row lies in exactly one CTA's piece, and the
        plan's shared memory is what the kernel computes for it."""
        rows, n, window, cplx, *aligned = PLAN_CASES[label]
        p = tsq.squelch_plan(rows, n, window, cplx, *aligned)
        rowf = n * cplx
        owner = np.zeros(rowf, dtype=np.int8)
        if p.slice:
            assert p.grid == rows * p.cluster
            for rank in range(p.cluster):
                owner[rank * p.slice:min((rank + 1) * p.slice, rowf)] += 1
            assert (p.cluster - 1) * p.slice < rowf     # no CTA without a piece
            # a resident slice is staged whole; a streamed one in chunks
            assert p.reread(n, cplx) == (p.slice > p.stages * p.chunk)
            if not p.reread(n, cplx):
                assert p.stages == 1 and p.chunk >= p.slice
        else:
            assert p.cluster == 1 and p.grid == rows
            owner[:] += 1
            # the row in registers, or chunks of whole windows: the row in
            # one stage, else walked
            assert p.chunk % (window * cplx) == 0 and p.chunk <= rowf
            assert p.walks(n, cplx) == (p.chunk < rowf)
            if not p.walks(n, cplx):
                assert p.stages in (0, 1)
            if p.stages == 0:
                assert p.vec and tsq.fits_registers(n, window, cplx, p.warps)
        assert (owner == 1).all()
        assert p.smem == tsq.squelch_smem(n, window, cplx, p.warps, p.slice, p.chunk,
                                          p.stages)

    @pytest.mark.parametrize("label", list(PLAN_CASES))
    def test_plan_limits(self, label):
        """At most 8 CTAs a cluster and 8 warps a CTA, shared memory within
        227 KB, and slices only for rows past ROW_FLOATS, with enough CTAs
        to reach every SM there."""
        rows, n, window, cplx, *aligned = PLAN_CASES[label]
        p = tsq.squelch_plan(rows, n, window, cplx, *aligned)
        assert p.cluster in (1, 2, 4, 8) and 1 <= p.warps <= 8
        assert p.smem <= 227 * 1024 - 32 and (1 if p.slice else 0) <= p.stages <= 4
        if n * cplx <= tsq.ROW_FLOATS:
            assert p.slice == 0                       # a row a CTA
        if p.slice:
            assert p.slice <= max(tsq.ROW_FLOATS, -(-n * cplx // 8)) + 3
            assert p.grid >= min(tsq.SMS, rows * 8)

    @pytest.mark.parametrize("label", list(PLAN_CASES))
    def test_four_byte_path_exactly_where_unaligned(self, label):
        """The 4-byte copies are chosen exactly where a row, slice or chunk
        start is not 16-byte aligned (an odd float count, or x off 16)."""
        rows, n, window, cplx, *aligned = PLAN_CASES[label]
        p = tsq.squelch_plan(rows, n, window, cplx, *aligned)
        starts = [r * n * cplx + p.slice * k + p.chunk * j
                  for r in range(min(rows, 3)) for k in range(p.cluster)
                  for j in range(p.stages)]
        aligned_all = (aligned or [True])[0] and all(f % 4 == 0 for f in starts) \
            and (n * cplx) % 4 == 0
        assert p.vec == aligned_all

    def test_plan_cases_the_checks_need(self):
        """The check shapes reach what they are for: a window straddling two
        CTAs with a shorter last slice, the re-read branch streamed in
        chunks with a shorter last one, the 4-byte path, one CTA a row for
        a ragged row count."""
        p = tsq.squelch_plan(12, 15000, 5000, 2)
        wf = 10000
        assert p.cluster > 1 and 30000 - (p.cluster - 1) * p.slice < p.slice
        assert any(c * wf // p.slice != ((c + 1) * wf - 1) // p.slice for c in range(3))
        p = tsq.squelch_plan(2, 300000, 30000, 2)
        assert p.reread(300000, 2) and p.slice % p.chunk
        assert not tsq.squelch_plan(5, 4801, 4801, 1).vec
        assert not tsq.squelch_plan(64, 2400, 800, 2, aligned=False).vec
        assert tsq.squelch_plan(1023, 600, 600, 2).grid == 1023
        # registers at every rows-mode path shape but the server's NFM bank,
        # whose 76.8 KB rows are staged, as x at an unaligned address is
        for label in ("usb", "nfm", "am", "cfg1", "cfg2", "cfg2 edge", "cfg4", "cfg3",
                      "cfg6", "cfg6 edge", "pod2", "ragged"):
            assert tsq.squelch_plan(*PLAN_CASES[label]).stages == 0, label
        for label in ("server nfm", "unaligned", "real"):
            assert tsq.squelch_plan(*PLAN_CASES[label]).stages == 1, label
        # rows of more windows than shared memory holds are walked
        for shape in ((16, 4800, 1, 2), (1, 100000, 1, 2), (1, 1_000_000, 1, 2)):
            assert tsq.squelch_plan(*shape).walks(shape[1], shape[3])

    def test_plan_takes_every_window_the_tiled_kernel_took(self):
        """The squelch kernel before the cluster redesign walked any row in
        tiles of whole windows and took every window of up to 58100 floats
        (its one-window tile in 227 KB of shared memory): every such window
        still has a plan, on a row of one window and on one too long for
        slices, complex and real, and the windows past it have none."""
        for window, cplx in ((29050, 2), (58100, 1), (4, 2), (1, 1)):
            long_row = window * (8 * 2 ** 22 // (window * cplx) + 1)
            for n in (window, long_row):
                p = tsq.squelch_plan(1, n, window, cplx)
                assert p.smem <= 227 * 1024 - 32
            assert p.walks(long_row, cplx)
        for window, cplx in ((29051, 2), (58101, 1)):
            with pytest.raises(ValueError):
                tsq.squelch_plan(1, window * 1000, window, cplx)

    def test_plan_rejects_what_the_kernel_cannot_take(self):
        for args in ((0, 600, 600, 2), (4, 600, 7, 2), (4, 600, 600, 3),
                     (1, 2 ** 30, 2 ** 30, 2)):    # a row of 2^31 floats
            with pytest.raises(ValueError):
                tsq.squelch_plan(*args)
