"""The port's kernels (openwebrx_tpu_torch): polyphase fold, ADPCM encode,
first-order IIR, AGC and squelch.

On the CPU the wrappers run their plain PyTorch versions, which are held
against the JAX reference on the same numpy inputs.  The CUDA kernels are
held against those plain versions on a card (marker ``cuda``; they skip
where there is none).
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
from openwebrx_tpu_torch.ops.fold import polyphase_fold, polyphase_fold_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _fold_inputs(m, p, n_time, seed):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((n_time, m))
         + 1j * rng.standard_normal((n_time, m))).astype(np.complex64)
    proto = jpfb.design_prototype(m, p)
    bank2 = np.ascontiguousarray(proto.reshape(p, m)[::-1, ::-1])
    return u, bank2


def _audio_int16(rng, channels, n):
    """Tone + noise with clipped extremes and full-scale steps."""
    t = np.arange(n)
    f = rng.uniform(100, 5000, (channels, 1))
    a = 0.5 * np.sin(2 * np.pi * f * t / 12000) + 0.3 * rng.standard_normal((channels, n))
    a[0] *= 5.0                                   # clips at ±full scale
    if channels > 2:
        a[2] = np.where(a[2] > 0, 1.0, -1.0)      # full-scale square wave
    return np.clip(a * 32767, -32768, 32767).astype(np.int16)


def _stride_with_total(total):
    """200 int16 samples whose 199 |differences| sum to ``total`` (up to
    199 * 32767 + 1): steps of q or q + 1 with alternating signs."""
    q, r = divmod(total, 2 * tadpcm.STATE_STRIDE - 1)
    d = np.full(2 * tadpcm.STATE_STRIDE - 1, q)
    d[:r] += 1
    sign = np.where(np.arange(d.size) % 2 == 0, 1, -1)
    x = -((q + 1) // 2) + np.concatenate([[0], np.cumsum(sign * d)])
    assert np.abs(np.diff(x)).sum() == total and np.abs(x).max() <= 32767
    return x.astype(np.int16)


def _boundary_strides():
    """(89, 600) int16: per table value k three strides whose sums of
    |differences| are 199 k - 1, 199 k and 199 k + 1, i.e. mean |dx| just
    below, at and just above the table entry."""
    n1 = 2 * tadpcm.STATE_STRIDE - 1
    return np.stack([np.concatenate([_stride_with_total(n1 * int(k) + d)
                                     for d in (-1, 0, 1)])
                     for k in tadpcm.IMA_STEP_TABLE])


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

    @pytest.mark.cuda
    @pytest.mark.parametrize("m,p,n_time", [(1024, 16, 2415), (100, 25, 331)])
    def test_kernel_matches_plain_on_card(self, cuda_device, m, p, n_time):
        u, bank2 = _fold_inputs(m, p, n_time, seed=7)
        ut = torch.from_numpy(u).to(cuda_device)
        bt = torch.from_numpy(bank2).to(cuda_device)
        got = polyphase_fold(ut, bt, p, device=cuda_device)
        ref = polyphase_fold_plain(ut, bt, p)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max())


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

    @pytest.mark.cuda
    def test_kernel_matches_plain_on_card(self, cuda_device):
        rng = np.random.default_rng(21)
        x = torch.from_numpy(_audio_int16(rng, 1024, 600)).to(cuda_device)
        lanes = x.reshape(-1, 2 * tadpcm.STATE_STRIDE).contiguous()
        prev = torch.from_numpy(rng.integers(-32768, 32767, lanes.shape[0],
                                             dtype=np.int32)).to(cuda_device)
        idxs = torch.from_numpy(rng.integers(0, 89, lanes.shape[0],
                                             dtype=np.int32)).to(cuda_device)
        got = tadpcm.encode_strides(lanes, prev, idxs, device=cuda_device)
        ref = tadpcm.encode_strides_plain(lanes, prev, idxs)
        assert torch.equal(got, ref)

    @pytest.mark.cuda
    @pytest.mark.parametrize("shape", [
        (1024, 600),     # USB and NFM banks: 3072 lanes
        (2048, 600),     # AM bank: 6144 lanes
        (128, 9600),     # WFM bank: 6144 lanes, 48 strides a channel
        (1200,),         # config #1: one channel, 6 lanes
    ])
    def test_fused_encode_matches_plain_on_card(self, cuda_device, shape):
        """One launch against the plain composition, four blocks with the
        state carried: bytes, stride states and state identical."""
        rng = np.random.default_rng(sum(shape))
        rows = int(np.prod(shape[:-1], dtype=np.int64))
        kst = tuple(torch.from_numpy(v).to(cuda_device) for v in (
            rng.integers(-32768, 32767, rows, dtype=np.int32).reshape(shape[:-1]),
            rng.integers(0, 89, rows, dtype=np.int32).reshape(shape[:-1])))
        pst = kst
        for _ in range(4):
            x = torch.from_numpy(_audio_int16(rng, rows, shape[-1]).reshape(shape)).to(cuda_device)
            kst, (kb, ks) = tadpcm.adpcm_encode(kst, x)
            pst, (pb, ps) = tadpcm.adpcm_encode_plain(pst, x)
            assert torch.equal(kb, pb) and torch.equal(ks, ps)
            assert all(torch.equal(a, b) for a, b in zip(kst, pst))

    @pytest.mark.cuda
    def test_short_stride_build_matches_plain_on_card(self, cuda_device):
        short = kernels.CudaKernel("adpcm.cu", kernels.ADPCM.symbol,
                                   kernels.ADPCM.argtypes,
                                   defines=("ADPCM_STRIDE=52",))
        rng = np.random.default_rng(52)
        x = torch.from_numpy(_audio_int16(rng, 3072, 104)).to(cuda_device)
        prev = torch.from_numpy(rng.integers(-32768, 32767, 3072,
                                             dtype=np.int32)).to(cuda_device)
        idxs = torch.from_numpy(rng.integers(0, 89, 3072,
                                             dtype=np.int32)).to(cuda_device)
        out = torch.empty((3072, 52), dtype=torch.uint8, device=cuda_device)
        short.launch(cuda_device, x.data_ptr(), None, None, prev.data_ptr(),
                     idxs.data_ptr(), out.data_ptr(), None, None, None, 3072, 1)
        assert torch.equal(out, tadpcm.encode_strides_plain(x, prev, idxs))

    @pytest.mark.cuda
    def test_fused_encode_boundary_strides_on_card(self, cuda_device):
        x = torch.from_numpy(_boundary_strides()).to(cuda_device)
        st = tadpcm.adpcm_init((x.shape[0],), device=cuda_device)
        kst, (kb, ks) = tadpcm.adpcm_encode(st, x)
        pst, (pb, ps) = tadpcm.adpcm_encode_plain(st, x)
        assert torch.equal(kb, pb) and torch.equal(ks, ps)
        assert all(torch.equal(a, b) for a, b in zip(kst, pst))


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

    @pytest.mark.cuda
    @pytest.mark.parametrize("rows,n,coeffs", [
        (1024, 2400, jiir.deemphasis_coeffs(48000.0, 150e-6)),   # NFM bank
        (2048, 600, jiir.dc_block_coeffs(12000.0)),              # AM bank
        (3, 9601, jiir.deemphasis_coeffs(48000.0, 50e-6)),       # ragged tile
        (128, 9600, jiir.deemphasis_coeffs(48000.0, 50e-6)),     # WFM bank
        (None, 4800, jiir.deemphasis_coeffs(48000.0, 150e-6)),   # config #1: one row
        (1, 40000, jiir.dc_block_coeffs(12000.0)),               # one row, column blocks
    ])
    def test_kernel_matches_plain_on_card(self, cuda_device, rows, n, coeffs):
        # tolerance: a block scan of runs against the plain doubling scan,
        # 1e-5 of the output scale
        b0, b1, a1 = coeffs
        rng = np.random.default_rng((rows or 1) + n)
        lead = () if rows is None else (rows,)
        x = torch.from_numpy(rng.standard_normal(lead + (n,)).astype(np.float32)).to(cuda_device)
        st = tuple(torch.from_numpy(v).to(cuda_device) for v in
                   rng.standard_normal((2,) + lead).astype(np.float32))
        (kx, ky), y = tiir.first_order_apply(st, b0, b1, a1, x, device=cuda_device)
        (px, py), yp = tiir.first_order_apply_plain(st, b0, b1, a1, x)
        torch.cuda.synchronize()
        scale = float(yp.abs().max())
        assert float((y - yp).abs().max()) <= 1e-5 * scale
        assert torch.equal(kx, px)
        assert float((ky - py).abs().max()) <= 1e-5 * scale


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

    @pytest.mark.cuda
    @pytest.mark.parametrize("profile,rows,n,chunk", [
        ("FAST", 1024, 2400, 50),     # NFM bank
        ("SLOW", 1024, 600, 50),      # USB bank
        ("SLOW", 5, 4800, 48),        # odd chunk
        ("SLOW", 2048, 600, 50),      # AM bank
        ("FAST", 1, 4800, 50),        # config #1: one row
        ("FAST", 2, 20000, 50),       # rows longer than one staged tile
        ("SLOW", 3, 9999, 3),         # unaligned rows, tiled
    ])
    def test_kernel_matches_plain_on_card(self, cuda_device, profile, rows, n, chunk):
        """Final gain, hang counters and audio identical: the kernel
        repeats the plain version's float32 operations in its order."""
        prof = getattr(tagc, profile)
        rng = np.random.default_rng(rows + n)
        scale = 10.0 ** rng.uniform(-3, 1, (rows, 1))
        x = torch.from_numpy((rng.standard_normal((rows, n)) * scale).astype(np.float32)).to(cuda_device)
        st = (torch.from_numpy(rng.uniform(0.1, 100, rows).astype(np.float32)).to(cuda_device),
              torch.from_numpy(rng.integers(0, 31, rows, dtype=np.int32)).to(cuda_device))
        (kg, kh), ky = tagc.agc_apply(st, prof, x, chunk, device=cuda_device)
        (pg, ph), py = tagc.agc_apply_plain(st, prof, x, chunk)
        torch.cuda.synchronize()
        assert torch.equal(kg, pg)
        assert torch.equal(kh, ph)
        assert torch.equal(ky, py)

    @pytest.mark.cuda
    def test_kernel_zero_rows_hang_step_and_scalar_row_on_card(self, cuda_device):
        x = np.zeros((3, 4800), np.float32)
        x[1, 2400:] = np.sin(np.arange(2400) * 0.3).astype(np.float32)
        x[2, 1000:1500] = 1.0
        for xs in (x, x[1]):           # a 0-dim state, as config #1 gives it
            xt = torch.from_numpy(xs).to(cuda_device)
            st = tagc.agc_init(tagc.FAST, xs.shape[:-1], device=cuda_device)
            (kg, kh), ky = tagc.agc_apply(st, tagc.FAST, xt, 50, device=cuda_device)
            (pg, ph), py = tagc.agc_apply_plain(st, tagc.FAST, xt, 50)
            torch.cuda.synchronize()
            assert torch.equal(kg, pg) and torch.equal(kh, ph)
            assert torch.equal(ky, py)


# power_db, the window mean of |x|² in dB: the kernel and torch.mean (and
# XLA's reduction) sum in different orders, and |x| is a hypot in the plain
# versions but re² + im² in the kernel; 1e-3 dB is ~2e-4 of relative power
SQUELCH_DB_ATOL = 1e-3


def _squelch_scene(rows, n, window, seed, dtype=np.complex64):
    """Rows over 80 dB of level with per-row thresholds near them, plus
    silent rows, NaN rows and a burst that arms the hang and runs out."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-4, 0, (rows, 1))
    x = rng.standard_normal((rows, n)) * scale
    if dtype == np.complex64:
        x = x + 1j * rng.standard_normal((rows, n)) * scale
    x = x.astype(dtype)
    level = (10 * np.log10(scale[:, 0] ** 2 * (2 if dtype == np.complex64 else 1))
             + rng.uniform(-6, 6, rows)).astype(np.float32)
    x[0] = 0                               # silence: −300 dB, never open
    if rows > 1:
        x[1, : n // 2] = np.nan            # NaN windows never open
    if n // window >= 4 and rows > 2:
        x[2] = 0
        x[2, window:2 * window] = 1.0      # one loud window: hang 2, then out
        level[2] = -20.0
    return x, level


def _squelch_bursts(rows, n, window, seed):
    """Complex rows whose every window lies 10 dB above or below the row's
    level at random (three in ten above), so that the hang opens and runs
    out all along a row, however short its windows."""
    rng = np.random.default_rng(seed)
    level = rng.uniform(-60, 0, rows).astype(np.float32)
    above = rng.uniform(size=(rows, n // window)) < 0.3
    amp = 10.0 ** ((level[:, None] + np.where(above, 10.0, -10.0)) / 20)
    x = np.repeat(amp, window, axis=1) * np.exp(2j * np.pi * rng.uniform(size=(rows, n)))
    return x.astype(np.complex64), level


def _state(rng, rows, dev="cpu"):
    return (torch.from_numpy(rng.integers(0, 2, rows).astype(bool)).to(dev),
            torch.from_numpy(rng.integers(0, 3, rows, dtype=np.int32)).to(dev))


def _bits(t):
    """A tensor's bit pattern: NaN samples that an open gate passes on
    compare equal, and +0.0 differs from −0.0."""
    return (torch.view_as_real(t) if t.is_complex() else t).view(torch.int32)


def _gates_exact_where_clear(pk, pp, level, yk, yp, sk, sp):
    """Rows whose every window lies more than the tolerance from its level
    must have identical gates, hang and output."""
    clear = ((pp - level[:, None]).abs() > SQUELCH_DB_ATOL) | pp.isnan()
    rows = clear.all(dim=-1)
    assert rows.float().mean() > 0.9
    assert torch.equal(_bits(yk)[rows], _bits(yp)[rows])
    assert torch.equal(sk[0][rows], sp[0][rows])
    assert torch.equal(sk[1][rows], sp[1][rows])


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

    @pytest.mark.cuda
    @pytest.mark.parametrize("dtype,rows,n,window", [
        (np.complex64, 1024, 600, 600),     # USB bank
        (np.complex64, 1024, 2400, 2400),   # NFM bank
        (np.complex64, 2048, 600, 600),     # AM bank
        (np.complex64, 128, 50000, 12500),  # WFM bank: tiled, 100 KB windows
        (np.complex64, 1, 4800, 2400),      # config #1
        (np.complex64, 16, 1536, 768),      # config #4's audio branch
        (np.float32, 5, 4801, 4801),        # real, unaligned
        (np.complex64, 3, 40000, 400),      # many windows, tiled
        (np.complex64, 12, 15000, 5000),    # windows straddle CTAs, last slice shorter
        (np.complex64, 2, 300000, 30000),   # the re-read branch
        (np.complex64, 64, 9600, 3200),     # the server's NFM bank, sliced
        (np.complex64, 1023, 600, 600),     # a ragged row count
    ])
    def test_kernel_matches_plain_on_card(self, cuda_device, dtype, rows, n, window):
        x, level = _squelch_scene(rows, n, window, seed=rows + n, dtype=dtype)
        rng = np.random.default_rng(rows)
        st = _state(rng, rows, cuda_device)
        xt = torch.from_numpy(x).to(cuda_device)
        lt = torch.from_numpy(level).to(cuda_device)
        sk, yk, pk = tsq.squelch_apply(st, lt, xt, window)
        sp, yp, pp = tsq.squelch_apply_plain(st, lt, xt, window)
        torch.cuda.synchronize()
        assert torch.equal(pk.isnan(), pp.isnan())
        fin = ~pp.isnan()
        assert float((pk[fin] - pp[fin]).abs().max()) <= SQUELCH_DB_ATOL
        _gates_exact_where_clear(pk, pp, lt, yk, yp, sk, sp)


    @pytest.mark.cuda
    @pytest.mark.parametrize("rows,n,window", [
        (16, 4800, 1),          # one-sample windows, more than shared memory holds
        (1, 100000, 1),         # 100000 windows a row: no slices fit
        (1, 17_000_000, 17000), # a row too long for slices, a window a chunk
    ])
    def test_kernel_walks_rows_on_card(self, cuda_device, rows, n, window):
        """Rows walked in chunks of whole windows, the hang carried from
        chunk to chunk, against the plain version: every window clear of
        its level, so gates, hang and output are bit-identical."""
        x, level = _squelch_bursts(rows, n, window, seed=n)
        st = _state(np.random.default_rng(rows), rows, cuda_device)
        xt = torch.from_numpy(x).to(cuda_device)
        lt = torch.from_numpy(level).to(cuda_device)
        assert tsq.squelch_plan(rows, n, window, 2).walks(n, 2)
        sk, yk, pk = tsq.squelch_apply(st, lt, xt, window)
        sp, yp, pp = tsq.squelch_apply_plain(st, lt, xt, window)
        assert float((pk - pp).abs().max()) <= SQUELCH_DB_ATOL
        assert torch.equal(_bits(yk), _bits(yp))
        assert torch.equal(sk[0], sp[0]) and torch.equal(sk[1], sp[1])

    @pytest.mark.cuda
    def test_kernel_repeats_and_carries_the_hang_on_card(self, cuda_device):
        """Two launches on one input give the same bits; the hang carried
        over three calls, state fed back, follows the plain chain; x at an
        address 8 bytes off 16 takes the 4-byte path; config #1's 0-dim
        state with one level."""
        x, level = _squelch_scene(64, 2400, 800, seed=3)
        st = _state(np.random.default_rng(3), 64, cuda_device)
        xt = torch.from_numpy(x).to(cuda_device)
        lt = torch.from_numpy(level).to(cuda_device)
        a, b = (tsq.squelch_apply(st, lt, xt, 800) for _ in range(2))
        assert torch.equal(_bits(a[1]), _bits(b[1]))
        assert torch.equal(a[2].view(torch.int32), b[2].view(torch.int32))
        xo = torch.empty(x.size * 2 + 2, device=cuda_device)[2:]
        xo = xo.view(torch.complex64).view(xt.shape)
        xo.copy_(xt)
        assert not tsq.squelch_plan(64, 2400, 800, 2, aligned=False).vec
        sk, yk, pk = tsq.squelch_apply(st, lt, xo, 800)
        sp, yp, pp = tsq.squelch_apply_plain(st, lt, xt, 800)
        _gates_exact_where_clear(pk, pp, lt, yk, yp, sk, sp)
        scene = torch.zeros(8, 2400, dtype=torch.complex64, device=cuda_device)
        scene[4:6, 600:1200] = 1.0
        scene[6:8, 1800:2400] = 1.0
        lvl = torch.tensor(-20.0, device=cuda_device)
        sk = sp = tsq.squelch_init((8,), device=cuda_device)
        for i in range(3):
            xi = scene if i == 0 else torch.zeros_like(scene)
            sk, yk, _ = tsq.squelch_apply(sk, lvl, xi, 600)
            sp, yp, _ = tsq.squelch_apply_plain(sp, lvl, xi, 600)
            assert torch.equal(sk[0], sp[0]) and torch.equal(sk[1], sp[1])
            assert torch.equal(_bits(yk), _bits(yp))
        x1 = torch.from_numpy(x[5]).to(cuda_device)
        s0 = tsq.squelch_init((), device=cuda_device)
        sk, yk, pk = tsq.squelch_apply(s0, lt[5], x1, 800)
        sp, yp, pp = tsq.squelch_apply_plain(s0, lt[5], x1, 800)
        assert sk[0].dim() == 0 and torch.equal(_bits(yk), _bits(yp))


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


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards (launches every kernel on cuda:1)")
    return torch.device("cuda", 1)


class TestSecondCard:
    @pytest.mark.cuda
    def test_every_wrapper_on_cuda1_matches_plain(self, second_card):
        """Every kernel wrapper on cuda:1 tensors, from a thread whose
        current device is still cuda:0: each launch makes its tensors'
        device current (the IIR's grid sizing reads that device's SM
        count), and each result equals its plain version as on cuda:0."""
        dev = second_card
        torch.cuda.set_device(0)
        rng = np.random.default_rng(101)
        u, bank2 = _fold_inputs(64, 16, 200, seed=5)
        ut, bt = torch.from_numpy(u).to(dev), torch.from_numpy(bank2).to(dev)
        v = polyphase_fold(ut, bt, 16, device=dev)
        ref = polyphase_fold_plain(ut, bt, 16)
        assert float((v - ref).abs().max()) <= 1e-5 * float(ref.abs().max())

        x = torch.from_numpy(_audio_int16(rng, 64, 600)).to(dev)
        lanes = x.reshape(-1, 2 * tadpcm.STATE_STRIDE).contiguous()
        prev = torch.zeros(lanes.shape[0], dtype=torch.int32, device=dev)
        assert torch.equal(tadpcm.encode_strides(lanes, prev, prev, device=dev),
                           tadpcm.encode_strides_plain(lanes, prev, prev))
        st = tadpcm.adpcm_init((64,), device=dev)
        got, want = tadpcm.adpcm_encode(st, x), tadpcm.adpcm_encode_plain(st, x)
        assert all(torch.equal(a, b) for a, b in zip((*got[0], *got[1]),
                                                      (*want[0], *want[1])))
        row = torch.from_numpy(_audio_int16(rng, 2, 4112)).to(dev)
        st = tadpcm.adpcm_init((2,), device=dev)
        got, want = tadpcm.adpcm_encode_seq(st, row), tadpcm.adpcm_encode_seq_plain(st, row)
        assert all(torch.equal(a, b) for a, b in zip((*got[0], *got[1]),
                                                      (*want[0], *want[1])))

        for n in (600, 2400):            # the IIR's one-warp and CTA paths
            xf = torch.from_numpy(rng.standard_normal((64, n)).astype(np.float32)).to(dev)
            zero = torch.zeros(64, device=dev)
            co = tiir.deemphasis_coeffs(48000.0, 150e-6)
            (xl, yl), y = tiir.first_order_apply((zero, zero), *co, xf, device=dev)
            (xp, yp), y_p = tiir.first_order_apply_plain((zero, zero), *co, xf)
            assert float((y - y_p).abs().max()) <= 1e-5 * float(y_p.abs().max())
            assert torch.equal(xl, xp)

        xf = torch.from_numpy(rng.standard_normal((64, 2400)).astype(np.float32)).to(dev)
        st = tagc.agc_init(tagc.FAST, (64,), device=dev)
        got = tagc.agc_apply(st, tagc.FAST, xf, 50, device=dev)
        want = tagc.agc_apply_plain(st, tagc.FAST, xf, 50)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0][0], want[0][0])

        xs, level = _squelch_scene(8, 2400, 600, seed=9, dtype=np.complex64)
        st = _state(rng, 8, dev)
        xt, lt = torch.from_numpy(xs).to(dev), torch.from_numpy(level).to(dev)
        sk, yk, pk = tsq.squelch_apply(st, lt, xt, 600)
        sp, yp, pp = tsq.squelch_apply_plain(st, lt, xt, 600)
        torch.cuda.synchronize(dev)
        fin = ~pp.isnan()
        assert torch.equal(pk.isnan(), pp.isnan())
        assert float((pk[fin] - pp[fin]).abs().max()) <= SQUELCH_DB_ATOL
        _gates_exact_where_clear(pk, pp, lt, yk, yp, sk, sp)
        assert torch.cuda.current_device() == 0
