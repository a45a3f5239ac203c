"""The port's kernels (openwebrx_tpu_torch): polyphase fold, ADPCM encode,
first-order IIR and AGC.

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
from openwebrx_tpu_torch.ops import adpcm as tadpcm
from openwebrx_tpu_torch.ops import agc as tagc
from openwebrx_tpu_torch.ops import iir as tiir
from openwebrx_tpu_torch.ops import channelizer as tpfb
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
    ])
    def test_kernel_matches_plain_on_card(self, cuda_device, rows, n, coeffs):
        # tolerance: a warp scan of 8-sample segments against the plain
        # doubling scan, 1e-5 of the output scale
        b0, b1, a1 = coeffs
        rng = np.random.default_rng(rows + n)
        x = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(cuda_device)
        st = tuple(torch.from_numpy(v).to(cuda_device) for v in
                   rng.standard_normal((2, rows)).astype(np.float32))
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
