"""The port's waterfall (openwebrx_tpu_torch): fftops, WaterfallStage and
FftChain, and the exact IMA row encoder behind the compressed rows.

The same numpy inputs go through the JAX package and the port on the CPU.
Float rows agree within WATERFALL_DB_ATOL on the bins within 60 dB of the
row's peak; the encoder's bytes, stride states and final state agree bit
for bit.  The kernel is held against its plain version on a card in
tests/test_torch_card.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from openwebrx_tpu.models.receiver import FftChain as JaxFftChain
from openwebrx_tpu.models.stages import plan_block_size as jax_plan
from openwebrx_tpu.ops import adpcm as jadpcm
from openwebrx_tpu.ops import fftops as jfft
from openwebrx_tpu.ops.formats import Format as JaxFormat, StreamSpec as JaxSpec
from openwebrx_tpu.runtime.chain import Program as JaxProgram
from openwebrx_tpu_torch.models.receiver import FftChain
from openwebrx_tpu_torch.models.stages import plan_block_size
from openwebrx_tpu_torch.ops import adpcm as tadpcm
from openwebrx_tpu_torch.ops import fftops as tfft
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.chain import Program

from test_torch_card import _square_rows, _waterfall_row_samples

FS = 240000.0
# dB rows: float32 FFTs of two libraries (pocketfft, XLA's) and sums of
# frames in other orders; bins within 60 dB of the peak carry ≥ 1e-6 of
# its power, where the relative error stays ~1e-5 (~1e-4 dB)
WATERFALL_DB_ATOL = 1e-3
NEAR_PEAK_DB = 60.0


def _near_peak_close(got, ref):
    ref = np.atleast_2d(ref)
    got = np.atleast_2d(got)
    assert got.shape == ref.shape and got.dtype == np.float32
    mask = ref >= ref.max(axis=-1, keepdims=True) - NEAR_PEAK_DB
    assert np.abs(got - ref)[mask].max() <= WATERFALL_DB_ATOL


def _iq(n, seed, tone=0.13):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    return (0.5 * np.exp(2j * np.pi * tone * k)
            + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


class TestAdpcmEncodeSeq:
    @pytest.mark.parametrize("idx0", [0, 88])
    @pytest.mark.parametrize("kind", ["wf29", "wf600", "clipped", "square"])
    def test_plain_bit_exact_with_jax_on_waterfall_rows(self, kind, idx0):
        """The rows the kernel is timed and checked on: waterfall-like dB
        rows at 29 and 600 averages, clipped and square-wave rows, from a
        start index at either end of the table."""
        x = _waterfall_row_samples(kind, seed=idx0)[None]
        pred = np.array([int(x[0, 0]) - 1000], np.int32)
        idx = np.array([idx0], np.int32)
        js, (jb, jst) = jadpcm.adpcm_encode_seq((jnp.asarray(pred), jnp.asarray(idx)),
                                                jnp.asarray(x))
        ts, (tb, tst) = tadpcm.adpcm_encode_seq_plain(
            (torch.from_numpy(pred), torch.from_numpy(idx)), torch.from_numpy(x))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # 4112: a 4096-bin row with pad (2056 bytes, not a multiple of 100);
    # 400: exactly two strides; 2064: a 2048-bin row padded to 8 samples
    @pytest.mark.parametrize("n", [4112, 400, 2064])
    def test_plain_bit_exact_with_jax(self, n):
        rng = np.random.default_rng(n)
        x = rng.integers(-32768, 32767, (3, n)).astype(np.int16)
        x[1] = np.cumsum(rng.integers(-900, 900, n)).clip(-32768, 32767)
        x[2] = _square_rows(1, n)[0]
        pred = rng.integers(-32768, 32767, 3).astype(np.int32)
        idx = rng.integers(0, 89, 3).astype(np.int32)
        js, (jb, jst) = jadpcm.adpcm_encode_seq((jnp.asarray(pred), jnp.asarray(idx)),
                                                jnp.asarray(x))
        ts, (tb, tst) = tadpcm.adpcm_encode_seq(
            (torch.from_numpy(pred), torch.from_numpy(idx)), torch.from_numpy(x))
        assert tb.dtype == torch.uint8 and tst.dtype == torch.int32
        assert tst.shape == (3, n // 200)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_decodes_with_the_browser_decoder(self):
        """A row encoded from a fresh codec decodes (continuously, from
        (0, 0)) to within a few steps of the input."""
        rng = np.random.default_rng(3)
        x = np.cumsum(rng.integers(-300, 300, 1000)).astype(np.int16)
        _, (b, _) = tadpcm.adpcm_encode_seq(tadpcm.adpcm_init((), device="cpu"),
                                            torch.from_numpy(x))
        dec, _ = tadpcm.adpcm_decode_np(b.numpy().tobytes())
        assert np.abs(dec[100:].astype(int) - x[100:]).max() < 2000

    def test_compress_fft_rows_matches_jax(self):
        rng = np.random.default_rng(4)
        rows = (rng.standard_normal((3, 512)) * 15 - 70).astype(np.float32)
        rows[1, 7] = 400.0                   # clips at +32767
        assert tadpcm.compress_fft_rows(rows, device="cpu") == \
            jadpcm.compress_fft_rows(rows)

    def test_rejects_bad_shapes_and_needs_a_card(self):
        st = tadpcm.adpcm_init((2,), device="cpu")
        with pytest.raises(ValueError):
            tadpcm.adpcm_encode_seq(st, torch.zeros(2, 7, dtype=torch.int16))
        with pytest.raises(ValueError):
            tadpcm.adpcm_encode_seq(st, torch.zeros(3, 8, dtype=torch.int16))
        with pytest.raises((RuntimeError, ValueError)):
            tadpcm.compress_fft_rows(np.zeros((1, 64), np.float32))

    def test_kernel_entry_runs_only_on_the_card(self):
        """encode_seq_kernel (the launch behind adpcm_encode_seq, with its
        test inputs) takes CUDA tensors only and forced in {0, 1, 2}."""
        st = tadpcm.adpcm_init((1,), device="cpu")
        x = torch.zeros(1, 16, dtype=torch.int16)
        with pytest.raises(ValueError):
            tadpcm.encode_seq_kernel(st, x)
        with pytest.raises(ValueError):
            tadpcm.encode_seq_kernel(st, x, forced=3)



class TestFftOps:
    @pytest.mark.parametrize("every_n", [256, 320, 200])
    def test_fft_power_matches_jax(self, every_n):
        x = _iq(every_n * 8, seed=every_n)
        w = jfft.hann_window(256)
        jh, jp = jfft.fft_power(jfft.fft_init(256, 256), w, jnp.asarray(x), 256, every_n)
        th, tp = tfft.fft_power(tfft.fft_init(256, 256, device="cpu"),
                                torch.from_numpy(w), torch.from_numpy(x), 256, every_n)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        jp = np.asarray(jp)
        assert tp.shape == jp.shape
        assert np.abs(tp.numpy() - jp).max() <= 1e-5 * jp.max()
        _near_peak_close(tfft.fft_swap(tfft.log_average(tp, 4)).numpy(),
                         np.asarray(jfft.fft_swap(jfft.log_average(jnp.asarray(jp), 4))))

    def test_fft_power_at_matches_jax_and_needs_uniform_frames(self):
        x = _iq(3000, seed=9)
        ends = (np.arange(7) + 1) * 400
        w = jfft.hann_window(512)
        jh, jp = jfft.fft_power_at(jfft.fft_init(512, 512), w, jnp.asarray(x), 512, ends)
        th, tp = tfft.fft_power_at(tfft.fft_init(512, 512, device="cpu"),
                                   torch.from_numpy(w), torch.from_numpy(x), 512, ends)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert np.abs(tp.numpy() - np.asarray(jp)).max() <= 1e-5 * np.asarray(jp).max()
        with pytest.raises(ValueError):
            tfft.fft_power_at(th, torch.from_numpy(w), torch.from_numpy(x), 512,
                              np.array([400, 900, 1300]))

    def test_tone_bin_level_and_params(self):
        """The reference's own checks: a 6 kHz tone in its bin, a full-scale
        tone at −6 dB after the Hann window, and waterfall_params."""
        fs, size = 48000.0, 1024
        x = np.exp(2j * np.pi * 6000.0 / fs * np.arange(size * 8)).astype(np.complex64)
        _, p = tfft.fft_power(tfft.fft_init(size, size, device="cpu"),
                              torch.from_numpy(tfft.hann_window(size)),
                              torch.from_numpy(x), size, size)
        row = tfft.fft_swap(tfft.log_average(p, averages=8, add_db=0.0))[0].numpy()
        assert abs(int(np.argmax(row)) - (size // 2 + 128)) <= 1
        assert -8.0 < row.max() < -4.0
        for args in ((2.4e6, 4096, 9), (12000, 2048, 9)):
            assert tfft.waterfall_params(*args) == jfft.waterfall_params(*args)
        np.testing.assert_array_equal(tfft.hamming_window(65), jfft.hamming_window(65))


class TestWaterfallChain:
    def _programs(self, compress, fft_size=512, fps=20):
        jc = JaxFftChain(fft_size=fft_size, fps=fps, compress=compress)
        tc = FftChain(fft_size=fft_size, fps=fps, compress=compress)
        jspec, tspec = JaxSpec(JaxFormat.COMPLEX_FLOAT, FS), StreamSpec(Format.COMPLEX_FLOAT, FS)
        block = plan_block_size(tc, tspec, 0.2)
        assert block == jax_plan(jc, jspec, 0.2)
        return (JaxProgram(jc, jspec, block), Program(tc, tspec, block, device="cpu"),
                tc, block)

    def test_float_rows_match_jax_over_blocks(self):
        jp, tp, tc, block = self._programs(False)
        assert tc.waterfall.rows == 4 and tc.waterfall.averages == 23
        for b in range(3):
            x = _iq(block, seed=b)
            (jr, _), (tr, _) = jp.process(x), tp.process(x)
            _near_peak_close(tr, np.asarray(jr))
        peak = tr[-1].argmax()
        assert abs(int(peak) - (512 // 2 + int(round(0.13 * 512)))) <= 1

    def test_compressed_rows_are_the_jax_encoding_of_the_ports_rows(self):
        """Wire bytes of compress=True equal the JAX compress_fft_rows of
        the port's own float rows (identical int16 input is the only fair
        bit-for-bit comparison), and the host trim still gives them."""
        from openwebrx_tpu_torch.runtime.chain import Program as TProgram
        _, tp_plain, _, block = self._programs(False)
        packed = FftChain(fft_size=512, fps=20, compress=True)
        tp_packed = TProgram(packed, StreamSpec(Format.COMPLEX_FLOAT, FS), block,
                             device="cpu")
        nb = packed.waterfall.wire_bytes_per_row
        assert nb == (512 + 10 + 1) // 2
        for b in range(2):
            x = _iq(block, seed=10 + b)
            rows, _ = tp_plain.process(x)
            raw, _ = tp_packed.process(x)
            assert raw.dtype == np.uint8 and raw.shape == (4, 264)
            ref = jadpcm.compress_fft_rows(rows)
            view = raw.view(np.uint8).reshape(raw.shape[0], -1)
            assert [view[i, :nb].tobytes() for i in range(len(ref))] == ref

    def test_decoded_rows_put_the_tone_in_its_bin(self):
        chain = FftChain(fft_size=1024, fps=10, compress=True)
        spec = StreamSpec(Format.COMPLEX_FLOAT, FS)
        prog = Program(chain, spec, plan_block_size(chain, spec, 0.1), device="cpu")
        raw, _ = prog.process(_iq(prog.block, seed=2, tone=-0.21))
        dec, _ = tadpcm.adpcm_decode_np(raw[0, :chain.waterfall.wire_bytes_per_row].tobytes())
        row = dec[tadpcm.COMPRESS_FFT_PAD_N:tadpcm.COMPRESS_FFT_PAD_N + 1024] / 100.0
        assert abs(int(np.argmax(row)) - (512 + int(round(-0.21 * 1024)))) <= 1
