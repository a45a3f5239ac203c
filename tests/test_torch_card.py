"""The port's card-only tests: every hand-written CUDA kernel against its
plain PyTorch version on a card, the runtime's one event per block and its
upload's single-threaded staging copy.

Each test carries the ``cuda`` marker and skips without a card.  This file
imports no jax and nothing of ``openwebrx_tpu``, so the card's machine,
which has no jax, collects it; ``tests/conftest.py`` imports jax, hence
``--noconftest``::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_card.py tests/test_torch_golden.py

The input makers here are shared with the CPU tests of the same kernels
(tests/test_torch_kernels.py, tests/test_torch_waterfall.py), which hold
the plain versions against the JAX reference.
"""

import numpy as np
import pytest
import torch

from openwebrx_tpu_torch import kernels
from openwebrx_tpu_torch.core.metrics import CODE_BITS
from openwebrx_tpu_torch.core.property import PropertyLayer
from openwebrx_tpu_torch.ops import adpcm as tadpcm
from openwebrx_tpu_torch.ops import agc as tagc
from openwebrx_tpu_torch.ops import channelizer as tpfb
from openwebrx_tpu_torch.ops import iir as tiir
from openwebrx_tpu_torch.ops import squelch as tsq
from openwebrx_tpu_torch.ops.fold import polyphase_fold, polyphase_fold_plain
from openwebrx_tpu_torch.runtime.chain import as_input_block
from openwebrx_tpu_torch.runtime.device import PORT_HOST, DeviceRuntime
from openwebrx_tpu_torch.sources.file import SignalSource
import torch_graph_scenes as gs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards (launches every kernel on cuda:1)")
    return torch.device("cuda", 1)


def _fold_inputs(m, p, n_time, seed):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((n_time, m))
         + 1j * rng.standard_normal((n_time, m))).astype(np.complex64)
    proto = tpfb.design_prototype(m, p)
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


def _square_rows(rows, n):
    """Full-scale square waves of several periods: the largest steps."""
    t = np.arange(n)
    out = [np.where((t // p) % 2 == 0, 32767, -32768) for p in (1, 3, 17, 64)]
    return np.stack([out[i % 4] for i in range(rows)]).astype(np.int16)


def _waterfall_row_samples(kind, bins=1024, seed=0):
    """The row encoder's int16 input for one waterfall-like row: dB of the
    averaged |FFT|² of noise plus two tones (29 frames as config #2's
    waterfall, 600 as the 49.152 MS/s one), a clipped row, or full-scale
    square waves; COMPRESS_FFT_PAD_N pad samples in front."""
    rng = np.random.default_rng(seed)
    if kind == "square":
        return _square_rows(1, bins + 16)[0]
    frames = {"wf29": 29, "wf600": 600, "clipped": 29}[kind]
    t = np.arange(bins)
    acc = np.zeros(bins)
    for _ in range(frames):
        z = rng.standard_normal(bins) + 1j * rng.standard_normal(bins)
        z += 30 * np.exp(2j * np.pi * 0.1 * t) + 3 * np.exp(2j * np.pi * 0.37 * t)
        acc += np.abs(np.fft.fftshift(np.fft.fft(z * np.hanning(bins)))) ** 2
    db = 10 * np.log10(acc / frames / bins) - 60
    if kind == "clipped":
        db[::7] = 400.0                     # +32767 after ×100
        db[3::11] = -400.0                  # −32768
    rows = torch.from_numpy(db.astype(np.float32))[None]
    return tadpcm.fft_row_samples(rows)[0].numpy()


class TestFold:
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
    @pytest.mark.cuda
    @pytest.mark.parametrize("rows,n,coeffs", [
        (1024, 2400, tiir.deemphasis_coeffs(48000.0, 150e-6)),   # NFM bank
        (2048, 600, tiir.dc_block_coeffs(12000.0)),              # AM bank
        (3, 9601, tiir.deemphasis_coeffs(48000.0, 50e-6)),       # ragged tile
        (128, 9600, tiir.deemphasis_coeffs(48000.0, 50e-6)),     # WFM bank
        (None, 4800, tiir.deemphasis_coeffs(48000.0, 150e-6)),   # config #1: one row
        (1, 40000, tiir.dc_block_coeffs(12000.0)),               # one row, column blocks
    ])
    def test_kernel_matches_plain_on_card(self, cuda_device, rows, n, coeffs):
        # tolerance: a block scan of runs against the plain doubling scan,
        # 1e-5 of the output scale
        b0, b1, a1 = coeffs
        rng = np.random.default_rng((rows or 1) + n)
        lead = () if rows is None else (rows,)
        x = torch.from_numpy(rng.standard_normal(lead + (n,)).astype(np.float32)).to(cuda_device)
        st = tuple(torch.from_numpy(np.asarray(v)).to(cuda_device) for v in
                   rng.standard_normal((2,) + lead).astype(np.float32))
        (kx, ky), y = tiir.first_order_apply(st, b0, b1, a1, x, device=cuda_device)
        (px, py), yp = tiir.first_order_apply_plain(st, b0, b1, a1, x)
        torch.cuda.synchronize()
        scale = float(yp.abs().max())
        assert float((y - yp).abs().max()) <= 1e-5 * scale
        assert torch.equal(kx, px)
        assert float((ky - py).abs().max()) <= 1e-5 * scale


class TestAgc:
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


class TestSquelch:
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


class TestAdpcmEncodeSeq:
    @pytest.mark.cuda
    @pytest.mark.parametrize("rows,n", [(1, 4112), (16, 4112), (3, 2058), (40, 400)])
    def test_kernel_matches_plain_on_card(self, cuda_device, rows, n):
        rng = np.random.default_rng(rows + n)
        x = rng.integers(-32768, 32767, (rows, n)).astype(np.int16)
        x[::3] = _square_rows(len(x[::3]), n)
        st = tuple(torch.from_numpy(v).to(cuda_device) for v in (
            rng.integers(-32768, 32767, rows).astype(np.int32),
            rng.integers(0, 89, rows).astype(np.int32)))
        xt = torch.from_numpy(x).to(cuda_device)
        ks, (kb, kst) = tadpcm.adpcm_encode_seq(st, xt)
        ps, (pb, pst) = tadpcm.adpcm_encode_seq_plain(st, xt)
        torch.cuda.synchronize()
        assert torch.equal(kb, pb) and torch.equal(kst, pst)
        assert all(torch.equal(a, b) for a, b in zip(ks, ps))

    @pytest.mark.cuda
    @pytest.mark.parametrize("forced", [1, 2])
    @pytest.mark.parametrize("rows,n", [(1, 4112), (16, 4112), (3, 2058), (2, 6)])
    def test_kernel_forced_repairs_match_plain_on_card(self, cuda_device, rows, n, forced):
        """The adversarial test inputs: every guess at (−32768, 88)
        (forced 1), or no guessed run taken at all, so the sweep encodes the
        row itself (forced 2); the output must not change."""
        rng = np.random.default_rng(rows * n + forced)
        x = np.stack([_waterfall_row_samples(("wf29", "wf600", "square")[i % 3],
                                             bins=4096, seed=i)[:n]
                      for i in range(rows)]) if n > 8 else \
            rng.integers(-32768, 32767, (rows, n)).astype(np.int16)
        st = tuple(torch.from_numpy(v).to(cuda_device) for v in (
            rng.integers(-32768, 32767, rows).astype(np.int32),
            rng.integers(0, 89, rows).astype(np.int32)))
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
        diag = torch.zeros(rows, tadpcm.SEQ_DIAG_WORDS, dtype=torch.int32,
                           device=cuda_device)
        ks, (kb, kst) = tadpcm.encode_seq_kernel(st, xt, forced=forced, diag=diag)
        ps, (pb, pst) = tadpcm.adpcm_encode_seq_plain(st, xt)
        torch.cuda.synchronize()
        assert torch.equal(kb, pb) and torch.equal(kst, pst)
        assert all(torch.equal(a, b) for a, b in zip(ks, ps))
        assert int(diag[:, 2].max()) > 0             # the first pass ran


def _source(signals, noise=2e-3, rate=3.072e6, name="torch-rt"):
    """The port's SignalSource (3.072 MS/s: 128 PFB channels of 24 kHz)."""
    props = PropertyLayer(samp_rate=int(rate), center_freq=14_100_000,
                          throttle=False, noise=noise, signals=signals)
    return SignalSource(name, props)


class TestOnCard:
    @pytest.mark.cuda
    def test_one_event_per_block_on_card(self):
        """On a card every result of a block (waterfall, a listener bank, a
        6-block service batch) is copied behind one shared event."""
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card")
        rt = DeviceRuntime(_source([]), capacity=8, target_seconds=0.05, host=PORT_HOST,
                           fft_size=1024)
        rt.subscribe_waterfall(lambda p: None)
        rt.open_channel("usb", 48_500.0)
        rt.open_channel("usb", 96_500.0, service=True)
        block = (np.random.default_rng(0).standard_normal((rt.block, 2)) * 0.05
                 ).astype(np.float32)
        for i in range(6):
            pend = rt._dispatch_block(block)
            events = {p.event for p in pend["fft_pending"]}
            for pl in pend["bank_pending"].values():
                events |= {p.event for p in pl}
            assert len(events) == 1 and None not in events
            assert len(pend["bank_pending"].get("pfb:ssb", [])) == (6 if i == 5 else 0)
            rt._complete_block(pend)


def _wire_block(kind, n, seed):
    """One source block of ``n`` samples as a source hands it: packed
    (n, 2) uint8 / int16 / float32 pairs, or (n,) complex64."""
    rng = np.random.default_rng(seed)
    if kind == "complex64":
        return (0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
                ).astype(np.complex64)
    if kind == "float32":
        return (0.05 * rng.standard_normal((n, 2))).astype(np.float32)
    dtype = np.dtype(kind)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, (n, 2), dtype=dtype, endpoint=True)


def _copy_upload(rt, block):
    """A device block as a fresh pinned buffer filled by ``Tensor.copy_``
    uploads it, the way ``pinned_copy`` replaced."""
    host = torch.from_numpy(np.ascontiguousarray(rt.fft_program.pack_input(block)))
    staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    staged.copy_(host)
    return as_input_block(staged.to(rt.device, non_blocking=True), rt.block, True,
                          rt.device)


class TestStagingOnCard:
    """``DeviceRuntime._upload`` on a card, its host copy ``pinned_copy``:
    every device block is bit for bit the one ``Tensor.copy_`` into a fresh
    pinned buffer gives, while the source writes its one buffer again after
    each call and nothing waits in between, and no ``Tensor.copy_`` runs;
    one ``stage`` span inside one ``upload`` span a block."""

    @staticmethod
    def _runtime(name):
        return DeviceRuntime(_source([], name=name), capacity=8, target_seconds=0.05,
                             host=PORT_HOST, fft_size=1024)

    @pytest.mark.cuda
    @pytest.mark.parametrize("kind", ["uint8", "int16", "float32", "complex64"])
    def test_every_device_block_is_the_tensor_copy_upload_s(self, cuda_device, kind,
                                                             monkeypatch):
        rt = self._runtime(f"staging-{kind}")
        copy_ = torch.Tensor.copy_

        def refused(*args, **kwargs):
            raise AssertionError("the upload went through Tensor.copy_")

        blocks = 2 * rt.pipeline_depth + 1
        first = _wire_block(kind, rt.block, 0)
        source = np.empty_like(first)             # the source's one buffer
        got, want = [], []
        for i in range(blocks):
            np.copyto(source, _wire_block(kind, rt.block, i))
            want.append(_copy_upload(rt, source.copy()))
            monkeypatch.setattr(torch.Tensor, "copy_", refused)
            got.append(rt._upload(source))
            monkeypatch.setattr(torch.Tensor, "copy_", copy_)
        source[...] = 0
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == torch.complex64 and g.device == cuda_device
            assert torch.view_as_real(g).cpu().numpy().tobytes() == \
                torch.view_as_real(w).cpu().numpy().tobytes(), i

    @pytest.mark.cuda
    def test_one_stage_span_inside_the_upload_span_of_each_block(self, cuda_device):
        import time
        rt = self._runtime("staging-paced")
        rt.subscribe_waterfall(lambda p: None)
        blocks = 3 * (rt.pipeline_depth + 1) + 1
        source = np.empty((rt.block, 2), np.uint8)
        for i in range(blocks):
            np.copyto(source, _wire_block("uint8", rt.block, i))
            rt._process_block(source)
            time.sleep(0.01)
        assert rt.gauges["blocks"] == blocks
        upload = {int(r["seq"]) - 1: r for r in rt.spans["upload"].records()}
        stage = rt.spans["stage"].records()
        assert len(upload) == len(stage) == blocks
        for r in stage:
            parent = upload[int(r["parent"]) >> CODE_BITS]
            assert rt.spans.find(int(r["parent"])).name == "upload"
            assert r["id"] == parent["id"]
            assert parent["start"] <= r["start"] <= r["end"] <= parent["end"]
        assert sorted(int(r["id"]) for r in stage) == list(range(blocks))


@pytest.fixture
def no_plain(monkeypatch):
    """Every plain version of a kernel fails a case that hands it a CUDA
    tensor (as tests/torch_ref_device.py's ``device`` fixture)."""
    import importlib
    from torch_ref_device import PLAIN_VERSIONS, _refusing_cuda
    reached = []
    for module, name in PLAIN_VERSIONS:
        mod = importlib.import_module(f"openwebrx_tpu_torch.{module}")
        monkeypatch.setattr(mod, name, _refusing_cuda(f"{module}.{name}",
                                                      getattr(mod, name), reached))
    yield
    assert not reached, f"plain versions reached on the card: {reached}"


def _replay_and_eager(scene):
    """``scene(graph)`` → (outputs, captures), run with the graph and then
    with the eager step on the card, each with every kernel count set to 0
    → {graph: (outputs, captures, launches)}."""
    runs = {}
    for graph in (True, False):
        gs.zero_launches()
        out, captures = scene(graph)
        torch.cuda.synchronize()
        runs[graph] = (out, captures, gs.launch_counts())
    return runs


def _assert_replay_is_eager(runs, captures, kernels_run):
    """Bit for bit the same outputs, ``captures`` graphs captured (none by
    the eager step), the same launches kernel by kernel, and every kernel
    of ``kernels_run`` launched."""
    (g_out, g_cap, g_launch), (e_out, e_cap, e_launch) = runs[True], runs[False]
    assert len(g_out) == len(e_out) > 0
    for b, (g, e) in enumerate(zip(g_out, e_out)):
        gs.assert_same(g, e, b)
    assert g_cap == captures and all(c == 0 for c in e_cap), (g_cap, e_cap)
    assert g_launch == e_launch, (g_launch, e_launch)
    assert all(g_launch[k] > 0 for k in kernels_run), g_launch


class TestGraphStepOnCard:
    """Each block of a bank or program on the card is one CUDA graph
    replay from its second block on, held bit for bit to the eager step
    (``graph=False``) over the same blocks and control changes; one
    capture per layout, one more per structural change; the replays'
    launch counts equal the eager step's, kernel by kernel; no plain
    version runs.  Scenes: tests/torch_graph_scenes.py."""

    @pytest.mark.cuda
    @pytest.mark.parametrize("mode", sorted(gs.BANK_MODES))
    def test_bank_replay_is_the_eager_step(self, cuda_device, no_plain, mode):
        def scene(graph):
            out, _, bank = gs.run_bank_scene(mode, cuda_device, graph)
            return out, [bank.program.step.captures]
        runs = _replay_and_eager(scene)
        kernels_run = {"fold.cu", "squelch.cu"} | (
            {"iir.cu"} if mode in ("nfm", "am", "wfm") else set()) | (
            {"agc.cu"} if mode != "wfm" else set())
        _assert_replay_is_eager(runs, [1], kernels_run)
        # each control change reached the replayed output (a squelch after
        # its hang), against the same bank replayed without the changes
        still, _, _ = gs.run_bank_scene(mode, cuda_device, True, events={})
        _, slots = gs.make_bank(mode)
        for b, (name, i) in gs.BANK_EVENTS.items():
            slot, first = slots[min(i, len(slots) - 1)], b + gs.EFFECT_LAG.get(name, 0)
            assert not np.array_equal(runs[True][0][first][0][slot],
                                      still[first][0][slot]), (mode, name)

    @pytest.mark.cuda
    @pytest.mark.parametrize("path", sorted(gs.BANK_MODES) + ["waterfall"])
    def test_replay_counts_are_the_kernels_that_ran(self, cuda_device, no_plain, path):
        """The launches that replays add to the counts (recorded at the
        capture) are held to what ran on the card: a profiler trace of the
        replayed blocks holds each hand-written kernel as often as its
        count says."""
        if path == "waterfall":
            step_of, fs, dials = gs.make_waterfall(cuda_device), gs.WF_FS, (300000.0,)
            step = step_of.step
        else:
            step_of, _ = gs.make_bank(path, cuda_device)
            fs, dials = gs.BANK_MODES[path][0], gs.BANK_MODES[path][4]
            step = step_of.program.step
        blocks = [gs.on(cuda_device, x) for x in gs.bank_blocks(
            "usb" if path == "waterfall" else path, fs, dials, step_of.block, 6, seed=4)]
        for x in blocks[:2]:            # the eager block; the capture, replayed
            step_of.process(x)
        gs.zero_launches()
        _, _, ran = gs.traced(lambda: [step_of.process(x) for x in blocks[2:]])
        counted = gs.launch_counts()
        assert step.captures == 1 and step.replays == 5
        assert ran == counted, (ran, counted)
        assert sum(counted.values()) >= 4, counted

    @pytest.mark.cuda
    def test_the_eager_block_and_the_capture_are_spans_of_the_open_log(self, cuda_device,
                                                                       no_plain):
        """A step's eager first block and its capture are ``eager`` and
        ``capture`` spans in the log of the span open on the thread, children
        of it; the step keeps its capture's span."""
        from openwebrx_tpu_torch.core.metrics import CODE_BITS, SpanLog
        step_of, _ = gs.make_bank("usb", cuda_device)
        fs, dials = gs.BANK_MODES["usb"][0], gs.BANK_MODES["usb"][4]
        blocks = [gs.on(cuda_device, x) for x in gs.bank_blocks(
            "usb", fs, dials, step_of.block, 3, seed=4)]
        log = SpanLog("card-test", {"dispatch": ()})
        for i, x in enumerate(blocks):
            with log["dispatch"](rid=i):
                step_of.process(x)
        dispatch, eager, capture = (log[n].records() for n in ("dispatch", "eager", "capture"))
        assert list(eager["id"]) == [0] and list(capture["id"]) == [1]
        for rec, block in ((eager, 0), (capture, 1)):
            assert rec["parent"][0] >> CODE_BITS == dispatch["seq"][block] - 1
            assert dispatch["start"][block] <= rec["start"][0] <= rec["end"][0] \
                <= dispatch["end"][block]
        metric, sid = step_of.program.step.capture_span
        assert metric is log["capture"] and metric.seconds(sid) > 0

    @pytest.mark.cuda
    def test_capture_survives_a_collection_of_old_graphs(self, cuda_device, no_plain,
                                                          monkeypatch):
        """A bank whose graph is cyclic garbage when another step captures:
        a garbage collection inside the capture would free that graph on the
        capturing thread, which invalidates the capture; the capture holds
        the collector off, and the old bank is freed after it."""
        import gc
        import weakref
        from openwebrx_tpu_torch.runtime.chain import GraphStep
        _, _, old = gs.run_bank_scene("usb", cuda_device, True, events={}, nblocks=3)
        assert old.program.step.captures == 1
        old.cycle = old                   # only the cyclic collector frees it
        holder, freed = [old], weakref.ref(old)
        del old
        body = GraphStep._body

        def collecting_body(self):
            if torch.cuda.is_current_stream_capturing() and holder:
                holder.clear()           # the old bank is garbage from here
                threshold = gc.get_threshold()
                gc.set_threshold(1, 1, 1)
                try:
                    [[] for _ in range(1000)]    # allocations that would collect
                finally:
                    gc.set_threshold(*threshold)
            return body(self)

        monkeypatch.setattr(GraphStep, "_body", collecting_body)
        out, _, bank = gs.run_bank_scene("usb", cuda_device, True, events={}, nblocks=3)
        torch.cuda.synchronize()
        step = bank.program.step
        assert step.captures == 1 and step.replays == 2 and not holder
        gc.collect()
        assert freed() is None

    @pytest.mark.cuda
    def test_stride_batch_replay_is_the_eager_step(self, cuda_device, no_plain):
        runs = _replay_and_eager(lambda graph: (lambda got, want, bank: (
            got, [bank.program.step.captures]))(*gs.run_stride_scene(cuda_device, graph)))
        _assert_replay_is_eager(runs, [1], {"fold.cu", "agc.cu", "squelch.cu"})
        got = runs[True][0]
        assert len(got) == 6
        for a, b in zip(got, got[1:]):
            assert not np.array_equal(a[0], b[0])

    @pytest.mark.cuda
    def test_compressed_waterfall_replay_is_the_eager_step(self, cuda_device, no_plain):
        runs = _replay_and_eager(lambda graph: gs.run_waterfall_scene(cuda_device, graph))
        _assert_replay_is_eager(runs, [1], {"adpcm_seq.cu"})

    @pytest.mark.cuda
    def test_dmr_program_replay_is_the_eager_step(self, cuda_device, no_plain):
        runs = _replay_and_eager(lambda graph: gs.run_dv_scene(cuda_device, graph))
        _assert_replay_is_eager(runs, [1], set())

    @pytest.mark.cuda
    def test_mode_switch_captures_again(self, cuda_device, no_plain):
        runs = _replay_and_eager(lambda graph: gs.run_mode_switch_scene(cuda_device, graph))
        _assert_replay_is_eager(runs, [1, 1], {"adpcm.cu", "agc.cu", "squelch.cu", "iir.cu"})

    @pytest.mark.cuda
    def test_psk31_secondary_replay_is_the_eager_step(self, cuda_device, no_plain):
        def scene(graph):
            got, captures = gs.run_secondary_scene(cuda_device, graph)
            return [(np.int32(i), y, np.frombuffer(b"".join(p or []), np.uint8))
                    for i, y, p in got], captures
        runs = _replay_and_eager(scene)
        # one capture per program: the first, and the one the growth built
        _assert_replay_is_eager(runs, [1, 1], {"adpcm_seq.cu"})

    @pytest.mark.cuda
    def test_runtime_dispatches_every_bank_as_a_replay(self, cuda_device, no_plain):
        """A DeviceRuntime with a listener, a service, a full-rate edge
        dial and the waterfall, fed the same wire blocks with a retune, a
        squelch and a bandpass change between them: every byte it delivers
        equals the eager runtime's; each bank and the waterfall captured
        once."""
        def scene(graph):
            rng = np.random.default_rng(0)
            with gs.runtime_graph(graph):
                rt = DeviceRuntime(_source([]), capacity=8, target_seconds=0.05,
                                   host=PORT_HOST, fft_size=1024, device=cuda_device)
                got = []
                rt.subscribe_waterfall(lambda p: got.append(("wf", p)))
                hs = [rt.open_channel("usb", 48_500.0),
                      rt.open_channel("usb", 96_500.0, service=True),
                      rt.open_channel("usb", 36_000.0)]       # a channel edge
                for i, h in enumerate(hs):
                    h.audio_cb = lambda wire, hd, i=i: got.append((i, bytes(wire)))
                for b in range(12):
                    if b == 3:
                        hs[0].set_offset(49_000.0)
                    if b == 5:
                        hs[0].set_squelch(0.0)
                    if b == 7:
                        hs[2].set_bandpass(500.0, 1800.0)
                    rt._process_block((rng.standard_normal((rt.block, 2)) * 0.05
                                       ).astype(np.float32))
            banks = [rt.banks[k] for k in sorted(rt.banks)]
            steps = [b.program.step for b in banks]
            steps.append(rt.fft_program.step)
            return ([(np.frombuffer(str(k).encode(), np.uint8), np.frombuffer(v, np.uint8))
                     for k, v in got], [st.captures for st in steps])
        runs = _replay_and_eager(scene)
        assert len(runs[True][1]) == 4            # pfbi:ssb, pfb:ssb, ssb, waterfall
        _assert_replay_is_eager(runs, [1, 1, 1, 1], {"fold.cu", "agc.cu", "squelch.cu",
                                                      "adpcm.cu", "adpcm_seq.cu"})


WARM_UP_SCRIPT = """
import json, subprocess, sys
from openwebrx_tpu_torch import kernels
from openwebrx_tpu_torch.core.config import Config, CoreConfig
from openwebrx_tpu_torch.ops import adpcm
from openwebrx_tpu_torch.sdr import SdrService
CoreConfig.defaults["data_directory"] = sys.argv[1]
CoreConfig.defaults["temporary_directory"] = sys.argv[1]
Config.get()["sdrs"] = {"card": {"name": "Card", "type": "signal", "samp_rate": 3072000,
                                 "center_freq": 14100000, "throttle": False,
                                 "noise": 2e-3, "signals": []}}
SdrService.device = "cuda"
kernels.build_all()         # as the server does before it warms up
popen, shapes = [], set()
def no_popen(*args, **kwargs):
    popen.append(repr(args))
    raise RuntimeError("the warm-up started a subprocess")
subprocess.Popen = no_popen
encode_seq = adpcm.encode_seq_kernel
def recording(state, samples, *args, **kwargs):
    shapes.add(tuple(samples.shape))
    return encode_seq(state, samples, *args, **kwargs)
adpcm.encode_seq_kernel = recording
before = {k.source.name: k.loaded for k in kernels.ALL}
seconds = SdrService.warm()
rt = SdrService.get_device("card")
print(json.dumps({"before": before, "after": {k.source.name: k.loaded for k in kernels.ALL},
                  "launches": {k.source.name: k.launches for k in kernels.ALL},
                  "banks": sorted(rt.banks), "handles": len(rt.handles),
                  "secondary_banks": sorted(rt.secondary_banks),
                  "secondary_handles": len(rt.secondary_handles),
                  "row_encoder_shapes": sorted(shapes), "popen": popen,
                  "seconds": seconds}))
"""
# the secondary FFT's rows at the row encoder: 2048 bins, 10 pad samples,
# whole 16-byte vectors (ops/adpcm.py fft_row_samples)
SECONDARY_FFT_SAMPLES = 2064


class TestWarmUpOnCard:
    @pytest.mark.cuda
    def test_warm_up_loads_every_kernel_and_builds_no_real_bank(self, cuda_device,
                                                                tmp_path):
        """In a fresh process: no kernel library is loaded before
        SdrService.warm, every one of kernels.ALL is after it, the warm-up
        launched all six, the row encoder at the secondary FFT's row width
        among them, it started no subprocess, and the runtime get_device
        hands out has no bank, no handle and no secondary bank or
        handle."""
        import json
        import subprocess
        import sys
        from pathlib import Path
        repo = Path(__file__).resolve().parents[1]
        proc = subprocess.run([sys.executable, "-c", WARM_UP_SCRIPT, str(tmp_path)],
                              cwd=repo, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        names = {k.source.name for k in kernels.ALL}
        assert got["before"] == dict.fromkeys(names, False)
        assert got["after"] == dict.fromkeys(names, True)
        assert all(got["launches"][n] > 0 for n in names), got["launches"]
        assert got["banks"] == [] and got["handles"] == 0
        assert got["secondary_banks"] == [] and got["secondary_handles"] == 0
        assert got["popen"] == []
        assert any(shape[-1] == SECONDARY_FFT_SAMPLES for shape in got["row_encoder_shapes"]), \
            got["row_encoder_shapes"]


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
