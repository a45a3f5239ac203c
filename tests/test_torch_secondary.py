"""The port's secondary and digital-voice chains (openwebrx_tpu_torch):
timing recovery, the 4FSK slicer, PSK31/RTTY/CW, the CW skimmer, FAX/SSTV
and the DV symbol chains.

Synthesized signals go through the port's chains on the CPU and the JAX
package's host decoders turn the outputs into text; the ops and the
FAX/skimmer chains are held against the JAX package on the same numpy
inputs, with the tolerances stated below.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from openwebrx_tpu.digimodes import psk as pskmod
from openwebrx_tpu.digimodes.cw import CwDecoder, CwSkimmer, MORSE
from openwebrx_tpu.digimodes.rtty import ITA2_LETTERS, LTRS, RttyFramer
from openwebrx_tpu.models.digital_voice import DV_FACTORY as JAX_DV
from openwebrx_tpu.models.secondary import SECONDARY_FACTORY as JAX_SECONDARY
from openwebrx_tpu.models.stages import plan_block_size as jax_plan
from openwebrx_tpu.ops import convert as jconvert
from openwebrx_tpu.ops import fsk as jfsk
from openwebrx_tpu.ops import timing as jtiming
from openwebrx_tpu.ops.formats import Format as JaxFormat, StreamSpec as JaxSpec
from openwebrx_tpu.runtime.chain import Program as JaxProgram
from openwebrx_tpu_torch.models.digital_voice import DV_FACTORY, DvSymbolChain
from openwebrx_tpu_torch.models.fax import CARRIER_HZ, DEVIATION_HZ
from openwebrx_tpu_torch.models.secondary import (
    SECONDARY_FACTORY, CwChain, CwSkimmerChain, PskChain, RttyChain,
)
from openwebrx_tpu_torch.models.stages import plan_block_size
from openwebrx_tpu_torch.ops import convert as tconvert
from openwebrx_tpu_torch.ops import fsk as tfsk
from openwebrx_tpu_torch.ops import timing as ttiming
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.chain import Program

FS = 48000.0
MORSE_INV = {v: k for k, v in MORSE.items()}
# complex symbols and float chain outputs against JAX: float32 sincos,
# FFT and conv sums in other orders, 1e-4 of the output's scale
CHAIN_RTOL = 1e-4
# secondary waterfall rows (aux), dB, on bins within 60 dB of the peak
AUX_DB_ATOL = 1e-2


def run_chain(chain, x, fs=FS):
    spec = StreamSpec(Format.COMPLEX_FLOAT, fs)
    prog = Program(chain, spec, plan_block_size(chain, spec, 0.1), device="cpu")
    n = len(x) // prog.block
    return [prog.process(blk) for blk in np.split(x[: n * prog.block], n)]


def fsk_iq(bits, f0, baud, shift, fs=FS):
    freq = np.repeat([f0 + (shift / 2 if b else -shift / 2) for b in bits],
                     int(round(fs / baud)))
    return (0.5 * np.exp(2j * np.pi * np.cumsum(freq) / fs)).astype(np.complex64)


class TestOps:
    @pytest.mark.parametrize("sps", [4, 10])
    def test_timing_recover_matches_jax(self, sps):
        # symbols: the offset estimate is an angle of a block sum whose
        # float32 order differs; 1e-4 of the scale and 1e-3 samples
        rng = np.random.default_rng(sps)
        dibits = rng.choice([-3.0, -1.0, 1.0, 3.0], (2, 120))
        x = np.repeat(dibits, sps, axis=-1)
        x = (np.exp(1j * 0.3 * x) + 0.05 * rng.standard_normal(x.shape)).astype(np.complex64)
        js = jtiming.timing_init((2,), sps)
        ts = ttiming.timing_init((2,), sps, device="cpu")
        for blk in np.split(x, 3, axis=-1):
            js, jy = jtiming.recover(js, jnp.asarray(blk), sps)
            ts, ty = ttiming.recover(ts, torch.from_numpy(blk), sps)
            jy = np.asarray(jy)
            assert ty.dtype == torch.complex64 and ty.shape == jy.shape
            assert np.abs(ty.numpy() - jy).max() <= CHAIN_RTOL * np.abs(jy).max()
            assert np.abs(ts[0].numpy() - np.asarray(js[0])).max() <= 1e-3
            np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))

    def test_timing_first_block_keeps_the_sentinel_rule(self):
        st = ttiming.timing_init((), 4, device="cpu")
        assert float(st[0]) == -1e9 and st[1].shape == (8,)

    def test_fsk4_slice_matches_jax(self):
        y = np.array([3.0, 1.0, -1.0, -3.0, 2.9, -0.9], np.float32)
        assert list(tfsk.fsk4_slice(torch.from_numpy(y)).numpy()) == \
            [0b01, 0b00, 0b10, 0b11, 0b01, 0b10]
        rng = np.random.default_rng(1)
        level = np.array([1.0, 3.0, -1.0, -3.0])[rng.integers(0, 4, (3, 500))]
        for gain in (0.01, 1.0, 250.0):
            yy = (level * gain + 0.3 * gain * rng.standard_normal(level.shape)
                  ).astype(np.float32)
            got = tfsk.fsk4_slice(torch.from_numpy(yy)).numpy()
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, np.asarray(jfsk.fsk4_slice(jnp.asarray(yy))))
        np.testing.assert_array_equal(
            tfsk.fsk2_slice(torch.from_numpy(yy)).numpy(),
            np.asarray(jfsk.fsk2_slice(jnp.asarray(yy))))

    def test_convert_matches_jax(self):
        rng = np.random.default_rng(2)
        s16 = rng.integers(-32768, 32767, (3, 40)).astype(np.int16)
        u8 = rng.integers(0, 256, 80).astype(np.uint8)
        np.testing.assert_array_equal(
            tconvert.short_to_float(torch.from_numpy(s16)).numpy(),
            np.asarray(jconvert.short_to_float(jnp.asarray(s16))))
        np.testing.assert_array_equal(tconvert.complex_short_to_complex(s16),
                                      jconvert.complex_short_to_complex(s16))
        np.testing.assert_array_equal(tconvert.uint8_iq_to_complex(u8),
                                      jconvert.uint8_iq_to_complex(u8))
        st = rng.standard_normal((4, 10, 2)).astype(np.float32)
        np.testing.assert_allclose(tconvert.downmix(torch.from_numpy(st)).numpy(),
                                   np.asarray(jconvert.downmix(jnp.asarray(st))),
                                   rtol=1e-6)

    def test_factories_cover_the_reference(self):
        assert set(SECONDARY_FACTORY) == set(JAX_SECONDARY)
        assert set(DV_FACTORY) == set(JAX_DV)
        assert isinstance(DV_FACTORY["ysf"](240000.0), DvSymbolChain)

    def test_dv_decoders_equal_the_reference(self):
        from openwebrx_tpu.models.digital_voice import DV_DECODERS as JAX_DECODERS
        from openwebrx_tpu_torch.models.digital_voice import DV_DECODERS
        assert DV_DECODERS == JAX_DECODERS


class TestTextDecodes:
    def test_psk31(self):
        baud, f0, text = 31.25, 2000.0, "cq cq de tpu"
        bits = [0] * 24
        for ch in text:
            bits += [int(b) for b in pskmod._VARICODE[ord(ch)]] + [0, 0]
        bits += [0] * 16
        phases = [1.0]
        for b in bits:                       # DBPSK: 1 keeps, 0 flips
            phases.append(phases[-1] * (1.0 if b else -1.0))
        sym = np.repeat(phases, int(FS / baud))
        x = (0.5 * sym * np.exp(2j * np.pi * f0 / FS * np.arange(len(sym)))
             ).astype(np.complex64)
        chain = PskChain(FS, baud)
        chain.set_frequency_offset(f0)
        outs = run_chain(chain, x)
        symbols = np.concatenate([y for y, _ in outs])
        assert symbols.dtype == np.complex64
        assert all(a["secondary_fft.rows"].shape[-1] == 2048 for _, a in outs)
        decoded = pskmod.VaricodeDecoder().decode(pskmod.dbpsk_bits(symbols))
        assert text in decoded, decoded

    def test_rtty(self):
        baud, shift, f0 = 45.45, 170.0, 1500.0
        bits = [1] * 8
        for code in [LTRS] + [ITA2_LETTERS.index(c) for c in "RYRYRY"]:
            bits += [0] + [(code >> i) & 1 for i in range(5)] + [1, 1]
        bits += [1] * 8
        chain = RttyChain(FS, baud, shift)
        chain.set_frequency_offset(f0)
        symbols = np.concatenate([y for y, _ in run_chain(chain, fsk_iq(bits, f0, baud, shift))])
        decoded = RttyFramer().decode((symbols.real > 0).astype(np.uint8))
        assert "RYRY" in decoded, decoded

    def test_cw(self):
        f0, dit = 800.0, 1.2 / 20.0
        env = []
        for ch in "TEST":
            for j, sym in enumerate(MORSE_INV[ch]):
                if j:
                    env += [0.0] * int(dit * FS)
                env += [1.0] * int((1 if sym == "." else 3) * dit * FS)
            env += [0.0] * int(3 * dit * FS)
        env = np.array(env + [0.0] * int(8 * dit * FS))
        x = (0.6 * env * np.exp(2j * np.pi * f0 / FS * np.arange(len(env)))
             ).astype(np.complex64)
        chain = CwChain(FS)
        chain.set_frequency_offset(f0)
        envelope = np.concatenate([y for y, _ in run_chain(chain, x)])
        decoded = CwDecoder(CwChain.ENV_RATE, wpm_hint=20.0).decode(envelope)
        assert "TEST" in decoded.replace(" ", ""), decoded

    def test_dmr_symbols_recovered(self):
        """C4FM dibits at 4800 Bd through the DMR chain (240 kHz input):
        > 95 % agree with the sent ones after the filters' delay."""
        from openwebrx_tpu_torch.ops.firdes import root_raised_cosine_taps
        fs, sps = 240000.0, 50
        rng = np.random.default_rng(7)
        dibits = rng.integers(0, 4, 2400)
        impulses = np.zeros(len(dibits) * sps)
        impulses[::sps] = np.array([1.0, 3.0, -1.0, -3.0])[dibits]
        taps = root_raised_cosine_taps(sps, 0.2)
        freqs = np.convolve(impulses, taps * sps / taps.sum(), mode="same") * 648.0
        x = (0.5 * np.exp(2j * np.pi * np.cumsum(freqs) / fs)).astype(np.complex64)
        chain = DV_FACTORY["dmr"](fs)
        chain.set_frequency_offset(0.0)
        out = np.concatenate([y for y, _ in run_chain(chain, x, fs)])
        assert out.dtype == np.uint8
        best = max(np.mean(dibits[200:n] == out[lag:][200:n])
                   for lag in range(80)
                   for n in [min(len(dibits), len(out) - lag)] if n >= 500)
        assert best > 0.95, best


def _jax_and_port(mode, fs, batch=(2,)):
    jc, tc = JAX_SECONDARY[mode](fs), SECONDARY_FACTORY[mode](fs)
    jspec, tspec = JaxSpec(JaxFormat.COMPLEX_FLOAT, fs), StreamSpec(Format.COMPLEX_FLOAT, fs)
    block = plan_block_size(tc, tspec, 0.1)
    assert block == jax_plan(jc, jspec, 0.1)
    return jc, tc, JaxProgram(jc, jspec, block, batch), Program(tc, tspec, block, batch,
                                                                 device="cpu")


class TestChainsAgainstJax:
    @pytest.mark.parametrize("mode", ["fax", "sstv"])
    def test_fax_chain(self, mode):
        """Subcarrier frequency (the real part) over 3 blocks.  The FM discriminator's first
        samples see the decimator's start-up ramp (~1e-7), whose rounding
        differs between implementations: block 0 is skipped."""
        jc, tc, jp, tp = _jax_and_port(mode, FS)
        for c in (jc, tc):
            c.set_frequency_offset(1000.0)
        rng = np.random.default_rng(5)
        n = jp.block * 3
        px = rng.integers(0, 256, n // 400).repeat(400)
        freq = CARRIER_HZ + (px / 255.0 * 2 - 1) * DEVIATION_HZ + 1000.0
        x = (0.5 * np.exp(2j * np.pi * np.cumsum(freq) / FS)).astype(np.complex64)
        for b, blk in enumerate(np.split(x, 3)):
            (jy, ja), (ty, ta) = jp.process(blk), tp.process(blk)
            jy = np.asarray(jy)
            # the discriminator's output rides the complex decimator
            assert ty.dtype == jy.dtype == np.complex64 and ty.shape == jy.shape == (2, 300)
            if b:
                assert np.abs(ty - jy).max() <= CHAIN_RTOL * np.abs(jy).max()
            jr, tr = np.asarray(ja["secondary_fft.rows"]), ta["secondary_fft.rows"]
            mask = jr >= jr.max(axis=-1, keepdims=True) - 60.0
            assert np.abs(tr - jr)[mask].max() <= AUX_DB_ATOL

    def test_cw_skimmer_chain_and_decoder(self):
        """Skimmer frames against JAX, and the host skimmer decodes TEST
        from the port's frames."""
        fs = 240000.0
        jc, tc, jp, tp = _jax_and_port("cwskimmer", fs, batch=())
        wpm, f0 = 25.0, 2000.0
        dit = fs * 1.2 / wpm
        env = [np.zeros(int(4 * dit))]
        for ch in "TEST":
            for sym in MORSE_INV[ch]:
                env += [np.ones(int(dit if sym == "." else 3 * dit)), np.zeros(int(dit))]
            env.append(np.zeros(int(3 * dit)))
        env = np.concatenate(env + [np.zeros(int(8 * dit))])
        k = int(0.005 * fs)
        env = np.convolve(env, np.hanning(k) / np.hanning(k).sum(), mode="same")
        sig = (0.4 * env * np.exp(2j * np.pi * f0 * np.arange(len(env)) / fs)
               ).astype(np.complex64)
        sig = np.concatenate([sig, np.zeros((-len(sig)) % jp.block, np.complex64)])
        skimmer = CwSkimmer(tc.bin_hz, tc.env_rate)
        texts, frames = [], []
        for i in range(0, len(sig), jp.block):
            (jf, _), (tf, _) = jp.process(sig[i:i + jp.block]), tp.process(sig[i:i + jp.block])
            jf = np.asarray(jf)
            assert tf.shape == jf.shape and tf.dtype == np.float32
            frames.append((tf, jf))
            texts += [t for _, t in skimmer.process(tf)]
        # the scale is the signal's: key-up frames are filter noise (~1e-7)
        tf, jf = (np.concatenate(f) for f in zip(*frames))
        assert np.abs(tf - jf).max() <= CHAIN_RTOL * np.abs(jf).max()
        assert "TEST" in "".join(texts).replace(" ", ""), texts
        assert isinstance(tc, CwSkimmerChain) and tc.bin_hz == 93.75


def _jax_state_numpy(prog):
    """A JAX Program's chain state with complex leaves as complex64."""
    import jax
    from openwebrx_tpu.runtime.chain import _unpack_leaf
    return jax.tree.map(lambda v, c: np.asarray(_unpack_leaf(v, c)), prog.state, prog._s_mask)


def _secondary_signal(mode, offsets, n, rng):
    """Two channels' worth of the mode's own signal at ``offsets`` plus
    noise: DBPSK at the mode's baud, FSK at its shift, keyed CW."""
    if mode.startswith("bpsk"):
        baud = 31.25 if mode == "bpsk31" else 62.5
        phases = np.cumprod(np.where(rng.integers(0, 2, int(n / FS * baud) + 2), 1.0, -1.0))
        env = np.repeat(phases, int(FS / baud))[:n]
        sig = sum(0.4 * env * np.exp(2j * np.pi * o / FS * np.arange(n)) for o in offsets)
    elif mode == "cwdecoder":
        key = np.repeat(rng.integers(0, 2, n // 2400 + 1), 2400)[:n]
        sig = sum(0.5 * key * np.exp(2j * np.pi * o / FS * np.arange(n)) for o in offsets)
    else:
        baud, shift = {"rtty170": (45.45, 170.0), "rtty450": (50.0, 450.0),
                       "rtty85": (50.0, 85.0)}.get(mode, (100.0, 170.0))
        bits = rng.integers(0, 2, int(n / FS * baud) + 2)
        sig = sum(fsk_iq(bits, o, baud, shift)[:n] for o in offsets)
    noise = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (sig + noise).astype(np.complex64)


class TestChainParityWithJax:
    """PskChain, RttyChain (rtty170/450/85, sitorb, navtex, dsc), CwChain
    and every DvSymbolChain block for block against the JAX chains, two
    channels at different offsets.  The FSK chains' FM discriminator sees
    the filters' start-up ramp (~1e-7) in block 0, whose rounding differs
    between any two float32 implementations, and the timing recovery keeps
    that in its offset estimate: those chains take the JAX chain's state
    after block 0 (as the analog chains do) and blocks 1-3 are compared."""

    @pytest.mark.parametrize("mode", ["bpsk31", "bpsk63", "rtty170", "rtty450", "rtty85",
                                      "sitorb", "navtex", "dsc", "cwdecoder"])
    def test_secondary_chain_block_for_block(self, mode):
        from openwebrx_tpu_torch.from_jax import bank_state_from_numpy
        jc, tc, jp, tp = _jax_and_port(mode, FS)
        offsets = np.array([1000.0, -2500.0])
        for c in (jc, tc):
            c.selector.shift.set_rate(-offsets / FS)
        handover = not (mode.startswith("bpsk") or mode == "cwdecoder")
        x = _secondary_signal(mode, offsets, 4 * jp.block, np.random.default_rng(len(mode)))
        for b, blk in enumerate(np.split(x, 4)):
            if b == 1 and handover:
                tp.state = bank_state_from_numpy(_jax_state_numpy(jp), "cpu")
            (jy, ja), (ty, ta) = jp.process(blk), tp.process(blk)
            jy = np.asarray(jy)
            assert ty.dtype == jy.dtype and ty.shape == jy.shape
            if b or not handover:
                assert np.abs(ty - jy).max() <= CHAIN_RTOL * np.abs(jy).max(), (mode, b)
            jr, tr = np.asarray(ja["secondary_fft.rows"]), ta["secondary_fft.rows"]
            mask = jr >= jr.max(axis=-1, keepdims=True) - 60.0
            assert np.abs(tr - jr)[mask].max() <= AUX_DB_ATOL

    @pytest.mark.parametrize("mode", sorted(DV_FACTORY))
    def test_dv_chain_block_for_block(self, mode):
        """C4FM at the mode's baud on two channels (240 kHz input): after
        block 0 (the discriminator's start-up, ≥ 95 % agreement) every
        dibit equals the JAX chain's."""
        import sys
        sys.path.insert(0, "tests")
        from test_digital_voice import c4fm_waveform
        fs = 240000.0
        jc, tc = JAX_DV[mode](fs), DV_FACTORY[mode](fs)
        tspec, jspec = StreamSpec(Format.COMPLEX_FLOAT, fs), JaxSpec(JaxFormat.COMPLEX_FLOAT, fs)
        block = plan_block_size(tc, tspec, 0.1)
        assert block == jax_plan(jc, jspec, 0.1)
        jp = JaxProgram(jc, jspec, block, (2,))
        tp = Program(tc, tspec, block, (2,), device="cpu")
        offsets = np.array([20000.0, -30000.0])
        for c in (jc, tc):
            c.selector.shift.set_rate(-offsets / fs)
        rng = np.random.default_rng(4)
        baud = 2400.0 if mode == "nxdn" else 4800.0
        dibits = rng.integers(0, 4, int(3 * block / fs * baud) + 10)
        x = sum(c4fm_waveform(dibits, baud=baud, offset_hz=o, fs=fs)[: 3 * block]
                for o in offsets)
        x = (x + 0.02 * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
             ).astype(np.complex64)
        for b, blk in enumerate(np.split(x, 3)):
            (jy, _), (ty, _) = jp.process(blk), tp.process(blk)
            jy = np.asarray(jy)
            assert ty.dtype == jy.dtype == np.uint8 and ty.shape == jy.shape
            if b:
                np.testing.assert_array_equal(ty, jy)
            else:
                assert np.mean(ty == jy) >= 0.95
