"""The port's Fanout, batched delivery, host packing helpers and the
full-rate ChannelBank (openwebrx_tpu_torch), on the CPU.

The reference's own Fanout cases (tests/test_fanout.py) run on both
devices in tests/test_torch_ref_serving.py; here the Fanout is held
against the JAX package's.  The ChannelBank runs beside the JAX
bank on the same numpy IQ, with the JAX bank's state carried over into the
port after block 0 (``from_jax.bank_state_from_numpy``).  int16 audio agrees
within AUDIO_LSB and squelch powers within POWER_DB_ATOL.
"""

import jax
import numpy as np
import pytest
import torch

from openwebrx_tpu.ops.formats import Format as JFormat, StreamSpec as JSpec
from openwebrx_tpu.runtime import chain as jchain
from openwebrx_tpu.runtime.bank import ChannelBank as JaxChannelBank
from openwebrx_tpu_torch.from_jax import bank_state_from_numpy
from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain, FftChain
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime import chain as tchain
from openwebrx_tpu_torch.runtime.bank import ChannelBank
from openwebrx_tpu_torch.runtime.chain import Fanout, Program

FS = 240000.0
POWER_KEY = "selector.squelch.power_db"
# int16 audio: fp32 summation order and sincos/FFT rounding (as the
# ChannelizedBank parity tests)
AUDIO_LSB = 2
POWER_DB_ATOL = 1e-3


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.2
            ).astype(np.complex64)


SPEC = StreamSpec(Format.COMPLEX_FLOAT, FS)


class TestFanout:
    def test_matches_the_jax_fanout(self):
        """The same Fanout in both packages on the same blocks: audio within
        AUDIO_LSB, squelch powers and waterfall rows near the peak within
        their tolerances; the port's waterfall branch gives (rows, 1024)
        and the Fanout's parameter version is its branches' sum."""
        from openwebrx_tpu.models.receiver import (
            ClientDemodulatorChain as JaxClient, FftChain as JaxFft)
        from openwebrx_tpu.ops.formats import Format as JF, StreamSpec as JS
        ja = JaxClient(FS, 12000.0, "usb", compression="none")
        jfan = jchain.Fanout([("usb", ja), ("fft", JaxFft(1024, fps=1000.0))],
                             batch_shapes={"usb": (2,), "fft": ()})
        ta = ClientDemodulatorChain(FS, 12000.0, "usb", compression="none")
        tfft = FftChain(1024, fps=1000.0)
        tfan = Fanout([("usb", ta), ("fft", tfft)], batch_shapes={"usb": (2,), "fft": ()})
        for c in (ja, ta):
            c.set_frequency_offset(30000.0)
        jp = jchain.Program(jfan, JS(JF.COMPLEX_FLOAT, FS), 24000)
        tp = Program(tfan, SPEC, 24000, device="cpu")
        assert tfan.params_version() == ta.params_version() + tfft.params_version()
        for b in range(3):
            x = _noise(24000, 20 + b)
            (jy, ja_), (ty, ta_) = jp.process(x), tp.process(x)
            d = np.abs(ty["usb"].astype(np.int32) - np.asarray(jy["usb"]).astype(np.int32))
            assert d.max() <= AUDIO_LSB
            np.testing.assert_allclose(ta_["usb." + POWER_KEY], ja_["usb." + POWER_KEY],
                                       rtol=0, atol=POWER_DB_ATOL)
            jr = np.asarray(jy["fft"])
            assert ty["fft"].ndim == 2 and ty["fft"].shape[-1] == 1024
            mask = jr >= jr.max(axis=-1, keepdims=True) - 60.0
            assert np.abs(ty["fft"] - jr)[mask].max() <= 1e-3


class TestBatchedDelivery:
    def test_join_pending_matches_process(self):
        chain_a = ClientDemodulatorChain(FS, 12000.0, "am", compression="none")
        chain_b = ClientDemodulatorChain(FS, 12000.0, "am", compression="none")
        pa = Program(chain_a, SPEC, 24000, batch_shape=(2,), device="cpu")
        pb = Program(chain_b, SPEC, 24000, batch_shape=(2,), device="cpu")
        blocks = [_noise(24000, 30 + i) for i in range(3)]
        want = [pa.process(x) for x in blocks]
        got = pb.fetch_many(*pb.join_pending([pb.dispatch_quiet(x) for x in blocks]))
        assert len(got) == 3
        for (wy, wa), (gy, ga) in zip(want, got):
            np.testing.assert_array_equal(gy, wy)
            np.testing.assert_array_equal(ga[POWER_KEY], wa[POWER_KEY])

    def test_host_helpers_match_jax(self):
        rng = np.random.default_rng(3)
        c = (rng.standard_normal(10) + 1j * rng.standard_normal(10)).astype(np.complex64)
        packed = tchain.host_pack_complex(c)
        np.testing.assert_array_equal(packed, jchain.host_pack_complex(c))
        np.testing.assert_array_equal(tchain.host_unpack_complex(packed), c)
        for block in (c, packed, (packed * 20000).astype(np.int16),
                      (packed * 100 + 127).astype(np.uint8)):
            np.testing.assert_array_equal(tchain.host_as_complex64(block),
                                          jchain.host_as_complex64(block))


    @pytest.mark.parametrize("kind", ["complex64", "float32", "int16", "uint8"])
    def test_pack_input_matches_jax(self, kind):
        """Program.pack_input: complex64 blocks come back as the packed
        float32 view, packed float32/int16/uint8 blocks as they are, real
        programs take their samples as they are; the same wrong sizes raise
        ValueError on both sides."""
        rng = np.random.default_rng(4)
        block = 24000
        chain = ClientDemodulatorChain(FS, 12000.0, "usb", compression="none")
        tp = Program(chain, SPEC, block, device="cpu")
        jp = jchain.Program(jchain.Chain([]), JSpec(JFormat.COMPLEX_FLOAT, FS), block)
        c = (rng.standard_normal(block) + 1j * rng.standard_normal(block)
             ).astype(np.complex64)
        packed = tchain.host_pack_complex(c)
        x = {"complex64": c, "float32": packed,
             "int16": (packed * 20000).astype(np.int16),
             "uint8": (packed * 100 + 127).astype(np.uint8)}[kind]
        got, want = tp.pack_input(x), jp.pack_input(x)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        for bad in (x[: block // 2], x[1:]):
            with pytest.raises(ValueError):
                jp.pack_input(bad)
            with pytest.raises(ValueError):
                tp.pack_input(bad)
        real = Program(tchain.Chain([]), StreamSpec(Format.FLOAT, FS), block,
                       device="cpu")
        jreal = jchain.Program(jchain.Chain([]), JSpec(JFormat.FLOAT, FS), block)
        r = c.real.copy()
        assert real.pack_input(r) is r and jreal.pack_input(r) is r
        for prog in (real, jreal):
            with pytest.raises(ValueError):
                prog.pack_input(r[1:])

def _jax_program_state(prog):
    """A JAX Program's chain state with complex leaves as complex64."""
    return jax.tree.map(lambda v, c: np.asarray(jchain._unpack_leaf(v, c)),
                        prog.state, prog._s_mask)


def _tones(block, nblocks, offsets, seed):
    rng = np.random.default_rng(seed)
    n = np.arange(block * nblocks)
    x = sum(0.4 * np.exp(2j * np.pi * (o + 1000.0) / FS * n) for o in offsets)
    x = x + 0.05 * (rng.standard_normal(len(n)) + 1j * rng.standard_normal(len(n)))
    return np.split(x.astype(np.complex64), nblocks)


class TestChannelBank:
    def test_slots_retune_squelch_against_jax(self):
        kw = dict(mode="usb", capacity=4, compression="none", target_seconds=0.05)
        jb = JaxChannelBank(FS, **kw)
        tb = ChannelBank(FS, device="cpu", **kw)
        assert tb.block == jb.block
        offsets = (30000.0, -45000.0, 70000.0)
        for o in offsets:
            assert jb.add_channel(o) == tb.add_channel(o)
        for bank in (jb, tb):
            bank.set_squelch(1, -40.0)
        for i, blk in enumerate(_tones(jb.block, 5, offsets, seed=1)):
            if i == 1:
                tb.program.state = bank_state_from_numpy(_jax_program_state(jb.program), "cpu")
            if i == 2:
                for bank in (jb, tb):
                    bank.retune(0, 50000.0)
                    bank.set_bandpass(2, 200.0, 2500.0)
                    bank.set_nr(2, -10.0)
                    bank.remove_channel(1)
            (yj, aj), (yt, at) = jb.process(blk), tb.process(blk)
            yj = np.asarray(yj)
            assert yt.dtype == np.int16 and yt.shape == yj.shape == (4, jb.block // 20)
            if i == 0:
                continue
            d = np.abs(yt.astype(np.int32) - yj.astype(np.int32))
            assert d.max() <= AUDIO_LSB, (i, d.max())
            np.testing.assert_allclose(at[POWER_KEY], aj[POWER_KEY], rtol=0,
                                       atol=POWER_DB_ATOL)
        assert list(tb.active_slots) == [0, 2] and tb.n_active == 2
        assert tb.add_channel(10000.0) == 1

    def test_feed_dispatch_accumulates_chunks(self):
        """A device chunk smaller than the chain's block: chunks gather on
        the device until one bank block is full, as one direct dispatch."""
        from openwebrx_tpu_torch.models.stages import block_requirement
        kw = dict(mode="usb", capacity=2, compression="none")
        req = block_requirement(ClientDemodulatorChain(FS, 12000.0, "usb", "none"), SPEC)
        p = next(d for d in range(2, req + 1) if req % d == 0)   # smallest prime
        # chunks of (p + 1)/p requirements: p of them make a bank block
        direct = ChannelBank(FS, device="cpu", block=req * (p + 1), **kw)
        fed = ChannelBank(FS, device="cpu", block=req // p * (p + 1), **kw)
        assert direct.chunk_ratio == 1
        assert fed.chunk_ratio == p and fed.block == direct.block
        for bank in (direct, fed):
            bank.add_channel(20000.0)
        x = _noise(direct.block, 5)
        want = direct.process(x)
        outs = [fed.feed_dispatch(torch.from_numpy(c)) for c in np.split(x, p)]
        assert [len(o) for o in outs] == [0] * (p - 1) + [1]
        got = fed.fetch(outs[-1][0])
        np.testing.assert_array_equal(got[0], want[0])

    def test_default_device_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        with pytest.raises(RuntimeError):
            ChannelBank(FS, "usb", capacity=2)
