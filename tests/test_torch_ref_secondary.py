"""The reference's own digimode and secondary-chain tests, carried onto the
port: tests/test_impairments.py, test_digimodes.py, test_cwskimmer.py,
test_fax.py, test_sstv.py, test_sstv_vis.py, test_secondary_maritime_image.py
and test_rds.py.

Each reference file is one outer class here, named after it
(``test_impairments.py`` → ``TestImpairments``), holding the reference's
classes and cases under their own names, with the reference's inputs,
seeds, assertions and bounds; the signals are decoded by the port's own
host decoders (its copies of the reference's).  Only what the port's API
forces differs: ``Program``/``build_program`` get ``device=``, and the fake
runtime ``SecondaryHandle`` is given carries the port's ``device`` and
``host`` (``PORT_HOST``) beside ``in_rate``.  Every case runs on
``device`` "cpu" (the plain versions) and "cuda" (the card; the ``cuda``
marker, skipped without a card).  The file imports no jax and nothing of
``openwebrx_tpu``.

Reference cases left out, each because it runs no device code of the port
(tests/test_torch_ref_coverage.py keeps this list; the host modules they
test are held to the reference by tests/test_torch_host_copy.py):

* test_digimodes.py ``TestRtty::test_framer_roundtrip`` and
  ``TestCw::test_decoder_direct``: host decoders fed bits/envelopes.
* test_cwskimmer.py ``TestCwSkimmerHost::test_two_signals_decoded``: numpy
  STFT frames into the host skimmer.
* test_sstv_vis.py (all 5 cases): frequency traces synthesized at the
  chain's output rate straight into the host ``SstvDecoder``; only
  ``IF_RATE``, a constant, comes from ``models``.
* test_rds.py ``TestLogical`` (5 cases) and ``TestPhysical`` (1 case): the
  host RDS decoder fed bits and a numpy-filtered baseband.
"""

import json
import types

import numpy as np
import pytest

from openwebrx_tpu_torch.digimodes import psk as pskmod
from openwebrx_tpu_torch.digimodes.cw import MORSE, CwDecoder, CwSkimmer
from openwebrx_tpu_torch.digimodes.dsc import EOS_REQ, FMT_SELECTIVE, encode_call
from openwebrx_tpu_torch.digimodes.rds import RdsDecoder, rds_modulate
from openwebrx_tpu_torch.digimodes.rtty import ITA2_LETTERS, LTRS, RttyFramer
from openwebrx_tpu_torch.digimodes.sitor import SitorBDecoder, encode_fec
from openwebrx_tpu_torch.models.fax import CARRIER_HZ, DEVIATION_HZ, PIXEL_RATE, FaxChain
from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain, build_program
from openwebrx_tpu_torch.models.secondary import CwChain, CwSkimmerChain, PskChain, RttyChain
from openwebrx_tpu_torch.models.stages import plan_block_size
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.chain import Program
from openwebrx_tpu_torch.runtime.device import PORT_HOST, SecondaryHandle
from openwebrx_tpu_torch.services.fax import FaxDecoder
from openwebrx_tpu_torch.services.sstv import MODES, SSTV_CARRIER, SSTV_DEV, SstvDecoder
from torch_ref_device import card_report, device  # noqa: F401  (fixtures)

FS = 48000.0


def program(chain, device, fs=FS):
    spec = StreamSpec(Format.COMPLEX_FLOAT, fs)
    block = plan_block_size(chain, spec, 0.1)
    return Program(chain, spec, block, device=device)


def run_chain_blocks(chain, x, device):
    """tests/test_digimodes.py's run_chain: the chain's output blocks."""
    prog = program(chain, device)
    block = prog.block
    outs = []
    n = len(x) // block
    for blk in np.split(x[: n * block], n):
        y, _ = prog.process(blk)
        outs.append(y)
    return outs


def run_chain(chain, x, device):
    """tests/test_impairments.py's run_chain: the output, concatenated."""
    return np.concatenate([np.asarray(y) for y in run_chain_blocks(chain, x, device)])


# ------------------------------------------------------ tests/test_impairments.py
def impair(x, cfo_hz=0.0, drift_hz_s=0.0, snr_db=None, seed=0):
    """Apply carrier offset, linear drift, and AWGN (full-band SNR)."""
    n = np.arange(len(x))
    t = n / FS
    x = x * np.exp(2j * np.pi * (cfo_hz * t + 0.5 * drift_hz_s * t * t))
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        p_sig = float(np.mean(np.abs(x) ** 2))
        p_noise = p_sig / 10.0 ** (snr_db / 10.0)
        x = x + (rng.standard_normal(len(x))
                 + 1j * rng.standard_normal(len(x))) * np.sqrt(p_noise / 2)
    return x.astype(np.complex64)


def psk31_baseband(text: str, f0: float) -> np.ndarray:
    bits = [0] * 24
    for ch in text:
        bits.extend(int(b) for b in pskmod._VARICODE[ord(ch)])
        bits.extend([0, 0])
    bits += [0] * 16
    sps = FS / 31.25
    phases = [1.0]
    for b in bits:
        phases.append(phases[-1] * (1.0 if b else -1.0))
    sym = np.repeat(phases, int(sps))
    n = np.arange(len(sym))
    return (0.5 * sym * np.exp(2j * np.pi * f0 / FS * n)).astype(np.complex64)


def decode_psk31(x, f0, device):
    chain = PskChain(FS, 31.25)
    chain.set_frequency_offset(f0)
    symbols = run_chain(chain, x, device)
    return pskmod.VaricodeDecoder().decode(pskmod.dbpsk_bits(symbols))


def rtty_baseband(text: str, f0: float, baud=45.45, shift=170.0) -> np.ndarray:
    codes = [LTRS] + [ITA2_LETTERS.index(c) for c in text]
    bits = [1] * 8
    for code in codes:
        bits.append(0)
        bits.extend((code >> i) & 1 for i in range(5))
        bits.extend([1, 1])
    bits += [1] * 8
    sps = int(round(FS / baud))
    freq = np.repeat([f0 + (shift / 2 if b else -shift / 2) for b in bits], sps)
    phase = 2 * np.pi * np.cumsum(freq) / FS
    return (0.5 * np.exp(1j * phase)).astype(np.complex64)


def decode_rtty(x, f0, device, baud=45.45, shift=170.0):
    chain = RttyChain(FS, baud, shift)
    chain.set_frequency_offset(f0)
    symbols = run_chain(chain, x, device)
    return RttyFramer().decode((symbols.real > 0).astype(np.uint8))


def sitorb_bits(text: str) -> list[int]:
    bits = []
    for word in encode_fec(text):
        bits.extend((word >> i) & 1 for i in range(7))
    return bits


def sitorb_baseband(bits, f0: float) -> np.ndarray:
    """100 Bd CCIR 476 FEC stream as FSK (mark=1 high tone)."""
    stream = [1] * 14 + list(bits) + [1] * 14
    sps = int(round(FS / 100.0))
    freq = np.repeat([f0 + (85.0 if b else -85.0) for b in stream], sps)
    phase = 2 * np.pi * np.cumsum(freq) / FS
    return (0.5 * np.exp(1j * phase)).astype(np.complex64)


def sitorb_ber(x, f0, tx_bits, device) -> float:
    """Demodulate through the 100 Bd FSK chain and measure the bit error
    rate against the transmitted stream, searching the alignment lag."""
    chain = RttyChain(FS, 100.0, 170.0, name="sitorb")
    chain.set_frequency_offset(f0)
    rx = (run_chain(chain, x, device).real > 0).astype(np.int8)
    tx = np.asarray(tx_bits, np.int8)
    best = 1.0
    for lag in range(0, max(1, len(rx) - len(tx))):
        seg = rx[lag: lag + len(tx)]
        if len(seg) < len(tx):
            break
        best = min(best, float(np.mean(seg != tx)))
    return best


class TestImpairments:
    class TestPsk31Impairments:
        TEXT = "cq de tpu"

        def test_cfo(self, device):
            # +4 Hz uncorrected offset: 2/3 of the 6 Hz tolerance window
            x = impair(psk31_baseband(self.TEXT, 2000.0), cfo_hz=4.0)
            assert self.TEXT in decode_psk31(x, 2000.0, device)

        def test_drift(self, device):
            # −2 Hz/s across the whole transmission, starting at +3 Hz: the
            # carrier crosses the channel center during the message
            x = impair(psk31_baseband(self.TEXT, 2000.0),
                       cfo_hz=3.0, drift_hz_s=-2.0)
            assert self.TEXT in decode_psk31(x, 2000.0, device)

        @pytest.mark.parametrize("seed", [1, 2, 3])
        def test_near_threshold_snr(self, seed, device):
            # −18 dB full-band ≈ Eb/N0 14 dB — 4 dB above measured threshold
            x = impair(psk31_baseband(self.TEXT, 2000.0), snr_db=-18.0, seed=seed)
            assert self.TEXT in decode_psk31(x, 2000.0, device)

        def test_snr_with_cfo_and_drift(self, device):
            x = impair(psk31_baseband(self.TEXT, 2000.0),
                       cfo_hz=-3.0, drift_hz_s=1.5, snr_db=-15.0, seed=7)
            assert self.TEXT in decode_psk31(x, 2000.0, device)

    class TestRttyImpairments:
        def test_cfo(self, device):
            x = impair(rtty_baseband("RYRYRY", 1500.0), cfo_hz=25.0)
            assert "RYRY" in decode_rtty(x, 1500.0, device)

        def test_drift(self, device):
            x = impair(rtty_baseband("RYRYRYRYRY", 1500.0),
                       cfo_hz=-5.0, drift_hz_s=2.0)
            assert "RYRY" in decode_rtty(x, 1500.0, device)

        @pytest.mark.parametrize("seed", [1, 2, 3])
        def test_near_threshold_snr(self, seed, device):
            x = impair(rtty_baseband("RYRYRY", 1500.0), snr_db=-12.0, seed=seed)
            assert "RYRY" in decode_rtty(x, 1500.0, device)

        def test_snr_with_cfo(self, device):
            x = impair(rtty_baseband("RYRYRY", 1500.0),
                       cfo_hz=20.0, snr_db=-9.0, seed=5)
            assert "RYRY" in decode_rtty(x, 1500.0, device)

    class TestSitorBImpairments:
        def test_cfo(self, device):
            bits = sitorb_bits("MAYDAY MAYDAY")
            x = impair(sitorb_baseband(bits, 1700.0), cfo_hz=25.0)
            assert sitorb_ber(x, 1700.0, bits, device) < 0.01

        @pytest.mark.parametrize("seed", [1, 2])
        def test_near_threshold_snr(self, seed, device):
            bits = sitorb_bits("MAYDAY MAYDAY")
            x = impair(sitorb_baseband(bits, 1700.0), snr_db=-9.0, seed=seed)
            # SITOR-B FEC corrects isolated errors (DX/RX duplication); BER
            # below ~2% keeps the text readable after FEC
            assert sitorb_ber(x, 1700.0, bits, device) < 0.02

        def test_drift_with_noise(self, device):
            bits = sitorb_bits("SECURITE SECURITE")
            x = impair(sitorb_baseband(bits, 1700.0),
                       cfo_hz=-10.0, drift_hz_s=2.0, snr_db=-6.0, seed=3)
            assert sitorb_ber(x, 1700.0, bits, device) < 0.02

        def test_clean_full_decode(self, device):
            """End-to-end sanity: with benign impairments the full CCIR 476
            decoder still locks and yields the text."""
            bits = sitorb_bits("MAYDAY")
            x = impair(sitorb_baseband(bits, 1700.0), cfo_hz=5.0)
            chain = RttyChain(FS, 100.0, 170.0, name="sitorb")
            chain.set_frequency_offset(1700.0)
            rx = (run_chain(chain, x, device).real > 0).astype(np.uint8)
            # align by correlation against the known stream (the chain's
            # filter/timing transient swallows a few leading symbols; in real
            # SITOR-B the phasing sequence provides this alignment)
            tx = np.asarray(bits, np.int8)
            lags = [(float(np.mean(rx[l: l + len(tx)] != tx)), l)
                    for l in range(len(rx) - len(tx))]
            _, lag = min(lags)
            text = SitorBDecoder().feed_bits(rx[lag:])
            assert "MAYDAY" in text

    def test_feedforward_vs_ideal_timing_oracle(self, device):
        """Quantify the feedforward timing loss vs an ideal-timing oracle at a
        noisy operating point: the feedforward estimate must track within
        half a sample at SPS=4."""
        x = impair(psk31_baseband("cq de tpu margin", 2000.0),
                   snr_db=-14.0, seed=11)
        chain = PskChain(FS, 31.25)
        chain.set_frequency_offset(2000.0)
        symbols = run_chain(chain, x, device)
        # decoded text must survive; the per-symbol magnitudes at the chosen
        # instants must retain most of the ideal symbol energy
        text = pskmod.VaricodeDecoder().decode(pskmod.dbpsk_bits(symbols))
        assert "cq de tpu" in text
        mags = np.abs(symbols)
        # eye opening: median sampled magnitude within 20% of the peak
        assert np.median(mags) > 0.6 * np.percentile(mags, 95)


# -------------------------------------------------------- tests/test_digimodes.py
def varicode_encode(text: str) -> list[int]:
    bits = []
    for ch in text:
        bits.extend(int(b) for b in pskmod._VARICODE[ord(ch)])
        bits.extend([0, 0])
    return bits


MORSE_INV = {v: k for k, v in MORSE.items()}


class TestDigimodes:
    class TestPsk31:
        def test_decode_text(self, device):
            baud, f0 = 31.25, 2000.0
            text = "cq cq de tpu"
            bits = [0] * 24 + varicode_encode(text) + [0] * 16  # idle = reversals
            sps = FS / baud
            # DBPSK: bit 1 → keep phase, 0 → flip
            phases = [1.0]
            for b in bits:
                phases.append(phases[-1] * (1.0 if b else -1.0))
            sym = np.repeat(phases, int(sps))
            n = np.arange(len(sym))
            x = (0.5 * sym * np.exp(2j * np.pi * f0 / FS * n)).astype(np.complex64)

            chain = PskChain(FS, baud)
            chain.set_frequency_offset(f0)
            outs = run_chain_blocks(chain, x, device)
            symbols = np.concatenate([np.asarray(o) for o in outs])
            rx_bits = pskmod.dbpsk_bits(symbols)
            decoder = pskmod.VaricodeDecoder()
            decoded = decoder.decode(rx_bits)
            assert text in decoded, f"decoded: {decoded!r}"

    class TestRtty:
        def test_decode_signal(self, device):
            baud, shift, f0 = 45.45, 170.0, 1500.0
            codes = [LTRS] + [ITA2_LETTERS.index(c) for c in "RYRYRY"]
            bits = [1] * 8
            for code in codes:
                bits.append(0)
                bits.extend((code >> i) & 1 for i in range(5))
                bits.extend([1, 1])
            bits += [1] * 8
            sps = FS / baud
            # FSK: mark (1) = +shift/2, space (0) = −shift/2 around f0
            freq = np.repeat([f0 + (shift / 2 if b else -shift / 2) for b in bits],
                             int(round(sps)))
            phase = 2 * np.pi * np.cumsum(freq) / FS
            x = (0.5 * np.exp(1j * phase)).astype(np.complex64)

            chain = RttyChain(FS, baud, shift)
            chain.set_frequency_offset(f0)
            outs = run_chain_blocks(chain, x, device)
            symbols = np.concatenate([np.asarray(o) for o in outs])
            rx_bits = (symbols.real > 0).astype(np.uint8)
            framer = RttyFramer()
            decoded = framer.decode(rx_bits)
            assert "RYRY" in decoded, f"decoded: {decoded!r}"

    class TestCw:
        def test_decode_signal(self, device):
            f0 = 800.0
            wpm = 20.0
            dit = 1.2 / wpm  # seconds
            env = []

            def key(on, units):
                env.extend([1.0 if on else 0.0] * int(units * dit * FS))
            for ch in "TEST":
                for j, sym in enumerate(MORSE_INV[ch]):
                    if j:
                        key(False, 1)
                    key(True, 1 if sym == "." else 3)
                key(False, 3)
            key(False, 8)
            env = np.array(env)
            n = np.arange(len(env))
            x = (0.6 * env * np.exp(2j * np.pi * f0 / FS * n)).astype(np.complex64)

            chain = CwChain(FS)
            chain.set_frequency_offset(f0)
            outs = run_chain_blocks(chain, x, device)
            envelope = np.concatenate([np.asarray(o) for o in outs])
            decoder = CwDecoder(CwChain.ENV_RATE, wpm_hint=wpm)
            decoded = decoder.decode(envelope)
            assert "TEST" in decoded.replace(" ", ""), f"decoded: {decoded!r}"


# ------------------------------------------------------- tests/test_cwskimmer.py
def morse_envelope(text: str, wpm: float, env_rate: float) -> np.ndarray:
    """Keying envelope (0/1) at env_rate for the given text."""
    dit = env_rate * 1.2 / wpm
    rev = {v: k for k, v in MORSE.items()}
    out = [np.zeros(int(4 * dit))]
    for ch in text:
        if ch == " ":
            out.append(np.zeros(int(7 * dit)))
            continue
        for sym in rev[ch]:
            out.append(np.ones(int(dit if sym == "." else 3 * dit)))
            out.append(np.zeros(int(dit)))
        out.append(np.zeros(int(3 * dit)))
    out.append(np.zeros(int(8 * dit)))
    return np.concatenate(out)


def keyed_tone(text: str, freq: float, rate: float, wpm: float = 22.0,
               amp: float = 0.5) -> np.ndarray:
    env = morse_envelope(text, wpm, rate)
    # ~5 ms raised-cosine keying shape (real transmitters avoid clicks)
    k = max(3, int(0.005 * rate))
    env = np.convolve(env, np.hanning(k) / (np.hanning(k).sum() + 1e-12),
                      mode="same")
    t = np.arange(len(env)) / rate
    return (amp * env * np.exp(2j * np.pi * freq * t)).astype(np.complex64)


class TestCwskimmer:
    class TestCwSkimmerDevicePath:
        def test_chain_program_and_handle_decoder(self, device):
            fs = 240000.0
            chain = CwSkimmerChain(fs)
            chain.set_frequency_offset(0.0)
            prog = program(chain, device, fs)
            block = prog.block

            sig = keyed_tone("TEST", 2000.0, fs, wpm=25, amp=0.4)
            pad = (-len(sig)) % block
            sig = np.concatenate([sig, np.zeros(pad, np.complex64)])
            skimmer = CwSkimmer(chain.bin_hz, chain.env_rate)
            texts = []
            for k in range(0, len(sig), block):
                frames, aux = prog.process(sig[k: k + block])
                texts.extend(t for _, t in skimmer.process(np.asarray(frames)))
            assert "TEST" in "".join(texts).replace(" ", ""), texts


# ------------------------------------------------------------- tests/test_fax.py
LPM = 120.0


def synthesize_fax(pattern_rows: np.ndarray, offset_hz: float) -> np.ndarray:
    """Rows of brightness (0..255) → USB IQ at FS with the fax subcarrier."""
    spl_audio = int(FS * 60.0 / LPM)
    lines = []
    for row in pattern_rows:
        # brightness → frequency: black 1500, white 2300
        px = np.repeat(row, spl_audio // len(row) + 1)[:spl_audio]
        freq = CARRIER_HZ + (px / 255.0 * 2 - 1) * DEVIATION_HZ
        lines.append(freq)
    freq = np.concatenate(lines)
    phase = 2 * np.pi * np.cumsum(freq + offset_hz) / FS
    return (0.5 * np.exp(1j * phase)).astype(np.complex64)


class TestFax:
    class TestFax:
        def test_decode_pattern(self, device):
            # phasing lines: white with a black pulse at the start
            spl = int(PIXEL_RATE * 60.0 / LPM)
            width = 200
            phasing = np.full((6, width), 255, np.uint8)
            phasing[:, : max(1, int(0.025 * width))] = 0
            # image: alternating black/white half-lines
            img = np.zeros((10, width), np.uint8)
            img[:, width // 2:] = 255
            pattern = np.concatenate([phasing, img])

            offset = 5000.0
            x = synthesize_fax(pattern, offset)
            chain = FaxChain(FS)
            chain.set_frequency_offset(offset)
            prog = program(chain, device)
            block = prog.block

            rows = []
            decoder = FaxDecoder(LPM, on_row=rows.append)
            n = len(x) // block
            for blk in np.split(x[: n * block], n):
                y, _ = prog.process(blk)
                decoder.feed(np.asarray(y))
            assert len(rows) >= 8, f"only {len(rows)} rows decoded"
            # find a decoded row from the image part: left half black, right white
            img_rows = [r for r in rows
                        if r[: spl // 4].mean() < 80 and r[-spl // 4:].mean() > 180]
            assert img_rows, "no image rows with the expected pattern"


# ------------------------------------------------------------ tests/test_sstv.py
SSTV_RATE = 3000.0  # chain output rate


def synthesize_martin(rows_rgb: np.ndarray, offset_hz: float) -> np.ndarray:
    spec = MODES["martin_m1"]

    def tone(freq_hz, ms):
        return np.full(int(FS * ms / 1000), freq_hz)
    freq = []
    for row in rows_rgb:
        freq.append(tone(1200.0, spec["sync_ms"]))
        for ch in spec["order"]:
            freq.append(tone(1500.0, spec["separator_ms"]))
            comp = row[:, {"G": 1, "B": 2, "R": 0}[ch]]
            px = np.repeat(comp, int(FS * spec["scan_ms"] / 1000) // len(comp) + 1)
            px = px[: int(FS * spec["scan_ms"] / 1000)]
            freq.append(1500.0 + px / 255.0 * 800.0)
    freq = np.concatenate(freq)
    phase = 2 * np.pi * np.cumsum(freq + offset_hz) / FS
    return (0.5 * np.exp(1j * phase)).astype(np.complex64)


class TestSstv:
    class TestSstv:
        def test_martin_m1_rows(self, device):
            width = 320
            # pattern: pure green top rows, then red/blue split rows
            rows = np.zeros((6, width, 3), np.uint8)
            rows[:3, :, 1] = 230                  # green rows
            rows[3:, : width // 2, 0] = 230       # red left
            rows[3:, width // 2:, 2] = 230        # blue right

            offset = -20000.0
            x = synthesize_martin(rows, offset)
            chain = FaxChain(FS, carrier_hz=SSTV_CARRIER, deviation_hz=SSTV_DEV)
            chain.set_frequency_offset(offset)
            prog = program(chain, device)
            block = prog.block
            decoded = []
            decoder = SstvDecoder("martin_m1", SSTV_RATE, on_row=decoded.append)
            n = len(x) // block
            for blk in np.split(x[: n * block], n):
                y, _ = prog.process(blk)
                decoder.feed(np.asarray(y))
            assert len(decoded) >= 4, f"only {len(decoded)} SSTV rows decoded"
            green_rows = [r for r in decoded if r[:, 1].mean() > 150
                          and r[:, 0].mean() < 100]
            split_rows = [r for r in decoded
                          if r[: width // 4, 0].mean() > 120
                          and r[-width // 4:, 2].mean() > 120]
            assert green_rows, "no green rows recovered"
            assert split_rows, "no red/blue split rows recovered"


# ------------------------------------------- tests/test_secondary_maritime_image.py
BAUD = 100.0
SHIFT = 170.0


def fsk_iq(bits, f0: float, baud: float = BAUD, shift: float = SHIFT,
           preamble: int = 60, postamble: int = 120) -> np.ndarray:
    """Mark-idle preamble then the bit stream as FSK around f0; trailing
    idle flushes the block accumulator and the FEC RX copies."""
    bits = [1] * preamble + list(bits) + [1] * postamble
    sps = int(round(FS / baud))
    freq = np.repeat([f0 + (shift / 2 if b else -shift / 2) for b in bits], sps)
    phase = 2 * np.pi * np.cumsum(freq) / FS
    return (0.5 * np.exp(1j * phase)).astype(np.complex64)


def words_to_bits(words):
    """SITOR codewords → bit stream, LSB first per 7-bit word."""
    bits = []
    for w in words:
        bits.extend((w >> i) & 1 for i in range(7))
    return bits


def run_handle(mode: str, x: np.ndarray, device) -> str:
    runtime = types.SimpleNamespace(in_rate=FS, device=device, host=PORT_HOST)
    handle = SecondaryHandle(runtime, mode, offset_hz=0.0)
    collected = []
    handle.text_cb = collected.append
    handle.set_offset(1000.0)
    # feed in device-sized chunks like the engine loop does
    step = 1 << 14
    for i in range(0, len(x), step):
        handle.feed(x[i: i + step])
    return "".join(collected)


class TestSecondaryMaritimeImage:
    class TestSitorB:
        def test_text_over_iq(self, device):
            words = encode_fec("RYRYRY TEST DE TPU")
            x = fsk_iq(words_to_bits(words), 1000.0)
            text = run_handle("sitorb", x, device)
            assert "TEST DE TPU" in text, f"decoded: {text!r}"

    class TestNavtex:
        def test_message_framing(self, device):
            body = "ZCZC FA01 SECURITE TEST NNNN"
            words = encode_fec("RYRY " + body + " RYRY")
            x = fsk_iq(words_to_bits(words), 1000.0)
            out = run_handle("navtex", x, device)
            messages = [json.loads(l) for l in out.splitlines() if l.strip()]
            assert messages, f"no NAVTEX messages in {out!r}"
            msg = messages[0]
            assert msg["mode"] == "NAVTEX"
            assert msg["station"] == "F"
            assert msg["type"] == "A"
            assert "SECURITE TEST" in msg["message"]

    class TestDsc:
        def test_selective_call_over_iq(self, device):
            bits = encode_call(FMT_SELECTIVE, "2113456780", 108, [26, 0],
                               eos=EOS_REQ)
            x = fsk_iq(bits, 1000.0)
            out = run_handle("dsc", x, device)
            messages = [json.loads(l) for l in out.splitlines() if l.strip()]
            assert messages, f"no DSC messages in {out!r}"
            msg = messages[0]
            assert msg["mode"] == "DSC"
            assert msg["format"] == "selective"
            assert msg["address"] == "2113456780"
            assert msg["eos"] == "ack required"

    class TestFaxInteractive:
        def test_rows_stream_as_json(self, device):
            lpm = 120.0
            spl_audio = int(FS * 60.0 / lpm)
            width = 200
            phasing = np.full((6, width), 255, np.uint8)
            phasing[:, : max(1, int(0.025 * width))] = 0
            img = np.zeros((8, width), np.uint8)
            img[:, width // 2:] = 255
            pattern = np.concatenate([phasing, img])

            lines = []
            for row in pattern:
                px = np.repeat(row, spl_audio // len(row) + 1)[:spl_audio]
                lines.append(CARRIER_HZ + (px / 255.0 * 2 - 1) * DEVIATION_HZ)
            freq = np.concatenate(lines)
            phase = 2 * np.pi * np.cumsum(freq + 1000.0) / FS
            x = (0.5 * np.exp(1j * phase)).astype(np.complex64)

            out = run_handle("fax", x, device)
            rows = [json.loads(l) for l in out.splitlines() if l.strip()]
            assert len(rows) >= 8, f"only {len(rows)} fax rows"
            assert rows[0]["mode"] == "Fax"
            assert rows[0]["width"] > 0
            import base64
            px = np.frombuffer(base64.b64decode(rows[-1]["pixels"]), np.uint8)
            assert len(px) == rows[-1]["width"]


# ------------------------------------------------------------- tests/test_rds.py
PI = 0x52A1


def ps_groups(ps="TPU FM  ", pty=10):
    groups = []
    for seg in range(4):
        b = (0 << 12) | (1 << 10) | (pty << 5) | seg
        d = (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])
        groups.append((PI, b, 0x0000, d))
    return groups


class TestRds:
    class TestDeviceTap:
        def test_wfm_chain_emits_rds_aux_and_decodes(self, device):
            fs = 2.4e6
            if_rate = 250000
            # composite synthesized directly at fs: mono tone + RDS subcarrier,
            # FM-modulated at 75 kHz deviation
            rds_wave = rds_modulate(ps_groups() * 4, fs, level=0.25, theta=0.3)
            t = np.arange(len(rds_wave)) / fs
            composite = 0.5 * np.sin(2 * np.pi * 1000 * t) + rds_wave
            phase = 2 * np.pi * np.cumsum(75000 * composite) / fs
            iq = (0.5 * np.exp(1j * phase)).astype(np.complex64)

            chain = ClientDemodulatorChain(fs, mode="wfm", compression="none")
            chain.set_frequency_offset(0.0)
            prog = build_program(chain, fs, target_seconds=0.1, device=device)
            events = []
            dec = RdsDecoder(if_rate / 16, events.append)
            pad = (-len(iq)) % prog.block
            iq = np.concatenate([iq, np.zeros(pad, np.complex64)])
            for k in range(0, len(iq), prog.block):
                _, aux = prog.process(iq[k: k + prog.block])
                rds_key = [key for key in aux if key.endswith(".rds")]
                assert rds_key, list(aux)
                dec.process(np.asarray(aux[rds_key[0]]))
            assert any(e.get("ps") == "TPU FM" for e in events), events[-3:]
