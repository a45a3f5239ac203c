"""Golden parity through the port: every case of tests/test_parity_golden.py
run through ``openwebrx_tpu_torch`` at that file's bounds, against the port's
own copy of the independent numpy/scipy oracle (``openwebrx_tpu_torch.testing``,
the reference's text renamed).

The capture is ``make_capture(duration_s=0.4)``: 2.4 MS/s, seed 0x5D12.  A
chain streams through ``build_program(chain, FS, target_seconds=0.1,
device=...)`` block by block, and ``settled`` skips its first 0.06 s.
Bounds (error power below the oracle's output power, or levels):

    selector IQ, also against the remez oracle       ≥ 45 dB
    NFM / AM / USB audio (pre-AGC)                   ≥ 35 dB
    WFM audio (fractional path)                      ≥ 25 dB
    full NFM chain, gain-matched per 25 ms           ≥ 25 dB
    squelch at −40 dB: closed max |y| < 1e-3 (450 kHz), open std > 1e-2
    impairments (dc, iqimb, clip, blocker)           ≥ 60 dB, and where
        audible the degradation within 2 dB of the oracle's
    full chain with AGC, one scalar gain             ≥ 12 dB
    the port's firdes lowpass and bandpass meet the csdr spec, and the
        oracle's two designs agree

Every case that runs a chain runs on ``cpu`` (the kernels' plain versions)
and on ``cuda`` (marker ``cuda``: the squelch, IIR and AGC kernels; skips
without a card).  The oracle's outputs are computed once per capture
(``Oracle``) and shared by both devices.  This file imports no jax and
nothing of ``openwebrx_tpu``: the card's machine collects it, and
chip_smoke.py phase 9 runs ``SCENES`` on the card from here.
"""

from typing import Callable, NamedTuple

import numpy as np
import pytest
import torch

from openwebrx_tpu_torch.models.analog import NFM_TAU, WFm
from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain, build_program
from openwebrx_tpu_torch.models.selector import Selector
from openwebrx_tpu_torch.models.stages import (
    AmDemodStage, DcBlockStage, DeemphasisStage, FmDemodStage, GainStage,
    LimitStage, RealPartStage)
from openwebrx_tpu_torch.ops import firdes
from openwebrx_tpu_torch.runtime.chain import Chain
from openwebrx_tpu_torch.testing import capture as cap
from openwebrx_tpu_torch.testing import oracle

FS = cap.FS
IMPAIRMENTS = ("dc", "iqimb", "clip", "blocker")


def run_chain(chain, x, device, in_rate=FS, target_seconds=0.1):
    """Stream x through a Program on ``device`` block by block → numpy audio."""
    prog = build_program(chain, in_rate, target_seconds=target_seconds, device=device)
    n = (len(x) // prog.block) * prog.block
    outs = [prog.process(x[i:i + prog.block])[0] for i in range(0, n, prog.block)]
    return np.concatenate([np.asarray(o).reshape(-1) for o in outs])


def settled(y, rate, skip_s=0.06):
    return y[int(skip_s * rate):]


def _sel(offset, out_rate, low, high):
    sel = Selector(FS, out_rate, with_squelch=False)
    sel.set_frequency_offset(offset)
    sel.set_bandpass(low, high)
    return sel


def _nfm_pre_agc(name):
    return Chain([_sel(cap.NFM_OFFSET, 48000.0, -4000.0, 4000.0),
                  FmDemodStage(), LimitStage(),
                  DeemphasisStage(NFM_TAU, name="deemph")], name=name)


def _client_nfm(offset, squelch_db):
    chain = ClientDemodulatorChain(FS, mode="nfm", compression="none")
    chain.set_frequency_offset(offset)
    chain.set_squelch_level(squelch_db)
    return chain


def _impair(name, x, n0):
    if name == "dc":            # receiver DC offset
        return (x + 0.05).astype(np.complex64)
    if name == "iqimb":         # 1 dB gain + 5 deg phase imbalance
        a = 10 ** (0.5 / 20)
        ph = np.deg2rad(5.0)
        i, q = x.real * a, x.imag / a
        return (i + 1j * (q * np.cos(ph) + i * np.sin(ph))) \
            .astype(np.complex64)
    if name == "clip":          # front-end clipping at half scale
        return (np.clip(x.real, -0.5, 0.5)
                + 1j * np.clip(x.imag, -0.5, 0.5)).astype(np.complex64)
    if name == "blocker":       # +30 dB carrier 25 kHz above the dial
        return (x + 2.0 * np.exp(
            2j * np.pi * (cap.NFM_OFFSET + 25e3) * n0 / FS)) \
            .astype(np.complex64)
    raise KeyError(name)


class Oracle:
    """The capture and the oracle's outputs on it, each computed once (by
    key) and shared by every device and scene that needs it."""

    def __init__(self, iq):
        self.iq = iq
        self._memo = {}

    def __call__(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def input(self, impairment=None):
        """The capture, or the capture with a front-end impairment."""
        if impairment is None:
            return self.iq
        return self(f"input {impairment}", lambda: _impair(
            impairment, self.iq.copy(), np.arange(len(self.iq))))

    def nfm(self, impairment=None):
        """oracle.nfm_chain (pre-AGC audio at 48 kHz) on ``input``."""
        return self(f"nfm {impairment}", lambda: oracle.nfm_chain(
            np.asarray(self.input(impairment), np.complex128), FS, 48000.0,
            cap.NFM_OFFSET, tau=NFM_TAU))

    def nfm12(self):
        """The NFM audio decimated to the client's 12 kHz."""
        return self("nfm12", lambda: oracle.fir_decimate(
            self.nfm(), 4, oracle.lowpass_taps(0.125, 0.15 / 4)))


class Measure(NamedTuple):
    """One number a scene is held to: passed when ``value op bound``."""
    what: str
    value: float
    op: str
    bound: float

    @property
    def passed(self) -> bool:
        return {">=": self.value >= self.bound, ">": self.value > self.bound,
                "<": self.value < self.bound}[self.op]


def _snr(what, ref, ours, rate, bound):
    n = min(len(ours), len(ref))
    return Measure(what, oracle.snr_db(settled(ref[:n], rate), settled(ours[:n], rate)),
                   ">=", bound)


def selector_iq(o, device):
    """Shift → decimate → bandpass IQ at the NFM IF (2.4 MS/s → 48 kHz)."""
    ours = run_chain(_sel(cap.NFM_OFFSET, 48000.0, -4000.0, 4000.0), o.iq, device)
    ref = o("selector", lambda: oracle.selector(
        np.asarray(o.iq, np.complex128), FS, 48000.0, cap.NFM_OFFSET, -4000.0, 4000.0))
    return [_snr("selector IQ parity dB", ref, ours, 48000, 45.0)]


def nfm_pre_agc(o, device):
    ours = run_chain(_nfm_pre_agc("nfm_parity"), o.iq, device)
    return [_snr("NFM audio parity dB", o.nfm(), ours, 48000, 35.0)]


def am_pre_agc(o, device):
    chain = Chain([_sel(cap.AM_OFFSET, 12000.0, -4000.0, 4000.0),
                   AmDemodStage(), DcBlockStage()], name="am_parity")
    ours = run_chain(chain, o.iq, device)
    ref = o("am", lambda: oracle.am_chain(
        np.asarray(o.iq, np.complex128), FS, 12000.0, cap.AM_OFFSET))
    return [_snr("AM audio parity dB", ref, ours, 12000, 35.0)]


def usb_pre_agc(o, device):
    chain = Chain([_sel(cap.USB_OFFSET, 12000.0, 300.0, 3000.0),
                   RealPartStage(), GainStage(2.0)], name="usb_parity")
    ours = run_chain(chain, o.iq, device)
    ref = o("usb", lambda: oracle.ssb_chain(
        np.asarray(o.iq, np.complex128), FS, 12000.0, cap.USB_OFFSET, 300.0, 3000.0))
    return [_snr("USB audio parity dB", ref, ours, 12000, 35.0)]


def wfm_audio(o, device):
    """The fractional decimator path (2.4 MS/s → 250 kHz → 48 kHz audio);
    the oracle resamples with scipy's kaiser polyphase, so the alignment is
    searched."""
    sel = Selector(FS, 250000.0, with_squelch=False)
    sel.set_frequency_offset(cap.NFM_OFFSET)
    sel.set_bandpass(-75000.0, 75000.0)
    ours = run_chain(Chain([sel, WFm(audio_rate=48000, rds=False)], name="wfm_parity"),
                     o.iq, device)
    ref = o("wfm", lambda: oracle.wfm_chain(
        np.asarray(o.iq, np.complex128), FS, cap.NFM_OFFSET))
    _, r, t = oracle.align(settled(ref, 48000), settled(ours, 48000), max_lag=512)
    return [Measure("WFM audio parity dB", oracle.snr_db(r, t), ">=", 25.0)]


def full_chain_gain_matched(o, device):
    """ClientDemodulatorChain with AGC, NR and 12 kHz client audio, gain
    matched per 25 ms window (the NR's latency absorbed by align())."""
    ours = run_chain(_client_nfm(cap.NFM_OFFSET, -150.0), o.iq, device)
    ours = ours.astype(np.float64) / 32768.0
    _, r, t = oracle.align(settled(o.nfm12(), 12000), settled(ours, 12000), max_lag=256)
    return [Measure("full-chain gain-matched parity dB",
                    oracle.gain_matched_snr_db(r, t, 12000), ">=", 25.0)]


def squelch_gates(o, device):
    """Squelch at −40 dB: closed on an empty channel, open on the NFM carrier."""
    quiet = run_chain(_client_nfm(450_000.0, -40.0), o.iq, device)
    loud = run_chain(_client_nfm(cap.NFM_OFFSET, -40.0), o.iq, device)
    quiet = settled(quiet.astype(np.float64) / 32768.0, 12000)
    loud = settled(loud.astype(np.float64) / 32768.0, 12000)
    return [Measure("squelch closed max |y|", float(np.max(np.abs(quiet))), "<", 1e-3),
            Measure("squelch open std", float(np.std(loud)), ">", 1e-2)]


def selector_vs_remez(o, device):
    """The second oracle design path (Parks-McClellan equiripple), which
    shares only the spec with the windowed-sinc designs."""
    ours = run_chain(_sel(cap.NFM_OFFSET, 48000.0, -4000.0, 4000.0), o.iq, device)
    ref = o("selector remez", lambda: oracle.selector(
        np.asarray(o.iq, np.complex128), FS, 48000.0, cap.NFM_OFFSET, -4000.0, 4000.0,
        design="remez"))
    return [_snr("remez-oracle selector parity dB", ref, ours, 48000, 45.0)]


def impairment(name):
    def scene(o, device):
        """A front-end impairment: parity holds, and where the damage is
        audible (below ~60 dB, each side's float precision floor) it
        degrades the port as much as the oracle, within 2 dB."""
        ours = run_chain(_nfm_pre_agc(f"nfm_{name}"), o.input(name), device)
        ref, clean = o.nfm(name), o.nfm()
        n = min(len(ours), len(ref), len(clean))
        out = [_snr(f"{name} parity dB", ref[:n], ours[:n], 48000, 60.0)]
        deg_ref = oracle.snr_db(settled(clean[:n], 48000), settled(ref[:n], 48000))
        deg_ours = oracle.snr_db(settled(clean[:n], 48000), settled(ours[:n], 48000))
        if min(deg_ref, deg_ours) < 60.0:
            out.append(Measure(f"{name} degradation |port − oracle| dB",
                               abs(deg_ref - deg_ours), "<", 2.0))
        return out
    return scene


def full_chain_agc(o, device):
    """The full chain with AGC against the oracle's independent per-sample
    AGC, one scalar gain and no per-window fitting."""
    ours = run_chain(_client_nfm(cap.NFM_OFFSET, -150.0), o.iq, device)
    ours = ours.astype(np.float64) / 32768.0
    ref = o("agc", lambda: oracle.agc(o.nfm12()))
    _, r, t = oracle.align(settled(ref, 12000), settled(ours, 12000), max_lag=256)
    g = float(np.dot(r, t) / max(np.dot(t, t), 1e-12))
    return [Measure("AGC-inclusive parity dB", oracle.snr_db(r, t * g), ">=", 12.0)]


class Scene(NamedTuple):
    run: Callable          # (Oracle, device) → [Measure]
    kernels: frozenset     # the csrc sources a run on the card launches


_IIR = frozenset({"iir.cu"})
_CLIENT = frozenset({"squelch.cu", "iir.cu", "agc.cu"})
SCENES = {
    "selector_iq": Scene(selector_iq, frozenset()),
    "nfm_pre_agc": Scene(nfm_pre_agc, _IIR),
    "am_pre_agc": Scene(am_pre_agc, _IIR),
    "usb_pre_agc": Scene(usb_pre_agc, frozenset()),
    "wfm_audio": Scene(wfm_audio, _IIR),
    "full_chain_gain_matched": Scene(full_chain_gain_matched, _CLIENT),
    "squelch_gates": Scene(squelch_gates, _CLIENT),
    "selector_vs_remez": Scene(selector_vs_remez, frozenset()),
    **{f"impairment_{name}": Scene(impairment(name), _IIR) for name in IMPAIRMENTS},
    "full_chain_agc": Scene(full_chain_agc, _CLIENT),
}


def golden_oracle() -> Oracle:
    return Oracle(cap.make_capture(duration_s=0.4))


@pytest.fixture(scope="module")
def golden():
    return golden_oracle()


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return request.param


def held(scene, golden, device):
    for m in SCENES[scene].run(golden, device):
        assert m.passed, f"{scene} on {device}: {m.what} {m.value:.3f} not {m.op} {m.bound}"


class TestOracleParity:
    def test_selector_iq(self, golden, device):
        held("selector_iq", golden, device)

    def test_nfm_pre_agc(self, golden, device):
        held("nfm_pre_agc", golden, device)

    def test_am_pre_agc(self, golden, device):
        held("am_pre_agc", golden, device)

    def test_usb_pre_agc(self, golden, device):
        held("usb_pre_agc", golden, device)

    def test_wfm_audio(self, golden, device):
        held("wfm_audio", golden, device)

    def test_full_chain_gain_matched(self, golden, device):
        held("full_chain_gain_matched", golden, device)

    def test_squelch_gates_quiet_channel(self, golden, device):
        held("squelch_gates", golden, device)

    def test_selector_vs_remez_oracle(self, golden, device):
        held("selector_vs_remez", golden, device)

    @pytest.mark.parametrize("name", IMPAIRMENTS)
    def test_impairment_parity(self, golden, device, name):
        held(f"impairment_{name}", golden, device)

    def test_full_chain_agc_no_gain_matching(self, golden, device):
        held("full_chain_agc", golden, device)


class TestDesign:
    def test_lowpass_design_meets_csdr_spec(self):
        """The port's firdes lowpass: −6 dB at cutoff, ≤ −40 dB beyond
        cutoff + transition, passband ripple < 0.2 dB."""
        cutoff, transition = 0.1, 0.0125
        taps = firdes.lowpass_taps(cutoff, transition)
        w = np.fft.rfftfreq(65536)
        h_db = 20 * np.log10(np.maximum(np.abs(np.fft.rfft(taps, 65536)), 1e-12))
        at_cut = h_db[np.argmin(np.abs(w - cutoff))]
        assert -8.0 < at_cut < -4.0, f"cutoff point {at_cut:.1f} dB not ≈ −6 dB"
        stop = h_db[w >= cutoff + transition]
        assert stop.max() < -40.0, f"stopband only {stop.max():.1f} dB"
        assert np.all(np.abs(h_db[w <= cutoff - transition]) < 0.2), \
            "passband ripple > 0.2 dB"

    def test_bandpass_design_meets_csdr_spec(self):
        """The asymmetric complex bandpass: flat passband, −40 dB stopband at
        the reference's transition 320/outRate."""
        out_rate = 12000.0
        transition = 320.0 / out_rate
        low, high = 300.0 / out_rate, 3000.0 / out_rate
        taps = firdes.bandpass_taps(low, high, transition)
        n = 65536
        h_db = 20 * np.log10(np.maximum(np.abs(np.fft.fft(taps, n)), 1e-12))
        w = np.fft.fftfreq(n)
        inband = (w > low + transition) & (w < high - transition)
        assert np.all(np.abs(h_db[inband]) < 0.5), "passband ripple > 0.5 dB"
        stop = (w < low - transition) | (w > high + transition)
        assert h_db[stop].max() < -40.0, f"stopband only {h_db[stop].max():.1f} dB"

    def test_oracle_designs_agree(self):
        """The oracle's windowed-sinc and equiripple designs agree in band
        and both reach −40 dB in the stopband."""
        cutoff, transition = 0.1, 0.0125
        for taps in (oracle.lowpass_taps(cutoff, transition),
                     oracle.lowpass_taps_remez(cutoff, transition)):
            w = np.fft.rfftfreq(65536)
            h_db = 20 * np.log10(np.maximum(np.abs(np.fft.rfft(taps, 65536)), 1e-12))
            assert np.all(np.abs(h_db[w <= cutoff - transition]) < 0.5)
            assert h_db[w >= cutoff + transition].max() < -40.0
