"""The plain reference against the port's ChannelizedBank on the CPU, in
each mode the cells run, raw int16 out: after the first two blocks (a
discriminator at stream start reads rounding noise, which the AGC carries
into the next block) every sample agrees to within the one step that
truncation gives, across a retune."""

import numpy as np
import pytest
import torch

from pbench.plan import PASSBAND, channel_of
from pbench.ref.dsp import BackRef, ChannelPlan, FrontRef, PfbRef, Precision, wire_to_complex

FS, BLOCK, NB = 1.024e6, 204800, 5


def _run(mode, low=False):
    from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank
    m = 16 if mode == "nfm" else 32
    rng = np.random.default_rng(5)
    t = np.arange(NB * BLOCK)
    dials = [64005.0 + 1000, 128000.0 - 3835]
    sig = sum(6 * np.exp(2j * np.pi * (d + 700) * t / FS) for d in dials)
    wire = rng.integers(100, 155, (NB * BLOCK, 2)).astype(float)
    wire = np.clip(np.round(wire + np.stack([sig.real, sig.imag], 1)), 0, 255).astype(np.uint8)
    bank = ChannelizedBank(FS, m, mode=mode, compression="none", block=BLOCK,
                           capacity=4, device="cpu")
    lo, hi = PASSBAND[mode]
    for d in dials:
        bank.set_bandpass(bank.assign(d), lo, hi)
    plan = ChannelPlan(mode, FS / m, BLOCK // m)
    p = Precision(low)
    pfb, front, back = PfbRef(m, 16, "cpu", p), FrontRef(plan, 2, "cpu", p), BackRef(plan, 2, "cpu", p)
    err = []
    for b in range(NB):
        now = [dials[0], dials[1] if b < 2 else dials[0] + 2995]
        if b == 2:
            bank.retune(1, now[1])
        y, _ = bank.process(wire[b * BLOCK:(b + 1) * BLOCK])
        kf = [channel_of(d, m, FS) for d in now]
        ch = pfb.block(p.r(wire_to_complex(wire[b * BLOCK:(b + 1) * BLOCK], "cpu")))
        x = ch[torch.as_tensor([k for k, _ in kf])]
        out = back(front(x, np.array([[f] for _, f in kf]), np.full((2, 1), lo),
                         np.full((2, 1), hi), np.full((2, 1), -150.0))).numpy()
        err.append(np.abs(np.trunc(out) - y[:2]).max())
    return err


@pytest.mark.parametrize("mode", ["usb", "am", "nfm"])
def test_reference_follows_the_bank(mode):
    err = _run(mode)
    assert max(err[2:]) <= 1.0, err


def test_the_bfloat16_control_does_not():
    assert max(_run("usb", low=True)[2:]) > 100


def test_an_agc_tie_forks_and_the_program_output_decides():
    # a tone whose chunk peak puts the target gain exactly on the gain:
    # the attack decision is a tie, so the row forks into two candidates
    plan = ChannelPlan("usb", 32000.0, 6400)
    back = BackRef(plan, 1, "cpu", Precision())
    n = np.arange(plan.if_block)
    x = torch.as_tensor(0.8 * np.cos(2 * np.pi * n / 10.0))[None]
    y = back(x)
    assert back.forks >= 1 and y.shape[0] == len(back.origin) >= 2
    assert (back.origin == 0).all()
    back.keep([0])
    assert len(back.origin) == 1 and back.nr_in.shape[0] == 1
