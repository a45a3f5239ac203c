"""The receiver's input: seeded noise plus a station of its mode on every
dial, as uint8 (cu8) wire pairs, looped.

Stations sit on exact FFT bins of the loop, so the looped stream has no
seam: a USB station is a tone ``tone_hz`` above its dial, an AM station a
carrier with two tone sidebands, an NFM station a carrier frequency
modulated by the tone (its Bessel lines).  A strong unmodulated carrier
sits at 0 Hz, where a filterbank parks its free slots.  Everything is
drawn from the seed with a ``torch.Generator`` on the given device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import jv


def synthesize(fs: float, loop_len: int, stations: list[dict], noise_lsb: float,
               dc_lsb: float, seed: int, device) -> np.ndarray:
    """Stations [{"hz", "mode", "lsb", "tone_hz", ...}] → (loop_len, 2)
    uint8 wire, u = clip(round(128·x + 127.4)) per component."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    spec = torch.zeros(loop_len, dtype=torch.complex128, device=dev)
    bins, amps = [], []

    def line(hz: float, amp: float):
        k = hz * loop_len / fs
        if abs(k - round(k)) > 1e-6:
            raise ValueError(f"{hz} Hz is not on the loop's bin grid")
        bins.append(int(round(k)) % loop_len)
        amps.append(amp)

    line(0.0, dc_lsb / 128.0)
    for st in stations:
        a = st["lsb"] / 128.0
        f, tone = st["hz"], st["tone_hz"]
        if st["mode"] in ("usb", "cw"):
            line(f + tone, a)
        elif st["mode"] == "lsb":
            line(f - tone, a)
        elif st["mode"] == "am":
            line(f, a)
            line(f + tone, a * st["depth"] / 2)
            line(f - tone, a * st["depth"] / 2)
        elif st["mode"] == "nfm":
            beta = st["deviation_hz"] / tone
            for n in range(-int(beta) - 8, int(beta) + 9):
                line(f + n * tone, a * float(jv(n, beta)))
        else:
            raise KeyError(st["mode"])
    phase = torch.rand(len(bins), generator=gen, device=dev, dtype=torch.float64) * 2 * math.pi
    idx = torch.as_tensor(bins, device=dev)
    spec.index_add_(0, idx, torch.polar(torch.as_tensor(amps, device=dev, dtype=torch.float64),
                                        phase) * loop_len)
    x = torch.fft.ifft(spec)
    noise = torch.randn((loop_len, 2), generator=gen, device=dev, dtype=torch.float64)
    iq = torch.stack([x.real, x.imag], -1) + noise * (noise_lsb / 128.0)
    u = torch.clamp(torch.round(iq * 128.0 + 127.4), 0, 255).to(torch.uint8)
    return u.cpu().numpy()
