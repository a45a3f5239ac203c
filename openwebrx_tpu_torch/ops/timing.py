"""Symbol timing recovery, feedforward (no feedback loop).

Counterpart of ``openwebrx_tpu/ops/timing.py``: the transition energy
m[n] = |x[n] − x[n−1]|² has a spectral line at the symbol rate whose phase
locates the transitions, so one complex correlation per block gives each
channel's timing offset (Oerder–Meyr).  Symbol centers are offset + k·sps
with offset ∈ [0, sps) estimated per block and kept continuous across
blocks through the carried previous offset (−1e9: none yet), so every
block yields exactly B/sps symbols.
"""

from __future__ import annotations

import numpy as np
import torch

from openwebrx_tpu_torch import resolve_device

SPS = 4  # digimode default samples per symbol after the chains' resampling


def timing_init(batch_shape=(), sps: int = SPS, device="cuda"):
    dev = resolve_device(device)
    batch_shape = tuple(batch_shape)
    return (torch.full(batch_shape, -1e9, dtype=torch.float32, device=dev),
            torch.zeros(batch_shape + (2 * sps,), dtype=torch.complex64,
                        device=dev))


def recover(state, x: torch.Tensor, sps: int = SPS):
    """x (..., B) complex64 at ``sps`` samples/symbol, B % sps == 0 →
    (state, symbols (..., B/sps) complex64): the linearly interpolated
    samples at the estimated symbol centers."""
    prev_off, tail = state
    tail_len = 2 * sps
    n_sym = x.shape[-1] // sps
    xe = torch.cat([tail, x], dim=-1)                 # (..., TAIL+B)
    new_tail = xe[..., -tail_len:]

    # transition energy and its symbol-rate phase
    d = xe[..., 1:] - xe[..., :-1]
    m = d.real ** 2 + d.imag ** 2
    n = (torch.arange(m.shape[-1], dtype=torch.float32, device=x.device)
         - (tail_len - 1))
    rot = torch.exp(-2j * np.pi * n / sps).to(torch.complex64)
    c = torch.sum(m.to(torch.complex64) * rot, dim=-1)
    # impulses at n ≡ t₀ contribute exp(−2πi·t₀/sps): the transition is
    # the negated phase, and symbol centers sit half a symbol after it
    trans = -torch.angle(c) / (2 * np.pi) * sps
    offset = torch.remainder(trans + sps / 2.0, sps)

    # continuity: snap to the representation nearest the previous offset,
    # then smooth (round is half-to-even, as jnp.round)
    have_prev = prev_off > -1e8
    k = torch.round((prev_off - offset) / sps)
    snapped = offset + k * sps
    smoothed = 0.75 * prev_off + 0.25 * snapped
    offset = torch.where(have_prev, torch.clamp(smoothed, -sps / 2, 1.5 * sps),
                         offset)

    # sample at the centers: xe index TAIL + offset + j·sps
    pos = (float(tail_len) + offset[..., None]
           + torch.arange(n_sym, dtype=torch.float32, device=x.device) * sps)
    total = xe.shape[-1]
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, total - 2)
    frac = (pos - i0.to(torch.float32)).to(torch.complex64)
    a = torch.gather(xe, -1, i0)
    bnext = torch.gather(xe, -1, i0 + 1)
    symbols = a + (bnext - a) * frac
    return (offset.to(torch.float32), new_tail), symbols
