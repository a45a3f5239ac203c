"""Streaming FIR filtering, integer decimation and rational resampling as
strided convolutions.

Counterpart of ``openwebrx_tpu/ops/fir.py``: ``fir_init``/``fir_apply`` are
a true causal convolution from zero initial state with an explicit overlap
tail carried between blocks; ``polyphase_bank`` (host numpy, copied
verbatim) and ``resample_init``/``resample_apply`` make an L/M resampler one
strided convolution with L output features.  Complex data goes through ``F.conv1d`` as a
(re, im) feature pair with a 2×2 feature kernel, the reference's layout.
The package pins ``cudnn.allow_tf32 = False`` (``openwebrx_tpu_torch``),
without which cuDNN would run this conv in TF32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from openwebrx_tpu_torch import resolve_device


def fir_init(taps_len: int, batch_shape=(), complex_input: bool = True,
             device="cuda") -> torch.Tensor:
    """Carried overlap tail: last (T−1) input samples, zeros at start."""
    dtype = torch.complex64 if complex_input else torch.float32
    return torch.zeros(tuple(batch_shape) + (taps_len - 1,), dtype=dtype,
                       device=resolve_device(device))


def fir_apply(tail: torch.Tensor, taps: torch.Tensor, x: torch.Tensor,
              decimation: int = 1):
    """Streaming FIR (+ optional integer decimation).

    tail: (..., T−1) carried state
    taps: (T,) float32 or complex64 tensor on x's device (NOT flipped)
    x:    (..., B) with B % decimation == 0
    returns (new_tail, y) with y (..., B // decimation)
    """
    t = taps.shape[-1]
    xe = torch.cat([tail, x], dim=-1)
    new_tail = xe[..., -(t - 1):] if t > 1 else tail
    lead = xe.shape[:-1]
    xb = xe.reshape(-1, xe.shape[-1])
    h = torch.flip(taps, dims=(-1,))
    hr = h.real if h.is_complex() else h
    if xe.is_complex():
        hi = h.imag if h.is_complex() else torch.zeros_like(h)
        lhs = torch.stack([xb.real, xb.imag], dim=1)          # (N, 2, W)
        # (yr, yi) = (xr*hr − xi*hi, xr*hi + xi*hr)
        rhs = torch.stack([torch.stack([hr, -hi]),
                           torch.stack([hi, hr])])            # (2, 2, T)
        out = F.conv1d(lhs, rhs, stride=decimation)
        y = torch.complex(out[:, 0], out[:, 1])
    else:
        y = F.conv1d(xb[:, None, :], hr[None, None, :], stride=decimation)[:, 0]
    return new_tail, y.reshape(lead + y.shape[-1:])


def polyphase_bank(taps: np.ndarray, interpolation: int, decimation: int):
    """Precompute the phase-filter bank for rational resampling (host-side).

    Rational L/M resampling (y = downsample_M(h * upsample_L(x))) is
    restructured so that all L output phases read the input at the same
    stride-M positions: output group j produces y[j·L + r] for r in 0..L−1,
    with y[jL + r] = Σ_c H[r, c] x[jM + lo + c].  That makes the whole
    resampler ONE strided conv with L output features — no gathers.

    Derivation: y[m] = Σ_k h[k] u[mM − k] with u[iL] = x[i]; for m = jL + r
    the nonzero terms have k ≡ rM (mod L) at input index i = jM + (rM − k)/L.

    Returns (bank (L, P) float32, tail_len, delay_groups) where ``tail_len``
    is the carried-state length required for streamed outputs to sit exactly
    on the true output grid (chosen in [P−M, P−1] with (tail_len + lo) ≡ 0
    mod M), and ``delay_groups``·L is the whole-sample output delay of the
    stream relative to upfirdn of the same input.
    """
    taps = np.asarray(taps, np.float64)
    tlen = len(taps)
    lgd = interpolation
    rows = []
    for r in range(lgd):
        ks = np.arange(tlen)
        pos = r * decimation - ks  # upsampled-domain positions rM − k
        valid = (pos % interpolation == 0)
        in_idx = pos[valid] // interpolation  # input indices (mostly ≤ 0)
        rows.append((in_idx, taps[ks[valid]]))
    lo = min((idx.min() for idx, _ in rows if len(idx)), default=0)
    hi = max((idx.max() for idx, _ in rows if len(idx)), default=0)
    p = int(hi - lo + 1)
    bank = np.zeros((lgd, p), np.float64)
    for r, (in_idx, coefs) in enumerate(rows):
        bank[r, in_idx - lo] = coefs
    # ensure the window spans at least M inputs (left-pad with zero columns —
    # they map to older input indices with zero weight, harmless history)
    if p < decimation:
        pad = decimation - p
        bank = np.concatenate([np.zeros((lgd, pad)), bank], axis=1)
        lo -= pad
        p += pad
    # tail length: the unique t in [P−M, P−1] with (t + lo) ≡ 0 (mod M) —
    # exactly B/M conv output groups per block AND outputs on the true grid.
    t = p - decimation
    while (t + lo) % decimation != 0:
        t += 1
    delay_groups = (t + lo) // decimation
    return bank.astype(np.float32), int(t), int(delay_groups)


def resample_init(tail_len: int, batch_shape=(), complex_input: bool = False,
                  device="cuda") -> torch.Tensor:
    dtype = torch.complex64 if complex_input else torch.float32
    return torch.zeros(tuple(batch_shape) + (tail_len,), dtype=dtype,
                       device=resolve_device(device))


def resample_apply(tail: torch.Tensor, bank: torch.Tensor, x: torch.Tensor,
                   interpolation: int, decimation: int):
    """Streaming rational resampler using a precomputed polyphase bank.

    tail: (..., tail_len) carried input samples (from polyphase_bank)
    bank: (L, P) float32 tensor on x's device, from polyphase_bank()
    x:    (..., B) with B % decimation == 0
    returns (new_tail, y) with y (..., B·L/M)
    """
    lgd = bank.shape[0]
    tail_len = tail.shape[-1]
    xe = torch.cat([tail, x], dim=-1)
    new_tail = xe[..., xe.shape[-1] - tail_len:] if tail_len > 0 else tail
    lead = xe.shape[:-1]
    xb = xe.reshape(-1, xe.shape[-1])
    if xe.is_complex():
        lhs = torch.stack([xb.real, xb.imag], dim=1)          # (N, 2, W)
        zero = torch.zeros_like(bank)
        rhs = torch.cat([torch.stack([bank, zero], dim=1),     # re rows
                         torch.stack([zero, bank], dim=1)])    # im rows: (2L, 2, P)
        out = F.conv1d(lhs, rhs, stride=decimation)
        y = torch.complex(out[:, :lgd], out[:, lgd:])
    else:
        y = F.conv1d(xb[:, None, :], bank[:, None, :], stride=decimation)
    # y: (N, L, B/M) — interleave phases: y[jL + r] = out[r, j]
    y = y.transpose(-1, -2).reshape(y.shape[0], -1)
    return new_tail, y.reshape(lead + y.shape[-1:])
