"""Polyphase filterbank channelizer: M channels from one wideband stream.

Counterpart of ``openwebrx_tpu/ops/channelizer.py``, with the same
phase-reversal layout: u'[t, q] = x[tM + 1 + q] is one contiguous slice and
reshape, the phase-reversed, time-reversed bank turns the branch filters
into the polyphase fold (``ops/fold.py``: the CUDA kernel on the card), then
an M-point FFT over the last axis (cuFFT through ``torch.fft``), a constant
per-channel twiddle e^{−j2πk/M} and one transpose.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openwebrx_tpu_torch import check_on, resolve_device
from openwebrx_tpu_torch.ops.fold import polyphase_fold


def design_prototype(m: int, taps_per_phase: int = 16,
                     cutoff_scale: float = 1.0) -> np.ndarray:
    """Prototype lowpass for an M-channel critically-sampled PFB: cutoff
    0.5/M, Hamming window, total length m·taps_per_phase (numpy, host)."""
    n = m * taps_per_phase
    cutoff = 0.5 / m * cutoff_scale
    h = np.sinc(2 * cutoff * (np.arange(n) - (n - 1) / 2)) * 2 * cutoff
    h *= np.hamming(n)
    h /= h.sum()
    return h.astype(np.float32)


def channelizer_init(m: int, taps_per_phase: int, batch_shape=(),
                     device="cuda") -> torch.Tensor:
    """Carried tail: P·M input samples."""
    return torch.zeros(tuple(batch_shape) + (taps_per_phase * m,),
                       dtype=torch.complex64, device=resolve_device(device))


@functools.lru_cache(maxsize=None)
def _twiddle(m: int, device: torch.device) -> torch.Tensor:
    tw = np.exp(-2j * np.pi * np.arange(m) / m).astype(np.complex64)
    return torch.as_tensor(tw, device=device)


def channelize(tail: torch.Tensor, prototype, x: torch.Tensor, m: int,
               device="cuda"):
    """tail (P·M,) · prototype (M·P,) (numpy or a float32 tensor on
    ``device``) · x (B,) with B % M == 0 → (new_tail, Y (M, B/M)
    complex64), channel k centered at k·fs/M (k ≥ M/2 wraps to negative
    frequencies)."""
    dev = resolve_device(device)
    check_on(dev, tail, x)
    h = torch.as_tensor(prototype, dtype=torch.float32, device=dev)
    p = h.shape[0] // m
    xe = torch.cat([tail, x], dim=-1)
    new_tail = xe[-(p * m):].clone()     # not a view pinning all of xe
    nf = xe.shape[-1] // m
    up = xe[1:1 + (nf - 1) * m].reshape(nf - 1, m)   # u'[t, q] = x[tM+1+q]
    bank2 = torch.flip(h.reshape(p, m), dims=(0, 1)).contiguous()
    v = polyphase_fold(up, bank2, p, device=dev)      # (B/M, M)
    yk = torch.fft.fft(v, dim=-1)
    return new_tail, (yk * _twiddle(m, dev)).T.contiguous()


def channel_frequencies(m: int, fs: float) -> np.ndarray:
    """Center frequency of each channel index (wrapped to ±fs/2)."""
    k = np.arange(m)
    f = k * fs / m
    f[f >= fs / 2] -= fs
    return f
