"""Waterfall FFT pipeline: windowed FFT → log power → averaging → fftshift.

Counterpart of ``openwebrx_tpu/ops/fftops.py``.  One call produces every
waterfall row of an input block as a batch: the frames are views of the
extended block (``Tensor.unfold``: the frames of every caller are
uniformly spaced), and frames × fft_size is one batched FFT (cuFFT through
``torch.fft`` on a card).
"""

from __future__ import annotations

import numpy as np
import torch

from openwebrx_tpu_torch import resolve_device


def hann_window(size: int) -> np.ndarray:
    return np.hanning(size).astype(np.float32)


def hamming_window(size: int) -> np.ndarray:
    return np.hamming(size).astype(np.float32)


def fft_init(fft_size: int, every_n: int, batch_shape=(),
             device="cuda") -> torch.Tensor:
    """Carried raw samples preceding the block: a fixed fft_size-sample
    history, zeros at start."""
    return torch.zeros(tuple(batch_shape) + (fft_size,), dtype=torch.complex64,
                       device=resolve_device(device))


def _power(frames: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    spec = torch.fft.fft(frames * window, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def fft_power_at(history: torch.Tensor, window: torch.Tensor, x: torch.Tensor,
                 fft_size: int, ends: np.ndarray):
    """|FFT|² frames ending at the given block offsets (host-static).

    history: (..., fft_size) carried samples preceding the block
    window:  (fft_size,) float32 tensor on x's device
    ends:    (nframes,) int offsets in (0, B], uniformly spaced — frame k
             covers stream samples [ends[k] − fft_size, ends[k]) of the
             block, i.e. xe[ends[k]:ends[k] + fft_size] of the extended block
    returns (new_history, power (..., nframes, fft_size))
    """
    ends = np.asarray(ends, np.int64)
    step = int(ends[1] - ends[0]) if len(ends) > 1 else 1
    if step <= 0 or np.any(ends != ends[0] + step * np.arange(len(ends))):
        raise ValueError("frame ends must be uniformly spaced")
    xe = torch.cat([history, x], dim=-1)
    frames = xe[..., int(ends[0]):].unfold(-1, fft_size, step)[..., :len(ends), :]
    return xe[..., -fft_size:], _power(frames, window)


def fft_power(history: torch.Tensor, window: torch.Tensor, x: torch.Tensor,
              fft_size: int, every_n: int):
    """Frames of |FFT|² over a block: x (..., B) complex64, B % every_n == 0
    → (new_history, power (..., B // every_n, fft_size)), not yet averaged
    or shifted.  With every_n == fft_size the frames tile the block; else
    frame k starts at k·every_n of the extended block (history, x),
    shifted by every_n − fft_size when every_n > fft_size so that it ends
    at (k+1)·every_n — the reference's three cases."""
    nframes = x.shape[-1] // every_n
    xe = torch.cat([history, x], dim=-1)
    if every_n == fft_size:
        start = fft_size
    else:
        start = every_n - fft_size if every_n > fft_size else 0
    frames = xe[..., start:].unfold(-1, fft_size, every_n)[..., :nframes, :]
    return xe[..., -fft_size:], _power(frames, window)


def log_average(p: torch.Tensor, averages: int, add_db: float = -70.0,
                fft_size: int | None = None) -> torch.Tensor:
    """Average groups of ``averages`` frames, normalize by fft_size² and
    convert to dB: p (..., nframes, fft_size) → (..., nframes // averages,
    fft_size) float32."""
    navg = p.shape[-2] // averages
    size = p.shape[-1] if fft_size is None else fft_size
    p = p[..., :navg * averages, :].reshape(
        p.shape[:-2] + (navg, averages, p.shape[-1]))
    pm = p.mean(dim=-2) / (size * size)
    return (10.0 * torch.log10(torch.clamp_min(pm, 1e-30)) + add_db).to(torch.float32)


def fft_swap(rows: torch.Tensor) -> torch.Tensor:
    """fftshift for display."""
    return torch.fft.fftshift(rows, dim=-1)


def waterfall_params(sample_rate: float, fft_size: int, fps: float,
                     overlap_factor: float = 0.3):
    """Choose every_n and averages so the client sees ``fps`` rows/s,
    averaging when frames are abundant."""
    frames_per_s = sample_rate / fft_size
    if frames_per_s > fps:
        averages = max(1, int(round(frames_per_s / fps)))
        every_n = fft_size
    else:
        averages = 1
        every_n = max(1, int(round(sample_rate / fps)))
    return int(every_n), int(averages)
