"""Spectral noise reduction (audio NR).

Counterpart of ``openwebrx_tpu/ops/noisefilter.py``: STFT with 50 %-overlap
Hann frames, a broadband noise floor from the 25th percentile of each
frame's magnitude spectrum (EMA-smoothed across blocks), soft spectral
subtraction and exact overlap-add.

``torch.quantile`` with linear interpolation equals ``jnp.percentile``'s
default method; it refuses inputs above 2²⁴ elements.  The 1024-channel
bank feeds it 1024 × 2 frames × 513 bins ≈ 1.05 M elements; a larger
spectrum goes through it in chunks of whole channels, which gives the
same numbers (each frame's percentile is its own).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openwebrx_tpu_torch import resolve_device

DEFAULT_HOP = 250      # ~5 ms at 48 kHz; the stage picks the nearest divisor
QUANTILE_LIMIT = 1 << 24


def _plan(hop: int):
    """window, COLA correction and FFT size for a 2·hop Hann frame."""
    frame = 2 * hop
    nfft = 1 << max(9, int(np.ceil(np.log2(frame))))
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame) / frame)
           ).astype(np.float32)
    cola = win[:hop] ** 2 + win[hop:] ** 2
    corr = (1.0 / np.maximum(cola, 1e-3)).astype(np.float32)
    return win, corr, nfft


@functools.lru_cache(maxsize=None)
def _plan_on(hop: int, device: torch.device):
    win, corr, nfft = _plan(hop)
    return (torch.as_tensor(win, device=device),
            torch.as_tensor(corr, device=device), nfft)


def nr_init(batch_shape=(), hop: int = DEFAULT_HOP, device="cuda"):
    dev = resolve_device(device)
    shape = tuple(batch_shape)
    return (
        torch.zeros(shape + (hop,), dtype=torch.float32, device=dev),  # input tail
        torch.zeros(shape + (hop,), dtype=torch.float32, device=dev),  # overlap-add tail
        torch.full(shape, -1.0, dtype=torch.float32, device=dev),      # floor (−1 = unset)
    )


def _frame_floor(mag: torch.Tensor) -> torch.Tensor:
    """(..., frames, bins) → (...): each frame's 25th percentile over its
    bins, averaged over the frames.  Above QUANTILE_LIMIT elements the
    channels go through ``torch.quantile`` in chunks within the limit."""
    if mag.numel() <= QUANTILE_LIMIT:
        return torch.quantile(mag, 0.25, dim=-1,
                              interpolation="linear").mean(dim=-1)
    per_channel = mag.shape[-2] * mag.shape[-1]
    if per_channel > QUANTILE_LIMIT:
        raise ValueError(f"one channel's NR spectrum has {per_channel} "
                         f"elements; torch.quantile takes at most "
                         f"{QUANTILE_LIMIT}")
    flat = mag.reshape((-1,) + tuple(mag.shape[-2:]))
    step = QUANTILE_LIMIT // per_channel
    parts = [torch.quantile(flat[i:i + step], 0.25, dim=-1,
                            interpolation="linear")
             for i in range(0, flat.shape[0], step)]
    return torch.cat(parts).mean(dim=-1).reshape(mag.shape[:-2])


def nr_apply(state, threshold_db: torch.Tensor, x: torch.Tensor,
             hop: int = DEFAULT_HOP):
    """x (..., B) float32 audio with B % hop == 0 → same shape, denoised
    and delayed by one hop.  threshold_db () or (...,) float32."""
    window, corr, nfft = _plan_on(hop, x.device)
    frame = 2 * hop
    in_tail, ola_tail, floor_ema = state
    b = x.shape[-1]

    xe = torch.cat([in_tail, x], dim=-1)                  # (..., hop+B)
    frames = xe.unfold(-1, frame, hop) * window            # (..., nframes, frame)
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)          # (..., nframes, nfft/2+1)
    mag = spec.abs()

    # broadband noise floor: low percentile across bins, averaged over the
    # block's frames, EMA-smoothed across blocks
    frame_floor = _frame_floor(mag)
    floor = torch.where(floor_ema < 0, frame_floor,
                        0.8 * floor_ema + 0.2 * frame_floor)

    alpha = torch.pow(10.0, threshold_db.to(torch.float32) / 20.0)
    sub = alpha[..., None, None] * floor[..., None, None]
    gain = torch.clamp((mag - sub) / torch.clamp_min(mag, 1e-9), 0.1, 1.0)
    cleaned = torch.fft.irfft(spec * gain, n=nfft, dim=-1)[..., :frame] * window

    first = cleaned[..., :, :hop]
    second = cleaned[..., :, hop:]
    prev_second = torch.cat([ola_tail[..., None, :], second[..., :-1, :]],
                            dim=-2)
    y = ((first + prev_second) * corr).reshape(x.shape[:-1] + (b,))
    new_state = (xe[..., -hop:], second[..., -1, :], floor)
    return new_state, y
