"""Overlap-save FFT bandpass filtering (single segment per block).

Counterpart of ``openwebrx_tpu/ops/bandpass.py``.  The response is a
parameter computed on the host (``firdes.bandpass_response_batch``); the
carried state is the last (ntaps−1) input samples.
"""

from __future__ import annotations

import numpy as np
import torch

from openwebrx_tpu_torch import resolve_device


def plan_nfft(ntaps: int, block: int) -> int:
    """Smallest power of two ≥ ntaps − 1 + block (single-segment case)."""
    need = ntaps - 1 + block
    return 1 << int(np.ceil(np.log2(need)))


def bandpass_init(ntaps: int, batch_shape=(), device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(batch_shape) + (ntaps - 1,),
                       dtype=torch.complex64, device=resolve_device(device))


def bandpass_apply(tail: torch.Tensor, response: torch.Tensor,
                   x: torch.Tensor, ntaps: int, nfft: int):
    """tail (..., ntaps−1) · response (nfft,) or (..., nfft) complex64 ·
    x (..., B), ntaps − 1 + B ≤ nfft → (tail, y (..., B) complex64) with a
    constant (ntaps−1)-sample group delay."""
    b = x.shape[-1]
    xe = torch.cat([tail, x], dim=-1)                 # (..., T−1+B)
    new_tail = xe[..., -(ntaps - 1):] if ntaps > 1 else tail
    xf = torch.fft.fft(xe, n=nfft, dim=-1)            # zero-padded to nfft
    y = torch.fft.ifft(xf * response, dim=-1)
    return new_tail, y[..., ntaps - 1: ntaps - 1 + b]
