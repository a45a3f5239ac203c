"""Streaming FIR filtering / integer decimation as a strided convolution.

Counterpart of ``openwebrx_tpu/ops/fir.py`` ``fir_init``/``fir_apply``:
a true causal convolution from zero initial state with an explicit overlap
tail carried between blocks.  Complex data goes through ``F.conv1d`` as a
(re, im) feature pair with a 2×2 feature kernel, the reference's layout.
The package pins ``cudnn.allow_tf32 = False`` (``openwebrx_tpu_torch``),
without which cuDNN would run this conv in TF32.
"""

from __future__ import annotations

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
