"""FSK symbol slicing for the digital-voice modes.

Counterpart of ``openwebrx_tpu/ops/fsk.py``.  C4FM levels map to dibits
(+3d → 0b01, +d → 0b00, −d → 0b10, −3d → 0b11): the MSB is the sign, the
LSB marks the outer levels.  The unit level d is estimated per block from
the mean magnitude (E|y| = 2d for equiprobable levels), so the slicer
scales itself to the discriminator gain.
"""

from __future__ import annotations

import torch


def fsk4_slice(y: torch.Tensor, floor: float = 1e-6) -> torch.Tensor:
    """y (..., N) real symbol-rate samples → dibits (..., N) uint8; the
    inner/outer threshold is 2·d with d = mean(|y|)/2 per channel."""
    d = torch.clamp_min(y.abs().mean(dim=-1, keepdim=True) / 2.0, floor)
    negative = (y < 0).to(torch.uint8)
    outer = (y.abs() > 2.0 * d).to(torch.uint8)
    return 2 * negative + outer


def fsk2_slice(y: torch.Tensor) -> torch.Tensor:
    """Binary FSK: sign bit per symbol (..., N) uint8."""
    return (y > 0).to(torch.uint8)
