"""Format conversion and elementwise ops at the stream edges.

Counterpart of ``openwebrx_tpu/ops/convert.py``.  Device math is float32
or complex64; int16 and uint8 samples exist only at host boundaries, where
the converters are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

SHORT_SCALE = 32767.0


def float_to_short(x: torch.Tensor) -> torch.Tensor:
    """float [−1, 1] → int16 (client audio egress): scale, clip, then
    truncate toward zero."""
    return torch.clamp(x * SHORT_SCALE, -32768, 32767).to(torch.int16)


def short_to_float(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * (1.0 / SHORT_SCALE)


def complex_short_to_complex(iq: np.ndarray) -> np.ndarray:
    """Host ingest: interleaved int16 IQ → complex64."""
    f = iq.astype(np.float32) * (1.0 / SHORT_SCALE)
    return (f[..., 0::2] + 1j * f[..., 1::2]).astype(np.complex64)


def uint8_iq_to_complex(raw: np.ndarray) -> np.ndarray:
    """RTL-SDR style unsigned 8-bit IQ → complex64 in [−1, 1]."""
    f = (raw.astype(np.float32) - 127.4) * (1.0 / 128.0)
    return (f[..., 0::2] + 1j * f[..., 1::2]).astype(np.complex64)


def downmix(x: torch.Tensor) -> torch.Tensor:
    """Stereo (..., N, 2) → mono (..., N)."""
    return x.mean(dim=-1)
