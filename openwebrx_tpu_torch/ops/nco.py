"""NCO frequency shift (complex mixer) with exact fixed-point phase.

Counterpart of ``openwebrx_tpu/ops/nco.py``.  Phase is a 32-bit fixed-point
integer (cycles·2³²); integer arithmetic mod 2³² is phase arithmetic mod one
cycle, so the carried phase is exact for arbitrarily long streams and must
match the reference bit for bit.  The port computes every phase product in
int64 and reduces it mod 2³² explicitly instead of relying
on int32 overflow (``ops.wrap32``).  The phasor is built by
rotation composition as in the reference: sincos only at the chunk starts
and the within-chunk offsets, the full ramp their outer product.
"""

from __future__ import annotations

import numpy as np
import torch

from openwebrx_tpu_torch import resolve_device
from openwebrx_tpu_torch.ops import wrap32

TWO_PI = 2.0 * np.pi
_SCALE = 2.0 ** 32


def rate_to_fixed(rate) -> np.ndarray:
    """Host-side: normalized rate (cycles/sample, float64) → int32 fixed.
    Scalars or arrays; quantization is 2⁻³² cycles/sample."""
    f = np.mod(np.asarray(rate, np.float64), 1.0)
    fixed = np.int64(np.round(f * _SCALE)) & np.int64(0xFFFFFFFF)
    return fixed.astype(np.uint32).view(np.int32)


def shift_init(batch_shape=(), device="cuda") -> torch.Tensor:
    """Initial carried phase (fixed-point cycles·2³²), one per channel."""
    return torch.zeros(tuple(batch_shape), dtype=torch.int32,
                       device=resolve_device(device))


def _expj_fixed(ph: torch.Tensor) -> torch.Tensor:
    """Fixed-point phase (int32 cycles·2³²) → unit phasor (complex64)."""
    angle = (ph.to(torch.float32) * 2.0 ** -32) * TWO_PI
    return torch.complex(torch.cos(angle), torch.sin(angle))


def _chunk_size(b: int, want: int = 64) -> int:
    """Largest divisor of b not above `want`."""
    k = min(want, b)
    while b % k:
        k -= 1
    return k


def shift_apply(phase: torch.Tensor, rate: torch.Tensor, x: torch.Tensor):
    """Mix x by exp(j·2π·rate·n) with carried phase.

    phase: (...,) int32 fixed-point cycles (carried state)
    rate:  () or (...,) int32 fixed-point (see rate_to_fixed)
    x:     (..., B) complex64
    returns (new_phase, y)
    """
    if rate.dtype != torch.int32 or phase.dtype != torch.int32:
        raise TypeError("phase and rate must be int32 fixed-point "
                        "(rate_to_fixed)")
    b = x.shape[-1]
    k = _chunk_size(b)
    nb = b // k
    rf = rate.to(torch.int64)[..., None]
    ph = phase.to(torch.int64)
    ar = torch.arange(max(nb, k), dtype=torch.int64, device=x.device)
    starts = wrap32(ph[..., None] + (ar[:nb] * k) * rf)
    inner = wrap32(ar[:k] * rf)
    phasor = (_expj_fixed(starts)[..., :, None]
              * _expj_fixed(inner)[..., None, :]
              ).reshape(*starts.shape[:-1], b)
    y = x * phasor
    new_phase = wrap32(ph + b * rate.to(torch.int64))
    return new_phase, y
