"""SSB detector pieces: real part, hard limit, gain.

Counterpart of ``real_part``, ``limit`` and ``gain`` in
``openwebrx_tpu/ops/demod.py``.  The AM, FM and sync-AM demodulators (and
the IIR they use) belong to a later slice of the port.
"""

from __future__ import annotations

import torch


def real_part(x: torch.Tensor) -> torch.Tensor:
    """SSB product detector after the passband shift: Re{x}."""
    return x.real.to(torch.float32)


def limit(x: torch.Tensor, max_amplitude: float = 1.0) -> torch.Tensor:
    """Hard clipper."""
    return torch.clamp(x, -max_amplitude, max_amplitude)


def gain(x: torch.Tensor, g) -> torch.Tensor:
    return x * g
