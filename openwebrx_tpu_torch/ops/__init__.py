"""DSP ops on tensors: pure functions (state, params, x) -> (state, y)."""

from __future__ import annotations

import torch


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 with the same value mod 2³² (two's complement).

    The reference relies on int32 arithmetic wrapping; the port computes
    in int64 and reduces explicitly, since C++ leaves signed overflow
    undefined."""
    return (((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)
