"""Float audio → int16 at the stream edge.

Counterpart of ``float_to_short`` in ``openwebrx_tpu/ops/convert.py``:
scale, clip, then truncate toward zero (the float→int16 cast).
"""

from __future__ import annotations

import torch

SHORT_SCALE = 32767.0


def float_to_short(x: torch.Tensor) -> torch.Tensor:
    """float [−1, 1] → int16 (client audio egress)."""
    return torch.clamp(x * SHORT_SCALE, -32768, 32767).to(torch.int16)
