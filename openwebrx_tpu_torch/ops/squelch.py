"""Power squelch with hang, plus s-meter power reports.

Counterpart of ``openwebrx_tpu/ops/squelch.py``.  The hang recurrence runs
over the block's measurement windows as a Python loop (one window per
block on the 1024-channel bank; a CUDA kernel for it is queued in
ROADMAP.md).
"""

from __future__ import annotations

import torch

from openwebrx_tpu_torch import resolve_device


def squelch_init(batch_shape=(), device="cuda"):
    dev = resolve_device(device)
    return (torch.zeros(tuple(batch_shape), dtype=torch.bool, device=dev),
            torch.zeros(tuple(batch_shape), dtype=torch.int32, device=dev))


def squelch_apply(state, level_db: torch.Tensor, x: torch.Tensor,
                  window: int, hang_windows: int = 2):
    """x (..., B) complex64/float32, B % window == 0; level_db () or (...,)
    float32 (−150 ⇒ squelch off) → (state, gated, power_db (..., nwindows))."""
    open_, hang = state
    b = x.shape[-1]
    nw = b // window
    p = (x.abs() ** 2).reshape(x.shape[:-1] + (nw, window)).mean(dim=-1)
    power_db = 10.0 * torch.log10(torch.clamp_min(p, 1e-30))
    above = power_db > level_db[..., None]
    gates = []
    for w in range(nw):
        a = above[..., w]
        hang = torch.where(a, torch.full_like(hang, hang_windows),
                           torch.clamp_min(hang - 1, 0))
        open_ = a | (hang > 0)
        gates.append(open_)
    g = torch.stack(gates, dim=-1).repeat_interleave(window, dim=-1)
    # where, not a multiply: x·0 keeps the sign of zero, and a −0.0
    # downstream turns arctan2(0, −0) = π into full-scale FM noise
    y = torch.where(g, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return (open_, hang), y, power_db
