"""Power squelch with hang, plus s-meter power reports.

Counterpart of ``openwebrx_tpu/ops/squelch.py``.  On a CUDA tensor
:func:`squelch_apply` is one launch of the hand-written kernel
``csrc/squelch.cu`` (window powers, dB, the hang recurrence over the
windows and the gated output); on a CPU tensor it is
:func:`squelch_apply_plain`, whose recurrence is a Python loop over the
block's windows.  The kernel sums each window in another order than
``torch.mean``, so ``power_db`` agrees within a tolerance; the gates, the
hang counters and the output agree exactly wherever the power is not
within that tolerance of the level.
"""

from __future__ import annotations

import numpy as np
import torch

from openwebrx_tpu_torch import check_on, resolve_device
from openwebrx_tpu_torch.kernels import SQUELCH


def squelch_init(batch_shape=(), device="cuda"):
    dev = resolve_device(device)
    return (torch.zeros(tuple(batch_shape), dtype=torch.bool, device=dev),
            torch.zeros(tuple(batch_shape), dtype=torch.int32, device=dev))


def squelch_apply_plain(state, level_db: torch.Tensor, x: torch.Tensor,
                        window: int, hang_windows: int = 2):
    """Plain version: x (..., B) complex64/float32, B % window == 0;
    level_db () or (...,) float32 (−150 ⇒ squelch off) → (state, gated,
    power_db (..., nwindows))."""
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


def squelch_apply(state, level_db: torch.Tensor, x: torch.Tensor,
                  window: int, hang_windows: int = 2):
    """x (..., B) complex64/float32, B % window == 0; level_db () or
    (...,) float32 (−150 ⇒ squelch off) → (state, gated, power_db (...,
    nwindows)), on x's device: one launch of the kernel on a card, the
    plain version on the CPU.  The state and the level must lie there too."""
    open0, hang0 = state
    dev = x.device
    check_on(dev, open0, hang0, level_db)
    lead = tuple(x.shape[:-1])
    b = x.shape[-1] if x.dim() else 0
    if window <= 0 or b == 0 or b % window:
        raise ValueError(f"block {b} is not a positive multiple of window {window}")
    if (open0.dtype != torch.bool or hang0.dtype != torch.int32
            or tuple(open0.shape) != lead or tuple(hang0.shape) != lead):
        raise ValueError(f"state must be ({lead} bool, {lead} int32)")
    if dev.type == "cpu":
        return squelch_apply_plain(state, level_db, x, window, hang_windows)
    if x.dtype not in (torch.complex64, torch.float32):
        raise ValueError(f"the squelch kernel takes complex64 or float32 x, "
                         f"got {x.dtype}")
    rows = int(np.prod(lead, dtype=np.int64))
    xc = x.contiguous()
    level = level_db.to(torch.float32)
    per_row = level.numel() != 1
    if per_row:
        # one threshold a row: a level of the batch's shape passes as is
        level = torch.broadcast_to(level, lead).contiguous()
    y = torch.empty_like(xc)
    power_db = torch.empty(lead + (b // window,), dtype=torch.float32, device=dev)
    open_ = torch.empty(lead, dtype=torch.bool, device=dev)
    hang = torch.empty(lead, dtype=torch.int32, device=dev)
    if rows:
        SQUELCH.launch(dev, xc.data_ptr(), level.data_ptr(),
                       open0.contiguous().data_ptr(),
                       hang0.contiguous().data_ptr(), y.data_ptr(),
                       power_db.data_ptr(), open_.data_ptr(), hang.data_ptr(),
                       rows, b, window, 2 if x.is_complex() else 1,
                       int(per_row), hang_windows)
    return (open_, hang), y, power_db
