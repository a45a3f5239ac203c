"""First-order IIR sections: y[n] = a1·y[n−1] + b0·x[n] + b1·x[n−1].

Counterpart of ``openwebrx_tpu/ops/iir.py``, which evaluates the linear
recurrence with ``jax.lax.associative_scan``.  PyTorch has no scan, so the
plain version here is a log-depth doubling scan (about log2(B) vectorized
steps, never a B-step loop), and on a CUDA tensor :func:`first_order_apply`
runs the hand-written kernel ``csrc/iir.cu`` (rows staged whole in shared
memory; a warp a short row, a CTA-wide scan for long ones, which are cut
over a thread-block cluster when few).  The three evaluation orders round
differently; the tests state the tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from openwebrx_tpu_torch import check_on, resolve_device
from openwebrx_tpu_torch.kernels import IIR

# the longest row one kernel launch takes (8 CTAs of 3840 samples)
KERNEL_MAX_ROW = 8 * 3840


def linear_recurrence(a, c: torch.Tensor, y_prev: torch.Tensor) -> torch.Tensor:
    """Solve y[n] = a·y[n−1] + c[n] along the last axis, y[−1] = y_prev.

    a: scalar or (...,) broadcastable coefficient; c: (..., B);
    y_prev: (...,) carried state.  Hillis–Steele scan of the affine maps
    (A, y): at distance d, y[d:] += A[d:]·y[:−d], then A[d:] *= A[:−d].
    """
    a = torch.broadcast_to(torch.as_tensor(a, dtype=c.dtype, device=c.device),
                           c.shape)
    y = c.clone()
    y[..., 0] = y[..., 0] + a[..., 0] * y_prev
    big_a = a
    b = c.shape[-1]
    d = 1
    while d < b:
        y = torch.cat([y[..., :d], y[..., d:] + big_a[..., d:] * y[..., :-d]],
                      dim=-1)
        big_a = torch.cat([big_a[..., :d], big_a[..., d:] * big_a[..., :-d]],
                          dim=-1)
        d *= 2
    return y


def first_order_init(batch_shape=(), device="cuda"):
    """State (x_prev, y_prev) of y = b0·x + b1·x⁻¹ + a1·y⁻¹."""
    dev = resolve_device(device)
    return (torch.zeros(tuple(batch_shape), dtype=torch.float32, device=dev),
            torch.zeros(tuple(batch_shape), dtype=torch.float32, device=dev))


def first_order_apply_plain(state, b0: float, b1: float, a1: float,
                            x: torch.Tensor):
    """Plain version: (x_prev, y_prev), x (..., B) float32 →
    ((x[..., −1], y[..., −1]), y)."""
    x_prev, y_prev = state
    x_shift = torch.cat([x_prev[..., None], x[..., :-1]], dim=-1)
    c = b0 * x + b1 * x_shift
    y = linear_recurrence(a1, c, y_prev)
    return (x[..., -1], y[..., -1]), y


def first_order_apply(state, b0: float, b1: float, a1: float,
                      x: torch.Tensor, device="cuda"):
    """General first-order section along the last axis (streaming) on
    ``device``: the CUDA kernel there, the plain version on the CPU; the
    tensors must lie on ``device``.  b0, b1, a1 are scalars.
    (x_prev, y_prev) (...,), x (..., B) float32 →
    ((x[..., −1], y[..., −1]), y)."""
    x_prev, y_prev = state
    dev = resolve_device(device)
    check_on(dev, x, x_prev, y_prev)
    lead = tuple(x.shape[:-1])
    n = x.shape[-1] if x.dim() else 0
    if x.dtype != torch.float32 or n == 0:
        raise ValueError(f"x must be (..., B) float32 with B > 0, got "
                         f"{tuple(x.shape)} {x.dtype}")
    for name, t in (("x_prev", x_prev), ("y_prev", y_prev)):
        if t.dtype != torch.float32 or tuple(t.shape) != lead:
            raise ValueError(f"{name} must be {lead} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if dev.type == "cpu":
        return first_order_apply_plain(state, b0, b1, a1, x)
    if not all(np.ndim(v) == 0 for v in (b0, b1, a1)):
        raise ValueError("the first-order kernel takes scalar coefficients")
    rows = int(np.prod(lead, dtype=np.int64))
    xp, yp = x_prev.contiguous(), y_prev.contiguous()
    if n > KERNEL_MAX_ROW:
        # the kernel cuts a row over at most 8 CTAs: longer rows go in
        # column blocks, the state carried from one to the next
        ys = []
        for a in range(0, n, KERNEL_MAX_ROW):
            (xp, yp), yb = first_order_apply(
                (xp, yp), b0, b1, a1, x[..., a:a + KERNEL_MAX_ROW].contiguous(), dev)
            ys.append(yb)
        return (xp, yp), torch.cat(ys, dim=-1)
    xc = x.contiguous()
    y = torch.empty_like(xc)
    x_last = torch.empty(lead, dtype=torch.float32, device=dev)
    y_last = torch.empty(lead, dtype=torch.float32, device=dev)
    if rows:
        IIR.launch(dev, xc.data_ptr(), xp.data_ptr(), yp.data_ptr(), y.data_ptr(),
                   x_last.data_ptr(), y_last.data_ptr(), rows, n,
                   float(b0), float(b1), float(a1))
    return (x_last, y_last), y


def dc_block_coeffs(rate: float, cutoff_hz: float = 10.0):
    """y[n] = x[n] − x[n−1] + R·y[n−1]: single-pole DC blocker."""
    r = float(np.exp(-2.0 * np.pi * cutoff_hz / rate))
    return 1.0, -1.0, r


def deemphasis_coeffs(rate: float, tau: float):
    """One-pole de-emphasis y[n] = α·x[n] + (1−α)·y[n−1]."""
    dt = 1.0 / rate
    alpha = dt / (tau + dt)
    return alpha, 0.0, 1.0 - alpha
