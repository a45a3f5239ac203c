"""Analog demodulators: AM envelope, quadrature FM, SSB real part, sync AM.

Counterpart of ``openwebrx_tpu/ops/demod.py``.  All ops act on the last
axis and broadcast over channel axes.  The only carried state is one
trailing sample (FM discriminator) or the estimated carrier phase and
frequency (sync AM).
"""

from __future__ import annotations

import numpy as np
import torch

from openwebrx_tpu_torch import resolve_device


def am_demod(x: torch.Tensor) -> torch.Tensor:
    """Envelope detector: |x|.  (DC block and AGC are separate stages.)"""
    return x.abs().to(torch.float32)


def fm_init(batch_shape=(), device="cuda") -> torch.Tensor:
    """Carried previous sample for the discriminator."""
    return torch.zeros(tuple(batch_shape), dtype=torch.complex64,
                       device=resolve_device(device))


def fm_demod(prev: torch.Tensor, x: torch.Tensor):
    """Quadrature discriminator: arg(x[n]·conj(x[n−1])) / π ∈ [−1, 1]."""
    xs = torch.cat([prev[..., None], x[..., :-1]], dim=-1)
    d = x * torch.conj(xs)
    y = torch.atan2(d.imag, d.real) * (1.0 / np.pi)
    # guard the zero vector: atan2(±0, −0) = ±π would turn squelched
    # silence into full-scale output
    y = torch.where(d.real ** 2 + d.imag ** 2 > 0, y, torch.zeros_like(y))
    return x[..., -1], y.to(torch.float32)


def real_part(x: torch.Tensor) -> torch.Tensor:
    """SSB product detector after the passband shift: Re{x}."""
    return x.real.to(torch.float32)


def limit(x: torch.Tensor, max_amplitude: float = 1.0) -> torch.Tensor:
    """Hard clipper."""
    return torch.clamp(x, -max_amplitude, max_amplitude)


def gain(x: torch.Tensor, g) -> torch.Tensor:
    return x * g


# ---------------------------------------------------------------- sync AM --
def sync_am_init(batch_shape=(), device="cuda"):
    """Carrier phase (rad) and smoothed frequency estimate (rad/sample)."""
    dev = resolve_device(device)
    return (torch.zeros(tuple(batch_shape), dtype=torch.float32, device=dev),
            torch.zeros(tuple(batch_shape), dtype=torch.float32, device=dev))


def _expj_neg(ph: torch.Tensor) -> torch.Tensor:
    """exp(−j·ph) for a float32 phase."""
    return torch.complex(torch.cos(ph), -torch.sin(ph))


def sync_am_demod(state, x: torch.Tensor, loop_alpha: float = 0.5):
    """Block-wise carrier-locked AM: estimate the residual carrier from the
    mean phasor rotation, advance a smoothed frequency estimate, mix the
    carrier down coherently, snap the residual phase onto the real axis and
    take the real part."""
    phase, freq = state
    b = x.shape[-1]
    rot = torch.sum(x[..., 1:] * torch.conj(x[..., :-1]), dim=-1)
    inst_freq = torch.atan2(rot.imag, rot.real)
    freq = (1.0 - loop_alpha) * freq + loop_alpha * inst_freq
    n = torch.arange(b, dtype=torch.float32, device=x.device)
    ph = phase[..., None] + freq[..., None] * n
    bb = x * _expj_neg(ph)
    carrier = torch.mean(bb, dim=-1)
    corr = torch.atan2(carrier.imag, carrier.real)
    bb = bb * _expj_neg(corr[..., None])
    y = bb.real.to(torch.float32)
    # torch.remainder, like jnp.mod, takes the sign of the divisor
    new_phase = torch.remainder(phase + freq * b + corr, 2.0 * np.pi)
    return (new_phase, freq), y
