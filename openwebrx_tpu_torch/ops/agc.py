"""Automatic gain control, chunked.

Counterpart of ``openwebrx_tpu/ops/agc.py``: the envelope is the peak of
each chunk, the gain follows attack/decay dynamics with hang over the
chunks, and the per-chunk gain is ramped back to sample rate.  On a CUDA
tensor the whole function (chunk peaks, the chunk recurrence, the ramp and
the multiply) is one launch of the hand-written kernel ``csrc/agc.cu``; on
a CPU tensor it is :func:`agc_apply_plain`, whose chunk recurrence is a
Python loop.  The kernel repeats the plain version's float32 operations in
its order with round-to-nearest intrinsics, so the gain, the hang counters
and the audio are identical.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from openwebrx_tpu_torch import check_on, resolve_device
from openwebrx_tpu_torch.kernels import AGC


@dataclasses.dataclass(frozen=True)
class AgcProfile:
    """Attack/decay per chunk, hang in chunks."""
    attack: float       # gain-down smoothing factor per chunk (fast)
    decay: float        # gain-up smoothing factor per chunk (slow)
    hang_chunks: int    # chunks to hold gain after a peak before decaying
    reference: float = 0.8     # target envelope level
    max_gain: float = 65536.0
    initial_gain: float = 1.0


FAST = AgcProfile(attack=0.9, decay=0.01, hang_chunks=8)
SLOW = AgcProfile(attack=0.7, decay=0.002, hang_chunks=30)

CHUNK = 50


def agc_init(profile: AgcProfile, batch_shape=(), device="cuda"):
    dev = resolve_device(device)
    return (torch.full(tuple(batch_shape), profile.initial_gain,
                       dtype=torch.float32, device=dev),      # gain
            torch.zeros(tuple(batch_shape), dtype=torch.int32,
                        device=dev))                           # hang counter


@functools.lru_cache(maxsize=None)
def _ramp(chunk: int, device: torch.device) -> torch.Tensor:
    # divided on the host: PyTorch's CUDA division by a scalar multiplies
    # by its reciprocal, which the kernel's exact i / chunk would not match
    ramp = np.arange(chunk, dtype=np.float32) / np.float32(chunk)
    return torch.as_tensor(ramp, device=device)


def agc_apply_plain(state, profile: AgcProfile, x: torch.Tensor,
                    chunk: int = CHUNK):
    """Plain version: x (..., B) float32 (or complex64), B % chunk == 0 →
    ((gain, hang), y)."""
    gain0, hang = state
    b = x.shape[-1]
    nchunks = b // chunk
    env = x.abs().reshape(x.shape[:-1] + (nchunks, chunk)).amax(dim=-1)
    reference = torch.full_like(gain0, profile.reference)
    g = gain0
    gains = []
    for c in range(nchunks):
        target = reference / torch.clamp_min(env[..., c], 1e-9)
        # attack: output would clip → move gain down fast, arm hang
        attacking = target < g
        g_att = g + profile.attack * (target - g)
        g_dec = g + profile.decay * (target - g)
        h_new = torch.where(attacking,
                            torch.full_like(hang, profile.hang_chunks),
                            torch.clamp_min(hang - 1, 0))
        g_new = torch.where(attacking, g_att, torch.where(hang > 0, g, g_dec))
        g = torch.clamp(g_new, 1e-6, profile.max_gain)
        hang = h_new
        gains.append(g)
    gains = torch.stack(gains, dim=-1)                 # (..., nchunks)
    # interpolate gain chunk → sample (hold-with-ramp, no zipper noise)
    g_prev = torch.cat([gain0[..., None], gains[..., :-1]], dim=-1)
    g_samp = (g_prev[..., :, None]
              + (gains - g_prev)[..., :, None] * _ramp(chunk, x.device))
    g_samp = g_samp.reshape(x.shape[:-1] + (b,))
    return (g, hang), (x * g_samp).to(x.dtype)


def agc_apply(state, profile: AgcProfile, x: torch.Tensor, chunk: int = CHUNK,
              device="cuda"):
    """x (..., B), B % chunk == 0 → ((gain, hang), y) on ``device``: one
    launch of the CUDA kernel there, the plain version on the CPU; the
    tensors must lie on ``device``.  The kernel takes float32 x only."""
    gain0, hang0 = state
    dev = resolve_device(device)
    check_on(dev, x, gain0, hang0)
    lead = tuple(x.shape[:-1])
    b = x.shape[-1] if x.dim() else 0
    if chunk <= 0 or b == 0 or b % chunk:
        raise ValueError(f"block {b} is not a positive multiple of chunk {chunk}")
    if (gain0.dtype != torch.float32 or hang0.dtype != torch.int32
            or tuple(gain0.shape) != lead or tuple(hang0.shape) != lead):
        raise ValueError(f"state must be ({lead} float32, {lead} int32)")
    if dev.type == "cpu":
        return agc_apply_plain(state, profile, x, chunk)
    if x.dtype != torch.float32:
        raise ValueError(f"the AGC kernel takes float32 x, got {x.dtype}")
    rows = int(np.prod(lead, dtype=np.int64))
    xc = x.contiguous()
    y = torch.empty_like(xc)
    gain = torch.empty(lead, dtype=torch.float32, device=dev)
    hang = torch.empty(lead, dtype=torch.int32, device=dev)
    if rows:
        AGC.launch(dev, xc.data_ptr(), gain0.contiguous().data_ptr(),
                   hang0.contiguous().data_ptr(), y.data_ptr(),
                   gain.data_ptr(), hang.data_ptr(), rows, b, chunk,
                   profile.attack, profile.decay, profile.hang_chunks,
                   profile.reference, profile.max_gain)
    return (gain, hang), y
