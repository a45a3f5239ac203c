"""Automatic gain control, chunked.

Counterpart of ``openwebrx_tpu/ops/agc.py``: the envelope is the peak of
each chunk, the gain follows attack/decay dynamics with hang over the
chunks, and the per-chunk gain is ramped back to sample rate.  The chunk
recurrence is a Python loop (12 steps per block on the 1024-channel bank);
a CUDA kernel for it is queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from openwebrx_tpu_torch import resolve_device


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
    return torch.arange(chunk, dtype=torch.float32, device=device) / chunk


def agc_apply(state, profile: AgcProfile, x: torch.Tensor,
              chunk: int = CHUNK):
    """x (..., B) float32, B % chunk == 0 → same shape out."""
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
