"""Halo-exchange streaming FIR over a time-sharded IQ block.

Counterpart of ``openwebrx_tpu/parallel/halo.py``.  A block of IQ is split
into contiguous time slices over the ranks of one mesh axis; each rank
filters its slice, but a causal FIR needs the T − 1 samples before it.
Those come from the left neighbour on a ring (``AxisComm.ring_right``, the
reference's ``ppermute``); the carried cross-block tail covers rank 0.
"""

from __future__ import annotations

import torch

from openwebrx_tpu_torch import check_on, resolve_device
from openwebrx_tpu_torch.ops import fir
from openwebrx_tpu_torch.parallel.mesh import AxisComm


def _taps(taps, dev: torch.device) -> torch.Tensor:
    h = torch.as_tensor(taps, device=dev)
    return h.to(torch.complex64 if h.is_complex() else torch.float32)


def halo_fir_decimate(tail: torch.Tensor, taps, x_local: torch.Tensor,
                      decimation: int, mesh, axis: str, device="cuda"):
    """Streaming FIR + decimate on this rank's slice of a time-sharded block.

    tail:    (..., T−1) carried state of the WHOLE stream (the same on every
             rank; only the axis' rank 0 reads it)
    taps:    (T,) numpy array or tensor, not flipped
    x_local: (..., B/n) this rank's contiguous time slice, B/n ≥ T − 1
    returns (new_tail, y_local (..., B/(n·D))): ``y_local`` is exactly
    ``fir.fir_apply`` of [left halo, x_local]; the new tail is the last
    rank's trailing T − 1 samples, on every rank (an all_gather of each
    rank's edge, as the reference's).
    """
    dev = resolve_device(device)
    check_on(dev, tail, x_local)
    comm = AxisComm(mesh, axis)
    h = _taps(taps, dev)
    halo = h.shape[-1] - 1
    if halo == 0:
        return tail, fir.fir_apply(tail, h, x_local, decimation)[1]
    if x_local.shape[-1] < halo:
        raise ValueError(f"a rank's slice of {x_local.shape[-1]} samples is "
                         f"shorter than the {halo}-sample halo")
    edge = x_local[..., -halo:]
    recv = comm.ring_right(edge)
    left = tail if comm.index == 0 else recv
    _, y = fir.fir_apply(left, h, x_local, decimation)
    return comm.all_gather(edge)[comm.size - 1], y


def make_sharded_decimator(mesh, axis: str, taps, decimation: int,
                           device="cuda"):
    """A step ``(tail, x_local) -> (tail, y_local)`` over ``axis``: each
    rank passes its slice of the block, whose length must divide by the
    decimation."""
    dev = resolve_device(device)
    h = _taps(taps, dev)

    def step(tail, x_local):
        if x_local.shape[-1] % decimation:
            raise ValueError(f"a rank's slice of {x_local.shape[-1]} samples "
                             f"does not divide by the decimation {decimation}")
        return halo_fir_decimate(tail, h, x_local, decimation, mesh, axis,
                                 device=dev)

    return step
