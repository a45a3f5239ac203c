"""Distributed polyphase channelizer: time-sharded fold, then one all_to_all.

Counterpart of ``openwebrx_tpu/parallel/pfb.py``.  Each rank folds its own
time slice of the wideband block through the PFB (``ops/channelizer``: the
``csrc/fold.cu`` kernel and cuFFT on a card), the filter history crossing
slice boundaries travels one hop to the right (the overlap-save halo), and
one all_to_all re-shards the result from time-sharded to channel-sharded,
the layout the per-channel chains want::

    x (B/n per rank) ─ fold + FFT (halo from the left rank)
      → Y (M, B/(n·M)) ─ all_to_all (rows j·M/n… to rank j)
      → Y (M/n, B/M) per rank → batched chains
"""

from __future__ import annotations

import torch

from openwebrx_tpu_torch import check_on, resolve_device
from openwebrx_tpu_torch.ops import channelizer as pfb
from openwebrx_tpu_torch.parallel.mesh import AxisComm


def time_to_channels(y: torch.Tensor, comm: AxisComm) -> torch.Tensor:
    """This rank's (M, T/n) time slice of every channel → the rank's (M/n,
    T) channel slice of the whole block: ``lax.all_to_all(split_axis=0,
    concat_axis=1, tiled=True)``.  Rank j receives rows [j·M/n, (j+1)·M/n)
    of every rank's slice; the one from rank i is time block i."""
    n = comm.size
    m, t = y.shape
    got = comm.all_to_all(y)                   # (n·M/n, T/n), by sender
    return got.view(n, m // n, t).permute(1, 0, 2).reshape(m // n, n * t)


def sharded_channelize(mesh, axis: str, prototype, m: int, device="cuda"):
    """``fold(tail, x_local) -> (new_tail, y_local)``.

    tail:    (P·M,) complex64 carried state of the whole stream (the same
             on every rank; the axis' rank 0 reads it)
    x_local: (B/n,) complex64, this rank's time slice, B/n a multiple of M
             and ≥ P·M
    new_tail: the last rank's trailing P·M samples, on every rank
    y_local: (M/n, B/M) complex64, this rank's channels over the block
    """
    dev = resolve_device(device)
    comm = AxisComm(mesh, axis)
    proto = torch.as_tensor(prototype, dtype=torch.float32, device=dev)
    halo = proto.shape[0]                      # P·M carried samples
    if m % comm.size:
        raise ValueError(f"{m} channels do not split over {comm.size} ranks")

    def fold(tail, x_local):
        check_on(dev, tail, x_local)
        if x_local.shape[-1] < halo:
            raise ValueError(f"a rank's slice of {x_local.shape[-1]} samples "
                             f"is shorter than the {halo}-sample halo")
        send = x_local[-halo:]
        # ring halo: my trailing P·M samples feed my right neighbour's fold
        prev = comm.ring_right(send)
        local_tail = tail if comm.index == 0 else prev
        _, y = pfb.channelize(local_tail, proto, x_local, m, device=dev)
        # the stream's new tail is the LAST rank's trailing samples (the
        # reference's psum of a masked send)
        new_tail = comm.broadcast_from(send, comm.size - 1)
        return new_tail, time_to_channels(y, comm)

    return fold


def collective_probe(mesh, axis: str, prototype, m: int, block: int,
                     device="cuda"):
    """A callable that runs exactly the collectives of one
    ``sharded_channelize`` step (ring halo, tail broadcast, re-shard) on
    zero operands of the step's per-rank shapes, with the fold, FFT and
    chains stripped: timing it against the full step splits a step into
    compute and transport."""
    dev = resolve_device(device)
    comm = AxisComm(mesh, axis)
    halo = len(prototype)
    send = torch.zeros(halo, dtype=torch.complex64, device=dev)
    y = torch.zeros(m, max(1, block // m // comm.size), dtype=torch.complex64,
                    device=dev)

    def probe():
        prev = comm.ring_right(send)
        tail = comm.broadcast_from(send, comm.size - 1)
        return prev, tail, time_to_channels(y, comm)

    return probe


def reshard_probe(mesh, axis: str, m: int, block: int, device="cuda"):
    """A callable that runs the time→channel re-shard alone on a zero
    operand of the step's per-rank shape: the one collective that moves the
    whole channelized block (the halo carries P·M samples, the tail one
    vector)."""
    dev = resolve_device(device)
    comm = AxisComm(mesh, axis)
    y = torch.zeros(m, max(1, block // m // comm.size), dtype=torch.complex64,
                    device=dev)
    return lambda: time_to_channels(y, comm)
