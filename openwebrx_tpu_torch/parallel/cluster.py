"""Multi-host distribution: the process group and host-sharded IQ ingest.

Counterpart of ``openwebrx_tpu/parallel/cluster.py`` (BASELINE config #5:
one wideband stream distributed across hosts).  The port runs one process
(rank) per device:

- ``init_cluster`` joins the ranks into one ``torch.distributed`` process
  group (NCCL for CUDA devices, gloo for the CPU, unless the caller names
  a backend), at the coordinator's TCP address.
- Each rank ingests ONLY its time slab of the wideband block; no rank ever
  sees the whole stream, so ingest bandwidth scales with ranks.
- The halo exchange and the time→channel re-shard of
  ``parallel/pfb.sharded_channelize`` are the step's collectives.
- Each rank reads back only its own channels and serves its own listeners.

``DistributedReceiver`` wires a ``ChannelizedBank`` over the ranks;
``python -m openwebrx_tpu_torch.parallel.cluster`` is the per-rank dry-run
and bench worker (``--device cpu`` for a gloo cluster on one machine).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from openwebrx_tpu_torch import resolve_device
from openwebrx_tpu_torch.parallel.mesh import AxisComm, make_mesh
from openwebrx_tpu_torch.parallel.pfb import collective_probe, reshard_probe
from openwebrx_tpu_torch.parallel.pod import sharded_bank_step
from openwebrx_tpu_torch.runtime.chain import (
    as_input_block, finish_fetch, start_fetch)


@dataclass
class ClusterInfo:
    process_id: int
    num_processes: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def rank_device(device, process_id: int) -> torch.device:
    """The device of rank ``process_id``: ``"cuda"`` without an index
    means card ``process_id % cards`` of its host (one rank per card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return resolve_device(dev)


def init_cluster(coordinator_address: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None,
                 timeout: int = 120, device="cuda",
                 backend: str | None = None) -> ClusterInfo:
    """Join this process to the receiver cluster (a no-op for one process).

    Falls back to the OWRX_COORDINATOR / OWRX_NUM_PROCESSES /
    OWRX_PROCESS_ID environment (set by systemd template units or the
    container orchestrator) when arguments are omitted.  Each process runs
    one device (``rank_device``).  ``backend`` defaults to NCCL for a CUDA
    device and gloo for the CPU.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "OWRX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("OWRX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("OWRX_PROCESS_ID", "0"))
    dev = rank_device(device, process_id)
    if num_processes > 1:
        if not coordinator_address:
            raise ValueError("multi-host config needs a coordinator address")
        if not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(
                backend or ("nccl" if dev.type == "cuda" else "gloo"),
                init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id,
                timeout=timedelta(seconds=timeout))
    world = dist.get_world_size() if dist.is_initialized() else 1
    return ClusterInfo(process_id, num_processes, 1, world)


class DistributedReceiver:
    """A ``ChannelizedBank`` stepped over every rank of the process group.

    Input: each rank calls ``process_local`` with ITS slab, block / n
    complex samples (rank p holds samples [p·slab, (p+1)·slab) of the
    global block, in stream order).

    Output: ``(channels, y, checksum)``: the channel indices this rank
    owns, their results as the bank's ``fetch`` gives them (int16 audio, or
    ADPCM's (bytes, stride states), which the wire framing needs), and the
    global sum of |audio| over every rank's channels.
    """

    def __init__(self, bank, cluster: ClusterInfo | None = None,
                 axis: str = "chan", device="cuda"):
        self.device = resolve_device(device)
        if bank.device != self.device:
            raise ValueError(f"the bank lies on {bank.device}, the receiver "
                             f"runs on {self.device}")
        if not dist.is_initialized():
            raise RuntimeError("DistributedReceiver needs a process group "
                               "(init_cluster or dist.init_process_group)")
        self.bank = bank
        self.n_devices = dist.get_world_size()
        self.cluster = cluster or ClusterInfo(dist.get_rank(), self.n_devices,
                                              1, self.n_devices)
        n = self.n_devices
        if bank.m % n or bank.block % n or bank.channel_block % n:
            raise ValueError(
                f"m={bank.m} / block={bank.block} / channel block="
                f"{bank.channel_block} must divide over {n} devices")
        self.axis = axis
        self.mesh = make_mesh(n, {axis: n}, device=self.device)
        self._comm = AxisComm(self.mesh, axis)
        self.slab = bank.block // n
        self._step, self.state, self._params_of, chans = sharded_bank_step(
            bank, self.mesh, axis)
        self.channels = np.arange(chans.start, chans.stop)
        self._params = None

    def refresh_params(self):
        """Slice the bank's chain params for this rank after a retune
        (assign/release/bandpass); cached between blocks."""
        # bank._params() pushes any dirty control arrays into the chain
        # before materializing; dense banks: the slot indices are unused
        _idx, chain_params = self.bank._params()
        self._params = self._params_of(chain_params)
        return self._params

    def _params_stale(self) -> bool:
        """The bank marks its dirty flag on every control change, so the
        per-block cost is one read under its lock.  The bank must not be
        dispatched directly while a DistributedReceiver owns it: its
        ``_params()`` would clear the flag without this rank's slice being
        rebuilt."""
        with self.bank._lock:
            return self._params is None or self.bank._params_dirty

    def dispatch_local(self, x_local):
        """Step the bank with this rank's slab ((slab,) complex64, or packed
        (slab, 2) float32, host or device) without waiting for the results;
        their copies to pinned host memory start at once.  Pair with
        ``complete_local`` one block later, so that the host's packing and
        the copies overlap the device's work."""
        x = as_input_block(x_local, self.slab, True, self.device)
        if self._params_stale():
            self.refresh_params()
        self.state, y, _aux = self._step(self.state, self._params, x)
        audio = y[0] if isinstance(y, tuple) else y
        check = self._comm.all_reduce_sum(
            audio.to(torch.float64).abs().sum().reshape(1))
        return start_fetch(y, {"check": check}, self.device)

    def complete_local(self, pending):
        """Wait for a ``dispatch_local`` result → (channel indices, y,
        checksum) for the channels this rank owns."""
        y, aux = finish_fetch(pending)
        return self.channels, y, float(aux["check"][0])

    def process_local(self, x_local):
        """One block, synchronous: ``complete_local(dispatch_local(x))``."""
        return self.complete_local(self.dispatch_local(x_local))

    def _time(self, probe, blocks: int) -> float:
        probe()                                     # warm
        self._sync()
        t0 = time.perf_counter()
        for _ in range(blocks):
            probe()
        self._sync()
        return (time.perf_counter() - t0) / blocks

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time_collectives(self, blocks: int = 16) -> float:
        """Seconds a step of the step's collectives alone (ring halo, tail
        broadcast and re-shard on the step's shapes, compute stripped): the
        transport half of a step."""
        return self._time(collective_probe(
            self.mesh, self.axis, self.bank.prototype, self.bank.m,
            self.bank.block, device=self.device), blocks)

    def time_reshard(self, blocks: int = 16) -> float:
        """Seconds a step of the time→channel re-shard alone, the
        collective that moves the whole channelized block."""
        return self._time(reshard_probe(
            self.mesh, self.axis, self.bank.m, self.bank.block,
            device=self.device), blocks)


def _usb_bank(m: int, seconds: float, device):
    from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank
    bank = ChannelizedBank(48000.0 * m, m, mode="usb", compression="none",
                           target_seconds=seconds, device=device)
    for k in range(m):
        bank.assign(float((k - m // 2) * 48000.0))
    return bank


def _dryrun(cluster: ClusterInfo, m: int = 8, seconds: float = 0.02,
            device="cuda"):
    """One deterministic step on tiny shapes; returns the checksum every
    process must agree on (and which matches the single-process run)."""
    rx = DistributedReceiver(_usb_bank(m, seconds, device), cluster,
                             device=device)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(rx.bank.block)
         + 1j * rng.standard_normal(rx.bank.block)).astype(np.complex64) * 0.1
    p = cluster.process_id
    # several blocks: block 1 is all filter-warmup zeros (FIR group delay
    # exceeds a tiny block), which would make the cross-host checksum
    # equality vacuous — checksum a post-warmup block instead
    for _ in range(3):
        idx, audio, check = rx.process_local(x[p * rx.slab:(p + 1) * rx.slab])
    # each process owns its channel slab: m/num_processes channels
    if len(idx) != m // cluster.num_processes or audio.shape[0] != len(idx):
        raise RuntimeError(f"rank {p} owns {len(idx)} channels of {m}")
    if check == 0.0:
        raise RuntimeError("dryrun audio is silent: the checksum is meaningless")
    return check, len(idx)


def _bench(cluster: ClusterInfo, m: int, blocks: int, seconds: float = 0.4,
           device="cuda"):
    """Weak-scaling bench leg: every rank feeds its slab of a bank with m
    total channels; returns (global samples/s, seconds a step, seconds a
    step of the collectives alone)."""
    rx = DistributedReceiver(_usb_bank(m, seconds, device), cluster,
                             device=device)
    rng = np.random.default_rng(cluster.process_id)
    slabs = [(rng.standard_normal(rx.slab) + 1j * rng.standard_normal(rx.slab)
              ).astype(np.complex64) * 0.1 for _ in range(4)]
    for i in range(2):                                   # warm up
        rx.process_local(slabs[i % len(slabs)])
    # one-deep pipeline: dispatch block N while block N−1's results finish
    # copying back, the structure the streaming loops use
    t0 = time.perf_counter()
    pend = None
    for i in range(blocks):
        nxt = rx.dispatch_local(slabs[i % len(slabs)])
        if pend is not None:
            rx.complete_local(pend)
        pend = nxt
    rx.complete_local(pend)
    dt = time.perf_counter() - t0
    coll_s = rx.time_collectives(min(blocks, 12)) if rx.n_devices > 1 else 0.0
    return rx.bank.block * blocks / dt, dt / blocks, coll_s


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="multi-host dryrun worker")
    parser.add_argument("--coordinator", default="127.0.0.1:9820")
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--channels", type=int, default=8)
    parser.add_argument("--bench-blocks", type=int, default=0,
                        help="run the weak-scaling bench for N blocks")
    parser.add_argument("--block-seconds", type=float, default=0.4,
                        help="bench block duration (bigger amortizes the "
                             "fixed per-step collective latency)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of this rank (default cuda: card "
                             "process-id %% cards; cpu for a gloo cluster)")
    parser.add_argument("--backend", default=None,
                        help="process group backend (default nccl on a card, "
                             "gloo on the cpu)")
    args = parser.parse_args(argv)
    cluster = init_cluster(args.coordinator, args.num_processes,
                           args.process_id, device=args.device,
                           backend=args.backend)
    device = rank_device(args.device, cluster.process_id)
    if not dist.is_initialized():       # one process: a group of one rank
        dist.init_process_group(
            args.backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=f"tcp://{args.coordinator}", world_size=1, rank=0)
    out = {"process_id": cluster.process_id,
           "num_processes": cluster.num_processes,
           "local_devices": cluster.local_device_count,
           "global_devices": cluster.global_device_count}
    try:
        if args.bench_blocks:
            sps, step_s, coll_s = _bench(cluster, args.channels,
                                         args.bench_blocks,
                                         seconds=args.block_seconds,
                                         device=device)
            out.update(samples_per_s=sps, step_seconds=step_s,
                       collective_seconds=coll_s, channels=args.channels)
        else:
            check, nchan = _dryrun(cluster, m=args.channels, device=device)
            out.update(owned_channels=nchan, checksum=check)
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
