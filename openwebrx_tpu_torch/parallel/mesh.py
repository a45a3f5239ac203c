"""Device meshes over ``torch.distributed`` ranks, and the collectives of one
mesh axis.

Counterpart of ``openwebrx_tpu/parallel/mesh.py``.  The reference is one
controller driving a ``jax.sharding.Mesh`` of devices through ``shard_map``;
the port is SPMD: one process (rank) per device, a process group joined
first (``parallel/cluster.init_cluster`` or ``dist.init_process_group``),
and a ``DeviceMesh`` naming the ranks' axes.  NCCL carries CUDA tensors,
gloo CPU ones.

The reference's ``cpu_devices`` (XLA's virtual host devices, for mesh
tests on one CPU) has no counterpart: a CPU "device" of the port is a gloo
rank, which is a process of its own.

:class:`AxisComm` is what the sharded functions call in place of
``lax.ppermute``, ``psum``, ``all_gather`` and ``all_to_all``.  Every
collective moves a byte view of its tensor, so complex and int16 data
cross NCCL (no complex type) and gloo (no complex or int16 type) bit for
bit; only :meth:`AxisComm.all_reduce_sum` does arithmetic, on real
tensors.  A CUDA tensor on a gloo group goes through host memory: gloo
runs on the host, and a caller who chose gloo for card tensors (two ranks
sharing one card, which NCCL refuses) gets that copy, never as a stand-in
for a failed NCCL.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from openwebrx_tpu_torch import resolve_device


def make_mesh(n_devices: int, axes: dict[str, int] | None = None,
              device="cuda"):
    """A ``DeviceMesh`` of ``n_devices`` ranks (the whole process group)
    with named axes, e.g. ``{"time": 2, "chan": 4}``; default
    ``{"chan": n_devices}``.  Needs an initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if axes is None:
        axes = {"chan": n_devices}
    shape = tuple(axes.values())
    if math.prod(shape) != n_devices:
        raise ValueError(f"mesh axes {axes} ≠ {n_devices} devices")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: join the ranks "
            "with parallel.cluster.init_cluster or dist.init_process_group")
    if n_devices != dist.get_world_size():
        raise ValueError(f"{n_devices} devices asked for, but the process "
                         f"group has {dist.get_world_size()} ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axes))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of ``t``'s elements (a copy only if ``t`` is not
    contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _typed(buf: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """Bytes received for a tensor like ``like`` → that dtype, ``shape``,
    on ``like``'s device."""
    return buf.to(like.device).view(like.dtype).reshape(shape)


class AxisComm:
    """The ranks along one axis of a ``DeviceMesh``: this rank's position
    ``index`` among ``size``, and the collectives of that axis' group.
    ``ranks`` are the global ranks in axis order (point-to-point ops name
    their peers by global rank)."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.size = len(self.ranks)
        self.index = mesh.get_local_rank(axis)
        self.backend = dist.get_backend(self.group)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s bytes where the group's backend reads them."""
        b = _bytes(t)
        return b.cpu() if self.backend == "gloo" and b.is_cuda else b

    def ring_right(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to the next rank of the axis (the last to the first)
        and return what the previous one sent: ``lax.ppermute`` with
        ``[(i, (i + 1) % n)]``.  With one rank that permutation is (0, 0),
        the identity, and nothing is sent."""
        if self.size == 1:
            return t
        send = self._out(t)
        recv = torch.empty_like(send)
        nxt = self.ranks[(self.index + 1) % self.size]
        prev = self.ranks[(self.index - 1) % self.size]
        ops = [dist.P2POp(dist.isend, send, nxt, self.group),
               dist.P2POp(dist.irecv, recv, prev, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return _typed(recv, t, t.shape)

    def broadcast_from(self, t: torch.Tensor, index: int) -> torch.Tensor:
        """The value of ``t`` on the axis' rank ``index``, on every rank."""
        buf = self._out(t)
        if self.index != index:     # received into a buffer of its own
            buf = torch.empty_like(buf)
        dist.broadcast(buf, src=self.ranks[index], group=self.group)
        return _typed(buf, t, t.shape)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t`` in axis order."""
        send = self._out(t)
        parts = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(parts, send, group=self.group)
        return _typed(torch.cat(parts), t, (self.size, *t.shape))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Split ``t`` along dim 0 into ``size`` equal blocks, send block j
        to rank j, and return the blocks received, stacked along dim 0 in
        the senders' axis order (``dist.all_to_all_single``)."""
        if t.shape[0] % self.size:
            raise ValueError(f"dim 0 of {tuple(t.shape)} does not split "
                             f"over {self.size} ranks")
        send = self._out(t)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return _typed(recv, t, t.shape)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` (a real tensor) over the axis' ranks."""
        buf = t.cpu() if self.backend == "gloo" and t.is_cuda else t.clone()
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)
