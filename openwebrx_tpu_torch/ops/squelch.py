"""Power squelch with hang, plus s-meter power reports.

Counterpart of ``openwebrx_tpu/ops/squelch.py``.  On a CUDA tensor
:func:`squelch_apply` is one launch of the hand-written kernel
``csrc/squelch.cu`` (window powers, dB, the hang recurrence over the
windows and the gated output) on the launch plan of :func:`squelch_plan`;
on a CPU tensor it is :func:`squelch_apply_plain`, whose recurrence is a
Python loop over the block's windows.  The kernel sums each window in another order than
``torch.mean``, so ``power_db`` agrees within a tolerance; the gates, the
hang counters and the output agree exactly wherever the power is not
within that tolerance of the level.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from openwebrx_tpu_torch import check_on, resolve_device
from openwebrx_tpu_torch.kernels import SQUELCH


# The kernel's launch plan (csrc/squelch.cu checks it and runs it); the
# constants are the best of a sweep of cuts on an H100 (PERF.md §6)
SMS = 132                 # SMs of an H100 SXM; the wrapper passes the card's
MAX_CLUSTER = 8           # CTAs a row: the portable cluster size
MAX_WARPS = 8             # warps a CTA (csrc/squelch.cu kMaxWarps)
ROW_FLOATS = 25000        # rows up to this many floats (100 KB: two CTAs an SM
                          # fit) go whole, a row a CTA; longer ones are sliced,
                          # no slice longer than this
THREADS_AIM = 1 << 17     # rows mode: the threads of the grid, where rows are many
MIN_VEC = 2               # a thread takes at least this many 16-byte vectors ...
MAX_VEC = 10              # ... and at most this many, where the warps allow
MAX_STAGES = 4            # stage buffers (csrc/squelch.cu kMaxStages)
MAX_REGS = 16             # 16-byte vectors a thread holds in registers mode
SMEM_FLOATS = (227 * 1024 - 32) // 4    # dynamic shared memory a CTA, floats (the
                                        # kernel's four mbarriers take 32 bytes)
MAX_OFFSET = 1 << 22      # floats: a slice plus a window stays under this


class SquelchPlan(NamedTuple):
    """How ``csrc/squelch.cu`` cuts one call.

    Rows mode (``slice == 0``): a CTA a row, ``grid = rows``; ``stages``
    0 holds the row in registers (``chunk`` is the row), else the row is
    staged in chunks of ``chunk`` floats of whole windows through
    ``stages`` buffers: one chunk where the row fits, else the row is
    walked chunk by chunk (``walks``), each gated and stored from its
    stage.  Slice mode: each row is cut into ``cluster`` slices of
    ``slice`` floats (the last one shorter), one CTA each, a thread-block
    cluster a row (``grid = rows * cluster``), a slice staged whole unless
    it is longer than the stages hold (``reread``: its window sums are
    then streamed and y written from a second read of x).  A CTA has
    ``warps`` warps.  ``grid`` and ``smem`` (the dynamic shared memory in
    bytes) follow from the rest, and the kernel derives them itself;
    ``vec``: bulk copies and 16-byte stores, else 4-byte copies (a row,
    slice or chunk start not 16-byte aligned).
    """
    cluster: int
    warps: int
    slice: int
    chunk: int
    stages: int
    grid: int
    smem: int
    vec: bool

    def walks(self, n: int, cplx: int) -> bool:
        return not self.slice and self.chunk < n * cplx

    def reread(self, n: int, cplx: int) -> bool:
        return bool(self.slice) and self.slice > self.stages * self.chunk


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, int(v - 1).bit_length())


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _group(tasks: int, n: int) -> int:
    """Threads a window when ``tasks`` windows share ``n`` threads, as
    ``csrc/squelch.cu`` group_of."""
    sub = 1
    while sub < n and tasks * sub * 2 <= n:
        sub <<= 1
    return sub


def fits_registers(n: int, window: int, cplx: int, warps: int) -> bool:
    """Whether a row fits registers mode (``csrc/squelch.cu`` regs_needed):
    windows of whole 16-byte vectors, no more windows than threads, and at
    most MAX_REGS vectors a thread."""
    wf, nwin, t = window * cplx, n // window, 32 * warps
    return wf % 4 == 0 and nwin <= t and _ceil(wf // 4, _group(nwin, t)) <= MAX_REGS


def squelch_smem(n: int, window: int, cplx: int, warps: int, slice_: int, chunk: int,
                 stages: int) -> int:
    """Dynamic shared memory (bytes) of a plan, as ``csrc/squelch.cu``
    ``layout_of`` carves it (``squelch_smem_bytes`` there; a card check
    holds the two equal): the stages, a chunk's window sums (a slot a
    warp), in slice mode the slice's window sums, and each warp's powers
    of the windows it decides (the row's in slice mode, a chunk's in rows
    mode)."""
    wf = window * cplx
    sums = slice_ // wf + 2 if slice_ else 0
    per_warp = n // window if slice_ else chunk // wf
    return 4 * (stages * chunk + (chunk // wf + 2) * warps + sums + warps * per_warp)


def squelch_layout(rows: int, n: int, window: int, cplx: int, cluster: int = 1,
                   warps: int = 0, sliced: bool = True, aligned: bool = True) -> SquelchPlan:
    """The plan of a given cut: ``sliced`` False is rows mode (``cluster``
    1), else ``cluster`` slices a row; ``warps`` 0 takes ``_warps``'.
    Raises ValueError where the cut does not fit."""
    rowf, wf, nwin = n * cplx, window * cplx, n // window
    vec = bool(aligned) and rowf % 4 == 0
    q = 4 if vec else cplx            # granularity of slices and chunks, floats
    if sliced:
        slice_ = _ceil(_ceil(rowf, cluster), q) * q
        if (cluster - 1) * slice_ >= rowf:
            raise ValueError(f"{cluster} slices of {slice_} floats overrun a row of {rowf}")
        grid = rows * cluster
        if not warps:
            warps = _warps(slice_, grid)
        room = SMEM_FLOATS - (slice_ // wf + 2) * (warps + 1) - warps * nwin
        if slice_ <= room:             # one bulk copy of the whole slice
            chunk, stages = slice_, 1
        else:                          # streamed: y from a second read of x
            stages = MAX_STAGES
            chunk = room // stages // q * q
    else:
        if cluster != 1:
            raise ValueError("rows mode takes no cluster")
        slice_, grid = 0, rows
        if not warps:
            warps = _warps(rowf, grid)
        if vec and fits_registers(n, window, cplx, warps):
            smem = squelch_smem(n, window, cplx, warps, 0, rowf, 0)
            return SquelchPlan(1, warps, 0, rowf, 0, grid, smem, True)
        # the windows a chunk fits (a window: one float of the stages a
        # stage, two slots a warp): the row whole in one stage, else walked
        # through two stages (one where a window takes more than half the
        # room) in chunks of a multiple of 16 bytes where they can be
        def fit(stages):
            return (SMEM_FLOATS - 2 * warps) // (stages * wf + 2 * warps)
        if fit(1) >= nwin:
            stages, tw = 1, nwin
        else:
            stages = 2 if fit(2) >= 1 else 1
            tw = fit(stages)
            step = 4 // math.gcd(wf, 4)
            if tw >= step:
                tw -= tw % step
        chunk = tw * wf
        vec = vec and chunk % 4 == 0
    smem = squelch_smem(n, window, cplx, warps, slice_, chunk, stages)
    if (chunk < q or smem > 4 * SMEM_FLOATS or (slice_ and slice_ + wf >= MAX_OFFSET)
            or not 1 <= warps <= MAX_WARPS or cluster not in ((2, 4, 8) if sliced else (1,))):
        raise ValueError(f"no squelch plan for rows {rows}, n {n}, window {window} "
                         f"({nwin} windows a row) in {cluster} slices")
    return SquelchPlan(cluster, warps, slice_, chunk, stages, grid, smem, vec)


def _warps(piece: int, ctas: int) -> int:
    """Warps a CTA for a piece of ``piece`` floats in a grid of ``ctas``:
    enough that no thread takes more than MAX_VEC 16-byte vectors, else
    THREADS_AIM threads over the grid, but none that would take fewer than
    MIN_VEC; 1 to MAX_WARPS."""
    most = piece // (4 * 32 * MIN_VEC)
    aim = min(THREADS_AIM // (32 * ctas), most)
    return max(1, min(MAX_WARPS, max(_ceil(piece, 4 * 32 * MAX_VEC), aim)))


def squelch_plan(rows: int, n: int, window: int, cplx: int, aligned: bool = True,
                 sms: int = SMS) -> SquelchPlan:
    """The launch plan of ``csrc/squelch.cu`` for ``rows`` rows of ``n``
    samples (``cplx`` floats each) in windows of ``window``; ``aligned``:
    x lies at a 16-byte aligned address; ``sms``: the card's SMs.

    Rows of up to ROW_FLOATS floats go whole, a row a CTA (rows mode), in
    registers where they fit; longer ones are cut into the fewest slices
    (a power of two up to MAX_CLUSTER) that keep a slice within ROW_FLOATS
    and give at least ``sms`` CTAs, a cluster a row.  A CTA takes the warps
    of ``_warps``, or one warp (then more slices) where a row's windows are
    too many for the shared memory; a row that no slices fit is walked in
    chunks of whole windows, a CTA a row.  Raises ValueError for a shape no
    plan fits: a row of 2^31 floats or more, or a window longer than the
    shared memory where the row is too long for slices."""
    if (rows < 1 or window < 1 or n < window or n % window or cplx not in (1, 2)
            or n * cplx >= 1 << 31):
        raise ValueError(f"no squelch plan for rows {rows}, n {n}, window {window}, "
                         f"cplx {cplx}")
    rowf = n * cplx
    parts = max(_pow2_ceil(_ceil(rowf, ROW_FLOATS)), _pow2_ceil(_ceil(sms, rows)))
    cuts = [(False, 1)] if rowf <= ROW_FLOATS else []
    cuts += [(True, c) for c in (2, 4, 8) if c >= min(MAX_CLUSTER, parts)]
    cuts += [(False, 1)] if rowf > ROW_FLOATS else []
    for sliced, cluster in cuts:   # many short windows: fewer warps, then slices
        for warps in (0, 1):
            try:
                return squelch_layout(rows, n, window, cplx, cluster, warps, sliced=sliced,
                                      aligned=aligned)
            except ValueError:
                pass
    raise ValueError(f"no squelch plan for rows {rows}, n {n}, window {window}, "
                     f"cplx {cplx}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
        cplx = 2 if x.is_complex() else 1
        plan = squelch_plan(rows, b, window, cplx, aligned=xc.data_ptr() % 16 == 0,
                            sms=_sms(dev.index))
        SQUELCH.launch(dev, xc.data_ptr(), level.data_ptr(),
                       open0.contiguous().data_ptr(),
                       hang0.contiguous().data_ptr(), y.data_ptr(),
                       power_db.data_ptr(), open_.data_ptr(), hang.data_ptr(),
                       rows, b, window, cplx, int(per_row), hang_windows,
                       plan.cluster, plan.warps, plan.slice, plan.chunk, plan.stages,
                       int(plan.vec))
    return (open_, hang), y, power_db
