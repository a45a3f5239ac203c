"""Pod-scale receiver: a ChannelizedBank's channels sharded over ranks.

Counterpart of ``openwebrx_tpu/parallel/pod.py`` (BASELINE config #5:
wideband IQ → PFB → 1000+ channels across N devices).  Each rank folds its
time slice of the block (``parallel/pfb.sharded_channelize``), receives its
slice of the channel axis from the re-shard, and runs the bank's chain on
those channels only.  Every state and param leaf whose leading axis is M
holds this rank's channels; every other leaf is replicated (the
reference's placement rule).  Banks are dense: every channel is a slot.
"""

from __future__ import annotations

import torch

from openwebrx_tpu_torch.parallel.mesh import AxisComm
from openwebrx_tpu_torch.parallel.pfb import sharded_channelize
from openwebrx_tpu_torch.runtime.chain import as_input_block, tree_map


def channel_slice(tree, m: int, lo: int, hi: int):
    """Leaves of ``tree`` whose leading axis is ``m`` → their rows [lo,
    hi); other leaves as they are."""
    def take(a):
        if torch.is_tensor(a) and a.dim() >= 1 and a.shape[0] == m:
            return a[lo:hi]
        return a
    return tree_map(take, tree)


def sharded_bank_step(bank, mesh, axis: str = "chan"):
    """The per-rank step of a dense ``ChannelizedBank`` over ``axis``.

    Returns ``(step, state, params_of, channels)``: ``step(state, params,
    x_local) -> (state, y, aux)`` takes this rank's time slice and returns
    its channels' results, ``state`` is this rank's share of
    ``bank.state`` (copied), ``params_of(chain_params)`` slices the bank's
    chain params for this rank, and ``channels`` is the rank's
    ``range`` of channel indices."""
    if bank.capacity is not None:
        raise ValueError("channel sharding takes a dense bank (capacity=None)")
    comm = AxisComm(mesh, axis)
    m, n = bank.m, comm.size
    if m % n or bank.channel_block % n:
        raise ValueError(f"m={m} / channel block={bank.channel_block} must "
                         f"divide over {n} ranks")
    lo, hi = comm.index * (m // n), (comm.index + 1) * (m // n)
    fold = sharded_channelize(mesh, axis, bank.prototype, m,
                              device=bank.device)
    chain = bank.chain

    def step(state, params, x_local):
        tail, chain_state = state
        tail, channels = fold(tail, x_local)
        chain_state, y, aux = chain.apply(chain_state, params, channels)
        return (tail, chain_state), y, aux

    state = tree_map(lambda a: a.clone() if torch.is_tensor(a) else a,
                     channel_slice(bank.state, m, lo, hi))
    return step, state, lambda p: channel_slice(p, m, lo, hi), range(lo, hi)


def shard_channelized_bank(bank, mesh, chan_axis: str = "chan"):
    """Returns ``(run, state)`` with ``state`` this rank's share of the
    bank's state.

    ``run(state, x) -> (state, y, aux)`` takes the whole block (as the
    reference's does), steps this rank's time slice, and returns this
    rank's channels' ``y`` and ``aux`` as device tensors
    (``gather_channels`` collects them).  Params come from the bank's
    program (``Program.current_params``) on each call, sliced for the rank.
    """
    step, state, params_of, _ = sharded_bank_step(bank, mesh, chan_axis)
    comm = AxisComm(mesh, chan_axis)
    slab = bank.block // comm.size
    lo = comm.index * slab

    def run(state, x):
        x = as_input_block(x, bank.block, True, bank.device)[lo:lo + slab]
        _idx, chain_params = bank.program.current_params()  # dense: slot indices unused
        return step(state, params_of(chain_params), x)

    return run, state


def gather_channels(y, mesh, axis: str = "chan"):
    """Every rank's channel slice of ``y`` (a tensor, or a tuple of them
    such as ADPCM's (bytes, stride states)), concatenated along the channel
    axis in rank order, on every rank."""
    comm = AxisComm(mesh, axis)

    def gather(t):
        g = comm.all_gather(t)
        return g.reshape(g.shape[0] * g.shape[1], *g.shape[2:])
    return tree_map(gather, y)
