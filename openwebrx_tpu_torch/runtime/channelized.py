"""ChannelizedBank: PFB front end + batched per-channel demod chains.

Counterpart of ``openwebrx_tpu/runtime/channelized.py``.  The polyphase
filterbank splits the wideband block into M critically-sampled channel
streams (``ops/channelizer.py``), the occupied channels are optionally
gathered into slots, and one ``ClientDemodulatorChain`` runs over all of
them as a batch.  A dial at frequency f maps to channel k = round(f·M/fs)
plus a fine shift of (f − k·fs/M) applied by the chain's selector.

The bank steps through a ``Program`` as ``ChannelBank`` does: its chain is
the filterbank front (``ChannelizeStage``: the PFB fold, the M-point FFT,
the slot gather) followed by the demodulator chain, and its block step is
``_raw_step``.  The streaming API mirrors the reference: ``dispatch()``
enqueues a block on the device and, with ``to_host``, starts the copies of
its results into pinned host memory without waiting; ``fetch()`` waits
for those copies and returns numpy; ``process()`` = fetch(dispatch()).
Results are the same host objects the reference bank returns: ``y =
(bytes uint8 (n, B/2), stride int32 (n, B/200))`` for ADPCM or int16
audio (n, B) otherwise, and ``aux = {"selector.squelch.power_db": (n,
windows) float32}``, plus ``"wfm.rds_tap.rds"`` (n, B_rds) complex64 in
WFM mode.  The state is (PFB tail, chain state), the params (slot →
channel index, chain params); the params are rebuilt and uploaded only
after a control changed, and a control may change from another thread
than the one dispatching.  As the reference compiles its step once, the
step runs over static buffers (``runtime/chain.py`` ``GraphStep``): on a
card every block from the second on is one CUDA graph replay.
"""

from __future__ import annotations

from math import gcd

import numpy as np
import torch

from openwebrx_tpu_torch import resolve_device
from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain
from openwebrx_tpu_torch.models.stages import block_requirement, plan_block_size
from openwebrx_tpu_torch.ops import channelizer as pfb
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.bank import SlotBank
from openwebrx_tpu_torch.runtime.chain import Chain, Program, Stage, digest


class ChannelizeStage(Stage):
    """The filterbank front of a bank's step: a wideband block → the PFB
    fold and M-point FFT (``ops/channelizer.py``) → (M, block / M) channel
    rows, or in a gathered bank (``gathered``) the rows of the slots'
    channels.  State: the PFB tail.  Params: the slot → channel index
    (``set_channels``)."""

    name = "pfb"

    def __init__(self, m: int, prototype: np.ndarray, gathered: bool,
                 device: torch.device):
        self.m = m
        self.prototype = torch.as_tensor(prototype, device=device)
        self.gathered = gathered
        self.taps_per_phase = len(prototype) // m
        self._chan = np.arange(m, dtype=np.int64)

    def set_channels(self, chan: np.ndarray):
        """The slot → channel index (a copy is kept)."""
        self._chan = np.array(chan, np.int64)
        self._bump()

    def plan(self, in_spec, block: int):
        return in_spec.with_rate(in_spec.rate / self.m), block // self.m

    def init_state(self, batch_shape, device):
        return pfb.channelizer_init(self.m, self.taps_per_phase, device=device)

    def params(self, device):
        return torch.as_tensor(self._chan, device=device)

    def apply(self, tail, idx, x):
        tail, channels = pfb.channelize(tail, self.prototype, x, self.m,
                                        device=self.prototype.device)
        if self.gathered:
            channels = channels.index_select(0, idx)
        return tail, channels, {}

    def signature(self):
        return ("pfb", self.m, self.taps_per_phase, self.gathered)


class _BankChain(Chain):
    """[front, demodulator chain] stepped by their bank's ``_raw_step``,
    whose results carry the demodulator chain's own aux keys."""

    def __init__(self, bank: "ChannelizedBank"):
        super().__init__([bank.front, bank.chain])
        self.bank = bank

    def apply(self, state, params, x):
        return self.bank._raw_step(state, params, x)


class ChannelizedBank(SlotBank):
    """All M channels (or ``capacity`` gathered slots) demodulated with one
    mode's chain."""

    def __init__(self, in_rate: float, m: int, mode: str = "usb",
                 audio_rate: float = 12000.0, compression: str = "none",
                 taps_per_phase: int = 16, target_seconds: float = 0.1,
                 block: int | None = None, capacity: int | None = None,
                 delivery_stride: int = 1, device="cuda", graph: bool = True):
        device = resolve_device(device)
        self.in_rate = float(in_rate)
        self.m = int(m)
        self.mode = mode
        self.compression = compression
        # capacity=None → dense: all M channels demodulate.  capacity=N →
        # slot-gathered: the N occupied channel streams are gathered out of
        # the PFB before the chains, so chain work scales with live dials
        self.capacity = int(capacity) if capacity else None
        self.delivery_stride = max(1, int(delivery_stride))
        self._n = self.capacity or self.m       # chain batch size
        self.channel_rate = self.in_rate / self.m
        self.prototype = pfb.design_prototype(self.m, taps_per_phase)
        self.taps_per_phase = taps_per_phase
        self.chain = ClientDemodulatorChain(self.channel_rate, audio_rate,
                                            mode, compression)
        spec = StreamSpec(Format.COMPLEX_FLOAT, self.channel_rate)
        # `block` is the caller's device chunk; the bank's own block must be
        # a multiple of it and of m × the chain's requirement, and chunks
        # accumulate until one bank block is complete
        self.chunk_ratio = 1
        if block is not None:
            req = block_requirement(self.chain, spec) * self.m
            self.block = block * req // gcd(block, req)
            self.chunk_ratio = self.block // block
            self.channel_block = self.block // self.m
        else:
            self.channel_block = plan_block_size(self.chain, spec,
                                                 target_seconds)
            self.block = self.channel_block * self.m

        n = self._n
        self._init_slots(n, mode)
        self._chan = np.zeros(n, np.int32)              # slot → PFB channel
        self._fine = np.zeros(n, np.float32)            # Hz within channel
        if self.capacity is None:
            self._chan = np.arange(n, dtype=np.int32)   # slot s ≡ channel s
        self.front = ChannelizeStage(self.m, self.prototype,
                                     self.capacity is not None, device)
        self._push_params()
        self.program = Program(_BankChain(self),
                               StreamSpec(Format.COMPLEX_FLOAT, self.in_rate),
                               self.block, batch_shape=(n,), device=device,
                               graph=graph)
        self.device = self.program.device

    def _raw_step(self, state, params, x):
        """The bank's block step: the front's channel rows through the
        demodulator chain."""
        (tail, chain_state), (idx, chain_params) = state, params
        tail, channels, _ = self.front.apply(tail, idx, x)
        chain_state, y, aux = self.chain.apply(chain_state, chain_params,
                                               channels)
        return (tail, chain_state), y, aux

    def _push_dial(self):
        self.chain.selector.shift.set_rate(-self._fine / self.channel_rate)
        self.front.set_channels(self._chan)

    # ------------------------------------------------------------- tuning --
    def channel_for(self, freq_offset_hz: float) -> tuple[int, float]:
        """Map a frequency offset (from device center) to (channel index,
        fine offset inside that channel)."""
        k = int(round(freq_offset_hz * self.m / self.in_rate)) % self.m
        center = pfb.channel_frequencies(self.m, self.in_rate)[k]
        return k, freq_offset_hz - center

    def channel_in_use(self, k: int) -> bool:
        """Is PFB channel k already serving an active slot?"""
        return bool(np.any(self._active & (self._chan == k)))

    def dial_hz(self, s: int) -> float:
        """A slot's dial: its channel's centre plus its fine offset."""
        k = int(self._chan[s])
        return float(pfb.channel_frequencies(self.m, self.in_rate)[k]
                     + self._fine[s])

    def can_retune(self, s: int, offset_hz: float) -> bool:
        """Can slot s take this dial and stay in the filterbank: its
        passband fits the dial's channel, and that channel is the slot's
        own or free (always, in a gathered bank, whose slots share
        channels)?"""
        k, _ = self.channel_for(offset_hz)
        own = self.capacity is not None or int(self._chan[s]) == k
        return (self.fits(offset_hz, float(self._low[s]), float(self._high[s]))
                and (own or not self.channel_in_use(k)))

    def assign(self, freq_offset_hz: float, squelch_db: float = -150.0) -> int:
        """Activate a slot on the channel containing the given frequency;
        returns the slot index (== channel index in dense mode).  In
        slot-gathered mode several slots may share one PFB channel."""
        with self._change():
            k, fine = self.channel_for(freq_offset_hz)
            if self.capacity is None:
                if self._active[k]:
                    raise ValueError(f"PFB channel {k} already occupied")
                s = k
            else:
                free = np.flatnonzero(~self._active)
                if len(free) == 0:
                    raise ValueError("PFB bank full — all slots taken")
                s = int(free[0])
                self._chan[s] = k
            self._active[s] = True
            self._fine[s] = fine
            self._squelch[s] = squelch_db
            return s

    def _clear(self, s: int):
        self._active[s] = False
        self._fine[s] = 0.0
        self._squelch[s] = -150.0
        if self.capacity is not None:
            self._chan[s] = 0       # parked (inactive slots never conflict)

    def release(self, s: int):
        with self._change():
            self._clear(s)

    remove_channel = release

    def retune(self, s: int, offset_hz: float) -> int:
        """Move a slot to a new frequency; the dial may land in another PFB
        channel.  Returns the (possibly new) slot index."""
        with self._change():
            new_k, fine = self.channel_for(offset_hz)
            if new_k == int(self._chan[s]) or self.capacity is not None:
                # the same channel, or a gathered bank: channels are
                # shareable, just remap the slot
                self._chan[s] = new_k
                self._fine[s] = fine
                return s
            # dense mode: the slot index IS the channel index, so move the slot
            if self._active[new_k]:
                raise ValueError(f"PFB channel {new_k} already occupied")
            sq, lo, hi, nr = (self._squelch[s], self._low[s], self._high[s],
                              self._nr[s])
            self._clear(s)
            self._active[new_k] = True
            self._fine[new_k] = fine
            self._squelch[new_k], self._nr[new_k] = sq, nr
            self._low[new_k], self._high[new_k] = lo, hi
            return new_k

    def fits(self, freq_offset_hz: float, low_hz: float, high_hz: float,
             margin: float = 0.4) -> bool:
        """Can this dial serve from the critically-sampled PFB?  The whole
        passband (fine offset + bandpass) must sit inside ±margin·channel
        rate of the channel centre."""
        _, fine = self.channel_for(freq_offset_hz)
        half = margin * self.channel_rate
        return (fine + low_hz) >= -half and (fine + high_hz) <= half

    @property
    def active_channels(self) -> np.ndarray:
        """PFB channel indices of the active slots."""
        return self._chan[self._active]

    def signature(self):
        return ("channelized", self.m, self.mode, self.channel_block,
                self.capacity, digest(self.prototype))
