"""ChannelizedBank: PFB front end + batched per-channel demod chains.

Counterpart of ``openwebrx_tpu/runtime/channelized.py``.  The polyphase
filterbank splits the wideband block into M critically-sampled channel
streams (``ops/channelizer.py``), the occupied channels are optionally
gathered into slots, and one ``ClientDemodulatorChain`` runs over all of
them as a batch.  A dial at frequency f maps to channel k = round(f·M/fs)
plus a fine shift of (f − k·fs/M) applied by the chain's selector.

The streaming API mirrors the reference: ``dispatch()`` enqueues a block on
the device and, with ``to_host``, starts the copies of its results into
pinned host memory without waiting; ``fetch()`` waits for those copies and
returns numpy; ``process()`` = fetch(dispatch()).  Results are the same
host objects the reference bank returns: ``y = (bytes uint8 (n, B/2),
stride int32 (n, B/200))`` for ADPCM or int16 audio (n, B) otherwise, and
``aux = {"selector.squelch.power_db": (n, windows) float32}``, plus
``"wfm.rds_tap.rds"`` (n, B_rds) complex64 in WFM mode.  Params
(fine shifts, squelch levels, passbands, NR thresholds) are rebuilt and
uploaded only after a control changed.
"""

from __future__ import annotations

from math import gcd

import numpy as np
import torch

from openwebrx_tpu_torch import resolve_device
from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain, MODE_BANDPASS
from openwebrx_tpu_torch.models.stages import block_requirement, plan_block_size
from openwebrx_tpu_torch.ops import channelizer as pfb
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.chain import (
    Pending, as_input_block, digest, finish_fetch, start_fetch)


class ChannelizedBank:
    """All M channels (or ``capacity`` gathered slots) demodulated with one
    mode's chain."""

    def __init__(self, in_rate: float, m: int, mode: str = "usb",
                 audio_rate: float = 12000.0, compression: str = "none",
                 taps_per_phase: int = 16, target_seconds: float = 0.1,
                 block: int | None = None, capacity: int | None = None,
                 delivery_stride: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.in_rate = float(in_rate)
        self.m = int(m)
        self.mode = mode
        self.compression = compression
        # capacity=None → dense: all M channels demodulate.  capacity=N →
        # slot-gathered: the N occupied channel streams are gathered out of
        # the PFB before the chains, so chain work scales with live dials
        self.capacity = int(capacity) if capacity else None
        self.delivery_stride = max(1, int(delivery_stride))
        self._out_accum: list = []
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
            bank_block = block * req // gcd(block, req)
            self.chunk_ratio = bank_block // block
            self.block = bank_block
            self.channel_block = bank_block // self.m
        else:
            self.channel_block = plan_block_size(self.chain, spec,
                                                 target_seconds)
            self.block = self.channel_block * self.m
        self._accum: list = []
        self.chain.plan(spec, self.channel_block)

        n = self._n
        self._chan = np.zeros(n, np.int32)              # slot → PFB channel
        self._fine = np.zeros(n, np.float32)            # Hz within channel
        self._squelch = np.full(n, -150.0, np.float32)
        self._active = np.zeros(n, bool)
        lo, hi = MODE_BANDPASS[mode]
        self._low = np.full(n, float(lo))
        self._high = np.full(n, float(hi))
        self._nr = np.full(n, -100.0, np.float32)       # ≤ −100 ⇒ NR off
        if self.capacity is None:
            self._chan = np.arange(n, dtype=np.int32)   # slot s ≡ channel s
        self._params_dirty = True
        self._params_cache = None
        self._prototype = torch.as_tensor(self.prototype, device=self.device)
        self.state = (pfb.channelizer_init(self.m, taps_per_phase,
                                           device=self.device),
                      self.chain.init_state((n,), self.device))

    def _raw_step(self, state, params, x):
        tail, chain_state = state
        idx, chain_params = params
        tail, channels = pfb.channelize(tail, self._prototype, x, self.m,
                                        device=self.device)
        if self.capacity is not None:
            channels = channels.index_select(0, idx)
        chain_state, y, aux = self.chain.apply(chain_state, chain_params,
                                               channels)
        return (tail, chain_state), y, aux

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

    def has_free_slot(self) -> bool:
        return bool(np.any(~self._active))

    def assign(self, freq_offset_hz: float, squelch_db: float = -150.0) -> int:
        """Activate a slot on the channel containing the given frequency;
        returns the slot index (== channel index in dense mode).  In
        slot-gathered mode several slots may share one PFB channel."""
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
        self._params_dirty = True
        return s

    def release(self, s: int):
        self._active[s] = False
        self._fine[s] = 0.0
        self._squelch[s] = -150.0
        if self.capacity is not None:
            self._chan[s] = 0       # parked (inactive slots never conflict)
        self._params_dirty = True

    def remove_channel(self, s: int):
        self.release(s)

    def retune(self, s: int, offset_hz: float) -> int:
        """Move a slot to a new frequency; the dial may land in another PFB
        channel.  Returns the (possibly new) slot index."""
        new_k, fine = self.channel_for(offset_hz)
        cur_k = int(self._chan[s])
        if new_k == cur_k:
            self._fine[s] = fine
            self._params_dirty = True
            return s
        if self.capacity is not None:
            # gathered mode: channels are shareable, just remap the slot
            self._chan[s] = new_k
            self._fine[s] = fine
            self._params_dirty = True
            return s
        # dense mode: the slot index IS the channel index, so move the slot
        if self._active[new_k]:
            raise ValueError(f"PFB channel {new_k} already occupied")
        sq, lo, hi, nr = (self._squelch[s], self._low[s], self._high[s],
                          self._nr[s])
        self.release(s)
        self._active[new_k] = True
        self._fine[new_k] = fine
        self._squelch[new_k], self._nr[new_k] = sq, nr
        self._low[new_k], self._high[new_k] = lo, hi
        self._params_dirty = True
        return new_k

    def set_squelch(self, s: int, level_db: float):
        self._squelch[s] = level_db
        self._params_dirty = True

    def set_nr(self, s: int, threshold_db: float):
        self._nr[s] = threshold_db
        self._params_dirty = True

    def set_bandpass(self, s: int, low_hz: float, high_hz: float):
        self._low[s], self._high[s] = low_hz, high_hz
        self._params_dirty = True

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

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    def _params(self):
        """Push the control arrays into the chain and rebuild the device
        params only when something changed since the last dispatch."""
        if self._params_dirty or self._params_cache is None:
            self.chain.selector.shift.set_rate(-self._fine / self.channel_rate)
            self.chain.selector.squelch.set_level(self._squelch)
            self.chain.selector.set_bandpass(self._low, self._high)
            self.chain.audio.noise_filter.set_threshold(self._nr)
            idx = torch.as_tensor(self._chan.astype(np.int64),
                                  device=self.device)
            self._params_cache = (idx, self.chain.params(self.device))
            self._params_dirty = False
        return self._params_cache

    # ------------------------------------------------------------- stream --
    def _as_block(self, iq) -> torch.Tensor:
        """(block,) complex64, or packed (block, 2) float32 / int16 / uint8
        (numpy or tensor) → (block,) complex64 on the bank's device."""
        return as_input_block(iq, self.block, True, self.device)

    def pack_input(self, iq_block: np.ndarray) -> np.ndarray:
        """Host complex block → packed (block, 2) float32 (zero-copy)."""
        x = np.ascontiguousarray(iq_block, dtype=np.complex64)
        return x.view(np.float32).reshape(x.shape + (2,))

    def dispatch(self, iq_block, to_host: bool = True):
        """Enqueue one bank block → (Pending, None).  With ``to_host`` the
        results' copies into pinned host memory start at once; fetch()
        waits for them."""
        x = self._as_block(iq_block)
        self.state, y, aux = self._raw_step(self.state, self._params(), x)
        return start_fetch(y, aux, self.device, to_host), None

    def feed_dispatch(self, xdev, to_host: bool = True):
        """Feed one device chunk.  Returns the pending result when a full
        bank block was dispatched, else None (chunks buffered until
        chunk_ratio arrived).  With ``delivery_stride`` K > 1, K bank blocks
        are dispatched before one (list of K pendings, K) comes back, for
        fetch_many."""
        if self.chunk_ratio == 1:
            x = xdev
        else:
            self._accum.append(self._as_chunk(xdev))
            if len(self._accum) < self.chunk_ratio:
                return None
            x = torch.cat(self._accum, dim=0)
            self._accum = []
        if self.delivery_stride <= 1:
            return self.dispatch(x, to_host=to_host)
        pending, _ = self.dispatch(x, to_host=to_host)
        self._out_accum.append(pending)
        if len(self._out_accum) < self.delivery_stride:
            return None
        joined, self._out_accum = self._out_accum, []
        return joined, self.delivery_stride

    def _as_chunk(self, xdev) -> torch.Tensor:
        t = torch.as_tensor(xdev) if isinstance(xdev, np.ndarray) else xdev
        return t.to(self.device)

    def fetch(self, pending: Pending, _unused=None):
        """Wait for a dispatched block and return (y, aux) as numpy."""
        return finish_fetch(pending)

    def fetch_many(self, joined, n: int):
        """Results of a delivery-stride batch, in dispatch order."""
        return [self.fetch(p) for p in joined[:n]]

    def process(self, iq_block):
        """One block, synchronous: → (y, aux) as numpy."""
        return self.fetch(*self.dispatch(iq_block))

    def signature(self):
        return ("channelized", self.m, self.mode, self.channel_block,
                self.capacity, digest(self.prototype))
