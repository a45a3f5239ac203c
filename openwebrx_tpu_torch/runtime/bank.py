"""ChannelBank: N full-rate listener channels demodulated as one batch.

Counterpart of ``openwebrx_tpu/runtime/bank.py``.  All channels of one
mode share one ``ClientDemodulatorChain`` run over a leading batch axis of
``capacity`` slots; per-slot tuning (offset, squelch, passband, NR) is a
parameter array, so adding or retuning a listener never rebuilds anything.
Inactive slots park at 0 Hz and the host ignores their rows.  Unlike the
PFB bank (``runtime/channelized.py``) every slot filters the full input
rate, which serves dials that do not fit a filterbank channel.
"""

from __future__ import annotations

from math import gcd

import numpy as np
import torch

from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain, MODE_BANDPASS
from openwebrx_tpu_torch.models.stages import block_requirement, plan_block_size
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.chain import Program


class ChannelBank:
    """A bank of identical-mode channels on ``device``."""

    def __init__(self, in_rate: float, mode: str = "nfm", capacity: int = 16,
                 audio_rate: float = 12000.0, compression: str = "adpcm",
                 target_seconds: float = 0.1, block: int | None = None,
                 device="cuda"):
        self.in_rate = float(in_rate)
        self.mode = mode
        self.capacity = int(capacity)
        self.compression = compression
        self.chain = ClientDemodulatorChain(in_rate, audio_rate, mode, compression)
        self._offsets = np.zeros(capacity, np.float32)
        self._squelch = np.full(capacity, -150.0, np.float32)
        self._active = np.zeros(capacity, bool)
        lo, hi = MODE_BANDPASS[mode]
        self._low = np.full(capacity, float(lo))
        self._high = np.full(capacity, float(hi))
        self._nr = np.full(capacity, -100.0, np.float32)  # ≤ −100 ⇒ NR off
        spec = StreamSpec(Format.COMPLEX_FLOAT, in_rate)
        # `block` is the caller's device chunk; a chain whose own block
        # requirement exceeds it accumulates chunk_ratio chunks on the
        # device and dispatches every chunk_ratio-th one
        self.chunk_ratio = 1
        if block is not None:
            req = block_requirement(self.chain, spec)
            bank_block = block * req // gcd(block, req)
            self.chunk_ratio = bank_block // block
            self.block = bank_block
        else:
            self.block = plan_block_size(self.chain, spec, target_seconds)
        self._accum: list = []
        self.program = Program(self.chain, spec, self.block,
                               batch_shape=(capacity,), device=device)
        self.device = self.program.device
        self._push_params()

    # ------------------------------------------------------------- slots --
    def add_channel(self, offset_hz: float, squelch_db: float = -150.0) -> int:
        free = np.flatnonzero(~self._active)
        if len(free) == 0:
            raise RuntimeError("bank full — grow() first")
        slot = int(free[0])
        self._active[slot] = True
        self._offsets[slot] = offset_hz
        self._squelch[slot] = squelch_db
        self._push_params()
        return slot

    def remove_channel(self, slot: int):
        self._active[slot] = False
        self._offsets[slot] = 0.0
        self._squelch[slot] = -150.0
        self._push_params()

    def retune(self, slot: int, offset_hz: float):
        self._offsets[slot] = offset_hz
        self._push_params()

    def set_squelch(self, slot: int, level_db: float):
        self._squelch[slot] = level_db
        self._push_params()

    def set_bandpass(self, slot: int, low_hz: float, high_hz: float):
        """Per-listener passband."""
        self._low[slot] = low_hz
        self._high[slot] = high_hz
        self._push_params()

    def set_nr(self, slot: int, threshold_db: float):
        """Per-listener noise reduction; threshold ≤ −100 dB disables."""
        self._nr[slot] = threshold_db
        self._push_params()

    @property
    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self._active)

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    def _push_params(self):
        self.chain.selector.shift.set_rate(-self._offsets / self.in_rate)
        self.chain.selector.squelch.set_level(self._squelch)
        self.chain.selector.set_bandpass(self._low, self._high)
        self.chain.audio.noise_filter.set_threshold(self._nr)

    # ------------------------------------------------------------ stream --
    def feed_dispatch(self, xdev, to_host: bool = True):
        """Feed one device chunk (``block // chunk_ratio`` samples, complex64
        or packed pairs).  Returns the program's (Pending, None) when a full
        bank block was dispatched, else None (chunks concatenated on the
        device once chunk_ratio of them arrived)."""
        if self.chunk_ratio == 1:
            return self.program.dispatch(xdev, to_host=to_host)
        t = torch.as_tensor(xdev) if isinstance(xdev, np.ndarray) else xdev
        self._accum.append(t.to(self.device))
        if len(self._accum) < self.chunk_ratio:
            return None
        x = torch.cat(self._accum, dim=0)
        self._accum = []
        return self.program.dispatch(x, to_host=to_host)

    def process(self, iq_block):
        """iq_block (block,) complex64 → (audio (capacity, out_block), aux)
        as numpy.  The one block fans out to all slots inside the chain (the
        shift stage's (C,) phase broadcasts against the (B,) input)."""
        return self.program.process(iq_block)
