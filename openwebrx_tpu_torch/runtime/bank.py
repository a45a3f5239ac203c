"""ChannelBank: N full-rate listener channels demodulated as one batch.

Counterpart of ``openwebrx_tpu/runtime/bank.py``.  All channels of one
mode share one ``ClientDemodulatorChain`` run over a leading batch axis of
``capacity`` slots; per-slot tuning (offset, squelch, passband, NR) is a
parameter array, so adding or retuning a listener never rebuilds anything;
each change is made under the program's ``params_lock``, so a dispatch on
another thread sees all of it or none.
Inactive slots park at 0 Hz and the host ignores their rows.  Unlike the
PFB bank (``runtime/channelized.py``) every slot filters the full input
rate, which serves dials that do not fit a filterbank channel.

``SlotBank`` is what both banks share: the slot table, the push of its
controls into the chain, the feed and the stream calls, all through the
bank's one ``Program``.
"""

from __future__ import annotations

import contextlib
from math import gcd

import numpy as np
import torch

from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain, MODE_BANDPASS
from openwebrx_tpu_torch.models.stages import block_requirement, plan_block_size
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.chain import Pending, Program


class SlotBank:
    """A bank of slots of one mode's ``ClientDemodulatorChain``
    (``chain``), stepped as one batch by ``program``, the bank's one
    ``Program``: its block step, its params (rebuilt by the next dispatch
    after a setter moved the chain's params version) and its state.

    Per slot the bank keeps whether it is active and its squelch level,
    passband and NR threshold.  Every change is made under the program's
    ``params_lock`` and pushed there into the chain's setters, so a
    dispatch on another thread sees all of it or none.  A subclass adds the
    dial (``_push_dial``, ``dial_hz``) and how a retune may move a slot.

    The feed: ``chunk_ratio`` device chunks make a bank block, and
    ``delivery_stride`` bank blocks one delivery."""

    delivery_stride = 1

    def _init_slots(self, n: int, mode: str):
        self._active = np.zeros(n, bool)
        self._squelch = np.full(n, -150.0, np.float32)
        lo, hi = MODE_BANDPASS[mode]
        self._low = np.full(n, float(lo))
        self._high = np.full(n, float(hi))
        self._nr = np.full(n, -100.0, np.float32)       # ≤ −100 ⇒ NR off
        self._accum: list = []          # device chunks of the next bank block
        self._due: list = []            # pending bank blocks of the next delivery

    def _push_params(self):
        """The slot table → the chain's setters (each bumps the chain's
        params version)."""
        self._push_dial()
        self.chain.selector.squelch.set_level(self._squelch)
        self.chain.selector.set_bandpass(self._low, self._high)
        self.chain.audio.noise_filter.set_threshold(self._nr)

    @contextlib.contextmanager
    def _change(self):
        """A change of the slot table: made and pushed under the program's
        ``params_lock``."""
        with self.program.params_lock:
            yield
            self._push_params()

    # ------------------------------------------------------------- slots --
    def set_squelch(self, slot: int, level_db: float):
        with self._change():
            self._squelch[slot] = level_db

    def set_bandpass(self, slot: int, low_hz: float, high_hz: float):
        """Per-listener passband."""
        with self._change():
            self._low[slot] = low_hz
            self._high[slot] = high_hz

    def set_nr(self, slot: int, threshold_db: float):
        """Per-listener noise reduction; threshold ≤ −100 dB disables."""
        with self._change():
            self._nr[slot] = threshold_db

    def controls(self, slot: int) -> tuple[float, float, float, float]:
        """A slot's (passband low Hz, passband high Hz, squelch dB, NR
        threshold dB)."""
        return (float(self._low[slot]), float(self._high[slot]),
                float(self._squelch[slot]), float(self._nr[slot]))

    def has_free_slot(self) -> bool:
        return bool(np.any(~self._active))

    @property
    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self._active)

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    # ------------------------------------------------------------ stream --
    @property
    def state(self):
        """The program's streaming state."""
        return self.program.state

    @state.setter
    def state(self, state):
        self.program.state = state

    @property
    def blocks_per_delivery(self) -> int:
        """Device chunks fed between two deliveries."""
        return self.chunk_ratio * self.delivery_stride

    def dispatch(self, iq_block, to_host: bool = True):
        """Enqueue one bank block → (Pending, None) (``Program.dispatch``)."""
        return self.program.dispatch(iq_block, to_host=to_host)

    def fetch(self, pending: Pending, _unused=None):
        """Wait for a dispatched block and return (y, aux) as numpy."""
        return self.program.fetch(pending)

    def process(self, iq_block):
        """One bank block, synchronous: → (y, aux) as numpy.  The one block
        fans out to all slots inside the step."""
        return self.program.process(iq_block)

    def feed_dispatch(self, xdev, to_host: bool = True) -> list[Pending]:
        """Feed one device chunk (``block // chunk_ratio`` samples, complex64
        or packed pairs) → the pending results now due, in dispatch order:
        none while the chunks of a bank block (concatenated on the device)
        or the bank blocks of a delivery accumulate, else the
        ``delivery_stride`` bank blocks of one delivery."""
        if self.chunk_ratio > 1:
            t = torch.as_tensor(xdev) if isinstance(xdev, np.ndarray) else xdev
            self._accum.append(t.to(self.device))
            if len(self._accum) < self.chunk_ratio:
                return []
            xdev, self._accum = torch.cat(self._accum, dim=0), []
        self._due.append(self.program.dispatch(xdev, to_host=to_host)[0])
        if len(self._due) < self.delivery_stride:
            return []
        due, self._due = self._due, []
        return due


class ChannelBank(SlotBank):
    """A bank of identical-mode channels on ``device``."""

    def __init__(self, in_rate: float, mode: str = "nfm", capacity: int = 16,
                 audio_rate: float = 12000.0, compression: str = "adpcm",
                 target_seconds: float = 0.1, block: int | None = None,
                 device="cuda", graph: bool = True):
        self.in_rate = float(in_rate)
        self.mode = mode
        self.capacity = int(capacity)
        self.compression = compression
        self.chain = ClientDemodulatorChain(in_rate, audio_rate, mode, compression)
        self._offsets = np.zeros(capacity, np.float32)
        self._init_slots(capacity, mode)
        spec = StreamSpec(Format.COMPLEX_FLOAT, in_rate)
        # `block` is the caller's device chunk; a chain whose own block
        # requirement exceeds it accumulates chunk_ratio chunks on the
        # device and dispatches every chunk_ratio-th one
        self.chunk_ratio = 1
        if block is not None:
            req = block_requirement(self.chain, spec)
            self.block = block * req // gcd(block, req)
            self.chunk_ratio = self.block // block
        else:
            self.block = plan_block_size(self.chain, spec, target_seconds)
        self._push_params()
        self.program = Program(self.chain, spec, self.block,
                               batch_shape=(capacity,), device=device,
                               graph=graph)
        self.device = self.program.device

    def _push_dial(self):
        self.chain.selector.shift.set_rate(-self._offsets / self.in_rate)

    def dial_hz(self, slot: int) -> float:
        """A slot's dial: its offset from the device centre."""
        return float(self._offsets[slot])

    def add_channel(self, offset_hz: float, squelch_db: float = -150.0) -> int:
        with self._change():
            free = np.flatnonzero(~self._active)
            if len(free) == 0:
                raise RuntimeError("bank full — grow() first")
            slot = int(free[0])
            self._active[slot] = True
            self._offsets[slot] = offset_hz
            self._squelch[slot] = squelch_db
            return slot

    def remove_channel(self, slot: int):
        with self._change():
            self._active[slot] = False
            self._offsets[slot] = 0.0
            self._squelch[slot] = -150.0

    def retune(self, slot: int, offset_hz: float) -> int:
        """Move a slot's dial; the slot stays → ``slot``."""
        with self._change():
            self._offsets[slot] = offset_hz
            return slot
