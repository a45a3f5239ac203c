"""DeviceRuntime: one SDR device's compute loop on a CUDA card.

Counterpart of ``openwebrx_tpu/runtime/device.py``, with its names
(``BANK_BUCKET``, ``BUCKET_CHAIN_MODE``, ``SecondaryBank``, the handles,
``DeviceRuntime``) and its routing decisions, decision for decision: which
bank, slot and PFB channel a dial takes, when it falls back to a full-rate
bank and when it is re-admitted to the filterbank.  ONE thread drains the
source's IQ blocks, runs the shared waterfall program and every
mode-bucketed bank on each block, and fans the results out to subscriber
callbacks (called on that thread: they must be quick or enqueue):

  waterfall(payload bytes)               per waterfall subscriber
  channel handle: audio(bytes, hd), smeter(float dB), rds events

What differs from the reference is mechanism only:

* A block goes to the card once, through a pinned staging buffer taken
  fresh for that block; uint8 and int16 wire samples go up as they are and
  become float on the card.  Every program gets that one device block.
* Every bank and program runs its block step over static buffers
  (``runtime/chain.py`` ``GraphStep``, the counterpart of the reference's
  jitted step): on a card its first block runs eagerly, its second is
  captured as a CUDA graph and every later block is one replay.  A
  capture or replay failure raises; the runtime never asks for the eager
  step (``graph=False``), which only comparisons reach.
* Every program is dispatched without fetching; then the copies of all of
  the block's results (waterfall, every bank, every block of a
  delivery-stride batch) start into pinned host memory behind ONE CUDA
  event, which completion waits on.  The reference's cross-program join of
  fused int32 buffers and its transport keepalive (``runtime/keepalive.py``)
  were tunnel workarounds and are not ported.
* Secondary banks and handles take the block already on the card; the
  secondary FFT rows are ADPCM-encoded there before the fetch.
* Host pieces (text decoders, subprocess pipelines, file storage, metadata
  parsers) are looked up by the names in ``HOST_NAMES``: from the port's
  own host modules (``PORT_HOST``, each imported when first used), or from
  a namespace passed as ``host=``, which overrides them all.  A handle
  whose mode needs a name the host lacks raises ``LookupError`` naming it
  when opened.  Channels, banks and the waterfall need nothing from it.
* The loop's gauges (blocks, proc_block_ms, samples_per_s,
  realtime_factor) go to ``core.metrics`` as ``device.<id>.<name>``, as
  in the reference, and are kept in ``DeviceRuntime.gauges`` too;
  ``proc_block_ms`` is the last block's own time, its dispatch and its
  completion.
* Spans: the runtime keeps a log of timed spans (``core.metrics``
  ``SpanLog``, registered as ``device.<id>.span.<name>``; ``spans``),
  recorded where the work happens.  A block's are ``read`` (the source's
  read that returned it, or one that timed out), ``dispatch`` (with
  ``upload``, and each block step's ``eager`` first block and
  ``capture``), ``hold`` (from the end of its dispatch until the loop
  takes it off its queue; caused by the read that ended it) and
  ``complete`` (with ``fetch``, the wait on its one event, and
  ``deliver``), each with the block's number; a control call's are
  ``control`` (with ``lock``, the wait on the runtime's lock) and
  ``apply`` (from its return to the start of the dispatch of the first
  block whose step runs with it), each with the change's number; set-up's
  are ``build``, ``bank`` and ``kernels``.  While a torch.profiler
  session records, every span but ``hold`` and ``apply`` is also an
  ``owrx.<name>`` range of its trace.

A source is duck-typed: the runtime uses its ``id``, ``get_sample_rate()``,
``block_size``, ``start()`` and ``read_block(timeout)`` (a (n,) complex
block or packed (n, 2) float32 / int16 / uint8 pairs, or None).
"""

from __future__ import annotations

import base64
import concurrent.futures
import functools
import importlib
import itertools
import json
import logging
import math
import os
import tempfile
import threading
import time
from collections import deque
from math import gcd

import numpy as np
import torch

from openwebrx_tpu_torch import kernels, resolve_device
from openwebrx_tpu_torch.core.metrics import Metrics, SpanLog, current_span
from openwebrx_tpu_torch.models.analog import WFm
from openwebrx_tpu_torch.models.digital_voice import DV_DECODERS, DV_FACTORY
from openwebrx_tpu_torch.models.receiver import (
    MODE_BANDPASS, ClientDemodulatorChain, FftChain)
from openwebrx_tpu_torch.models.secondary import IF_RATE, SECONDARY_FACTORY, CwChain
from openwebrx_tpu_torch.models.selector import Selector
from openwebrx_tpu_torch.models.stages import (
    RdsTapStage, block_requirement, plan_block_size)
from openwebrx_tpu_torch.ops import adpcm
from openwebrx_tpu_torch.ops.adpcm import SyncFramer
from openwebrx_tpu_torch.ops.channelizer import channel_frequencies
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime.bank import ChannelBank
from openwebrx_tpu_torch.runtime.chain import (
    Pending, Program, as_input_block, finish_fetch, start_fetches)
from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank

logger = logging.getLogger(__name__)

# modes sharing a chain structure share a bank (lsb/usb/cw are all SSB
# chains; their per-channel bandpasses differ, which the bank supports)
BANK_BUCKET = {
    "nfm": "nfm", "am": "am", "sam": "sam", "wfm": "wfm",
    "lsb": "ssb", "usb": "ssb", "cw": "ssb",
    "rawam": "rawam", "usbd": "usbd",
    # raw synchronous AM shares the SAm chain; its wide ±10 kHz bandpass
    # is per-channel state
    "rawsam": "sam",
}
BUCKET_CHAIN_MODE = {"nfm": "nfm", "am": "am", "sam": "sam", "wfm": "wfm",
                     "ssb": "usb", "rawam": "rawam", "usbd": "usbd"}

# The host objects the runtime uses, each with the module (of the port, and
# of the reference package under the same name) that defines it
HOST_NAMES = {
    "VaricodeDecoder": "digimodes.psk", "dbpsk_bits": "digimodes.psk",
    "RttyFramer": "digimodes.rtty",
    "CwDecoder": "digimodes.cw", "CwSkimmer": "digimodes.cw",
    "SitorBDecoder": "digimodes.sitor", "NavtexDecoder": "digimodes.sitor",
    "DscDecoder": "digimodes.dsc",
    "SstvDecoder": "services.sstv",
    "FaxDecoder": "services.fax", "convert_to_png": "services.fax",
    "Storage": "core.storage",
    "SubprocessPipeline": "services.pipeline",
    "MetaParser": "services.meta",
    "DrmStatusMonitor": "services.exec_meta", "DabAfc": "services.exec_meta",
    "DabMetaParser": "services.exec_meta", "HdrMetaParser": "services.exec_meta",
    "hdradio": "services.hdradio",      # the module; optional (in-process HD Radio)
    "M17Decoder": "digimodes.m17", "DmrDecoder": "digimodes.dmr",
    "YsfDecoder": "digimodes.ysf", "DstarDecoder": "digimodes.dstar",
    "NxdnDecoder": "digimodes.nxdn",
    "RdsDecoder": "digimodes.rds", "RdsParser": "services.toolbox",
}

# The runtime's span names (``DeviceRuntime.spans``) → their outcomes
RUNTIME_SPANS = {"build": (), "bank": (), "kernels": (),
                 "read": ("block", "timeout"), "dispatch": (), "upload": (),
                 "eager": (), "capture": (), "hold": (), "complete": (), "fetch": (),
                 "deliver": (), "control": (), "lock": (), "apply": ()}


class _PortHost:
    """The port's own objects under ``HOST_NAMES``: ``PORT_HOST.<name>``
    imports ``openwebrx_tpu_torch.<module>`` on first use (a module entry,
    such as ``hdradio``, is the module itself)."""

    def __getattr__(self, name):
        module = HOST_NAMES.get(name)
        if module is None:
            raise AttributeError(name)
        mod = importlib.import_module(f"openwebrx_tpu_torch.{module}")
        return mod if module.endswith("." + name) else getattr(mod, name)


PORT_HOST = _PortHost()


def host_names(host, *names, what: str):
    """The objects ``names`` from the ``host`` namespace (``PORT_HOST``
    when None); LookupError naming every missing one (``what`` says who
    needs them)."""
    if host is None:
        host = PORT_HOST
    missing = [n for n in names if getattr(host, n, None) is None]
    if missing:
        raise LookupError(f"{what} needs {', '.join(missing)} from "
                          f"DeviceRuntime(host=...)")
    return [getattr(host, n) for n in names]


class _Chunks:
    """Complex samples (host or device, any length) → whole blocks of
    ``block`` samples on ``device``: a handle's own cadence, independent
    of the device block.  Blocks are fresh tensors (the inputs are
    copied), so a source may reuse its buffers."""

    def __init__(self, block: int, device: torch.device):
        self.block, self.device = block, device
        self._parts: list[torch.Tensor] = []
        self._n = 0

    def push(self, x):
        """Add samples; yield every block now complete."""
        t = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
        self._parts.append(t.to(self.device, torch.complex64))
        self._n += t.shape[-1]
        while self._n >= self.block:
            buf = torch.cat(self._parts)
            chunk, rest = buf[: self.block], buf[self.block:]
            self._parts = [rest] if len(rest) else []
            self._n = len(rest)
            yield chunk


class SecondaryBank:
    """All same-mode secondary digimode listeners of a device share ONE
    batched Program: N PSK31 cursors are N rows of a (N,)-batched chain,
    their offsets and carriers parameter arrays, so attaching a listener
    rebuilds nothing (growing beyond capacity does: capacity doubles).  The
    host bits→text decoders stay per handle.  ``runtime`` needs
    ``in_rate``, ``device`` and ``host``."""

    def __init__(self, runtime: "DeviceRuntime", mode: str, capacity: int = 2):
        self.runtime = runtime
        self.device = resolve_device(runtime.device)
        self.mode = f"bank:{mode}"
        self.secondary_mode = mode
        self.capacity = int(capacity)
        self.chain = SECONDARY_FACTORY[mode](runtime.in_rate)
        self._offsets = np.zeros(self.capacity, np.float32)
        # chains with a built-in subcarrier (SSTV/FAX park the fine shift
        # at 1900 Hz) keep that as the per-slot default
        fine = getattr(self.chain, "fine_shift", None)
        self._default_carrier = 0.0
        if fine is not None:
            self._default_carrier = -float(np.asarray(fine._rate)) * IF_RATE
        self._carriers = np.full(self.capacity, self._default_carrier,
                                 np.float32)
        self._active = np.zeros(self.capacity, bool)
        self.members: list["SecondaryHandle | None"] = [None] * self.capacity
        self._build_program()

    def _build_program(self):
        spec = StreamSpec(Format.COMPLEX_FLOAT, self.runtime.in_rate)
        self.block = plan_block_size(self.chain, spec, 0.1)
        self._push_params()
        self.program = Program(self.chain, spec, self.block,
                               batch_shape=(self.capacity,), device=self.device)
        self._chunks = _Chunks(self.block, self.device)

    def _push_params(self):
        self.chain.selector.shift.set_rate(-self._offsets / self.runtime.in_rate)
        fine = getattr(self.chain, "fine_shift", None)
        if fine is not None:
            fine.set_rate(-self._carriers / IF_RATE)

    def attach(self, handle: "SecondaryHandle", offset_hz: float) -> int:
        free = np.flatnonzero(~self._active)
        if len(free) == 0:
            self._grow()
            free = np.flatnonzero(~self._active)
        slot = int(free[0])
        self._active[slot] = True
        self._offsets[slot] = offset_hz
        self._carriers[slot] = self._default_carrier
        self.members[slot] = handle
        self._push_params()
        return slot

    def detach(self, handle: "SecondaryHandle"):
        if handle.slot is not None and self.members[handle.slot] is handle:
            self._active[handle.slot] = False
            self.members[handle.slot] = None
            self._offsets[handle.slot] = 0.0
            self._push_params()
        if not self._active.any():
            drop = getattr(self.runtime, "_drop_secondary_bank", None)
            if drop is not None:
                drop(self)

    def _grow(self):
        """Double capacity: a new program, whose chain state restarts (the
        host text decoders carry on)."""
        new_cap = self.capacity * 2
        self._offsets = np.resize(self._offsets, new_cap)
        self._carriers = np.resize(self._carriers, new_cap)
        self._offsets[self.capacity:] = 0.0
        self._carriers[self.capacity:] = self._default_carrier
        self._active = np.concatenate(
            [self._active, np.zeros(self.capacity, bool)])
        self.members = self.members + [None] * self.capacity
        self.capacity = new_cap
        self._build_program()

    def set_offset(self, slot: int, offset_hz: float):
        self._offsets[slot] = offset_hz
        self._push_params()

    def set_carrier(self, slot: int, carrier_hz: float):
        self._carriers[slot] = carrier_hz
        self._push_params()

    def feed(self, block) -> int:
        """Complex samples (the device block in the runtime) → every
        complete bank block through the program; each member gets its
        row, and its secondary FFT rows as wire payloads (encoded on the
        device) when it has an ``fft_cb``.  Returns the bank blocks run."""
        ran = 0
        for chunk in self._chunks.push(block):
            ran += 1
            pending, _ = self.program.dispatch(chunk, to_host=False)
            rows = next((r for k, r in pending.aux.items()
                         if k.endswith("secondary_fft.rows")), None)
            members = [(int(s), self.members[s]) for s in np.flatnonzero(self._active)
                       if self.members[s] is not None]
            want = [s for s, h in members if h.fft_cb is not None]
            wire = {}
            if rows is not None and want:
                sel = torch.as_tensor(want, device=self.device)
                wire["rows"] = adpcm.encode_fft_rows(rows.index_select(0, sel))
            y, wire = finish_fetch(start_fetches([Pending(pending.y, wire)],
                                                 self.device)[0])
            payloads = {}
            if "rows" in wire:
                nb = adpcm.wire_bytes_per_row(rows.shape[-1])
                for i, s in enumerate(want):
                    payloads[s] = [r[:nb].tobytes() for r in wire["rows"][i]]
            for s, handle in members:
                handle._deliver(y[s], payloads.get(s))
        return ran


class SecondaryHandle:
    """A digimode decoder attached to a listener's frequency: a slot in the
    device's per-mode SecondaryBank, with its host bits→text decoder."""

    def __init__(self, runtime: "DeviceRuntime", mode: str, offset_hz: float,
                 bank: "SecondaryBank | None" = None):
        self.runtime = runtime
        self.mode = mode
        self.text_cb = None
        self.fft_cb = None            # secondary FFT rows (wire payloads)
        self.slot = None
        # standalone use: own single-slot bank
        self.bank = bank if bank is not None \
            else SecondaryBank(runtime, mode, capacity=1)
        # the host decoder first: a missing host name leaves no slot taken
        self._decoder = self._make_decoder()
        self.slot = self.bank.attach(self, offset_hz)

    @property
    def chain(self):
        return self.bank.chain

    def _need(self, *names):
        return host_names(getattr(self.runtime, "host", None), *names,
                          what=f"secondary mode {self.mode!r}")

    def _make_decoder(self):
        mode = self.mode
        if mode.startswith("bpsk"):
            varicode, dbpsk_bits = self._need("VaricodeDecoder", "dbpsk_bits")
            vd = varicode()
            self._last_symbol = None

            def decode(symbols):
                symbols = np.asarray(symbols)
                if self._last_symbol is not None:
                    symbols = np.concatenate([[self._last_symbol], symbols])
                self._last_symbol = symbols[-1] if len(symbols) else None
                return vd.decode(dbpsk_bits(symbols))
            return decode
        if mode.startswith("rtty"):
            framer = self._need("RttyFramer")[0]()
            return lambda symbols: framer.decode(
                (np.asarray(symbols).real > 0).astype(np.uint8))
        if mode == "cwdecoder":
            cw = self._need("CwDecoder")[0](CwChain.ENV_RATE)
            return lambda env: cw.decode(np.asarray(env))
        if mode == "cwskimmer":
            skimmer = self._need("CwSkimmer")[0](self.chain.bin_hz,
                                                 self.chain.env_rate)

            def decode(frames):
                # the reference csdr-cwskimmer line format '<freq>:<text>',
                # freq relative to the passband centre
                return "".join(f"{int(freq)}:{text}\n" for freq, text
                               in skimmer.process(np.asarray(frames)))
            return decode
        if mode == "sitorb":
            sitor = self._need("SitorBDecoder")[0]()
            return lambda symbols: sitor.feed_bits(
                (np.asarray(symbols).real > 0).astype(np.uint8))
        if mode in ("navtex", "dsc"):
            events: list[dict] = []
            inner = self._need("NavtexDecoder" if mode == "navtex"
                               else "DscDecoder")[0](events.append)

            def decode(symbols):
                inner.feed_bits((np.asarray(symbols).real > 0).astype(np.uint8))
                out = "".join(json.dumps(m) + "\n" for m in events)
                events.clear()
                return out
            return decode
        if mode in ("sstv", "fax"):
            return self._make_image_decoder()
        return lambda y: ""

    def _make_image_decoder(self):
        """SSTV/FAX: host line assembly on the subcarrier-frequency stream;
        every image row goes out as a JSON line (base64 pixels) and finished
        images land in shared storage."""
        lines: list[str] = []

        def emit(msg: dict):
            lines.append(json.dumps(msg) + "\n")

        if self.mode == "sstv":
            sstv_decoder, = self._need("SstvDecoder")
            self._need("Storage", "convert_to_png")
            state = {"decoder": None, "line": 0,
                     "mode": None, "width": 0, "height": 0}

            def on_mode(name, width, height):
                state.update(mode=name, width=width, height=height, line=0)
                emit({"mode": "SSTV", "sstv_mode": name,
                      "width": width, "height": height, "line": -1})

            def on_row(row):
                n = state["line"]
                state["line"] += 1
                emit({"mode": "SSTV", "sstv_mode": state["mode"] or "?",
                      "width": int(row.shape[0]),
                      "height": state["height"], "line": n,
                      "pixels": base64.b64encode(
                          np.asarray(row, np.uint8).tobytes()).decode()})
                if state["height"] and state["line"] >= state["height"]:
                    self._save_image(state["decoder"].image(), "sstv", emit)
                    state["decoder"] = sstv_decoder(on_row=on_row,
                                                    on_mode=on_mode)
                    state["line"] = 0

            state["decoder"] = sstv_decoder(on_row=on_row, on_mode=on_mode)

            def decode(y):
                state["decoder"].feed(np.asarray(y))
                out = "".join(lines)
                lines.clear()
                return out
            return decode

        fax_decoder, storage = self._need("FaxDecoder", "Storage")
        fax_state = {"line": 0}

        def on_fax_row(row):
            n = fax_state["line"]
            fax_state["line"] += 1
            # fax lines are wide (≈1500 px at 120 lpm): 4× subsampled for
            # the wire, the canvas stretches horizontally
            sub = np.asarray(row, np.uint8)[::4]
            emit({"mode": "Fax", "width": int(sub.shape[0]), "line": n,
                  "pixels": base64.b64encode(sub.tobytes()).decode()})

        def on_fax_complete(path):
            fax_state["line"] = 0
            emit({"mode": "Fax", "complete": True,
                  "filename": os.path.basename(path)})

        fax = fax_decoder(on_row=on_fax_row, on_complete=on_fax_complete,
                          tmp_dir=storage.shared().directory)

        def decode_fax(y):
            fax.feed(np.asarray(y))
            out = "".join(lines)
            lines.clear()
            return out
        return decode_fax

    def _save_image(self, img, prefix: str, emit):
        """Store a finished RGB/grey image as PNG (PGM/PPM kept where no
        converter runs) in the shared file store and announce it."""
        if img is None:
            return
        storage, convert_to_png = self._need("Storage", "convert_to_png")
        img = np.asarray(img, np.uint8)
        store = storage.shared()
        color = img.ndim == 3
        raw = store.new_file(f"{prefix.upper()}-image.{'ppm' if color else 'pgm'}")
        with open(raw, "wb") as f:
            magic = "P6" if color else "P5"
            f.write(f"{magic}\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
            f.write(img.tobytes())
        png = convert_to_png(raw)
        emit({"mode": prefix.upper(), "complete": True,
              "filename": os.path.basename(png or raw)})

    def set_offset(self, offset_hz: float):
        self.bank.set_offset(self.slot, offset_hz)

    def set_carrier(self, carrier_hz: float):
        self.bank.set_carrier(self.slot, carrier_hz)

    def feed(self, block):
        """Standalone feed (single-slot bank); in the DeviceRuntime the
        per-mode SecondaryBank is fed once for all members."""
        self.bank.feed(block)

    def _deliver(self, y: np.ndarray, fft_payloads: list[bytes] | None):
        """One bank block's results for this slot, on the feeding thread."""
        if self.fft_cb is not None and fft_payloads is not None:
            for payload in fft_payloads:
                self.fft_cb(payload)
        text = self._decoder(y)
        if text and self.text_cb is not None:
            self.text_cb(text)


class IqServiceHandle:
    """A complex-IF tap: a Selector-only chain at an arbitrary IF rate, for
    external decoders that consume IQ (dumphfdl 12k, dumpvdl2 105k,
    rtl_433 250k).  Own block cadence; iq_cb receives bytes in the wire
    format asked for ('cf32' or 'cs16')."""

    def __init__(self, runtime: "DeviceRuntime", if_rate: float,
                 offset_hz: float, wire_format: str = "cs16"):
        self.runtime = runtime
        self.if_rate = float(if_rate)
        self.mode = f"iq@{int(if_rate)}"
        self.wire_format = wire_format
        self.chain = Selector(runtime.in_rate, if_rate, with_squelch=False)
        self.chain.set_frequency_offset(offset_hz)
        spec = StreamSpec(Format.COMPLEX_FLOAT, runtime.in_rate)
        self.block = plan_block_size(self.chain, spec, 0.1)
        self.program = Program(self.chain, spec, self.block,
                               device=runtime.device)
        self._chunks = _Chunks(self.block, self.program.device)
        self.iq_cb = None

    def set_offset(self, offset_hz: float):
        self.chain.set_frequency_offset(offset_hz)

    def feed(self, block) -> int:
        """Complex samples → every complete tap block through the program
        and, in the wire format, to ``iq_cb``; returns the blocks run."""
        ran = 0
        for chunk in self._chunks.push(block):
            ran += 1
            iq, _ = self.program.process(chunk)
            if self.iq_cb is None:
                continue
            if self.wire_format == "cs16":
                interleaved = np.empty(2 * len(iq), np.int16)
                scaled = np.clip(iq * 32767.0, -32768, 32767)
                interleaved[0::2] = scaled.real.astype(np.int16)
                interleaved[1::2] = scaled.imag.astype(np.int16)
                self.iq_cb(interleaved.tobytes())
            else:
                self.iq_cb(iq.astype(np.complex64).tobytes())
        return ran


def dv_program(mode: str, in_rate: float, offset_hz: float, device):
    """The device program of digital-voice ``mode`` at ``in_rate``, tuned
    to ``offset_hz``: → (chain, block, Program), as every DV listener, the
    M17 metadata tap and ``warm_up`` build it."""
    chain = DV_FACTORY[mode](in_rate)
    chain.set_frequency_offset(offset_hz)
    spec = StreamSpec(Format.COMPLEX_FLOAT, in_rate)
    block = plan_block_size(chain, spec, 0.1)
    return chain, block, Program(chain, spec, block, device=device)


class M17MetaTap:
    """Native M17 link-layer metadata beside the external audio decoder:
    the listener's 48 kHz cs16 IF stream (the bytes the subprocess gets)
    → DvSymbolChain on ``device`` → the host M17Decoder (LSF/LICH) → meta
    callback."""

    mode = "m17meta"
    IF_RATE = 48000.0

    def __init__(self, meta_cb, host=None, device="cuda"):
        m17_decoder, = host_names(host, "M17Decoder", what="M17 metadata")
        self.chain, self.block, self.program = dv_program(
            "m17", self.IF_RATE, 0.0, device)
        self._chunks = _Chunks(self.block, self.program.device)
        self.decoder = m17_decoder(meta_cb)

    def feed_cs16(self, data: bytes):
        """Interleaved int16 IQ at the 48 kHz IF."""
        s = np.frombuffer(data, np.int16).astype(np.float32) / 32767.0
        for chunk in self._chunks.push((s[0::2] + 1j * s[1::2]).astype(np.complex64)):
            dibits, _ = self.program.process(chunk)
            try:
                self.decoder.feed(np.asarray(dibits).astype(np.uint8))
            except Exception:
                logger.exception("m17 frame decode failed")


class ExecAudioHandle:
    """A listener mode decoded by an external binary: complex IF from an
    IqServiceHandle → subprocess → s16 audio back to the client (Drm,
    FreeDV, M17, HD Radio, DAB).  audio_cb(bytes, hd) receives raw s16
    frames; meta_cb(dict) the panels' metadata (DRM status socket, DAB and
    HDR stderr parsers)."""

    # mode → (if_rate, wire format, command builder, meta channel)
    MODES = {
        "drm": (48000, "cs16",
                lambda rate: ["dream", "-c", "6", "--sigsrate", str(int(rate)),
                              "--audsrate", "12000", "-I", "-", "-O", "-"],
                "drm_socket"),
        "freedv": (8000, "cs16",
                   lambda rate: ["freedv_rx", "1600", "-", "-"], None),
        "m17": (48000, "cs16",
                lambda rate: ["m17-demod", "-l"], None),
        "hdr": (744187, "cs16",
                lambda rate: ["nrsc5", "-r", "-", "-o", "-", "0"], "hdr"),
        "dab": (2048000, "cs16",
                lambda rate: ["dablin", "-s", "-p", "-"], "dab"),
    }

    def __init__(self, runtime: "DeviceRuntime", mode: str, offset_hz: float,
                 command_override=None):
        if_rate, wire, cmd, meta_kind = self.MODES[mode]
        host = runtime.host
        self.mode = mode
        self.runtime = runtime
        self.audio_cb = None
        self.meta_cb = None
        self._base_offset = float(offset_hz)
        self._drm_monitor = None
        self._drm_socket_path = None
        self._hdr = None
        self.pipeline = None
        what = f"exec mode {mode!r}"
        hdradio = getattr(host, "hdradio", None)
        if mode == "hdr" and command_override is None \
                and hdradio is not None and hdradio.available():
            # in-process decode through libnrsc5: IQ flows from the card's
            # channel into the decoder, audio/ID3/SIS come back by callback
            self.iq = runtime.open_iq_channel(if_rate, offset_hz, wire)
            self._hdr = hdradio.HdRadioDecoder(
                on_audio=self._on_audio_bytes, on_meta=self._on_meta)
            self.iq.iq_cb = self._hdr.feed
            return
        pipeline_cls, = host_names(host, "SubprocessPipeline", what=what)
        meta_names = {"drm_socket": ("DrmStatusMonitor",),
                      "dab": ("DabAfc", "DabMetaParser"),
                      "hdr": ("HdrMetaParser",)}.get(meta_kind, ())
        if mode == "m17":
            meta_names = ("MetaParser", "M17Decoder")
        meta_cls = host_names(host, *meta_names, what=what)
        self.iq = runtime.open_iq_channel(if_rate, offset_hz, wire)
        tap = None
        if mode == "m17":
            # native link-layer metadata regardless of the binary, fed the
            # SAME cs16 IF stream as the subprocess
            self._m17_meta = meta_cls[0](self._on_meta)
            tap = self._m17_tap = M17MetaTap(self._m17_meta.process, host,
                                             runtime.device)
        commandline = list(command_override or cmd(if_rate))
        on_stderr = None
        if meta_kind == "drm_socket":
            self._drm_socket_path = os.path.join(
                tempfile.gettempdir(),
                f"owrx_drm_{os.getpid()}_{id(self):x}.sock")
            if command_override is None:
                commandline += ["--status-socket", self._drm_socket_path]
            self._drm_monitor = meta_cls[0](self._drm_socket_path, self._on_meta)
            self._drm_monitor.start()
        elif meta_kind == "dab":
            self._afc = meta_cls[0](self._apply_afc)
            on_stderr = meta_cls[1](self._on_meta, self._afc).feed_line
        elif meta_kind == "hdr":
            on_stderr = meta_cls[0](self._on_meta).feed_line
        self.pipeline = pipeline_cls(
            commandline, self._on_audio_bytes, line_based=False,
            on_stderr_line=on_stderr)
        if tap is not None:
            feed_pipe = self.pipeline.feed

            def _feed_both(data: bytes):
                feed_pipe(data)
                try:
                    tap.feed_cs16(data)
                except Exception:
                    logger.exception("m17 meta tap failed")
            self.iq.iq_cb = _feed_both
        else:
            self.iq.iq_cb = self.pipeline.feed

    def _on_audio_bytes(self, data: bytes):
        if self.audio_cb is not None:
            self.audio_cb(data, False)

    def _on_meta(self, meta: dict):
        if self.meta_cb is not None:
            self.meta_cb(meta)

    def _apply_afc(self, shift_hz: float):
        """DAB AFC: the ETI frontend's frequency-shift feedback nudges the
        channel NCO."""
        self.iq.set_offset(self._base_offset + shift_hz)

    def set_offset(self, offset_hz: float):
        self._base_offset = float(offset_hz)
        afc = getattr(self, "_afc", None)
        if afc is not None:
            afc.reset()
        self.iq.set_offset(offset_hz)

    def close(self):
        if self._drm_monitor is not None:
            self._drm_monitor.stop()
            if self._drm_socket_path and os.path.exists(self._drm_socket_path):
                try:
                    os.unlink(self._drm_socket_path)
                except OSError:
                    pass
        self.runtime.release_secondary(self.iq)
        if self._hdr is not None:
            self._hdr.close()
        if self.pipeline is not None:
            self.pipeline.close()


class DigitalVoiceHandle:
    """DMR/YSF/D-Star/NXDN listener: the card runs the whole symbol path
    (discriminator → RRC matched filter → timing recovery → 4FSK slicer);
    the host frame decoder reads talker metadata from the dibits, and the
    external vocoder pipeline gets one dibit byte per symbol on stdin.
    ``runtime`` needs ``in_rate``, ``device``, ``host``, ``_lock`` and
    ``secondary_handles``."""

    FRAME_DECODERS = {"dmr": "DmrDecoder", "ysf": "YsfDecoder",
                      "dstar": "DstarDecoder", "nxdn": "NxdnDecoder"}

    def __init__(self, runtime: "DeviceRuntime", mode: str, offset_hz: float,
                 command_override=None):
        names = ("MetaParser", "SubprocessPipeline")
        if mode in self.FRAME_DECODERS:
            names += (self.FRAME_DECODERS[mode],)
        meta_parser, pipeline_cls, *frames = host_names(
            runtime.host, *names, what=f"digital voice mode {mode!r}")
        self.runtime = runtime
        self.mode = mode
        self.audio_cb = None
        self.meta_cb = None
        self.chain, self.block, self.program = dv_program(
            mode, runtime.in_rate, offset_hz, runtime.device)
        self._chunks = _Chunks(self.block, self.program.device)
        self.meta_parser = meta_parser(self._on_meta)
        # the native frame layer decodes talker metadata in-process; the
        # external pipeline still gets the dibits for the vocoder audio
        self._frames = frames[0](self.meta_parser.process) if frames else None
        self.pipeline = pipeline_cls(
            command_override or DV_DECODERS[mode], self._on_audio_bytes,
            line_based=False, on_meta_line=self.meta_parser.feed_line)
        with runtime._lock:
            runtime.secondary_handles.append(self)  # device feed path

    def _on_audio_bytes(self, data: bytes):
        if self.audio_cb is not None:
            self.audio_cb(data, False)

    def _on_meta(self, meta: dict):
        if self.meta_cb is not None:
            self.meta_cb(meta)

    def set_offset(self, offset_hz: float):
        self.chain.set_frequency_offset(offset_hz)

    def set_dial_frequency(self, freq: float):
        self.meta_parser.set_dial_frequency(freq)

    def feed(self, block):
        for chunk in self._chunks.push(block):
            dibits, _ = self.program.process(chunk)
            dib = np.asarray(dibits).astype(np.uint8)
            if self._frames is not None:
                try:
                    self._frames.feed(dib)       # native metadata path
                except Exception:
                    logger.exception("%s frame decode failed", self.mode)
            self.pipeline.feed(dib.tobytes())

    def close(self):
        self.runtime.release_secondary(self)
        self.pipeline.close()


def _inside(metric) -> bool:
    """Whether this thread is inside a span of ``metric``."""
    span = current_span()
    while span is not None:
        if span.metric is metric:
            return True
        span = span.prev
    return False


def _control(method):
    """A listener's control call, on its ``ChannelHandle`` or on the
    runtime: a ``control`` span with a change number of its own, after
    which the change waits for the first block whose step of the
    listener's bank runs with it (``DeviceRuntime._changed``).  A control
    call made inside another is part of it."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        rt = self if isinstance(self, DeviceRuntime) else self.runtime
        control = rt.spans["control"]
        if _inside(control):
            return method(self, *args, **kwargs)
        with control(rid=next(rt._change_ids), parent=-1) as span:
            out = method(self, *args, **kwargs)
        handle = next((h for h in (out, self, *args) if isinstance(h, ChannelHandle)), None)
        if handle is not None:
            rt._changed(span, handle)
        return out
    return call


class _ControlLock:
    """The runtime's reentrant lock; a control call's wait for it is a
    ``lock`` span."""

    __slots__ = ("_lock", "_wait", "_control")

    def __init__(self, spans: SpanLog):
        self._lock = threading.RLock()
        self._wait, self._control = spans["lock"], spans["control"]

    def __enter__(self):
        span = current_span()
        if span is not None and span.metric is self._control:
            with self._wait():
                self._lock.acquire()
        else:
            self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


class ChannelHandle:
    """A listener's handle on one bank slot."""

    def __init__(self, runtime: "DeviceRuntime", mode: str, slot: int):
        self.runtime = runtime
        self.mode = mode
        self.slot = slot
        self.bucket_key = BANK_BUCKET[mode]
        self.framer = SyncFramer()
        self.audio_cb = None
        self.smeter_cb = None
        self._rds_cb = None             # WFM only: RDS events
        self._rds = None
        self._smeter_decim = 0

    @property
    def rds_cb(self):
        return self._rds_cb

    @rds_cb.setter
    def rds_cb(self, cb):
        if cb is not None:
            host_names(self.runtime.host, "RdsDecoder", "RdsParser", what="RDS")
        self._rds_cb = cb

    # -- controls ---------------------------------------------------------
    @property
    def bank(self):
        return self.runtime.banks[self.bucket_key]

    @_control
    def set_offset(self, offset_hz: float):
        if self.slot is None:
            return
        if self.bucket_key.startswith(("pfb:", "pfbi:")):
            # the new dial may not fit its PFB channel or may collide with
            # another dial's: the runtime re-fits, migrating if needed
            self.runtime.retune_channelized(self, offset_hz)
            return
        # a full-rate slot retuning to a dial that fits the filterbank is
        # re-admitted (with hysteresis)
        if self.runtime.try_pfb_readmit(self, offset_hz):
            return
        new_slot = self.bank.retune(self.slot, offset_hz)
        if new_slot is not None:
            self.slot = new_slot

    @_control
    def set_squelch(self, level_db: float):
        if self.slot is not None:
            self.bank.set_squelch(self.slot, level_db)

    @_control
    def set_bandpass(self, low_hz: float, high_hz: float):
        if self.slot is not None:
            self.bank.set_bandpass(self.slot, low_hz, high_hz)

    @_control
    def set_nr(self, threshold_db: float):
        if self.slot is not None:
            self.bank.set_nr(self.slot, threshold_db)

    @_control
    def set_mode(self, mode: str, offset_hz: float | None = None):
        """Mode switch = move to another bank."""
        self._rds = None
        self.runtime.switch_mode(self, mode, offset_hz)

    def feed_rds(self, baseband: np.ndarray):
        """RDS aux row from the WFM bank → host group decoder → rds_cb."""
        if self._rds is None:
            rds_decoder, rds_parser = host_names(
                self.runtime.host, "RdsDecoder", "RdsParser", what="RDS")
            parser = rds_parser(self.rds_cb)
            self._rds = rds_decoder(WFm.fixed_if_rate / RdsTapStage.DECIMATION,
                                    parser.parse)
        self._rds.process(baseband)

    def close(self):
        self.runtime.release_channel(self)


class DeviceRuntime:
    def __init__(self, source, fft_size: int = 4096, fft_fps: float = 9.0,
                 audio_rate: float = 12000.0, compression: str = "adpcm",
                 fft_compression: str = "adpcm", capacity: int = 16,
                 target_seconds: float = 0.1, pipeline_depth: int = 2,
                 pfb_capacity: int | None = None,
                 service_delivery_seconds: float = 0.3, host=None,
                 device="cuda"):
        self.spans = SpanLog(f"device.{source.id}", RUNTIME_SPANS)
        with self.spans["build"](parent=-1):
            self.device = resolve_device(device)
            self.host = PORT_HOST if host is None else host
            # background service results are delivered in batches of about
            # this much signal (delivery_stride of the 'pfb:' banks)
            self.service_delivery_seconds = float(service_delivery_seconds)
            # `capacity` sizes the full-rate banks; `pfb_capacity` the
            # filterbank banks, whose slots cost a channel-rate row each
            self.pfb_capacity = pfb_capacity
            # blocks in flight between dispatch and completion
            self.pipeline_depth = max(1, int(pipeline_depth))
            self.fft_compression = fft_compression
            self.source = source
            self.audio_rate = audio_rate
            self.compression = compression
            self.capacity = capacity
            self.target_seconds = target_seconds
            self.in_rate = source.get_sample_rate()
            self.banks: dict[str, ChannelBank | ChannelizedBank] = {}
            self._pfbi_infeasible: set[str] = set()
            self._pfb_m: dict[str, int] = {}
            self.handles: list[ChannelHandle] = []
            self.secondary_handles: list = []     # SecondaryBank/Iq/DV feeders
            self.secondary_banks: dict[str, SecondaryBank] = {}
            self.waterfall_subscribers: list = []
            self._lock = _ControlLock(self.spans)
            self._running = False
            self._thread: threading.Thread | None = None
            self.gauges = {"blocks": 0, "proc_block_ms": 0.0,
                           "samples_per_s": 0.0, "realtime_factor": 0.0}
            self._gauges = None               # their registry entries, once the loop runs
            self._n_dispatch = 0              # blocks dispatched: the next block's number
            # id(dispatched block) → (its number, its dispatch's start and end)
            self._inflight: dict[int, tuple] = {}
            self._cause = -1                  # the loop's last read (its span id)
            self._change_ids = itertools.count()
            # changes whose bank's step has not yet run with them:
            # (change, its control span, its return, bank, rebuilds, block)
            self._changes: list[tuple] = []
            self._changes_lock = threading.Lock()

            # ONE device block must satisfy every mode bucket's chain (plus the
            # waterfall, which accepts any block): lcm of the bucket
            # requirements at this rate
            spec = StreamSpec(Format.COMPLEX_FLOAT, self.in_rate)
            req = 1
            want = max(1, int(round(self.in_rate * target_seconds)))
            self.available_buckets = set()
            for bucket_mode in set(BUCKET_CHAIN_MODE.values()):
                try:
                    proto = ClientDemodulatorChain(self.in_rate, audio_rate,
                                                   bucket_mode, compression)
                except ValueError:
                    # mode infeasible at this device rate (WFM's fixed 250 kHz
                    # IF above the device rate): not offered
                    continue
                r = block_requirement(proto, spec)
                # only chains with a requirement near the latency target set
                # the device cadence; a long chain accumulates device chunks
                # inside its bank (ChannelBank.feed_dispatch)
                if r <= 2 * want:
                    req = req * r // gcd(req, r)
                self.available_buckets.add(
                    next(b for b, m in BUCKET_CHAIN_MODE.items() if m == bucket_mode))
            # floor-round toward the latency target (never below one requirement)
            self.block = max(req, (want // req) * req)

            self.fft_chain = FftChain(fft_size, fft_fps,
                                      compress=(fft_compression == "adpcm"))
            self.fft_program = Program(self.fft_chain, spec, self.block,
                                       device=self.device)
            source.block_size = self.block

    # -- channels ---------------------------------------------------------
    def _get_bank(self, key: str) -> ChannelBank:
        """key = bucket name, or 'svc:<bucket>' for raw-audio service banks."""
        with self._lock:
            bank = self.banks.get(key)
            if bank is None:
                service = key.startswith("svc:")
                bucket = key.split(":", 1)[-1]
                # WFM listeners get HD audio (48 kHz)
                audio_rate = 48000.0 if bucket == "wfm" else self.audio_rate
                with self.spans["bank"]():
                    bank = ChannelBank(self.in_rate, BUCKET_CHAIN_MODE[bucket],
                                       capacity=self.capacity,
                                       audio_rate=audio_rate,
                                       compression="none" if service else self.compression,
                                       block=self.block, device=self.device)
                self.banks[key] = bank
            return bank

    def _pfb_channels(self) -> int:
        """PFB channel count for this device rate: the largest power of two
        keeping the channel slice ≥ 24 kHz.  0 ⇒ device too narrow to
        channelize."""
        if self.in_rate < 24000 * 8:
            return 0
        return min(4096, 2 ** int(math.log2(self.in_rate / 24000)))

    def _pfb_m_for(self, bucket: str) -> int:
        """Channel count for a bucket's filterbank: start from
        _pfb_channels() and halve (widening slices) until the bucket's
        demod chain is feasible at the channel rate.  0 ⇒ this bucket
        cannot channelize at this device rate.  Cached per bucket."""
        cached = self._pfb_m.get(bucket)
        if cached is not None:
            return cached
        audio_rate = 48000.0 if bucket == "wfm" else self.audio_rate
        m = self._pfb_channels()
        while m >= 8:
            try:
                ClientDemodulatorChain(self.in_rate / m, audio_rate,
                                       BUCKET_CHAIN_MODE[bucket], "none")
                break
            except ValueError:
                m //= 2
        else:
            m = 0
        self._pfb_m[bucket] = m
        return m

    def _get_pfb_bank(self, bucket: str, interactive: bool = False):
        """Per-bucket ChannelizedBank: every dial of a bucket demodulates
        from ONE polyphase filterbank at channel rate.  Two banks per
        bucket: 'pfb:' (services, raw audio, delivery batches) and 'pfbi:'
        (interactive listeners, client codec, every block)."""
        key = ("pfbi:" if interactive else "pfb:") + bucket
        with self._lock:
            bank = self.banks.get(key)
            if bank is None:
                m = self._pfb_m_for(bucket)
                if interactive:
                    stride = 1
                    compression = self.compression
                else:
                    stride = max(1, int(round(self.service_delivery_seconds
                                              / self.target_seconds)))
                    compression = "none"
                with self.spans["bank"]():
                    bank = ChannelizedBank(
                        self.in_rate, m,
                        mode=BUCKET_CHAIN_MODE[bucket],
                        audio_rate=(48000.0 if bucket == "wfm"
                                    else self.audio_rate),
                        compression=compression, block=self.block,
                        capacity=min(m, self.pfb_capacity
                                     or max(64, self.capacity)),
                        delivery_stride=stride, device=self.device)
                if interactive and bank.chunk_ratio > 2:
                    # the channel-rate chain would accumulate > 2 device
                    # blocks a dispatch: too much latency for a listener;
                    # this bucket's listeners are served full rate
                    self._pfbi_infeasible.add(bucket)
                    return None
                self.banks[key] = bank
            return bank

    def _pfb_route(self, bucket: str, offset_hz: float, lo: float, hi: float,
                   interactive: bool, margin: float = 0.4):
        """Try to place a dial on the bucket's PFB bank → (bucket_key, slot),
        or None when the filterbank can't serve it: device too narrow,
        passband wider than a slice, dial straddling a channel edge,
        channel occupied (dense banks), bank full."""
        m = self._pfb_m_for(bucket)
        if m < 8 or (hi - lo) > 2 * margin * self.in_rate / m:
            return None
        if interactive and bucket in self._pfbi_infeasible:
            return None
        # fit check before building a bank: an edge dial must not pay a
        # filterbank build just to be turned away
        k = int(round(offset_hz * m / self.in_rate)) % m
        fine = offset_hz - channel_frequencies(m, self.in_rate)[k]
        half = margin * self.in_rate / m
        if not ((fine + lo) >= -half and (fine + hi) <= half):
            return None
        bank = self._get_pfb_bank(bucket, interactive)
        if bank is None:
            return None
        # gathered banks share channels freely; only dense banks (slot ≡
        # channel) need the occupancy check
        free = bank.capacity is not None or not bank.channel_in_use(k)
        if not (free and bank.has_free_slot()):
            return None
        slot = bank.assign(offset_hz)
        bank.set_bandpass(slot, lo, hi)
        return ("pfbi:" if interactive else "pfb:") + bucket, slot

    @_control
    def open_channel(self, mode: str, offset_hz: float = 0.0,
                     service: bool = False) -> ChannelHandle:
        """service=True → raw int16 audio (choppers, recorders); otherwise
        the client codec.  A dial whose passband fits a free PFB channel
        slice takes a slot of the bucket's filterbank bank; one that
        straddles a channel edge (or collides in a dense bank) falls back
        to a full-rate ChannelBank slot.  Retuning migrates live both ways
        (retune_channelized / try_pfb_readmit)."""
        bucket = BANK_BUCKET[mode]
        if bucket not in self.available_buckets:
            raise KeyError(f"mode {mode} not available at "
                           f"{self.in_rate:.0f} S/s")
        lo, hi = MODE_BANDPASS[mode]
        routed = None
        try:
            routed = self._pfb_route(bucket, offset_hz, lo, hi,
                                     interactive=not service)
        except (ValueError, KeyError):
            logger.exception("PFB bank unavailable for %s; "
                             "falling back to full-rate bank", mode)
        if routed is not None:
            key, slot = routed
            handle = ChannelHandle(self, mode, slot)
            handle.bucket_key = key
            with self._lock:
                self.handles.append(handle)
            return handle
        key = f"svc:{bucket}" if service else bucket
        bank = self._get_bank(key)
        slot = bank.add_channel(offset_hz)
        bank.set_bandpass(slot, lo, hi)
        handle = ChannelHandle(self, mode, slot)
        handle.bucket_key = key
        with self._lock:
            self.handles.append(handle)
        return handle

    def retune_channelized(self, handle: ChannelHandle, offset_hz: float):
        """Retune a PFB-backed handle: it stays in the filterbank when the
        new dial fits a free (or its own) channel, else it migrates live to
        a full-rate slot (interactive handles to their bucket's listener
        bank, services to 'svc:')."""
        with self._lock:
            interactive = handle.bucket_key.startswith("pfbi:")
            bank = self.banks[handle.bucket_key]
            lo, hi = float(bank._low[handle.slot]), float(bank._high[handle.slot])
            k, _ = bank.channel_for(offset_hz)
            own = (bank.capacity is not None
                   or int(bank._chan[handle.slot]) == k)
            if bank.fits(offset_hz, lo, hi) and (own or
                                                 not bank.channel_in_use(k)):
                handle.slot = bank.retune(handle.slot, offset_hz)
                return
            # migrate to the full-rate bank, keeping controls
            sq = float(bank._squelch[handle.slot])
            nr = float(bank._nr[handle.slot])
            bank.remove_channel(handle.slot)
            handle.slot = None            # inert if the reopen fails
            bucket = handle.bucket_key.split(":", 1)[-1]
            new_key = bucket if interactive else f"svc:{bucket}"
            new_bank = self._get_bank(new_key)
            slot = new_bank.add_channel(offset_hz, squelch_db=sq)
            new_bank.set_bandpass(slot, lo, hi)
            new_bank.set_nr(slot, nr)
            handle.slot = slot
            handle.bucket_key = new_key
            # the new slot's codec state starts fresh: resync the framer
            handle.framer = SyncFramer()

    # the reference's older name
    retune_service = retune_channelized

    def try_pfb_readmit(self, handle: ChannelHandle,
                        offset_hz: float) -> bool:
        """A full-rate handle retuning to a dial that fits the filterbank
        moves back in.  The stricter 0.35 margin (against the 0.4 fit) is
        hysteresis: a drag oscillating across a channel edge must not
        thrash between banks."""
        with self._lock:
            old_key = handle.bucket_key
            if handle.slot is None or old_key.startswith(("pfb:", "pfbi:")):
                return False
            interactive = not old_key.startswith("svc:")
            bucket = old_key.split(":", 1)[-1]
            bank = self.banks[old_key]
            lo = float(bank._low[handle.slot])
            hi = float(bank._high[handle.slot])
            try:
                routed = self._pfb_route(bucket, offset_hz, lo, hi,
                                         interactive, margin=0.35)
            except (ValueError, KeyError):
                return False
            if routed is None:
                return False
            sq = float(bank._squelch[handle.slot])
            nr = float(bank._nr[handle.slot])
            bank.remove_channel(handle.slot)
            key, slot = routed
            new_bank = self.banks[key]
            new_bank.set_squelch(slot, sq)
            new_bank.set_nr(slot, nr)
            handle.slot = slot
            handle.bucket_key = key
            handle.framer = SyncFramer()
            return True

    def open_secondary(self, mode: str, offset_hz: float) -> SecondaryHandle:
        """Attach a digimode listener: same-mode listeners share one
        batched SecondaryBank program."""
        with self._lock:
            bank = self.secondary_banks.get(mode)
            if bank is None:
                bank = SecondaryBank(self, mode)
                self.secondary_banks[mode] = bank
                self.secondary_handles.append(bank)   # device feed path
            try:
                return SecondaryHandle(self, mode, offset_hz, bank)
            except LookupError:
                if not bank._active.any():
                    self._drop_secondary_bank(bank)
                raise

    def _drop_secondary_bank(self, bank: SecondaryBank):
        with self._lock:
            if self.secondary_banks.get(bank.secondary_mode) is bank:
                del self.secondary_banks[bank.secondary_mode]
            if bank in self.secondary_handles:
                self.secondary_handles.remove(bank)

    def open_iq_channel(self, if_rate: float, offset_hz: float,
                        wire_format: str = "cs16") -> IqServiceHandle:
        handle = IqServiceHandle(self, if_rate, offset_hz, wire_format)
        with self._lock:
            self.secondary_handles.append(handle)  # same feed path
        return handle

    def release_secondary(self, handle):
        with self._lock:
            bank = getattr(handle, "bank", None)
            if isinstance(bank, SecondaryBank):
                bank.detach(handle)
                handle.slot = None
                return
            if handle in self.secondary_handles:
                self.secondary_handles.remove(handle)

    @_control
    def release_channel(self, handle: ChannelHandle):
        with self._lock:
            if handle in self.handles:
                self.handles.remove(handle)
                if handle.slot is not None:
                    self.banks[handle.bucket_key].remove_channel(handle.slot)

    @_control
    def switch_mode(self, handle: ChannelHandle, mode: str,
                    offset_hz: float | None = None):
        is_pfb = handle.bucket_key.startswith(("pfb:", "pfbi:"))
        service = handle.bucket_key.startswith(("svc:", "pfb:"))
        new_bucket = BANK_BUCKET[mode]
        new_key = f"svc:{new_bucket}" if service else new_bucket
        if new_bucket not in self.available_buckets:
            raise KeyError(f"mode {mode} not available at "
                           f"{self.in_rate:.0f} S/s")
        with self._lock:
            bank = self.banks[handle.bucket_key]
            if offset_hz is not None:
                offset = offset_hz
            elif is_pfb:
                # dial = the slot's channel centre + fine offset
                k = int(bank._chan[handle.slot])
                offset = float(channel_frequencies(bank.m, bank.in_rate)[k]
                               + bank._fine[handle.slot])
            else:
                offset = float(bank._offsets[handle.slot])
            if new_key == handle.bucket_key and not is_pfb:
                handle.mode = mode
                lo, hi = MODE_BANDPASS[mode]
                bank.set_bandpass(handle.slot, lo, hi)
                return
            bank.remove_channel(handle.slot)
            # the full open_channel routing for the new mode; if the reopen
            # fails the handle goes inert (slot None) rather than alias a
            # freed slot
            self.handles.remove(handle)
            handle.slot = None
            new_handle = self.open_channel(mode, offset, service=service)
            handle.slot = new_handle.slot
            handle.mode = mode
            handle.bucket_key = new_handle.bucket_key
            self.handles.remove(new_handle)
            self.handles.append(handle)
            handle.framer = SyncFramer()

    # -- waterfall --------------------------------------------------------
    def subscribe_waterfall(self, cb):
        with self._lock:
            self.waterfall_subscribers.append(cb)

    def unsubscribe_waterfall(self, cb):
        with self._lock:
            if cb in self.waterfall_subscribers:
                self.waterfall_subscribers.remove(cb)

    # -- loop -------------------------------------------------------------
    def build_kernels(self) -> float:
        """On a card, build every kernel of the port (one nvcc each, all
        at once; a library already built is reused) so that none compiles
        inside a streamed block (a ``kernels`` span); returns the seconds
        it took."""
        if self.device.type != "cuda":
            return 0.0
        with self.spans["kernels"](parent=-1):
            return kernels.build_all()

    def start(self):
        with self._lock:
            if self._running:
                return
            self.build_kernels()
            self._running = True
            self.source.start()
            self._thread = threading.Thread(target=self._loop,
                                            name=f"device-{self.source.id}",
                                            daemon=True)
            self._thread.start()

    def stop(self):
        if not self._running:
            return
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _pump(self, block, pending: deque):
        """Dispatch one block, then complete the oldest in flight once
        ``pipeline_depth`` blocks are."""
        pending.append(self._dispatch_block(block))
        if len(pending) >= self.pipeline_depth:
            self._finish(pending.popleft(), self._cause)

    def _loop(self):
        # a new thread's current device is device 0, whatever the runtime
        # was built on
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        m = Metrics.shared()
        prefix = f"device.{self.source.id}"
        self._gauges = (m.counter(f"{prefix}.blocks"),
                        {name: m.direct(f"{prefix}.{name}")
                         for name in ("proc_block_ms", "samples_per_s", "realtime_factor")})
        read = self.spans["read"]
        pending = deque()

        def drain_all():
            while pending:
                try:
                    self._finish(pending.popleft(), self._cause)
                except Exception:
                    logger.exception("device %s block completion failed",
                                     self.source.id)

        while self._running:
            # short timeout while blocks are in flight: a paused stream
            # must not hold completed results for the idle timeout
            with read(rid=self._n_dispatch, parent=-1) as span:
                block = self.source.read_block(timeout=0.06 if pending else 1.0)
                if block is None:
                    span.rid, span.outcome = -1, "timeout"
                else:
                    span.outcome = "block"
            self._cause = span.sid
            if block is None:
                drain_all()
                continue
            try:
                self._pump(block, pending)
            except Exception:
                logger.exception("device %s block processing failed",
                                 self.source.id)
                pending.clear()
                continue
        drain_all()

    def _process_block(self, block):
        """Synchronous dispatch + complete (tests and direct callers)."""
        self._finish(self._dispatch_block(block))

    def _finish(self, pending: dict, cause: int = -1):
        """Take a dispatched block off the loop's hands: its ``hold`` span
        ends, caused by the read (span id) ``cause``; it completes inside a
        ``complete`` span; the gauges take its own time, its dispatch and
        its completion."""
        b, t0, t1 = self._inflight.pop(id(pending), (-1, None, None))
        if t1 is not None:
            self.spans["hold"].record(t1, time.perf_counter(), b, cause)
        with self.spans["complete"](rid=b, parent=-1) as span:
            self._complete_block(pending)
        if t1 is not None:
            self._gauge(t1 - t0 + span.t1 - span.t0)

    def _gauge(self, seconds: float):
        """The gauges after a block that took ``seconds`` of its own."""
        g = self.gauges
        g["blocks"] += 1
        g["proc_block_ms"] = round(seconds * 1e3, 3)
        if seconds > 0:
            g["samples_per_s"] = round(self.block / seconds)
            if self.in_rate:
                g["realtime_factor"] = round(self.block / seconds / self.in_rate, 2)
        if self._gauges is not None:
            blocks, direct = self._gauges
            blocks.inc()
            for name, metric in direct.items():
                metric.set(g[name])

    def _upload(self, block) -> torch.Tensor:
        """One host→device transfer of an IQ block, shared by every
        program: complex samples as float32 pairs, int16/uint8 wire pairs
        as they are, staged in pinned memory taken fresh for this block
        (PyTorch's host allocator keeps it until the copy is done) →
        (block,) complex64 on the device."""
        with self.spans["upload"]():
            host = torch.from_numpy(np.ascontiguousarray(
                self.fft_program.pack_input(block)))
            if self.device.type == "cuda":
                staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                staged.copy_(host)
                x = staged.to(self.device, non_blocking=True)
            else:
                x = host.clone()          # the source may reuse its buffer
            return as_input_block(x, self.block, True, self.device)

    def _dispatch_block(self, block) -> dict:
        n = self._n_dispatch
        self._n_dispatch += 1
        with self.spans["dispatch"](rid=n, parent=-1) as span:
            with self._lock:
                banks = {k: b for k, b in self.banks.items() if b.n_active}
                handles = list(self.handles)
                secondaries = list(self.secondary_handles)
            want_fft = bool(self.waterfall_subscribers)
            xdev = (self._upload(block) if want_fft or banks or secondaries
                    else None)
            # dispatch everything before fetching anything
            fft_pending = ([self.fft_program.dispatch(xdev, to_host=False)[0]]
                           if want_fft else [])
            bank_pending = {}
            for key, bank in banks.items():
                pend = bank.feed_dispatch(xdev, to_host=False)
                if pend is None:      # a long-chain bank still accumulating
                    continue
                # a delivery-stride batch is (list of K pendings, K)
                bank_pending[key] = pend[0] if isinstance(pend[1], int) else [pend[0]]
            self._settle(n, span.t0, banks)
            # every result of this block starts its copy behind ONE event
            fetched = iter(start_fetches(
                fft_pending + [p for pl in bank_pending.values() for p in pl],
                self.device))
            fft_pending = [next(fetched) for _ in fft_pending]
            bank_pending = {k: [next(fetched) for _ in pl]
                            for k, pl in bank_pending.items()}
            # secondaries fetch their own results, on their own cadence, while
            # the banks' copies are in flight
            for sec in secondaries:
                try:
                    sec.feed(xdev)
                except Exception:
                    logger.exception("secondary %s failed", sec.mode)
            out = {"banks": banks, "handles": handles,
                   "fft_pending": fft_pending, "bank_pending": bank_pending}
        self._inflight[id(out)] = (n, span.t0, span.t1)
        if len(self._inflight) > 64:        # blocks dispatched and completed elsewhere
            del self._inflight[next(iter(self._inflight))]
        return out

    def _changed(self, span, handle: ChannelHandle):
        """A control call (``span``) returned: its change waits for the
        first block whose step of the handle's bank runs with it."""
        bank = self.banks.get(handle.bucket_key) if handle.slot is not None else None
        if bank is None:
            return
        rebuilds, waiting = bank.params_epoch()
        # not waiting: the step of a dispatch already begun took it
        at = -1 if waiting or not self._n_dispatch else self._n_dispatch - 1
        with self._changes_lock:
            self._changes.append((span.rid, span.sid, span.t1, bank, rebuilds + waiting, at))
            del self._changes[:-1024]

    def _settle(self, b: int, t0: float, active: dict):
        """After block ``b``'s banks were dispatched (from ``t0``): an
        ``apply`` span for each change whose bank's step has now run with
        it, ending at ``t0``; a change whose bank no longer runs is
        dropped."""
        if not self._changes:
            return
        apply = self.spans["apply"]
        with self._changes_lock:
            waiting = []
            for change in self._changes:
                cid, sid, returned, bank, rebuilds, at = change
                if at >= 0:
                    apply.record(returned, returned, cid, sid, at)
                elif bank.params_rebuilds >= rebuilds:
                    apply.record(returned, max(returned, t0), cid, sid, b)
                elif returned >= t0 or any(bank is x for x in active.values()):
                    waiting.append(change)
            self._changes = waiting

    def _complete_block(self, pending: dict):
        # every result of the block waits on one event
        with self.spans["fetch"]():
            event = next((p.event for pl in [pending["fft_pending"],
                                             *pending["bank_pending"].values()]
                          for p in pl if p.event is not None), None)
            if event is not None:
                event.synchronize()
        with self.spans["deliver"]():
            self._deliver(pending)

    def _deliver(self, pending: dict):
        """A completed block's results, as numpy, to every subscriber and
        listener (numpy, ADPCM framing, callbacks)."""
        banks = pending["banks"]
        handles = pending["handles"]
        # the waterfall, shared by every subscriber; compressed rows come
        # as (rows, padded bytes) uint8, the payload is a row's first
        # wire_bytes_per_row bytes
        for fft in pending["fft_pending"]:
            rows, _ = finish_fetch(fft)
            rows = np.atleast_2d(rows)
            if self.fft_compression == "adpcm":
                nb = self.fft_chain.waterfall.wire_bytes_per_row
                payloads = [row[:nb].tobytes() for row in rows]
            else:
                payloads = [row.astype(np.float32).tobytes() for row in rows]
            for cb in list(self.waterfall_subscribers):
                for payload in payloads:
                    cb(payload)
        outputs = {}
        for key, pends in pending["bank_pending"].items():
            decoded = []
            for p in pends:
                y, aux = finish_fetch(p)
                power = rds = None
                for k, v in aux.items():
                    if k.endswith("power_db") and power is None:
                        power = v
                    elif k.endswith(".rds"):
                        rds = v
                decoded.append((y, power, rds))
            outputs[key] = decoded
        for handle in handles:
            outs = outputs.get(handle.bucket_key)
            if not outs or handle.slot is None:
                continue
            for y, power, rds in outs:
                if handle.audio_cb is not None:
                    if banks[handle.bucket_key].compression == "adpcm":
                        bytes_, stride_states = y
                        wire = handle.framer.frame(bytes_[handle.slot],
                                                   stride_states[handle.slot])
                    else:
                        wire = y[handle.slot].tobytes()
                    handle.audio_cb(wire, handle.bucket_key.endswith("wfm"))
                if handle.smeter_cb is not None and power is not None:
                    # 4 reports/s from 16 measurements/s
                    self._emit_smeter(handle, power[handle.slot])
                if handle.rds_cb is not None and rds is not None:
                    handle.feed_rds(rds[handle.slot])

    def _emit_smeter(self, handle, power: np.ndarray):
        for v in power:
            handle._smeter_decim += 1
            if handle._smeter_decim % 4 == 0:
                handle.smeter_cb(float(v))


# The programs warm_up runs besides the banks and the waterfall, by kind:
# a mode of each signature (chain, rate, block) whose first block in a
# fresh process cost more than 20 ms above a steady block at the 2.4 MS/s
# demo on an NVIDIA H100 (chip_smoke.py --startup-split; PERF.md §6),
# most of it CUDA and cuFFT modules read from disk on the machine's first
# use: PSK31 (0.77 s), the CW decoder (0.61 s), DMR and YSF (0.14 s: an
# 8192-point cuFFT plan), the CW skimmer and FreeDV's 8 kHz IQ tap (61 and
# 62 ms: a 256- and a 1024-point plan) and the Meteor LRPT tap (25 ms: a
# 32768-point plan).  Every other secondary, DV and IQ-tap signature cost
# at most 13 ms once, less than warming it would add to the start-up (the
# HD Radio tap alone takes 3 s to build there).
WARM_MODES = {"secondary": ("bpsk31", "cwdecoder", "cwskimmer"), "dv": ("dmr",),
              "iq": ("freedv", "meteor-lrpt")}


class WarmProgram:
    """A device program ``warm_up`` runs besides the channel banks and the
    waterfall: its ``kind`` (a key of ``WARM_MODES``), the ``mode`` it was
    built for, the ``program``, ``feed`` (the device block → the program
    blocks it ran) and the blocks that ran and ``delivered`` their results
    in the feed that first ran one."""

    def __init__(self, kind: str, mode: str, program: Program, feed):
        self.kind, self.mode, self.program, self.feed = kind, mode, program, feed
        self.delivered = 0


def _ignore(*args):
    pass


def _program_feed(program: Program):
    """A Program's feed as a handle runs it: the device block cut into its
    own blocks, each processed and fetched."""
    chunks = _Chunks(program.block, program.device)

    def feed(x) -> int:
        ran = 0
        for chunk in chunks.push(x):
            program.process(chunk)
            ran += 1
        return ran
    return feed


def warm_programs(runtime: DeviceRuntime) -> list[WarmProgram]:
    """The programs of ``WARM_MODES`` on ``runtime``, built as the handles
    build them and none started: a capacity-2 ``SecondaryBank`` with one
    member, its text decoder and an ``fft_cb`` (so its FFT rows are
    encoded), the ``dv_program``, the ``IqServiceHandle`` of an
    ``ExecAudioHandle`` or ``IQ_EXEC_MODES`` mode.  No subprocess is
    started: the DV and exec modes' external decoders are not.  A secondary
    mode whose host decoder ``runtime.host`` lacks (the ``LookupError`` its
    handle raises), or an IQ mode whose IF is above the source's rate,
    which the runtime would refuse to open, is left out and logged."""
    from openwebrx_tpu_torch.services.exec_modes import IQ_EXEC_MODES
    programs = []
    for mode in WARM_MODES["secondary"]:
        bank = SecondaryBank(runtime, mode)
        try:
            handle = SecondaryHandle(runtime, mode, 0.0, bank)
        except LookupError as e:
            logger.info("warm-up leaves out %s: %s", mode, e)
            continue
        handle.text_cb = handle.fft_cb = _ignore
        programs.append(WarmProgram("secondary", mode, bank.program, bank.feed))
    for mode in WARM_MODES["dv"]:
        _, _, program = dv_program(mode, runtime.in_rate, 0.0, runtime.device)
        programs.append(WarmProgram("dv", mode, program, _program_feed(program)))
    for mode in WARM_MODES["iq"]:
        if mode in ExecAudioHandle.MODES:
            if_rate, wire = ExecAudioHandle.MODES[mode][:2]
        else:
            if_rate, wire = IQ_EXEC_MODES[mode]["if_rate"], IQ_EXEC_MODES[mode]["wire"]
        if if_rate > runtime.in_rate:
            logger.info("warm-up leaves out %s: its IF of %.0f S/s is above the "
                        "source's %.0f S/s", mode, if_rate, runtime.in_rate)
            continue
        tap = IqServiceHandle(runtime, if_rate, 0.0, wire)
        tap.iq_cb = _ignore
        programs.append(WarmProgram("iq", mode, tap.program, tap.feed))
    return programs


def warm_up(runtime: DeviceRuntime) -> list[WarmProgram]:
    """Pay a process's one-time costs of a program's first block on
    ``runtime``, a runtime built only for this and dropped after it: it
    opens, in every bucket the rate offers, a listener and a service on a
    dial the filterbank takes and on one at a channel edge (the full-rate
    banks), subscribes to the waterfall, builds ``warm_programs`` (the
    secondary, digital-voice and IQ-tap programs of ``WARM_MODES``) and
    runs silent blocks through its block path and those programs until
    every bank and program has dispatched, fetched and delivered once (a
    program is not fed again after it has).  That loads every kernel's
    library and module and every PyTorch op's, cuDNN for the FIR
    decimators, the cuFFT plans of these programs' sizes (PyTorch caches
    them per device, for the whole process) and the pinned staging.
    Programs of another runtime built later at the same rate and settings
    find all of that done; their routing and their output do not depend
    on it.  It runs on a thread of its own that ends before this returns,
    so the cuDNN and cuBLAS handles it made go back to PyTorch's pool,
    where the next thread that needs one (a runtime's loop) takes it.  It
    starts no subprocess, and a failure inside it propagates.  → the
    programs it ran besides the banks."""
    def work():
        if runtime.device.type == "cuda":
            torch.cuda.set_device(runtime.device)
            kernels.load_all()
        fs = runtime.in_rate
        for bucket in sorted(runtime.available_buckets):
            m = runtime._pfb_m_for(bucket)
            dials = (0.0,) if m < 8 else (fs / m, 1.5 * fs / m)
            for service in (False, True):
                for dial in dials:
                    handle = runtime.open_channel(BUCKET_CHAIN_MODE[bucket],
                                                  dial, service=service)
                    handle.audio_cb = lambda wire, hd: None
                    handle.smeter_cb = lambda level: None
        runtime.subscribe_waterfall(lambda payload: None)
        programs = warm_programs(runtime)
        blocks = max([bank.chunk_ratio * getattr(bank, "delivery_stride", 1)
                      for bank in runtime.banks.values()]
                     + [-(-p.program.block // runtime.block) for p in programs])
        silence = np.zeros(runtime.block, np.complex64)
        xdev = runtime._upload(silence)
        for _ in range(blocks):
            runtime._process_block(silence)
            for p in programs:
                if not p.delivered:
                    p.delivered = p.feed(xdev)
        idle = [p.mode for p in programs if not p.delivered]
        if idle:
            raise RuntimeError(f"warm-up: no result from {idle} in {blocks} blocks")
        return programs

    with concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="warm-up") as pool:
        return pool.submit(work).result()
