"""Scenes of the port's compiled block step (``runtime/chain.py``
``GraphStep``), shared by the CPU tests (tests/test_torch_graph_step.py)
and the card tests (tests/test_torch_card.py).

Each scene runs a bank or program of the port over seeded numpy blocks with
control changes between blocks and returns every block's outputs as numpy.
``PlainBank`` and ``PlainProgram`` are the step as the port ran it before
it had static buffers (state, y, aux = step(state, params, x) on fresh
tensors every block, params rebuilt from the controls): the plain reference
the static-buffer step is held to, bit for bit.  This module imports no jax
and nothing of ``openwebrx_tpu``.
"""

import contextlib
import functools
import types

import numpy as np
import torch

from openwebrx_tpu_torch import kernels
from openwebrx_tpu_torch.models.digital_voice import DV_FACTORY
from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain, FftChain
from openwebrx_tpu_torch.models.stages import plan_block_size
from openwebrx_tpu_torch.ops import channelizer as pfb
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime import device as rtdev
from openwebrx_tpu_torch.runtime.chain import (Program, as_input_block, finish_fetch,
                                               start_fetches, tree_map)
from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank

FS, M = 0.96e6, 8
OFFSETS = (250000.0, -370000.0, 130000.0, 380000.0)
F_AUDIO = (1100.0, 700.0, 1500.0, 900.0)
BLOCKS = 12
# the control changes of a bank scene, by the block they come before, and
# the dial (index into the mode's dials) each one changes: one dial each
BANK_EVENTS = {3: ("retune", 0), 5: ("squelch", 1), 7: ("bandpass", 2), 9: ("nr", 3)}
# the blocks after its own before a change reaches the audio: a squelch
# that closes keeps the gate open through its hang (two windows, here one
# window a block), so its block still plays
EFFECT_LAG = {"squelch": 1}
# the bank modes: mode → (input rate, PFB channels, capacity, audio rate,
# dials); WFM needs slices of at least its 250 kHz IF: 4.8 MS/s split 16
# ways, two gathered slots (its events fall on its two dials)
BANK_MODES = {
    "usb": (FS, M, None, 12000.0, OFFSETS),
    "nfm": (FS, M, None, 12000.0, OFFSETS),
    "am": (FS, M, None, 12000.0, OFFSETS),
    "wfm": (4.8e6, 16, 2, 48000.0, (600000.0, -1500000.0)),
}


def bank_blocks(mode, fs, offsets, block, nblocks=BLOCKS, seed=0):
    """An FM (NFM, WFM) or AM (otherwise) carrier with a tone at each
    offset, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(block * nblocks) / fs
    x = np.zeros(len(t), np.complex128)
    for o, fa in zip(offsets, F_AUDIO):
        audio = np.sin(2 * np.pi * fa * t)
        if mode in ("nfm", "wfm"):
            dev = 75000.0 if mode == "wfm" else 3000.0
            x += 0.4 * np.exp(1j * (2 * np.pi * o * t
                                    + 2 * np.pi * dev * np.cumsum(audio) / fs))
        else:
            x += 0.3 * (1 + 0.6 * audio) * np.exp(2j * np.pi * o * t)
    x += 0.02 * (rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)))
    return np.split(x.astype(np.complex64), nblocks)


def make_bank(mode, device="cpu", graph=True, **kw):
    """A bank of ``BANK_MODES[mode]`` with a slot on every dial → (bank,
    slots)."""
    fs, m, capacity, audio_rate, dials = BANK_MODES[mode]
    args = dict(mode=mode, compression="none", target_seconds=0.05,
                capacity=capacity, audio_rate=audio_rate)
    args.update(kw)
    bank = ChannelizedBank(fs, m, device=device, graph=graph, **args)
    return bank, [bank.assign(o) for o in dials]


def bank_event(bank, name, slot, offset):
    """One control change of a listener: a retune within its channel, a
    squelch that closes, a narrower passband, noise reduction on."""
    if name == "retune":
        return bank.retune(slot, offset + 20000.0)
    if name == "squelch":
        bank.set_squelch(slot, 0.0)
    elif name == "bandpass":
        bank.set_bandpass(slot, -1500.0, 1200.0)
    elif name == "nr":
        bank.set_nr(slot, -10.0)
    return slot


class PlainBank:
    """A ChannelizedBank's dispatch before the static buffers: its step on
    a state of fresh tensors, the params of its controls.  ``bank`` is used
    for its controls and its step only."""

    def __init__(self, bank):
        self.bank = bank
        self.state = (pfb.channelizer_init(bank.m, bank.taps_per_phase,
                                           device=bank.device),
                      bank.chain.init_state((bank._n,), bank.device))

    def process(self, x):
        xt = as_input_block(x, self.bank.block, True, self.bank.device)
        self.state, y, aux = self.bank._raw_step(self.state, self.bank._params(), xt)
        return tree_map(lambda t: t.cpu().numpy(), (y, aux))


class PlainProgram:
    """A Program's dispatch before the static buffers: the chain's apply on
    a state of fresh tensors, the chain's params every block."""

    def __init__(self, program):
        self.program = program
        self.state = program.chain.init_state(program.batch_shape, program.device)

    def process(self, x):
        p = self.program
        xt = as_input_block(x, p.block, p._in_complex, p.device)
        self.state, y, aux = p.chain.apply(self.state, p.chain.params(p.device), xt)
        return tree_map(lambda t: t.cpu().numpy(), (y, aux))


def on(device, x):
    """A numpy block as the caller hands it: numpy on the CPU, a tensor
    already on the card otherwise."""
    return x if torch.device(device).type == "cpu" else torch.from_numpy(x).to(device)


def run_bank_scene(mode, device="cpu", graph=True, events=BANK_EVENTS, plain=False,
                   nblocks=BLOCKS, bank_state=None):
    """``nblocks`` blocks through a ``mode`` bank with ``events`` before
    their blocks → (list of (y, aux) numpy, the plain step's on the same
    bank and blocks when ``plain``, else None, the bank).
    ``bank_state(b, bank)``, when given, may hand the bank a state before
    block b."""
    bank, slots = make_bank(mode, device, graph)
    fs, _, _, _, dials = BANK_MODES[mode]
    ref = PlainBank(bank) if plain else None
    out, ref_out = [], []
    for b, x in enumerate(bank_blocks(mode, fs, dials, bank.block, nblocks, seed=len(mode))):
        if b in events:
            name, i = events[b]
            i = min(i, len(slots) - 1)
            slots[i] = bank_event(bank, name, slots[i], dials[i])
        if bank_state is not None:
            bank_state(b, bank)
        out.append(bank.process(on(device, x)))
        if ref is not None:
            ref_out.append(ref.process(on(device, x)))
    return out, (ref_out if plain else None), bank


def run_stride_scene(device="cpu", graph=True, stride=6):
    """``stride`` USB bank blocks through ``feed_dispatch`` with
    ``delivery_stride`` = ``stride``, the batch started behind one event
    → (list of (y, aux) numpy in dispatch order, what the plain step gives
    the same blocks, the bank)."""
    bank, _ = make_bank("usb", device, graph, delivery_stride=stride)
    ref_bank, _ = make_bank("usb", device, graph=False)
    plain = PlainBank(ref_bank)
    joined, want = None, []
    for x in bank_blocks("usb", FS, OFFSETS, bank.block, stride, seed=6):
        x = on(device, x)
        want.append(plain.process(x))
        joined = bank.feed_dispatch(x, to_host=False)
    pendings, n = joined
    got = [finish_fetch(p) for p in start_fetches(pendings, bank.device)][:n]
    return got, want, bank


WF_FS = 2.4e6


def make_waterfall(device="cpu", graph=True):
    """The compressed waterfall: 1024 bins, a row a 2.4 MS/s block of 0.05 s."""
    return Program(FftChain(1024, 20.0, compress=True),
                   StreamSpec(Format.COMPLEX_FLOAT, WF_FS), 120000, device=device,
                   graph=graph)


def run_waterfall_scene(device="cpu", graph=True, nblocks=BLOCKS):
    """The compressed waterfall (``make_waterfall``) → (list of (rows, aux)
    numpy, [captures])."""
    prog = make_waterfall(device, graph)
    out = [prog.process(on(device, x))
           for x in bank_blocks("usb", WF_FS, (300000.0,), prog.block, nblocks, seed=2)]
    return out, [prog.step.captures]


def run_dv_scene(device="cpu", graph=True, nblocks=BLOCKS):
    """A DMR symbol program (240 kHz input, an FM carrier on the dial) with
    a retune before block 6 → (list of (dibits, aux) numpy, [captures])."""
    fs = 240000.0
    chain = DV_FACTORY["dmr"](fs)
    chain.set_frequency_offset(20000.0)
    spec = StreamSpec(Format.COMPLEX_FLOAT, fs)
    prog = Program(chain, spec, plan_block_size(chain, spec, 0.1), device=device,
                   graph=graph)
    out = []
    for b, x in enumerate(bank_blocks("nfm", fs, (20000.0,), prog.block, nblocks, seed=3)):
        if b == 6:
            chain.set_frequency_offset(20600.0)
        out.append(prog.process(on(device, x)))
    return out, [prog.step.captures]


def run_mode_switch_scene(device="cpu", graph=True, nblocks=8):
    """A USB listener's Program (240 kHz, ADPCM) switched to AM through
    ``rebuild`` after half the blocks → (list of (y, aux) numpy, [captures
    before the switch, after it])."""
    fs = 240000.0
    chain = ClientDemodulatorChain(fs, 12000.0, "usb", "adpcm")
    chain.set_frequency_offset(30000.0)
    spec = StreamSpec(Format.COMPLEX_FLOAT, fs)
    prog = Program(chain, spec, plan_block_size(chain, spec, 0.1), device=device,
                   graph=graph)
    out, captures = [], []
    for b, x in enumerate(bank_blocks("am", fs, (30000.0,), prog.block, nblocks, seed=5)):
        if b == nblocks // 2:
            captures.append(prog.step.captures)
            chain.set_mode("am")
            prog.rebuild()
        out.append(prog.process(on(device, x)))
    return out, captures + [prog.step.captures]


def stub_host():
    """The host side of a PSK31 secondary, decoding nothing."""
    return types.SimpleNamespace(
        VaricodeDecoder=lambda: types.SimpleNamespace(decode=lambda bits: ""),
        dbpsk_bits=lambda symbols: symbols)


def psk_signal(offsets, n, fs=48000.0, seed=31):
    """DBPSK at 31.25 baud on each offset, plus noise."""
    rng = np.random.default_rng(seed)
    phases = np.cumprod(np.where(rng.integers(0, 2, n // 1536 + 2), 1.0, -1.0))
    env = np.repeat(phases, 1536)[:n]
    t = np.arange(n) / fs
    sig = sum(0.4 * env * np.exp(2j * np.pi * o * t) for o in offsets)
    return (sig + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@contextlib.contextmanager
def runtime_graph(graph):
    """The runtime's banks and programs (``runtime/device.py``'s
    ``Program``, ``ChannelBank``, ``ChannelizedBank``) built with
    ``graph``: ``DeviceRuntime`` never passes it, so the eager step of a
    runtime is reached only so."""
    names = ("Program", "ChannelBank", "ChannelizedBank")
    built = {n: getattr(rtdev, n) for n in names}
    for n in names:
        setattr(rtdev, n, functools.partial(built[n], graph=graph))
    try:
        yield
    finally:
        for n in names:
            setattr(rtdev, n, built[n])


def run_secondary_scene(device="cpu", graph=True):
    """A PSK31 SecondaryBank fed the device block: two members (one with
    its FFT rows encoded), then a third, which doubles the capacity and
    builds a new program → ([(member, y, payloads) of every delivery],
    [captures of the first program, of the second])."""
    fs = 48000.0
    runtime = types.SimpleNamespace(in_rate=fs, device=device, host=stub_host())
    got = []
    offsets = (1000.0, -2500.0, 4000.0)
    with runtime_graph(graph):
        bank = rtdev.SecondaryBank(runtime, "bpsk31", capacity=2)

        def attach(i):
            h = rtdev.SecondaryHandle(runtime, "bpsk31", offsets[i], bank)
            if i == 0:
                h.fft_cb = lambda payload: None
            h._deliver = lambda y, payloads, i=i: got.append((i, y, payloads))
            return h

        attach(0), attach(1)
        first = bank.program
        x = psk_signal(offsets, 4 * bank.block)
        for b, blk in enumerate(np.split(x, 4)):
            if b == 2:
                attach(2)
            bank.feed(on(device, blk))
    return got, [first.step.captures, bank.program.step.captures]


# each hand-written kernel's name in a profiler trace, by source file (the
# names: fold_kernel, adpcm_kernel, adpcm_seq_kernel, agc_kernel, iir_kernel
# and iir_rows_kernel, squelch_kernel and squelch_regs_kernel)
KERNEL_MARKS = {"fold.cu": "fold_kernel", "adpcm.cu": "adpcm_kernel",
                "adpcm_seq.cu": "adpcm_seq_kernel", "agc.cu": "agc_kernel",
                "iir.cu": "iir_", "squelch.cu": "squelch_"}


def trace_kernels(trace) -> tuple[list, dict]:
    """The kernel events of a Chrome trace's events, and the hand-written
    kernels' count among them by source file."""
    events = [e for e in trace if e.get("cat") == "kernel"]
    return events, {src: sum(mark in e.get("name", "") for e in events)
                    for src, mark in KERNEL_MARKS.items()}


def traced(fn):
    """``fn()`` under torch.profiler, the card synchronised before the
    trace ends → (its return, the trace's kernel events, the hand-written
    kernels' launches that ran, by source file)."""
    import json
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    events, ours = trace_kernels(trace)
    return out, events, ours


def launch_counts() -> dict:
    return {k.source.name: k.launches for k in kernels.ALL}


def zero_launches():
    for k in kernels.ALL:
        k.launches = 0


def assert_same(a, b, what=""):
    """Two (y, aux) trees of numpy arrays bit for bit."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, what
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), what


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _leaves(t)]
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    return [np.ascontiguousarray(tree)]
