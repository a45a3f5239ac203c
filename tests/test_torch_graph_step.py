"""The port's compiled block step (``runtime/chain.py`` ``GraphStep``) on
the CPU, where it runs without capture over the same static buffers.

Over 12 blocks of a seeded signal with control changes between blocks, a
USB and an NFM ``ChannelizedBank`` and a PSK31 ``Program`` are held bit for
bit to the step as the port ran it before it had static buffers
(``PlainBank``, ``PlainProgram`` in tests/torch_graph_scenes.py), and
within the existing parity tests' tolerances to the JAX package's bank and
Program.  A retune, a bandpass and an NR change each change the output
from its block on, a squelch that closes from the block after its hang; a
mode switch through ``rebuild`` carries
state; a delivery-stride batch keeps six distinct results in order; a
secondary bank's growth restarts its program.  Every live setter the banks
and the runtime call is shown to act through the params tree only (a stage
holding the old setting, given the new params, gives the new output), so a
captured graph sees it.  The card holds the replay to the eager step
(tests/test_torch_card.py ``TestGraphStepOnCard``).
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

from openwebrx_tpu.models.secondary import SECONDARY_FACTORY as JAX_SECONDARY
from openwebrx_tpu.ops.formats import Format as JaxFormat, StreamSpec as JaxSpec
from openwebrx_tpu.runtime.chain import Program as JaxProgram, _unpack_leaf
from openwebrx_tpu.runtime.channelized import ChannelizedBank as JaxBank
from openwebrx_tpu_torch.from_jax import bank_state_from_numpy
from openwebrx_tpu_torch.models.digital_voice import DV_FACTORY
from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain
from openwebrx_tpu_torch.models.secondary import SECONDARY_FACTORY
from openwebrx_tpu_torch.models.selector import Selector
from openwebrx_tpu_torch.models.stages import plan_block_size
from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
from openwebrx_tpu_torch.runtime import device as rtdev
from openwebrx_tpu_torch.runtime.bank import ChannelBank
from openwebrx_tpu_torch.runtime.chain import Chain, GraphStep, Program
from torch_graph_scenes import (BANK_EVENTS, BANK_MODES, BLOCKS, EFFECT_LAG, PlainProgram,
                                assert_same, bank_blocks, bank_event, make_bank,
                                psk_signal, run_bank_scene, run_stride_scene, stub_host)

POWER_KEY = "selector.squelch.power_db"
# int16 audio against the JAX bank, as tests/test_torch_channelized.py
# holds it: fp32 summation order and sincos/FFT rounding (USB), plus the
# drift through the demodulator, IIR and AGC gain (NFM); squelch power in dB
AUDIO_LSB = {"usb": 2, "nfm": 4}
POWER_DB_ATOL = 1e-3
# PSK31 symbols against the JAX chain, of the largest |y| (as
# tests/test_torch_secondary.py); secondary waterfall rows near the peak
CHAIN_RTOL = 1e-4
AUX_DB_ATOL = 1e-2
PSK_FS = 48000.0
PSK_OFFSETS = np.array([1000.0, -2500.0])


@functools.lru_cache(maxsize=None)
def _scene(mode, events=True):
    """A bank scene on the CPU and its plain step (cached: several tests
    read it)."""
    return run_bank_scene(mode, events=BANK_EVENTS if events else {}, plain=True)


def _jax_state_numpy(holder):
    """A JAX bank's or Program's state with complex leaves as complex64."""
    return jax.tree.map(lambda v, c: np.asarray(_unpack_leaf(v, c)),
                        holder.state, holder._s_mask)


class TestStaticStepAgainstPlain:
    @pytest.mark.parametrize("mode", ["usb", "nfm"])
    def test_bank_matches_the_plain_step(self, mode):
        ours, plain, _ = _scene(mode)
        assert len(ours) == len(plain) == BLOCKS
        for b, (o, p) in enumerate(zip(ours, plain)):
            assert_same(o, p, (mode, b))

    @pytest.mark.parametrize("mode", ["usb", "nfm"])
    def test_each_control_change_takes_effect_from_its_block(self, mode):
        ours, _, _ = _scene(mode)
        still, _, _ = _scene(mode, events=False)
        dials = BANK_MODES[mode][4]
        bank, _ = make_bank(mode)
        for b, (name, i) in BANK_EVENTS.items():
            slot = bank.channel_for(dials[i])[0]          # dense: slot = channel
            first = b + EFFECT_LAG.get(name, 0)
            for k in range(first):
                assert np.array_equal(ours[k][0][slot], still[k][0][slot]), (name, k)
            for k in range(first, BLOCKS):
                assert not np.array_equal(ours[k][0][slot], still[k][0][slot]), (name, k)

    def test_psk31_program_matches_the_plain_step(self):
        prog, blocks, events = _psk_program()
        still, _, _ = _psk_program()
        plain = PlainProgram(prog)
        for b, x in enumerate(blocks):
            if b in events:
                events[b](prog.chain)
            o, p = prog.process(x), plain.process(x)
            assert_same(o, p, b)
            # the retune (block 4) moved the symbols from its block on
            assert np.array_equal(o[0], still.process(x)[0]) == (b < 4), b

    def test_mode_switch_through_rebuild_carries_state(self):
        fs = 240000.0
        chain = ClientDemodulatorChain(fs, 12000.0, "usb", "none")
        chain.set_frequency_offset(30000.0)
        spec = StreamSpec(Format.COMPLEX_FLOAT, fs)
        prog = Program(chain, spec, plan_block_size(chain, spec, 0.1), device="cpu")
        plain = PlainProgram(prog)
        rng = np.random.default_rng(5)
        n = np.arange(8 * prog.block)
        x = (0.3 * (1 + 0.5 * np.sin(2 * np.pi * 700 * n / fs))
             * np.exp(2j * np.pi * 30000.0 * n / fs)
             + 0.02 * rng.standard_normal(len(n))).astype(np.complex64)
        blocks = np.split(x, 8)
        for x in blocks[:4]:
            assert_same(prog.process(x), plain.process(x))
        keys = [(w.label, w.signature()) for w in chain.workers]
        old = dict(zip(keys, plain.state))
        chain.set_mode("am")
        prog.rebuild()
        plain.state = tuple(old.get((w.label, w.signature()), s) for w, s in
                            zip(chain.workers, chain.init_state((), prog.device)))
        # the selector and the client audio (the same at a 12 kHz IF) carry
        assert sum((w.label, w.signature()) in old for w in chain.workers) == 2
        fresh = Program(ClientDemodulatorChain(fs, 12000.0, "am", "none"), spec,
                        prog.block, device="cpu")
        fresh.chain.set_frequency_offset(30000.0)
        first = True
        for x in blocks[4:]:
            o = prog.process(x)
            assert_same(o, plain.process(x))
            if first:        # the selector's state came across the switch
                assert not np.array_equal(o[0], fresh.process(x)[0])
                first = False

    def test_delivery_stride_batch_is_six_distinct_blocks_in_order(self):
        got, want, _ = run_stride_scene()
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert_same(g, w)
        for a, b in zip(got, got[1:]):
            assert not np.array_equal(a[0], b[0])

    def test_secondary_bank_growth_restarts_its_program(self):
        runtime = types.SimpleNamespace(in_rate=PSK_FS, device="cpu", host=stub_host())
        bank = rtdev.SecondaryBank(runtime, "bpsk31", capacity=2)
        got = {}
        offsets = (1000.0, -2500.0, 4000.0)

        def attach(off):
            h = rtdev.SecondaryHandle(runtime, "bpsk31", off, bank)
            h._deliver = lambda y, payloads, h=h: got.setdefault(h, []).append(y)
            return h

        handles = [attach(o) for o in offsets[:2]]
        step, plain = bank.program.step, PlainProgram(bank.program)
        x = psk_signal(offsets, 4 * bank.block)
        want = {h: [] for h in handles}
        for b, blk in enumerate(np.split(x, 4)):
            if b == 2:                     # a third member: capacity 2 → 4
                handles.append(attach(offsets[2]))
                want[handles[-1]] = []
                assert bank.capacity == 4 and bank.program.step is not step
                plain = PlainProgram(bank.program)
            y, _ = plain.process(blk)
            for h in handles:
                want[h].append(y[h.slot])
            assert bank.feed(blk) == 1
        for h in handles:
            assert len(got[h]) == len(want[h])
            for g, w in zip(got[h], want[h]):
                assert np.array_equal(g.view(np.uint8), w.view(np.uint8))
        assert tuple(bank.program.step.state[0][0].shape[:1]) == (4,)


class TestAgainstJax:
    @pytest.mark.parametrize("mode", ["usb", "nfm"])
    def test_bank_matches_the_jax_bank(self, mode):
        """The scene's events on both banks; NFM hands the JAX bank's
        state over after block 0 (the FM discriminator's start-up noise,
        see tests/test_torch_channelized.py)."""
        fs, m, capacity, audio_rate, dials = BANK_MODES[mode]
        jb = JaxBank(fs, m, mode=mode, compression="none", target_seconds=0.05,
                     capacity=capacity, audio_rate=audio_rate)
        jslots = [jb.assign(o) for o in dials]
        handover = mode == "nfm"
        blocks = bank_blocks(mode, fs, dials, jb.block, BLOCKS, seed=len(mode))
        expected = []

        def step_jax(b, bank):
            """Before the port's block b: the JAX bank's state after its
            block 0 handed over (NFM), then the JAX bank's block b."""
            if b == 1 and handover:
                bank.state = bank_state_from_numpy(_jax_state_numpy(jb), "cpu")
            if b in BANK_EVENTS:
                name, i = BANK_EVENTS[b]
                jslots[i] = bank_event(jb, name, jslots[i], dials[i])
            expected.append(jb.process(blocks[b]))

        ours, _, _ = run_bank_scene(mode, bank_state=step_jax)
        for b, ((yt, at), (yj, aj)) in enumerate(zip(ours, expected)):
            if b == 0 and handover:
                continue
            yj = np.asarray(yj)
            assert yt.dtype == np.int16 and yt.shape == yj.shape
            d = np.abs(yt.astype(np.int32) - yj.astype(np.int32))
            assert d.max() <= AUDIO_LSB[mode], (mode, b, d.max())
            np.testing.assert_allclose(at[POWER_KEY], aj[POWER_KEY],
                                       rtol=0, atol=POWER_DB_ATOL)

    def test_psk31_program_matches_the_jax_program(self):
        prog, blocks, events = _psk_program()
        jc = JAX_SECONDARY["bpsk31"](PSK_FS)
        jp = JaxProgram(jc, JaxSpec(JaxFormat.COMPLEX_FLOAT, PSK_FS), prog.block, (2,))
        jc.selector.shift.set_rate(-PSK_OFFSETS / PSK_FS)
        for b, x in enumerate(blocks):
            if b in events:
                events[b](prog.chain)
                events[b](jc)
            (ty, ta), (jy, ja) = prog.process(x), jp.process(x)
            jy = np.asarray(jy)
            assert ty.dtype == jy.dtype and ty.shape == jy.shape
            assert np.abs(ty - jy).max() <= CHAIN_RTOL * np.abs(jy).max(), b
            jr, tr = np.asarray(ja["secondary_fft.rows"]), ta["secondary_fft.rows"]
            mask = jr >= jr.max(axis=-1, keepdims=True) - 60.0
            assert np.abs(tr - jr)[mask].max() <= AUX_DB_ATOL, b


def _psk_program():
    """A two-channel PSK31 Program over 12 blocks → (program, blocks,
    {block: control change of a chain}): a retune before block 4, a
    carrier moved before block 8."""
    chain = SECONDARY_FACTORY["bpsk31"](PSK_FS)
    chain.selector.shift.set_rate(-PSK_OFFSETS / PSK_FS)
    spec = StreamSpec(Format.COMPLEX_FLOAT, PSK_FS)
    prog = Program(chain, spec, plan_block_size(chain, spec, 0.1), (2,), device="cpu")
    blocks = np.split(psk_signal(PSK_OFFSETS, BLOCKS * prog.block), BLOCKS)
    events = {4: lambda c: c.selector.shift.set_rate(-(PSK_OFFSETS + 40.0) / PSK_FS),
              8: lambda c: c.set_carrier(15.0)}
    return prog, blocks, events


# -- every live setter acts through the params tree --------------------------
def _setter_cases():
    """(name, build) pairs: build() → (old, new, run) where ``old`` and
    ``new`` are two equal objects of which ``new`` got one control change,
    and ``run(obj, params)`` steps ``obj`` once from a fresh state with the
    given params."""
    x = np.random.default_rng(9).standard_normal(2 * 48000).astype(np.complex64)

    def bank_case(setter):
        def build():
            objs = [make_bank("usb")[0] for _ in range(2)]
            slot = objs[1].channel_for(BANK_MODES["usb"][4][0])[0]
            {"retune": lambda b: b.retune(slot, 255000.0),
             "squelch": lambda b: b.set_squelch(slot, 0.0),
             "bandpass": lambda b: b.set_bandpass(slot, 500.0, 1800.0),
             "nr": lambda b: b.set_nr(slot, -10.0)}[setter](objs[1])
            blk = bank_blocks("usb", *BANK_MODES["usb"][:1], BANK_MODES["usb"][4],
                              objs[0].block, 1)[0]

            def run(bank, params):
                state = (bank.state[0].clone(), bank.chain.init_state((bank._n,), "cpu"))
                _, y, aux = bank._raw_step(state, params, torch.from_numpy(blk))
                return y, aux
            return objs[0], objs[1], run, lambda b: b.program.current_params()
        return build

    def full_rate_case(setter):
        def build():
            objs = [ChannelBank(240000.0, "usb", capacity=2, compression="none",
                                device="cpu") for _ in range(2)]
            for b in objs:
                b.add_channel(20000.0)
            {"retune": lambda b: b.retune(0, 21000.0),
             "squelch": lambda b: b.set_squelch(0, 0.0),
             "bandpass": lambda b: b.set_bandpass(0, 500.0, 1800.0),
             "nr": lambda b: b.set_nr(0, -10.0)}[setter](objs[1])
            return (objs[0].program, objs[1].program, _program_run(x),
                    lambda p: p.current_params())
        return build

    def secondary_case(setter):
        def build():
            runtime = types.SimpleNamespace(in_rate=PSK_FS, device="cpu",
                                            host=stub_host())
            objs = [rtdev.SecondaryBank(runtime, "bpsk31") for _ in range(2)]
            for b in objs:
                b.attach(None, 1000.0)
            {"offset": lambda b: b.set_offset(0, 1200.0),
             "carrier": lambda b: b.set_carrier(0, 20.0)}[setter](objs[1])
            return (objs[0].program, objs[1].program, _program_run(x),
                    lambda p: p.current_params())
        return build

    def chain_case(make):
        def build():
            progs = []
            for _ in range(2):
                chain = make()
                spec = StreamSpec(Format.COMPLEX_FLOAT, PSK_FS * 5)
                progs.append(Program(chain, spec, plan_block_size(chain, spec, 0.1),
                                     device="cpu"))
            progs[1].chain.set_frequency_offset(7000.0)
            return progs[0], progs[1], _program_run(x), lambda p: p.current_params()
        return build

    cases = [(f"channelized-{s}", bank_case(s)) for s in ("retune", "squelch", "bandpass", "nr")]
    cases += [(f"full-rate-{s}", full_rate_case(s)) for s in ("retune", "squelch", "bandpass", "nr")]
    cases += [(f"secondary-{s}", secondary_case(s)) for s in ("offset", "carrier")]
    cases += [("iq-tap-offset", chain_case(lambda: Selector(PSK_FS * 5, 48000.0,
                                                           with_squelch=False))),
              ("dv-offset", chain_case(lambda: DV_FACTORY["dmr"](PSK_FS * 5)))]
    return cases


def _program_run(x):
    def run(prog, params):
        blk = np.resize(x, prog.block)
        state = prog.chain.init_state(prog.batch_shape, prog.device)
        xt = torch.from_numpy(blk)
        _, y, aux = prog.chain.apply(state, params, xt)
        return y, aux
    return run


SETTER_CASES = _setter_cases()


@pytest.mark.parametrize("name,build", SETTER_CASES, ids=[n for n, _ in SETTER_CASES])
def test_setter_acts_through_the_params_tree(name, build):
    """A stage that still holds the old setting, stepped with the new
    params, gives the new output: the setting reaches the step only
    through the params tree, which a replay reads from its static
    buffers."""
    old, new, run, params_of = build()
    fresh = run(new, params_of(new))
    stale = run(old, params_of(new))
    before = run(old, params_of(old))
    assert_same(stale, fresh, name)
    assert not np.array_equal(np.asarray(before[0][0] if isinstance(before[0], tuple)
                                         else before[0]),
                              np.asarray(fresh[0][0] if isinstance(fresh[0], tuple)
                                         else fresh[0])), name


# -- the static buffers ----------------------------------------------------------
class TestGraphStepBuffers:
    def test_changed_params_are_copied_into_the_static_tensors(self):
        step = GraphStep(lambda s, p, x: (s, x * p[0], {}), (), torch.device("cpu"))
        first = (torch.tensor(2.0),)
        step.set_params(first)
        y1, _ = step(torch.ones(3))
        static = step.params[0]
        step.set_params((torch.tensor(5.0),))
        y2, _ = step(torch.ones(3))
        assert step.params[0] is static and float(static) == 5.0
        assert y1.tolist() == [2.0] * 3 and y2.tolist() == [5.0] * 3
        step.set_params((torch.ones(2),))          # a new layout: adopted
        assert step.params[0] is not static
        assert step(torch.ones(2))[0].tolist() == [1.0, 1.0]

    def test_a_python_scalar_param_change_is_a_new_layout(self):
        step = GraphStep(lambda s, p, x: (s, x * p, {}), (), torch.device("cpu"))
        step.set_params(2.0)
        assert step(torch.ones(1))[0].item() == 2.0
        step.set_params(3.0)
        assert step.params == 3.0 and step(torch.ones(1))[0].item() == 3.0

    def test_state_is_written_in_place_even_when_leaves_swap(self):
        a, b = torch.tensor([1.0]), torch.tensor([2.0])
        step = GraphStep(lambda s, p, x: ((s[1], s[0] + x), s[0], {}), (a, b),
                         torch.device("cpu"))
        step.set_params(())
        y, _ = step(torch.tensor([10.0]))
        assert step.state[0] is a and step.state[1] is b
        assert (a.item(), b.item()) == (2.0, 11.0)
        assert y.item() == 1.0        # the old state, copied out before the write

    def test_outputs_aliasing_the_input_are_the_callers(self):
        step = GraphStep(lambda s, p, x: (s, x, {"view": x[:1]}), (), torch.device("cpu"))
        step.set_params(())
        y1, aux1 = step(torch.tensor([1.0, 2.0]))
        y2, _ = step(torch.tensor([3.0, 4.0]))
        assert y1.tolist() == [1.0, 2.0] and aux1["view"].tolist() == [1.0]
        assert y2.tolist() == [3.0, 4.0]

    def test_a_capture_holds_the_garbage_collector_off(self):
        import gc

        from openwebrx_tpu_torch.runtime.chain import _gc_paused
        assert gc.isenabled()
        with _gc_paused():
            assert not gc.isenabled()
            with _gc_paused():           # another thread's capture meanwhile
                assert not gc.isenabled()
            assert not gc.isenabled()
        assert gc.isenabled()
        gc.disable()
        try:
            with _gc_paused():
                pass
            assert not gc.isenabled()    # left as it was found
        finally:
            gc.enable()

    def test_a_state_of_another_layout_is_adopted(self):
        def program(batch):
            return Program(Chain([Selector(PSK_FS, 12000.0)]),
                           StreamSpec(Format.COMPLEX_FLOAT, PSK_FS), 4800,
                           batch_shape=(batch,), device="cpu")
        prog, wider = program(2), program(3)
        before = prog.state
        prog.process(np.zeros(4800, np.complex64))
        prog.state = wider.state            # another batch: adopted as it is
        assert prog.state is wider.state
        prog.state = before
        assert prog.state is before
        same = program(2).state             # the same layout: copied in place
        prog.state = same
        assert prog.state is before

    def test_a_state_layout_that_never_settles_raises(self):
        """A step that gives its state a new layout once (the first block
        after a placeholder state) is adopted; one that does so on every
        block would never be captured, and raises on the second."""
        once = GraphStep(lambda s, p, x: (x.clone(), x, {}), torch.zeros(1),
                         torch.device("cpu"))
        once.set_params(())
        for _ in range(3):
            once(torch.ones(4))
        assert once.state.shape == (4,)
        grows = GraphStep(lambda s, p, x: (torch.cat([s, x]), x, {}), torch.zeros(0),
                          torch.device("cpu"))
        grows.set_params(())
        grows(torch.ones(2))
        with pytest.raises(RuntimeError, match="new layout on every block"):
            grows(torch.ones(2))
