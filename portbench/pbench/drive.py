"""One run of a cell: the runtime under its traffic, every block, delivery,
control change and span recorded.

The runtime is ``openwebrx_tpu_torch.runtime.device.DeviceRuntime`` on
its own loop thread (``start()``), built with the arguments the server's
``SdrService._new_runtime`` gives it from the configuration's settings.
The benchmark wraps two of its methods on the instance, and on the loop
thread does no more than read the clock, number the block and note what
the runtime's own dispatch returned: ``_dispatch_block`` (routing, upload,
each bank's dispatch, fetch start) is stamped at its start and end, with
the banks it ran and whether the waterfall ran; ``_complete_block`` (the
wait on the block's event, then delivery: numpy, framing, callbacks) at
its start and end.  Control changes come from a thread of the benchmark's
own on a wall-clock schedule, as the server's asyncio thread makes them,
and nothing of the benchmark's orders them against the loop.  That
thread reads a listener's bank and slot after each call on it returns
(``Record.moves``); which slot each listener held in each block, and
which block a change reached first, are worked out afterwards from those
times and the times of each dispatch (``Driver.resolve``).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Record:
    """What a run recorded, block ``b`` numbered in dispatch order."""
    n_dispatch: int = 0
    dispatch: dict = field(default_factory=dict)     # b → (t0, t1)
    # (hid, call start, call end, (bank key, slot) or None once it left):
    # a listener's routing as read after each call on it returned
    moves: list = field(default_factory=list)
    routing: dict = field(default_factory=dict)      # b → {hid: (key, slot)}; ``Driver.route``
    active: dict = field(default_factory=dict)       # b → the bank keys the dispatch ran
    waterfall_ran: dict = field(default_factory=dict)  # b → bool
    complete: dict = field(default_factory=dict)     # b → (t0, t1)
    audio: dict = field(default_factory=lambda: defaultdict(list))  # hid → [(b, t, bytes)]
    rows: dict = field(default_factory=lambda: defaultdict(list))   # b → [payload]
    control: list = field(default_factory=list)      # dicts
    current: int = -1
    errors: list = field(default_factory=list)


class Driver:
    """Builds the runtime for ``config`` and drives it."""

    def __init__(self, config: dict, device: str):
        from openwebrx_tpu_torch.runtime.device import DeviceRuntime
        from pbench.source import LoopSource

        self.config = config
        self.plan = None                 # set once the block size is known
        s = config["settings"]
        self.source = LoopSource(None, config["sample_rate"])
        self.rt = DeviceRuntime(
            self.source,
            fft_size=int(s.get("fft_size", 4096)),
            fft_fps=float(s.get("fft_fps", 9)),
            compression=s.get("audio_compression", "adpcm"),
            fft_compression=s.get("fft_compression", "adpcm"),
            capacity=int(s.get("tpu_channel_capacity", 16)),
            target_seconds=float(s.get("tpu_block_seconds", 0.1)),
            device=device)
        self.block = self.rt.block
        self.rec = Record()
        self.handles: dict[int, object] = {}
        # hid → [(change id, the blocks it may first have reached, hz)]
        self.dials: dict[int, list] = defaultdict(list)
        self.waterfall = self.service = False
        self._wf_cbs: dict[int, object] = {}
        self.profiler = None
        self._wrap()

    # -- instrumentation --------------------------------------------------
    def _wrap(self):
        """Stamps on the loop thread: no lock, no loop over listeners or
        banks, no wait (a traced run also starts and stops its profiler
        there)."""
        rt, rec = self.rt, self.rec
        dispatch, complete = rt._dispatch_block, rt._complete_block

        def wrapped_dispatch(block):
            if self.profiler is not None:
                self.profiler.at_dispatch(rec.n_dispatch)
            t0 = time.perf_counter()
            b = rec.n_dispatch
            rec.n_dispatch += 1
            pending = dispatch(block)
            rec.dispatch[b] = (t0, time.perf_counter())
            # the runtime's own snapshot of the banks it ran (a dict made
            # for this block); its keys are taken after the run
            rec.active[b] = pending["banks"]
            rec.waterfall_ran[b] = bool(pending["fft_pending"])
            pending["portbench_block"] = b
            return pending

        def wrapped_complete(pending):
            b = pending.get("portbench_block", -1)
            t0 = time.perf_counter()
            rec.current = b
            complete(pending)
            rec.complete[b] = (t0, time.perf_counter())

        rt._dispatch_block = wrapped_dispatch
        rt._complete_block = wrapped_complete

    def _audio_cb(self, hid: int):
        out = self.rec.audio[hid]
        rec = self.rec

        def cb(wire, hd):
            out.append((rec.current, time.perf_counter(), wire))
        return cb

    def _wf_cb(self):
        rec = self.rec

        def cb(payload):
            rows = rec.rows[rec.current]
            if len(rows) < 64 and not any(p is payload for p in rows):
                rows.append(payload)
        return cb

    # -- listeners ----------------------------------------------------------
    def subscribe(self, hid: int):
        if self.waterfall:
            cb = self._wf_cb()
            self._wf_cbs[hid] = cb
            self.rt.subscribe_waterfall(cb)

    def open(self, hid: int, mode: str, hz: float):
        t = time.perf_counter()
        h = self.rt.open_channel(mode, hz, service=self.service)
        h.audio_cb = self._audio_cb(hid)
        self.handles[hid] = h
        self.rec.moves.append((hid, t, time.perf_counter(), (h.bucket_key, h.slot)))

    def close(self, hid: int):
        t = time.perf_counter()
        h = self.handles.pop(hid)
        self.rt.release_channel(h)
        self.rec.moves.append((hid, t, time.perf_counter(), None))
        if hid in self._wf_cbs:
            self.rt.unsubscribe_waterfall(self._wf_cbs.pop(hid))

    def apply(self, ev, scheduled: float | None):
        """One control change, made as the server makes it: no lock of
        the benchmark's is held."""
        hz = self.plan.dial(ev.station) if ev.hz is None else ev.hz
        t_req = time.perf_counter()
        if ev.kind == "swap":
            # the newcomer's waterfall first (a waterfall with no
            # subscriber would skip a block); the leaver's slot is then
            # free for the newcomer, as when a browser reconnects
            self.subscribe(ev.new_listener)
            self.close(ev.listener)
            self.open(ev.new_listener, ev.mode, hz)
            who = ev.new_listener
        elif ev.listener in self.handles:       # a retune, an edge drag or its return
            h = self.handles[ev.listener]
            h.set_offset(hz)
            who = ev.listener
            self.rec.moves.append((who, t_req, time.perf_counter(), (h.bucket_key, h.slot)))
        else:
            return
        t_done = time.perf_counter()
        self.rec.control.append({"kind": ev.kind, "listener": who, "left": ev.listener,
                                 "hz": hz, "scheduled": scheduled, "requested": t_req,
                                 "done": t_done})

    def route(self):
        """Each block's routing, from the records: a listener
        holds in block b what was read after the last call on it that
        returned before b's dispatch began.  A call that overlapped the
        dispatch leaves the block with what the listener held before it;
        whether it reached the block is open (``resolve``), and where the
        call moved the listener, ``check.unresolved`` leaves it unjudged
        there.  The runtime moves a listener only inside a call on it."""
        moves = sorted(self.rec.moves, key=lambda m: m[2])
        held, i = {}, 0
        for b in sorted(self.rec.dispatch):
            t0 = self.rec.dispatch[b][0]
            while i < len(moves) and moves[i][2] < t0:
                hid, _, _, where = moves[i]
                if where is None:
                    held.pop(hid, None)
                else:
                    held[hid] = where
                i += 1
            self.rec.routing[b] = dict(held)

    def resolve(self):
        """After the run: each block's routing (``route``) and bank keys,
        and which blocks each change may first have reached.
        A dispatch that began after the change returned has it; one that
        overlapped the call may have it or not; one that ended before the
        call began has not.  Sets each change's ``firsts`` (ascending) and
        ``first`` (the last of them: the first block certain to have it),
        and ``dials``."""
        self.route()
        self.rec.active = {b: list(banks) for b, banks in self.rec.active.items()}
        starts = sorted((t0, t1, b) for b, (t0, t1) in self.rec.dispatch.items())
        for cid, c in enumerate(self.rec.control):
            after = [b for t0, _, b in starts if t0 > c["done"]]
            certain = min(after) if after else self.rec.n_dispatch
            maybe = [b for t0, t1, b in starts
                     if t0 <= c["done"] and t1 >= c["requested"] and b < certain]
            c["firsts"] = tuple(sorted(maybe)) + (certain,)
            c["first"] = certain
            self.dials[c["listener"]].append((cid, c["firsts"], c["hz"]))
        self.ambiguous = sum(len(c["firsts"]) > 1 for c in self.rec.control)

    # -- phases -------------------------------------------------------------
    def start(self, wire):
        self.source.wire = wire
        for hid, (mode, station) in self.plan.listeners.items():
            hz = self.plan.dial(station)
            self.open(hid, mode, hz)
            self.dials[hid].append((-1 - hid, (0,), hz))
            self.subscribe(hid)
        self.rt.start()

    def warm(self, blocks: int, events, timeout: float = 900.0):
        """Stream ``blocks`` blocks of the cell's own traffic, applying the
        warm-up's control changes between them; wait until every one has
        been delivered."""
        for i in range(blocks):
            b = len(self.source.handed)
            self.source.warm(1)
            # each change between two whole dispatches
            self._wait(lambda: b in self.rec.dispatch, timeout)
            if i < len(events):
                self.apply(events[i], None)
        last = len(self.source.handed) - 1
        self._wait(lambda: last in self.rec.complete, timeout)

    def _wait(self, cond, timeout: float):
        t_end = time.perf_counter() + timeout
        while not cond():
            if time.perf_counter() > t_end:
                raise TimeoutError("the runtime stopped taking blocks")
            if self.rt._thread is None or not self.rt._thread.is_alive():
                raise RuntimeError("the runtime's loop thread died")
            time.sleep(0.002)

    def window(self, pacing: str, seconds: float, events, sub=None):
        """The measured window → (t0, the traced sub-window or None).  With
        ``sub`` = (offset, length) seconds, torch.profiler records the
        device from t0 + offset for length."""
        t0 = time.perf_counter()
        self.first_window_block = len(self.source.handed)
        # a realtime source runs on for two more blocks, so that a change
        # due at the window's end meets a block; they are not measured
        tail = 2 * self.block / self.source.fs if pacing == "realtime" else 0.0
        self.source.window(pacing, t0, seconds + tail)
        ctl = threading.Thread(target=self._control, args=(t0, events),
                               name="portbench-control", daemon=True)
        ctl.start()
        if sub is not None:
            from pbench.trace import LoopProfiler
            self.profiler = LoopProfiler(t0 + sub[0], t0 + sub[0] + sub[1])
        time.sleep(max(0.0, t0 + seconds + tail - time.perf_counter()))
        ctl.join()
        self.source.idle()
        traced = None
        if self.profiler is not None:
            self._wait(lambda: self.profiler.done, 60.0)
            traced = self.profiler.result(str(_out_dir()))
        return t0, traced

    def _control(self, t0: float, events):
        try:
            for ev in events:
                at = t0 + ev.at
                delay = at - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                self.apply(ev, at)
        except Exception as exc:            # recorded; the run then fails
            self.rec.errors.append(f"control: {exc!r}")

    def drain(self, extra: bool, timeout: float = 60.0):
        """Wait for every handed block to be delivered, then stop.  With
        ``extra``, hand over up to 8 more blocks while a result of the
        window's blocks is still held back (a bank that delivers in
        batches of blocks)."""
        last = len(self.source.handed) - 1
        self._wait(lambda: last in self.rec.complete, timeout)
        if extra:
            held = self.first_window_block
            for _ in range(8):
                self.route()
                got = deliveries(self.rec)
                if all(b in got.get(hid, {}) for b in range(held, last + 1)
                       for hid, (key, slot) in self.rec.routing[b].items()
                       if slot is not None and key in self.rec.active[b]):
                    break
                target = len(self.source.handed) + 1
                self.source.warm(1)
                self._wait(lambda: len(self.source.handed) >= target, timeout)
                end = len(self.source.handed) - 1
                self._wait(lambda: end in self.rec.complete, timeout)
        self.rt.stop()


def _out_dir():
    """Scratch space inside the checkout (git-ignored)."""
    from pathlib import Path
    return Path(__file__).resolve().parents[1] / ".out"


def deliveries(rec: Record) -> dict:
    """hid → {block: (time, payload)}; a completion that delivered n
    results to a listener (a delivery-stride batch) delivered blocks
    b−n+1 … b."""
    out = {}
    for hid, items in rec.audio.items():
        per = {}
        run, last = [], None
        for item in items + [(None, None, None)]:
            if item[0] != last and run:
                n = len(run)
                for i, (b, t, w) in enumerate(run):
                    per[last - n + 1 + i] = (t, w)
                run = []
            last = item[0]
            if item[0] is not None:
                run.append(item)
        out[hid] = per
    return out
