"""The runtime's span log (``core/metrics.py`` ``SpanLog``, ``SpanMetric``;
``runtime/device.py`` ``DeviceRuntime.spans``) on the CPU.

A small runtime (1.024 MS/s, a listener on the filterbank and one at a
channel edge on a full-rate bank, the waterfall) runs its own loop on the
test's thread, fed by a source that pauses between blocks (a read finds
nothing) and retunes both listeners from inside a read, so that the
first dispatch after each change is known.  Held here: one ``dispatch``,
``hold`` and ``complete`` a block with its children inside, a hold ended
at once by a poll that found nothing newer, each retune's ``apply``
closing at the next dispatch, the log's bound, the profiler's ranges on
the log's clock, the per-block gauge, no ``stage`` span on the CPU and
the registry's view; and the
loop's choice of when to complete a block: ``pipeline_depth`` blocks in
flight while the source always has the next one, and a block that
arrives while older ones are in flight dispatched before the next of
them completes.
"""

import json
import queue
import time

import numpy as np
import pytest
import torch

from openwebrx_tpu_torch.core.metrics import CODE_BITS, Metrics, SpanLog
from openwebrx_tpu_torch.runtime.device import DeviceRuntime

RATE = 1.024e6          # 32 filterbank channels of 32 kHz for SSB
TIMEOUT = 0.06          # the loop's old read timeout with a block in flight: a hold now ends well under it
BLOCKS = 6
PFB_DIAL, EDGE_DIAL = 100e3, 44e3          # channel 3 + 4 kHz; channel 1 + 12 kHz
RETUNES = {2: (130e3, 76e3), 4: (100e3, 44e3)}   # before block k: (pfb, edge)


class PausingSource:
    """Hands ``blocks`` uint8 blocks, each after the first to the read
    after one that found nothing (it waits its whole timeout); before block
    ``k`` of ``RETUNES`` it retunes both listeners, on the reading thread.
    Once all are handed, it stops the runtime."""

    def __init__(self, blocks=BLOCKS, name="spans-test"):
        self.id = name
        self.block_size = None
        self.blocks = blocks
        self.handed = 0
        self.paused = False
        self.rt = self.handles = None
        self.changed = {}          # block → the change numbers made before it
        self.rng = np.random.default_rng(7)

    def get_sample_rate(self):
        return RATE

    def start(self):
        pass

    def read_block(self, timeout=1.0):
        if self.handed and not self.paused:
            time.sleep(timeout)
            self.paused = True
            return None
        if self.handed >= self.blocks:
            self.rt._running = False
            return None
        self.paused = False
        k = self.handed
        if k in RETUNES:
            # no other control call runs: the changes are numbered in order
            before = self.rt.spans["control"].count
            for h, hz in zip(self.handles, RETUNES[k]):
                h.set_offset(hz)
            self.changed[k] = [before, before + 1]
        self.handed += 1
        return self.rng.integers(120, 136, (self.block_size, 2), dtype=np.uint8)


def _runtime(src, pipeline_depth=2):
    rt = DeviceRuntime(src, fft_size=1024, compression="none", fft_compression="none",
                       capacity=4, pipeline_depth=pipeline_depth,
                       target_seconds=0.05, device="cpu")
    src.rt = rt
    pfb, edge = rt.open_channel("usb", PFB_DIAL), rt.open_channel("usb", EDGE_DIAL)
    assert pfb.bucket_key == "pfbi:ssb" and edge.bucket_key == "ssb"
    src.handles = (pfb, edge)
    rt.subscribe_waterfall(lambda payload: None)
    return rt


def _run_loop(rt):
    """The runtime's loop on this thread until the source has run out."""
    rt._running = True
    rt._loop()


def _by_id(rt, name):
    rec = rt.spans[name].records()
    return {int(r["id"]): r for r in rec}, rec


@pytest.fixture(scope="module")
def looped():
    src = PausingSource()
    rt = _runtime(src)
    _run_loop(rt)
    return rt, src


class TestBlockSpans:
    def test_each_block_has_one_dispatch_hold_and_complete_with_children(self, looped):
        rt, _ = looped
        for name in ("dispatch", "hold", "complete"):
            ids = sorted(int(i) for i in rt.spans[name].records()["id"])
            assert ids == list(range(BLOCKS)), name
        for parent, children in (("dispatch", ("upload",)),
                                 ("complete", ("fetch", "deliver"))):
            by_id, _ = _by_id(rt, parent)
            for child in children:
                rec = rt.spans[child].records()
                assert len(rec) == BLOCKS, child
                for r in rec:
                    p = by_id[int(r["id"])]
                    assert r["parent"] >> CODE_BITS == p["seq"] - 1
                    assert rt.spans.find(int(r["parent"])).name == parent
                    assert p["start"] <= r["start"] <= r["end"] <= p["end"], child

    def test_a_hold_past_the_read_timeout_was_ended_by_a_timed_out_read(self, looped):
        # the source has one block a pause: the poll after each dispatch
        # finds nothing newer, and the block completes at once, well under
        # the old read timeout
        rt, _ = looped
        reads = rt.spans["read"]
        read = {int(r["seq"]) - 1: r for r in reads.records()}
        holds = rt.spans["hold"].records()
        assert sorted(int(h["id"]) for h in holds) == list(range(BLOCKS))
        for h in holds:
            cause = read[int(h["parent"]) >> CODE_BITS]
            assert reads.outcomes[cause["outcome"]] == "empty"
            assert cause["id"] == -1
            assert h["end"] - h["start"] < TIMEOUT / 2
            assert h["start"] <= cause["start"] <= cause["end"] <= h["end"]
        blocks = [r for r in reads.records() if reads.outcomes[r["outcome"]] == "block"]
        assert sorted(int(r["id"]) for r in blocks) == list(range(BLOCKS))
        assert rt.gauges["early_completions"] == BLOCKS
        m = Metrics.shared()
        assert m.get(f"device.{rt.source.id}.early_completions").get_value() == {"count": BLOCKS}
        assert m.get(f"device.{rt.source.id}.blocks").get_value() == {"count": BLOCKS}

    def test_the_cpu_upload_stages_nothing(self, looped):
        # the pinned host copy and its `stage` span are the card's
        rt, _ = looped
        assert len(rt.spans["stage"].records()) == 0
        assert len(rt.spans["upload"].records()) == BLOCKS

    def test_a_retune_applies_at_the_next_dispatch_on_either_bank(self, looped):
        rt, src = looped
        dispatch, _ = _by_id(rt, "dispatch")
        control, _ = _by_id(rt, "control")
        apply, _ = _by_id(rt, "apply")
        assert sorted(src.changed) == sorted(RETUNES)
        for k, changes in src.changed.items():
            for cid in changes:              # the filterbank's, then the full-rate bank's
                a, c = apply[cid], control[cid]
                assert a["ref"] == k
                assert a["parent"] >> CODE_BITS == c["seq"] - 1
                assert a["start"] == c["end"]
                assert a["end"] == dispatch[k]["start"] > a["start"]
                locks = [r for r in rt.spans["lock"].records() if r["id"] == cid]
                assert locks and all(c["start"] <= r["start"] <= r["end"] <= c["end"]
                                     for r in locks)

    def test_the_stall_of_one_block_shows_in_its_own_proc_block_ms(self):
        src = PausingSource(blocks=0, name="spans-test-gauge")
        rt = _runtime(src)
        seen = []

        def audio(wire, hd):
            if len(seen) == 3:
                time.sleep(0.05)
        src.handles[0].audio_cb = audio
        for _ in range(5):
            rt._process_block(np.full((rt.block, 2), 128, np.uint8))
            seen.append(rt.gauges["proc_block_ms"])
        assert rt.gauges["blocks"] == 5
        dispatch, _ = _by_id(rt, "dispatch")
        complete, _ = _by_id(rt, "complete")
        for k, ms in enumerate(seen):        # each block's own time, not an average
            own = 1e3 * (dispatch[k]["end"] - dispatch[k]["start"]
                         + complete[k]["end"] - complete[k]["start"])
            assert abs(ms - own) <= 1e-3, (k, ms, own)
        assert seen[3] >= 50.0 and complete[3]["end"] - complete[3]["start"] >= 0.05, seen
        rate = rt.block / (seen[4] / 1e3)
        assert abs(rt.gauges["samples_per_s"] - rate) <= 1e-3 * rate
        assert abs(rt.gauges["realtime_factor"] - rate / RATE) <= 0.01


class ReadySource:
    """Always has the next block ready while it lasts: ``blocks`` uint8
    blocks, each read at once.  Then it has nothing; the loop's first wait
    on it (a read with a timeout, nothing in flight) stops the runtime.
    ``arrive()`` adds a block that arrives later, handed to the next read.
    Keeps, at every read, the blocks in flight and the early completions
    so far."""

    def __init__(self, blocks, name):
        self.id = name
        self.block_size = None
        self.rt = None
        self.left = blocks
        self.later = queue.Queue()
        self.seen = []                 # (in flight, early completions) at each read
        self.rng = np.random.default_rng(11)

    def get_sample_rate(self):
        return RATE

    def start(self):
        pass

    def _block(self):
        return self.rng.integers(120, 136, (self.block_size, 2), dtype=np.uint8)

    def arrive(self):
        self.later.put(self._block())

    def read_block(self, timeout=1.0):
        rt = self.rt
        self.seen.append((rt._n_dispatch - rt.gauges["blocks"],
                          rt.gauges["early_completions"]))
        if self.left:
            self.left -= 1
            return self._block()
        try:
            return self.later.get_nowait()
        except queue.Empty:
            pass
        if timeout > 0:
            rt._running = False
        return None


def _outcomes(rt):
    reads = rt.spans["read"]
    return [reads.outcomes[r["outcome"]] for r in reads.records()]


def _hold_causes(rt):
    """Block → the read (its record) that ended its hold."""
    read = {int(r["seq"]) - 1: r for r in rt.spans["read"].records()}
    return {int(h["id"]): read[int(h["parent"]) >> CODE_BITS]
            for h in rt.spans["hold"].records()}


class TestWhenToComplete:
    @pytest.mark.parametrize("depth", [2, 3])
    def test_a_source_with_the_next_block_ready_keeps_the_pipeline_full(self, depth):
        n = 6
        src = ReadySource(n, name=f"spans-test-ready{depth}")
        rt = _runtime(src, pipeline_depth=depth)
        src.rt = rt
        _run_loop(rt)
        # while the source lasts no block completes early, and every read
        # after the first depth - 1 finds depth - 1 blocks in flight: the
        # block it returns makes depth
        assert src.seen[:n] == [(min(k, depth - 1), 0) for k in range(n)]
        assert _outcomes(rt) == (["block"] * n + ["empty"] * (depth - 1) + ["timeout"])
        reads = rt.spans["read"]
        causes = _hold_causes(rt)
        assert sorted(causes) == list(range(n))
        for b, cause in causes.items():
            if b <= n - depth:        # pushed out by the read of a newer block
                assert reads.outcomes[cause["outcome"]] == "block"
                assert cause["id"] == b + depth - 1
            else:                     # the source ran dry: completed early
                assert reads.outcomes[cause["outcome"]] == "empty"
        assert rt.gauges["blocks"] == n
        assert rt.gauges["early_completions"] == depth - 1
        counter = Metrics.shared().get(f"device.{rt.source.id}.early_completions")
        assert counter.get_value() == {"count": depth - 1}

    def test_a_block_that_arrives_while_older_ones_are_in_flight_goes_first(self):
        # blocks 0 and 1 are ready, then nothing: the poll completes block 0,
        # and block 2 arrives while it completes; the next poll dispatches
        # block 2 before block 1 completes
        src = ReadySource(2, name="spans-test-arrival")
        rt = _runtime(src, pipeline_depth=3)
        src.rt = rt
        complete = rt._complete_block

        def completing(pending):
            if rt.gauges["blocks"] == 0:        # block 0 completes: block 2 arrives
                src.arrive()
            complete(pending)
        rt._complete_block = completing
        _run_loop(rt)
        assert _outcomes(rt) == ["block", "block", "empty", "block", "empty", "empty",
                                 "timeout"]
        dispatch, _ = _by_id(rt, "dispatch")
        done, _ = _by_id(rt, "complete")
        assert sorted(done) == [0, 1, 2]
        assert done[0]["end"] <= dispatch[2]["start"] < dispatch[2]["end"] <= done[1]["start"]
        reads = rt.spans["read"]
        causes = _hold_causes(rt)
        block2 = next(r for r in reads.records()
                      if reads.outcomes[r["outcome"]] == "block" and r["id"] == 2)
        for b in (0, 1, 2):
            assert reads.outcomes[causes[b]["outcome"]] == "empty"
        assert causes[0]["end"] <= block2["start"] < block2["end"] <= causes[1]["start"]
        assert rt.gauges["early_completions"] == 3


class TestLog:
    def test_a_hundred_thousand_spans_stay_within_the_bound(self):
        log = SpanLog("spans-test-bound", {"x": ()})
        metric = log["x"]
        size = metric._rec.nbytes
        t0 = time.perf_counter()
        for i in range(100_000):
            with metric(rid=i):
                pass
        rec = metric.records()
        assert metric.capacity >= 65536 and len(rec) == metric.capacity
        assert metric._rec.nbytes == size
        assert metric.count == 100_000
        assert list(rec["id"][[0, -1]]) == [100_000 - metric.capacity, 99_999]
        # the first spans were overwritten: a window from before them reads nothing
        assert metric.durations(t0, time.perf_counter()) is None
        assert len(metric.durations(float(rec["start"][0]), time.perf_counter())) \
            == metric.capacity

    def test_the_registry_shows_each_span_count_and_sum(self, looped):
        rt, _ = looped
        m = Metrics.shared()
        tree = m.get_hierarchical()["device"][rt.source.id]["span"]
        json.dumps(tree)
        prom = m.render_prometheus().splitlines()
        for name in ("read", "dispatch", "hold", "complete", "deliver", "control", "apply"):
            metric = rt.spans[name]
            assert tree[name] == {"count": metric.count, "sum": metric.sum} and metric.count
            flat = f"device.{rt.source.id}.span.{name}".replace(".", "_")
            assert f"# TYPE {flat} summary" in prom
            assert f"{flat}_count {metric.count}" in prom
            assert f"{flat}_sum {metric.sum}" in prom


def test_the_profiler_trace_holds_the_ranges_on_the_log_clock(tmp_path):
    src = PausingSource(blocks=3, name="spans-test-profiled")
    rt = _runtime(src)
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("spans-test.first"):   # the first range's set-up
            pass
        marks = []
        for i in range(5):
            with record_function(f"spans-test.marker{i}"):
                marks.append(time.perf_counter())
        _run_loop(rt)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    # the trace's clock against perf_counter: a marker's start, read inside it
    # (a thread switch in between only makes the difference larger)
    offset = min(t - float(next(e["ts"] for e in events
                                if e.get("name") == f"spans-test.marker{i}")) * 1e-6
                 for i, t in enumerate(marks))
    for name in ("dispatch", "read", "deliver"):
        ranges = sorted(float(e["ts"]) * 1e-6 + offset for e in events
                        if e.get("name") == f"owrx.{name}" and e.get("ph") == "X")
        starts = sorted(float(s) for s in rt.spans[name].records()["start"])
        assert len(ranges) == len(starts) > 0, name
        assert np.max(np.abs(np.asarray(ranges) - np.asarray(starts))) < 1e-3, name
    # no profiler, no range: the flag the spans read is off again
    assert not torch.autograd.profiler._is_profiler_enabled
